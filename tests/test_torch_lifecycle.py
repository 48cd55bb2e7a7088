"""
The port's lifecycle pieces (``gordo_tpu_torch.lifecycle``) against the
JAX package's: the drift monitor on the same ratio sequences (1e-12),
``total_anomaly_series`` on both frame types, the shadow score and gate,
warm-start stacking, the trainer's NaN seam, the promotion protocol, and
on the converted ``lc-m-*`` fixture (``tests/torch_lifecycle_helpers``)
each machine's drift statistics and its live model's shadow score (rtol
1e-5) and a warm-start refit's parameters (atol 1e-4, the conventions'
tolerance for fits and builds).
"""

import json
import os

import numpy as np
import pandas as pd
import pytest
import torch

from gordo_tpu import serializer as jax_serializer
from gordo_tpu.builder.fleet_build import FleetModelBuilder as JaxFleetModelBuilder
from gordo_tpu.builder.fleet_build import _find_jax_estimator
from gordo_tpu.lifecycle import DriftMonitor as JaxDriftMonitor
from gordo_tpu.lifecycle import shadow_gate as jax_shadow_gate
from gordo_tpu.lifecycle import shadow_score as jax_shadow_score
from gordo_tpu.lifecycle import total_anomaly_series as jax_total_anomaly_series
from gordo_tpu.robustness import faults as jax_faults
from gordo_tpu_torch import convert, serializer
from gordo_tpu_torch.builder.fleet_build import FleetModelBuilder, _find_torch_estimator
from gordo_tpu_torch.lifecycle import (
    DriftMonitor,
    TornPromotion,
    assemble_revision,
    read_promotion_report,
    repoint_latest,
    shadow_gate,
    shadow_score,
    total_anomaly_series,
    warm_params_from_artifacts,
)
from gordo_tpu_torch.lifecycle.manager import LifecycleConfig, parse_timestamp
from gordo_tpu_torch.lifecycle.refit import degrade_params, estimator_params
from gordo_tpu_torch.models.factories.feedforward import feedforward_hourglass
from gordo_tpu_torch.models.utils import BlockFrame, Frame
from gordo_tpu_torch.observability import read_events
from gordo_tpu_torch.parallel.fleet import FleetTrainer, StackedData
from gordo_tpu_torch.robustness import InjectedFault, faults
from gordo_tpu_torch.server.utils import dataframe_from_dict
from tests.test_lifecycle import BASE_REVISION, NAMES
from tests.torch_lifecycle_helpers import (
    build_pair,
    jax_manager,
    jax_shuffle_noise,
    port_manager,
)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_faults(monkeypatch):
    for var in (faults.FAULT_INJECT_ENV_VAR, faults.FAULT_INJECT_FILE_ENV_VAR,
                "GORDO_TPU_EVENT_LOG"):
        monkeypatch.delenv(var, raising=False)
    faults.reset()
    jax_faults.reset()
    yield
    faults.reset()
    jax_faults.reset()


def _set_faults(monkeypatch, spec):
    monkeypatch.setenv(faults.FAULT_INJECT_ENV_VAR, spec)
    faults.reset()
    jax_faults.reset()


# -- the drift monitor ---------------------------------------------------------


def _frames(values):
    """The same total-anomaly column as a JAX MultiIndex frame and a port
    BlockFrame."""
    values = np.asarray(values, dtype=float)
    jax_frame = pd.DataFrame({"x": values})
    jax_frame.columns = pd.MultiIndex.from_tuples([("total-anomaly-scaled", "")])
    port_frame = BlockFrame(range(len(values)))
    port_frame.add_column("total-anomaly-scaled", values)
    return jax_frame, port_frame


def _assert_assessments_equal(got, want):
    got, want = got.to_dict(), want.to_dict()
    assert got.keys() == want.keys()
    for key, value in want.items():
        if isinstance(value, float):
            assert abs(got[key] - value) <= 1e-12 * max(1.0, abs(value)), key
        else:
            assert got[key] == value, key


#: (machine, values, threshold, revision) observation sequences
SEQUENCES = {
    "ewma": [("m", [5.0] * 8, 10.0, ""), ("m", [30.0] * 8, 10.0, "")]
    + [("m", [1.0] * 8, 10.0, "")] * 6,
    "exceedance": [("m", [11.0] * 6 + [0.1] * 4, 10.0, "")] * 3,
    "min_observations": [("m", [50.0] * 4, 1.0, "")] * 3,
    "revision_reset": [("m", [50.0] * 4, 1.0, "r1"), ("m", [50.0] * 4, 1.0, "r2"),
                       ("m", [0.5, 2.0, np.nan, 3.0], 1.0, "r2")],
    "two_machines": [("a", [0.3, 0.4, 2.5], 1.0, "r"), ("b", [1.5, 1.7], 1.2, "r"),
                     ("a", [0.9, 1.1, 1.2], 1.0, "r"), ("b", [0.1, np.inf, 0.2], 1.2, "r")],
}
MONITOR_KWARGS = {
    "ewma": dict(ewma_alpha=0.5, ratio_threshold=1.0, exceedance_threshold=0.9),
    "exceedance": dict(ewma_alpha=1.0, ratio_threshold=100.0, exceedance_threshold=0.5),
    "min_observations": dict(ewma_alpha=1.0, min_observations=3),
    "revision_reset": dict(ewma_alpha=0.5, min_observations=2),
    "two_machines": dict(ewma_alpha=0.3, ratio_threshold=1.1, exceedance_threshold=0.4),
}


@pytest.mark.parametrize("case", sorted(SEQUENCES))
def test_drift_monitor_matches_jax(case, tmp_path):
    """Both monitors fed the same sequence agree on every assessment
    (1e-12), persist the same state, and reload to the same verdicts."""
    kwargs = MONITOR_KWARGS[case]
    port = DriftMonitor(state_path=tmp_path / "port" / "drift.json", **kwargs)
    jax = JaxDriftMonitor(state_path=tmp_path / "jax" / "drift.json", **kwargs)
    for machine, values, threshold, revision in SEQUENCES[case]:
        jax_frame, port_frame = _frames(values)
        _assert_assessments_equal(
            port.observe(machine, port_frame, threshold=threshold, revision=revision),
            jax.observe(machine, jax_frame, threshold=threshold, revision=revision))
        assert port.drifted() == jax.drifted()
    port.save()
    jax.save()
    port_state = json.loads((tmp_path / "port" / "drift.json").read_text())
    jax_state = json.loads((tmp_path / "jax" / "drift.json").read_text())
    for state in (port_state, jax_state):
        for record in state["machines"].values():
            record.pop("last_observed")
    assert port_state == jax_state
    reloaded = DriftMonitor(state_path=tmp_path / "port" / "drift.json", **kwargs)
    assert reloaded.drifted() == JaxDriftMonitor(
        state_path=tmp_path / "jax" / "drift.json", **kwargs).drifted()


def test_drift_monitor_corrupt_state_starts_fresh(tmp_path):
    for text in ("{not json", "[1, 2]", '{"machines": {"m": 3, "n": {"bogus": 1}}}'):
        path = tmp_path / "drift.json"
        path.write_text(text)
        assert DriftMonitor(state_path=path).drifted() == []
    # a monitor over a missing file saves a fresh one
    monitor = DriftMonitor(state_path=tmp_path / "new" / "drift.json")
    assert monitor.save() == str(tmp_path / "new" / "drift.json")


def test_drift_monitor_rejects_what_jax_rejects():
    for monitor in (DriftMonitor(), JaxDriftMonitor()):
        for threshold in (None, float("nan"), 0.0):
            with pytest.raises(ValueError, match="threshold"):
                monitor.observe("m", _frames([1.0])[isinstance(monitor, DriftMonitor)],
                                threshold=threshold)
        with pytest.raises(ValueError, match="finite"):
            monitor.observe_ratio("m", np.array([np.nan, np.inf]))
        with pytest.raises(ValueError, match="non-finite"):
            monitor.observe_stats("m", ratio=np.nan, exceedance=0.1)
    with pytest.raises(ValueError, match="ewma_alpha"):
        DriftMonitor(ewma_alpha=0.0)


def test_drift_monitor_emits_event_on_transition(monkeypatch, tmp_path):
    log = tmp_path / "events.jsonl"
    monkeypatch.setenv("GORDO_TPU_EVENT_LOG", str(log))
    monitor = DriftMonitor(ewma_alpha=1.0)
    for _ in range(2):
        monitor.observe("m", _frames([50.0] * 4)[1], threshold=1.0, revision="r")
    drifted = [e for e in read_events(str(log)) if e["event"] == "machine_drifted"]
    assert len(drifted) == 1  # the transition, not every drifted observation
    assert (drifted[0]["machine"], drifted[0]["revision"]) == ("m", "r")
    assert set(drifted[0]) >= {"ewma_ratio", "ewma_exceedance", "n_observations"}


def test_total_anomaly_series_both_frame_shapes():
    values = [1.0, 2.5, np.nan]
    jax_frame, port_frame = _frames(values)
    np.testing.assert_array_equal(total_anomaly_series(port_frame),
                                  jax_total_anomaly_series(jax_frame).to_numpy())
    # a server reply parsed back: flat columns
    reply = {"total-anomaly-scaled": {"0": 3.0, "1": 4.0}, "other": {"0": 0.0, "1": 1.0}}
    flat = dataframe_from_dict(reply)
    assert isinstance(flat, Frame)
    np.testing.assert_array_equal(total_anomaly_series(flat),
                                  jax_total_anomaly_series(pd.DataFrame(reply)).to_numpy())
    for frame in (Frame(np.zeros((1, 1)), ["other"], [0]), BlockFrame([0])):
        with pytest.raises(KeyError, match="total-anomaly"):
            total_anomaly_series(frame)


# -- shadow scoring and warm start ---------------------------------------------


class _OffsetModel:
    """Output = ``bias``-shifted targets, ``offset`` rows short."""

    def __init__(self, y, offset=0, bias=0.0):
        self._y, self.offset, self.bias = np.asarray(y, dtype=float), offset, bias

    def predict(self, X):
        return self._y[self.offset:] + self.bias


def test_shadow_score_and_gate_match_jax():
    y = np.arange(20, dtype=float).reshape(10, 2)
    for offset, bias in ((0, 0.0), (3, 0.0), (3, 2.0), (9, -1.5)):
        model = _OffsetModel(y, offset, bias)
        assert shadow_score(model, None, y) == jax_shadow_score(model, None, y)
    for score in (shadow_score, jax_shadow_score):
        with pytest.raises(ValueError, match="longer"):
            score(_OffsetModel(np.vstack([y, y])), None, y)
    for live, candidate, tol in ((1.0, 1.05, 0.1), (1.0, 1.2, 0.1), (1.0, 0.5, 0.0),
                                 (1.0, float("nan"), 0.1), (1.0, float("inf"), 0.1),
                                 (float("nan"), 123.0, 0.1), (2.0, 2.2, 0.1)):
        assert shadow_gate(live, candidate, tol) == jax_shadow_gate(live, candidate, tol)


def _trees(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"w": rng.random((3, 2)).astype("float32"), "b": rng.random(2)} for _ in range(n)]


def test_stack_warm_params_matches_jax():
    trees = _trees(2)
    port = FleetModelBuilder([], device="cpu", initial_params={"a": trees[0], "b": trees[1]})
    jax = JaxFleetModelBuilder([], initial_params={"a": trees[0], "b": trees[1]})
    got = port._stack_warm_params(["a", "b"], 4)
    want = jax._stack_warm_params(["a", "b"], m_padded=4)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]))
    assert got["w"].shape == (4, 3, 2)
    np.testing.assert_array_equal(got["w"][2], trees[0]["w"])  # the pad is the first's
    # tensors stack as arrays do
    tensors = {k: torch.from_numpy(np.asarray(v)) for k, v in trees[1].items()}
    port = FleetModelBuilder([], device="cpu", initial_params={"a": trees[0], "b": tensors})
    np.testing.assert_array_equal(port._stack_warm_params(["a", "b"], 2)["b"][1],
                                  trees[1]["b"].astype(np.float32))


def test_stack_warm_params_falls_back_cold_as_jax_does():
    trees = _trees(2)
    cases = [
        (None, ["a"], 1),
        ({"a": trees[0]}, ["a", "b"], 2),
        ({"a": trees[0], "b": {"other": np.zeros(2)}}, ["a", "b"], 2),
        ({"a": trees[0], "b": {"w": np.zeros((4, 2)), "b": np.zeros(2)}}, ["a", "b"], 2),
    ]
    for initial, names, m in cases:
        assert FleetModelBuilder([], device="cpu", initial_params=initial)._stack_warm_params(
            names, m) is None
        assert JaxFleetModelBuilder([], initial_params=initial)._stack_warm_params(
            names, m) is None


def test_warm_init_refuses_a_mismatched_model():
    builder = FleetModelBuilder([], device="cpu")
    cold = {"w": torch.zeros(2, 3, 2)}
    assert builder._warm_init(cold, None) is None
    assert builder._warm_init(cold, {"w": np.ones((2, 4, 2), np.float32)}) is None
    assert builder._warm_init(cold, {"v": np.ones((2, 3, 2), np.float32)}) is None
    warm = builder._warm_init(cold, {"w": np.ones((2, 3, 2), np.float32)})
    assert torch.equal(warm["w"], torch.ones(2, 3, 2))


def _fleet_data(n_machines=2, seed=0):
    rng = np.random.default_rng(seed)
    Xs = [rng.random((64, 3)).astype("float32") for _ in range(n_machines)]
    return StackedData.from_ragged(Xs, [x.copy() for x in Xs], device="cpu")


def test_fleet_trainer_warm_start_continues_from_given_params():
    """fit(params=...) trains from the given weights: one warm epoch from
    a converged state starts far below a cold run's first epoch."""
    data = _fleet_data()
    trainer = FleetTrainer(feedforward_hourglass(n_features=3), device="cpu")
    params, losses = trainer.fit(data, seeds=[0, 0], epochs=10, batch_size=16)
    _, warm = trainer.fit(data, params=params, epochs=1, batch_size=16)
    assert (warm[0] < losses[0] * 0.9).all()
    assert (np.abs(warm[0] - losses[-1]) < np.abs(warm[0] - losses[0])).all()


@pytest.mark.parametrize("sites, spec, expect_epoch", [
    (("train",), "train:nan:1@epoch:1", 1),
    (("train", "refit"), "refit:nan:1@epoch:0", 0),
    (("train",), "refit:nan:1@epoch:0", None),
])
def test_fleet_trainer_nan_seam_quarantines(monkeypatch, sites, spec, expect_epoch):
    """A targeted machine's epoch loss goes NaN at the spec's epoch: the
    guard quarantines it there and freezes its weights at the last
    finite epoch, and the other machine trains on untouched."""
    data = _fleet_data()
    clean = FleetTrainer(feedforward_hourglass(n_features=3), device="cpu", fault_sites=sites)
    want_params, want_losses = clean.fit(data, seeds=[0, 1], epochs=3, batch_size=16)
    frozen = (clean.fit(data, seeds=[0, 1], epochs=expect_epoch, batch_size=16)[0]
              if expect_epoch else clean.init_params([0, 1]))
    _set_faults(monkeypatch, spec)
    trainer = FleetTrainer(feedforward_hourglass(n_features=3), device="cpu", fault_sites=sites)
    params, losses = trainer.fit(data, seeds=[0, 1], epochs=3, batch_size=16,
                                 machine_names=["m-0", "1"])
    np.testing.assert_array_equal(losses[:, 0], want_losses[:, 0])
    for name in params:
        torch.testing.assert_close(params[name][0], want_params[name][0], rtol=0, atol=0)
    if expect_epoch is None:
        assert trainer.healthy_.all()
        np.testing.assert_array_equal(losses, want_losses)
        return
    assert trainer.healthy_.tolist() == [True, False]
    assert trainer.quarantine_epoch_.tolist() == [-1, expect_epoch]
    assert np.isnan(losses[expect_epoch, 1])
    for name in params:
        torch.testing.assert_close(params[name][1], frozen[name][1], rtol=0, atol=0)


# -- the promotion protocol ----------------------------------------------------


def _fake_revision(tmp_path, machines=("a", "b"), revision="100"):
    rev = tmp_path / "models" / revision
    for name in machines:
        (rev / name).mkdir(parents=True)
        (rev / name / "params.npz").write_bytes(b"weights-" + name.encode())
        (rev / name / "metadata.json").write_text(json.dumps({"name": name}))
    return rev


def _published(parent):
    return sorted(n for n in os.listdir(parent)
                  if not n.startswith(".") and os.path.isdir(os.path.join(parent, n)))


def test_assemble_revision_retains_hard_linked(tmp_path):
    rev = _fake_revision(tmp_path)
    out = assemble_revision(rev, decisions={}, candidates={}, build_report={},
                            promotion_report={"x": 1})
    assert out.parent == rev.parent and out.name.isdigit() and int(out.name) > int(rev.name)
    for name in ("a", "b"):
        assert os.path.samefile(rev / name / "params.npz", out / name / "params.npz")
    assert read_promotion_report(out) == {"x": 1, "version": 1, "revision": out.name}
    assert json.loads((out / "build_report.json").read_text())["revision"] == out.name
    assert not [n for n in os.listdir(rev.parent) if n.startswith(".promote-")]
    assert read_promotion_report(rev) is None


def test_assemble_revision_torn_never_publishes(tmp_path, monkeypatch):
    """promote:torn kills assembly mid-copy: the staging directory stays
    dot-prefixed and nothing publishes; the retry (the tear's budget
    spent) publishes under a fresh name within the same millisecond."""
    import time as time_mod

    monkeypatch.setattr(time_mod, "time", lambda: 1_700_000_123.456)
    rev = _fake_revision(tmp_path)
    _set_faults(monkeypatch, "promote:torn@attempts:1")
    with pytest.raises(TornPromotion) as err:
        assemble_revision(rev, decisions={}, candidates={}, build_report={},
                          promotion_report={})
    assert isinstance(err.value.__cause__, InjectedFault)
    staging = [n for n in os.listdir(rev.parent) if n.startswith(".promote-")]
    assert len(staging) == 1 and err.value.staging_dir.endswith(staging[0])
    assert _published(rev.parent) == [rev.name]
    out = assemble_revision(rev, decisions={}, candidates={}, build_report={},
                            promotion_report={})
    assert out.name in _published(rev.parent) and f".promote-{out.name}" not in staging


def test_repoint_latest_flips_atomically(tmp_path):
    rev1 = _fake_revision(tmp_path, revision="100")
    rev2 = _fake_revision(tmp_path, revision="200")
    os.symlink("100", rev1.parent / "latest")
    repoint_latest(rev1.parent / "latest", rev2)
    assert os.readlink(rev1.parent / "latest") == "200"  # relative: relocatable
    with pytest.raises(ValueError, match="real directory"):
        repoint_latest(rev1, rev2)


def test_config_windows_and_timestamps():
    with pytest.raises(ValueError, match="holdout_fraction"):
        LifecycleConfig(holdout_fraction=1.0)
    with pytest.raises(ValueError, match="Empty lifecycle window"):
        LifecycleConfig(window_start="2019-01-02T00:00:00+00:00",
                        window_end="2019-01-01T00:00:00Z")
    for text in ("2019-01-01T00:00:00+00:00", "2019-01-01 06:30:00.25+01:00",
                 "2019-01-01T00:00:00Z", "2019-03-04"):
        assert parse_timestamp(text) == pd.Timestamp(text).to_pydatetime()


@pytest.mark.parametrize("start, end, holdout", [
    ("2019-01-01T00:00:00+00:00", "2019-01-02T00:00:00+00:00", 0.25),
    ("2019-01-01T00:00:00+00:00", "2019-01-01T00:00:07+00:00", 0.25),
    ("2019-01-01T00:00:00+00:00", "2019-01-01T00:00:01.000003+00:00", 0.5),
    ("2019-01-01 00:00:00", "2019-06-01 00:00:00", 0.3),
])
def test_machine_window_strings_match_jax(tmp_path, start, end, holdout):
    meta = {"dataset": {"train_start_date": start, "train_end_date": end}}
    (tmp_path / "models" / "1").mkdir(parents=True)
    os.symlink("1", tmp_path / "models" / "latest")
    port = port_manager(tmp_path / "models", holdout_fraction=holdout)
    jax = jax_manager(tmp_path / "models", holdout_fraction=holdout)
    assert port._machine_window(meta) == jax._machine_window(meta)
    override = dict(window_start=start, window_end=end, holdout_fraction=holdout)
    assert (port_manager(tmp_path / "models", **override)._machine_window({"dataset": {}})
            == jax_manager(tmp_path / "models", **override)._machine_window({"dataset": {}}))


# -- the converted fixture -----------------------------------------------------


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return build_pair(tmp_path_factory.mktemp("lifecycle-pair"))


def _windows(pair):
    jax = jax_manager(pair / "jax" / "models")
    port = port_manager(pair / "port" / "models")
    jax_live = str(pair / "jax" / "models" / BASE_REVISION)
    port_live = str(pair / "port" / "models" / BASE_REVISION)
    out = {}
    for name in NAMES:
        jax_meta = jax._load_metadata(jax_live, name)
        port_meta = port._load_metadata(port_live, name)
        window = port._machine_window(port_meta)
        assert window == jax._machine_window(jax_meta)
        out[name] = dict(
            jax_meta=jax_meta, port_meta=port_meta, window=window,
            jax_model=jax._load_monitorable(jax_live, name),
            port_model=port._load_monitorable(port_live, name),
            jax_data=jax._fetch_window(jax_meta, window["start"], window["end"]),
            port_data=port._fetch_window(port_meta, window["start"], window["end"]),
        )
    return jax, port, out


@pytest.mark.parametrize("spec", ["", "drift:shift:lc-m-1;drift:shift:lc-m-3@scale:2.5"])
def test_per_machine_statistics_match_jax(pair, monkeypatch, spec):
    """Each converted machine's window, drift statistics (ratio,
    exceedance) with and without ``drift:shift``, and its live model's
    shadow score on the holdout tail, against JAX's ``_score_one`` and
    ``shadow_score`` (rtol 1e-5)."""
    jax, port, machines = _windows(pair)
    if spec:
        _set_faults(monkeypatch, spec)
    for name, m in machines.items():
        jax_X, jax_y = m["jax_data"]
        port_X, port_y = m["port_data"]
        # the data layers agree to float64 rounding
        np.testing.assert_allclose(port_X.values, jax_X.to_numpy(), rtol=1e-12)
        assert port_X.columns == list(jax_X.columns)
        np.testing.assert_array_equal(
            port_X.index, jax_X.index.tz_convert(None).to_numpy().astype("datetime64[ns]"))
        got = port._score_one(name, m["port_model"], m["port_data"], BASE_REVISION,
                              m["port_meta"])
        want = jax._score_one(name, m["jax_model"], m["jax_data"], BASE_REVISION,
                              m["jax_meta"])
        np.testing.assert_allclose(got.ratio, want.ratio, rtol=1e-5)
        assert got.exceedance == pytest.approx(want.exceedance, rel=1e-5)
        assert got.n_observations == want.n_observations
        split = parse_timestamp(m["window"]["split"])
        hold = port_X.index >= np.datetime64(split.replace(tzinfo=None), "ns")
        jax_hold = jax_X.index >= pd.Timestamp(m["window"]["split"])
        np.testing.assert_allclose(
            shadow_score(m["port_model"], port_X.values[hold], port_y.values[hold]),
            jax_shadow_score(m["jax_model"], jax_X.loc[jax_hold], jax_y.loc[jax_hold]),
            rtol=1e-5)
    if spec:
        shifted = port.monitor.state("lc-m-1").ewma_ratio
        clean = port.monitor.state("lc-m-0").ewma_ratio
        assert shifted > 10 * clean


def test_warm_start_refit_matches_jax(pair, monkeypatch):
    """From the same served weights, the port's refit (CV folds and final
    fit, warm) lands within 1e-4 of JAX's, its thresholds within 1e-4
    too, and both moved away from the served weights."""
    monkeypatch.setattr(FleetTrainer, "_shuffle_noise", jax_shuffle_noise)
    jax, port, machines = _windows(pair)
    names = ["lc-m-1", "lc-m-2"]
    jax_candidates, jax_quarantined, _ = jax._refit(
        names, {n: machines[n]["jax_meta"] for n in names},
        {n: machines[n]["window"] for n in names},
        {n: machines[n]["jax_model"] for n in names})
    candidates, quarantined, failures = port._refit(
        names, {n: machines[n]["port_meta"] for n in names},
        {n: machines[n]["window"] for n in names},
        {n: machines[n]["port_model"] for n in names})
    assert quarantined == jax_quarantined == {} and failures == {}
    assert sorted(candidates) == sorted(jax_candidates) == names
    for name in names:
        jax_model = jax_candidates[name][0]
        want = convert.state_dict_from_flax(_find_jax_estimator(jax_model).params_,
                                            "AutoEncoder")
        got = estimator_params(_find_torch_estimator(candidates[name][0]))
        served = estimator_params(_find_torch_estimator(machines[name]["port_model"]))
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-4)
        assert max(float(np.abs(got[k] - served[k]).max()) for k in got) > 1e-3
        np.testing.assert_allclose(candidates[name][0].aggregate_threshold_,
                                   jax_model.aggregate_threshold_, rtol=1e-4)
        machine = candidates[name][1]
        assert machine.dataset.to_dict()["train_end_date"] == machines[name]["window"]["split"]


def test_warm_params_from_artifacts(pair):
    params = warm_params_from_artifacts(pair / "port" / "models" / BASE_REVISION,
                                        ["lc-m-0", "no-such-machine"], device="cpu")
    assert list(params) == ["lc-m-0"]
    model = serializer.load(pair / "port" / "models" / BASE_REVISION / "lc-m-0", "cpu")
    jax_model = jax_serializer.load(pair / "jax" / "models" / BASE_REVISION / "lc-m-0")
    want = convert.state_dict_from_flax(_find_jax_estimator(jax_model).params_, "AutoEncoder")
    for key, value in want.items():
        np.testing.assert_array_equal(params["lc-m-0"][key], value)
    degraded = degrade_params(params["lc-m-0"], 10.0)
    np.testing.assert_allclose(degraded[key], value * 10.0)
    assert _find_torch_estimator(model) is not None
