"""
Fleet builds and fold-parallel CV: the port's bucketing
(``gordo_tpu_torch.parallel.bucketing``), ``FleetModelBuilder`` and
``build-fleet`` (``gordo_tpu_torch.builder.fleet_build``,
``gordo_tpu_torch.cli``) and the detector's fold-parallel CV against the
JAX package's.

Parity builds start from the JAX init (``_initial_state``) and, where the
JAX trainer shuffles (a feedforward bucket), take JAX's shuffle draws
(``FleetTrainer._shuffle_noise``: ``jax.random.uniform`` of each
machine's solo key folded with the epoch; the machines of
``examples/machines_fleet.yaml`` all have seed 0), so both see the same
batches. Tolerances: predictions and CV scores 1e-4; detector thresholds
1e-4 (feedforward) and 1e-3 (Transformer: a rolling min/max of errors of
a deeper float32 net in another summation order).
"""

import copy
import json

import jax
import numpy as np
import pandas as pd
import pytest
import torch
import yaml
from click.testing import CliRunner
from sklearn.preprocessing import RobustScaler

from gordo_tpu import serializer as jax_serializer
from gordo_tpu.builder.build_model import ModelBuilder as JaxModelBuilder
from gordo_tpu.builder.fleet_build import FleetModelBuilder as JaxFleetModelBuilder
from gordo_tpu.cli.cli import build_fleet as jax_build_fleet
from gordo_tpu.machine import Machine as JaxMachine
from gordo_tpu.models import AutoEncoder as JaxAutoEncoder
from gordo_tpu.models import TransformerAutoEncoder as JaxTransformerAutoEncoder
from gordo_tpu.models.anomaly import DiffBasedAnomalyDetector as JaxDetector
from gordo_tpu.models.core import solo_init_key
from gordo_tpu.parallel import bucketing as jax_bucketing
from gordo_tpu.workflow.config_elements.normalized_config import NormalizedConfig as JaxConfig
from gordo_tpu.workflow.workflow_generator import get_dict_from_yaml as jax_dict_from_yaml
from gordo_tpu_torch import serializer
from gordo_tpu_torch.builder import ModelBuilder
from gordo_tpu_torch.builder.fleet_build import FleetModelBuilder
from gordo_tpu_torch.cli import cli
from gordo_tpu_torch.data import _get_dataset
from gordo_tpu_torch.machine import Machine
from gordo_tpu_torch.models import AutoEncoder, TransformerAutoEncoder
from gordo_tpu_torch.models.anomaly.diff import DiffBasedAnomalyDetector
from gordo_tpu_torch.models.preprocessing import RobustScaler as RobustScaling
from gordo_tpu_torch.parallel import bucketing
from gordo_tpu_torch.parallel.fleet import FleetTrainer
from gordo_tpu_torch.workflow.config_elements import NormalizedConfig
from gordo_tpu_torch.workflow.workflow_generator import get_dict_from_yaml
from gordo_tpu_torch.workflow.yaml_reader import safe_load
from tests.conftest import CONFIG_STR, GORDO_SINGLE_TARGET
from tests.test_torch_cross_validate import _jax_initial_state as _transformer_initial_state
from tests.test_torch_fleet_env import clear_fleet_env, fleet_env  # noqa: F401
from tests.test_torch_pipeline import _jax_initial_state as _feedforward_initial_state

torch.set_num_threads(1)
FLEET_YAML = "examples/machines_fleet.yaml"


def _fleet_configs():
    with open(FLEET_YAML) as fh:
        return safe_load(fh.read())


def _port_machines(configs):
    out = []
    for config in copy.deepcopy(configs):
        machine = Machine.from_config(config, project_name=config["project_name"])
        machine.model = serializer.from_definition(machine.model).into_definition()
        out.append(machine)
    return out


def _jax_machines(configs):
    out = []
    for config in copy.deepcopy(configs):
        machine = JaxMachine.from_config(config, project_name=config["project_name"])
        machine.model = jax_serializer.into_definition(jax_serializer.from_definition(machine.model))
        out.append(machine)
    return out


def _jax_shuffle_noise(self, m, n_samples, epoch):
    """The JAX fleet trainer's shuffle draws for machines of seed 0."""
    key = jax.random.fold_in(solo_init_key(0), epoch)
    noise = np.asarray(jax.random.uniform(key, (n_samples,)))
    return torch.from_numpy(np.stack([noise] * m))


# -- bucketing -----------------------------------------------------------------


def _mixed_configs():
    """The example fleet, the conftest project's machines, and machines of
    3, 4, 5 and 7 tags with one definition (ragged widths)."""
    configs = _fleet_configs()
    normed = NormalizedConfig(get_dict_from_yaml(__import__("io").StringIO(CONFIG_STR)),
                              project_name="p")
    configs += [dict(m.to_dict(), project_name="p") for m in normed.machines]
    for n in (3, 4, 5, 7):
        tags = [f"tag-{i}" for i in range(n)]
        configs.append({
            "name": f"ragged-{n}", "project_name": "p",
            "dataset": {"type": "RandomDataset", "tags": tags, "target_tag_list": tags,
                        "train_start_date": "2019-01-01T00:00:00+00:00",
                        "train_end_date": "2019-01-02T00:00:00+00:00", "asset": "gra"},
            "model": {"gordo_tpu.models.AutoEncoder": {"kind": "feedforward_hourglass"}},
        })
    return configs


@pytest.mark.parametrize("policy", ["exact", "padded"])
def test_bucket_membership_matches_jax(policy):
    configs = _mixed_configs()
    got = bucketing.get_policy(policy).plan(_port_machines(configs))
    want = jax_bucketing.get_policy(policy).plan(_jax_machines(configs))
    assert [[m.name for m in p.machines] for p in got] == [[m.name for m in p.machines]
                                                           for p in want]
    assert [(p.key.n_features, p.key.n_features_out, p.dims) for p in got] == [
        (p.key.n_features, p.key.n_features_out, p.dims) for p in want]
    assert [p.padding_waste() for p in got] == [p.padding_waste() for p in want]
    assert bucketing.plan_padding_waste(got) == jax_bucketing.plan_padding_waste(want)
    # deterministic from the config alone
    again = bucketing.get_policy(policy).plan(_port_machines(configs))
    assert [p.key for p in again] == [p.key for p in got]
    grouped = bucketing.bucket_machines(_port_machines(configs))
    assert [[m.name for m in b] for b in grouped.values()] == [
        [m.name for m in b] for b in jax_bucketing.bucket_machines(_jax_machines(configs)).values()]


@pytest.mark.parametrize("n", [1, 255, 256, 257, 4097, 21745])
def test_bucket_sizes_match_jax(n):
    assert bucketing.timestep_bucket(n) == jax_bucketing.timestep_bucket(n)
    assert bucketing.dimension_bucket(n) == jax_bucketing.dimension_bucket(n)
    assert bucketing.PaddedBucketPolicy().program_dims([n, 3], [2, n]) == (
        jax_bucketing.PaddedBucketPolicy().program_dims([n, 3], [2, n]))


@pytest.mark.parametrize("bad", [0, -3, 2.5])
def test_degenerate_bucket_lengths_raise_as_in_jax(bad):
    for module in (bucketing, jax_bucketing):
        with pytest.raises(ValueError):
            module.timestep_bucket(bad)
    with pytest.raises(ValueError, match="power of two"):
        bucketing.dimension_bucket(4, min_bucket=3)
    with pytest.raises(ValueError, match="ragged"):
        bucketing.ExactBucketPolicy().program_dims([3, 4], [3, 3])
    with pytest.raises(ValueError, match="Unknown bucket policy"):
        bucketing.get_policy("sideways")


# -- build-fleet against the JAX FleetModelBuilder ---------------------------


@pytest.fixture(scope="module")
def fleet_pair(tmp_path_factory):
    """(port collection, JAX build results, the port's stdout) of
    examples/machines_fleet.yaml: the port through ``build-fleet --device
    cpu``, JAX through its FleetModelBuilder."""
    out = tmp_path_factory.mktemp("fleet") / "collection"
    text = open(FLEET_YAML).read()
    with pytest.MonkeyPatch.context() as mp:
        clear_fleet_env(mp)
        mp.setattr(AutoEncoder, "_initial_state", _feedforward_initial_state)
        mp.setattr(FleetTrainer, "_shuffle_noise", _jax_shuffle_noise)
        code = cli.main(["build-fleet", text, str(out), "--device", "cpu"])
    assert code == 0
    jax_builder = JaxFleetModelBuilder(_jax_machines(yaml.safe_load(text)))
    return out, jax_builder, jax_builder.build()


def test_build_fleet_buckets_match_jax(fleet_pair):
    out, jax_builder, _ = fleet_pair
    telemetry = json.loads((out / "telemetry_report.json").read_text())
    assert [b["machines"] for b in telemetry["buckets"]] == [
        [m.name for m in plan.machines] for plan in jax_builder.plan_]
    report = json.loads((out / "build_report.json").read_text())
    assert set(report) == set(jax_builder.build_report_)
    assert (report["n_built"], report["n_failed"], report["failed"]) == (4, 0, [])


def test_build_fleet_predictions_and_scores_match_jax(fleet_pair):
    out, _, jax_results = fleet_pair
    for jax_model, jax_machine in jax_results:
        port_model = serializer.load(out / jax_machine.name, device="cpu")
        metadata = serializer.load_metadata(out / jax_machine.name)
        X, _, _ = _get_dataset(metadata["dataset"]).get_data()
        np.testing.assert_allclose(port_model.predict(X), jax_model.predict(X), atol=1e-4,
                                   err_msg=jax_machine.name)
        got = metadata["metadata"]["build_metadata"]["model"]
        want = jax_machine.to_dict()["metadata"]["build_metadata"]["model"]
        assert set(got) == set(want)
        assert got["cross_validation"]["splits"] == want["cross_validation"]["splits"]
        for metric, folds in want["cross_validation"]["scores"].items():
            for fold, value in folds.items():
                np.testing.assert_allclose(got["cross_validation"]["scores"][metric][fold], value,
                                           rtol=1e-4, atol=1e-6, err_msg=f"{metric} {fold}")
        assert got["model_offset"] == want["model_offset"]
        assert set(got["model_meta"]["history"]["params"]) == set(
            want["model_meta"]["history"]["params"])


def _failing_fetch(original):
    def fetch(self, machine):
        if machine.name == "example-pump-1":
            raise ConnectionError("simulated outage")
        return original(self, machine)
    return fetch


def test_on_error_skip_matches_jax(tmp_path, fleet_env, capsys):
    monkeypatch = fleet_env
    """One machine's fetch fails: both commands exit 0, print the same
    FAILED line and record the same casualty in build_report.json."""
    text = open(FLEET_YAML).read()
    monkeypatch.setattr(FleetModelBuilder, "_fetch_one", _failing_fetch(FleetModelBuilder._fetch_one))
    monkeypatch.setattr(JaxFleetModelBuilder, "_fetch_one",
                        _failing_fetch(JaxFleetModelBuilder._fetch_one))
    code = cli.main(["build-fleet", text, str(tmp_path / "port"), "--device", "cpu",
                     "--on-error", "skip", "--fetch-retries", "0"])
    port_lines = [line for line in capsys.readouterr().out.splitlines() if line.startswith("FAILED")]
    result = CliRunner().invoke(
        jax_build_fleet,
        [text, str(tmp_path / "jax"), "--on-error", "skip", "--fetch-retries", "0",
         "--no-aot-cache"],
    )
    jax_lines = [line for line in result.output.splitlines() if line.startswith("FAILED")]
    assert (code, port_lines) == (result.exit_code, jax_lines)
    assert port_lines == ["FAILED example-pump-1 (fetch): ConnectionError('simulated outage')"]
    port_report = json.loads((tmp_path / "port" / "build_report.json").read_text())
    jax_report = json.loads((tmp_path / "jax" / "build_report.json").read_text())
    assert port_report["failed"] == jax_report["failed"]
    for key in ("n_machines", "n_built", "n_failed", "n_quarantined", "quarantined", "on_error"):
        assert port_report[key] == jax_report[key], key
    assert sorted(p.name for p in (tmp_path / "port").iterdir() if p.is_dir()) == [
        "example-compressor-0", "example-compressor-1", "example-pump-0"]


def test_on_error_raise_exits_with_the_failure(tmp_path, fleet_env):
    monkeypatch = fleet_env
    text = open(FLEET_YAML).read()
    monkeypatch.setattr(FleetModelBuilder, "_fetch_one", _failing_fetch(FleetModelBuilder._fetch_one))
    code = cli.main(["build-fleet", text, str(tmp_path), "--device", "cpu", "--fetch-retries", "0"])
    assert code == cli.exit_code(ConnectionError) == 1


@pytest.mark.parametrize(
    "flag,value",
    [("--workers", "2"), ("--worker-id", "0"), ("--lease-ttl", "5"), ("--max-attempts", "2"),
     ("--ledger-status", "x"), ("--aot-cache", "1"),
     ("--model-register-dir", "x")],
)
def test_unported_options_name_their_roadmap_item(flag, value, capsys, fleet_env):
    with pytest.raises(SystemExit) as exit_info:
        cli.main(["build-fleet", "[]", "/nonexistent", "--device", "cpu", flag, value])
    assert exit_info.value.code == 2
    err = capsys.readouterr().err
    assert f"build-fleet {flag} is not ported yet (ROADMAP.md queue 1 item" in err


def test_options_that_ask_for_what_the_port_does_pass(fleet_env):
    monkeypatch = fleet_env
    parser = cli._parser()
    args = parser.parse_args(["build-fleet", "[]", "/x", "--precision", "float32",
                              "--prefetch-depth", "0", "--workers", "1", "--no-resume",
                              "--no-aot-cache"])
    cli._refuse_unported(parser, args)
    monkeypatch.setenv("GORDO_AOT_CACHE", "1")
    with pytest.raises(SystemExit):
        cli._refuse_unported(parser, parser.parse_args(["build-fleet", "[]", "/x"]))


# -- the detector's fold-parallel CV ------------------------------------------


def _series(n_rows, n_features, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n_rows)[:, None]
    wave = np.sin(2 * np.pi * t / 144 + np.arange(n_features))
    return (wave + 0.1 * rng.normal(size=(n_rows, n_features))).astype(np.float32)


CV_CASES = {
    "feedforward": (JaxAutoEncoder, AutoEncoder, _feedforward_initial_state,
                    dict(kind="feedforward_hourglass", epochs=2, batch_size=16, shuffle=False,
                         seed=4), 4, 1e-4),
    "transformer-flash": (JaxTransformerAutoEncoder, TransformerAutoEncoder,
                          _transformer_initial_state,
                          dict(kind="transformer_model", lookback_window=8, d_model=16,
                               n_heads=2, n_layers=1, epochs=1, batch_size=32, dropout=0.0,
                               seed=7, attention_impl="flash"), 3, 1e-3),
}


@pytest.mark.parametrize("case", sorted(CV_CASES))
def test_fold_parallel_cv_matches_jax(case, monkeypatch):
    jax_cls, port_cls, initial_state, kwargs, n_features, rtol = CV_CASES[case]
    X = _series(180, n_features, seed=11)
    tags = [f"tag-{i}" for i in range(n_features)]
    frame = pd.DataFrame(X, columns=tags)
    jax_detector = JaxDetector(base_estimator=jax_cls(**kwargs))
    jax_cv = jax_detector.cross_validate(
        X=frame, y=frame,
        scoring=JaxModelBuilder.build_metrics_dict(JaxModelBuilder.metrics_from_list(None), frame,
                                                   scaler=RobustScaler()),
    )
    monkeypatch.setattr(port_cls, "_initial_state", initial_state)
    port_detector = DiffBasedAnomalyDetector(port_cls(**kwargs))
    port_cv = port_detector.cross_validate(
        X=X, y=X, device="cpu",
        scoring=ModelBuilder.build_metrics_dict(ModelBuilder.metrics_from_list(None), tags, X,
                                                RobustScaling()),
    )
    assert jax_detector.cv_fast_path_ is port_detector.cv_fast_path_ is True
    for name in (k for k in jax_cv if k.startswith("test_")):
        np.testing.assert_allclose(port_cv[name], jax_cv[name], rtol=1e-4, atol=1e-5, err_msg=name)
    np.testing.assert_allclose(port_detector.feature_thresholds_,
                               jax_detector.feature_thresholds_.to_numpy(), rtol=rtol)
    np.testing.assert_allclose(port_detector.aggregate_threshold_,
                               jax_detector.aggregate_threshold_, rtol=rtol)
    got, want = port_detector.get_metadata(), jax_detector.get_metadata()
    assert got["cv-fast-path"] == want["cv-fast-path"] is True
    assert len(port_cv["estimator"]) == 3


def test_pipeline_detector_keeps_the_sequential_path():
    """The conftest single-target detector wraps a Pipeline: JAX refuses
    its fold-parallel path, and so does the port (``cv-fast-path`` false
    in both)."""
    jax_config = JaxConfig(jax_dict_from_yaml(__import__("io").StringIO(CONFIG_STR)),
                           project_name="p")
    config = NormalizedConfig(get_dict_from_yaml(__import__("io").StringIO(CONFIG_STR)),
                              project_name="p")
    jax_machine = next(m for m in jax_config.machines if m.name == GORDO_SINGLE_TARGET)
    machine = next(m for m in config.machines if m.name == GORDO_SINGLE_TARGET)
    X = _series(120, 4, seed=2)
    frame = pd.DataFrame(X, columns=[f"tag-{i}" for i in range(4)])
    jax_detector = jax_serializer.from_definition(jax_machine.model)
    jax_detector.cross_validate(X=frame, y=frame)
    detector = serializer.from_definition(machine.model)
    assert not detector._folds_batchable(X, X, __import__(
        "gordo_tpu_torch.models.utils", fromlist=["TimeSeriesSplit"]).TimeSeriesSplit(3))
    detector.cross_validate(X=X, y=X, device="cpu")
    assert detector.get_metadata()["cv-fast-path"] is False
    assert jax_detector.get_metadata()["cv-fast-path"] is False


def test_a_failing_fold_parallel_fit_raises(monkeypatch):
    """No silent fallback to the sequential path (JAX falls back)."""
    def broken(self, *args, **kwargs):
        raise ValueError("broken fleet fit")

    monkeypatch.setattr(FleetTrainer, "fit", broken)
    detector = DiffBasedAnomalyDetector(AutoEncoder(kind="feedforward_hourglass", epochs=1))
    X = _series(60, 3, seed=1)
    with pytest.raises(ValueError, match="broken fleet fit"):
        detector.cross_validate(X=X, y=X, device="cpu")


def test_fetch_retries_and_timeout_record_casualties(monkeypatch):
    """A fetch that fails once is retried and builds; one that never
    returns in time is a casualty under ``on_error="skip"``; one that
    keeps failing is a MachineFetchError's cause with its attempt count."""
    from gordo_tpu_torch.builder import fleet_build

    monkeypatch.setattr(fleet_build, "backoff_seconds", lambda attempt: 0.0)
    calls = {}
    original = FleetModelBuilder._fetch_one

    def flaky(self, machine):
        calls[machine.name] = calls.get(machine.name, 0) + 1
        if machine.name == "example-pump-0" and calls[machine.name] == 1:
            raise ConnectionError("first attempt")
        if machine.name == "example-pump-1":
            __import__("time").sleep(2.0)
        if machine.name == "example-compressor-0":
            raise ConnectionError("down")
        return original(self, machine)

    monkeypatch.setattr(FleetModelBuilder, "_fetch_one", flaky)
    machines = _port_machines(_fleet_configs())
    builder = FleetModelBuilder(machines, on_error="skip", fetch_retries=1, fetch_timeout=0.5,
                                device="cpu")
    fetched, failures = builder.fetch_data(machines)
    assert [item["machine"].name for item in fetched] == ["example-pump-0", "example-compressor-1"]
    assert calls["example-pump-0"] == 2
    assert failures == [
        {"machine": "example-pump-1", "phase": "fetch",
         "error": "TimeoutError: fetch exceeded 0.5s", "attempts": None},
        {"machine": "example-compressor-0", "phase": "fetch",
         "error": "ConnectionError('down')", "attempts": 2},
    ]


def test_short_windowed_machine_is_refused_before_training():
    """A windowed machine with fewer rows than one window: a casualty
    under ``on_error="skip"`` (the others build), an InsufficientDataError
    under ``"raise"``."""
    from gordo_tpu_torch.data import InsufficientDataError

    def config(name, end):
        return {
            "name": name, "project_name": "p",
            "dataset": {"type": "RandomDataset", "tags": ["tag-0", "tag-1"],
                        "train_start_date": "2019-01-01T00:00:00+00:00",
                        "train_end_date": end, "asset": "gra"},
            "model": {"gordo_tpu.models.TransformerAutoEncoder": {
                "kind": "transformer_model", "lookback_window": 100, "d_model": 8,
                "n_heads": 2, "n_layers": 1, "epochs": 1, "batch_size": 64}},
        }

    configs = [config("long", "2019-01-04T00:00:00+00:00"),
               config("short", "2019-01-01T12:00:00+00:00")]
    builder = FleetModelBuilder(_port_machines(configs), on_error="skip", device="cpu")
    built = builder.build()
    assert [machine.name for _, machine in built] == ["long"]
    (failure,) = builder.build_failures_
    assert failure["machine"] == "short" and failure["phase"] == "build"
    assert failure["error"].startswith("InsufficientDataError: short: ")
    with pytest.raises(InsufficientDataError, match="needs at least 100"):
        FleetModelBuilder(_port_machines(configs), device="cpu").build()


def test_fetch_timeout_holds_when_hung_fetches_hold_every_thread(monkeypatch):
    """One fetch thread, held by a hung fetch: the machine queued behind it
    times out once nothing has resolved for a whole ``fetch_timeout``,
    instead of waiting for a thread forever."""
    original = FleetModelBuilder._fetch_one

    def hung_first(self, machine):
        if machine.name == "example-pump-0":
            __import__("time").sleep(1.5)
        return original(self, machine)

    monkeypatch.setattr(FleetModelBuilder, "_fetch_one", hung_first)
    machines = _port_machines(_fleet_configs())[:2]
    builder = FleetModelBuilder(machines, on_error="skip", fetch_timeout=0.3, data_threads=1,
                                device="cpu")
    fetched, failures = builder.fetch_data(machines)
    assert fetched == []
    assert [f["machine"] for f in failures] == ["example-pump-0", "example-pump-1"]
    assert {f["error"] for f in failures} == {"TimeoutError: fetch exceeded 0.3s"}
