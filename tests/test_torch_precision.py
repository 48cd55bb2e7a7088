"""
Per-machine bf16 inference precision: ``gordo_tpu_torch.parallel.
precision``, the precision-aware ``predict`` of the port's estimators and
``FleetTrainer``, the fleet builder's calibration and ``build-fleet
--precision``, and bf16 serving groups, against the JAX package's.

Tolerances: bf16 outputs within 2^-7 relative of JAX's bf16 outputs (both
round the weights and the input to bfloat16; a float32 model's layers then
compute in float32, as Flax's ``nn.Dense(dtype=float32)`` promotes them);
calibration MAE deltas within rtol 5e-2 of JAX's on the same float32
weights (a difference of two MAEs, each in another summation order).
A default build's artifacts are compared by their definition bytes and
their arrays' bytes: ``np.savez`` stamps each member with the time it
was written, so two archives never agree byte for byte.
"""

import json
import logging

import numpy as np
import pytest
import torch
import yaml

from gordo_tpu.builder.fleet_build import FleetModelBuilder as JaxFleetModelBuilder
from gordo_tpu.builder.fleet_build import _find_jax_estimator
from gordo_tpu.machine import Machine as JaxMachine
from gordo_tpu.parallel import precision as jax_precision
from gordo_tpu.server.fleet_serving import FleetScorer as JaxFleetScorer
from gordo_tpu_torch import serializer
from gordo_tpu_torch.builder.fleet_build import FleetModelBuilder, _find_torch_estimator
from gordo_tpu_torch.cli import cli
from gordo_tpu_torch.data import _get_dataset
from gordo_tpu_torch.machine import Machine
from gordo_tpu_torch.parallel.bucketing import timestep_bucket
from gordo_tpu_torch.parallel.fleet import FleetTrainer, StackedData
from gordo_tpu_torch.parallel.precision import (
    DEFAULT_PRECISION_TOLERANCE,
    PRECISIONS,
    cast_params,
    mae,
    mae_parity,
    resolve_precision,
)
from gordo_tpu_torch.server.fleet_serving import FleetScorer
from tests.test_torch_fleet_env import fleet_env  # noqa: F401
from tests.test_torch_fleet_serving import jax_feedforward, jax_transformers, to_port

torch.set_num_threads(1)
BF16_RTOL = 2.0 ** -7


# -- the vocabulary ----------------------------------------------------------------


@pytest.mark.parametrize("value", [None, "float32", "Float32", "bf16", " auto ", "BF16"])
def test_resolve_precision_matches_jax(value):
    assert PRECISIONS == jax_precision.PRECISIONS
    assert DEFAULT_PRECISION_TOLERANCE == jax_precision.DEFAULT_PRECISION_TOLERANCE
    assert resolve_precision(value) == jax_precision.resolve_precision(value)


def test_resolve_precision_refuses_what_jax_refuses():
    with pytest.raises(ValueError, match="unknown precision"):
        resolve_precision("fp8")
    with pytest.raises(ValueError, match="unknown precision"):
        jax_precision.resolve_precision("fp8")


@pytest.mark.parametrize("pair", [(1.0, 1.1, 0.25), (1.0, 2.0, 0.25), (0.0, 0.0, 0.25),
                                  (0.3, 0.2999, 0.0), (2.5, 1.0, 1.0)])
def test_mae_parity_matches_jax(pair):
    assert mae_parity(*pair) == jax_precision.mae_parity(*pair)


def test_mae_matches_jax():
    rng = np.random.default_rng(1)
    p, y = rng.normal(size=(20, 3)).astype("float32"), rng.normal(size=(20, 3))
    assert mae(p, y) == jax_precision.mae(p, y)
    assert mae(np.zeros((0, 3)), np.zeros((0, 3))) == 0.0


def test_cast_params_narrows_floats_and_spares_ints():
    tree = {"w": torch.ones((2, 2)), "stack": torch.ones((4, 3, 2)),
            "step": torch.tensor(7, dtype=torch.int32)}
    cast = cast_params(tree, torch.bfloat16)
    assert cast["w"].dtype == cast["stack"].dtype == torch.bfloat16
    assert cast["stack"].shape == (4, 3, 2)
    assert cast["step"].dtype == torch.int32 and cast["step"] is tree["step"]


# -- bf16 predict against JAX --------------------------------------------------------


@pytest.fixture(scope="module")
def bf16_pairs():
    """JAX and port estimators of the same weights, every one bf16: three
    feedforward AutoEncoders and two flash Transformers."""
    jax_ests = {**jax_feedforward(3), **jax_transformers(2)}
    port_ests = to_port(jax_ests)
    for est in list(jax_ests.values()) + list(port_ests.values()):
        est.precision_ = "bf16"
    return jax_ests, port_ests


def test_bf16_solo_predict_is_float32_and_matches_jax(bf16_pairs):
    """A row-wise estimator predicts in bf16 weights; a windowed one in
    float32 weights, as the JAX windowed predict does (it never reads
    ``precision_``)."""
    jax_ests, port_ests = bf16_pairs
    rng = np.random.default_rng(3)
    for name, est in port_ests.items():
        X = rng.normal(size=(30, est.n_features_)).astype("float32")
        got, want = est.predict(X), np.asarray(jax_ests[name].predict(X))
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=1e-6, err_msg=name)
        est.precision_ = "float32"
        float32 = est.predict(X)
        est.precision_ = "bf16"
        assert np.array_equal(float32, got) == name.startswith("tf"), name


def test_bf16_fleet_predict_is_float32_and_matches_jax(bf16_pairs):
    jax_ests, port_ests = bf16_pairs
    rng = np.random.default_rng(4)
    inputs = {name: rng.normal(size=(24 + 3 * i, est.n_features_)).astype("float32")
              for i, (name, est) in enumerate(port_ests.items())}
    port_scorer, jax_scorer = FleetScorer(port_ests), JaxFleetScorer(jax_ests)
    assert port_scorer.n_groups == jax_scorer.n_groups == 2
    assert set(port_scorer.group_precisions().values()) == {"bf16"}
    got, want = port_scorer.predict(inputs), jax_scorer.predict(inputs)
    for name in inputs:
        assert got[name].dtype == np.float32
        np.testing.assert_allclose(got[name], np.asarray(want[name]), rtol=BF16_RTOL, atol=1e-6,
                                   err_msg=name)
        if name.startswith("ff"):
            np.testing.assert_allclose(got[name], port_ests[name].predict(inputs[name]),
                                       rtol=1e-5, atol=1e-6, err_msg=name)


def test_resident_stack_of_a_bf16_group_is_bfloat16(bf16_pairs):
    _, port_ests = bf16_pairs
    (group,) = [g for g in FleetScorer(port_ests)._groups if g["windowed"]]
    assert {value.dtype for value in group["params"].values()} == {torch.bfloat16}


def test_bf16_and_float32_machines_split_into_two_groups():
    jax_ests = jax_feedforward(3)
    jax_ests["ff-1"].precision_ = "bf16"
    port_ests = to_port(jax_ests)
    port_ests["ff-1"].precision_ = "bf16"
    port_scorer, jax_scorer = FleetScorer(port_ests), JaxFleetScorer(jax_ests)
    assert port_scorer.n_groups == jax_scorer.n_groups == 2
    assert port_scorer.group_precisions() == {"ff-0": "float32", "ff-1": "bf16",
                                              "ff-2": "float32"}
    assert sorted(g["precision"] for g in port_scorer._groups) == sorted(
        g["precision"] for g in jax_scorer._groups)


def test_fleet_trainer_bf16_predict_matches_the_bf16_scorer(bf16_pairs):
    _, port_ests = bf16_pairs
    names = [n for n in port_ests if n.startswith("tf")]
    ests = [port_ests[n] for n in names]
    trainer = FleetTrainer(ests[0]._build_spec(), lookahead=0, device="cpu")
    params = trainer.stack_params([dict(e.spec_.module.state_dict()) for e in ests])
    X = np.random.default_rng(5).normal(size=(len(ests), 32, 3)).astype("float32")
    out = trainer.predict(params, X, precision="bf16")
    assert out.dtype == np.float32
    served = FleetScorer(dict(zip(names, ests))).predict(dict(zip(names, X)))
    for i, name in enumerate(names):
        np.testing.assert_allclose(out[i], served[name], rtol=1e-5, atol=1e-6)


# -- the calibration against JAX's ------------------------------------------------------


def _machine_config(name, seed, model):
    tags = ["tag-0", "tag-1", "tag-2"]
    return {
        "name": name, "project_name": "precision-test",
        "dataset": {"type": "RandomDataset", "tags": tags, "target_tag_list": tags,
                    "train_start_date": "2019-01-01T00:00:00+00:00",
                    "train_end_date": "2019-01-03T00:00:00+00:00", "asset": "gra"},
        "model": model, "evaluation": {"seed": seed},
    }


FEEDFORWARD = {"gordo_tpu.models.AutoEncoder": {"kind": "feedforward_hourglass", "epochs": 1}}
TRANSFORMER = {"gordo_tpu.models.TransformerAutoEncoder": {
    "kind": "transformer_model", "lookback_window": 8, "d_model": 16, "n_heads": 2,
    "n_layers": 1, "epochs": 1, "batch_size": 64, "attention_impl": "dense"}}
CALIBRATION_CONFIGS = [_machine_config(f"ff-{i}", i, FEEDFORWARD) for i in range(3)] + [
    _machine_config(f"tf-{i}", i, TRANSFORMER) for i in range(2)]


@pytest.fixture(scope="module")
def jax_auto_build():
    machines = [JaxMachine.from_config(c, project_name=c["project_name"])
                for c in yaml.safe_load(json.dumps(CALIBRATION_CONFIGS))]
    builder = JaxFleetModelBuilder(machines, precision="auto")
    return builder, builder.build()


def test_auto_decisions_and_deltas_match_jax_on_the_same_weights(jax_auto_build):
    """The JAX build's float32 weights, carried over, calibrated by the
    port's builder on the port's data layer: the same decisions, deltas
    within rtol 5e-2."""
    jax_builder, jax_pairs = jax_auto_build
    jax_ests = {m.name: _find_jax_estimator(model) for model, m in jax_pairs}
    want = jax_builder.precision_decisions_
    assert set(want) == set(jax_ests)
    port_builder = FleetModelBuilder([], device="cpu", precision="auto")
    got = {}
    for prefix in ("ff-", "tf-"):
        names = sorted(n for n in jax_ests if n.startswith(prefix))
        port_ests = to_port({n: jax_ests[n] for n in names})
        ests = [port_ests[n] for n in names]
        configs = {c["name"]: c for c in CALIBRATION_CONFIGS}
        Xs = [np.asarray(_get_dataset(configs[n]["dataset"]).get_data()[0], dtype=np.float32)
              for n in names]
        spec = ests[0]._build_spec()
        lookahead = ests[0].lookahead if spec.windowed else 0
        trainer = FleetTrainer(spec, lookahead=lookahead, device="cpu")
        params = trainer.stack_params([dict(e.spec_.module.state_dict()) for e in ests])
        data = StackedData.from_ragged(Xs, Xs, n_timesteps=timestep_bucket(max(map(len, Xs))),
                                       device="cpu")
        got.update(port_builder._calibrate_precision(
            trainer, params, data, Xs, Xs, ests, names, [3] * len(names), spec, lookahead))
        for n, est in zip(names, ests):
            assert est.precision_ == got[n]["precision"]
    assert {n: r["precision"] for n, r in got.items()} == {
        n: r["precision"] for n, r in want.items()}
    for name, record in want.items():
        assert record["mae_delta"] > 0
        np.testing.assert_allclose(got[name]["mae_delta"], record["mae_delta"], rtol=5e-2,
                                   err_msg=name)
        assert got[name]["forced"] is record["forced"] is False


def _port_machines():
    return [Machine.from_config(dict(c), project_name=c["project_name"])
            for c in yaml.safe_load(json.dumps(CALIBRATION_CONFIGS[:3]))]


def _artifact(path):
    with np.load(path / serializer.PARAMS_FILENAME) as npz:
        arrays = {name: npz[name].tobytes() for name in npz.files}
    return (path / serializer.DEFINITION_FILENAME).read_bytes(), arrays


def test_default_build_runs_no_calibration_and_writes_the_same_artifacts(tmp_path, monkeypatch):
    calls, original = [], FleetTrainer.predict

    def spy(self, *args, **kwargs):
        calls.append(kwargs.get("precision"))
        return original(self, *args, **kwargs)

    monkeypatch.setattr(FleetTrainer, "predict", spy)
    default = FleetModelBuilder(_port_machines(), device="cpu")
    default.build(tmp_path / "default")
    explicit = FleetModelBuilder(_port_machines(), device="cpu", precision="float32")
    explicit.build(tmp_path / "explicit")
    assert "bf16" not in calls
    for builder, out in ((default, "default"), (explicit, "explicit")):
        assert builder.precision_decisions_ == {}
        report = json.loads((tmp_path / out / "build_report.json").read_text())
        assert report["precision"] == {"mode": "float32", "tolerance": 0.25, "machines": {}}
    for name in ("ff-0", "ff-1", "ff-2"):
        definition, arrays = _artifact(tmp_path / "default" / name)
        assert (definition, arrays) == _artifact(tmp_path / "explicit" / name)
        assert not any(key.startswith("precision_") for key in arrays)
        assert not hasattr(_find_torch_estimator(
            serializer.load(tmp_path / "default" / name, device="cpu")), "precision_")


def test_report_precision_block_and_artifacts(tmp_path, jax_auto_build, fleet_env):
    """``--precision auto`` through the CLI: the report's block has the
    JAX report's keys, and each artifact loads back with its decision."""
    text = json.dumps(CALIBRATION_CONFIGS[:3])
    code = cli.main(["build-fleet", text, str(tmp_path), "--device", "cpu", "--precision", "auto"])
    assert code == 0
    report = json.loads((tmp_path / "build_report.json").read_text())
    want = jax_auto_build[0].build_report_["precision"]
    block = report["precision"]
    assert (block["mode"], block["tolerance"]) == ("auto", DEFAULT_PRECISION_TOLERANCE)
    assert set(block) == set(want)
    assert set(block["machines"]) == {"ff-0", "ff-1", "ff-2"}
    for name, record in block["machines"].items():
        assert set(record) == set(want["machines"][name])
        est = _find_torch_estimator(serializer.load(tmp_path / name, device="cpu"))
        assert est.precision_ == record["precision"]
        assert est.precision_mae_delta_ == pytest.approx(record["mae_delta"])
    telemetry = json.loads((tmp_path / "telemetry_report.json").read_text())
    assert telemetry["precision"] == "auto"
    assert set(telemetry["buckets"][0]["precision_decisions"]) == set(block["machines"])


def test_bf16_mode_serves_bf16_and_logs_a_breach(caplog):
    builder = FleetModelBuilder(_port_machines(), device="cpu", precision="bf16",
                                precision_tolerance=0.0)
    with caplog.at_level(logging.WARNING):
        pairs = builder.build()
    assert {r["precision"] for r in builder.precision_decisions_.values()} == {"bf16"}
    assert all(_find_torch_estimator(model).precision_ == "bf16" for model, _ in pairs)
    assert "exceeds tolerance" in caplog.text
    auto = FleetModelBuilder(_port_machines(), device="cpu", precision="auto",
                             precision_tolerance=0.0)
    auto.build()
    assert {r["precision"] for r in auto.precision_decisions_.values()} == {"float32"}


def test_build_fleet_precision_flags(capsys, fleet_env):
    parser = cli._parser()
    args = parser.parse_args(["build-fleet", "[]", "/x", "--precision", "bf16",
                              "--precision-tolerance", "0.1"])
    cli._refuse_unported(parser, args)
    assert (args.precision, args.precision_tolerance) == ("bf16", 0.1)
    for bad in (["--precision", "fp8"], ["--precision-tolerance", "-1"]):
        with pytest.raises(SystemExit) as exit_info:
            cli.main(["build-fleet", "[]", "/nonexistent", "--device", "cpu", *bad])
        assert exit_info.value.code == 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_launches_are_counted_by_kernel_and_input_type(monkeypatch, dtype):
    """``_call`` counts each launch in ``typed_launches`` under its kernel
    and its input's type (how phase 11 tells a bf16 group's forward from a
    float32 one's); a reset clears the count."""
    import contextlib
    import ctypes

    from gordo_tpu_torch.ops import flash_attention as fa

    def entry_point(*args):
        ctypes.cast(args[-1], ctypes.POINTER(ctypes.c_int))[0] = fa.FAMILIES.index("quad")
        return 0

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: Stream())
    monkeypatch.setattr(fa, "launch_counts", dict(fa.launch_counts))
    monkeypatch.setattr(fa, "kernel_launches", dict(fa.kernel_launches))
    monkeypatch.setattr(fa, "typed_launches", {})
    q = torch.zeros((2, 8, 2, 16), dtype=dtype)
    for _ in range(3):
        fa._call(fa.KERNEL, entry_point, q, ())
    name = str(dtype).replace("torch.", "")
    assert fa.typed_launches == {f"{fa.KERNEL}_quad_{name}": 3}
    fa.reset_launch_counts()
    assert fa.typed_launches == {}
