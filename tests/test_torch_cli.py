"""
The slice end to end: ``python -m gordo_tpu_torch.cli build`` over a
machine config of ``examples/config.yaml`` (the default pipeline), its
exit codes, the artifact's metadata against the JAX build's, and the two
servers' JSON on one converted default-pipeline artifact.

Tolerances: server JSON values rtol 1e-4 / atol 1e-5 (float32 nets in
another summation order), error bodies and everything not a float
exactly; ``dataset_meta`` keys and row counts exactly.
"""

import copy
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch
import yaml
from werkzeug.test import Client

import chip_smoke
from gordo_tpu import serializer as jax_serializer
from gordo_tpu.builder import ModelBuilder as JaxModelBuilder
from gordo_tpu.machine import Machine
from gordo_tpu.serializer import from_definition as jax_from_definition
from gordo_tpu.server import build_app as jax_build_app
from gordo_tpu.server import utils as jax_server_utils
from gordo_tpu.workflow.config_elements.normalized_config import NormalizedConfig
from gordo_tpu.workflow.workflow_generator import get_dict_from_yaml
from gordo_tpu_torch import convert, serializer
from gordo_tpu_torch.cli.cli import EXIT_CODES
from gordo_tpu_torch.server.app import build_app
from tests.test_torch_pipeline import default_model, jax_parts

REPO_ROOT = Path(__file__).resolve().parent.parent
PROJECT = "plant-a-anomaly"
REVISION = "1700000000000"
RTOL, ATOL = 1e-4, 1e-5


def example_machines():
    """{name: the machine as the workflow passes it (JSON)} of
    examples/config.yaml."""
    config = get_dict_from_yaml(str(REPO_ROOT / "examples" / "config.yaml"))
    machines = NormalizedConfig(config, project_name=PROJECT).machines
    return {m.name: json.loads(json.dumps(m.to_dict(), default=str)) for m in machines}


def run_build(machine, output_dir, *args, device="cpu"):
    env = dict(os.environ, MACHINE=json.dumps(machine), OUTPUT_DIR=str(output_dir))
    env.pop("GORDO_TPU_LAKE_DIR", None)
    command = [sys.executable, "-m", "gordo_tpu_torch.cli", "build", *args]
    if device:
        command += ["--device", device]
    return subprocess.run(
        command, cwd=REPO_ROOT, env=env, capture_output=True, text=True, timeout=300
    )


def test_chip_smoke_machines_are_the_example_configs():
    """chip_smoke.py reads examples/config.yaml through the port's config
    layer; its machines equal the JAX package's normalized ones, and their
    YAML text (what phase 6 hands ``build``) reads back to the same dict
    through both the port's reader and PyYAML."""
    from gordo_tpu.machine import MachineEncoder as JaxMachineEncoder
    from gordo_tpu_torch.machine import MachineEncoder
    from gordo_tpu_torch.workflow.yaml_reader import safe_load

    want = {
        m.name: json.loads(json.dumps(m.to_dict(), cls=JaxMachineEncoder))
        for m in NormalizedConfig(
            get_dict_from_yaml(str(REPO_ROOT / "examples" / "config.yaml")), project_name=PROJECT
        ).machines
    }
    machines = chip_smoke.example_machines(str(REPO_ROOT))
    assert list(machines) == list(want)
    assert set(chip_smoke.DEFAULT_ROWS) < set(machines)
    for name, machine in machines.items():
        got = json.loads(json.dumps(machine.to_dict(), cls=MachineEncoder))
        assert got == want[name], name
        text = chip_smoke.yaml_text(got)
        assert safe_load(text) == yaml.safe_load(text) == got
    assert chip_smoke.DEFAULT_ROWS == {"pump-4130": 766, "compressor-2201": 10975}


@pytest.fixture(scope="module")
def pump_builds(tmp_path_factory):
    """(port build's completed process, its artifact dir, the JAX build's
    machine dict) for pump-4130."""
    machine = example_machines()["pump-4130"]
    out = tmp_path_factory.mktemp("cli") / "pump-4130"
    result = run_build(machine, out, "--print-cv-scores")
    _, jax_machine = JaxModelBuilder(Machine.from_config(machine, project_name=PROJECT)).build()
    return result, out, jax_machine.to_dict()


def test_cli_build_writes_the_artifact(pump_builds):
    result, out, _ = pump_builds
    assert result.returncode == 0, result.stderr
    assert sorted(os.listdir(out)) == ["definition.json", "metadata.json", "params.npz"]
    assert "model parameters on cpu" in result.stderr
    scores = [line for line in result.stdout.splitlines() if "=" in line]
    assert any(line.startswith("explained-variance-score_fold-mean=") for line in scores)
    model = serializer.load(out, device="cpu")
    assert type(model.base_estimator).__name__ == "Pipeline"


def test_cli_build_metadata_matches_jax_build(pump_builds):
    _, out, jax_machine = pump_builds
    got = serializer.load_metadata(out)["metadata"]["build_metadata"]
    want = jax_machine["metadata"]["build_metadata"]
    assert set(got) == set(want)
    assert set(got["model"]) == set(want["model"])
    assert set(got["dataset"]) == set(want["dataset"]) == {"query_duration_sec", "dataset_meta"}
    assert got["dataset"]["query_duration_sec"] > 0
    got_meta, want_meta = got["dataset"]["dataset_meta"], want["dataset"]["dataset_meta"]
    assert list(got_meta) == list(want_meta)
    assert got_meta["tag_loading_metadata"] == want_meta["tag_loading_metadata"]
    assert got_meta["tag_loading_metadata"]["aggregate_metadata"]["dropped_na_length"] == 766
    for key in ("train_start_date_actual", "train_end_date_actual"):
        assert got_meta[key] == str(want_meta[key])
    cv, jax_cv = got["model"]["cross_validation"], want["model"]["cross_validation"]
    assert set(cv["scores"]) == set(jax_cv["scores"])
    assert cv["splits"] == {k: str(v) if not isinstance(v, int) else v
                            for k, v in jax_cv["splits"].items()}
    assert set(got["model"]["model_meta"]) == set(want["model"]["model_meta"])
    assert got["model"]["model_offset"] == want["model"]["model_offset"] == 0


@pytest.mark.parametrize("name", ["example-pump-0", "gordo-base-model"])
def test_cli_builds_a_bare_autoencoder(name, tmp_path):
    """A bare AutoEncoder (every machine of examples/machines_fleet.yaml, the
    conftest gordo-base-model) cross-validates through the port's numpy
    ``cross_validate``, as the JAX builder through scikit-learn's."""
    from tests.test_torch_cross_validate import bare_machines

    result = run_build(bare_machines()[name], tmp_path / name, "--print-cv-scores")
    assert result.returncode == 0, result.stderr
    assert "Cross-validated" in result.stderr
    meta = serializer.load_metadata(tmp_path / name)["metadata"]["build_metadata"]["model"]
    scores = meta["cross_validation"]["scores"]
    assert scores and all({"fold-1", "fold-2", "fold-3"} <= set(s) for s in scores.values())
    assert type(serializer.load(tmp_path / name, device="cpu")).__name__ == "AutoEncoder"


def _raw_pump_yaml() -> str:
    """examples/machines_fleet.yaml's example-pump-0 as YAML text on its
    own, raw as the file has it (no project globals), with the fit's
    shuffle off (threefry against Philox)."""
    text = (REPO_ROOT / "examples" / "machines_fleet.yaml").read_text()
    entry = text[text.index("- name: example-pump-0") : text.index("- name: example-pump-1")]
    assert entry.endswith("      batch_size: 16\n")
    return "  " + entry[2:] + "      shuffle: false\n"


def test_cli_builds_a_raw_machine_as_the_jax_build_does(tmp_path, monkeypatch):
    """A raw machine in MACHINE as YAML text is built as the JAX ``build``
    builds it (``Machine.from_config(machine, project_name=machine[
    "project_name"])``): no globals, so the default evaluation and
    unscaled CV scores equal to the JAX build's (rtol 1e-4, both fits from
    the JAX init), and the metadata's dataset (all 18 normalized keys)
    and evaluation equal to JAX's."""
    from gordo_tpu.machine import MachineEncoder as JaxMachineEncoder
    from gordo_tpu_torch.cli import cli
    from gordo_tpu_torch.models import AutoEncoder
    from tests.test_torch_pipeline import _jax_initial_state

    text = _raw_pump_yaml()
    raw = yaml.safe_load(text)
    _, jax_machine = JaxModelBuilder(
        Machine.from_config(raw, project_name=raw["project_name"])
    ).build()
    want = json.loads(json.dumps(jax_machine.to_dict(), cls=JaxMachineEncoder))
    out = tmp_path / "example-pump-0"
    monkeypatch.setenv("MACHINE", text)
    monkeypatch.setenv("OUTPUT_DIR", str(out))
    monkeypatch.setattr(AutoEncoder, "_initial_state", _jax_initial_state)
    assert cli.main(["build", "--device", "cpu"]) == 0
    got = serializer.load_metadata(out)
    assert got["evaluation"] == want["evaluation"] == {"cv_mode": "full_build"}
    assert got["dataset"] == want["dataset"] and len(got["dataset"]) == 18
    scores = got["metadata"]["build_metadata"]["model"]["cross_validation"]["scores"]
    want_scores = want["metadata"]["build_metadata"]["model"]["cross_validation"]["scores"]
    assert set(scores) == set(want_scores) and "mean-squared-error" in scores
    for metric, stats in want_scores.items():
        for stat, value in stats.items():
            np.testing.assert_allclose(
                scores[metric][stat], value, rtol=1e-4, atol=1e-7, err_msg=f"{metric} {stat}"
            )


def _machine_with(**dataset_changes):
    machine = copy.deepcopy(example_machines()["pump-4130"])
    machine["dataset"].update(dataset_changes)
    return machine


@pytest.mark.parametrize(
    "case,code,error",
    [
        ("insufficient-data", 80, "InsufficientDataError"),
        ("bad-tag", 60, "SensorTagNormalizationError"),
        ("no-card", 1, "RuntimeError"),
    ],
)
def test_cli_build_exit_codes(case, code, error, tmp_path):
    machine, device = _machine_with(), "cpu"
    if case == "insufficient-data":
        machine = _machine_with(n_samples_threshold=100_000)
    elif case == "bad-tag":
        machine = _machine_with(tag_list=["NO-ASSET-PREFIX 1"], target_tag_list=None)
    else:
        if torch.cuda.is_available():
            pytest.skip("a card is present, so the default device works")
        device = None  # the card, which this machine lacks
    report = tmp_path / "report.json"
    result = run_build(machine, tmp_path / "out", "--exceptions-reporter-file", str(report),
                       device=device)
    assert result.returncode == code, result.stderr
    assert json.loads(report.read_text())["type"] == error
    assert not (tmp_path / "out").exists()


# the conftest gordo-base-model as a raw machine in YAML
BASE_MODEL_YAML = """
name: gordo-base-model
project_name: gordo-test
dataset:
  type: RandomDataset
  tags: [tag-0, tag-1, tag-2, tag-3]   # a comment
  train_start_date: '2019-01-01T00:00:00+00:00'
  train_end_date: 2019-01-03T00:00:00+00:00
  asset: gra
model:
  gordo_tpu.models.AutoEncoder:
    kind: feedforward_hourglass
    epochs: 1
"""


def test_cli_refuses_a_machine_that_is_not_json(tmp_path):
    """MACHINE is YAML (JSON is YAML too), as in the JAX command: a
    machine given as YAML text builds; text that does not parse, or that
    is not a mapping, is a usage error (exit 2)."""

    def build(machine, out):
        env = dict(os.environ, MACHINE=machine, OUTPUT_DIR=str(out))
        env.pop("GORDO_TPU_LAKE_DIR", None)
        return subprocess.run(
            [sys.executable, "-m", "gordo_tpu_torch.cli", "build", "--device", "cpu"],
            cwd=REPO_ROOT, env=env, capture_output=True, text=True, timeout=120,
        )

    result = build(BASE_MODEL_YAML, tmp_path / "base")
    assert result.returncode == 0, result.stderr
    assert sorted(os.listdir(tmp_path / "base")) == ["definition.json", "metadata.json",
                                                     "params.npz"]
    for machine, message in [
        ("- name: pump-4130\n- model: {}", "MACHINE must be a YAML mapping, got list"),
        ("name: [pump-4130", "MACHINE must be the machine's config as YAML; it did not parse"),
    ]:
        result = build(machine, tmp_path / "refused")
        assert result.returncode == 2
        assert message in result.stderr
    assert not (tmp_path / "refused").exists()


def test_exit_code_table_matches_jax():
    from gordo_tpu.cli.cli import _exceptions_reporter

    want = sorted(_exceptions_reporter._exit_codes.values())
    assert sorted(EXIT_CODES.values()) == want == [1, 20, 30, 60, 70, 80, 81, 90]
    assert {k.__name__ for k in EXIT_CODES} == {
        k.__name__ for k in _exceptions_reporter._exit_codes
    }


# -- both servers on one converted default-pipeline artifact ---------------------

TAGS = ["GRA-PUMP-TEMP 1", "GRA-PUMP-PRES 2", "GRA-PUMP-FLOW 3"]


def _rows(n_rows, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n_rows)[:, None]
    wave = np.sin(2 * np.pi * t / 144 + np.arange(3))
    return np.array([60.0, 4.0, 900.0]) + np.array([5.0, 0.5, 80.0]) * (
        wave + 0.1 * rng.normal(size=(n_rows, 3))
    )


def _metadata(name, definition):
    return {
        "name": name,
        "dataset": {"tag_list": TAGS, "target_tag_list": TAGS, "resolution": "10T"},
        "model": definition,
        "metadata": {"build_metadata": {"model": {"model_offset": 0}}},
        "project_name": PROJECT,
    }


@pytest.fixture(scope="module")
def clients(tmp_path_factory):
    """(JAX client, port client): the default-pipeline detector
    ``pipeline`` and the bare AutoEncoder ``bare``, fitted in JAX and
    carried over."""
    frame = pd.DataFrame(_rows(600, seed=1), columns=TAGS)
    detector = jax_from_definition(default_model(epochs=2, seed=2))
    detector.cross_validate(X=frame, y=frame)
    detector.fit(frame, frame)
    bare = jax_from_definition({"gordo_tpu.models.AutoEncoder": {"kind": "feedforward_hourglass",
                                                                 "seed": 3}})
    bare.fit(frame, frame)
    root = tmp_path_factory.mktemp("servers")
    jax_dir, port_dir = root / "jax" / REVISION, root / "port" / REVISION
    for name, model in (("pipeline", detector), ("bare", bare)):
        definition = jax_serializer.into_definition(model)
        jax_serializer.dump(model, jax_dir / name, metadata=_metadata(name, definition))
    parts = jax_parts(jax_serializer.load(jax_dir / "pipeline"))
    convert.write_artifact(
        port_dir / "pipeline", metadata=jax_serializer.load_metadata(jax_dir / "pipeline"),
        **parts,
    )
    loaded_bare = jax_serializer.load(jax_dir / "bare")
    convert.write_artifact(
        port_dir / "bare", loaded_bare.params_, jax_serializer.into_definition(loaded_bare),
        metadata=jax_serializer.load_metadata(jax_dir / "bare"),
    )
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MODEL_COLLECTION_DIR", str(jax_dir))
        jax_server_utils.clear_caches()
        yield Client(jax_build_app()), Client(build_app(str(port_dir), device="cpu"))
    jax_server_utils.clear_caches()


def _body(n_rows, seed):
    frame = pd.DataFrame(
        _rows(n_rows, seed), columns=TAGS,
        index=pd.date_range("2019-06-01", periods=n_rows, freq="10min", tz="UTC"),
    )
    data = jax_server_utils.dataframe_to_dict(frame)
    return {"X": data, "y": data}


def _post(client, machine, route, body):
    reply = client.post(f"/gordo/v0/{PROJECT}/{machine}/{route}", json=body)
    return reply.status_code, json.loads(reply.get_data())


def _assert_same(got, want, path="body"):
    if isinstance(want, dict):
        assert isinstance(got, dict), path
        assert set(got) == set(want), f"{path}: {sorted(set(got) ^ set(want))}"
        for key in want:
            _assert_same(got[key], want[key], f"{path}/{key}")
    elif isinstance(want, float):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=path)
    else:
        assert got == want, path


@pytest.mark.parametrize("route", ["prediction", "anomaly/prediction"])
@pytest.mark.parametrize("n_rows", [144, 1000])
def test_servers_answer_alike_for_the_default_pipeline(clients, route, n_rows):
    jax_client, port_client = clients
    body = _body(n_rows, seed=n_rows)
    want_status, want = _post(jax_client, "pipeline", route, body)
    got_status, got = _post(port_client, "pipeline", route, body)
    assert got_status == want_status == 200
    assert set(got) == set(want) == {"data", "time-seconds", "revision"}
    _assert_same(got["data"], want["data"])
    assert len(got["data"]["model-output"][TAGS[0]]) == n_rows


def test_servers_answer_alike_for_a_bare_autoencoder(clients):
    jax_client, port_client = clients
    body = _body(144, seed=7)
    want_status, want = _post(jax_client, "bare", "prediction", body)
    got_status, got = _post(port_client, "bare", "prediction", body)
    assert got_status == want_status == 200
    _assert_same(got["data"], want["data"])
    want_status, want = _post(jax_client, "bare", "anomaly/prediction", body)
    got_status, got = _post(port_client, "bare", "anomaly/prediction", body)
    assert got_status == want_status == 422
    prefix = "Model is not an AnomalyDetector, it is of type: "
    assert want["message"].startswith(prefix) and got["message"].startswith(prefix)
    assert got["message"].endswith("AutoEncoder'>") and want["message"].endswith("AutoEncoder'>")


def test_servers_metadata_alike(clients):
    jax_client, port_client = clients
    path = f"/gordo/v0/{PROJECT}/pipeline/metadata"
    got, want = (json.loads(c.get(path).get_data()) for c in (port_client, jax_client))
    assert set(got) == set(want)
    assert got["metadata"] == want["metadata"]


# -- the recurrent machines of chip_smoke.py's phase 8 ------------------------

PLANT_TAGS = [f"GRA-TAG {i}" for i in range(1, 51)]
PLANT_DATASET = f"""
      type: TimeSeriesDataset
      data_provider: {{type: RandomDataProvider, min_size: 16400, max_size: 16400}}
      tags: {json.dumps(PLANT_TAGS)}
      train_start_date: '2019-01-01T00:00:00+00:00'
      train_end_date: '2019-04-25T00:00:00+00:00'"""
RECURRENT_CONFIG = f"""
machines:
  - name: lstm-plant-50
    dataset:{PLANT_DATASET}
    model:
      gordo_tpu.models.anomaly.DiffBasedAnomalyDetector:
        base_estimator:
          gordo_tpu.models.LSTMAutoEncoder:
            kind: lstm_model
            lookback_window: 64
            encoding_dim: [128, 64]
            encoding_func: [tanh, tanh]
            decoding_dim: [64, 128]
            decoding_func: [tanh, tanh]
            fused: true
            schedule: layer
            batch_size: 512
            epochs: 1
  - name: gru-plant-50
    dataset:{PLANT_DATASET}
    model:
      gordo_tpu.models.anomaly.DiffBasedAnomalyDetector:
        base_estimator:
          gordo_tpu.models.GRUForecast:
            kind: gru_hourglass
            lookback_window: 64
            batch_size: 512
            epochs: 1
"""


def test_chip_smoke_recurrent_machines_are_normalized_configs():
    import yaml

    config = yaml.safe_load(RECURRENT_CONFIG)
    machines = NormalizedConfig(config, project_name=PROJECT).machines
    want = {m.name: json.loads(json.dumps(m.to_dict(), default=str)) for m in machines}
    assert chip_smoke.RECURRENT_MACHINES == want


def test_chip_smoke_recurrent_rows_are_the_jax_data_layers():
    from gordo_tpu.data import _get_dataset as jax_get_dataset
    from gordo_tpu_torch.data import _get_dataset

    dataset = chip_smoke.RECURRENT_MACHINES["lstm-plant-50"]["dataset"]
    X, _, stamps = _get_dataset(dataset).get_data()
    jax_X, _ = jax_get_dataset(copy.deepcopy(dataset)).get_data()
    assert len(X) == len(jax_X) == chip_smoke.RECURRENT_ROWS
    np.testing.assert_allclose(X, jax_X.to_numpy(), rtol=1e-12)
    assert list(pd.to_datetime(stamps[[0, -1]], utc=True)) == list(jax_X.index[[0, -1]])


def _small_recurrent_machine(name):
    """A phase-8 machine cut for the CPU: 3 tags, 4 days, lookback 8, one
    epoch, batch 64; the estimator's kind and widths as configured."""
    machine = copy.deepcopy(chip_smoke.RECURRENT_MACHINES[name])
    tags = PLANT_TAGS[:3]
    machine["dataset"].update(
        tag_list=tags, target_tag_list=tags, train_end_date="2019-01-05T00:00:00+00:00",
        data_provider={"type": "RandomDataProvider", "min_size": 600, "max_size": 600},
    )
    (estimator,) = machine["model"]["gordo_tpu.models.anomaly.DiffBasedAnomalyDetector"][
        "base_estimator"].values()
    estimator.update(lookback_window=8, epochs=1, batch_size=64)
    return machine


@pytest.mark.parametrize("name", ["lstm-plant-50", "gru-plant-50"])
def test_cli_builds_and_serves_a_recurrent_machine(name, tmp_path):
    """The build CLI, the builder and the server take the recurrent
    families with no branch of their own: a cut-down phase-8 machine
    builds on the CPU, its artifact loads as the recurrent estimator, and
    its anomaly frame answers over the port's app."""
    machine = _small_recurrent_machine(name)
    out = tmp_path / REVISION / name
    result = run_build(machine, out)
    assert result.returncode == 0, result.stderr
    assert "model parameters on cpu" in result.stderr
    meta = serializer.load_metadata(out)["metadata"]["build_metadata"]["model"]
    lookahead = meta["model_meta"]["forecast_steps"]
    assert lookahead == (1 if name.startswith("gru") else 0)
    assert meta["model_offset"] == 8 - 1 + lookahead
    assert meta["cross_validation"]["scores"]["explained-variance-score"]["fold-mean"] <= 1.0
    model = serializer.load(out, device="cpu")
    assert type(model.base_estimator).__name__ == (
        "GRUForecast" if name.startswith("gru") else "LSTMAutoEncoder"
    )
    app = build_app(str(tmp_path / REVISION), device="cpu")
    body = {"X": {tag: {f"2019-06-01T00:{i:02d}:00+00:00": float(i % 7) for i in range(30)}
                  for tag in PLANT_TAGS[:3]}}
    body["y"] = body["X"]
    reply = app.dispatch("POST", f"/gordo/v0/{PROJECT}/{name}/anomaly/prediction",
                         lambda: json.dumps(body).encode())
    assert reply.status == 200, reply.payload
    confidence = reply.payload["data"]["total-anomaly-confidence"]
    (values,) = confidence.values()
    assert len(values) == 30 - meta["model_offset"]
    assert all(np.isfinite(v) for v in values.values())


# -- chip_smoke.py's project build (phase 9) ----------------------------------


def test_chip_smoke_project_config_normalizes_as_jax():
    from gordo_tpu.machine import MachineEncoder as JaxMachineEncoder
    from gordo_tpu_torch.machine import MachineEncoder
    from gordo_tpu_torch.workflow.config_elements import NormalizedConfig as PortNormalizedConfig
    from gordo_tpu_torch.workflow.yaml_reader import safe_load

    text = chip_smoke.PROJECT_CONFIG
    assert safe_load(text) == yaml.safe_load(text)
    got = PortNormalizedConfig(safe_load(text), project_name="local-build").machines
    want = NormalizedConfig(yaml.safe_load(text), project_name="local-build").machines
    assert [m.name for m in got] == list(chip_smoke.PROJECT_SERVING)
    for ours, theirs in zip(got, want):
        assert json.loads(json.dumps(ours.to_dict(), cls=MachineEncoder)) == json.loads(
            json.dumps(theirs.to_dict(), cls=JaxMachineEncoder)
        )


def test_chip_smoke_project_builds_and_serves_on_the_cpu(tmp_path):
    """Phase 9 cut for the CPU: the TCN machine at 3 tags, 4 days,
    lookback 8, batch 64 and channels 8/8/8; the other two as they are.
    ``local_build`` builds all three in this process, and each artifact
    answers its routes over the port's app."""
    from gordo_tpu_torch.builder.local_build import local_build
    from gordo_tpu_torch.data import _get_dataset

    config = yaml.safe_load(chip_smoke.PROJECT_CONFIG)
    tcn = config["machines"][0]
    tcn["dataset"].update(
        tags=PLANT_TAGS[:3], train_end_date="2019-01-05T00:00:00+00:00",
        data_provider={"type": "RandomDataProvider", "min_size": 600, "max_size": 600},
    )
    (estimator,) = tcn["model"]["gordo_tpu.models.anomaly.DiffBasedAnomalyDetector"][
        "base_estimator"].values()
    estimator.update(lookback_window=8, batch_size=64, channels=[8, 8, 8])
    collection = tmp_path / REVISION
    built = []
    for model, machine in local_build(chip_smoke.yaml_text(config), device="cpu"):
        serializer.dump(model, collection / machine.name, machine.to_dict())
        built.append(machine.to_dict())
    assert [m["name"] for m in built] == list(chip_smoke.PROJECT_SERVING)
    app = build_app(str(collection), device="cpu")
    for machine in built:
        name = machine["name"]
        X, _, stamps = _get_dataset(machine["dataset"]).get_data()
        keys = pd.to_datetime(stamps, utc=True).map(lambda t: t.isoformat())
        frame = {tag: dict(zip(keys, X[:, j].tolist()))
                 for j, tag in enumerate(machine["dataset"]["tag_list"])}
        body = json.dumps({"X": frame, "y": frame}).encode()
        for route in chip_smoke.PROJECT_SERVING[name][0]:
            reply = app.dispatch("POST", f"/gordo/v0/{chip_smoke.PROJECT}/{name}/{route}",
                                 lambda: body)
            assert reply.status == 200, (name, route, reply.payload)
            output = reply.payload["data"]["model-output"]
            offset = machine["metadata"]["build_metadata"]["model"]["model_offset"]
            assert list(output) == machine["dataset"]["target_tag_list"]
            assert all(len(column) == len(X) - offset for column in output.values())
