"""
The port's ``client`` and ``trace`` commands against the JAX commands
(click, run in-process with ``CliRunner``) on the same server: the port's
server over loopback HTTP, serving ``tests/torch_client_helpers.py``'s
collection.

- ``python -m gordo_tpu_torch.cli client ... predict --output-dir`` (a
  subprocess: the real entry point) and the JAX command with
  ``--no-parquet`` write ``<machine>.csv.gz`` files that pandas reads
  back equal, per machine and with ``--fleet``;
- ``metadata --output-file`` writes the JAX command's JSON;
- ``download-model`` writes artifacts that ``serializer.load`` serves;
- ``--parquet`` and ``--influx-uri`` are refused naming ``pyarrow`` and
  ``influxdb``, ``--session-config`` keys other than ``headers`` by name,
  and the exit code is 1 when a prediction failed;
- ``trace export`` and ``trace summarize`` print the JAX ``trace``
  command's output on one span file.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
from click.testing import CliRunner

from gordo_tpu.cli.client import client as jax_client_cli
from gordo_tpu.cli.trace import trace_cli as jax_trace_cli
from gordo_tpu_torch import serializer
from gordo_tpu_torch.cli import cli
from gordo_tpu_torch.observability import tracing
from tests import torch_client_helpers as helpers

REPO_ROOT = Path(__file__).resolve().parent.parent
PROVIDER = '{"type": "RandomDataProvider", "seed": 2}'


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli-client")
    _, port_dir = helpers.build_collections(root)
    helpers.add_casualty_revision(port_dir, "1700000000001", helpers.FF)
    with pytest.MonkeyPatch.context() as mp:
        for var in ("GORDO_BATCH_WAIT_MS", tracing.TRACE_LOG_ENV_VAR):
            mp.delenv(var, raising=False)
        served = helpers.ServerProcess(port_dir)
        yield served, port_dir
        served.close()


def _group(port):
    return ["--project", helpers.PROJECT, "--host", "127.0.0.1", "--port", str(port),
            "--scheme", "http", "--batch-size", "20", "--parallelism", "2"]


def _jax(args):
    result = CliRunner().invoke(jax_client_cli, args, catch_exceptions=False)
    return result.exit_code, result.output


def _read(path):
    return pd.read_csv(path, header=[0, 1], index_col=0)


@pytest.mark.parametrize("fleet", [[], ["--fleet", "--fleet-group-size", "4"]])
def test_predict_writes_the_jax_commands_files(server, fleet, tmp_path, monkeypatch):
    monkeypatch.delenv(tracing.TRACE_LOG_ENV_VAR, raising=False)
    served, _ = server
    port_out, jax_out = tmp_path / "port", tmp_path / "jax"
    port_out.mkdir(), jax_out.mkdir()
    predict = ["predict", helpers.START, helpers.END, "--data-provider", PROVIDER]
    env = {**os.environ, "PYTHONPATH": str(REPO_ROOT)}
    env.pop(tracing.TRACE_LOG_ENV_VAR, None)
    result = subprocess.run(
        [sys.executable, "-m", "gordo_tpu_torch.cli", "client", *_group(served.port), *predict,
         "--output-dir", str(port_out), *fleet],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=300, env=env)
    assert result.returncode == 0, result.stderr[-2000:]
    assert "Summary of failed predictions" in result.stdout
    code, _ = _jax([*_group(served.port), *predict, "--output-dir", str(jax_out), "--no-parquet",
                    *fleet])
    assert code == 0
    assert sorted(os.listdir(port_out)) == sorted(os.listdir(jax_out)) == [
        f"{name}.csv.gz" for name in helpers.MACHINES]
    for name in helpers.MACHINES:
        got, want = _read(port_out / f"{name}.csv.gz"), _read(jax_out / f"{name}.csv.gz")
        pd.testing.assert_frame_equal(got, want)
        assert len(got) > 20


def test_metadata_file_is_the_jax_commands(server, tmp_path):
    served, _ = server
    got, want = tmp_path / "port.json", tmp_path / "jax.json"
    assert cli.main(["client", *_group(served.port), "metadata", "--output-file", str(got)]) == 0
    code, _ = _jax([*_group(served.port), "metadata", "--output-file", str(want),
                    "--target", helpers.TF, "--target", helpers.FF, "--target", helpers.RAW])
    assert code == 0
    assert json.loads(got.read_text()) == json.loads(want.read_text())
    assert sorted(json.loads(got.read_text())) == helpers.MACHINES


def test_download_model_writes_servable_artifacts(server, tmp_path):
    served, port_dir = server
    assert cli.main(["client", *_group(served.port), "download-model", str(tmp_path),
                     "--target", helpers.TF, "--target", helpers.FF]) == 0
    assert sorted(os.listdir(tmp_path)) == [helpers.FF, helpers.TF]
    X = np.random.default_rng(1).normal(size=(20, 3)).astype(np.float32)
    got = serializer.load(tmp_path / helpers.TF, device="cpu").predict(X)
    want = serializer.load(port_dir / helpers.TF, device="cpu").predict(X)
    np.testing.assert_array_equal(got, want)
    assert serializer.load_metadata(tmp_path / helpers.FF) == serializer.load_metadata(
        port_dir / helpers.FF)


@pytest.mark.parametrize("option,package", [(["--parquet"], "pyarrow"),
                                            (["--influx-uri", "u:p@h:1/db"], "influxdb")])
def test_options_that_need_missing_packages_are_refused(server, option, package, capsys):
    served, _ = server
    with pytest.raises(SystemExit) as exc:
        cli.main(["client", *_group(served.port), "predict", helpers.START, helpers.END,
                  "--data-provider", PROVIDER, *option])
    assert exc.value.code == 2
    assert package in capsys.readouterr().err


def test_session_config_takes_headers_only(server, capsys):
    served, _ = server
    with pytest.raises(SystemExit):
        cli.main(["client", *_group(served.port), "--session-config",
                  "{'headers': {'API-KEY': 'x'}, 'verify': false}", "metadata"])
    assert "refused: verify" in capsys.readouterr().err
    assert cli.main(["client", *_group(served.port), "--session-config",
                     "{'headers': {'API-KEY': 'x'}}", "metadata", "--target", helpers.TF]) == 0


def test_a_failed_prediction_exits_1(server, capsys, monkeypatch):
    monkeypatch.delenv(tracing.TRACE_LOG_ENV_VAR, raising=False)
    _, port_dir = server
    casualty = helpers.ServerProcess(port_dir.parent / "1700000000001")
    try:
        code = cli.main(["client", *_group(casualty.port), "predict", helpers.START, helpers.END,
                         "--data-provider", PROVIDER, "--target", helpers.FF])
    finally:
        casualty.close()
    assert code == 1
    assert f"Machine '{helpers.FF}' is unavailable on the server" in capsys.readouterr().out


def test_trace_commands_print_the_jax_commands_output(tmp_path, monkeypatch, capsys):
    log = tmp_path / "spans" / "spans.jsonl"
    monkeypatch.setenv(tracing.TRACE_LOG_ENV_VAR, str(log))
    with tracing.start_span("client.predict", path="single"):
        with tracing.start_span("client.request", machine="m-1"):
            tracing.record_span("parse", 0.001)
        with tracing.start_span("client.request", machine="m-2"):
            pass
    monkeypatch.delenv(tracing.TRACE_LOG_ENV_VAR)
    (tmp_path / "spans" / "events.jsonl").write_text('{"event": "x"}\n')
    runner = CliRunner()
    for path in (str(log), str(log.parent)):
        want = runner.invoke(jax_trace_cli, ["summarize", path, "--top", "2"]).output
        capsys.readouterr()
        assert cli.main(["trace", "summarize", path, "--top", "2"]) == 0
        assert capsys.readouterr().out == want
        out_got, out_want = tmp_path / "got.json", tmp_path / "want.json"
        runner.invoke(jax_trace_cli, ["export", path, "-o", str(out_want)])
        assert cli.main(["trace", "export", path, "-o", str(out_got)]) == 0
        assert json.loads(out_got.read_text()) == json.loads(out_want.read_text())
        assert any(e["ph"] == "X" for e in json.loads(out_got.read_text())["traceEvents"])
