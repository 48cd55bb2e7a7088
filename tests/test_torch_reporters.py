"""
The port's build reporters (``gordo_tpu_torch.reporters``) against the
JAX package's: a machine reported by the port's ``SqliteReporter`` and
the same machine by JAX's give equal rows (every column for a machine as
configured; the ``dataset`` and ``model`` columns and the metadata's keys
for a built one, whose build times differ); a second report upserts the
row; the ``from_dict``/``to_dict`` round trip of the JAX class paths; a
``build`` with a reporter exits 0 and writes the built machine's row; and
configured Postgres and MLflow reporters exit 90 after the artifact is
written, naming the package each needs.
"""

import copy
import json
import sqlite3

import pytest
import torch
import yaml

from gordo_tpu.builder import ModelBuilder as JaxModelBuilder
from gordo_tpu.machine import Machine as JaxMachine
from gordo_tpu.reporters.postgres import SqliteReporter as JaxSqliteReporter
from gordo_tpu_torch.cli import cli
from gordo_tpu_torch.machine import Machine, MachineEncoder
from gordo_tpu_torch.reporters import (
    BaseReporter,
    MlFlowReporter,
    PostgresReporter,
    ReporterException,
    SqliteReporter,
)
from tests.test_torch_cli import BASE_MODEL_YAML
from tests.test_torch_config import _fleet

torch.set_num_threads(1)

SQLITE = "gordo_tpu.reporters.postgres.SqliteReporter"


def _rows(path):
    with sqlite3.connect(path) as conn:
        return conn.execute("SELECT name, dataset, model, metadata FROM machine").fetchall()


def _machines(index=0):
    raw = copy.deepcopy(_fleet()[index])
    return (Machine.from_config(raw, project_name=raw["project_name"]),
            JaxMachine.from_config(copy.deepcopy(raw), project_name=raw["project_name"]))


@pytest.mark.parametrize("index", range(4))
def test_rows_equal_jax_for_a_configured_machine(index, tmp_path):
    port, jax = _machines(index)
    SqliteReporter(str(tmp_path / "port.db")).report(port)
    JaxSqliteReporter(str(tmp_path / "jax.db")).report(jax)
    got, want = _rows(tmp_path / "port.db"), _rows(tmp_path / "jax.db")
    assert len(got) == 1 and got == want
    assert json.loads(got[0][1]) == json.loads(json.dumps(port.to_dict()["dataset"],
                                                          cls=MachineEncoder))


def test_a_second_report_upserts_the_row(tmp_path):
    port, _ = _machines()
    path = str(tmp_path / "m.db")
    SqliteReporter(path).report(port)
    port.metadata.user_defined["machine-metadata"] = {"owner": "ops"}
    SqliteReporter(path).report(port)
    (row,) = _rows(path)
    assert json.loads(row[3])["user_defined"]["machine-metadata"] == {"owner": "ops"}


def test_reporter_definitions_round_trip_as_jax_writes_them(tmp_path):
    reporter = BaseReporter.from_dict({SQLITE: {"path": str(tmp_path / "a.db")}})
    assert isinstance(reporter, SqliteReporter)
    assert reporter.to_dict() == JaxSqliteReporter(str(tmp_path / "a.db")).to_dict()
    assert BaseReporter.from_dict(reporter.to_dict()).path == reporter.path
    assert isinstance(BaseReporter.from_dict(
        {"gordo_tpu_torch.reporters.postgres.SqliteReporter": {"path": "x"}}), SqliteReporter)
    with pytest.raises(ReporterException, match="names no reporter"):
        BaseReporter.from_dict({"gordo_tpu.reporters.nowhere.Nobody": {}})


def test_sql_failures_raise_reporter_exceptions(tmp_path):
    port, _ = _machines()
    with pytest.raises(ReporterException):
        SqliteReporter(str(tmp_path / "missing-dir" / "m.db")).report(port)
    for reporter, package in ((PostgresReporter(host="db"), "psycopg2"),
                              (MlFlowReporter(), "mlflow")):
        with pytest.raises(ReporterException, match=package):
            reporter.report(port)


def _build_yaml(reporters):
    """The one-epoch conftest machine with ``reporters`` configured."""
    return BASE_MODEL_YAML + "runtime:\n  reporters:\n" + "".join(
        f"    - {path}: {json.dumps(kwargs)}\n" for path, kwargs in reporters)


def test_build_with_a_sqlite_reporter_writes_the_built_machine(tmp_path):
    db = tmp_path / "machines.db"
    out = tmp_path / "out"
    code = cli.main(["build", _build_yaml([(SQLITE, {"path": str(db)})]), str(out),
                     "--device", "cpu"])
    assert code == 0
    (row,) = _rows(db)
    metadata = json.loads((out / "metadata.json").read_text())
    assert row[0] == "gordo-base-model"
    assert json.loads(row[1]) == metadata["dataset"]
    assert json.loads(row[2]) == metadata["model"]
    built = json.loads(row[3])
    assert set(built) == set(metadata["metadata"])
    assert built["build_metadata"]["model"]["model_offset"] == (
        metadata["metadata"]["build_metadata"]["model"]["model_offset"])


def test_built_rows_have_the_jax_rows_columns_and_keys(tmp_path):
    """The same built machine as the JAX build command reports it: equal
    ``dataset`` and ``model`` columns, the same metadata keys."""
    text = _build_yaml([(SQLITE, {"path": str(tmp_path / "port.db")})])
    assert cli.main(["build", text, str(tmp_path / "out"), "--device", "cpu"]) == 0
    raw = yaml.safe_load(text)
    jax_machine = JaxMachine.from_config(raw, project_name=raw["project_name"])
    _, built = JaxModelBuilder(jax_machine).build()
    JaxSqliteReporter(str(tmp_path / "jax.db")).report(built)
    (got,), (want,) = _rows(tmp_path / "port.db"), _rows(tmp_path / "jax.db")
    assert got[0] == want[0]
    assert json.loads(got[1]) == json.loads(want[1])
    assert json.loads(got[2]) == json.loads(want[2])
    got_meta, want_meta = json.loads(got[3]), json.loads(want[3])
    assert set(got_meta) == set(want_meta)
    assert set(got_meta["build_metadata"]) == set(want_meta["build_metadata"])
    assert set(got_meta["build_metadata"]["model"]) == set(want_meta["build_metadata"]["model"])


@pytest.mark.parametrize("path,package", [
    ("gordo_tpu.reporters.postgres.PostgresReporter", "psycopg2"),
    ("gordo_tpu.reporters.mlflow.MlFlowReporter", "mlflow"),
])
def test_unported_reporters_exit_90_after_the_artifact(path, package, tmp_path, capsys):
    out = tmp_path / "out"
    code = cli.main(["build", _build_yaml([(path, {"host": "db"} if "Postgres" in path else {})]),
                     str(out), "--device", "cpu"])
    assert code == 90
    assert (out / "metadata.json").is_file()
    assert package in capsys.readouterr().err
