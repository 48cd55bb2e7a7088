"""
SQL reporters (the port of ``gordo_tpu.reporters.postgres``): each built
machine upserted by name into one table, its ``dataset``, ``model`` and
``metadata`` as JSON, after the same ``MachineEncoder`` round trip (so
datetimes and numpy scalars are plain JSON). The table and the
``ON CONFLICT`` upsert are the JAX package's statements.

``SqliteReporter(path)`` writes through the standard library's
``sqlite3`` (a 30 s busy timeout, so concurrent builds wait out each
other's writes). ``PostgresReporter`` and ``MlFlowReporter`` need
psycopg2 and mlflow, which the card's machine lacks: configuring either
raises :class:`ReporterException` when the machine is reported, after
its artifact is written.
"""

import json
import logging
import sqlite3

from gordo_tpu_torch.reporters.base import BaseReporter, ReporterException
from gordo_tpu_torch.utils.utils import capture_args

logger = logging.getLogger(__name__)

_UPSERT_SQL = """
INSERT INTO machine (name, dataset, model, metadata)
VALUES ({ph}, {ph}, {ph}, {ph})
ON CONFLICT (name) DO UPDATE SET
    dataset = excluded.dataset,
    model = excluded.model,
    metadata = excluded.metadata
"""

_CREATE_SQL = """
CREATE TABLE IF NOT EXISTS machine (
    name TEXT NOT NULL UNIQUE,
    dataset {json_type} NOT NULL,
    model {json_type} NOT NULL,
    metadata {json_type} NOT NULL
)
"""


class PostgresReporterException(ReporterException):
    pass


class MlflowLoggingError(ReporterException):
    pass


class SqlReporter(BaseReporter):
    """The SQL reporter core: a subclass gives the DB-API connection, its
    parameter placeholder and its JSON column type."""

    _placeholder = "?"
    _json_type = "TEXT"

    def _connect(self):
        raise NotImplementedError

    def _ensure_table(self, conn) -> None:
        with conn:
            cursor = conn.cursor()
            cursor.execute(_CREATE_SQL.format(json_type=self._json_type))
            cursor.close()

    def report(self, machine):
        """Upsert the machine's row, keyed by its name."""
        from gordo_tpu_torch.machine.machine import MachineEncoder

        record = json.loads(json.dumps(machine.to_dict(), cls=MachineEncoder))
        try:
            conn = self._connect()
            try:
                self._ensure_table(conn)
                with conn:
                    cursor = conn.cursor()
                    cursor.execute(
                        _UPSERT_SQL.format(ph=self._placeholder),
                        (
                            record["name"],
                            json.dumps(record["dataset"]),
                            json.dumps(record["model"]),
                            json.dumps(record["metadata"]),
                        ),
                    )
                    cursor.close()
            finally:
                conn.close()
        except Exception as exc:
            raise PostgresReporterException(exc) from exc
        logger.info("Reported machine %s to sql", machine.name)


class SqliteReporter(SqlReporter):
    """The table in a sqlite file at ``path``."""

    @capture_args
    def __init__(self, path: str):
        self.path = path

    def _connect(self):
        return sqlite3.connect(self.path, timeout=30.0)


class PostgresReporter(SqlReporter):
    """Not ported: it needs psycopg2 (module docstring)."""

    _placeholder = "%s"
    _json_type = "JSONB"

    @capture_args
    def __init__(self, *args, **kwargs):
        pass

    def report(self, machine):
        raise PostgresReporterException(
            "PostgresReporter is not ported: it needs psycopg2, which the card's machine "
            "lacks (the artifact was written); use SqliteReporter for a dependency-free store"
        )


class MlFlowReporter(BaseReporter):
    """Not ported: it needs mlflow (module docstring)."""

    WIRE_MODULE = "gordo_tpu.reporters.mlflow"

    @capture_args
    def __init__(self, *args, **kwargs):
        pass

    def report(self, machine):
        raise MlflowLoggingError(
            "MlFlowReporter is not ported: it needs mlflow, which the card's machine lacks "
            "(the artifact was written)"
        )


#: the reporters a config may name, by class name
REPORTERS = {cls.__name__: cls for cls in (SqliteReporter, PostgresReporter, MlFlowReporter)}
