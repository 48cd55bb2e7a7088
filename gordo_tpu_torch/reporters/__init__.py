"""
Build reporters (the port of ``gordo_tpu.reporters``): what a built
machine is reported to, as its ``runtime.reporters`` configure.
"""

from .base import BaseReporter, ReporterException
from .postgres import MlFlowReporter, PostgresReporter, SqliteReporter, SqlReporter

__all__ = [
    "BaseReporter",
    "ReporterException",
    "MlFlowReporter",
    "PostgresReporter",
    "SqliteReporter",
    "SqlReporter",
]
