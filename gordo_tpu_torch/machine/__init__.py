"""
The machine config unit, its validators and its build metadata (the port
of ``gordo_tpu.machine``).
"""

from . import validators  # noqa: F401
from .machine import Machine, MachineEncoder, ReporterException
from .metadata import (
    BuildMetadata,
    CrossValidationMetaData,
    DatasetBuildMetadata,
    Metadata,
    ModelBuildMetadata,
)

__all__ = [
    "Machine",
    "MachineEncoder",
    "ReporterException",
    "Metadata",
    "BuildMetadata",
    "ModelBuildMetadata",
    "DatasetBuildMetadata",
    "CrossValidationMetaData",
    "validators",
]
