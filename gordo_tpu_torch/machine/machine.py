"""
The machine config unit (the port of ``gordo_tpu.machine.machine``): a
validated (name, model, dataset, runtime, evaluation, metadata) bundle,
the unit the builder builds and the server serves.

Config overlays as in the JAX package: ``runtime`` and ``evaluation``
are the project globals patched by the machine's own block, while
``dataset`` is the machine's block patched *by* the globals (global
dataset keys win).
"""

import json
import logging
from datetime import datetime
from typing import Any, Dict, Optional, Union

import numpy as np

from gordo_tpu_torch.data.base import GordoBaseDataset
from gordo_tpu_torch.machine.metadata import Metadata
from gordo_tpu_torch.machine.validators import (
    ValidDataset,
    ValidMachineRuntime,
    ValidMetadata,
    ValidModel,
    ValidUrlString,
)
from gordo_tpu_torch.reporters.base import ReporterException  # noqa: F401 (the CLI's exit 90)
from gordo_tpu_torch.workflow.helpers import patch_dict

logger = logging.getLogger(__name__)

# the attributes to_dict()/from_dict() carry, in this order
_MACHINE_FIELDS = (
    "name",
    "dataset",
    "model",
    "metadata",
    "runtime",
    "project_name",
    "evaluation",
)


def _as_dataset(value: Union[GordoBaseDataset, dict]) -> GordoBaseDataset:
    if isinstance(value, GordoBaseDataset):
        return value
    return GordoBaseDataset.from_dict(value)


def _as_metadata(value: Union[Metadata, dict, None]) -> Metadata:
    if isinstance(value, Metadata):
        return value
    return Metadata.from_dict(value or {})


class Machine:

    name = ValidUrlString()
    project_name = ValidUrlString()
    host = ValidUrlString()
    model = ValidModel()
    dataset = ValidDataset()
    metadata = ValidMetadata()
    runtime = ValidMachineRuntime()
    _strict = True

    def __init__(
        self,
        name: str,
        model: dict,
        dataset: Union[GordoBaseDataset, dict],
        project_name: str,
        evaluation: Optional[dict] = None,
        metadata: Optional[Union[dict, Metadata]] = None,
        runtime: Optional[dict] = None,
    ):
        self.name = name
        self.model = model
        self.dataset = _as_dataset(dataset)
        self.runtime = runtime or {}
        # None and {} both mean the default evaluation: a plain full build
        self.evaluation = evaluation or {"cv_mode": "full_build"}
        self.metadata = _as_metadata(metadata)
        self.project_name = project_name
        self.host = f"gordoserver-{self.project_name}-{self.name}"

    @classmethod
    def from_config(
        cls,
        config: Dict[str, Any],
        project_name: str,
        config_globals: Optional[dict] = None,
    ) -> "Machine":
        """A machine from one machine block of a project config, with the
        project globals laid over it as the module docstring says."""
        shared = config_globals or {}

        def block(key: str, source: dict) -> dict:
            return source.get(key) or {}

        return cls(
            name=config["name"],
            project_name=project_name,
            model=config.get("model") or shared.get("model"),
            dataset=_as_dataset(patch_dict(block("dataset", config), block("dataset", shared))),
            runtime=patch_dict(block("runtime", shared), block("runtime", config)),
            evaluation=patch_dict(block("evaluation", shared), block("evaluation", config)),
            metadata=Metadata(
                user_defined={
                    "global-metadata": block("metadata", shared),
                    "machine-metadata": block("metadata", config),
                }
            ),
        )

    @classmethod
    def from_dict(cls, d: dict) -> "Machine":
        return cls(**d)

    @classmethod
    def unvalidated(cls, **kwargs) -> "Machine":
        """A machine built without the model config's dry run, for
        trusted copies of a machine that was validated already."""
        instance = cls.__new__(cls)
        instance.__dict__["_strict"] = False
        cls.__init__(instance, **kwargs)
        return instance

    def to_dict(self) -> dict:
        def plain(value):
            return value.to_dict() if hasattr(value, "to_dict") else value

        return {field: plain(getattr(self, field)) for field in _MACHINE_FIELDS}

    def __str__(self):
        """The machine as JSON: the port has no YAML writer, so this is
        not the JAX machine's YAML dump (JSON is valid YAML all the
        same)."""
        return json.dumps(self.to_dict(), cls=MachineEncoder)

    def __eq__(self, other):
        if not isinstance(other, Machine):
            return NotImplemented
        return self.to_dict() == other.to_dict()

    def __hash__(self):
        return hash((self.project_name, self.name))

    def report(self):
        """Run every reporter configured under ``runtime.reporters``::

            runtime:
              reporters:
                - gordo_tpu.reporters.postgres.SqliteReporter:
                    path: /reports/machines.db

        A reporter's failure raises :class:`ReporterException` (the build
        command's exit code 90), after the artifact was written."""
        from gordo_tpu_torch.reporters.base import BaseReporter

        for config in self.runtime.get("reporters", []):
            reporter = BaseReporter.from_dict(config)
            logger.debug("Using reporter: %r", reporter)
            reporter.report(self)


class MachineEncoder(json.JSONEncoder):
    """JSON for machine dicts: datetimes and numpy scalars too."""

    def default(self, obj):
        if isinstance(obj, datetime):
            return obj.strftime("%Y-%m-%d %H:%M:%S.%f%z")
        kind = type(obj)
        if np.issubdtype(kind, np.floating):
            return float(obj)
        if np.issubdtype(kind, np.integer):
            return int(obj)
        return super().default(obj)
