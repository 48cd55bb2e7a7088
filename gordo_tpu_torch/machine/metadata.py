"""
Build metadata records (the port of ``gordo_tpu.machine.metadata``):
dataclasses whose ``to_dict``/``from_dict`` keep the JAX records' keys
and nesting, the ``metadata.json`` layout of both packages' artifacts.
"""

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

from gordo_tpu_torch import __version__

__all__ = [
    "Metadata",
    "BuildMetadata",
    "ModelBuildMetadata",
    "CrossValidationMetaData",
    "DatasetBuildMetadata",
]


class _JsonRecord:
    """Dict round trips for nested records: unknown keys are ignored, and
    a nested record (a field whose default factory is a record) is built
    by its own ``from_dict``."""

    def to_dict(self) -> dict:
        return {
            f.name: (
                value.to_dict()
                if isinstance(value := getattr(self, f.name), _JsonRecord)
                else value
            )
            for f in dataclasses.fields(self)
        }

    @classmethod
    def from_dict(cls, payload: Optional[dict]):
        payload = payload or {}
        kwargs: dict = {}
        for f in dataclasses.fields(cls):
            if f.name not in payload:
                continue
            value = payload[f.name]
            factory = f.default_factory
            if (
                isinstance(factory, type)
                and issubclass(factory, _JsonRecord)
                and isinstance(value, dict)
            ):
                value = factory.from_dict(value)
            kwargs[f.name] = value
        return cls(**kwargs)


@dataclass
class CrossValidationMetaData(_JsonRecord):
    scores: dict = field(default_factory=dict)
    cv_duration_sec: Optional[float] = None
    splits: dict = field(default_factory=dict)


@dataclass
class ModelBuildMetadata(_JsonRecord):
    model_offset: int = 0
    model_creation_date: Optional[str] = None
    model_builder_version: str = __version__
    cross_validation: CrossValidationMetaData = field(default_factory=CrossValidationMetaData)
    model_training_duration_sec: Optional[float] = None
    model_meta: dict = field(default_factory=dict)


@dataclass
class DatasetBuildMetadata(_JsonRecord):
    query_duration_sec: Optional[float] = None
    dataset_meta: dict = field(default_factory=dict)


@dataclass
class BuildMetadata(_JsonRecord):
    model: ModelBuildMetadata = field(default_factory=ModelBuildMetadata)
    dataset: DatasetBuildMetadata = field(default_factory=DatasetBuildMetadata)


@dataclass
class Metadata(_JsonRecord):
    user_defined: dict = field(default_factory=dict)
    build_metadata: BuildMetadata = field(default_factory=BuildMetadata)
