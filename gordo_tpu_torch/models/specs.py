"""
What a model factory returns (the port of ``gordo_tpu.models.specs``'s
``ModelSpec`` and ``resolve_dtype``).

A :class:`ModelSpec` is an ``nn.Module`` plus the window geometry the
estimator needs. The training half of the JAX spec (optimizer and loss
configuration) comes with the training slice.
"""

import dataclasses

import torch
from torch import nn

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "float64": torch.float64,
}


def resolve_dtype(dtype) -> torch.dtype:
    if dtype is None:
        return torch.float32
    if isinstance(dtype, str):
        try:
            return _DTYPES[dtype]
        except KeyError:
            raise ValueError(f"Unknown dtype {dtype!r}") from None
    return dtype


@dataclasses.dataclass
class ModelSpec:
    """What a factory returns: the module and its window geometry."""

    module: nn.Module
    # sequence-model window geometry; windowed=False means samples are rows
    windowed: bool = False
    lookback_window: int = 1
