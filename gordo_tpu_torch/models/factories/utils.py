"""
Factory helpers (the port of ``gordo_tpu.models.factories.utils``).
"""

import math
from typing import Tuple


def hourglass_calc_dims(
    compression_factor: float, encoding_layers: int, n_features: int
) -> Tuple[int, ...]:
    """
    Layer dims of an hourglass net: linear from ``n_features`` down to the
    smallest layer (``ceil(compression_factor * n_features)``, at least 1)
    over ``encoding_layers`` steps, rounded as Python rounds.

    >>> hourglass_calc_dims(0.5, 3, 10)
    (8, 7, 5)
    >>> hourglass_calc_dims(0.5, 3, 3)
    (3, 2, 2)
    """
    if not 0 <= compression_factor <= 1:
        raise ValueError(f"compression_factor must lie in [0, 1], got {compression_factor}")
    if encoding_layers < 1:
        raise ValueError(f"encoding_layers must be >= 1, got {encoding_layers}")
    smallest = max(1, min(math.ceil(compression_factor * n_features), n_features))
    step = (n_features - smallest) / encoding_layers
    return tuple(round(n_features - depth * step) for depth in range(1, encoding_layers + 1))


def check_dim_func_len(prefix: str, dim: Tuple[int, ...], func: Tuple[str, ...]) -> None:
    """Dims and activation functions must pair up one to one."""
    if len(dim) != len(func):
        raise ValueError(
            f"{prefix}_dim has {len(dim)} layers but {prefix}_func has "
            f"{len(func)} — each layer needs exactly one activation, so the "
            f"two tuples must be the same length."
        )
