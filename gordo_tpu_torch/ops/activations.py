"""
Keras-style activation names -> torch functions, so configs written with
string activations ("tanh", "linear", ...) work unchanged. Same registry
names as ``gordo_tpu.ops.activations``; each function matches its JAX
counterpart's defaults (``jax.nn.gelu`` is the tanh approximation,
``jax.nn.leaky_relu`` has slope 0.01, ``jax.nn.hard_sigmoid`` is
``relu6(x + 3) / 6``).
"""

from typing import Callable, Union

import torch
import torch.nn.functional as F


def _linear(x):
    return x


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _softmax(x):
    return torch.softmax(x, dim=-1)


def _hard_sigmoid(x):
    return F.relu6(x + 3.0) / 6.0


ACTIVATIONS = {
    "linear": _linear,
    "tanh": torch.tanh,
    "relu": F.relu,
    "sigmoid": torch.sigmoid,
    "elu": F.elu,
    "selu": F.selu,
    "softplus": F.softplus,
    "softsign": F.softsign,
    "leaky_relu": F.leaky_relu,
    "gelu": _gelu,
    "swish": F.silu,
    "silu": F.silu,
    "softmax": _softmax,
    "exponential": torch.exp,
    "hard_sigmoid": _hard_sigmoid,
}


def resolve_activation(func: Union[str, Callable]) -> Callable:
    if callable(func):
        return func
    try:
        return ACTIVATIONS[func]
    except KeyError:
        raise ValueError(
            f"Unknown activation {func!r}; available: {sorted(ACTIVATIONS)}"
        ) from None
