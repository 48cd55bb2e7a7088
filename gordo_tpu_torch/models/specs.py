"""
What a model factory returns (the port of ``gordo_tpu.models.specs``):
:class:`ModelSpec`, ``resolve_dtype``, the optimizer map, the per-sample
losses, Flax's default initialisation, the :class:`Dense` layer and the
feedforward family's :class:`FeedForwardNet`.

A :class:`ModelSpec` is an ``nn.Module`` plus the window geometry and the
training configuration (optimizer name and kwargs, loss name) the
estimator needs.

Optimizers keep the JAX package's Keras-style names and kwargs (``lr`` is
``learning_rate``, ``decay`` is ``weight_decay``, the learning rate
defaults to 1e-3) and optax's semantics and defaults, built on
``torch.optim``: optax's ``adam`` is ``torch.optim.Adam``'s update,
``adamw`` is ``torch.optim.AdamW``'s with optax's weight decay of 1e-4
(torch's default is 1e-2), and ``sgd`` is ``torch.optim.SGD`` with
optax's momentum trace. The other names the JAX package knows raise.
"""

import dataclasses
import math
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from gordo_tpu_torch.ops.activations import resolve_activation

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


def _adam_kwargs(learning_rate, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0,
                 mu_dtype=None, *, nesterov=False, **decay):
    if eps_root or mu_dtype is not None or nesterov:
        raise NotImplementedError(
            "eps_root, mu_dtype and nesterov are not ported (ROADMAP.md queue 1)"
        )
    return dict(lr=learning_rate, betas=(b1, b2), eps=eps, **decay)


def _adam(params, learning_rate, **kwargs) -> torch.optim.Optimizer:
    return torch.optim.Adam(params, **_adam_kwargs(learning_rate, **kwargs))


def _adamw(params, learning_rate, weight_decay=1e-4, mask=None, **kwargs):
    if mask is not None:
        raise NotImplementedError("adamw's mask is not ported (ROADMAP.md queue 1)")
    return torch.optim.AdamW(
        params, **_adam_kwargs(learning_rate, weight_decay=weight_decay, **kwargs)
    )


def _sgd(params, learning_rate, momentum=None, nesterov=False, accumulator_dtype=None):
    if accumulator_dtype is not None:
        raise NotImplementedError(
            "sgd's accumulator_dtype is not ported (ROADMAP.md queue 1)"
        )
    # optax's trace: t = g + momentum * t, update = -lr * t (nesterov:
    # g + momentum * t) — torch's SGD with dampening 0
    return torch.optim.SGD(
        params, lr=learning_rate, momentum=momentum or 0.0, nesterov=nesterov
    )


_OPTIMIZERS: Dict[str, Callable[..., torch.optim.Optimizer]] = {
    "adam": _adam,
    "adamw": _adamw,
    "sgd": _sgd,
}
#: names the JAX package knows that the port does not have yet
_NOT_PORTED = ("adadelta", "adagrad", "adamax", "lamb", "lion", "nadam", "rmsprop")

# Keras optimizer-kwarg spellings -> optax spellings
_OPT_KWARG_ALIASES = {"lr": "learning_rate", "decay": "weight_decay"}


def resolve_optimizer(
    name: str, optimizer_kwargs: Optional[Dict[str, Any]] = None
) -> Tuple[Callable[..., torch.optim.Optimizer], Dict[str, Any]]:
    """
    (constructor, normalized kwargs) for a Keras-style optimizer config:
    aliases translated (lr -> learning_rate, ...) and the default learning
    rate applied. The constructor takes the parameters first.
    """
    kwargs = dict(optimizer_kwargs or {})
    for old, new in _OPT_KWARG_ALIASES.items():
        if old in kwargs:
            kwargs[new] = kwargs.pop(old)
    kwargs.setdefault("learning_rate", 1e-3)
    key = name.lower()
    if key in _NOT_PORTED:
        raise NotImplementedError(
            f"Optimizer {name!r} is not ported yet (ROADMAP.md queue 1); "
            f"available: {sorted(_OPTIMIZERS)}"
        )
    try:
        return _OPTIMIZERS[key], kwargs
    except KeyError:
        raise ValueError(
            f"Unknown optimizer {name!r}; available: {sorted(_OPTIMIZERS)}"
        ) from None


def make_optimizer(
    name: str,
    optimizer_kwargs: Optional[Dict[str, Any]],
    params: Iterable[torch.Tensor],
) -> torch.optim.Optimizer:
    """A ``torch.optim`` optimizer over ``params`` from a Keras-style name
    and kwargs, with optax's semantics."""
    ctor, kwargs = resolve_optimizer(name, optimizer_kwargs)
    return ctor(params, **kwargs)


def _huber(err: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    """optax's huber loss against 0: quadratic within ``delta``, linear out."""
    abs_err = err.abs()
    quadratic = torch.clamp(abs_err, max=delta)
    return 0.5 * quadratic**2 + delta * (abs_err - quadratic)


_LOSSES = {
    "mse": lambda err: err**2,
    "mean_squared_error": lambda err: err**2,
    "mae": torch.abs,
    "mean_absolute_error": torch.abs,
    "huber": _huber,
}


def per_sample_loss(loss: str, y_pred: torch.Tensor, y_true: torch.Tensor) -> torch.Tensor:
    """(batch, features) prediction error -> (batch,) per-sample loss."""
    try:
        elementwise = _LOSSES[loss]
    except KeyError:
        raise ValueError(f"Unknown loss {loss!r}; available: {sorted(_LOSSES)}") from None
    return elementwise(y_pred - y_true).mean(dim=-1)


# std of a standard normal cut at +-2, which Flax divides out so that the
# cut distribution keeps the asked-for variance
_TRUNCATED_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """
    Flax's ``lecun_normal`` into a torch (out, in) weight, in place: a
    normal cut at two standard deviations, variance 1/fan_in with fan_in
    = ``weight.shape[1]``. Drawn on the CPU from ``generator`` (inverse
    CDF of a uniform draw), so the weights do not depend on the device.
    """
    std = math.sqrt(1.0 / weight.shape[1]) / _TRUNCATED_STD
    lo, hi = (1.0 + math.erf(-2.0 / math.sqrt(2.0))) / 2.0, (1.0 + math.erf(2.0 / math.sqrt(2.0))) / 2.0
    u = torch.rand(weight.shape, generator=generator, dtype=torch.float64)
    z = math.sqrt(2.0) * torch.erfinv(2.0 * (lo + (hi - lo) * u) - 1.0)
    with torch.no_grad():
        weight.copy_((z.clamp(-2.0, 2.0) * std).to(weight.dtype))
    return weight


def flax_default_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """
    Flax's default initialisation for every Linear and LayerNorm in
    ``module``, in place: Linear weights ``lecun_normal``, biases 0;
    LayerNorm scale 1 and bias 0. Modules are visited in registration
    order, so a seed gives one set of weights.
    """
    for sub in module.modules():
        if isinstance(sub, nn.Linear):
            lecun_normal_(sub.weight, generator)
            if sub.bias is not None:
                nn.init.zeros_(sub.bias)
        elif isinstance(sub, nn.LayerNorm):
            nn.init.ones_(sub.weight)
            nn.init.zeros_(sub.bias)
    return module


@dataclasses.dataclass
class ModelSpec:
    """What a factory returns: the module, its window geometry and its
    training configuration."""

    module: nn.Module
    optimizer: str = "Adam"
    optimizer_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    loss: str = "mse"
    # sequence-model window geometry; windowed=False means samples are rows
    windowed: bool = False
    lookback_window: int = 1

    def make_optimizer(self, params: Iterable[torch.Tensor]) -> torch.optim.Optimizer:
        return make_optimizer(self.optimizer, self.optimizer_kwargs, params)


class Dense(nn.Linear):
    """``nn.Linear`` computing in ``dtype`` over float32 parameters."""

    def __init__(self, in_features: int, out_features: int, dtype=torch.float32):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class FeedForwardNet(nn.Module):
    """
    Dense encoder/decoder stack (the port of the JAX ``FeedForwardNet``):
    ``layers[i]`` is the JAX module's ``Dense_i``, each followed by its
    activation, then the output layer and ``out_func``. The layers whose
    ``l1_flags`` entry is set add an L1 activity penalty of
    ``l1 * sum(|activation|) / batch`` to the loss (the reference applies
    it to every encoder layer after the first). Returns ``(output as
    float32, penalty)``. It has no dropout, so ``forward`` ignores the
    ``generator`` the fit loop hands every module.
    """

    def __init__(
        self,
        n_features: int,
        layer_dims: Tuple[int, ...],
        layer_funcs: Tuple[str, ...],
        l1_flags: Tuple[bool, ...],
        out_dim: int,
        out_func: str = "linear",
        l1: float = 1e-4,
        dtype=torch.float32,
    ):
        super().__init__()
        widths = (n_features, *layer_dims, out_dim)
        self.layers = nn.ModuleList(
            Dense(n_in, n_out, dtype) for n_in, n_out in zip(widths[:-1], widths[1:])
        )
        self.funcs = [resolve_activation(f) for f in (*layer_funcs, out_func)]
        self.l1_flags = (*l1_flags, False)
        self.l1 = l1

    def forward(
        self, x: torch.Tensor, generator: Optional[torch.Generator] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        penalty = torch.zeros((), dtype=torch.float32, device=x.device)
        for layer, func, flagged in zip(self.layers, self.funcs, self.l1_flags):
            x = func(layer(x))
            if flagged:
                penalty = penalty + self.l1 * x.float().abs().sum() / x.shape[0]
        return x.float(), penalty
