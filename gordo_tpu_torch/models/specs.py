"""
What a model factory returns (the port of ``gordo_tpu.models.specs``):
:class:`ModelSpec`, ``resolve_dtype``, the optimizer map, the per-sample
losses, Flax's default initialisation, the :class:`Dense` layer, the
feedforward family's :class:`FeedForwardNet` and the recurrent family's
:class:`LSTMNet` (LSTM and GRU cells; fused, unfused and stacked).

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


def orthogonal_(weight: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """
    Flax's ``orthogonal()`` into a torch (out, in) weight, in place: a
    Haar-distributed matrix with orthonormal rows or columns, whichever
    side is shorter (the QR of a normal draw, signs fixed by R's
    diagonal). Pass ``kernel.T`` for a kernel in Flax's (in, out) layout.
    Drawn on the CPU from ``generator``.
    """
    n_rows, n_cols = weight.shape[1], weight.shape[0]  # Flax's (in, out)
    a = torch.randn(
        (max(n_rows, n_cols), min(n_rows, n_cols)), generator=generator, dtype=torch.float64
    )
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    q = q.T if n_rows < n_cols else q  # (in, out)
    with torch.no_grad():
        weight.copy_(q.T.to(weight.dtype))
    return weight


def flax_raw_init_(module: nn.Module, generator: torch.Generator) -> None:
    """
    Flax's initialisers for the parameters a module holds itself in
    Flax's (in, out) layout, by name: ``input_kernel*`` ``lecun_normal``,
    ``recurrent_kernel*`` ``orthogonal()``, every bias 0.
    """
    for name, param in module.named_parameters(recurse=False):
        if name.startswith("input_kernel"):
            lecun_normal_(param.T, generator)
        elif name.startswith("recurrent_kernel"):
            orthogonal_(param.T, generator)
        else:
            nn.init.zeros_(param)


def flax_default_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """
    Flax's default initialisation for every Linear, Conv1d and LayerNorm
    in ``module``, in place: Linear weights ``lecun_normal`` (``orthogonal()``
    for a :class:`Dense` made with ``kernel_init="orthogonal"``), Conv1d
    weights ``lecun_normal`` over a fan-in of in x kernel size, biases
    0; LayerNorm scale 1 and bias 0; the parameters a recurrent layer
    holds itself as :func:`flax_raw_init_` says. Modules are visited in
    registration order, so a seed gives one set of weights.
    """
    for sub in module.modules():
        if isinstance(sub, nn.Linear):
            if getattr(sub, "kernel_init", None) == "orthogonal":
                orthogonal_(sub.weight, generator)
            else:
                lecun_normal_(sub.weight, generator)
            if sub.bias is not None:
                nn.init.zeros_(sub.bias)
        elif isinstance(sub, nn.Conv1d):
            # Flax's fan_in of a kernel (k, in, out) is k * in
            lecun_normal_(sub.weight.view(sub.weight.shape[0], -1), generator)
            nn.init.zeros_(sub.bias)
        elif isinstance(sub, nn.LayerNorm):
            nn.init.ones_(sub.weight)
            nn.init.zeros_(sub.bias)
        elif isinstance(sub, _RAW_PARAM_LAYERS):
            flax_raw_init_(sub, generator)
    return module


def dropout(
    x: torch.Tensor, rate: float, training: bool, generator: Optional[torch.Generator]
) -> torch.Tensor:
    """
    Flax's ``nn.Dropout``: in training, keep each element with probability
    ``1 - rate`` and scale it by ``1 / (1 - rate)``; the identity
    otherwise. The mask comes from ``generator`` (on x's device).
    """
    if not training or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training mode needs an explicit torch.Generator")
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


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
    """``nn.Linear`` computing in ``dtype`` over float32 parameters.
    ``kernel_init`` names the Flax initialiser of its weight
    (``"lecun_normal"`` or ``"orthogonal"``, :func:`flax_default_init_`)."""

    def __init__(
        self,
        in_features: int,
        out_features: int,
        dtype=torch.float32,
        bias: bool = True,
        kernel_init: str = "lecun_normal",
    ):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype
        self.kernel_init = kernel_init

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


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


# -- the recurrent family ----------------------------------------------------
#
# Parameters a recurrent layer holds itself (recurrent kernels, the stacked
# schedule's input kernels) keep Flax's (in, out) layout, as the products
# ``h @ W`` read them; Dense layers keep torch's (out, in). Carries are
# float32 whatever the compute dtype, as in the JAX layers.

CELLS = ("lstm", "gru")
SCHEDULES = ("layer", "stacked")


def lstm_cell_step(c, h, z_t, w_h, b_h, act, dtype):
    """
    One LSTM timestep from the pre-projected input ``z_t`` (gate order
    [i, f, g, o], sigmoid gates, ``act`` on g and on the cell output):
    the product in ``dtype`` after ``h`` is cast to it, the gate math and
    the cell state in float32. Shared by the fused layer and the stacked
    schedule.
    """
    gates = (z_t + h.to(dtype) @ w_h + b_h).float()
    i, f, _, o = torch.sigmoid(gates).chunk(4, dim=-1)
    g = gates.chunk(4, dim=-1)[2]
    c = f * c + i * act(g)
    return c, o * act(c)


def gru_cell_step(h, z_t, w_rz, w_n, b_n, act, dtype, h_dim: int):
    """
    One GRU timestep from the pre-projected input ``z_t`` (r/z sigmoid
    gates, ``act`` on the candidate, the reset gate applied to the
    projected hidden state plus ``b_n``, ``h' = (1-z)·n + z·h``): the
    products in ``dtype``, the gate math in float32.
    """
    hd = h.to(dtype)
    rz = (z_t[..., : 2 * h_dim] + hd @ w_rz).float()
    r, zg = torch.sigmoid(rz).chunk(2, dim=-1)
    hn = (hd @ w_n).float() + b_n
    n = act(z_t[..., 2 * h_dim :].float() + r * hn)
    return (1.0 - zg) * n + zg * h


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` in x's type: XLA computes ``1 / (1 + exp(-x))``
    with each step rounded to a 16-bit type (``torch.sigmoid`` rounds once,
    and lands a bfloat16 step away from it on many values)."""
    if x.dtype in (torch.bfloat16, torch.float16):
        return 1.0 / (1.0 + torch.exp(-x))
    return torch.sigmoid(x)


def _zeros(batch: int, width: int, like: torch.Tensor) -> torch.Tensor:
    return torch.zeros((batch, width), dtype=torch.float32, device=like.device)


class FusedLSTMLayer(nn.Module):
    """
    LSTM layer with the input projection hoisted out of the time loop:
    one (time·batch, f) × (f, 4h) product without bias, then a plain
    Python loop of :func:`lstm_cell_step` over time. Time-major: (time,
    batch, f) in, (time, batch, h) in ``dtype`` out.
    """

    def __init__(self, n_in: int, features: int, func="tanh", dtype=torch.float32):
        super().__init__()
        self.features = features
        self.act = resolve_activation(func)
        self.compute_dtype = dtype
        self.input_proj = Dense(n_in, 4 * features, dtype, bias=False)
        self.recurrent_kernel = nn.Parameter(torch.zeros(features, 4 * features))
        self.recurrent_bias = nn.Parameter(torch.zeros(4 * features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t_dim, b_dim = x.shape[:2]
        dt = self.compute_dtype
        z = self.input_proj(x.reshape(t_dim * b_dim, -1)).view(t_dim, b_dim, -1)
        w_h, b_h = self.recurrent_kernel.to(dt), self.recurrent_bias.to(dt)
        c = h = _zeros(b_dim, self.features, x)
        hs = []
        for z_t in z.unbind(0):
            c, h = lstm_cell_step(c, h, z_t, w_h, b_h, self.act, dt)
            hs.append(h)
        return torch.stack(hs).to(dt)


class FusedGRULayer(nn.Module):
    """
    GRU layer with the input projections hoisted out of the time loop:
    one (time·batch, f) × (f, 3h) product with bias, then a plain Python
    loop of :func:`gru_cell_step`. The recurrent kernels are (h, 2h) for
    r/z and (h, h) for n; only n has a recurrent bias. Time-major, as
    :class:`FusedLSTMLayer`.
    """

    def __init__(self, n_in: int, features: int, func="tanh", dtype=torch.float32):
        super().__init__()
        self.features = features
        self.act = resolve_activation(func)
        self.compute_dtype = dtype
        self.input_proj = Dense(n_in, 3 * features, dtype)
        self.recurrent_kernel_rz = nn.Parameter(torch.zeros(features, 2 * features))
        self.recurrent_kernel_n = nn.Parameter(torch.zeros(features, features))
        self.recurrent_bias_n = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t_dim, b_dim = x.shape[:2]
        dt = self.compute_dtype
        z = self.input_proj(x.reshape(t_dim * b_dim, -1)).view(t_dim, b_dim, -1)
        w_rz, w_n = self.recurrent_kernel_rz.to(dt), self.recurrent_kernel_n.to(dt)
        h = _zeros(b_dim, self.features, x)
        hs = []
        for z_t in z.unbind(0):
            h = gru_cell_step(
                h, z_t, w_rz, w_n, self.recurrent_bias_n, self.act, dt, self.features
            )
            hs.append(h)
        return torch.stack(hs).to(dt)


def _gate_denses(prefix: str, gates: str, biased: str, n_in: int, features: int, dtype,
                 kernel_init: str):
    """{"<prefix><gate>": Dense} in gate order, each (n_in -> features),
    with a bias for the gates in ``biased``."""
    return {
        f"{prefix}{gate}": Dense(n_in, features, dtype, gate in biased, kernel_init)
        for gate in gates
    }


def _cat_dense(x: torch.Tensor, denses, dt) -> torch.Tensor:
    """The Denses' outputs side by side, as one product in ``dt`` (each
    column as its own Dense computes it)."""
    out = F.linear(x.to(dt), torch.cat([d.weight for d in denses]).to(dt))
    if denses[0].bias is None:
        return out
    return out + torch.cat([d.bias for d in denses]).to(dt)


class OptimizedLSTMCell(nn.Module):
    """
    The unfused LSTM layer, with the parameters of Flax's
    ``OptimizedLSTMCell``: input Denses ``ii``, ``if``, ``ig``, ``io``
    without bias, recurrent Denses ``hi``, ``hf``, ``hg``, ``ho`` with
    bias (``orthogonal()``-initialised), under ``gates``. Its arithmetic
    is Flax's: both products and the gate activations in ``dtype``, the
    cell state promoted to float32. Each gate family runs as one product
    (Flax concatenates them too), the input side hoisted out of the time
    loop. Time-major: (time, batch, f) in, (time, batch, h) float32 out.
    """

    def __init__(self, n_in: int, features: int, func="tanh", dtype=torch.float32):
        super().__init__()
        self.features = features
        self.act = resolve_activation(func)
        self.compute_dtype = dtype
        self.gates = nn.ModuleDict({
            **_gate_denses("i", "ifgo", "", n_in, features, dtype, "lecun_normal"),
            **_gate_denses("h", "ifgo", "ifgo", features, features, dtype, "orthogonal"),
        })

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t_dim, b_dim = x.shape[:2]
        dt = self.compute_dtype
        gates = self.gates
        z = _cat_dense(x.reshape(t_dim * b_dim, -1), [gates[f"i{g}"] for g in "ifgo"], dt)
        z = z.view(t_dim, b_dim, -1)
        w_h = torch.cat([gates[f"h{g}"].weight for g in "ifgo"]).to(dt).T
        b_h = torch.cat([gates[f"h{g}"].bias for g in "ifgo"]).to(dt)
        c = h = _zeros(b_dim, self.features, x)
        hs = []
        for z_t in z.unbind(0):
            pre = (h.to(dt) @ w_h + b_h) + z_t
            i, f, _, o = _sigmoid(pre).chunk(4, dim=-1)
            c = f * c + i * self.act(pre.chunk(4, dim=-1)[2])
            h = o * self.act(c)
            hs.append(h)
        return torch.stack(hs)


class GRUCell(nn.Module):
    """
    The unfused GRU layer, with the parameters of Flax's ``GRUCell``:
    input Denses ``ir``, ``iz``, ``in`` with bias, recurrent ``hr``,
    ``hz`` without and ``hn`` with bias (``orthogonal()``-initialised),
    under ``gates``. Flax's arithmetic: the products and the gates in
    ``dtype``, ``h' = (1-z)·n + z·h`` promoted to float32. The input
    side runs as one product hoisted out of the time loop, the recurrent
    side as one product a step. Time-major, float32 out.
    """

    def __init__(self, n_in: int, features: int, func="tanh", dtype=torch.float32):
        super().__init__()
        self.features = features
        self.act = resolve_activation(func)
        self.compute_dtype = dtype
        self.gates = nn.ModuleDict({
            **_gate_denses("i", "rzn", "rzn", n_in, features, dtype, "lecun_normal"),
            **_gate_denses("h", "rzn", "n", features, features, dtype, "orthogonal"),
        })

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t_dim, b_dim = x.shape[:2]
        dt, h_dim = self.compute_dtype, self.features
        gates = self.gates
        z = _cat_dense(x.reshape(t_dim * b_dim, -1), [gates[f"i{g}"] for g in "rzn"], dt)
        z = z.view(t_dim, b_dim, -1)
        w_h = torch.cat([gates[f"h{g}"].weight for g in "rzn"]).to(dt).T
        b_hn = gates["hn"].bias.to(dt)
        h = _zeros(b_dim, h_dim, x)
        hs = []
        for z_t in z.unbind(0):
            hw = h.to(dt) @ w_h
            r, zg = _sigmoid(z_t[..., : 2 * h_dim] + hw[..., : 2 * h_dim]).chunk(2, -1)
            n = self.act(z_t[..., 2 * h_dim :] + r * (hw[..., 2 * h_dim :] + b_hn))
            h = (1.0 - zg) * n + zg * h
            hs.append(h)
        return torch.stack(hs)


class StackedRecurrent(nn.Module):
    """
    The ``stacked`` schedule: every layer steps inside one time loop
    (layer l's step reads layer l-1's hidden state of the same timestep).
    Layer 0's input projection is hoisted (``input_proj_0``, with bias
    for the GRU only); layer l > 0 projects per step through
    ``input_kernel_{l}`` (and ``input_bias_{l}`` for the GRU). Recurrent
    parameters: ``recurrent_kernel_{l}``/``recurrent_bias_{l}`` (LSTM),
    ``recurrent_kernel_rz_{l}``, ``recurrent_kernel_n_{l}``,
    ``recurrent_bias_n_{l}`` (GRU). Time-major (time, batch, f) in; the
    last layer's last hidden state (batch, h) in ``dtype`` out.
    """

    def __init__(self, n_features: int, dims, funcs, cell: str = "lstm", dtype=torch.float32):
        super().__init__()
        self.dims = tuple(dims)
        self.acts = [resolve_activation(f) for f in funcs]
        self.cell = cell
        self.compute_dtype = dtype
        n_gates = 4 if cell == "lstm" else 3
        self.input_proj_0 = Dense(n_features, n_gates * dims[0], dtype, bias=cell == "gru")
        for layer, d in enumerate(dims):
            if layer:
                self._param(f"input_kernel_{layer}", dims[layer - 1], n_gates * d)
                if cell == "gru":
                    self._param(f"input_bias_{layer}", n_gates * d)
            if cell == "lstm":
                self._param(f"recurrent_kernel_{layer}", d, 4 * d)
                self._param(f"recurrent_bias_{layer}", 4 * d)
            else:
                self._param(f"recurrent_kernel_rz_{layer}", d, 2 * d)
                self._param(f"recurrent_kernel_n_{layer}", d, d)
                self._param(f"recurrent_bias_n_{layer}", d)

    def _param(self, name: str, *shape: int) -> None:
        self.register_parameter(name, nn.Parameter(torch.zeros(shape)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t_dim, b_dim = x.shape[:2]
        dt, dims, lstm = self.compute_dtype, self.dims, self.cell == "lstm"
        p = dict(self.named_parameters(recurse=False))
        z1 = self.input_proj_0(x.reshape(t_dim * b_dim, -1)).view(t_dim, b_dim, -1)
        w_x = [p[f"input_kernel_{l}"].to(dt) for l in range(1, len(dims))]
        if lstm:
            w_h = [p[f"recurrent_kernel_{l}"].to(dt) for l in range(len(dims))]
            b_h = [p[f"recurrent_bias_{l}"].to(dt) for l in range(len(dims))]
            carry = [(_zeros(b_dim, d, x), _zeros(b_dim, d, x)) for d in dims]
        else:
            b_x = [p[f"input_bias_{l}"].to(dt) for l in range(1, len(dims))]
            w_rz = [p[f"recurrent_kernel_rz_{l}"].to(dt) for l in range(len(dims))]
            w_n = [p[f"recurrent_kernel_n_{l}"].to(dt) for l in range(len(dims))]
            b_n = [p[f"recurrent_bias_n_{l}"] for l in range(len(dims))]
            carry = [_zeros(b_dim, d, x) for d in dims]
        for z1_t in z1.unbind(0):
            inp = None
            for layer, (d, act) in enumerate(zip(dims, self.acts)):
                if lstm:
                    z_t = z1_t if layer == 0 else inp @ w_x[layer - 1]
                    carry[layer] = lstm_cell_step(
                        *carry[layer], z_t, w_h[layer], b_h[layer], act, dt
                    )
                    h = carry[layer][1]
                else:
                    z_t = z1_t if layer == 0 else inp @ w_x[layer - 1] + b_x[layer - 1]
                    h = carry[layer] = gru_cell_step(
                        carry[layer], z_t, w_rz[layer], w_n[layer], b_n[layer], act, dt, d
                    )
                inp = h.to(dt)
        return inp


_RAW_PARAM_LAYERS = (FusedLSTMLayer, FusedGRULayer, StackedRecurrent)


class LSTMNet(nn.Module):
    """
    Stacked recurrent layers -> Dense head (the port of the JAX
    ``LSTMNet``): every layer passes its whole sequence to the next and
    ``head`` reads the last layer's last timestep. ``cell`` is ``"lstm"``
    or ``"gru"``. ``fused=False`` runs Flax's cells
    (:class:`OptimizedLSTMCell`, :class:`GRUCell`); ``fused=True`` the
    fused layers under ``schedule="layer"`` or one :class:`StackedRecurrent`
    under ``schedule="stacked"``. Each choice has its own parameter tree.
    ``time_unroll`` is stored so that a definition round-trips; it only
    shapes the JAX scan, and the port's time loop ignores it. Input
    (batch, time, features); returns (output (batch, out_dim) as float32,
    penalty 0).
    """

    def __init__(
        self,
        n_features: int,
        layer_dims: Tuple[int, ...],
        layer_funcs: Tuple[str, ...],
        out_dim: int,
        out_func: str = "linear",
        fused: bool = False,
        cell: str = "lstm",
        time_unroll: int = 1,
        schedule: str = "layer",
        dtype=torch.float32,
    ):
        super().__init__()
        if cell not in CELLS:
            raise ValueError(f"Unknown recurrent cell {cell!r}")
        if schedule not in SCHEDULES:
            raise ValueError(f"Unknown schedule {schedule!r}")
        if schedule == "stacked" and not fused:
            raise ValueError('schedule="stacked" requires fused=True')
        self.cell, self.fused, self.schedule = cell, fused, schedule
        self.time_unroll = int(time_unroll)
        if fused and schedule == "stacked":
            self.stack = StackedRecurrent(n_features, layer_dims, layer_funcs, cell, dtype)
        else:
            layer_cls = {
                ("lstm", True): FusedLSTMLayer,
                ("gru", True): FusedGRULayer,
                ("lstm", False): OptimizedLSTMCell,
                ("gru", False): GRUCell,
            }[cell, fused]
            widths = (n_features, *layer_dims)
            self.layers = nn.ModuleList(
                layer_cls(n_in, d, func, dtype)
                for n_in, d, func in zip(widths[:-1], widths[1:], layer_funcs)
            )
        self.head = Dense(layer_dims[-1] if layer_dims else n_features, out_dim, dtype)
        self.out_func = resolve_activation(out_func)

    def forward(
        self, x: torch.Tensor, generator: Optional[torch.Generator] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = x.transpose(0, 1)  # time-major through the whole stack
        if hasattr(self, "stack"):
            h = self.stack(x)
        else:
            for layer in self.layers:
                x = layer(x)
            h = x[-1]
        out = self.out_func(self.head(h)).float()
        return out, torch.zeros((), dtype=torch.float32, device=out.device)


#: SequentialNet's layer kinds
SEQUENTIAL_KINDS = ("dense", "lstm", "dropout", "activation", "flatten")


class SequentialNet(nn.Module):
    """
    A layer stack from a raw layer list (the port of the JAX
    ``SequentialNet``, behind ``RawModelRegressor``): each entry is
    ``(kind, ((name, value), ...))`` with kind ``"dense"`` (``units``,
    ``activation``), ``"lstm"`` (``units``, ``activation``,
    ``return_sequences``: Flax's ``OptimizedLSTMCell`` over the time
    axis, the last step unless ``return_sequences``), ``"dropout"``
    (``rate``), ``"activation"`` or ``"flatten"``. The k-th Dense is
    ``dense.<k>`` (Flax's ``Dense_<k>``) and the k-th LSTM ``lstm.<k>``
    (``OptimizedLSTMCell_<k>``).

    Torch needs the widths up front where Flax infers them: the input is
    (batch, n_features), or (batch, n_steps, n_features) when ``n_steps``
    is given (an ``lstm`` layer needs that). Returns (output as float32,
    penalty 0).
    """

    def __init__(self, n_features: int, layers, n_steps: Optional[int] = None,
                 dtype=torch.float32):
        super().__init__()
        self.dense = nn.ModuleList()
        self.lstm = nn.ModuleList()
        self.plan = []  # (kind, module or None, kwargs)
        steps, width = n_steps, n_features
        for kind, frozen in layers:
            kwargs = dict(frozen)
            module = None
            if kind == "dense":
                module = Dense(width, int(kwargs["units"]), dtype)
                self.dense.append(module)
                width = int(kwargs["units"])
            elif kind == "lstm":
                if steps is None:
                    raise ValueError("an lstm layer needs (batch, time, features) input")
                module = OptimizedLSTMCell(
                    width, int(kwargs["units"]), kwargs.get("activation", "tanh"), dtype
                )
                self.lstm.append(module)
                width = int(kwargs["units"])
                if not kwargs.get("return_sequences", False):
                    steps = None
            elif kind == "flatten":
                width, steps = width * (steps or 1), None
            elif kind not in SEQUENTIAL_KINDS:
                raise ValueError(f"Unknown raw layer type {kind!r}")
            self.plan.append((kind, module, kwargs))
        self.out_features = width

    def forward(
        self, x: torch.Tensor, generator: Optional[torch.Generator] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        for kind, module, kwargs in self.plan:
            if kind == "dense":
                x = resolve_activation(kwargs.get("activation", "linear"))(module(x))
            elif kind == "lstm":
                x = module(x.transpose(0, 1)).transpose(0, 1)
                if not kwargs.get("return_sequences", False):
                    x = x[:, -1, :]
            elif kind == "dropout":
                x = dropout(x, float(kwargs.get("rate", 0.5)), self.training, generator)
            elif kind == "activation":
                x = resolve_activation(kwargs.get("activation", "linear"))(x)
            else:  # flatten
                x = x.reshape(x.shape[0], -1)
        return x.float(), torch.zeros((), dtype=torch.float32, device=x.device)
