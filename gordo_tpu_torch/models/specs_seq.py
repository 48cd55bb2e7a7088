"""
Transformer encoder and temporal convolutional network for timeseries
anomaly models (the port of ``gordo_tpu.models.specs_seq``).

Parameters live in float32; ``dtype`` is the compute type of the Linear
layers (as Flax's ``Dense(dtype=...)``), while LayerNorm and the softmax
stay in float32. Attention is pluggable: ``"dense"`` is the plain einsum
path, ``"flash"`` the hand-written CUDA kernels of
``gordo_tpu_torch.ops.flash_attention`` (forward, and dq and dk/dv in
the backward; their plain versions on CPU tensors).

Dropout sits where the JAX model has it (after the attention block's
output projection, after the feed-forward block and after the
embedding) and acts only in training mode (``module.train()``), with
masks drawn from the ``generator`` handed to ``forward``: torch's own
``F.dropout`` reads the global RNG, which a seeded fit must not.

The TCN (:class:`TCNNet`) is a stack of dilated causal convolution
blocks: each convolution is ``F.conv1d`` with ``dilation=d`` after a
left pad of ``(k-1)·d`` steps, as the JAX net's ``nn.Conv`` (``VALID``)
after its ``jnp.pad``; the library convolution stands where the JAX
package runs XLA's, outside any Pallas kernel.

``TransformerNet(remat=True)`` rematerialises each block, as the JAX
net's ``nn.remat``: the block runs under
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``, so only the
block's input is kept for the backward pass and its internals (attention
and feed-forward activations) are recomputed there; the flash forward
runs a second time in each block's backward. The parameter names do not
change, so either twin loads the other's weights. The recompute draws
the same dropout masks as the forward: the block's generator (a
``torch.Generator`` or a ``DropoutFeed``) is set back to its state at
the block's entry for the recompute and restored after it, as JAX's
``nn.remat`` replays its key (checkpoint's own RNG preservation covers
only the global generators, which the port never draws from). No factory
sets the flag; the JAX package reaches it only from long-context
sequence sharding (ROADMAP.md queue 1 item 10).

Not ported yet: sequence sharding (``seq_axis``, ROADMAP.md queue 1 item
10).
"""

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from gordo_tpu_torch.models.specs import Dense, DropoutFeed, cast, dropout
from gordo_tpu_torch.ops.activations import resolve_activation
from gordo_tpu_torch.ops.flash_attention import flash_attention

ATTENTION_IMPLS = ("dense", "flash")

#: Flax's LayerNorm epsilon (torch's default is 1e-5)
LAYER_NORM_EPS = 1e-6


def sinusoidal_positions(seq_len: int, d_model: int, device=None) -> torch.Tensor:
    """Fixed sinusoidal positional encoding, (seq_len, d_model) float32."""
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d_model, 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / 10000.0 ** (dim / d_model)
    enc = torch.zeros((seq_len, d_model), dtype=torch.float32, device=device)
    enc[:, 0::2] = torch.sin(angle)
    enc[:, 1::2] = torch.cos(angle[:, : d_model // 2])
    return enc


def dense_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """
    Plain dot-product attention over (batch, seq, heads, head_dim)
    tensors; the softmax runs in float32 whatever the compute dtype.
    """
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * sm_scale
    if causal:
        q_len, k_len = scores.shape[-2], scores.shape[-1]
        keep = torch.ones(q_len, k_len, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~keep, torch.finfo(torch.float32).min)
    weights = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


class LayerNorm(nn.LayerNorm):
    """Flax-style LayerNorm: eps 1e-6, computed and returned in float32
    (its scale and bias too, as the JAX ``LayerNorm(dtype=float32)``
    promotes bf16-served ones)."""

    def __init__(self, d_model: int):
        super().__init__(d_model, eps=LAYER_NORM_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        f32 = torch.float32
        return F.layer_norm(cast(x, f32), self.normalized_shape, cast(self.weight, f32),
                            cast(self.bias, f32), self.eps)


class MultiHeadSelfAttention(nn.Module):
    """QKV projection + pluggable attention core + output projection."""

    def __init__(
        self,
        d_model: int,
        n_heads: int,
        causal: bool = False,
        attention_impl: str = "dense",
        dtype=torch.float32,
    ):
        super().__init__()
        if d_model % n_heads:
            raise ValueError(f"d_model={d_model} not divisible by n_heads={n_heads}")
        if attention_impl not in ATTENTION_IMPLS:
            raise ValueError(
                f"Unknown attention_impl {attention_impl!r}; available: {ATTENTION_IMPLS}"
            )
        self.n_heads = n_heads
        self.causal = causal
        self.attention_impl = attention_impl
        self.query = Dense(d_model, d_model, dtype)
        self.key = Dense(d_model, d_model, dtype)
        self.value = Dense(d_model, d_model, dtype)
        self.out = Dense(d_model, d_model, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        batch, seq, d_model = x.shape
        head_dim = d_model // self.n_heads

        def proj(layer):
            # a view: the kernel reads the heads through their strides
            return layer(x).view(batch, seq, self.n_heads, head_dim)

        q, k, v = proj(self.query), proj(self.key), proj(self.value)
        attend = flash_attention if self.attention_impl == "flash" else dense_attention
        out = attend(q, k, v, causal=self.causal)
        return self.out(out.reshape(batch, seq, d_model))


class TransformerBlock(nn.Module):
    """Pre-LayerNorm encoder block: MHA + MLP, residual around each."""

    def __init__(
        self,
        d_model: int,
        n_heads: int,
        ff_dim: int,
        causal: bool = False,
        attention_impl: str = "dense",
        ff_func: str = "gelu",
        dtype=torch.float32,
        dropout: float = 0.0,
    ):
        super().__init__()
        self.dropout = dropout
        self.norm1 = LayerNorm(d_model)
        self.attn = MultiHeadSelfAttention(d_model, n_heads, causal, attention_impl, dtype)
        self.norm2 = LayerNorm(d_model)
        self.ff1 = Dense(d_model, ff_dim, dtype)
        self.ff2 = Dense(ff_dim, d_model, dtype)
        self.ff_func = resolve_activation(ff_func)

    def forward(
        self, x: torch.Tensor, generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        x = x + dropout(self.attn(self.norm1(x)), self.dropout, self.training, generator)
        h = self.ff2(self.ff_func(self.ff1(self.norm2(x))))
        return x + dropout(h, self.dropout, self.training, generator)


def _rng_state(generator):
    """The state a block's recompute must start its dropout draws from."""
    if isinstance(generator, torch.Generator):
        return generator.get_state()
    if isinstance(generator, DropoutFeed):
        return None if generator.draws is None else list(generator.draws)
    return None


def _set_rng_state(generator, state) -> None:
    if isinstance(generator, torch.Generator):
        generator.set_state(state)
    elif isinstance(generator, DropoutFeed) and state is not None:
        generator.draws = list(state)


def rematerialised(block: nn.Module, h: torch.Tensor, generator) -> torch.Tensor:
    """``block(h, generator)`` under non-reentrant activation checkpointing,
    its recompute replaying the dropout draws of the forward (module
    docstring)."""
    entry = _rng_state(generator)
    calls = [0]

    def run(x):
        calls[0] += 1
        if calls[0] == 1 or entry is None:
            return block(x, generator)
        after = _rng_state(generator)
        _set_rng_state(generator, entry)
        try:
            return block(x, generator)
        finally:
            _set_rng_state(generator, after)

    return checkpoint(run, h, use_reentrant=False, preserve_rng_state=False)


class TransformerNet(nn.Module):
    """
    Encoder-only Transformer over a lookback window: embed sensors into
    d_model, add sinusoidal positions, run n_layers blocks, and read the
    final timestep through a Linear head. Input (batch, time, features),
    output (batch, out_dim) float32. ``generator`` draws the dropout
    masks in training mode. ``remat`` recomputes each block's internals
    in the backward pass (module docstring).
    """

    def __init__(
        self,
        n_features: int,
        d_model: int,
        n_heads: int,
        n_layers: int,
        ff_dim: int,
        out_dim: int,
        causal: bool = True,
        attention_impl: str = "dense",
        out_func: str = "linear",
        dtype=torch.float32,
        dropout: float = 0.0,
        remat: bool = False,
    ):
        super().__init__()
        self.d_model = d_model
        self.dropout = dropout
        self.remat = remat
        self.embed = Dense(n_features, d_model, dtype)
        self.blocks = nn.ModuleList(
            TransformerBlock(
                d_model, n_heads, ff_dim, causal, attention_impl, dtype=dtype, dropout=dropout
            )
            for _ in range(n_layers)
        )
        self.norm = LayerNorm(d_model)
        self.head = Dense(d_model, out_dim, dtype)
        self.out_func = resolve_activation(out_func)

    def forward(
        self, x: torch.Tensor, generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        h = self.embed(x)
        h = h + cast(sinusoidal_positions(x.shape[1], self.d_model, device=h.device), h.dtype)
        h = dropout(h, self.dropout, self.training, generator)
        for block in self.blocks:
            if self.remat and torch.is_grad_enabled():
                h = rematerialised(block, h, generator)
            else:
                h = block(h, generator)
        h = self.norm(h)[:, -1, :]
        return cast(self.out_func(self.head(h)), torch.float32)


class Conv(nn.Conv1d):
    """Flax's ``nn.Conv`` over one axis, computing in ``dtype`` over
    float32 parameters: input and weight cast to ``dtype``, the product
    rounded to it, then the bias added in it. Channels first, (batch,
    channels, time); no padding of its own (Flax's ``VALID``)."""

    def __init__(self, n_in: int, n_out: int, kernel_size: int, dilation: int = 1,
                 dtype=torch.float32):
        super().__init__(n_in, n_out, kernel_size, dilation=dilation)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        out = F.conv1d(cast(x, dt), cast(self.weight, dt), dilation=self.dilation)
        return out + cast(self.bias, dt)[:, None]


def _over_channels(func, h: torch.Tensor) -> torch.Tensor:
    """An activation over a channels-first tensor, applied along its
    channel axis (the last axis of the JAX net's layout)."""
    return func(h.transpose(1, 2)).transpose(1, 2)


class TCNBlock(nn.Module):
    """
    A dilated causal convolution block: twice (left pad, ``Conv``,
    activation, dropout), plus a 1x1 ``residual_proj`` on the residual
    where the channel counts differ; returns ``act(x + residual)``.
    Channels first, (batch, channels, time).
    """

    def __init__(self, n_in: int, channels: int, kernel_size: int, dilation: int,
                 dropout: float = 0.0, func: str = "relu", dtype=torch.float32):
        super().__init__()
        self.pad = (kernel_size - 1) * dilation
        self.dropout = dropout
        self.func = resolve_activation(func)
        self.conv0 = Conv(n_in, channels, kernel_size, dilation, dtype)
        self.conv1 = Conv(channels, channels, kernel_size, dilation, dtype)
        if n_in != channels:
            self.residual_proj = Conv(n_in, channels, 1, 1, dtype)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        residual = x
        for conv in (self.conv0, self.conv1):
            h = _over_channels(self.func, conv(F.pad(x, (self.pad, 0))))
            x = dropout(h, self.dropout, self.training, generator)
        if hasattr(self, "residual_proj"):
            residual = self.residual_proj(residual)
        return _over_channels(self.func, x + residual)


class TCNNet(nn.Module):
    """
    Temporal convolutional network: :class:`TCNBlock` s with the given
    channels and dilations, then a Dense ``head`` on the last timestep.
    Input (batch, time, features); returns (output (batch, out_dim) as
    float32, penalty 0). ``generator`` draws the dropout masks in
    training mode.
    """

    def __init__(
        self,
        n_features: int,
        channels: Tuple[int, ...],
        kernel_size: int,
        dilations: Tuple[int, ...],
        out_dim: int,
        dropout: float = 0.0,
        func: str = "relu",
        out_func: str = "linear",
        dtype=torch.float32,
    ):
        super().__init__()
        widths = (n_features, *channels)
        self.blocks = nn.ModuleList(
            TCNBlock(n_in, ch, kernel_size, dil, dropout, func, dtype)
            for n_in, ch, dil in zip(widths[:-1], widths[1:], dilations)
        )
        self.head = Dense(widths[-1], out_dim, dtype)
        self.out_func = resolve_activation(out_func)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        h = x.transpose(1, 2)
        for block in self.blocks:
            h = block(h, generator)
        out = cast(self.out_func(self.head(h[:, :, -1])), torch.float32)
        return out, torch.zeros((), dtype=torch.float32, device=out.device)


def default_dilations(n_blocks: int) -> Tuple[int, ...]:
    """The doubling schedule 1, 2, 4, ... for ``n_blocks`` blocks."""
    return tuple(2 ** i for i in range(n_blocks))


def receptive_field(kernel_size: int, dilations: Tuple[int, ...]) -> int:
    """Timesteps the last output of a TCN stack sees (two convolutions a
    block)."""
    return 1 + 2 * (kernel_size - 1) * sum(dilations)
