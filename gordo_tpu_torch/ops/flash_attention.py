"""
Flash attention forward: the port of ``gordo_tpu.ops.flash_attention``'s
forward pass (the Pallas ``_attn_kernel``) to a CUDA kernel written by
hand for Hopper (``csrc/flash_attention_fwd.cu``).

Public layout is (batch, seq, heads, head_dim), as in the JAX package.
The kernel reads q/k/v through their strides and writes ``out`` in the
same layout, so the (batch*heads, seq, head_dim) transposes of the JAX
wrapper are gone; the per-row log-sum-exp comes back as (batch*heads,
seq) float32 with row ``b * heads + h``.

- A CUDA tensor launches the kernel, or raises: there is no fallback.
- A CPU tensor runs :func:`flash_attention_reference`, the plain PyTorch
  version of the same function (the tests use it; so does
  ``chip_smoke.py``, to hold the kernel against it on the card).

``launch_counts`` counts kernel launches, so a run can show that its
attention went through the kernel. The backward kernels (``dq``,
``dk``/``dv``) belong to the training slice; serving needs the forward
only.
"""

import ctypes
import math
from typing import Optional, Tuple

import torch

KERNEL = "flash_attention_fwd"
HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: kernel launches since the last reset (compare-with-plain runs included)
launch_counts = {KERNEL: 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    sm_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """
    Plain PyTorch attention in float32: (out in q's dtype, lse of shape
    (batch*heads, seq) in float32). Materializes the (seq, seq) scores.
    """
    batch, seq, heads, head_dim = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(head_dim)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        keep = torch.ones(seq, seq, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~keep, float("-inf"))
    lse = torch.logsumexp(scores, dim=-1)  # (batch, heads, seq)
    weights = torch.exp(scores - lse[..., None])
    out = torch.einsum("bhqk,bkhd->bqhd", weights, v.float())
    return out.to(q.dtype), lse.reshape(batch * heads, seq)


def _check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(
            "flash_attention takes q, k, v of one (batch, seq, heads, head_dim) "
            f"shape; got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v devices differ: {q.device}, {k.device}, {v.device}")


def _launch(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool,
    sm_scale: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the CUDA kernel on CUDA tensors; raises on what it does not take."""
    batch, seq, heads, head_dim = q.shape
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(
            f"flash_attention kernel takes float32 or bfloat16, got {q.dtype}"
        )
    if head_dim not in HEAD_DIMS:
        raise ValueError(
            f"flash_attention kernel takes head_dim in {HEAD_DIMS}, got {head_dim}"
        )
    q, k, v = (x if x.stride(-1) == 1 else x.contiguous() for x in (q, k, v))
    out = torch.empty((batch, seq, heads, head_dim), dtype=q.dtype, device=q.device)
    lse = torch.empty((batch * heads, seq), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    fn = _kernel_function()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            batch, seq, heads, head_dim, _DTYPE_CODES[q.dtype],
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            float(sm_scale), int(bool(causal)), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"{KERNEL} launch failed with CUDA error {err} "
            f"(shape {tuple(q.shape)}, dtype {q.dtype})"
        )
    launch_counts[KERNEL] += 1
    return out, lse


def _kernel_function():
    from gordo_tpu_torch.ops import _build

    fn = _build.load(KERNEL).gordo_flash_attention_fwd
    if fn.argtypes is None:
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = (
            [ptr] * 5 + [i32] * 5 + [i64] * 12 + [ctypes.c_float, i32, ptr]
        )
        fn.restype = i32
    return fn


def flash_attention_forward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    sm_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """
    (out, lse) of attention over (batch, seq, heads, head_dim) tensors:
    the CUDA kernel for CUDA tensors, the plain version for CPU tensors.
    """
    _check_inputs(q, k, v)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cuda":
        return _launch(q, k, v, causal, sm_scale)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, sm_scale)
    raise ValueError(f"flash_attention has no path for device {q.device}")


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """
    Flash attention over (batch, seq, heads, head_dim) tensors — drop-in
    for ``gordo_tpu_torch.models.specs_seq.dense_attention`` and the
    counterpart of ``gordo_tpu.ops.flash_attention.flash_attention``.
    """
    return flash_attention_forward(q, k, v, causal, sm_scale)[0]
