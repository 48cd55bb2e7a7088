"""
Flash attention, forward and backward: the port of
``gordo_tpu.ops.flash_attention`` (the Pallas ``_attn_kernel``,
``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` and the custom VJP around
them) to CUDA kernels written by hand for Hopper
(``csrc/flash_attention_fwd.cu``, ``csrc/flash_attention_bwd.cu``).

Public layout is (batch, seq, heads, head_dim), as in the JAX package.
The kernels read q/k/v/dO through their strides and write their outputs
in the same layout, so the (batch*heads, seq, head_dim) transposes of the
JAX wrapper are gone; the per-row log-sum-exp (and the backward's
``delta = rowsum(dO * O)``) are (batch*heads, seq) float32 with row
``b * heads + h``.

- A CUDA tensor launches a kernel, or raises: there is no fallback.
- A CPU tensor runs the plain PyTorch version of the same function
  (``flash_attention_reference``, ``flash_attention_bwd_dq_reference``
  and ``flash_attention_bwd_dkv_reference``;
  ``flash_attention_backward_reference`` composes the two halves for the
  tests). The tests use them; so does
  ``chip_smoke.py``, to hold each kernel against its plain version on the
  card. The plain versions compute in float32, or in float64 for float64
  inputs (``gradcheck``). The kernels take float32, bfloat16, float16 and
  float64 and, as the Pallas kernels do, convert each element to float32
  on load and sum in float32, returning the input's dtype. The
  tensor-core kernels (bfloat16 and float16 at kernel width 64 and 128)
  multiply in the input's type: they carry the probabilities P of P·V in
  the forward, and Pᵀ and dSᵀ of Pᵀ·dO and dSᵀ·Q in dk/dv, as two terms
  of that type (head + tail), where FlashAttention and PyTorch's SDPA
  round them once; dq's dS of dS·K is rounded once. The plain versions
  keep them in float32, as the Pallas kernel does on the CPU.

:func:`flash_attention` is differentiable through
:class:`FlashAttentionFunction`, which saves (q, k, v, out, lse) as the
JAX custom VJP does. Its backward (:class:`FlashAttentionBackward`) runs
the dq kernel, which also writes delta, and then the dk/dv kernel, which
reads it. Both work under ``torch.func.vmap`` (the fleet trainer's
machine axis): the vmapped axis is folded into the batch axis and the
same kernels launch once on the folded tensors.

``launch_counts`` counts kernel launches by entry point,
``kernel_launches`` by the CUDA kernel each ran and ``typed_launches``
by that kernel and its input type, so a run can show that its attention
went through the kernels, in which type.

The kernels run at head_dim 16, 32, 64, 128 and 256 (:data:`HEAD_DIMS`)
and, through kernels that take the width at run time, at any multiple of
128 above 256, with no upper limit. As the JAX wrapper pads head_dim to a
multiple of 128 lanes, every wrapper here zero-pads q, k, v (and O, dO)
on the head axis to the kernel width (:func:`kernel_width`: 8 and 12 run
at 16, 24 at 32, 48 at 64, 96 at 128, 129-255 at 256, 257-384 at 384, 640
at 640, 1025-1152 at 1152), keeps ``sm_scale`` at 1/sqrt(the caller's
head_dim) unless the caller gives one, and slices out, dq, dk and dv
back. Zero lanes add nothing to a score and give zero output and
gradient, and LSE and delta are unchanged. The CPU path pads too, so the
CPU tests run the padding the card runs.

Which CUDA kernel an entry point runs depends on the width and the type:
the quad-lane kernels at 16 and 32; at 64 and 128 the tensor-core
kernels (``mma.sync``) for all three entry points in bfloat16/float16,
and the CUDA-core "wide" kernels for float32 and float64; the wide
kernels at 256; above 256 the width-sliced forward ("sliced") and the
"tiled" dq and dk/dv kernels, which own a tile of rows and one column
slice of their outputs a block and recompute the scores over the whole
width per slice: on the tensor cores in bfloat16/float16 ("tiled_mma",
Pᵀ and dSᵀ of dk/dv as head + tail, dS of dq rounded once), on the CUDA
cores in float32/float64 ("tiled"). None of them has a width limit.
The kernel's C side reports the family it launched, and the wrapper
counts it in :data:`kernel_launches` beside the entry point's own count
in :data:`launch_counts`. The C interface takes batch, seq, heads and
head_dim (and batch * heads) as int32: a wider shape raises here.

The forward and the dq kernel may split the key axis across blocks when
a launch's row tiles alone leave the card's SMs idle (head_dim 64 and
up), and the dk/dv kernel its query axis above 256: the kernel's C side
answers how many splits a shape takes (:func:`forward_splits`,
:func:`dq_splits`, :func:`dkv_splits`), and the wrapper allocates the
float32 scratch the splits write before a second kernel merges them in a
fixed order.

Each kernel takes a ``mode`` bit set: :data:`MODE_CAUSAL`, and
:data:`MODE_VEC16` when :func:`rows_16b_aligned` finds every row of its
tensors 16-byte aligned, so the kernel may move rows with 16-byte copies;
otherwise the same kernel moves them element by element. The decision is
made here, per call, and is tested on the CPU.
"""

import ctypes
import functools
import math
from typing import Dict, Optional, Tuple

import torch

KERNEL = "flash_attention_fwd"
KERNEL_DQ = "flash_attention_bwd_dq"
KERNEL_DKV = "flash_attention_bwd_dkv"
#: the CUDA source (``csrc/<name>.cu``) of each kernel
SOURCES = {KERNEL: "flash_attention_fwd", KERNEL_DQ: "flash_attention_bwd",
           KERNEL_DKV: "flash_attention_bwd"}
HEAD_DIMS = (16, 32, 64, 128, 256)
#: the C interface's int32 shape arguments
_INT32_MAX = 2**31 - 1
#: above the widest of HEAD_DIMS, widths are padded to a multiple of this
_LANE_PAD = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2, torch.float64: 3}
#: bits of a kernel's ``mode`` argument
MODE_CAUSAL = 1
MODE_VEC16 = 2
_VEC_BYTES = 16

#: the kernel families an entry point reports (``flash::kFamily*``, in order)
FAMILIES = ("quad", "wide", "mma", "tiled", "sliced", "tiled_mma")
#: each entry point's kernels, by family
KERNEL_FAMILIES = {
    KERNEL: ("quad", "wide", "mma", "sliced"),
    KERNEL_DQ: ("quad", "wide", "mma", "tiled", "tiled_mma"),
    KERNEL_DKV: ("quad", "wide", "mma", "tiled", "tiled_mma"),
}

#: kernel launches since the last reset, by entry point (compare-with-plain
#: runs included)
launch_counts = {KERNEL: 0, KERNEL_DQ: 0, KERNEL_DKV: 0}
#: the same launches by the CUDA kernel that ran, ``<entry point>_<family>``
kernel_launches = {
    f"{entry}_{family}": 0 for entry, families in KERNEL_FAMILIES.items() for family in families
}


#: calls of each entry point that ran its plain version, on CPU tensors
#: (the CPU's counterpart of ``launch_counts``)
plain_calls = {KERNEL: 0, KERNEL_DQ: 0, KERNEL_DKV: 0}


#: the same launches by CUDA kernel and input type,
#: ``<entry point>_<family>_<dtype>`` (``flash_attention_fwd_quad_bfloat16``)
typed_launches: Dict[str, int] = {}


def reset_launch_counts() -> None:
    for counts in (launch_counts, kernel_launches, plain_calls):
        for name in counts:
            counts[name] = 0
    typed_launches.clear()


def _plain_dtype(dtype: torch.dtype) -> torch.dtype:
    """float32, or float64 for float64 inputs."""
    return torch.promote_types(dtype, torch.float32)


def _causal_keep(seq: int, device) -> torch.Tensor:
    return torch.ones(seq, seq, dtype=torch.bool, device=device).tril()


def _scores(q, k, causal, sm_scale):
    """(batch, heads, seq_q, seq_k) scaled scores in the plain type, the
    causal mask's dropped pairs at -inf."""
    acc = _plain_dtype(q.dtype)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), k.to(acc)) * sm_scale
    if causal:
        scores = scores.masked_fill(~_causal_keep(q.shape[1], q.device), float("-inf"))
    return scores


def _default_scale(q: torch.Tensor, sm_scale: Optional[float]) -> float:
    return 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None else sm_scale


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    sm_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """
    Plain PyTorch attention: (out in q's dtype, lse of shape
    (batch*heads, seq)). Materializes the (seq, seq) scores.
    """
    batch, seq, heads, _ = q.shape
    scores = _scores(q, k, causal, _default_scale(q, sm_scale))
    lse = torch.logsumexp(scores, dim=-1)  # (batch, heads, seq)
    weights = torch.exp(scores - lse[..., None])
    out = torch.einsum("bhqk,bkhd->bqhd", weights, v.to(weights.dtype))
    return out.to(q.dtype), lse.reshape(batch * heads, seq)


def _probabilities(q, k, lse, causal, sm_scale):
    """p = exp(scores - lse), 0 where the mask drops the pair."""
    batch, seq, heads, _ = q.shape
    scores = _scores(q, k, causal, sm_scale)
    return torch.exp(scores - lse.to(scores.dtype).reshape(batch, heads, seq, 1))


def flash_attention_bwd_dq_reference(q, k, v, out, lse, d_out, causal, sm_scale):
    """Plain version of the dq kernel: (dq in q's dtype, delta of shape
    (batch*heads, seq) in the plain type), with ``delta = rowsum(dO * O)`` and
    ``dq = sm_scale * [p * (dO.vᵀ - delta)] k``."""
    batch, seq, heads, _ = q.shape
    prob = _probabilities(q, k, lse, causal, sm_scale)
    acc = prob.dtype
    d_out = d_out.to(acc)
    delta = (d_out * out.to(acc)).sum(-1).permute(0, 2, 1)  # (batch, heads, seq)
    dp = torch.einsum("bqhd,bkhd->bhqk", d_out, v.to(acc))
    ds = prob * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.to(acc)) * sm_scale
    return dq.to(q.dtype), delta.reshape(batch * heads, seq)


def flash_attention_bwd_dkv_reference(q, k, v, lse, delta, d_out, causal, sm_scale):
    """Plain version of the dk/dv kernel: (dk, dv) in k's and v's dtypes,
    ``dv = pᵀ dO`` and ``dk = sm_scale * [p * (dO.vᵀ - delta)]ᵀ q``."""
    batch, seq, heads, _ = q.shape
    prob = _probabilities(q, k, lse, causal, sm_scale)
    acc = prob.dtype
    d_out = d_out.to(acc)
    dp = torch.einsum("bqhd,bkhd->bhqk", d_out, v.to(acc))
    ds = prob * (dp - delta.to(acc).reshape(batch, heads, seq, 1))
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.to(acc)) * sm_scale
    dv = torch.einsum("bhqk,bqhd->bkhd", prob, d_out)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_backward_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    d_out: torch.Tensor,
    causal: bool = False,
    sm_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """
    Plain PyTorch backward of attention (the FlashAttention-2 formulas on
    materialized scores): (dq, dk, dv) from the forward's residuals and
    the output's gradient ``d_out``.
    """
    sm_scale = _default_scale(q, sm_scale)
    dq, delta = flash_attention_bwd_dq_reference(q, k, v, out, lse, d_out, causal, sm_scale)
    dk, dv = flash_attention_bwd_dkv_reference(q, k, v, lse, delta, d_out, causal, sm_scale)
    return dq, dk, dv


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


def _check_kernel_inputs(q: torch.Tensor) -> None:
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(
            "flash_attention kernels take float32, bfloat16, float16 or float64, "
            f"got {q.dtype}"
        )
    batch, seq, heads, head_dim = q.shape
    if max(batch * heads, seq, head_dim) > _INT32_MAX:
        raise ValueError(
            "flash_attention kernels take batch * heads, seq and head_dim as int32 "
            f"(at most {_INT32_MAX}), got shape {tuple(q.shape)}"
        )


def kernel_width(head_dim: int) -> int:
    """The head_dim a kernel runs ``head_dim`` at: the next of
    :data:`HEAD_DIMS`, or above the widest of them the next multiple of
    128, as the JAX wrapper pads."""
    for width in HEAD_DIMS:
        if head_dim <= width:
            return width
    return -(-head_dim // _LANE_PAD) * _LANE_PAD


def _to_width(width: int, *tensors: torch.Tensor):
    """Each (..., head_dim) tensor zero-padded on its last axis to ``width``."""
    return [
        x if x.shape[-1] == width else torch.nn.functional.pad(x, (0, width - x.shape[-1]))
        for x in tensors
    ]


def _heads(x: torch.Tensor, head_dim: int) -> torch.Tensor:
    """x's first ``head_dim`` lanes: a kernel-width result sliced back."""
    return x if x.shape[-1] == head_dim else x[..., :head_dim]


def _head_dim_contiguous(*tensors):
    return [x if x.stride(-1) == 1 else x.contiguous() for x in tensors]


def _stat_rows(q: torch.Tensor, stat: torch.Tensor) -> torch.Tensor:
    """A (batch*heads, seq) float32 row statistic, contiguous, on q's device."""
    batch, seq, heads, _ = q.shape
    if stat.shape != (batch * heads, seq) or stat.device != q.device:
        raise ValueError(
            f"row statistic of shape {tuple(stat.shape)} on {stat.device}; "
            f"expected ({batch * heads}, {seq}) on {q.device}"
        )
    return stat.float().contiguous()


def _kernel_function(kernel: str, n_pointers: int):
    """The entry point ``gordo_<kernel>``. Every kernel takes its tensor
    pointers, (batch, seq, heads, head_dim, dtype), an array of each
    tensor's (batch, seq, head) strides, sm_scale, its mode bits, the
    stream and where to write the family of the kernel it launched."""
    from gordo_tpu_torch.ops import _build

    fn = getattr(_build.load(SOURCES[kernel]), f"gordo_{kernel}")
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr] * n_pointers + [i32] * 5 + [
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, i32, ptr,
            ctypes.POINTER(ctypes.c_int)]
        fn.restype = i32
    return fn


def _call(kernel: str, fn, q: torch.Tensor, args) -> None:
    """Run ``fn(*args, stream, &family)`` on q's device and count the
    launch, by entry point and by the kernel family it reports."""
    family = ctypes.c_int(-1)
    with torch.cuda.device(q.device):
        err = fn(*args, torch.cuda.current_stream(q.device).cuda_stream, ctypes.byref(family))
    if err != 0:
        raise RuntimeError(
            f"{kernel} launch failed with CUDA error {err} "
            f"(shape {tuple(q.shape)}, dtype {q.dtype})"
        )
    name = f"{kernel}_{FAMILIES[family.value]}"
    kernel_launches[name] += 1
    typed = f"{name}_{str(q.dtype).replace('torch.', '')}"
    typed_launches[typed] = typed_launches.get(typed, 0) + 1
    launch_counts[kernel] += 1


def rows_16b_aligned(*tensors: torch.Tensor) -> bool:
    """
    Whether every (batch, seq, head) row of every (batch, seq, heads,
    head_dim) tensor starts on a 16-byte boundary and spans whole 16-byte
    chunks: each data pointer, each (batch, seq, head) stride in bytes and
    the row's bytes are multiples of 16, with the head dim contiguous. A
    float32 view is aligned when it starts a multiple of 4 elements into
    aligned memory, a bfloat16 or float16 view a multiple of 8, a float64
    view a multiple of 2.
    """
    for x in tensors:
        size = x.element_size()
        if x.stride(-1) != 1 or x.data_ptr() % _VEC_BYTES or (x.shape[-1] * size) % _VEC_BYTES:
            return False
        if any((stride * size) % _VEC_BYTES for stride in x.stride()[:3]):
            return False
    return True


def _mode(causal: bool, *tensors: torch.Tensor) -> int:
    """The kernels' ``mode``: causal, and 16-byte rows when ``tensors``
    (every tensor the kernel reads or writes row by row) allow them."""
    vec = MODE_VEC16 if tensors and rows_16b_aligned(*tensors) else 0
    return (MODE_CAUSAL if causal else 0) | vec


def _shape_args(q: torch.Tensor):
    return (*q.shape, _DTYPE_CODES[q.dtype])


def _stride_array(*tensors):
    values = [s for x in tensors for s in x.stride()[:3]]
    return (ctypes.c_longlong * len(values))(*values)


def forward_splits(q: torch.Tensor, causal: bool) -> int:
    """The key splits the forward kernel takes for q's shape on its card:
    1, or more when its row tiles alone leave the card's SMs idle (head_dim
    64 and up); each split walks a run of the key tiles and a second
    kernel merges their rows in a fixed order."""
    return _splits(KERNEL, q.device.index or 0, *_shape_args(q), _mode(causal))


def dq_splits(q: torch.Tensor, causal: bool) -> int:
    """The key splits the dq kernel takes for q's shape on its card, by the
    forward's rule; each split writes its partial dq rows and a second
    kernel sums them in split order."""
    return _splits(KERNEL_DQ, q.device.index or 0, *_shape_args(q), _mode(causal))


def dkv_splits(q: torch.Tensor, causal: bool) -> int:
    """The query splits the dk/dv kernel takes for q's shape on its card: 1
    up to head_dim 256, and above it by the same rule; each split writes
    its partial dk and dv rows and a second kernel sums them in split
    order."""
    return _splits(KERNEL_DKV, q.device.index or 0, *_shape_args(q), _mode(causal))


@functools.lru_cache(maxsize=256)
def _splits(kernel: str, device: int, *shape_and_mode: int) -> int:
    """The kernel's own answer (``gordo_<kernel>_splits``), asked once per
    (kernel, card, shape, dtype, mode): a training loop asks with one shape
    every step."""
    from gordo_tpu_torch.ops import _build

    fn = getattr(_build.load(SOURCES[kernel]), f"gordo_{kernel}_splits")
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 6
        fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        splits = fn(*shape_and_mode)
    if splits < 1:
        raise RuntimeError(
            f"{kernel}: the split query failed with CUDA error {-splits} for {shape_and_mode}"
        )
    return splits


def _launch(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool,
    sm_scale: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the forward kernel; raises on what it does not take."""
    _check_kernel_inputs(q)
    batch, seq, heads, head_dim = q.shape
    q, k, v = _head_dim_contiguous(q, k, v)
    out = torch.empty((batch, seq, heads, head_dim), dtype=q.dtype, device=q.device)
    lse = torch.empty((batch * heads, seq), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    splits = forward_splits(q, causal)
    # each split's unnormalised rows and (max, sum) pairs, merged by the kernel
    workspace = None
    if splits > 1:
        workspace = torch.empty(
            splits * batch * heads * seq * (head_dim + 2), dtype=torch.float32, device=q.device
        )
    fn = _kernel_function(KERNEL, 6)
    _call(KERNEL, fn, q, (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        None if workspace is None else workspace.data_ptr(),
        *_shape_args(q), _stride_array(q, k, v, out),
        float(sm_scale), _mode(causal, q, k, v, out),
    ))
    return out, lse


def _device_path(name: str, q: torch.Tensor) -> str:
    if q.device.type in ("cuda", "cpu"):
        return q.device.type
    raise ValueError(f"{name} has no path for device {q.device}")


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
    sm_scale = _default_scale(q, sm_scale)
    path, head_dim = _device_path("flash_attention", q), q.shape[-1]
    q, k, v = _to_width(kernel_width(q.shape[-1]), q, k, v)
    if path == "cuda":
        out, lse = _launch(q, k, v, causal, sm_scale)
    else:
        plain_calls[KERNEL] += 1
        out, lse = flash_attention_reference(q, k, v, causal, sm_scale)
    return _heads(out, head_dim), lse


def _check_like(q: torch.Tensor, **tensors) -> None:
    for name, x in tensors.items():
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(
                f"{name} is {tuple(x.shape)} {x.dtype} on {x.device}; expected "
                f"q's {tuple(q.shape)} {q.dtype} on {q.device}"
            )


def flash_attention_bwd_dq(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    d_out: torch.Tensor,
    causal: bool = False,
    sm_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """
    (dq, delta): the dq kernel for CUDA tensors, its plain version for
    CPU tensors. ``delta = rowsum(d_out * out)`` is (batch*heads, seq)
    float32, the input the dk/dv half takes.
    """
    _check_inputs(q, k, v)
    _check_like(q, out=out, d_out=d_out)
    sm_scale = _default_scale(q, sm_scale)
    path, head_dim = _device_path("flash_attention_bwd_dq", q), q.shape[-1]
    q, k, v, out, d_out = _to_width(kernel_width(q.shape[-1]), q, k, v, out, d_out)
    if path == "cpu":
        plain_calls[KERNEL_DQ] += 1
        dq, delta = flash_attention_bwd_dq_reference(q, k, v, out, lse, d_out, causal, sm_scale)
    else:
        dq, delta = _launch_dq(q, k, v, out, lse, d_out, causal, sm_scale)
    return _heads(dq, head_dim), delta


def _launch_dq(q, k, v, out, lse, d_out, causal: bool, sm_scale: float):
    """Run the dq kernel; raises on what it does not take."""
    _check_kernel_inputs(q)
    lse = _stat_rows(q, lse)
    q, k, v, out, d_out = _head_dim_contiguous(q, k, v, out, d_out)
    batch, seq, heads, head_dim = q.shape
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    delta = torch.empty((batch * heads, seq), dtype=torch.float32, device=q.device)
    if dq.numel() == 0:
        return dq, delta
    splits = dq_splits(q, causal)
    # each split's unscaled dq rows, summed by the merge kernel
    workspace = None
    if splits > 1:
        workspace = torch.empty(
            splits * batch * heads * seq * head_dim, dtype=torch.float32, device=q.device
        )
    fn = _kernel_function(KERNEL_DQ, 9)
    _call(KERNEL_DQ, fn, q, (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), d_out.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        None if workspace is None else workspace.data_ptr(),
        *_shape_args(q), _stride_array(q, k, v, out, d_out, dq),
        float(sm_scale), _mode(causal, q, k, v, out, d_out, dq),
    ))
    return dq, delta


def flash_attention_bwd_dkv(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lse: torch.Tensor,
    delta: torch.Tensor,
    d_out: torch.Tensor,
    causal: bool = False,
    sm_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv): the dk/dv kernel for CUDA tensors, its plain version for
    CPU tensors; ``delta`` is the dq half's."""
    _check_inputs(q, k, v)
    _check_like(q, d_out=d_out)
    sm_scale = _default_scale(q, sm_scale)
    path, head_dim = _device_path("flash_attention_bwd_dkv", q), q.shape[-1]
    q, k, v, d_out = _to_width(kernel_width(q.shape[-1]), q, k, v, d_out)
    if path == "cpu":
        plain_calls[KERNEL_DKV] += 1
        dk, dv = flash_attention_bwd_dkv_reference(q, k, v, lse, delta, d_out, causal, sm_scale)
    else:
        dk, dv = _launch_dkv(q, k, v, lse, delta, d_out, causal, sm_scale)
    return _heads(dk, head_dim), _heads(dv, head_dim)


def _launch_dkv(q, k, v, lse, delta, d_out, causal: bool, sm_scale: float):
    """Run the dk/dv kernel; raises on what it does not take."""
    _check_kernel_inputs(q)
    lse, delta = _stat_rows(q, lse), _stat_rows(q, delta)
    q, k, v, d_out = _head_dim_contiguous(q, k, v, d_out)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    if dk.numel() == 0:
        return dk, dv
    splits = dkv_splits(q, causal)
    # each split's unscaled dk and dv rows, summed by the merge kernel
    workspace = None
    if splits > 1:
        workspace = torch.empty(splits * 2 * q.numel(), dtype=torch.float32, device=q.device)
    fn = _kernel_function(KERNEL_DKV, 9)
    _call(KERNEL_DKV, fn, q, (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), d_out.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        None if workspace is None else workspace.data_ptr(),
        *_shape_args(q), _stride_array(q, k, v, d_out, dk, dv),
        float(sm_scale), _mode(causal, q, k, v, d_out, dk, dv),
    ))
    return dk, dv


def flash_attention_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    d_out: torch.Tensor,
    causal: bool = False,
    sm_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """
    (dq, dk, dv) from the forward's residuals and ``d_out``: the dq and
    dk/dv kernels for CUDA tensors (two launches), their plain versions
    for CPU tensors.
    """
    dq, delta = flash_attention_bwd_dq(q, k, v, out, lse, d_out, causal, sm_scale)
    dk, dv = flash_attention_bwd_dkv(q, k, v, lse, delta, d_out, causal, sm_scale)
    return dq, dk, dv


def _batch_first(x: torch.Tensor, dim: Optional[int], size: int) -> torch.Tensor:
    """A vmapped argument with its vmapped axis first (broadcast to
    ``size`` when it has none)."""
    if dim is None:
        return x.expand(size, *x.shape)
    return x.movedim(dim, 0)


def _machine_slices(n: int, rows_per_machine: int):
    """Slices of the vmapped axis whose folded launches keep batch * heads *
    seq, and with it every kernel's 1-D grid, within int32."""
    step = max(1, _INT32_MAX // max(1, rows_per_machine))
    return [slice(start, min(start + step, n)) for start in range(0, n, step)]


def _fold(x: torch.Tensor) -> torch.Tensor:
    """(M, B, ...) -> (M * B, ...)."""
    return x.reshape(x.shape[0] * x.shape[1], *x.shape[2:])


class FlashAttentionFunction(torch.autograd.Function):
    """Flash attention with its backward in the two backward kernels
    (their plain version on CPU tensors): the port of the JAX custom VJP.
    Returns (out, lse); lse is not differentiable.

    It works under ``torch.func`` transforms: the forward takes no ctx
    (``setup_context`` saves q, k, v, out and lse), the backward is
    :class:`FlashAttentionBackward`, itself vmappable, and under ``vmap``
    both fold the vmapped axis into the batch axis, (M, B, S, H, D) ->
    (M·B, S, H, D), launch the same kernels on the folded tensors and
    unfold what they return, so a kernel never sees a batched tensor. A
    fleet of M machines thus launches each kernel once for all of them."""

    @staticmethod
    def forward(q, k, v, causal: bool, sm_scale: float):
        return flash_attention_forward(q, k, v, causal, sm_scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, sm_scale = inputs
        out, lse = output
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        ctx.sm_scale = sm_scale

    @staticmethod
    def backward(ctx, d_out, _d_lse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = FlashAttentionBackward.apply(
            q, k, v, out, lse, d_out, ctx.causal, ctx.sm_scale
        )
        return dq, dk, dv, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal, sm_scale):
        n = info.batch_size
        q, k, v = (_batch_first(x, d, n) for x, d in zip((q, k, v), in_dims))
        batch, seq, heads = q.shape[1], q.shape[2], q.shape[3]
        outs, lses = [], []
        for part in _machine_slices(n, batch * heads * seq):
            out, lse = FlashAttentionFunction.apply(
                _fold(q[part]), _fold(k[part]), _fold(v[part]), causal, sm_scale
            )
            outs.append(out.reshape(-1, batch, *out.shape[1:]))
            lses.append(lse.reshape(-1, batch * heads, seq))
        return (torch.cat(outs), torch.cat(lses)), (0, 0)


class FlashAttentionBackward(torch.autograd.Function):
    """(dq, dk, dv) of flash attention from the forward's residuals and dO:
    the dq kernel, which also writes delta, then the dk/dv kernel (their
    plain versions on CPU tensors). q, k, v, out and dO are padded to the
    kernel width once. Vmappable by the forward's folding rule; not
    differentiable itself (no double backward)."""

    @staticmethod
    def forward(q, k, v, out, lse, d_out, causal: bool, sm_scale: float):
        head_dim = q.shape[-1]
        q, k, v, out, d_out = _to_width(kernel_width(head_dim), q, k, v, out, d_out)
        dq, dk, dv = flash_attention_backward(q, k, v, out, lse, d_out, causal, sm_scale)
        return tuple(_heads(g, head_dim) for g in (dq, dk, dv))

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError(
            "flash attention's gradients are once_differentiable: the backward kernels "
            "have no backward of their own"
        )

    @staticmethod
    def vmap(info, in_dims, q, k, v, out, lse, d_out, causal, sm_scale):
        n = info.batch_size
        q, k, v, out, lse, d_out = (
            _batch_first(x, d, n) for x, d in zip((q, k, v, out, lse, d_out), in_dims)
        )
        batch, seq, heads = q.shape[1], q.shape[2], q.shape[3]
        grads = []
        for part in _machine_slices(n, batch * heads * seq):
            folded = FlashAttentionBackward.apply(
                _fold(q[part]), _fold(k[part]), _fold(v[part]), _fold(out[part]),
                _fold(lse[part]), _fold(d_out[part]), causal, sm_scale,
            )
            grads.append([g.reshape(-1, batch, *g.shape[1:]) for g in folded])
        return tuple(torch.cat(parts) for parts in zip(*grads)), (0, 0, 0)


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
    counterpart of ``gordo_tpu.ops.flash_attention.flash_attention``;
    differentiable on both devices.
    """
    _check_inputs(q, k, v)
    out, _ = FlashAttentionFunction.apply(q, k, v, causal, _default_scale(q, sm_scale))
    return out
