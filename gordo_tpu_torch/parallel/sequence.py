"""
Sequence parallelism (the port of ``gordo_tpu.parallel.sequence``):
attention over windows too long for one device, their timesteps split
over a mesh axis of ``torch.distributed`` ranks.

- **Ring attention** (:func:`ring_attention`): each rank keeps its query
  shard; the key and value shards rotate rank -> rank+1
  (``batch_isend_irecv``) while an online softmax in float32 accumulates
  the output, the causal mask built from global positions (the rank's
  offset). The rotation is an autograd function whose backward sends the
  gradients rank -> rank-1: the inverse permutation, as JAX transposes
  ``ppermute``. At one rank the rotation is the identity and nothing is
  sent (neither nccl nor gloo sends a rank to itself).
- **Ulysses** (:func:`ulysses_attention`): ``all_to_all_single`` moves
  from sequence shards to head groups (each rank gets every timestep of
  ``heads / N`` heads), runs ``attn_fn`` (the port's ``dense_attention``
  by default) and moves back; the exchange's backward is the same
  exchange of the gradients. Needs ``heads % N == 0``.

Both compute with plain tensor ops, as the JAX functions compute with
``einsum`` outside any Pallas kernel; both are exact.

Where JAX runs these inside ``shard_map`` over a named axis, the port
runs them inside :func:`mesh_context` (``with mesh_context(mesh):``),
which binds axis names to the mesh's process groups for the process (not
a thread: on the card, autograd runs a block's recompute, and so its
attention, on its own device thread); a ``mesh=`` argument binds them
for one call.
:func:`sequence_sharded_attention` is the full-array entry point: every
rank passes the whole (batch, seq, heads, head_dim) tensors, computes its
shard and returns the whole output; its gradients are the whole
gradients on every rank.
"""

import contextlib
import math
from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist

from gordo_tpu_torch.parallel.mesh import axis_index, axis_size

SEQ_AXIS = "seq"

_NEG_INF = -1e30

#: the mesh bound by the innermost mesh_context
_BOUND = [None]


@contextlib.contextmanager
def mesh_context(mesh):
    """Bind the axis names of ``mesh`` (JAX's ``shard_map`` scope): the
    sequence-parallel functions and a ``TransformerNet`` with ``seq_axis``
    find their process group here."""
    previous, _BOUND[0] = _BOUND[0], mesh
    try:
        yield mesh
    finally:
        _BOUND[0] = previous


def bound_axis(axis_name: str, mesh=None) -> Tuple[object, int, int]:
    """(process group, this rank's index, size) of ``axis_name`` on
    ``mesh``, else on the mesh of the enclosing :func:`mesh_context`."""
    mesh = mesh if mesh is not None else _BOUND[0]
    if mesh is None or axis_name not in (mesh.mesh_dim_names or ()):
        raise ValueError(
            f"Mesh axis {axis_name!r} is not bound: run inside "
            "gordo_tpu_torch.parallel.sequence.mesh_context(mesh) with a mesh that names it"
        )
    return mesh.get_group(axis_name), axis_index(mesh, axis_name), axis_size(mesh, axis_name)


def _peer(group, index: int) -> int:
    """The global rank of ``group``'s rank ``index``."""
    return dist.get_global_rank(group, index)


class _RingShift(torch.autograd.Function):
    """(k, v) of rank i -> rank i+1 of the group; backward: the gradients
    i -> i-1."""

    @staticmethod
    def forward(ctx, k, v, group, index, size):
        ctx.group, ctx.index, ctx.size = group, index, size
        return _shift(k, v, group, index, size, +1)

    @staticmethod
    def backward(ctx, dk, dv):
        dk, dv = _shift(dk, dv, ctx.group, ctx.index, ctx.size, -1)
        return dk, dv, None, None, None


def _shift(k, v, group, index: int, size: int, step: int):
    """Send (k, v) to the rank ``step`` after this one; receive the
    rank ``step`` before's."""
    k, v = k.contiguous(), v.contiguous()
    k_in, v_in = torch.empty_like(k), torch.empty_like(v)
    to, frm = _peer(group, (index + step) % size), _peer(group, (index - step) % size)
    ops = [dist.P2POp(dist.isend, k, to, group, tag=0),
           dist.P2POp(dist.isend, v, to, group, tag=1),
           dist.P2POp(dist.irecv, k_in, frm, group, tag=0),
           dist.P2POp(dist.irecv, v_in, frm, group, tag=1)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return k_in, v_in


def ring_shift(k: torch.Tensor, v: torch.Tensor, group, index: int, size: int):
    """One rotation of the key and value shards around the group's ring;
    the identity at one rank."""
    if size == 1:
        return k, v
    return _RingShift.apply(k, v, group, index, size)


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` over the leading axis (one slice a rank); the
    exchange is its own transpose, so the backward exchanges the
    gradients the same way."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_to_all(grad, ctx.group), None


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _AllReduceSum(torch.autograd.Function):
    """``psum``: the sum over the group, replicated; the backward sums the
    gradients the same way (module docstring of ``long_context.py``)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = grad.contiguous().clone()
        dist.all_reduce(out, group=ctx.group)
        return out, None


def psum(x: torch.Tensor, axis_name: str = SEQ_AXIS, mesh=None) -> torch.Tensor:
    """The sum of ``x`` over ``axis_name``, on every rank of it."""
    group, _, size = bound_axis(axis_name, mesh)
    return _AllReduceSum.apply(x, group)


def _gather(x: torch.Tensor, group, size: int, dim: int) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


class _ShardSeq(torch.autograd.Function):
    """A replicated full sequence -> this rank's shard; the backward
    gathers the shards' gradients into the full (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, group, index, size):
        ctx.group, ctx.size = group, size
        local = x.shape[1] // size
        return x[:, index * local:(index + 1) * local].contiguous()

    @staticmethod
    def backward(ctx, grad):
        return _gather(grad, ctx.group, ctx.size, 1), None, None, None


class _GatherSeq(torch.autograd.Function):
    """Every rank's shard -> the full sequence on every rank; the backward
    keeps this rank's slice of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, group, index, size):
        ctx.index, ctx.local = index, x.shape[1]
        return _gather(x, group, size, 1)

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.index * ctx.local
        return grad[:, lo:lo + ctx.local].contiguous(), None, None, None


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    axis_name: str = SEQ_AXIS,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    mesh=None,
) -> torch.Tensor:
    """
    Exact attention with the key and value shards rotating around the
    ring of ``axis_name``: q, k, v are this rank's shards, (batch,
    seq_local, heads, head_dim); returns this rank's shard of the output.
    """
    group, my_idx, n = bound_axis(axis_name, mesh)
    batch, seq_loc, heads, head_dim = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(head_dim)
    q32 = q.to(torch.float32)
    local = torch.arange(seq_loc, device=q.device)
    q_pos = my_idx * seq_loc + local  # the global positions of the query rows

    # the online softmax's accumulators
    out_acc = torch.zeros((batch, seq_loc, heads, head_dim), dtype=torch.float32, device=q.device)
    row_max = torch.full((batch, heads, seq_loc), _NEG_INF, dtype=torch.float32, device=q.device)
    row_sum = torch.zeros((batch, heads, seq_loc), dtype=torch.float32, device=q.device)

    # rank j sends its block to j+1, so after i rotations the block here
    # came from rank (my_idx - i) mod n
    k_blk, v_blk = k, v
    for i in range(n):
        src = (my_idx - i) % n
        k_pos = src * seq_loc + local
        scores = torch.einsum("bqhd,bkhd->bhqk", q32, k_blk.to(torch.float32)) * sm_scale
        mask = None
        if causal:
            mask = (k_pos[None, :] <= q_pos[:, None])[None, None]
            scores = torch.where(mask, scores, torch.full_like(scores, _NEG_INF))
        new_max = torch.maximum(row_max, scores.amax(dim=-1))
        correction = torch.exp(row_max - new_max)
        probs = torch.exp(scores - new_max[..., None])
        if mask is not None:
            # a fully masked row has exp(-1e30 - (-1e30)) == 1
            probs = torch.where(mask, probs, torch.zeros_like(probs))
        row_sum = row_sum * correction + probs.sum(dim=-1)
        blk_out = torch.einsum("bhqk,bkhd->bqhd", probs, v_blk.to(torch.float32))
        out_acc = out_acc * correction.transpose(1, 2)[..., None] + blk_out
        row_max = new_max
        if i < n - 1:
            k_blk, v_blk = ring_shift(k_blk, v_blk, group, my_idx, n)

    denom = torch.clamp(row_sum, min=1e-30).transpose(1, 2)[..., None]
    return (out_acc / denom).to(q.dtype)


def _scatter_heads(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """(batch, seq/N, heads, d) -> (batch, seq, heads/N, d): head group j
    to rank j, the sequence shards concatenated in rank order."""
    b, s, h, d = x.shape
    parts = x.reshape(b, s, n, h // n, d).permute(2, 0, 1, 3, 4)
    out = _AllToAll.apply(parts, group)
    return out.permute(1, 0, 2, 3, 4).reshape(b, n * s, h // n, d)


def _gather_heads(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """The inverse of :func:`_scatter_heads`."""
    b, seq, hn, d = x.shape
    s = seq // n
    parts = x.reshape(b, n, s, hn, d).permute(1, 0, 2, 3, 4)
    out = _AllToAll.apply(parts, group)
    return out.permute(1, 2, 0, 3, 4).reshape(b, s, n * hn, d)


def ulysses_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    axis_name: str = SEQ_AXIS,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    attn_fn: Optional[Callable] = None,
    mesh=None,
) -> torch.Tensor:
    """
    All-to-all (DeepSpeed-Ulysses) sequence parallelism: (batch, seq/N,
    heads, d) shards -> (batch, seq, heads/N, d), exact attention per head
    group with ``attn_fn(q, k, v, causal=..., sm_scale=...)`` (the port's
    ``dense_attention`` by default), then back.
    """
    if attn_fn is None:
        from gordo_tpu_torch.models.specs_seq import dense_attention

        attn_fn = dense_attention
    group, _, n = bound_axis(axis_name, mesh)
    heads = q.shape[2]
    if heads % n:
        raise ValueError(
            f"ulysses_attention needs n_heads ({heads}) divisible by the sequence-axis size ({n})"
        )
    q_h, k_h, v_h = (_scatter_heads(t, group, n) for t in (q, k, v))
    out_h = attn_fn(q_h, k_h, v_h, causal=causal, sm_scale=sm_scale)
    return _gather_heads(out_h, group, n)


SEQUENCE_IMPLS = {"ring": ring_attention, "ulysses": ulysses_attention}


def shard_sequence(x: torch.Tensor, axis_name: str = SEQ_AXIS, mesh=None) -> torch.Tensor:
    """This rank's shard of a replicated (batch, seq, ...) tensor's
    sequence; its gradient is gathered back to the full one."""
    group, index, size = bound_axis(axis_name, mesh)
    return _ShardSeq.apply(x, group, index, size)


def gather_sequence(x: torch.Tensor, axis_name: str = SEQ_AXIS, mesh=None) -> torch.Tensor:
    """Every rank's (batch, seq/N, ...) shard as the full sequence."""
    group, index, size = bound_axis(axis_name, mesh)
    return _GatherSeq.apply(x, group, index, size)


def sequence_sharded_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh,
    impl: str = "ring",
    axis_name: str = SEQ_AXIS,
    causal: bool = False,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """
    The full-array entry point: every rank passes the whole (batch, seq,
    heads, head_dim) q, k, v, runs the chosen sequence-parallel attention
    on its shard of ``mesh[axis_name]`` and gets the whole output. seq
    must divide evenly by the axis size.
    """
    try:
        attn = SEQUENCE_IMPLS[impl]
    except KeyError:
        raise ValueError(
            f"Unknown sequence-parallel impl {impl!r}; available: {sorted(SEQUENCE_IMPLS)}"
        ) from None
    size = axis_size(mesh, axis_name)
    if q.shape[1] % size:
        raise ValueError(
            f"Sequence length {q.shape[1]} not divisible by mesh axis {axis_name!r} size {size}"
        )
    with mesh_context(mesh):
        shards = [shard_sequence(t, axis_name) for t in (q, k, v)]
        out = attn(*shards, axis_name=axis_name, causal=causal, sm_scale=sm_scale)
        return gather_sequence(out, axis_name)
