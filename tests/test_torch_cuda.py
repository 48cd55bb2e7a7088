"""
Card-only tests of the port's CUDA kernels: each kernel against its plain
PyTorch version on the same CUDA tensors. They skip without a card.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch: there, run it without the JAX-side
conftest, ``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.

Tolerances: 1e-4 in float32 (same softmax in float32, other summation
order); 2e-2 in bf16 (one bf16 rounding of outputs of magnitude up to 2);
5e-3 in float16 (one float16 rounding of outputs up to 8, both sides
summing in float32); 1e-5 in float64 (the kernels sum in float32, as the
Pallas kernels do, the plain version in float64).
"""

import pytest
import torch

from gordo_tpu_torch.ops import flash_attention as fa

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape,causal,dtype,tol",
    [
        ((64, 64, 4, 16), True, torch.float32, 1e-4),
        ((3, 301, 2, 64), False, torch.float32, 1e-4),
        ((3, 301, 2, 128), True, torch.float32, 1e-4),
        ((8, 100, 2, 32), True, torch.bfloat16, 2e-2),
        ((8192, 64, 4, 16), True, torch.float32, 1e-4),  # the served shape
    ],
)
def test_cuda_kernel_matches_plain_version(shape, causal, dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(3))
    before = fa.launch_counts[fa.KERNEL]
    out, lse = fa.flash_attention_forward(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.launch_counts[fa.KERNEL] == before + 1
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v, causal=causal)
    assert (out.float() - ref_out.float()).abs().max().item() <= tol
    assert (lse - ref_lse).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape,causal,dtype,tol",
    [
        ((32, 64, 4, 16), True, torch.float32, 1e-4),
        ((3, 301, 2, 64), False, torch.float32, 1e-4),
        ((3, 301, 2, 128), True, torch.float32, 1e-4),
        ((8, 100, 2, 32), True, torch.bfloat16, 2e-2),
        ((8192, 64, 4, 16), True, torch.float32, 1e-4),  # the served scale
    ],
)
def test_cuda_backward_kernels_match_plain_version(shape, causal, dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v, d_out = (
        torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(4)
    )
    out, lse = fa.flash_attention_forward(q, k, v, causal=causal)
    before = dict(fa.launch_counts)
    got = fa.flash_attention_backward(q, k, v, out, lse, d_out, causal=causal)
    torch.cuda.synchronize()
    assert fa.launch_counts[fa.KERNEL_DQ] == before[fa.KERNEL_DQ] + 1
    assert fa.launch_counts[fa.KERNEL_DKV] == before[fa.KERNEL_DKV] + 1
    want = fa.flash_attention_backward_reference(q, k, v, out, lse, d_out, causal=causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == shape, name
        assert (g.float() - w.float()).abs().max().item() <= tol, name


def _misaligned(shape, dtype, gen):
    """A (B, S, H, D) view one element into its memory: no row start is
    16-byte aligned, so the kernels take their element-by-element path."""
    n = shape[0] * shape[1] * shape[2] * shape[3]
    return torch.randn(n + 1, generator=gen, device="cuda").to(dtype)[1:].view(shape)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape,causal,dtype,tol",
    [
        ((32, 64, 4, 16), True, torch.float32, 1e-4),
        ((3, 130, 2, 32), False, torch.float32, 1e-4),
        ((8, 100, 2, 16), True, torch.bfloat16, 2e-2),
    ],
)
def test_cuda_misaligned_views_match_plain_version(shape, causal, dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(4)
    q, k, v, d_out = (_misaligned(shape, dtype, gen) for _ in range(4))
    assert not fa.rows_16b_aligned(q)
    out, lse = fa.flash_attention_forward(q, k, v, causal=causal)
    got = fa.flash_attention_backward(q, k, v, out, lse, d_out, causal=causal)
    torch.cuda.synchronize()
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v, causal=causal)
    assert (out.float() - ref_out.float()).abs().max().item() <= tol
    assert (lse - ref_lse).abs().max().item() <= tol
    want = fa.flash_attention_backward_reference(q, k, v, out, lse, d_out, causal=causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert (g.float() - w.float()).abs().max().item() <= tol, name


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape,dtype", [((32, 64, 4, 16), torch.float32), ((8192, 64, 4, 16), torch.float32),
                    ((8, 100, 2, 32), torch.bfloat16)]
)
def test_cuda_kernels_are_deterministic(shape, dtype):
    """Two launches on the same inputs give bitwise-equal outputs: each
    output element has one owner, reduced in a fixed order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v, d_out = (
        torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(4)
    )
    out, lse = fa.flash_attention_forward(q, k, v, causal=True)
    out2, lse2 = fa.flash_attention_forward(q, k, v, causal=True)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    dq, delta = fa.flash_attention_bwd_dq(q, k, v, out, lse, d_out, causal=True)
    dq2, delta2 = fa.flash_attention_bwd_dq(q, k, v, out, lse, d_out, causal=True)
    assert torch.equal(dq, dq2) and torch.equal(delta, delta2)
    first = fa.flash_attention_bwd_dkv(q, k, v, lse, delta, d_out, causal=True)
    second = fa.flash_attention_bwd_dkv(q, k, v, lse, delta, d_out, causal=True)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_cuda_flash_gradients_equal_dense(causal):
    """The autograd Function on the card: a loss through the flash kernels
    has dense attention's gradient, through strided views of one input."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from gordo_tpu_torch.models.specs_seq import dense_attention

    gen = torch.Generator(device="cuda").manual_seed(2)
    wide = torch.randn((16, 64, 4, 48), generator=gen, device="cuda").requires_grad_(True)
    q, k, v = wide[..., :16], wide[..., 16:32], wide[..., 32:]
    before = fa.launch_counts[fa.KERNEL_DQ]
    fa.flash_attention(q, k, v, causal=causal).square().sum().backward()
    assert fa.launch_counts[fa.KERNEL_DQ] == before + 1
    flash_grad = wide.grad.clone()
    wide.grad = None
    dense_attention(q, k, v, causal=causal).square().sum().backward()
    assert (flash_grad - wide.grad).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_cuda_function_refuses_double_backward():
    """The kernels' gradients are not differentiable: a second-order
    request raises on the card as on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = (
        torch.randn((2, 64, 4, 16), generator=gen, device="cuda").requires_grad_(True)
        for _ in range(3)
    )
    loss = fa.flash_attention(q, k, v, causal=True).square().sum()
    (dq,) = torch.autograd.grad(loss, q, create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        dq.sum().backward()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 1000, 2, 64), (2, 300, 2, 128)])
@pytest.mark.parametrize("causal", [False, True])
def test_cuda_wide_kernels_are_deterministic(shape, causal):
    """The head_dim 64 and 128 forward and dk/dv kernels: two launches give
    bitwise-equal outputs (one owner per output element, the quad merged in
    a fixed order, no atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(6)
    q, k, v, d_out = (torch.randn(shape, generator=gen, device="cuda") for _ in range(4))
    out, lse = fa.flash_attention_forward(q, k, v, causal=causal)
    out2, lse2 = fa.flash_attention_forward(q, k, v, causal=causal)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    _, delta = fa.flash_attention_bwd_dq(q, k, v, out, lse, d_out, causal=causal)
    first = fa.flash_attention_bwd_dkv(q, k, v, lse, delta, d_out, causal=causal)
    second = fa.flash_attention_bwd_dkv(q, k, v, lse, delta, d_out, causal=causal)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim,width", [(8, 16), (12, 16), (24, 32), (48, 64), (96, 128),
                                            (200, 256)])
def test_cuda_wrappers_pad_head_dim(head_dim, width, monkeypatch):
    """A head_dim off the kernel widths launches each kernel once at the
    next width, on zero-padded tensors, and comes back at its own width
    equal to the plain version; so does the Function's gradient."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    widths = []
    for name in ("_launch", "_launch_dq", "_launch_dkv"):
        launch = getattr(fa, name)

        def spy(q, *args, _launch=launch):
            widths.append(q.shape[-1])
            return _launch(q, *args)

        monkeypatch.setattr(fa, name, spy)
    shape = (4, 77, 2, head_dim)
    gen = torch.Generator(device="cuda").manual_seed(7)
    q, k, v, d_out = (torch.randn(shape, generator=gen, device="cuda") for _ in range(4))
    before = dict(fa.launch_counts)
    out, lse = fa.flash_attention_forward(q, k, v, causal=True)
    got = fa.flash_attention_backward(q, k, v, out, lse, d_out, causal=True)
    torch.cuda.synchronize()
    assert widths == [width] * 3
    assert all(fa.launch_counts[n] == before[n] + 1 for n in before)
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v, causal=True)
    assert out.shape == shape and (out - ref_out).abs().max().item() <= 1e-4
    assert (lse - ref_lse).abs().max().item() <= 1e-4
    want = fa.flash_attention_backward_reference(q, k, v, out, lse, d_out, causal=True)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == shape and (g - w).abs().max().item() <= 1e-4, name
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    (fa.flash_attention(*leaves, causal=True) * d_out).sum().backward()
    for name, leaf, w in zip(("dq", "dk", "dv"), leaves, want):
        assert (leaf.grad - w).abs().max().item() <= 1e-4, name


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim", [1100, 2048])
def test_cuda_raises_above_head_dim_128(head_dim):
    """No head_dim limit is left on the card: 1100 (run at 1152) and 2048
    run through all three entry points and the Function (the sliced
    forward, the tiled dq and dk/dv), each launching its kernel once and
    agreeing with the plain version; nothing falls back to it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    shape = (1, 70, 2, head_dim)
    gen = torch.Generator(device="cuda").manual_seed(13)
    q, k, v, d_out = (torch.randn(shape, generator=gen, device="cuda") for _ in range(4))
    before = dict(fa.launch_counts)
    out, lse = fa.flash_attention_forward(q, k, v, causal=True)
    dq, delta = fa.flash_attention_bwd_dq(q, k, v, out, lse, d_out, causal=True)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, lse, delta, d_out, causal=True)
    torch.cuda.synchronize()
    assert all(fa.launch_counts[n] == before[n] + 1 for n in before)
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v, causal=True)
    assert (out - ref_out).abs().max().item() <= 1e-4
    assert (lse - ref_lse).abs().max().item() <= 1e-4
    want = fa.flash_attention_backward_reference(q, k, v, out, lse, d_out, causal=True)
    for name, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert g.shape == shape and (g - w).abs().max().item() <= 1e-4, name
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    (fa.flash_attention(*leaves, causal=True) * d_out).sum().backward()
    for name, leaf, w in zip(("dq", "dk", "dv"), leaves, want):
        assert (leaf.grad - w).abs().max().item() <= 1e-4, name


def _launched(before):
    return sorted(name for name, n in fa.kernel_launches.items() if n != before[name])


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape,causal,dtype,tol",
    [
        ((4, 1000, 2, 64), True, torch.bfloat16, 2e-2),
        ((4, 1000, 2, 64), False, torch.float16, 5e-3),
        ((2, 300, 2, 128), False, torch.bfloat16, 2e-2),
        ((3, 301, 2, 128), True, torch.float16, 5e-3),
        ((16, 200, 2, 48), True, torch.bfloat16, 2e-2),  # padded to 64
        ((3, 150, 2, 96), False, torch.float16, 5e-3),  # padded to 128
        ((1, 500, 1, 64), False, torch.bfloat16, 2e-2),  # the forward splits its keys
    ],
)
def test_cuda_tensor_core_kernels_match_plain_version(shape, causal, dtype, tol):
    """bfloat16 and float16 at kernel widths 64 and 128 run the tensor-core
    forward, dq and dk/dv kernels: each within the type's tolerance of the
    plain version, two dk/dv launches bitwise equal (each key row has one
    owner, no atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(11)
    q, k, v, d_out = (
        torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(4)
    )
    before = dict(fa.kernel_launches)
    out, lse = fa.flash_attention_forward(q, k, v, causal=causal)
    dq, dk, dv = fa.flash_attention_backward(q, k, v, out, lse, d_out, causal=causal)
    torch.cuda.synchronize()
    assert _launched(before) == [f"{fa.KERNEL_DKV}_mma", f"{fa.KERNEL_DQ}_mma",
                                 f"{fa.KERNEL}_mma"]
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v, causal=causal)
    assert (out.float() - ref_out.float()).abs().max().item() <= tol
    assert (lse - ref_lse).abs().max().item() <= tol
    want = fa.flash_attention_backward_reference(q, k, v, out, lse, d_out, causal=causal)
    for name, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert g.dtype == dtype and g.shape == shape, name
        assert (g.float() - w.float()).abs().max().item() <= tol, name
    _, delta = fa.flash_attention_bwd_dq(q, k, v, out, lse, d_out, causal=causal)
    first = fa.flash_attention_bwd_dkv(q, k, v, lse, delta, d_out, causal=causal)
    second = fa.flash_attention_bwd_dkv(q, k, v, lse, delta, d_out, causal=causal)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("head_dim", [64, 128])
def test_cuda_float32_and_float64_keep_the_wide_kernels(dtype, head_dim):
    """float32 and float64 stay on the CUDA cores at 64 and 128: TF32
    would break their 1e-4 and 1e-5 tolerances."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    q, k, v, d_out = (torch.randn((2, 100, 2, head_dim), device="cuda").to(dtype)
                      for _ in range(4))
    before = dict(fa.kernel_launches)
    out, lse = fa.flash_attention_forward(q, k, v, causal=True)
    fa.flash_attention_backward(q, k, v, out, lse, d_out, causal=True)
    torch.cuda.synchronize()
    assert _launched(before) == [f"{entry}_wide"
                                 for entry in (fa.KERNEL_DKV, fa.KERNEL_DQ, fa.KERNEL)]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape,causal,dtype,tol",
    [
        ((2, 300, 2, 300), True, torch.float32, 1e-4),
        ((2, 300, 2, 300), True, torch.bfloat16, 2e-2),
        ((2, 130, 2, 300), False, torch.float16, 5e-3),
        ((1, 130, 2, 300), True, torch.float64, 1e-5),
        ((1, 256, 2, 640), False, torch.float32, 1e-4),
        ((1, 256, 2, 640), False, torch.bfloat16, 2e-2),
        ((1, 100, 1, 1024), True, torch.float32, 1e-4),
        ((1, 128, 2, 1100), True, torch.float32, 1e-4),
        ((1, 96, 1, 1100), False, torch.bfloat16, 2e-2),
        ((1, 64, 1, 2048), False, torch.float32, 1e-4),
        ((1, 64, 1, 2048), True, torch.float16, 5e-3),
        ((2, 2048, 4, 512), True, torch.bfloat16, 2e-2),  # a launch that fills the card
    ],
)
def test_cuda_tiled_kernels_match_plain_version(shape, causal, dtype, tol):
    """Above 256 the tiled dq and dk/dv kernels (on the tensor cores in
    bfloat16/float16, with key and query splits on small grids) and the
    sliced forward run at the JAX padding (300 at 384, 1100 at 1152, 512,
    640, 1024 and 2048 as they are): each within its tolerance of the plain
    version, two launches of each bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(12)
    q, k, v, d_out = (
        torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(4)
    )
    before = dict(fa.kernel_launches)
    out, lse = fa.flash_attention_forward(q, k, v, causal=causal)
    got = fa.flash_attention_backward(q, k, v, out, lse, d_out, causal=causal)
    torch.cuda.synchronize()
    tiled = "tiled_mma" if dtype in (torch.bfloat16, torch.float16) else "tiled"
    assert _launched(before) == [f"{fa.KERNEL_DKV}_{tiled}", f"{fa.KERNEL_DQ}_{tiled}",
                                 f"{fa.KERNEL}_sliced"]
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v, causal=causal)
    assert (out.double() - ref_out.double()).abs().max().item() <= tol
    assert (lse.double() - ref_lse.double()).abs().max().item() <= tol
    want = fa.flash_attention_backward_reference(q, k, v, out, lse, d_out, causal=causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == shape, name
        assert (g.double() - w.double()).abs().max().item() <= tol, name
    again = fa.flash_attention_backward(q, k, v, out, lse, d_out, causal=causal)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape,causal,dtype,tol",
    [
        ((2, 300, 2, 128), False, torch.float32, 1e-4),
        ((2, 300, 2, 128), True, torch.float32, 1e-4),
        ((1, 500, 1, 64), True, torch.float32, 1e-4),
        ((1, 500, 1, 64), False, torch.bfloat16, 2e-2),
    ],
)
def test_cuda_forward_key_splits_match_plain_version(shape, causal, dtype, tol):
    """A grid under one wave of the card splits the key axis across blocks;
    the merge kernel sums the splits in a fixed order: the result equals
    the plain version and two launches are bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(8)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(3))
    assert fa.forward_splits(q, causal) > 1
    out, lse = fa.flash_attention_forward(q, k, v, causal=causal)
    out2, lse2 = fa.flash_attention_forward(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v, causal=causal)
    assert (out.float() - ref_out.float()).abs().max().item() <= tol
    assert (lse - ref_lse).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape,causal,dtype,tol,split",
    [
        ((1, 500, 1, 64), True, torch.float32, 1e-4, True),
        ((8, 1024, 4, 64), False, torch.float32, 1e-4, False),
        ((1, 300, 1, 128), False, torch.float32, 1e-4, True),
        ((16, 512, 8, 128), True, torch.float32, 1e-4, False),
        ((1, 200, 1, 256), True, torch.float32, 1e-4, True),
        ((4, 512, 8, 256), False, torch.float32, 1e-4, False),
        ((1, 500, 1, 64), False, torch.bfloat16, 2e-2, True),
        ((3, 301, 2, 128), True, torch.float16, 5e-3, True),
        ((1, 130, 2, 256), False, torch.float64, 1e-5, True),
    ],
)
def test_cuda_wide_dq_matches_plain_version(shape, causal, dtype, tol, split):
    """The head_dim 64/128/256 dq kernel, with and without its key split,
    against the plain version; two launches are bitwise equal (the merge
    sums the splits in a fixed order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(9)
    q, k, v, d_out = (
        torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(4)
    )
    assert (fa.dq_splits(q, causal) > 1) == split
    out, lse = fa.flash_attention_reference(q, k, v, causal=causal)
    before = fa.launch_counts[fa.KERNEL_DQ]
    dq, delta = fa.flash_attention_bwd_dq(q, k, v, out, lse, d_out, causal=causal)
    dq2, delta2 = fa.flash_attention_bwd_dq(q, k, v, out, lse, d_out, causal=causal)
    torch.cuda.synchronize()
    assert fa.launch_counts[fa.KERNEL_DQ] == before + 2
    assert torch.equal(dq, dq2) and torch.equal(delta, delta2)
    ref_dq, ref_delta = fa.flash_attention_bwd_dq_reference(
        q, k, v, out, lse, d_out, causal, shape[-1] ** -0.5
    )
    assert dq.dtype == dtype and dq.shape == shape
    assert (dq.double() - ref_dq.double()).abs().max().item() <= tol
    assert (delta.double() - ref_delta.double()).abs().max().item() <= tol


# the seven cases of test_cuda_tensor_core_kernels_match_plain_version,
# then two whose dq splits its keys and two whose dq does not
MMA_DQ_CASES = [
    ((4, 1000, 2, 64), True, torch.bfloat16, 2e-2, None),
    ((4, 1000, 2, 64), False, torch.float16, 5e-3, None),
    ((2, 300, 2, 128), False, torch.bfloat16, 2e-2, None),
    ((3, 301, 2, 128), True, torch.float16, 5e-3, None),
    ((16, 200, 2, 48), True, torch.bfloat16, 2e-2, None),
    ((3, 150, 2, 96), False, torch.float16, 5e-3, None),
    ((1, 500, 1, 64), False, torch.bfloat16, 2e-2, None),
    ((1, 500, 1, 64), True, torch.bfloat16, 2e-2, True),
    ((1, 300, 1, 128), False, torch.float16, 5e-3, True),
    ((8, 1024, 4, 64), False, torch.bfloat16, 2e-2, False),
    ((16, 512, 8, 128), True, torch.float16, 5e-3, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal,dtype,tol,split", MMA_DQ_CASES)
def test_cuda_mma_dq_matches_plain_version(shape, causal, dtype, tol, split):
    """The tensor-core dq kernel (bfloat16 and float16 at kernel widths 64
    and 128), with and without its key split, against the plain version
    (dq and delta); two launches are bitwise equal (no atomics, the merge
    sums the splits in a fixed order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(14)
    q, k, v, d_out = (
        torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(4)
    )
    width = torch.empty(shape[:-1] + (fa.kernel_width(shape[-1]),), dtype=dtype, device="cuda")
    if split is not None:
        assert (fa.dq_splits(width, causal) > 1) == split
    out, lse = fa.flash_attention_reference(q, k, v, causal=causal)
    before = dict(fa.kernel_launches)
    dq, delta = fa.flash_attention_bwd_dq(q, k, v, out, lse, d_out, causal=causal)
    dq2, delta2 = fa.flash_attention_bwd_dq(q, k, v, out, lse, d_out, causal=causal)
    torch.cuda.synchronize()
    assert _launched(before) == [f"{fa.KERNEL_DQ}_mma"]
    assert fa.kernel_launches[f"{fa.KERNEL_DQ}_mma"] == before[f"{fa.KERNEL_DQ}_mma"] + 2
    assert torch.equal(dq, dq2) and torch.equal(delta, delta2)
    ref_dq, ref_delta = fa.flash_attention_bwd_dq_reference(
        q, k, v, out, lse, d_out, causal, shape[-1] ** -0.5
    )
    assert dq.dtype == dtype and dq.shape == shape
    assert (dq.float() - ref_dq.float()).abs().max().item() <= tol
    assert (delta - ref_delta).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape,causal", [((2, 300, 2, 300), True), ((1, 256, 2, 640), False),
                                          ((1, 128, 2, 1100), True), ((1, 64, 1, 2048), False)])
def test_cuda_sliced_forward_matches_plain_version(shape, causal, dtype, tol):
    """The width-sliced forward at every width above 256 (300 at 384, 1100
    at 1152): within the type's tolerance of the plain version, two
    launches bitwise equal (each output slice and row has one owner; the
    key splits merge in a fixed order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(15)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(3))
    before = dict(fa.kernel_launches)
    out, lse = fa.flash_attention_forward(q, k, v, causal=causal)
    out2, lse2 = fa.flash_attention_forward(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert _launched(before) == [f"{fa.KERNEL}_sliced"]
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v, causal=causal)
    assert out.dtype == dtype and out.shape == shape
    assert (out.float() - ref_out.float()).abs().max().item() <= tol
    assert (lse - ref_lse).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape,causal,dtype,tol",
    [
        ((4, 257, 2, 64), True, torch.float16, 5e-3),
        ((3, 150, 2, 256), True, torch.float16, 5e-3),
        ((8, 100, 2, 16), False, torch.float16, 5e-3),
        ((2, 130, 2, 16), True, torch.float64, 1e-5),
        ((2, 300, 2, 128), False, torch.float64, 1e-5),
        ((1, 77, 2, 200), True, torch.float64, 1e-5),
        ((2, 300, 2, 256), False, torch.float32, 1e-4),
        ((2, 129, 2, 256), True, torch.bfloat16, 2e-2),
    ],
)
def test_cuda_float16_float64_and_width_256_match_plain_version(shape, causal, dtype, tol):
    """All three kernels take float16 and float64 (float32 sums, outputs in
    the input's dtype) and head_dim 256; each matches its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(10)
    q, k, v, d_out = (
        torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(4)
    )
    before = dict(fa.launch_counts)
    out, lse = fa.flash_attention_forward(q, k, v, causal=causal)
    got = fa.flash_attention_backward(q, k, v, out, lse, d_out, causal=causal)
    torch.cuda.synchronize()
    assert all(fa.launch_counts[n] == before[n] + 1 for n in before)
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v, causal=causal)
    assert out.dtype == dtype and (out.double() - ref_out.double()).abs().max().item() <= tol
    assert (lse.double() - ref_lse.double()).abs().max().item() <= tol
    want = fa.flash_attention_backward_reference(q, k, v, out, lse, d_out, causal=causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == shape, name
        assert (g.double() - w.double()).abs().max().item() <= tol, name
