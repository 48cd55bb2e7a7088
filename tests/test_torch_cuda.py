"""
Card-only tests of the port's CUDA kernels: each kernel against its plain
PyTorch version on the same CUDA tensors. They skip without a card.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch: there, run it without the JAX-side
conftest, ``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.

Tolerances: 1e-4 in float32 (same softmax in float32, other summation
order); 2e-2 in bf16 (one bf16 rounding of outputs of magnitude up to 2).
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
