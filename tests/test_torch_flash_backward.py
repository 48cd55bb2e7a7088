"""
The port's flash-attention backward (gordo_tpu_torch.ops.flash_attention)
and the autograd Function around the three kernels.

- The plain backward against the JAX package's ``_flash_backward_bhsd``
  (both Pallas backward kernels, run in interpret mode as the JAX tests
  run them on the CPU) and against dense attention's autograd, on the
  same forward residuals. atol 1e-5: the same float32 math in another
  summation order.
- ``gradcheck`` of the Function in float64.
- The repair: gradients of a loss through ``attention_impl="flash"``
  equal those through ``"dense"`` (atol 1e-5, float32).
- The Function's gradients against ``jax.grad`` through the JAX
  ``flash_attention`` at head_dims the wrappers pad (up to 640: 300 runs
  at 384 and 640 at itself, as in the JAX wrapper; atol 1e-5), in float16 (atol 2e-3: both sides accumulate in float32 and
  round each gradient to float16 once) and in float64 under
  ``jax.enable_x64`` (atol 1e-5: the Pallas kernels accumulate in float32
  where the plain path uses float64).

On CPU tensors the wrappers run their plain versions; the CUDA kernels
are held against those on the card by tests/test_torch_cuda.py and
chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax

from gordo_tpu.ops.flash_attention import _flash_backward_bhsd
from gordo_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from gordo_tpu_torch.models.specs_seq import TransformerNet, dense_attention
from gordo_tpu_torch.ops import flash_attention as fa

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# the models here are tiny: one thread runs them as fast as many, and
# leaves the cores to the other test workers
torch.set_num_threads(1)

ATOL = 1e-5
# a ragged sequence (37: not a tile multiple) and the training step's S, H,
# D; then head_dims the wrappers zero-pad to the next kernel width (8 and
# 12 to 16, 48 to 64, 96 to 128)
SHAPES = [(2, 37, 2, 16), (4, 64, 4, 16), (2, 37, 2, 8), (3, 29, 2, 12), (2, 37, 2, 48),
          (2, 21, 1, 96)]


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=shape).astype(np.float32)) for _ in range(4)]


def _bhsd(x: torch.Tensor) -> jnp.ndarray:
    batch, seq, heads, head_dim = x.shape
    return jnp.asarray(x.permute(0, 2, 1, 3).reshape(batch * heads, seq, head_dim).numpy())


def _bshd(x, shape) -> np.ndarray:
    batch, seq, heads, head_dim = shape
    return np.asarray(x).reshape(batch, heads, seq, head_dim).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("causal", [False, True])
def test_plain_backward_matches_jax_kernels(shape, causal):
    q, k, v, d_out = _inputs(shape, seed=sum(shape) + causal)
    out, lse = fa.flash_attention_forward(q, k, v, causal=causal)
    sm_scale = 1.0 / np.sqrt(shape[-1])
    want = _flash_backward_bhsd(
        _bhsd(q), _bhsd(k), _bhsd(v), _bhsd(out), jnp.asarray(lse.numpy()), _bhsd(d_out),
        causal, sm_scale, 32, 32, True,
    )
    got = fa.flash_attention_backward(q, k, v, out, lse, d_out, causal=causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), _bshd(w, shape), atol=ATOL, err_msg=name)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("causal", [False, True])
def test_plain_backward_matches_dense_autograd(shape, causal):
    q, k, v, d_out = _inputs(shape, seed=3 + causal)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    dense_attention(*leaves, causal=causal).backward(d_out)
    out, lse = fa.flash_attention_forward(q, k, v, causal=causal)
    before = dict(fa.launch_counts)
    got = fa.flash_attention_backward(q, k, v, out, lse, d_out, causal=causal)
    for name, g, leaf in zip(("dq", "dk", "dv"), got, leaves):
        np.testing.assert_allclose(g.numpy(), leaf.grad.numpy(), atol=ATOL, err_msg=name)
    # CPU tensors take the plain versions: no kernel was launched
    assert fa.launch_counts == before


def test_backward_halves_compose():
    """The dq half's delta is rowsum(dO * O) per (batch*head, seq) row, and
    the two halves give the whole plain backward."""
    shape = (3, 20, 2, 16)
    q, k, v, d_out = _inputs(shape, seed=5)
    out, lse = fa.flash_attention_forward(q, k, v, causal=True)
    dq, delta = fa.flash_attention_bwd_dq(q, k, v, out, lse, d_out, causal=True)
    want_delta = (d_out * out).sum(-1).permute(0, 2, 1).reshape(shape[0] * shape[2], shape[1])
    np.testing.assert_allclose(delta.numpy(), want_delta.numpy(), atol=ATOL)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, lse, delta, d_out, causal=True)
    want = fa.flash_attention_backward_reference(q, k, v, out, lse, d_out, True)
    for got, expected in zip((dq, dk, dv), want):
        np.testing.assert_array_equal(got.numpy(), expected.numpy())


@pytest.mark.parametrize("causal", [False, True])
def test_function_gradcheck_float64(causal):
    rng = np.random.default_rng(11 + causal)
    q, k, v = (
        torch.from_numpy(rng.normal(size=(2, 9, 2, 4))).requires_grad_(True) for _ in range(3)
    )
    assert torch.autograd.gradcheck(
        lambda a, b, c: fa.flash_attention(a, b, c, causal=causal), (q, k, v)
    )


@pytest.mark.parametrize("head_dim", [8, 12, 48, 96, 200, 256, 300, 640])
@pytest.mark.parametrize("causal", [False, True])
def test_function_gradients_match_jax_grad_at_padded_head_dims(head_dim, causal):
    """The Function pads q, k, v once to the kernel width and slices the
    gradients back: dq, dk, dv of a loss equal ``jax.grad`` through the JAX
    ``flash_attention`` (Pallas in interpret mode)."""
    shape = (2, 23, 2, head_dim)
    q, k, v, d_out = _inputs(shape, seed=head_dim + causal)

    def jax_loss(a, b, c):
        return (jax_flash_attention(a, b, c, causal=causal) * jnp.asarray(d_out.numpy())).sum()

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(*(jnp.asarray(x.numpy()) for x in (q, k, v)))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    (fa.flash_attention(*leaves, causal=causal) * d_out).sum().backward()
    for name, leaf, w in zip(("dq", "dk", "dv"), leaves, want):
        assert leaf.grad.shape == shape
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), atol=ATOL, err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
def test_padded_plain_path_matches_jax_above_1024(causal, monkeypatch):
    """head_dim 1100, which the card runs at 1152 (the sliced forward, the
    tiled dq and dk/dv): the CPU's padded plain path against the
    JAX ``flash_attention`` (Pallas in interpret mode), the output and the
    ``jax.grad`` gradients, float32, atol 1e-5."""
    shape = (1, 19, 1, 1100)
    q, k, v, d_out = _inputs(shape, seed=1100 + causal)
    jq, jk, jv = (jnp.asarray(x.numpy()) for x in (q, k, v))
    want_out = jax_flash_attention(jq, jk, jv, causal=causal)
    widths = []
    reference = fa.flash_attention_reference

    def spy(x, *args):
        widths.append(x.shape[-1])
        return reference(x, *args)

    monkeypatch.setattr(fa, "flash_attention_reference", spy)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = fa.flash_attention(*leaves, causal=causal)
    assert widths == [1152] and out.shape == shape
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), atol=ATOL)

    def jax_loss(a, b, c):
        return (jax_flash_attention(a, b, c, causal=causal) * jnp.asarray(d_out.numpy())).sum()

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(jq, jk, jv)
    (out * d_out).sum().backward()
    for name, leaf, w in zip(("dq", "dk", "dv"), leaves, want):
        assert leaf.grad.shape == shape
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), atol=ATOL, err_msg=name)


def _jax_grads(q, k, v, d_out, causal):
    """dq, dk, dv of sum(out * d_out) through the JAX ``flash_attention``."""

    def loss(a, b, c):
        return (jax_flash_attention(a, b, c, causal=causal) * jnp.asarray(d_out)).sum()

    return jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))


def _torch_grads(q, k, v, d_out, causal):
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    (fa.flash_attention(*leaves, causal=causal) * torch.from_numpy(d_out)).sum().backward()
    return [leaf.grad for leaf in leaves]


# a kernel width of each kernel family and a padded head_dim
DTYPE_SHAPES = [(2, 23, 2, 16), (2, 19, 2, 64), (1, 17, 2, 200)]


@pytest.mark.parametrize("shape", DTYPE_SHAPES)
@pytest.mark.parametrize("causal", [False, True])
def test_function_gradients_match_jax_grad_in_float16(shape, causal):
    q, k, v, d_out = (x.numpy().astype(np.float16) for x in _inputs(shape, seed=sum(shape) + causal))
    want = _jax_grads(q, k, v, d_out, causal)
    got = _torch_grads(q, k, v, d_out, causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float16 and np.asarray(w).dtype == np.float16, name
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w).astype(np.float32),
                                   atol=2e-3, err_msg=name)


@pytest.mark.parametrize("shape", DTYPE_SHAPES)
@pytest.mark.parametrize("causal", [False, True])
def test_function_gradients_match_jax_grad_in_float64(shape, causal):
    q, k, v, d_out = (x.numpy().astype(np.float64) for x in _inputs(shape, seed=sum(shape) + 2))
    with jax.enable_x64(True):
        want = _jax_grads(q, k, v, d_out, causal)
        assert all(np.asarray(w).dtype == np.float64 for w in want)
    got = _torch_grads(q, k, v, d_out, causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float64, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, err_msg=name)


def test_function_refuses_double_backward():
    """The kernels' gradients are not themselves differentiable, so a
    second-order request raises on every device, the CPU included."""
    rng = np.random.default_rng(14)
    q, k, v = (
        torch.from_numpy(rng.normal(size=(1, 6, 2, 16)).astype(np.float32)).requires_grad_(True)
        for _ in range(3)
    )
    loss = fa.flash_attention(q, k, v, causal=True).square().sum()
    (dq,) = torch.autograd.grad(loss, q, create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        dq.sum().backward()


def test_function_grads_reach_strided_views():
    """The model feeds (batch, seq, heads, head_dim) views of one
    projection; gradients flow back through them."""
    rng = np.random.default_rng(12)
    wide = torch.from_numpy(rng.normal(size=(2, 10, 2, 48)).astype(np.float32))
    wide.requires_grad_(True)
    q, k, v = wide[..., :16], wide[..., 16:32], wide[..., 32:]
    fa.flash_attention(q, k, v, causal=True).square().sum().backward()
    flash_grad = wide.grad.clone()
    wide.grad = None
    dense_attention(q, k, v, causal=True).square().sum().backward()
    np.testing.assert_allclose(flash_grad.numpy(), wide.grad.numpy(), atol=ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_gradients_equal_dense_through_the_model(causal):
    """The repair: a loss through attention_impl="flash" has the same
    gradient in every parameter as through "dense"."""
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.normal(size=(6, 8, 3)).astype(np.float32))
    target = torch.from_numpy(rng.normal(size=(6, 3)).astype(np.float32))
    grads = {}
    for impl in ("dense", "flash"):
        torch.manual_seed(0)
        net = TransformerNet(
            n_features=3, d_model=16, n_heads=2, n_layers=2, ff_dim=32, out_dim=3,
            causal=causal, attention_impl=impl,
        )
        ((net(x) - target) ** 2).mean().backward()
        grads[impl] = {name: p.grad.clone() for name, p in net.named_parameters()}
    assert set(grads["flash"]) == set(grads["dense"])
    for name, grad in grads["flash"].items():
        np.testing.assert_allclose(
            grad.numpy(), grads["dense"][name].numpy(), atol=ATOL, err_msg=name
        )
    # the projections below attention do get a gradient
    assert grads["flash"]["blocks.0.attn.query.weight"].abs().max() > 0


def test_backward_has_no_path_off_cpu_and_cuda():
    q = torch.zeros(1, 4, 2, 16, device="meta")
    lse = torch.zeros(2, 4, device="meta")
    with pytest.raises(ValueError, match="no path"):
        fa.flash_attention_backward(q, q, q, q, lse, q)
    with pytest.raises(ValueError, match="no path"):
        fa.flash_attention_bwd_dkv(q, q, q, lse, lse, q)


def test_backward_rejects_mismatched_gradient():
    q = torch.zeros(1, 4, 2, 16)
    lse = torch.zeros(2, 4)
    with pytest.raises(ValueError, match="d_out"):
        fa.flash_attention_bwd_dq(q, q, q, q, lse, torch.zeros(1, 5, 2, 16))


def test_backward_source_is_listed():
    from gordo_tpu_torch.ops import _build

    for kernel in (fa.KERNEL_DQ, fa.KERNEL_DKV):
        assert fa.SOURCES[kernel] in _build.sources()
