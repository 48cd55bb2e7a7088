"""
Rematerialisation in the port's ``TransformerNet`` (``remat=True``):
against the JAX net's ``nn.remat`` blocks (flash attention through the
Pallas kernels in interpret mode, as the JAX package's tests run them on
the CPU), against the port's own plain net (gradients bitwise equal,
with dropout too: the recompute replays the block's dropout draws), and
the flash Function's launches under it, read through its CPU counter
(``flash_attention.plain_calls``): each layer's forward runs twice in a
training step, dq and dk/dv once.

Tolerance against JAX: 1e-5 in float32 (the same arithmetic in another
summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gordo_tpu.models.specs_seq import TransformerNet as JaxTransformerNet
from gordo_tpu_torch.convert import transformer_state_dict
from gordo_tpu_torch.models.specs import DropoutFeed
from gordo_tpu_torch.models.specs_seq import TransformerNet
from gordo_tpu_torch.ops import flash_attention as fa
from tests.test_torch_transformer import LOOKBACK, N_FEATURES, SMALL, flax_params

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ATOL = 1e-5


def _net(attention_impl="flash", remat=False, dropout=0.0, params=None):
    net = TransformerNet(
        n_features=N_FEATURES, ff_dim=4 * SMALL["d_model"], out_dim=N_FEATURES,
        attention_impl=attention_impl, dropout=dropout, remat=remat, **SMALL,
    )
    if params is not None:
        state = transformer_state_dict(params)
        net.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in state.items()})
    return net.train()


def _batch(seed=1, n=12):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, LOOKBACK, N_FEATURES)).astype(np.float32)
    target = rng.normal(size=(n, N_FEATURES)).astype(np.float32)
    return x, target


def _step(net, x, target, generator=None):
    """(loss, {name: gradient}) of one mean-squared-error step."""
    net.zero_grad(set_to_none=True)
    out = net(torch.from_numpy(x), generator)
    loss = ((out - torch.from_numpy(target)) ** 2).mean()
    loss.backward()
    return loss.detach(), {n: p.grad.detach().clone() for n, p in net.named_parameters()}


def test_remat_net_matches_jax_remat_net():
    _, params = flax_params("flash", seed=3)
    module = JaxTransformerNet(
        ff_dim=4 * SMALL["d_model"], out_dim=N_FEATURES, attention_impl="flash", remat=True,
        **SMALL,
    )
    x, target = _batch()

    def loss_fn(p):
        out, _ = module.apply(p, jnp.asarray(x))
        return jnp.mean((out - jnp.asarray(target)) ** 2)

    want_loss, want_grads = jax.value_and_grad(loss_fn)(params)
    got_loss, got_grads = _step(_net("flash", remat=True, params=params), x, target)
    np.testing.assert_allclose(got_loss.item(), float(want_loss), atol=ATOL, rtol=ATOL)
    want = transformer_state_dict(jax.tree.map(np.asarray, want_grads))
    assert set(got_grads) == set(want)
    for name, grad in got_grads.items():
        np.testing.assert_allclose(grad.numpy(), want[name], atol=ATOL, rtol=ATOL, err_msg=name)


@pytest.mark.parametrize("attention_impl", ["flash", "dense"])
@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_remat_gradients_equal_plain_bitwise(attention_impl, dropout):
    """The same weights and the same generator seed: loss and every
    gradient bit for bit, and the generator left where the plain step
    leaves it (the recompute's draws are replays, not new draws)."""
    _, params = flax_params(attention_impl, seed=5)
    x, target = _batch(seed=6)
    results = []
    for remat in (False, True):
        generator = torch.Generator().manual_seed(17)
        loss, grads = _step(_net(attention_impl, remat, dropout, params), x, target, generator)
        results.append((loss, grads, generator.get_state()))
    (loss, grads, state), (remat_loss, remat_grads, remat_state) = results
    assert torch.equal(loss, remat_loss)
    for name, grad in grads.items():
        assert torch.equal(grad, remat_grads[name]), name
    assert torch.equal(state, remat_state)


def test_remat_replays_a_dropout_feed():
    """Under the fleet trainer the draws come from a ``DropoutFeed``: the
    recompute takes the same draws again."""
    _, params = flax_params("flash", seed=7)
    x, target = _batch(seed=8, n=4)
    shapes_feed = DropoutFeed()
    with torch.no_grad():
        _net("flash", dropout=0.1, params=params)(torch.from_numpy(x), shapes_feed)
    gen = torch.Generator().manual_seed(3)
    draws = [torch.rand(shape, generator=gen) for shape in shapes_feed.shapes]
    results = [
        _step(_net("flash", remat, 0.1, params), x, target, DropoutFeed(draws))
        for remat in (False, True)
    ]
    assert torch.equal(results[0][0], results[1][0])
    for name, grad in results[0][1].items():
        assert torch.equal(grad, results[1][1][name]), name


def test_remat_launches_the_flash_forward_twice_per_layer():
    x, target = _batch(seed=9)
    counts = {}
    for remat in (False, True):
        net = _net("flash", remat)
        fa.reset_launch_counts()
        _step(net, x, target)
        counts[remat] = dict(fa.plain_calls)
    layers = SMALL["n_layers"]
    assert counts[False] == {fa.KERNEL: layers, fa.KERNEL_DQ: layers, fa.KERNEL_DKV: layers}
    assert counts[True] == {fa.KERNEL: 2 * layers, fa.KERNEL_DQ: layers,
                            fa.KERNEL_DKV: layers}
    # an inference forward recomputes nothing
    fa.reset_launch_counts()
    with torch.no_grad():
        _net("flash", True).eval()(torch.from_numpy(x))
    assert fa.plain_calls[fa.KERNEL] == layers


def test_remat_keeps_the_parameter_names():
    """Either twin loads the other's weights, and their forwards agree."""
    plain, remat = _net(remat=False), _net(remat=True)
    assert list(plain.state_dict()) == list(remat.state_dict())
    remat.load_state_dict(plain.state_dict())
    x, _ = _batch(seed=10)
    with torch.no_grad():
        np.testing.assert_array_equal(plain.eval()(torch.from_numpy(x)).numpy(),
                                      remat.eval()(torch.from_numpy(x)).numpy())
