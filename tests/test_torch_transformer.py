"""
The port's Transformer model path against the JAX package's: activation
registry, positional encoding, TransformerNet forward on carried-over
Flax weights (both attention impls), and the windowed predict of the
Transformer estimators.

Inputs and weights are made with numpy from a seed and handed to both
sides. Tolerance: atol 1e-5 in float32 (same arithmetic, summation order
differs). In bfloat16, 16 bf16 steps (2^-8 relative) of the output's
largest magnitude: both sides round every Dense output and the attention
output to bfloat16, each at its own places, over 2 layers. Over 20 seeds
at this size the port differed from JAX by at most 5.5 steps with flash
attention and 11 with dense, and either bf16 model from the float32 one
by up to 7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gordo_tpu.models import TransformerAutoEncoder as JaxTransformerAutoEncoder
from gordo_tpu.models import TransformerForecast as JaxTransformerForecast
from gordo_tpu.models.specs_seq import TransformerNet as JaxTransformerNet
from gordo_tpu.models.specs_seq import sinusoidal_positions as jax_positions
from gordo_tpu.ops.activations import ACTIVATIONS as JAX_ACTIVATIONS
from gordo_tpu_torch.convert import transformer_state_dict
from gordo_tpu_torch.models import TransformerAutoEncoder, TransformerForecast
from gordo_tpu_torch.models.specs_seq import TransformerNet, sinusoidal_positions
from gordo_tpu_torch.ops.activations import ACTIVATIONS
from gordo_tpu_torch.parallel.fleet import windowed_predict

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ATOL = 1e-5
N_FEATURES, LOOKBACK = 3, 8
SMALL = dict(d_model=16, n_heads=2, n_layers=2)


def flax_params(attention_impl="dense", seed=0, widths=SMALL, dtype=jnp.float32):
    """A small JAX TransformerNet's params, every leaf perturbed with
    numpy noise so biases and LayerNorm scales are not trivially 0/1;
    ``dtype`` is the module's compute type (the params are float32)."""
    module = JaxTransformerNet(
        ff_dim=4 * widths["d_model"], out_dim=N_FEATURES, attention_impl=attention_impl,
        dtype=dtype, **widths,
    )
    params = module.init(jax.random.PRNGKey(seed), jnp.zeros((1, LOOKBACK, N_FEATURES)))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * rng.normal(size=a.shape).astype(np.float32), params
    )
    return module, params


def port_net(attention_impl, params, widths=SMALL, dtype=torch.float32):
    net = TransformerNet(
        n_features=N_FEATURES, ff_dim=4 * widths["d_model"], out_dim=N_FEATURES,
        attention_impl=attention_impl, dtype=dtype, **widths,
    )
    state = transformer_state_dict(params)
    net.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return net.eval()


def test_activation_registry_matches_jax():
    assert set(ACTIVATIONS) == set(JAX_ACTIVATIONS)
    grid = np.linspace(-6.0, 6.0, 241, dtype=np.float32)
    for name, fn in ACTIVATIONS.items():
        want = np.asarray(JAX_ACTIVATIONS[name](jnp.asarray(grid)))
        got = fn(torch.from_numpy(grid)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6, err_msg=name)


@pytest.mark.parametrize("seq,d_model", [(10, 16), (64, 64), (7, 5)])
def test_sinusoidal_positions_match_jax(seq, d_model):
    np.testing.assert_allclose(
        sinusoidal_positions(seq, d_model).numpy(),
        np.asarray(jax_positions(seq, d_model)),
        atol=1e-6,
    )


@pytest.mark.parametrize("attention_impl", ["dense", "flash"])
def test_transformer_net_matches_flax(attention_impl):
    module, params = flax_params(attention_impl)
    x = np.random.default_rng(1).normal(size=(24, LOOKBACK, N_FEATURES)).astype(np.float32)
    want, _ = module.apply(params, jnp.asarray(x))
    with torch.no_grad():
        got = port_net(attention_impl, params)(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_transformer_block_at_head_dim_8_matches_flax():
    """d_model 32 over 4 heads (examples/long_context_training.py's head
    size, 8) through attention_impl="flash": the wrapper pads each head to
    the 16-wide kernel, and the block still equals the JAX one."""
    widths = dict(d_model=32, n_heads=4, n_layers=1)
    module, params = flax_params("flash", seed=2, widths=widths)
    x = np.random.default_rng(3).normal(size=(16, LOOKBACK, N_FEATURES)).astype(np.float32)
    want, _ = module.apply(params, jnp.asarray(x))
    with torch.no_grad():
        got = port_net("flash", params, widths)(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


BF16_STEPS = 16


@pytest.mark.parametrize("attention_impl", ["flash", "dense"])
def test_transformer_net_in_bfloat16_matches_flax(attention_impl):
    """The model at compute dtype bfloat16 with 2 heads of 64 (d_model 128,
    2 layers, a 24-step window), the width whose attention the card runs on
    its tensor-core kernels: the port (flash: the plain path on the CPU)
    against the JAX TransformerNet at ``jnp.bfloat16`` (flash: Pallas in
    interpret mode), on weights carried over by ``convert.py``."""
    widths = dict(d_model=128, n_heads=2, n_layers=2)
    module, params = flax_params(attention_impl, seed=11, widths=widths, dtype=jnp.bfloat16)
    x = np.random.default_rng(12).normal(size=(4, 24, N_FEATURES)).astype(np.float32)
    want, _ = module.apply(params, jnp.asarray(x))
    want = np.asarray(want, dtype=np.float32)
    with torch.no_grad():
        got = port_net(attention_impl, params, widths, dtype=torch.bfloat16)(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(
        got.numpy(), want, atol=BF16_STEPS * 2.0 ** -8 * np.abs(want).max(), rtol=0
    )


def test_state_dict_covers_every_weight():
    _, params = flax_params()
    state = transformer_state_dict(params)
    net = TransformerNet(
        n_features=N_FEATURES, ff_dim=4 * SMALL["d_model"], out_dim=N_FEATURES, **SMALL
    )
    assert set(state) == set(net.state_dict())
    assert all(state[k].shape == tuple(v.shape) for k, v in net.state_dict().items())
    # Flax Dense kernels are (in, out); torch Linear weights are (out, in)
    np.testing.assert_array_equal(state["embed.weight"], params["params"]["embed"]["kernel"].T)


def _estimator_pair(jax_cls, port_cls, params):
    kwargs = dict(
        kind="transformer_model", lookback_window=LOOKBACK, attention_impl="flash", **SMALL
    )
    jax_est = jax_cls(**kwargs)
    jax_est.kwargs.update(n_features=N_FEATURES, n_features_out=N_FEATURES)
    jax_est.spec_ = jax_est._build_spec()
    jax_est.params_ = params
    jax_est.n_features_ = jax_est.n_features_out_ = N_FEATURES
    port = port_cls(n_features=N_FEATURES, n_features_out=N_FEATURES, **kwargs)
    port.load_state_arrays(transformer_state_dict(params), device="cpu")
    return jax_est, port


@pytest.mark.parametrize(
    "jax_cls,port_cls,lookahead",
    [
        (JaxTransformerAutoEncoder, TransformerAutoEncoder, 0),
        (JaxTransformerForecast, TransformerForecast, 1),
    ],
)
def test_windowed_predict_matches_jax(jax_cls, port_cls, lookahead):
    _, params = flax_params("flash", seed=2)
    jax_est, port = _estimator_pair(jax_cls, port_cls, params)
    X = np.random.default_rng(3).normal(size=(100, N_FEATURES)).astype(np.float32)
    want = jax_est.predict(X)
    got = port.predict(X)
    assert port.lookahead == lookahead
    assert got.shape == want.shape == (100 - LOOKBACK + 1 - lookahead, N_FEATURES)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_windowed_predict_chunks_agree():
    _, params = flax_params(seed=4)
    net = port_net("flash", params)
    X = torch.from_numpy(np.random.default_rng(5).normal(size=(60, N_FEATURES)).astype(np.float32))
    whole = windowed_predict(net, X, LOOKBACK, 0)
    chunked = windowed_predict(net, X, LOOKBACK, 0, batch_size=7)
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), atol=1e-6)


def test_too_few_rows_raise_the_jax_message():
    _, params = flax_params(seed=6)
    jax_est, port = _estimator_pair(JaxTransformerAutoEncoder, TransformerAutoEncoder, params)
    X = np.zeros((LOOKBACK - 2, N_FEATURES), dtype=np.float32)
    with pytest.raises(ValueError) as jax_err:
        jax_est.predict(X)
    with pytest.raises(ValueError) as port_err:
        port.predict(X)
    assert str(port_err.value) == str(jax_err.value)


def test_padded_width_artifact_pads_and_strips():
    """A machine built into a wider (padded) program takes and returns
    its real width; the pad column is inert."""
    _, params = flax_params(seed=8)
    _, port = _estimator_pair(JaxTransformerAutoEncoder, TransformerAutoEncoder, params)
    port.n_active_features_ = port.n_active_features_out_ = N_FEATURES - 1
    X = np.random.default_rng(9).normal(size=(30, N_FEATURES - 1)).astype(np.float32)
    got = port.predict(X)
    padded = np.concatenate([X, np.zeros((30, 1), np.float32)], axis=1)
    del port.n_active_features_, port.n_active_features_out_
    np.testing.assert_allclose(got, port.predict(padded)[:, : N_FEATURES - 1], atol=0)
