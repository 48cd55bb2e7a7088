"""
The port's training path against the JAX package's: Flax's default
initialisation, the optimizers against optax, the per-sample losses,
dropout, the window gather, and ``fit`` itself.

``fit`` parity: both sides start from the JAX init (``solo_init_key``,
handed to the port through ``_initial_state``), with dropout 0 and no
shuffle (the windowed default), so they see the same batches. The JAX
model trains with dense attention (its interpret-mode flash backward is
slow-marked in tests/test_seq_models.py; the parameter tree is the same)
and the port with flash, its training configuration. Tolerances: epoch
losses rtol 1e-4, parameters atol 1e-4 after 2 epochs — float32 in
another summation order, compounded over the steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from scipy.stats import norm
from torch import nn

from gordo_tpu.models import TransformerAutoEncoder as JaxTransformerAutoEncoder
from gordo_tpu.models.core import solo_init_key
from gordo_tpu.models.specs import make_optimizer as jax_make_optimizer
from gordo_tpu.models.specs import per_sample_loss as jax_per_sample_loss
from gordo_tpu.models.specs_seq import TransformerNet as JaxTransformerNet
from gordo_tpu_torch.convert import transformer_state_dict
from gordo_tpu_torch.models import TransformerAutoEncoder, TransformerForecast
from gordo_tpu_torch.models.specs import (
    flax_default_init_,
    make_optimizer,
    per_sample_loss,
    resolve_optimizer,
)
from gordo_tpu_torch.models.specs_seq import TransformerNet, dropout
from gordo_tpu_torch.ops.windowing import gather_windows

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# the models here are tiny: one thread runs them as fast as many, and
# leaves the cores to the other test workers
torch.set_num_threads(1)

N_FEATURES, LOOKBACK = 3, 8
SMALL = dict(d_model=16, n_heads=2, n_layers=2)


def _series(n_rows, seed):
    """Daily-cycle sensor rows with noise, (n_rows, 3) float32."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_rows)[:, None]
    wave = np.sin(2 * np.pi * t / 144 + np.arange(N_FEATURES))
    return (wave + 0.1 * rng.normal(size=(n_rows, N_FEATURES))).astype(np.float32)


# -- initialisation --------------------------------------------------------


def test_init_moments_match_flax():
    """Dense kernels: a normal cut at 2 sigma with variance 1/fan_in, as
    Flax's lecun_normal; biases 0 and LayerNorm (1, 0). Both samples
    (131072 draws each) are held to the distribution's own quantiles
    within 0.025 sigma: the sampling spread of a quantile there is about
    0.006 sigma."""
    n_in, n_out = 256, 512
    flax_net = JaxTransformerNet(d_model=n_in, n_heads=4, n_layers=1, ff_dim=n_out, out_dim=2)
    flax_params = flax_net.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 8)))["params"]
    want = np.asarray(flax_params["TransformerBlock_0"]["Dense_0"]["kernel"])  # (in, out)
    net = TransformerNet(n_features=8, d_model=n_in, n_heads=4, n_layers=1, ff_dim=n_out, out_dim=2)
    flax_default_init_(net, torch.Generator().manual_seed(0))
    got = net.blocks[0].ff1.weight.detach().numpy()  # (out, in)
    assert got.shape == want.T.shape
    std = 1.0 / np.sqrt(n_in)
    levels = np.array([0.05, 0.25, 0.5, 0.75, 0.95])
    lo, hi = norm.cdf(-2.0), norm.cdf(2.0)
    quantiles = norm.ppf(lo + levels * (hi - lo)) / 0.87962566103423978 * std
    for sample in (got, want):
        assert abs(sample.mean()) < 0.01 * std
        assert abs(sample.std() / std - 1.0) < 0.01
        assert np.abs(sample).max() <= 2.0 * std / 0.87962566103423978 + 1e-7
        np.testing.assert_allclose(
            np.percentile(sample, 100 * levels), quantiles, atol=0.025 * std
        )
    for module in net.modules():
        if isinstance(module, nn.Linear):
            assert not module.bias.detach().any()
        elif isinstance(module, nn.LayerNorm):
            assert (module.weight == 1).all() and not module.bias.detach().any()


def test_init_is_seeded():
    def init(seed):
        net = TransformerNet(n_features=3, ff_dim=64, out_dim=3, **SMALL)
        return flax_default_init_(net, torch.Generator().manual_seed(seed)).state_dict()

    a, b, c = init(1), init(1), init(2)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed.weight"], c["embed.weight"])


# -- optimizers and losses -------------------------------------------------


@pytest.mark.parametrize(
    "name,kwargs",
    [
        ("adam", {}),
        ("Adam", {"lr": 0.01, "b1": 0.8, "eps": 1e-6}),
        ("adamw", {}),
        ("adamw", {"learning_rate": 0.02, "weight_decay": 0.1}),
        ("sgd", {"lr": 0.1}),
        ("sgd", {"learning_rate": 0.05, "momentum": 0.9}),
        ("sgd", {"learning_rate": 0.05, "momentum": 0.9, "nesterov": True}),
    ],
)
def test_optimizer_matches_optax(name, kwargs):
    rng = np.random.default_rng(0)
    params = {"w": rng.normal(size=(4, 3)).astype(np.float32), "b": rng.normal(size=3).astype(np.float32)}
    grads = [
        {key: rng.normal(size=value.shape).astype(np.float32) for key, value in params.items()}
        for _ in range(6)
    ]
    tx = jax_make_optimizer(name, kwargs)
    jax_params = {key: jnp.asarray(value) for key, value in params.items()}
    state = tx.init(jax_params)
    torch_params = {key: torch.from_numpy(value.copy()).requires_grad_(True) for key, value in params.items()}
    opt = make_optimizer(name, kwargs, list(torch_params.values()))
    for grad in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in grad.items()}, state, jax_params)
        jax_params = optax.apply_updates(jax_params, updates)
        for key, tensor in torch_params.items():
            tensor.grad = torch.from_numpy(grad[key])
        opt.step()
        for key, tensor in torch_params.items():
            np.testing.assert_allclose(
                tensor.detach().numpy(), np.asarray(jax_params[key]), atol=1e-6, err_msg=key
            )


def test_optimizer_aliases_and_defaults():
    _, kwargs = resolve_optimizer("Adam", {"lr": 0.5, "decay": 0.2})
    assert kwargs == {"learning_rate": 0.5, "weight_decay": 0.2}
    _, kwargs = resolve_optimizer("sgd")
    assert kwargs == {"learning_rate": 1e-3}
    opt = make_optimizer("adamw", None, [torch.zeros(2, requires_grad=True)])
    assert opt.defaults["weight_decay"] == 1e-4  # optax's default, not torch's 1e-2
    assert opt.defaults["lr"] == 1e-3


@pytest.mark.parametrize(
    "name", ["rmsprop", "adagrad", "adadelta", "adamax", "nadam", "lamb", "lion"]
)
def test_unported_optimizers_raise(name):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        resolve_optimizer(name)


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="Unknown optimizer"):
        resolve_optimizer("adamz")


@pytest.mark.parametrize("loss", ["mse", "mean_squared_error", "mae", "mean_absolute_error", "huber"])
def test_per_sample_loss_matches_jax(loss):
    rng = np.random.default_rng(1)
    pred, true = (3.0 * rng.normal(size=(20, 4))).astype(np.float32), rng.normal(size=(20, 4)).astype(np.float32)
    want = np.asarray(jax_per_sample_loss(loss, jnp.asarray(pred), jnp.asarray(true)))
    got = per_sample_loss(loss, torch.from_numpy(pred), torch.from_numpy(true)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# -- dropout and the gather ------------------------------------------------


def test_dropout_keeps_and_scales_from_the_generator():
    x = torch.ones(200, 100)
    out = dropout(x, 0.25, True, torch.Generator().manual_seed(4))
    kept = out != 0
    assert abs(kept.float().mean().item() - 0.75) < 0.01
    np.testing.assert_allclose(out[kept].numpy(), 1.0 / 0.75, rtol=1e-6)
    again = dropout(x, 0.25, True, torch.Generator().manual_seed(4))
    assert torch.equal(out, again)
    assert dropout(x, 0.25, False, None) is x
    with pytest.raises(ValueError, match="Generator"):
        dropout(x, 0.25, True, None)


def test_model_dropout_acts_only_in_training():
    net = TransformerNet(n_features=3, ff_dim=32, out_dim=3, dropout=0.5, **SMALL)
    x = torch.from_numpy(_series(16, 0)).reshape(2, 8, 3)
    net.eval()
    assert torch.equal(net(x), net(x))
    net.train()
    a = net(x, generator=torch.Generator().manual_seed(1))
    b = net(x, generator=torch.Generator().manual_seed(1))
    c = net(x, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("lookahead", [0, 1])
def test_gather_windows_matches_jax_gather(lookahead):
    X = np.arange(60, dtype=np.float32).reshape(20, 3)
    y = 2 * X
    sel = np.array([0, 5, 11], dtype=np.int32)
    rows = sel[:, None] + np.arange(LOOKBACK)[None, :]
    xb, yb = gather_windows(torch.from_numpy(X), torch.from_numpy(y), torch.from_numpy(sel).long(), LOOKBACK, lookahead)
    np.testing.assert_array_equal(xb.numpy(), X[rows])
    np.testing.assert_array_equal(yb.numpy(), y[sel + LOOKBACK - 1 + lookahead])


# -- fit -------------------------------------------------------------------


def _jax_init(jax_est, seed):
    jax_est.kwargs.update(n_features=N_FEATURES, n_features_out=N_FEATURES)
    module = jax_est._build_spec().module
    return module.init(solo_init_key(seed), jnp.zeros((1, LOOKBACK, N_FEATURES)))


def _fit_pair(X, seed=3, optimizer="Adam", **fit_kwargs):
    kwargs = dict(
        kind="transformer_model", lookback_window=LOOKBACK, dropout=0.0, epochs=2,
        batch_size=32, seed=seed, optimizer=optimizer, **SMALL,
    )
    jax_est = JaxTransformerAutoEncoder(attention_impl="dense", **kwargs)
    jax_est.fit(X, X, **fit_kwargs)
    port = TransformerAutoEncoder(attention_impl="flash", **kwargs)
    state = transformer_state_dict(_jax_init(JaxTransformerAutoEncoder(**kwargs), seed))
    port._initial_state = lambda spec, seed: {k: torch.tensor(v) for k, v in state.items()}
    port.fit(X, X, device="cpu", **fit_kwargs)
    return jax_est, port


@pytest.mark.parametrize(
    "optimizer,fit_kwargs",
    [("Adam", {}), ("Adam", {"validation_split": 0.2}), ("sgd", {})],
)
def test_fit_matches_jax_fit(optimizer, fit_kwargs):
    """Under Adam the attention key biases are left out of the parameter
    comparison: their gradient is 0 in exact arithmetic (a shift of every
    key by one vector moves each query's scores by a constant, which the
    softmax ignores), so each side's gradient there is rounding noise,
    which Adam normalises into steps of about the learning rate. Under
    SGD they stay put, and every parameter is compared."""
    # 240 rows -> 233 windows: a ragged last batch (233 = 7 * 32 + 9)
    X = _series(240, seed=5)
    jax_est, port = _fit_pair(X, optimizer=optimizer, **fit_kwargs)
    np.testing.assert_allclose(port.history_["loss"], jax_est.history_["loss"], rtol=1e-4)
    if "validation_split" in fit_kwargs:
        np.testing.assert_allclose(
            port.history_["val_loss"], jax_est.history_["val_loss"], rtol=1e-4
        )
    assert port.history_["params"] == jax_est.history_["params"]
    assert port.history_["loss"][-1] < port.history_["loss"][0]
    want = transformer_state_dict(jax_est.params_)
    got = port.spec_.module.state_dict()
    assert set(got) == set(want)
    for name, value in want.items():
        if optimizer == "Adam" and name.endswith("attn.key.bias"):
            continue
        np.testing.assert_allclose(got[name].numpy(), value, atol=1e-4, err_msg=name)
    np.testing.assert_allclose(port.predict(X), jax_est.predict(X), atol=1e-4)
    np.testing.assert_allclose(port.score(X, X), jax_est.score(X, X), rtol=1e-4)
    got_meta, want_meta = port.get_metadata(), jax_est.get_metadata()
    assert set(got_meta) == set(want_meta)
    assert set(got_meta["history"]) == set(want_meta["history"])
    assert {k: v for k, v in got_meta.items() if k != "history"} == {
        k: v for k, v in want_meta.items() if k != "history"
    }


def test_fit_raises_on_callbacks():
    est = TransformerAutoEncoder(
        kind="transformer_model", lookback_window=LOOKBACK, epochs=1,
        callbacks=[{"tensorflow.keras.callbacks.EarlyStopping": {"patience": 1}}], **SMALL,
    )
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        est.fit(_series(40, seed=1), _series(40, seed=1), device="cpu")


def test_fit_is_seeded_with_dropout_and_shuffle():
    """Dropout masks and shuffles come from the fit's seed: the same seed
    trains the same weights, another seed others."""

    def fit(seed):
        est = TransformerForecast(
            kind="transformer_model", lookback_window=LOOKBACK, epochs=1, dropout=0.2,
            shuffle=True, seed=seed, **SMALL,
        )
        return est.fit(_series(80, seed=2), _series(80, seed=2), device="cpu").state_arrays()

    a, b, c = fit(1), fit(1), fit(2)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not np.array_equal(a["head.weight"], c["head.weight"])
