"""
The TCN family (``TCNNet``, ``tcn_model``, ``TCNAutoEncoder`` and
``TCNForecast``) against the JAX package's.

Inputs and Flax parameters come from numpy and JAX seeds and go to both
sides through ``gordo_tpu_torch.convert``. Channels (8, 12) from 4
features, so both blocks project their residual (4 -> 8 and 8 -> 12),
kernel 3, dilations (1, 2). Tolerances:

- forward in float32: atol 1e-5 (the same arithmetic, another summation
  order);
- forward in bfloat16: within 2^-7 of the largest output against the JAX
  net run op by op (``jax.disable_jit``);
- ``fit`` from the JAX init with dropout 0 and the same batches: epoch
  losses rtol 1e-4, parameters atol 1e-4;
- estimators' ``predict`` atol 1e-5 and ``score`` rtol 1e-5 with atol
  1e-6.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gordo_tpu import models as jax_models
from gordo_tpu.models.core import solo_init_key
from gordo_tpu.models.factories.tcn import tcn_model as jax_tcn_model
from gordo_tpu.models.specs_seq import TCNNet as JaxTCNNet
from gordo_tpu.models.specs_seq import default_dilations as jax_default_dilations
from gordo_tpu.models.specs_seq import receptive_field as jax_receptive_field
from gordo_tpu.serializer import into_definition
from gordo_tpu_torch import serializer
from gordo_tpu_torch.convert import model_from_flax, tcn_state_dict
from gordo_tpu_torch.models import TCNAutoEncoder, TCNForecast
from gordo_tpu_torch.models.factories.tcn import tcn_model
from gordo_tpu_torch.models.register import register_model_builder
from gordo_tpu_torch.models.specs import flax_default_init_
from gordo_tpu_torch.models.specs_seq import TCNNet, default_dilations, receptive_field

torch.backends.cudnn.allow_tf32 = False
torch.set_num_threads(1)

N_FEATURES, LOOKBACK = 4, 10
NET = dict(channels=(8, 12), kernel_size=3, dilations=(1, 2), out_dim=N_FEATURES)
ESTIMATORS = {"TCNAutoEncoder": (TCNAutoEncoder, 0), "TCNForecast": (TCNForecast, 1)}


def _series(n_rows, n_features, seed):
    """Daily-cycle sensor rows with noise, float32."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_rows)[:, None]
    wave = np.sin(2 * np.pi * t / 144 + np.arange(n_features))
    return (wave + 0.1 * rng.normal(size=(n_rows, n_features))).astype(np.float32)


def _windows(seed, n=24):
    return np.random.default_rng(seed).normal(size=(n, LOOKBACK, N_FEATURES)).astype(np.float32)


def _nets(jax_dtype=jnp.float32, torch_dtype=torch.float32, func="relu"):
    jax_net = JaxTCNNet(dtype=jax_dtype, func=func, **NET)
    port_net = TCNNet(N_FEATURES, dtype=torch_dtype, func=func, **NET)
    return jax_net, port_net


def _load(port_net, params):
    port_net.load_state_dict({k: torch.tensor(v) for k, v in tcn_state_dict(params).items()})
    return port_net


@pytest.mark.parametrize("model_type", list(ESTIMATORS))
def test_tcn_kind_is_registered(model_type):
    assert register_model_builder.factories[model_type]["tcn_model"] is tcn_model


@pytest.mark.parametrize("n_blocks", [1, 3, 5])
def test_dilations_and_receptive_field_match_jax(n_blocks):
    dilations = default_dilations(n_blocks)
    assert dilations == jax_default_dilations(n_blocks)
    for kernel in (2, 3, 5):
        assert receptive_field(kernel, dilations) == jax_receptive_field(kernel, dilations)
    assert receptive_field(3, (1, 2, 4)) == 29


def test_factory_refuses_mismatched_dilations_as_jax():
    kwargs = dict(n_features=3, channels=(8, 8), dilations=(1, 2, 4))
    with pytest.raises(ValueError) as jax_err:
        jax_tcn_model(**kwargs)
    with pytest.raises(ValueError) as port_err:
        tcn_model(**kwargs)
    assert str(port_err.value) == str(jax_err.value)


def test_factory_defaults_match_jax():
    spec, jax_spec = tcn_model(n_features=3, lookback_window=7), jax_tcn_model(n_features=3,
                                                                                lookback_window=7)
    net, jax_net = spec.module, jax_spec.module
    assert [b.conv0.out_channels for b in net.blocks] == list(jax_net.channels) == [64, 64, 64]
    assert [b.conv0.dilation[0] for b in net.blocks] == list(jax_net.dilations) == [1, 2, 4]
    assert net.blocks[0].dropout == jax_net.dropout == 0.1
    assert (spec.windowed, spec.lookback_window, spec.loss, spec.optimizer) == (
        jax_spec.windowed, jax_spec.lookback_window, jax_spec.loss, jax_spec.optimizer
    )


def test_init_follows_flax():
    """The port's initial state has the converted Flax tree's names and
    shapes; conv and Dense weights are a normal cut at 2 sigma of
    variance 1/fan_in (kernel size x in for a conv), biases 0."""
    jax_net, port_net = _nets()
    flax_state = tcn_state_dict(
        jax_net.init(jax.random.PRNGKey(0), jnp.zeros((1, LOOKBACK, N_FEATURES)))
    )
    state = flax_default_init_(port_net, torch.Generator().manual_seed(3)).state_dict()
    assert {k: tuple(v.shape) for k, v in state.items()} == {
        k: v.shape for k, v in flax_state.items()
    }
    assert {"blocks.0.residual_proj.weight", "blocks.1.residual_proj.weight"} <= set(state)
    for name, value in state.items():
        value = value.double()
        if name.endswith("weight"):
            fan_in = value[0].numel()
            assert value.abs().max() <= 2.0 / np.sqrt(fan_in) / 0.87962566103423978 + 1e-7
            assert value.std() > 0.5 / np.sqrt(fan_in), name
        else:
            assert not value.any(), name


def test_no_projection_where_the_channels_agree():
    net = TCNNet(8, (8, 8), 3, (1, 2), 8)
    assert not any("residual_proj" in name for name in net.state_dict())


@pytest.mark.parametrize("func", ["relu", "tanh"])
def test_forward_float32_matches_flax(func):
    jax_net, port_net = _nets(func=func)
    x = _windows(1)
    params = jax_net.init(jax.random.PRNGKey(2), jnp.asarray(x[:1]))
    want, want_penalty = jax_net.apply(params, jnp.asarray(x))
    out, penalty = _load(port_net, params)(torch.from_numpy(x))
    assert out.dtype == torch.float32 and out.shape == (len(x), N_FEATURES)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=1e-5)
    assert penalty.item() == float(want_penalty) == 0.0


@pytest.mark.parametrize("seed", [0, 6])
def test_forward_bfloat16_matches_flax(seed):
    jax_net, port_net = _nets(jnp.bfloat16, torch.bfloat16)
    x = _windows(seed)
    params = jax_net.init(jax.random.PRNGKey(seed), jnp.asarray(x[:1]))
    got = _load(port_net, params)(torch.from_numpy(x))[0].detach().numpy()
    with jax.disable_jit():
        want = np.asarray(jax_net.apply(params, jnp.asarray(x))[0])
    np.testing.assert_allclose(got, want, atol=2.0**-7 * np.abs(want).max(), rtol=0)


def test_dropout_acts_only_in_training():
    port_net = TCNNet(N_FEATURES, dropout=0.5, **NET)
    flax_default_init_(port_net, torch.Generator().manual_seed(0))
    x = torch.from_numpy(_windows(4))
    eval_out = port_net.eval()(x)[0]
    assert torch.equal(eval_out, port_net(x)[0])
    port_net.train()
    a = port_net(x, generator=torch.Generator().manual_seed(1))[0]
    b = port_net(x, generator=torch.Generator().manual_seed(1))[0]
    assert torch.equal(a, b) and not torch.allclose(a, eval_out)


@pytest.mark.parametrize("model_type", list(ESTIMATORS))
def test_fit_from_jax_init_matches_jax(model_type):
    # 80 rows -> 71 or 70 windows: a ragged last batch
    X = _series(80, N_FEATURES, seed=5)
    kwargs = dict(kind="tcn_model", lookback_window=LOOKBACK, channels=(8, 12),
                  dilations=(1, 2), dropout=0.0, epochs=2, batch_size=16, seed=3)
    jax_cls, (port_cls, _) = getattr(jax_models, model_type), ESTIMATORS[model_type]
    jax_est = jax_cls(**kwargs).fit(X, X)
    init = jax_cls(n_features=N_FEATURES, n_features_out=N_FEATURES, **kwargs)._build_spec()
    state = tcn_state_dict(init.module.init(solo_init_key(3), jnp.zeros((1, LOOKBACK, N_FEATURES))))
    port = port_cls(**kwargs)
    port._initial_state = lambda spec, seed: {k: torch.tensor(v) for k, v in state.items()}
    port.fit(X, X, device="cpu")
    np.testing.assert_allclose(port.history_["loss"], jax_est.history_["loss"], rtol=1e-4)
    assert port.history_["params"] == jax_est.history_["params"]
    want = tcn_state_dict(jax_est.params_)
    got = port.spec_.module.state_dict()
    assert set(got) == set(want)
    for name, value in want.items():
        np.testing.assert_allclose(got[name].numpy(), value, atol=1e-4, err_msg=name)


@pytest.fixture(scope="module", params=list(ESTIMATORS))
def fitted_pair(request):
    """(JAX estimator fitted for 1 epoch, the port's copy of it)."""
    name = request.param
    kwargs = dict(kind="tcn_model", lookback_window=LOOKBACK, channels=(6, 6), epochs=1,
                  batch_size=32, seed=1)
    X = _series(120, 5, seed=7)
    jax_est = getattr(jax_models, name)(**kwargs).fit(X, X)
    port = model_from_flax(jax_est.params_, into_definition(jax_est), device="cpu")
    assert type(port) is ESTIMATORS[name][0]
    return jax_est, port


def test_estimator_predict_and_score_match_jax(fitted_pair):
    jax_est, port = fitted_pair
    rows = _series(200, 5, seed=8)
    got, want = port.predict(rows), jax_est.predict(rows)
    assert port.lookahead == jax_est.lookahead
    assert got.shape == want.shape == (200 - LOOKBACK + 1 - jax_est.lookahead, 5)
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(
        port.score(rows, rows), jax_est.score(rows, rows), rtol=1e-5, atol=1e-6
    )
    assert port.get_metadata()["forecast_steps"] == jax_est.lookahead
    with pytest.raises(ValueError) as jax_err:
        jax_est.predict(rows[: LOOKBACK - 1])
    with pytest.raises(ValueError) as port_err:
        port.predict(rows[: LOOKBACK - 1])
    assert str(port_err.value) == str(jax_err.value)


def test_estimator_serializer_roundtrip(fitted_pair, tmp_path):
    _, port = fitted_pair
    rows = _series(60, 5, seed=9)
    serializer.dump(port, tmp_path / "machine", {"name": "machine"})
    definition = json.loads((tmp_path / "machine" / "definition.json").read_text())
    assert list(definition) == [f"gordo_tpu_torch.models.models.{type(port).__name__}"]
    again = serializer.load(tmp_path / "machine", device="cpu")
    assert type(again) is type(port)
    np.testing.assert_array_equal(again.predict(rows), port.predict(rows))
    again = serializer.loads(serializer.dumps(tmp_path / "machine"), device="cpu")
    np.testing.assert_array_equal(again.predict(rows), port.predict(rows))


def test_detector_definition_builds_and_fits():
    definition = {
        "gordo_tpu.models.anomaly.DiffBasedAnomalyDetector": {
            "base_estimator": {"gordo_tpu.models.TCNAutoEncoder": {
                "kind": "tcn_model", "lookback_window": LOOKBACK, "channels": [4, 4],
                "epochs": 1}}
        }
    }
    model = serializer.from_definition(definition)
    assert type(model.base_estimator) is TCNAutoEncoder
    X = _series(60, 3, seed=10)
    model.fit(X, X, device="cpu")
    assert model.predict(X).shape == (60 - LOOKBACK + 1, 3)
