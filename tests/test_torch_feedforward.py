"""
The feedforward family (``AutoEncoder`` with the ``feedforward_*``
factories and ``FeedForwardNet``) against the JAX package's.

Tolerances: the net's output and L1 penalty from one converted Flax tree
at 1e-6 (float32, another summation order); ``fit`` from the JAX init
with the same batches (no shuffle: the two packages' permutations
differ) with epoch losses at rtol 1e-4 and parameters at atol 1e-4 after
two epochs of Adam, float32 rounding compounded over the steps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gordo_tpu.models import AutoEncoder as JaxAutoEncoder
from gordo_tpu.models.core import solo_init_key
from gordo_tpu.models.factories.utils import hourglass_calc_dims as jax_hourglass_calc_dims
from gordo_tpu.serializer import into_definition
from gordo_tpu_torch.convert import feedforward_state_dict, model_from_flax
from gordo_tpu_torch.models import AutoEncoder
from gordo_tpu_torch.models.factories.utils import hourglass_calc_dims
from gordo_tpu_torch.models.register import register_model_builder
from gordo_tpu_torch.ops.activations import resolve_activation

torch.backends.cuda.matmul.allow_tf32 = False
# the models here are tiny: one thread runs them as fast as many, and
# leaves the cores to the other test workers
torch.set_num_threads(1)

KINDS = {
    "hourglass-3": ("feedforward_hourglass", {}, 3),
    "hourglass-10": (
        "feedforward_hourglass", {"compression_factor": 0.2, "encoding_layers": 4}, 10
    ),
    "hourglass-relu": ("feedforward_hourglass", {"func": "relu", "encoding_layers": 1}, 6),
    "symmetric": ("feedforward_symmetric", {"dims": (8, 4), "funcs": ("tanh", "relu")}, 5),
    "model": (
        "feedforward_model",
        {
            "encoding_dim": (6, 3, 2),
            "encoding_func": ("tanh", "elu", "linear"),
            "decoding_dim": (4,),
            "decoding_func": ("sigmoid",),
            "out_func": "tanh",
        },
        4,
    ),
}


def _modules(kind, kwargs, n_features):
    """(JAX FeedForwardNet, port FeedForwardNet) of one definition."""
    jax_est = JaxAutoEncoder(kind, n_features=n_features, **kwargs)
    port_est = AutoEncoder(kind, n_features=n_features, **kwargs)
    return jax_est._build_spec().module, port_est._build_spec().module


def _rows(n_rows, n_features, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n_rows)[:, None]
    wave = np.sin(2 * np.pi * t / 144 + np.arange(n_features))
    return (wave + 0.1 * rng.normal(size=(n_rows, n_features))).astype(np.float32)


def test_feedforward_kinds_are_registered():
    assert {"feedforward_model", "feedforward_symmetric", "feedforward_hourglass"} <= set(
        register_model_builder.factories["AutoEncoder"]
    )


@pytest.mark.parametrize(
    "args", [(0.5, 3, 10), (0.2, 3, 10), (0.5, 1, 10), (0.5, 3, 3), (1.0, 2, 7), (0.0, 5, 4)]
)
def test_hourglass_dims_match_jax(args):
    assert hourglass_calc_dims(*args) == jax_hourglass_calc_dims(*args)


@pytest.mark.parametrize("name", list(KINDS))
def test_factory_dims_match_jax(name):
    kind, kwargs, n_features = KINDS[name]
    jax_net, port_net = _modules(kind, kwargs, n_features)
    widths = [layer.out_features for layer in port_net.layers]
    assert widths == [*jax_net.layer_dims, jax_net.out_dim]
    assert port_net.layers[0].in_features == n_features
    assert port_net.l1_flags == (*jax_net.l1_flags, False)
    funcs = [resolve_activation(f) for f in (*jax_net.layer_funcs, jax_net.out_func)]
    assert port_net.funcs == funcs


def test_default_pipeline_machine_dims():
    """pump-4130's 3 tags: (3, 2, 2) -> (2, 2, 3), then the output."""
    _, port_net = _modules("feedforward_hourglass", {}, 3)
    assert [layer.out_features for layer in port_net.layers] == [3, 2, 2, 2, 2, 3, 3]


@pytest.mark.parametrize(
    "kind,kwargs",
    [
        ("feedforward_model", {"encoding_dim": (3, 2), "encoding_func": ("tanh",)}),
        ("feedforward_model", {"decoding_dim": (3,), "decoding_func": ("tanh", "tanh")}),
        ("feedforward_symmetric", {"dims": ()}),
        ("feedforward_hourglass", {"compression_factor": 1.5}),
        ("feedforward_hourglass", {"encoding_layers": 0}),
    ],
)
def test_factory_checks_match_jax(kind, kwargs):
    with pytest.raises(ValueError) as jax_err:
        JaxAutoEncoder(kind, n_features=4, **kwargs)._build_spec()
    with pytest.raises(ValueError) as port_err:
        AutoEncoder(kind, n_features=4, **kwargs)._build_spec()
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("name", list(KINDS))
def test_net_output_and_penalty_match_flax(name):
    kind, kwargs, n_features = KINDS[name]
    jax_net, port_net = _modules(kind, kwargs, n_features)
    x = np.random.default_rng(1).normal(size=(37, n_features)).astype(np.float32)
    params = jax_net.init(solo_init_key(4), jnp.asarray(x[:1]))
    want_out, want_penalty = jax_net.apply(params, jnp.asarray(x))
    state = feedforward_state_dict(params)
    port_net.load_state_dict({k: torch.tensor(v) for k, v in state.items()})
    out, penalty = port_net(torch.from_numpy(x))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), atol=1e-6)
    np.testing.assert_allclose(penalty.item(), float(want_penalty), rtol=1e-6, atol=1e-9)
    assert (float(want_penalty) > 0) == any(jax_net.l1_flags)


def _jax_initial_state(self, spec, seed):
    """The JAX init a solo JAX fit of these kwargs and seed starts from."""
    module = JaxAutoEncoder(self.kind, **self.kwargs)._build_spec().module
    params = module.init(solo_init_key(seed), jnp.zeros((1, self.kwargs["n_features"])))
    return {k: torch.tensor(v) for k, v in feedforward_state_dict(params).items()}


@pytest.mark.parametrize(
    "kind,kwargs,fit_kwargs",
    [
        ("feedforward_hourglass", {}, {}),
        ("feedforward_hourglass", {"optimizer": "sgd", "optimizer_kwargs": {"lr": 0.05}}, {}),
        ("feedforward_symmetric", {"dims": (6, 3), "funcs": ("tanh", "tanh")},
         {"validation_split": 0.2}),
    ],
)
def test_fit_from_jax_init_matches_jax(kind, kwargs, fit_kwargs, monkeypatch):
    # 213 rows: a ragged last batch of 21 (213 = 6 * 32 + 21)
    X = _rows(213, 5, seed=2)
    common = dict(epochs=2, batch_size=32, seed=9, shuffle=False, **kwargs)
    jax_est = JaxAutoEncoder(kind, **common).fit(X, X, **fit_kwargs)
    monkeypatch.setattr(AutoEncoder, "_initial_state", _jax_initial_state)
    port = AutoEncoder(kind, **common).fit(X, X, device="cpu", **fit_kwargs)
    np.testing.assert_allclose(port.history_["loss"], jax_est.history_["loss"], rtol=1e-4)
    if fit_kwargs:
        np.testing.assert_allclose(
            port.history_["val_loss"], jax_est.history_["val_loss"], rtol=1e-4
        )
    assert port.history_["params"] == jax_est.history_["params"]
    want = feedforward_state_dict(jax_est.params_)
    got = port.spec_.module.state_dict()
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_allclose(got[key].numpy(), value, atol=1e-4, err_msg=key)


def test_predict_score_transform_match_jax():
    X = _rows(300, 4, seed=3)
    jax_est = JaxAutoEncoder("feedforward_hourglass", epochs=1, seed=1).fit(X, X)
    port = model_from_flax(jax_est.params_, into_definition(jax_est), device="cpu")
    assert isinstance(port, AutoEncoder)
    rows = _rows(1000, 4, seed=4)
    np.testing.assert_allclose(port.predict(rows), jax_est.predict(rows), atol=1e-6)
    np.testing.assert_allclose(port.transform(rows), jax_est.transform(rows), atol=1e-6)
    np.testing.assert_allclose(port.score(rows, rows), jax_est.score(rows, rows), rtol=1e-5)
    assert port.predict(rows[:0]).shape == (0, 4)
