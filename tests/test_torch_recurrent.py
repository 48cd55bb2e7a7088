"""
The recurrent family (``LSTMNet`` with LSTM and GRU cells, the
``lstm_*``/``gru_*`` factories and the four estimators) against the JAX
package's, in all six Flax layouts: each cell unfused, fused under the
``layer`` schedule and fused under the ``stacked`` schedule.

Inputs and Flax parameters come from numpy and JAX seeds and go to both
sides through ``gordo_tpu_torch.convert``. Tolerances:

- forward in float32: atol 1e-5 (the same arithmetic, another summation
  order);
- forward in bfloat16: within 2^-7 of the largest output against the JAX
  net run op by op (``jax.disable_jit``), which rounds where the port
  rounds. XLA's compiled scan fuses the step's elementwise work and keeps
  some of it in float32, so the compiled reference differs from its own
  op-by-op run by more than 2^-7 of the largest output at some seeds.
  Against the compiled run the port is held to 2^-5 (8 bfloat16 steps);
- ``fit`` from the JAX init with the same batches: epoch losses rtol
  1e-4, parameters atol 1e-4 after 2 epochs of Adam;
- estimators' ``predict`` atol 1e-5 and ``score`` rtol 1e-5 with atol
  1e-6 (an explained variance near 0 after one epoch cancels to a few
  digits).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gordo_tpu import models as jax_models
from gordo_tpu.models.core import solo_init_key
from gordo_tpu.models.specs import LSTMNet as JaxLSTMNet
from gordo_tpu.serializer import into_definition
from gordo_tpu_torch import serializer
from gordo_tpu_torch.convert import model_from_flax, recurrent_state_dict
from gordo_tpu_torch.models import (
    GRUAutoEncoder,
    GRUForecast,
    KerasLSTMAutoEncoder,
    LSTMAutoEncoder,
    LSTMForecast,
)
from gordo_tpu_torch.models.anomaly import DiffBasedAnomalyDetector
from gordo_tpu_torch.models.register import register_model_builder
from gordo_tpu_torch.models.specs import LSTMNet, flax_default_init_

torch.backends.cuda.matmul.allow_tf32 = False
# the models here are tiny: one thread runs them as fast as many, and
# leaves the cores to the other test workers
torch.set_num_threads(1)

N_FEATURES, LOOKBACK = 4, 6
DIMS = (8, 4, 4, 8)
FUNCS = ("tanh",) * 4
#: (fused, schedule) of each Flax layout
LAYOUTS = {"unfused": (False, "layer"), "fused": (True, "layer"), "stacked": (True, "stacked")}
CASES = [(cell, layout) for cell in ("lstm", "gru") for layout in LAYOUTS]
CASE_IDS = [f"{cell}-{layout}" for cell, layout in CASES]
ESTIMATORS = {
    "LSTMAutoEncoder": (LSTMAutoEncoder, "lstm_model"),
    "LSTMForecast": (LSTMForecast, "lstm_hourglass"),
    "GRUAutoEncoder": (GRUAutoEncoder, "gru_symmetric"),
    "GRUForecast": (GRUForecast, "gru_hourglass"),
}


def _series(n_rows, n_features, seed):
    """Daily-cycle sensor rows with noise, float32."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_rows)[:, None]
    wave = np.sin(2 * np.pi * t / 144 + np.arange(n_features))
    return (wave + 0.1 * rng.normal(size=(n_rows, n_features))).astype(np.float32)


def _nets(cell, layout, jax_dtype=jnp.float32, torch_dtype=torch.float32):
    fused, schedule = LAYOUTS[layout]
    common = dict(out_dim=N_FEATURES, fused=fused, cell=cell, schedule=schedule)
    jax_net = JaxLSTMNet(layer_dims=DIMS, layer_funcs=FUNCS, dtype=jax_dtype, **common)
    port_net = LSTMNet(N_FEATURES, DIMS, FUNCS, dtype=torch_dtype, **common)
    return jax_net, port_net


def _windows(seed, n=30):
    return np.random.default_rng(seed).normal(size=(n, LOOKBACK, N_FEATURES)).astype(np.float32)


def _load(port_net, params):
    port_net.load_state_dict({k: torch.tensor(v) for k, v in recurrent_state_dict(params).items()})
    return port_net


# -- factories, checks and initialisation ------------------------------------


@pytest.mark.parametrize("model_type", list(ESTIMATORS))
def test_recurrent_kinds_are_registered(model_type):
    family = "lstm" if model_type.startswith("LSTM") else "gru"
    assert set(register_model_builder.factories[model_type]) == {
        f"{family}_model", f"{family}_symmetric", f"{family}_hourglass"
    }


@pytest.mark.parametrize("model_type", ["LSTMAutoEncoder", "GRUForecast"])
@pytest.mark.parametrize(
    "kind,kwargs",
    [
        ("model", {"encoding_dim": (3, 2), "encoding_func": ("tanh",)}),
        ("model", {"decoding_dim": (3,), "decoding_func": ("tanh", "tanh")}),
        ("symmetric", {"dims": ()}),
        ("hourglass", {"compression_factor": 1.5}),
        ("hourglass", {"encoding_layers": 0}),
    ],
)
def test_factory_checks_match_jax(model_type, kind, kwargs):
    family = "lstm" if model_type.startswith("LSTM") else "gru"
    jax_cls = getattr(jax_models, model_type)
    port_cls = ESTIMATORS[model_type][0]
    with pytest.raises(ValueError) as jax_err:
        jax_cls(f"{family}_{kind}", n_features=4, **kwargs)._build_spec()
    with pytest.raises(ValueError) as port_err:
        port_cls(f"{family}_{kind}", n_features=4, **kwargs)._build_spec()
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize(
    "kwargs",
    [
        {"cell": "rnn"},
        {"schedule": "diagonal"},
        {"schedule": "stacked", "fused": False},
    ],
)
def test_net_errors_match_jax(kwargs):
    jax_kwargs = dict(layer_dims=DIMS, layer_funcs=FUNCS, out_dim=3, **kwargs)
    with pytest.raises(ValueError) as jax_err:
        JaxLSTMNet(**jax_kwargs).init(jax.random.PRNGKey(0), jnp.zeros((1, LOOKBACK, 3)))
    with pytest.raises(ValueError) as port_err:
        LSTMNet(3, DIMS, FUNCS, 3, **kwargs)
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("cell,layout", CASES, ids=CASE_IDS)
def test_init_follows_flax(cell, layout):
    """The port's initial state has the converted Flax tree's names and
    shapes; recurrent kernels are orthogonal (orthonormal rows or
    columns, whichever side is shorter), input kernels a normal cut at
    2 sigma of variance 1/fan_in, biases 0; a seed gives one state."""
    jax_net, port_net = _nets(cell, layout)
    flax_state = recurrent_state_dict(
        jax_net.init(jax.random.PRNGKey(0), jnp.zeros((1, LOOKBACK, N_FEATURES)))
    )
    state = flax_default_init_(port_net, torch.Generator().manual_seed(3)).state_dict()
    assert {k: tuple(v.shape) for k, v in state.items()} == {
        k: v.shape for k, v in flax_state.items()
    }
    again = flax_default_init_(_nets(cell, layout)[1], torch.Generator().manual_seed(3))
    assert all(torch.equal(v, again.state_dict()[k]) for k, v in state.items())
    for name, value in state.items():
        value = value.double()
        if "recurrent_kernel" in name or ".gates.h" in name and name.endswith("weight"):
            # Flax layout (in, out) for raw kernels, torch (out, in) for Denses
            kernel = value if "recurrent_kernel" in name else value.T
            small = min(kernel.shape)
            gram = kernel @ kernel.T if kernel.shape[0] == small else kernel.T @ kernel
            np.testing.assert_allclose(gram.numpy(), np.eye(small), atol=1e-6, err_msg=name)
        elif name.endswith("weight") or "input_kernel" in name:
            fan_in = value.shape[1] if name.endswith("weight") else value.shape[0]
            bound = 2.0 / np.sqrt(fan_in) / 0.87962566103423978
            assert value.abs().max() <= bound + 1e-7, name
            assert value.std() > 0.5 / np.sqrt(fan_in), name
        else:
            assert not value.any(), name


# -- forward -----------------------------------------------------------------


@pytest.mark.parametrize("cell,layout", CASES, ids=CASE_IDS)
def test_forward_float32_matches_flax(cell, layout):
    jax_net, port_net = _nets(cell, layout)
    x = _windows(1)
    params = jax_net.init(jax.random.PRNGKey(2), jnp.asarray(x[:1]))
    want, want_penalty = jax_net.apply(params, jnp.asarray(x))
    out, penalty = _load(port_net, params)(torch.from_numpy(x))
    assert out.dtype == torch.float32 and out.shape == (len(x), N_FEATURES)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=1e-5)
    assert penalty.item() == float(want_penalty) == 0.0


@pytest.mark.parametrize("cell,layout", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("seed", [0, 6])
def test_forward_bfloat16_matches_flax(cell, layout, seed):
    jax_net, port_net = _nets(cell, layout, jnp.bfloat16, torch.bfloat16)
    x = _windows(seed)
    params = jax_net.init(jax.random.PRNGKey(seed), jnp.asarray(x[:1]))
    got = _load(port_net, params)(torch.from_numpy(x))[0].detach().numpy()
    with jax.disable_jit():
        op_by_op = np.asarray(jax_net.apply(params, jnp.asarray(x))[0])
    compiled = np.asarray(jax_net.apply(params, jnp.asarray(x))[0])
    scale = np.abs(op_by_op).max()
    np.testing.assert_allclose(got, op_by_op, atol=2.0**-7 * scale, rtol=0)
    np.testing.assert_allclose(got, compiled, atol=2.0**-5 * scale, rtol=0)


def test_time_unroll_is_kept_and_changes_nothing():
    x = torch.from_numpy(_windows(3))
    nets = [LSTMNet(N_FEATURES, DIMS, FUNCS, 2, fused=True, time_unroll=u) for u in (1, 8)]
    flax_default_init_(nets[0], torch.Generator().manual_seed(0))
    nets[1].load_state_dict(nets[0].state_dict())
    assert nets[1].time_unroll == 8
    assert torch.equal(nets[0](x)[0], nets[1](x)[0])
    est = LSTMAutoEncoder("lstm_model", fused=True, time_unroll=4)
    assert serializer.from_definition(json.loads(json.dumps(est.into_definition()))).kwargs[
        "time_unroll"
    ] == 4


# -- fit ---------------------------------------------------------------------


def _estimator_kwargs(cell, layout, **extra):
    fused, schedule = LAYOUTS[layout]
    return dict(
        kind=f"{cell}_model", lookback_window=LOOKBACK, encoding_dim=DIMS[:2],
        encoding_func=FUNCS[:2], decoding_dim=DIMS[2:], decoding_func=FUNCS[2:],
        fused=fused, schedule=schedule, **extra,
    )


@pytest.mark.parametrize("cell,layout", CASES, ids=CASE_IDS)
def test_fit_from_jax_init_matches_jax(cell, layout):
    # 80 rows -> 75 windows: a ragged last batch (75 = 4 * 16 + 11)
    X = _series(80, N_FEATURES, seed=5)
    kwargs = _estimator_kwargs(cell, layout, epochs=2, batch_size=16, seed=3)
    jax_cls = jax_models.LSTMAutoEncoder if cell == "lstm" else jax_models.GRUAutoEncoder
    port_cls = LSTMAutoEncoder if cell == "lstm" else GRUAutoEncoder
    jax_est = jax_cls(**kwargs).fit(X, X)
    init = jax_cls(n_features=N_FEATURES, n_features_out=N_FEATURES, **kwargs)._build_spec()
    state = recurrent_state_dict(
        init.module.init(solo_init_key(3), jnp.zeros((1, LOOKBACK, N_FEATURES)))
    )
    port = port_cls(**kwargs)
    port._initial_state = lambda spec, seed: {k: torch.tensor(v) for k, v in state.items()}
    port.fit(X, X, device="cpu")
    np.testing.assert_allclose(port.history_["loss"], jax_est.history_["loss"], rtol=1e-4)
    assert port.history_["params"] == jax_est.history_["params"]
    want = recurrent_state_dict(jax_est.params_)
    got = port.spec_.module.state_dict()
    assert set(got) == set(want)
    for name, value in want.items():
        np.testing.assert_allclose(got[name].numpy(), value, atol=1e-4, err_msg=name)


# -- estimators --------------------------------------------------------------


@pytest.fixture(scope="module", params=list(ESTIMATORS))
def fitted_pair(request):
    """(JAX estimator fitted for 1 epoch, the port's copy of it)."""
    name = request.param
    port_cls, kind = ESTIMATORS[name]
    kwargs = dict(kind=kind, lookback_window=LOOKBACK, epochs=1, batch_size=32, seed=1)
    if kind.endswith("symmetric"):
        kwargs.update(dims=(6, 3), funcs=("tanh", "tanh"))
    X = _series(120, 5, seed=7)
    jax_est = getattr(jax_models, name)(**kwargs).fit(X, X)
    port = model_from_flax(jax_est.params_, into_definition(jax_est), device="cpu")
    assert type(port) is port_cls
    return jax_est, port


def test_estimator_predict_and_score_match_jax(fitted_pair):
    jax_est, port = fitted_pair
    rows = _series(200, 5, seed=8)
    got, want = port.predict(rows), jax_est.predict(rows)
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
    again = serializer.load(tmp_path / "machine", device="cpu")
    assert type(again) is type(port)
    np.testing.assert_array_equal(again.predict(rows), port.predict(rows))
    again = serializer.loads(serializer.dumps(tmp_path / "machine"), device="cpu")
    np.testing.assert_array_equal(again.predict(rows), port.predict(rows))


@pytest.mark.parametrize(
    "path", ["gordo_tpu.models.KerasLSTMAutoEncoder", "gordo_tpu_torch.models.KerasLSTMAutoEncoder"]
)
def test_aliased_definition_loads(path, tmp_path):
    """A definition naming the reference's ``KerasLSTMAutoEncoder`` builds
    the port's LSTMAutoEncoder, which fits, dumps and loads back."""
    definition = {
        "gordo_tpu_torch.models.anomaly.DiffBasedAnomalyDetector": {
            "base_estimator": {path: {"kind": "lstm_hourglass", "lookback_window": LOOKBACK,
                                      "epochs": 1}}
        }
    }
    model = serializer.from_definition(definition)
    assert isinstance(model, DiffBasedAnomalyDetector)
    assert KerasLSTMAutoEncoder is LSTMAutoEncoder
    assert type(model.base_estimator) is LSTMAutoEncoder
    X = _series(60, 3, seed=10)
    model.fit(X, X, device="cpu")
    serializer.dump(model, tmp_path / "m", {})
    again = serializer.load(tmp_path / "m", device="cpu")
    np.testing.assert_array_equal(again.predict(X), model.predict(X))
