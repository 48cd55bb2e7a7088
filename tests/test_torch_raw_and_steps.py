"""
The raw regressor and the remaining pipeline steps against the JAX
package's: ``SequentialNet`` for each layer kind, ``RawModelRegressor``
(its legacy Keras spec too), ``InfImputer`` with both strategies, and a
``Pipeline`` with ``FunctionTransformer(multiply_by)``.

Inputs and Flax parameters come from numpy and JAX seeds and go to both
sides through ``gordo_tpu_torch.convert``. Tolerances: forwards and
predictions atol 1e-5 (float32, another summation order); ``fit`` from
the JAX init with shuffle off: epoch losses rtol 1e-4; the imputer and
``multiply_by`` exactly (the same float64 numpy arithmetic).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from gordo_tpu.models.core import solo_init_key
from gordo_tpu.models.models import RawModelRegressor as JaxRawModelRegressor
from gordo_tpu.models.models import _parse_raw_layer as jax_parse_raw_layer
from gordo_tpu.models.specs import SequentialNet as JaxSequentialNet
from gordo_tpu.models.transformer_funcs.general import multiply_by as jax_multiply_by
from gordo_tpu.models.transformers import InfImputer as JaxInfImputer
from gordo_tpu.serializer import from_definition as jax_from_definition
from gordo_tpu.serializer import into_definition
from gordo_tpu_torch import serializer
from gordo_tpu_torch.convert import model_from_flax, sequential_state_dict
from gordo_tpu_torch.models import (
    AutoEncoder,
    FunctionTransformer,
    KerasRawModelRegressor,
    Pipeline,
    RawModelRegressor,
)
from gordo_tpu_torch.models.models import _parse_raw_layer
from gordo_tpu_torch.models.specs import SequentialNet
from gordo_tpu_torch.models.transformer_funcs import resolve_function
from gordo_tpu_torch.models.transformer_funcs.general import multiply_by
from gordo_tpu_torch.models.transformers import InfImputer
from tests.test_torch_pipeline import SCALER_ATTRS, _jax_initial_state

torch.set_num_threads(1)

RAW_SPEC = {  # tests/test_models.py's raw regressor
    "compile": {"loss": "mse", "optimizer": "adam"},
    "spec": {"layers": [{"Dense": {"units": 8, "activation": "tanh"}}, {"Dense": {"units": 1}}]},
}
LEGACY_SPEC = {
    "compile": {"loss": "mse", "optimizer": {"tensorflow.keras.optimizers.Adam": {"lr": 0.01}}},
    "spec": {
        "tensorflow.keras.models.Sequential": {
            "layers": [
                {"tensorflow.keras.layers.Dense": {"units": 4, "activation": "relu"}},
                # rate 0: training masks come from different generators
                {"tensorflow.keras.layers.Dropout": {"rate": 0.0}},
                {"tensorflow.keras.layers.Dense": {"units": 1}},
            ]
        }
    },
}


def _layers(entries):
    return tuple((kind, tuple(sorted(kwargs.items()))) for kind, kwargs in entries)


# (name, layer list, input shape): every layer kind, in 2-D and 3-D input
NETS = [
    ("dense", _layers([("dense", {"units": 8, "activation": "tanh"}), ("dense", {"units": 1})]),
     (20, 4)),
    ("lstm", _layers([("dense", {"units": 5, "activation": "relu"}),
                      ("lstm", {"units": 6, "return_sequences": True}),
                      ("lstm", {"units": 3, "activation": "tanh"}),
                      ("dropout", {"rate": 0.3}), ("activation", {"activation": "tanh"}),
                      ("dense", {"units": 2})]), (20, 7, 4)),
    ("lstm-sequences", _layers([("lstm", {"units": 3, "return_sequences": True}),
                                ("dense", {"units": 2})]), (20, 5, 4)),
    ("flatten", _layers([("dense", {"units": 5}), ("flatten", {}), ("dense", {"units": 2})]),
     (20, 6, 3)),
    ("flat-input", _layers([("dropout", {}), ("dense", {"units": 4}),
                            ("activation", {"activation": "relu"}), ("flatten", {}),
                            ("dense", {"units": 3})]), (20, 4)),
]


@pytest.mark.parametrize("name,layers,shape", NETS, ids=[n[0] for n in NETS])
def test_sequential_net_matches_flax(name, layers, shape):
    x = np.random.default_rng(len(name)).normal(size=shape).astype(np.float32)
    jax_net = JaxSequentialNet(layers=layers)
    params = jax_net.init(jax.random.PRNGKey(1), jnp.asarray(x[:1]))
    want, want_penalty = jax_net.apply(params, jnp.asarray(x))
    net = SequentialNet(shape[-1], layers, n_steps=shape[1] if len(shape) == 3 else None)
    state = sequential_state_dict(params)
    assert {k: tuple(v.shape) for k, v in net.state_dict().items()} == {
        k: v.shape for k, v in state.items()
    }
    net.load_state_dict({k: torch.tensor(v) for k, v in state.items()})
    out, penalty = net.eval()(torch.from_numpy(x))
    assert out.dtype == torch.float32 and tuple(out.shape) == want.shape
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=1e-5)
    assert penalty.item() == float(want_penalty) == 0.0


def test_sequential_net_refuses_what_it_cannot_size():
    with pytest.raises(ValueError, match="lstm layer needs"):
        SequentialNet(4, _layers([("lstm", {"units": 3})]))
    with pytest.raises(ValueError, match="Unknown raw layer type"):
        SequentialNet(4, _layers([("conv", {})]))


@pytest.mark.parametrize(
    "entry",
    ["Dense", {"tensorflow.keras.layers.Dense": {"units": 2}}, {"LSTM": {"units": 3}},
     "keras.layers.Flatten", {"Dropout": None}],
)
def test_raw_layers_parse_as_jax(entry):
    assert _parse_raw_layer(copy.deepcopy(entry)) == jax_parse_raw_layer(copy.deepcopy(entry))


@pytest.mark.parametrize("entry", [{"Conv1D": {}}, {"a": {}, "b": {}}, 5])
def test_raw_layer_errors_match_jax(entry):
    with pytest.raises(ValueError) as jax_err:
        jax_parse_raw_layer(entry)
    with pytest.raises(ValueError) as port_err:
        _parse_raw_layer(entry)
    assert str(port_err.value) == str(jax_err.value)


def test_raw_regressor_refuses_a_spec_without_its_keys_as_jax():
    X = np.zeros((8, 3), dtype=np.float32)
    with pytest.raises(ValueError) as jax_err:
        JaxRawModelRegressor(kind={"spec": RAW_SPEC["spec"]}).fit(X, X[:, :1])
    with pytest.raises(ValueError) as port_err:
        RawModelRegressor(kind={"spec": RAW_SPEC["spec"]}).fit(X, X[:, :1], device="cpu")
    assert str(port_err.value) == str(jax_err.value)


def _raw_jax_initial_state(self, spec, seed):
    """The JAX init a solo JAX fit of this raw regressor and seed starts from."""
    module = JaxRawModelRegressor(self.kind, **self.kwargs)._build_spec().module
    params = module.init(solo_init_key(seed), jnp.zeros((1, self.kwargs["n_features"])))
    return {k: torch.tensor(v) for k, v in sequential_state_dict(params).items()}


@pytest.mark.parametrize("spec", [RAW_SPEC, LEGACY_SPEC], ids=["raw", "legacy-keras"])
def test_raw_regressor_fit_and_predict_match_jax(spec, monkeypatch):
    rng = np.random.default_rng(3)
    X = rng.random((50, 4)).astype(np.float32)
    y = (X @ rng.random((4, 1)) + 0.1).astype(np.float32)
    kwargs = dict(epochs=3, batch_size=16, shuffle=False, seed=2)
    jax_est = JaxRawModelRegressor(kind=copy.deepcopy(spec), **kwargs).fit(X, y)
    monkeypatch.setattr(RawModelRegressor, "_initial_state", _raw_jax_initial_state)
    port = RawModelRegressor(kind=copy.deepcopy(spec), **kwargs).fit(X, y, device="cpu")
    np.testing.assert_allclose(port.history_["loss"], jax_est.history_["loss"], rtol=1e-4)
    np.testing.assert_allclose(port.predict(X), jax_est.predict(X), atol=1e-5)
    converted = model_from_flax(jax_est.params_, into_definition(jax_est), device="cpu")
    assert type(converted) is RawModelRegressor
    np.testing.assert_allclose(converted.predict(X), jax_est.predict(X), atol=1e-5)


def test_raw_regressor_definition_round_trips(tmp_path):
    definition = {"gordo.machine.model.models.KerasRawModelRegressor": {
        "kind": RAW_SPEC, "epochs": 1}}
    model = serializer.from_definition(definition)
    assert type(model) is RawModelRegressor and KerasRawModelRegressor is RawModelRegressor
    assert "RawModelRegressor(kind: " in repr(model)
    X = np.random.default_rng(0).random((30, 4)).astype(np.float32)
    model.fit(X, X[:, :1], device="cpu")
    assert model.predict(X).shape == (30, 1)
    serializer.dump(model, tmp_path / "m", {})
    again = serializer.load(tmp_path / "m", device="cpu")
    np.testing.assert_array_equal(again.predict(X), model.predict(X))
    assert again.kind == RAW_SPEC


# -- InfImputer ------------------------------------------------------------------


def _with_infs(seed, dtype=np.float64):
    X = np.random.default_rng(seed).normal(size=(40, 4)).astype(dtype)
    X[3, 0] = X[9, 2] = np.inf
    X[5, 0] = X[11, 3] = -np.inf
    X[:, 1] = np.inf  # a column with no finite value
    X[7, 1] = -np.inf
    return X


IMPUTERS = [
    dict(),
    dict(delta=0.5),
    dict(strategy="extremes"),
    dict(inf_fill_value=99.0, neg_inf_fill_value=-99.0),
    dict(inf_fill_value=7.0, strategy="extremes"),
]


@pytest.mark.parametrize("kwargs", IMPUTERS, ids=[str(k) for k in IMPUTERS])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_inf_imputer_matches_jax(kwargs, dtype):
    X, new = _with_infs(1, dtype), _with_infs(2, dtype)
    jax_imputer = JaxInfImputer(**kwargs).fit(X)
    imputer = InfImputer(**kwargs).fit(X)
    np.testing.assert_array_equal(imputer._posinf_fill_values, jax_imputer._posinf_fill_values)
    np.testing.assert_array_equal(imputer._neginf_fill_values, jax_imputer._neginf_fill_values)
    got, want = imputer.transform(new), jax_imputer.transform(new)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(InfImputer(**kwargs).fit_transform(pd.DataFrame(X)),
                                  JaxInfImputer(**kwargs).fit_transform(pd.DataFrame(X)))
    again = InfImputer(**kwargs).load_state_arrays(imputer.state_arrays())
    np.testing.assert_array_equal(again.transform(new), got)


def test_inf_imputer_refuses_an_unknown_strategy_as_jax():
    with pytest.raises(ValueError) as jax_err:
        JaxInfImputer(strategy="bogus").fit(np.zeros((2, 2)))
    with pytest.raises(ValueError) as port_err:
        InfImputer(strategy="bogus").fit(np.zeros((2, 2)))
    assert str(port_err.value) == str(jax_err.value)


# -- FunctionTransformer(multiply_by) ------------------------------------------------


def test_multiply_by_matches_jax():
    X = np.random.default_rng(0).normal(size=(5, 3))
    np.testing.assert_array_equal(multiply_by(X, 2.5), jax_multiply_by(X, 2.5))


@pytest.mark.parametrize(
    "path",
    ["gordo_tpu.models.transformer_funcs.general.multiply_by",
     "gordo.machine.model.transformer_funcs.general.multiply_by",
     "gordo_tpu_torch.models.transformer_funcs.general.multiply_by"],
)
def test_function_transformer_resolves_the_ported_function(path):
    step = FunctionTransformer(func=path, kw_args={"factor": 2})
    np.testing.assert_array_equal(step.fit_transform(np.array([[1.0, 2.0]])), [[2.0, 4.0]])
    assert resolve_function(path) is multiply_by


@pytest.mark.parametrize("path", ["numpy.log", "os.system", "gordo_tpu.models.nothing"])
def test_function_transformer_refuses_any_other_path(path):
    with pytest.raises(ValueError, match=path.replace(".", r"\.")):
        FunctionTransformer(func=path)


def test_function_transformer_without_func_is_the_identity():
    X = np.ones((2, 2))
    assert FunctionTransformer().transform(X) is X


def _steps_definition(**estimator):
    return {
        "sklearn.pipeline.Pipeline": {
            "steps": [
                {"gordo_tpu.models.transformers.InfImputer": {"delta": 1.0}},
                {"sklearn.preprocessing.FunctionTransformer": {
                    "func": "gordo_tpu.models.transformer_funcs.general.multiply_by",
                    "kw_args": {"factor": 2}}},
                "sklearn.preprocessing.MinMaxScaler",
                {"gordo_tpu.models.AutoEncoder": {"kind": "feedforward_hourglass", **estimator}},
            ]
        }
    }


def _step_arrays(jax_pipe):
    """Each JAX step's fitted arrays, named as the port's steps name them."""
    arrays = []
    for _, step in jax_pipe.steps[:-1]:
        if isinstance(step, JaxInfImputer):
            arrays.append({"posinf_fill_values": step._posinf_fill_values,
                           "neginf_fill_values": step._neginf_fill_values})
        elif hasattr(step, "data_min_"):
            arrays.append({attr: getattr(step, attr) for attr in SCALER_ATTRS})
        else:
            arrays.append({})
    return arrays


@pytest.fixture(scope="module")
def pipeline_pair():
    """(JAX pipeline, the port's pipeline fitted from the JAX init, X)."""
    X = _with_infs(3)[:, [0, 2, 3]]
    X[:, 1] *= 50.0
    definition = _steps_definition(epochs=2, batch_size=8, shuffle=False, seed=4)
    jax_pipe = jax_from_definition(copy.deepcopy(definition)).fit(X, X)
    port_pipe = serializer.from_definition(definition)
    assert [type(step).__name__ for _, step in port_pipe.steps] == [
        "InfImputer", "FunctionTransformer", "MinMaxScaler", "AutoEncoder"
    ]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(AutoEncoder, "_initial_state", _jax_initial_state)
        port_pipe.fit(X, X, device="cpu")
    return jax_pipe, port_pipe, X


def test_pipeline_with_function_transformer_fits_as_jax(pipeline_pair):
    jax_pipe, port_pipe, X = pipeline_pair
    np.testing.assert_allclose(port_pipe.steps[-1][1].history_["loss"],
                               jax_pipe.steps[-1][1].history_["loss"], rtol=1e-4)
    np.testing.assert_allclose(port_pipe.predict(X), jax_pipe.predict(X), atol=1e-5)


def test_pipeline_with_function_transformer_converts_and_round_trips(pipeline_pair, tmp_path):
    jax_pipe, _, X = pipeline_pair
    converted = model_from_flax(jax_pipe.steps[-1][1].params_, into_definition(jax_pipe),
                                pipeline_steps=_step_arrays(jax_pipe), device="cpu")
    assert isinstance(converted, Pipeline)
    np.testing.assert_allclose(converted.predict(X), jax_pipe.predict(X), atol=1e-5)
    serializer.dump(converted, tmp_path / "m", {})
    again = serializer.load(tmp_path / "m", device="cpu")
    np.testing.assert_array_equal(again.predict(X), converted.predict(X))
    step = again.steps[1][1]
    assert (step.func, step.kw_args) == (
        "gordo_tpu.models.transformer_funcs.general.multiply_by", {"factor": 2}
    )
