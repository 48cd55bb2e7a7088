"""
The port's training callbacks (``gordo_tpu_torch.models.callbacks``)
against the JAX package's: ``EarlyStopping`` and ``TerminateOnNaN`` on
the same loss sequences, the serializer's round trip and Keras paths,
``fleet_fit_kwargs``, and the solo fit running them (losses and weights
against a JAX fit from the same init, which stops at the same epoch).
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gordo_tpu.models import AutoEncoder as JaxAutoEncoder
from gordo_tpu.models import callbacks as jax_callbacks
from gordo_tpu.models.core import solo_init_key
from gordo_tpu_torch import serializer
from gordo_tpu_torch.convert import feedforward_state_dict
from gordo_tpu_torch.models import AutoEncoder
from gordo_tpu_torch.models import callbacks
from gordo_tpu_torch.models.core import _materialize_callbacks

torch.set_num_threads(1)

SEQUENCES = {
    "falls": [1.0, 0.8, 0.7, 0.65, 0.6, 0.58],
    "plateau": [1.0, 0.9, 0.9, 0.91, 0.95, 0.89, 0.92],
    "bounces": [1.0, 1.2, 0.8, 0.85, 0.9, 0.95, 0.7],
    "nan": [1.0, 0.5, float("nan"), 0.4],
}
ES_CASES = [
    {},
    {"monitor": "loss", "patience": 0},
    {"monitor": "loss", "patience": 2, "min_delta": 0.02},
    {"monitor": "loss", "patience": 1, "baseline": 0.85},
    {"monitor": "loss", "patience": 1, "start_from_epoch": 3},
    {"monitor": "val_loss", "patience": 1},
    {"monitor": "loss", "patience": 1, "mode": "max"},
    {"monitor": "val_accuracy", "patience": 1},
]


def _run(cb, losses, with_val):
    """(stop epoch or None, the params finalize returns) over a sequence;
    the params at epoch e are ``{"w": [e]}``."""
    cb.on_train_begin()
    stop = None
    for epoch, loss in enumerate(losses):
        logs = {"loss": loss}
        if with_val:
            logs["val_loss"] = loss + 0.1
        params = {"w": torch.tensor([float(epoch)])}
        if cb.update(epoch, logs, params):
            stop = epoch
            break
    final = cb.finalize({"w": torch.tensor([-1.0])})
    return stop, float(final["w"][0])


def _run_jax(cb, losses, with_val):
    cb.on_train_begin()
    stop = None
    for epoch, loss in enumerate(losses):
        logs = {"loss": loss}
        if with_val:
            logs["val_loss"] = loss + 0.1
        if cb.update(epoch, logs, {"w": jnp.asarray([float(epoch)])}):
            stop = epoch
            break
    final = cb.finalize({"w": jnp.asarray([-1.0])})
    return stop, float(final["w"][0])


@pytest.mark.parametrize("with_val", [False, True])
@pytest.mark.parametrize("restore", [False, True])
@pytest.mark.parametrize("kwargs", ES_CASES)
@pytest.mark.parametrize("sequence", sorted(SEQUENCES))
def test_early_stopping_matches_jax(sequence, kwargs, restore, with_val):
    losses = SEQUENCES[sequence]
    kwargs = dict(kwargs, restore_best_weights=restore)
    got = _run(callbacks.EarlyStopping(**kwargs), losses, with_val)
    want = _run_jax(jax_callbacks.EarlyStopping(**kwargs), losses, with_val)
    assert got == want


@pytest.mark.parametrize("sequence", sorted(SEQUENCES))
def test_terminate_on_nan_matches_jax(sequence):
    losses = SEQUENCES[sequence]
    got = _run(callbacks.TerminateOnNaN(), losses, False)
    assert got == _run_jax(jax_callbacks.TerminateOnNaN(), losses, False)


def test_val_loss_falls_back_to_loss_with_a_warning(caplog):
    cb = callbacks.EarlyStopping(patience=1)
    with caplog.at_level(logging.WARNING):
        assert _run(cb, SEQUENCES["plateau"], with_val=False)[0] == 2
    assert "monitoring 'loss' instead" in caplog.text


def test_bad_mode_raises_as_in_jax():
    with pytest.raises(ValueError, match="mode"):
        callbacks.EarlyStopping(mode="sideways")
    with pytest.raises(ValueError, match="mode"):
        jax_callbacks.EarlyStopping(mode="sideways")


@pytest.mark.parametrize(
    "path",
    ["tensorflow.keras.callbacks.EarlyStopping", "keras.callbacks.EarlyStopping",
     "gordo_tpu.models.callbacks.EarlyStopping", "gordo_tpu_torch.models.callbacks.EarlyStopping"],
)
def test_serializer_maps_keras_jax_and_port_paths(path):
    cb = serializer.callback_from_definition({path: {"patience": 3, "monitor": "loss"}})
    assert isinstance(cb, callbacks.EarlyStopping)
    definition = serializer.callback_into_definition(cb)
    assert definition == {
        "gordo_tpu_torch.models.callbacks.EarlyStopping":
            jax_callbacks.EarlyStopping(patience=3, monitor="loss").get_params()
    }
    back = serializer.callback_from_definition(definition)
    assert back.get_params() == cb.get_params()


def test_unknown_keras_callback_is_dropped_with_jax_warning(caplog):
    raw = [
        {"tensorflow.keras.callbacks.ReduceLROnPlateau": {"patience": 1}},
        {"tensorflow.keras.callbacks.TerminateOnNaN": {}},
        "keras.callbacks.EarlyStopping",
        object(),
    ]
    with caplog.at_level(logging.WARNING):
        got = _materialize_callbacks(raw)
    assert [type(cb).__name__ for cb in got] == ["TerminateOnNaN", "EarlyStopping"]
    assert "Ignoring unsupported training callback tensorflow.keras.callbacks.ReduceLROnPlateau" in (
        caplog.text
    )
    assert "Ignoring unsupported training callback object object" in caplog.text


def test_estimator_definition_round_trips_callbacks():
    est = AutoEncoder(kind="feedforward_hourglass", epochs=2,
                      callbacks=[callbacks.EarlyStopping(patience=2, monitor="loss")])
    definition = est.into_definition()
    (kwargs,) = definition.values()
    assert kwargs["callbacks"] == [
        {"gordo_tpu_torch.models.callbacks.EarlyStopping":
            callbacks.EarlyStopping(patience=2, monitor="loss").get_params()}
    ]
    rebuilt = serializer.from_definition(definition)
    (cb,) = _materialize_callbacks(rebuilt.kwargs["callbacks"])
    assert cb.get_params()["patience"] == 2


@pytest.mark.parametrize(
    "fit_args",
    [
        {},
        {"validation_split": 0.2},
        {"callbacks": [{"tensorflow.keras.callbacks.EarlyStopping": {"patience": 2}}]},
        {"validation_split": 0.25, "callbacks": [
            {"keras.callbacks.EarlyStopping": {"patience": 1, "min_delta": 0.1,
                                              "restore_best_weights": True,
                                              "start_from_epoch": 2}}]},
        {"callbacks": [{"keras.callbacks.EarlyStopping": {"monitor": "val_accuracy"}}]},
        {"callbacks": [{"keras.callbacks.EarlyStopping": {"baseline": 0.5}}]},
        {"callbacks": [{"keras.callbacks.TerminateOnNaN": {}}]},
        {"callbacks": [{"keras.callbacks.EarlyStopping": {}}, {"keras.callbacks.EarlyStopping": {}}]},
    ],
)
def test_fleet_fit_kwargs_matches_jax(fit_args):
    assert callbacks.fleet_fit_kwargs(fit_args) == jax_callbacks.fleet_fit_kwargs(fit_args)


def _jax_initial_state(self, spec, seed):
    module = JaxAutoEncoder(self.kind, **self.kwargs)._build_spec().module
    params = module.init(solo_init_key(seed), jnp.zeros((1, self.kwargs["n_features"])))
    return {k: torch.tensor(v) for k, v in feedforward_state_dict(params).items()}


@pytest.mark.parametrize("restore", [False, True])
def test_solo_fit_early_stops_as_jax(monkeypatch, restore):
    """The solo fit with a Keras EarlyStopping on the validation loss, from
    the JAX init with shuffle off: the same epochs run (``history_``), the
    same losses (rtol 1e-4) and the same final (or restored) weights
    (atol 1e-4)."""
    monkeypatch.setattr(AutoEncoder, "_initial_state", _jax_initial_state)
    rng = np.random.default_rng(0)
    X = rng.normal(size=(120, 4)).astype(np.float32)
    kwargs = dict(
        kind="feedforward_hourglass", epochs=30, batch_size=16, shuffle=False,
        validation_split=0.25, seed=3,
        callbacks=[{"tensorflow.keras.callbacks.EarlyStopping": {
            "patience": 1, "min_delta": 0.0112, "restore_best_weights": restore}}],
    )
    port = AutoEncoder(**kwargs).fit(X, X, device="cpu")
    jax_est = JaxAutoEncoder(**kwargs).fit(X, X)
    assert len(port.history_["loss"]) == len(jax_est.history_["loss"]) < 30
    np.testing.assert_allclose(port.history_["loss"], jax_est.history_["loss"], rtol=1e-4)
    np.testing.assert_allclose(port.history_["val_loss"], jax_est.history_["val_loss"], rtol=1e-4)
    assert port.history_["params"] == jax_est.history_["params"]
    want = feedforward_state_dict(jax_est.params_)
    got = port.state_arrays()
    for name, value in want.items():
        np.testing.assert_allclose(got[name], value, atol=1e-4, err_msg=name)
