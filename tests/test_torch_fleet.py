"""
The port's fleet trainer (``gordo_tpu_torch.parallel.fleet``) against the
JAX package's ``FleetTrainer``, and the flash kernels' Function under a
machine axis.

Both trainers start from the same weights (each machine's JAX init,
carried across by ``gordo_tpu_torch.convert`` and stacked) with dropout
0 and shuffle off, so they see the same batches: feedforward, an LSTM,
the TCN and the Transformer with flash attention (JAX's Pallas kernels
in interpret mode; the port's plain versions, as on any CPU tensor), a
padded-policy bucket of ragged widths, per-machine early stopping with
``restore_best_weights``, a validation split and a poisoned machine under
the quarantine. Tolerances: epoch losses rtol 1e-4, parameters atol
1e-4 (float32 in another summation order), except the attention key
biases of the Adam-trained Transformer: their gradient is 0 in exact
arithmetic, and Adam turns either side's rounding noise into steps of up
to the learning rate (``tests/test_torch_training.py``).

A one-machine fleet against the port's solo ``fit`` (1e-5), and
``epoch_chunk`` against ``epoch_chunk=1`` (the same bits).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

from gordo_tpu.models import AutoEncoder as JaxAutoEncoder
from gordo_tpu.models import LSTMAutoEncoder as JaxLSTMAutoEncoder
from gordo_tpu.models import TCNAutoEncoder as JaxTCNAutoEncoder
from gordo_tpu.models import TransformerAutoEncoder as JaxTransformerAutoEncoder
from gordo_tpu.models.core import solo_init_key
from gordo_tpu.parallel.fleet import FleetTrainer as JaxFleetTrainer
from gordo_tpu.parallel.fleet import StackedData as JaxStackedData
from gordo_tpu_torch.convert import (
    feedforward_state_dict,
    recurrent_state_dict,
    tcn_state_dict,
    transformer_state_dict,
)
from gordo_tpu_torch.models import (
    AutoEncoder,
    LSTMAutoEncoder,
    TCNAutoEncoder,
    TransformerAutoEncoder,
)
from gordo_tpu_torch.models.specs_seq import dense_attention
from gordo_tpu_torch.ops import flash_attention as fa
from gordo_tpu_torch.parallel.fleet import FleetTrainer, StackedData

torch.set_num_threads(1)
SEEDS = (1, 2, 3)


def _rows(lengths, n_features=4, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(max(lengths))[:, None]
    out = []
    for i, n in enumerate(lengths):
        wave = np.sin(2 * np.pi * t[:n] / 48 + np.arange(n_features) + i)
        out.append((wave + 0.1 * rng.normal(size=(n, n_features))).astype(np.float32))
    return out


def _jax_params(jax_est, n_features, seeds):
    """(stacked JAX init of each machine's solo key, the same per machine as
    numpy trees)."""
    spec = jax_est._build_spec()
    lb = spec.lookback_window if spec.windowed else None
    example = jnp.zeros((1, lb, n_features) if lb else (1, n_features))
    keys = jnp.stack([solo_init_key(s) for s in seeds])
    stacked = jax.vmap(lambda k: spec.module.init(k, example))(keys)
    trees = [jax.tree.map(lambda a: np.asarray(a[i]), stacked) for i in range(len(seeds))]
    return keys, stacked, trees


def _fit_pair(jax_cls, port_cls, kwargs, convert, Xs, Ys=None, seeds=SEEDS,
              trainer_kwargs=None, n_features=None, **fit_kwargs):
    """(JAX trainer, port trainer, JAX (params, losses), port (params,
    losses), convert) from the same init."""
    Ys = Xs if Ys is None else Ys
    trainer_kwargs = trainer_kwargs or {}
    n_features = n_features or max(x.shape[1] for x in Xs)
    n_out = max(y.shape[1] for y in Ys)
    full = dict(kwargs, n_features=n_features, n_features_out=n_out)
    jax_est = jax_cls(**full)
    keys, stacked, trees = _jax_params(jax_est, n_features, seeds)
    states = [convert(tree) for tree in trees]
    spec = jax_est._build_spec()
    lookahead = jax_est.lookahead if spec.windowed else 0
    jt = JaxFleetTrainer(spec, lookahead=lookahead, **trainer_kwargs)
    jax_out = jt.fit(JaxStackedData.from_ragged(Xs, Ys, n_features=n_features,
                                                n_features_out=n_out),
                     keys, params=stacked, **fit_kwargs)
    port_est = port_cls(**full)
    pt = FleetTrainer(port_est._build_spec(), lookahead=lookahead, device="cpu",
                      **trainer_kwargs)
    port_out = pt.fit(StackedData.from_ragged(Xs, Ys, n_features=n_features,
                                              n_features_out=n_out, device="cpu"),
                      params=pt.stack_params(states), **fit_kwargs)
    return jt, pt, jax_out, port_out, convert


def _assert_same(pair, skip=()):
    jt, pt, (jax_params, jax_losses), (port_params, port_losses), convert = pair
    np.testing.assert_allclose(port_losses, np.asarray(jax_losses), rtol=1e-4)
    for i in range(port_losses.shape[1]):
        want = convert(jax.tree.map(lambda a: np.asarray(a[i]), jax_params))
        for name, value in want.items():
            if any(name.endswith(s) for s in skip):
                continue
            np.testing.assert_allclose(port_params[name][i].numpy(), value, atol=1e-4,
                                       err_msg=f"{name} machine {i}")


FEEDFORWARD = dict(kind="feedforward_hourglass")


def test_stacked_data_matches_jax():
    Xs = _rows([20, 13, 17], n_features=3)
    Ys = [x[:, :2] if i == 1 else x for i, x in enumerate(Xs)]
    want = JaxStackedData.from_ragged(Xs, Ys, n_machines_padded=4, n_timesteps=24,
                                      n_features=4, n_features_out=3)
    got = StackedData.from_ragged(Xs, Ys, n_machines_padded=4, n_timesteps=24, n_features=4,
                                  n_features_out=3, device="cpu")
    for field in ("X", "y", "sample_weight", "feature_out_weight"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)), err_msg=field)
    assert StackedData.from_ragged(Xs, Xs, device="cpu").feature_out_weight is None


def test_feedforward_fleet_matches_jax():
    pair = _fit_pair(JaxAutoEncoder, AutoEncoder, FEEDFORWARD, feedforward_state_dict,
                     _rows([50, 37, 61]), epochs=3, batch_size=16, shuffle=False)
    _assert_same(pair)
    jt, pt, (jax_params, _), (port_params, _), _ = pair
    X = np.stack([x[:37] for x in _rows([50, 37, 61])])
    np.testing.assert_allclose(pt.predict(port_params, torch.from_numpy(X)),
                               np.asarray(jt.predict(jax_params, X)), atol=1e-5)
    for i, state in enumerate(pt.unstack_all(port_params, 3)):
        assert set(state) == set(port_params)
        np.testing.assert_array_equal(state["layers.0.weight"],
                                      pt.unstack_params(port_params, i)["layers.0.weight"])


def test_lstm_fleet_matches_jax():
    kwargs = dict(kind="lstm_model", lookback_window=6, encoding_dim=(8,), encoding_func=("tanh",),
                  decoding_dim=(8,), decoding_func=("tanh",), fused=True)
    _assert_same(_fit_pair(JaxLSTMAutoEncoder, LSTMAutoEncoder, kwargs, recurrent_state_dict,
                           _rows([40, 31, 36]), epochs=2, batch_size=8))


def test_tcn_fleet_matches_jax():
    kwargs = dict(kind="tcn_model", lookback_window=8, channels=(8, 8), kernel_size=2,
                  dilations=(1, 2), dropout=0.0)
    _assert_same(_fit_pair(JaxTCNAutoEncoder, TCNAutoEncoder, kwargs, tcn_state_dict,
                           _rows([40, 33, 45]), epochs=2, batch_size=8))


def test_flash_transformer_fleet_matches_jax():
    """The Transformer with flash attention: JAX's vmapped Pallas kernels in
    interpret mode against the port's Function under vmap."""
    kwargs = dict(kind="transformer_model", lookback_window=8, d_model=16, n_heads=2,
                  n_layers=1, dropout=0.0, attention_impl="flash")
    _assert_same(
        _fit_pair(JaxTransformerAutoEncoder, TransformerAutoEncoder, kwargs,
                  transformer_state_dict, _rows([31, 24, 27], n_features=3), epochs=1,
                  batch_size=8),
        skip=("attn.key.bias",),
    )


def test_padded_ragged_bucket_matches_jax():
    """Machines of 3 and 4 features in one bucket at the padded widths (4 in,
    4 out): pad columns zero on input and weighted out of the loss."""
    Xs = [x if i != 1 else x[:, :3] for i, x in enumerate(_rows([40, 36, 44]))]
    pair = _fit_pair(JaxAutoEncoder, AutoEncoder, FEEDFORWARD, feedforward_state_dict, Xs,
                     n_features=4, epochs=2, batch_size=8, shuffle=False)
    assert pair[1].fit_telemetry_["n_machines"] == 3
    _assert_same(pair)


ES = dict(early_stopping_patience=1, early_stopping_min_delta=0.02, restore_best_weights=True)


def test_early_stopping_restores_best_weights_as_jax():
    pair = _fit_pair(JaxAutoEncoder, AutoEncoder, FEEDFORWARD, feedforward_state_dict,
                     _rows([60, 44, 52]), epochs=12, batch_size=16, shuffle=False, **ES)
    _assert_same(pair)
    assert pair[3][1].shape[0] < 12  # the fleet stopped early


def test_validation_split_matches_jax():
    pair = _fit_pair(JaxAutoEncoder, AutoEncoder, FEEDFORWARD, feedforward_state_dict,
                     _rows([60, 44, 52]), epochs=4, batch_size=16, shuffle=False,
                     validation_split=0.25, early_stopping_patience=1,
                     early_stopping_min_delta=0.01)
    _assert_same(pair)
    jt, pt = pair[0], pair[1]
    np.testing.assert_allclose(pt.val_losses_, jt.val_losses_, rtol=1e-4)
    assert all("val_loss" in h for h in pt.history_)


def test_poisoned_machine_is_quarantined_as_jax():
    Xs = _rows([40, 40, 40])
    Xs[1] = Xs[1].copy()
    Xs[1][5, 2] = np.nan
    pair = _fit_pair(JaxAutoEncoder, AutoEncoder, FEEDFORWARD, feedforward_state_dict, Xs,
                     epochs=3, batch_size=8, shuffle=False)
    jt, pt, (jax_params, jax_losses), (port_params, port_losses), convert = pair
    np.testing.assert_array_equal(pt.healthy_, jt.healthy_)
    np.testing.assert_array_equal(pt.quarantine_epoch_, jt.quarantine_epoch_)
    assert pt.healthy_.tolist() == [True, False, True]
    assert np.isnan(port_losses[:, 1]).all() and np.isnan(np.asarray(jax_losses)[:, 1]).all()
    for i in (0, 1, 2):
        want = convert(jax.tree.map(lambda a: np.asarray(a[i]), jax_params))
        for name, value in want.items():
            np.testing.assert_allclose(port_params[name][i].numpy(), value, atol=1e-4)


def test_epoch_chunk_is_scheduling_only():
    Xs = _rows([60, 44, 52])
    out = []
    for chunk in (1, 3):
        est = AutoEncoder(**FEEDFORWARD, n_features=4, n_features_out=4)
        trainer = FleetTrainer(est._build_spec(), device="cpu", epoch_chunk=chunk)
        params, losses = trainer.fit(StackedData.from_ragged(Xs, Xs, device="cpu"),
                                     seeds=SEEDS, epochs=12, batch_size=16, **ES)
        out.append((params, losses, trainer.fit_telemetry_["n_host_syncs"]))
    (p1, l1, syncs1), (p3, l3, syncs3) = out
    np.testing.assert_array_equal(l1, l3)
    assert all(torch.equal(p1[n], p3[n]) for n in p1)
    assert syncs3 < syncs1


@pytest.mark.parametrize("kind", ["feedforward", "transformer"])
def test_one_machine_fleet_matches_solo_fit(kind):
    if kind == "feedforward":
        est = AutoEncoder(**FEEDFORWARD, epochs=3, batch_size=16, shuffle=False, seed=5)
        X = _rows([70])[0]
    else:
        est = TransformerAutoEncoder(kind="transformer_model", lookback_window=8, d_model=16,
                                     n_heads=2, n_layers=1, dropout=0.0, epochs=2,
                                     batch_size=8, seed=5, attention_impl="flash")
        X = _rows([40], n_features=3)[0]
    solo = est.clone().fit(X, X, device="cpu")
    est.kwargs.update(n_features=X.shape[1], n_features_out=X.shape[1])
    spec = est._build_spec()
    trainer = FleetTrainer(spec, lookahead=0, device="cpu")
    init = trainer.stack_params([{n: t.clone() for n, t in est._initial_state(spec, 5).items()}])
    params, losses = trainer.fit(StackedData.from_ragged([X], [X], device="cpu"), params=init,
                                 epochs=est.kwargs["epochs"], batch_size=est.kwargs["batch_size"],
                                 shuffle=False)
    np.testing.assert_allclose(losses[:, 0], solo.history_["loss"], rtol=1e-5)
    for name, value in solo.state_arrays().items():
        if not name.endswith("attn.key.bias"):  # Adam on rounding noise (module note)
            np.testing.assert_allclose(params[name][0].numpy(), value, atol=1e-5, err_msg=name)


def test_dropout_draws_differ_by_machine_and_follow_the_seed():
    """The TCN at its default dropout (0.1) under vmap: two machines with
    the same data and weights train apart (their masks differ), and the
    same trainer seed trains the same weights."""
    X = _rows([40])[0]

    def train(seed):
        est = TCNAutoEncoder(kind="tcn_model", lookback_window=8, channels=(8, 8),
                             kernel_size=2, dilations=(1, 2), n_features=4, n_features_out=4)
        trainer = FleetTrainer(est._build_spec(), device="cpu", seed=seed)
        params, _ = trainer.fit(StackedData.from_ragged([X, X], [X, X], device="cpu"),
                                seeds=(7, 7), epochs=1, batch_size=8)
        return params

    a, b, c = train(1), train(1), train(2)
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not torch.equal(a["head.weight"][0], a["head.weight"][1])
    assert not torch.equal(a["head.weight"], c["head.weight"])


def test_flash_function_under_vmap_matches_dense():
    """The flash Function under vmap, vmap(grad) and regular autograd
    through vmap: the same values and gradients as dense attention, and
    the kernels' wrappers see only folded (unbatched) tensors."""
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 3, 8, 2, 8)).astype(np.float32))
               for _ in range(3))

    def loss(fn):
        return lambda a, b, c: (fn(a, b, c, causal=True) ** 2).sum()

    out = vmap(lambda a, b, c: fa.flash_attention(a, b, c, causal=True))(q, k, v)
    want = torch.stack([dense_attention(q[i], k[i], v[i], causal=True) for i in range(2)])
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=1e-5)
    got = vmap(grad(loss(fa.flash_attention), argnums=(0, 1, 2)))(q, k, v)
    ref = vmap(grad(loss(dense_attention), argnums=(0, 1, 2)))(q, k, v)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=1e-5)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    vmap(loss(fa.flash_attention))(*leaves).sum().backward()
    for leaf, r in zip(leaves, ref):
        np.testing.assert_allclose(leaf.grad.numpy(), r.numpy(), atol=1e-5)


def test_flash_vmap_slices_the_machine_axis_within_int32():
    """A folded launch keeps batch * heads * seq within int32: the machine
    axis is cut into slices that do."""
    assert fa._machine_slices(5, 2**30) == [slice(0, 1), slice(1, 2), slice(2, 3), slice(3, 4),
                                            slice(4, 5)]
    assert fa._machine_slices(5, 100) == [slice(0, 5)]
