"""
Epoch checkpoints of the port's fleet fit (``gordo_tpu_torch.parallel.checkpoint``
and ``FleetTrainer.fit(checkpointer=...)``) on the CPU, at a small size.

- The checkpointer: save, restore and ``keep``; a torn newest checkpoint
  falls back to the one before; the early-stopping and quarantine extras
  with the optional-key layouts.
- A fit stopped after epoch k and resumed is bitwise the unbroken fit,
  with dropout on and shuffling, at ``epoch_chunk`` 1 and 2, for the
  feedforward net and the flash Transformer (each epoch's draws come
  from (seed, epoch)).
- A fit resumed from epoch k against the JAX trainer resumed from k
  (orbax checkpoints), from the JAX init with dropout 0 and shuffle off:
  losses within rtol 1e-4, parameters within atol 1e-4.
"""

import json

import jax
import numpy as np
import pytest
import torch

from gordo_tpu.models import AutoEncoder as JaxAutoEncoder
from gordo_tpu.models import TransformerAutoEncoder as JaxTransformerAutoEncoder
from gordo_tpu.parallel import FleetCheckpointer as JaxFleetCheckpointer
from gordo_tpu.parallel.fleet import FleetTrainer as JaxFleetTrainer
from gordo_tpu.parallel.fleet import StackedData as JaxStackedData
from gordo_tpu_torch.convert import feedforward_state_dict, transformer_state_dict
from gordo_tpu_torch.models import AutoEncoder, TransformerAutoEncoder
from gordo_tpu_torch.parallel.checkpoint import MANIFEST_FILENAME, FleetCheckpointer
from gordo_tpu_torch.parallel.fleet import FleetTrainer, StackedData
from tests.test_torch_fleet import _jax_params, _rows

torch.set_num_threads(1)
FEEDFORWARD = dict(kind="feedforward_hourglass")
TRANSFORMER = dict(kind="transformer_model", lookback_window=8, d_model=16, n_heads=2,
                   n_layers=2, attention_impl="flash")


def _trainer(est_kwargs, n_features=4, **trainer_kwargs):
    cls = TransformerAutoEncoder if "lookback_window" in est_kwargs else AutoEncoder
    est = cls(**est_kwargs, n_features=n_features, n_features_out=n_features)
    return FleetTrainer(est._build_spec(), device="cpu", seed=11, **trainer_kwargs)


def _data(lengths=(48, 40, 44), n_features=4):
    Xs = _rows(list(lengths), n_features=n_features)
    return StackedData.from_ragged(Xs, Xs, device="cpu")


def _state(params):
    return {name: value.clone() for name, value in params.items()}


# -- the checkpointer --------------------------------------------------------


def _saved(tmp_path, keep=3, epochs=5, extra=None):
    trainer = _trainer(FEEDFORWARD)
    params = trainer.init_params([1, 2])
    opt_state = trainer.optimizer.init(params, n_machines=2)
    ckpt = FleetCheckpointer(tmp_path / "ckpt", keep=keep)
    saved = {}
    for epoch in range(epochs):
        params = {n: v + epoch for n, v in params.items()}
        ckpt.save(epoch, params, opt_state, extra=extra)
        saved[epoch] = _state(params)
    return ckpt, trainer, params, opt_state, saved


def test_save_restore_and_keep(tmp_path):
    ckpt, _, params, opt_state, saved = _saved(tmp_path, keep=2)
    assert ckpt.all_epochs() == [3, 4] and ckpt.latest_epoch() == 4
    restored, opt, epoch = ckpt.restore(params, opt_state)
    assert epoch == 4
    for name, value in saved[4].items():
        assert torch.equal(restored[name], value)
    assert torch.equal(opt["count"], opt_state["count"])
    restored, _, epoch = ckpt.restore(params, opt_state, epoch=3)
    assert epoch == 3 and all(torch.equal(restored[n], saved[3][n]) for n in saved[3])
    manifest = json.loads((tmp_path / "ckpt" / "4" / MANIFEST_FILENAME).read_text())
    assert sorted(manifest) == ["opt_state.npz", "params.npz"]


def test_restore_without_checkpoints_raises(tmp_path):
    ckpt = FleetCheckpointer(tmp_path / "empty")
    assert ckpt.latest_epoch() is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore({}, {})


def test_torn_newest_falls_back_to_the_one_before(tmp_path, caplog):
    ckpt, _, params, opt_state, saved = _saved(tmp_path, epochs=3)
    path = tmp_path / "ckpt" / "2" / "params.npz"
    path.write_bytes(path.read_bytes()[:-7])  # a torn write
    restored, _, epoch = ckpt.restore(params, opt_state)
    assert epoch == 1
    assert all(torch.equal(restored[n], saved[1][n]) for n in saved[1])
    assert "torn" in caplog.text
    # the torn checkpoint is gone, so the resumed fit can save it again
    assert ckpt.all_epochs() == [0, 1]


def test_unloadable_newest_falls_back_and_is_kept(tmp_path):
    """A checkpoint whose files match their manifest but do not load into
    the template (another layout) is skipped, not deleted."""
    ckpt, trainer, params, opt_state, saved = _saved(tmp_path, epochs=2)
    other = {"only": torch.zeros(2, 3)}
    ckpt.save(2, other, opt_state)
    restored, _, epoch = ckpt.restore(params, opt_state)
    assert epoch == 1 and ckpt.all_epochs() == [0, 1, 2]


def test_extras_with_optional_keys(tmp_path):
    healthy = np.array([True, False])
    es = {"best": np.array([0.5, 0.25], np.float32), "wait": np.array([2, 0], np.int32),
          "active": np.array([True, False]), "last_loss": np.array([0.6, 0.3], np.float32)}
    ckpt, _, params, opt_state, _ = _saved(tmp_path, epochs=1, extra={"healthy": healthy})
    template = dict(es, healthy=np.ones(2, bool))
    # a healthy-only checkpoint (a plain fit's) restores into an
    # early-stopping template through the optional-key layouts
    _, _, epoch, extra = ckpt.restore_with_extra(params, opt_state, template,
                                                 optional_extra_keys=("healthy",))
    assert epoch == 0 and sorted(extra) == ["healthy"]
    np.testing.assert_array_equal(extra["healthy"], healthy)
    ckpt.save(1, params, opt_state, extra=dict(es, healthy=healthy))
    _, _, epoch, extra = ckpt.restore_with_extra(params, opt_state, template,
                                                 optional_extra_keys=("healthy",))
    assert epoch == 1 and sorted(extra) == sorted(template)
    for key, value in es.items():
        np.testing.assert_array_equal(extra[key], value)
    # an early-stopping checkpoint without the mask (an older layout)
    ckpt.save(2, params, opt_state, extra=es)
    _, _, epoch, extra = ckpt.restore_with_extra(params, opt_state, template,
                                                 optional_extra_keys=("healthy",))
    assert epoch == 2 and sorted(extra) == sorted(es)
    # no extra at all: the weights restore and the extra is None
    ckpt.save(3, params, opt_state)
    _, _, epoch, extra = ckpt.restore_with_extra(params, opt_state, template,
                                                 optional_extra_keys=("healthy",))
    assert epoch == 3 and extra is None


# -- resumed fits, bitwise ---------------------------------------------------


@pytest.mark.parametrize("chunk", [1, 2])
@pytest.mark.parametrize("name,kwargs,n_features", [
    ("feedforward", dict(FEEDFORWARD, dropout=0.1), 4),
    ("flash-transformer", dict(TRANSFORMER, dropout=0.1), 3),
])
def test_resumed_fit_is_bitwise_the_unbroken_one(tmp_path, name, kwargs, n_features, chunk):
    data = _data(n_features=n_features)
    fit = dict(seeds=[1, 2, 3], epochs=4, batch_size=16, shuffle=True)
    full, full_losses = _trainer(kwargs, n_features, epoch_chunk=chunk).fit(data, **fit)
    ckpt = FleetCheckpointer(tmp_path / "ckpt")
    _trainer(kwargs, n_features, epoch_chunk=chunk).fit(data, **dict(fit, epochs=2),
                                                        checkpointer=ckpt)
    assert ckpt.latest_epoch() == 1
    trainer = _trainer(kwargs, n_features, epoch_chunk=chunk)
    resumed, losses = trainer.fit(data, **fit, checkpointer=ckpt)
    assert trainer.fit_telemetry_["resumed_from_epoch"] == 2
    assert losses.shape == (2, 3)
    np.testing.assert_array_equal(losses, full_losses[2:])
    for key, value in full.items():
        assert torch.equal(resumed[key], value), key
    assert ckpt.latest_epoch() == 3


def test_checkpoint_every_ends_a_chunk(tmp_path):
    """``checkpoint_every=2`` saves epochs 1 and 3, each at a chunk's end,
    and the fit is the same bits as without checkpoints."""
    data = _data()
    fit = dict(seeds=[1, 2, 3], epochs=4, batch_size=16, shuffle=True)
    plain, _ = _trainer(FEEDFORWARD).fit(data, **fit)
    ckpt = FleetCheckpointer(tmp_path / "ckpt")
    trainer = _trainer(FEEDFORWARD)
    params, _ = trainer.fit(data, **fit, checkpointer=ckpt, checkpoint_every=2)
    assert ckpt.all_epochs() == [1, 3]
    assert all(torch.equal(params[k], plain[k]) for k in plain)


def test_resumed_early_stopping_and_quarantine_state(tmp_path):
    """Early stopping with a poisoned machine: the resumed fit restores
    the stopping state and the quarantine mask and ends as the unbroken
    fit does."""
    Xs = _rows([48, 40, 44])
    Xs[1] = Xs[1].copy()
    Xs[1][5, 2] = np.inf
    data = StackedData.from_ragged(Xs, Xs, device="cpu")
    fit = dict(seeds=[1, 2, 3], epochs=6, batch_size=16, shuffle=False,
               early_stopping_patience=1, early_stopping_min_delta=0.0035)
    full_trainer = _trainer(FEEDFORWARD)
    full, full_losses = full_trainer.fit(data, **fit)
    ckpt = FleetCheckpointer(tmp_path / "ckpt")
    _trainer(FEEDFORWARD).fit(data, **dict(fit, epochs=2), checkpointer=ckpt)
    trainer = _trainer(FEEDFORWARD)
    resumed, losses = trainer.fit(data, **fit, checkpointer=ckpt)
    assert 2 < len(full_losses) < 6  # the fleet stopped after the resume, early
    np.testing.assert_array_equal(losses, full_losses[2:])
    assert all(torch.equal(resumed[k], full[k]) for k in full)
    np.testing.assert_array_equal(trainer.healthy_, full_trainer.healthy_)
    assert not trainer.healthy_[1]
    # the quarantine happened before the resume: as in JAX, the resumed
    # fit names only the machines it quarantined itself
    assert full_trainer.quarantine_epoch_.tolist() == [-1, 0, -1]
    assert trainer.quarantine_epoch_.tolist() == [-1, -1, -1]


# -- against the JAX trainer -------------------------------------------------


@pytest.mark.parametrize("jax_cls,port_cls,kwargs,convert,n_features,skip", [
    (JaxAutoEncoder, AutoEncoder, FEEDFORWARD, feedforward_state_dict, 4, ()),
    (JaxTransformerAutoEncoder, TransformerAutoEncoder, dict(TRANSFORMER, n_layers=1),
     transformer_state_dict, 3, ("attn.key.bias",)),
])
def test_resumed_fit_against_jax(tmp_path, jax_cls, port_cls, kwargs, convert, n_features,
                                 skip):
    """Both trainers checkpoint epoch 0 and resume to epoch 2 from their own
    checkpoints, from the same (JAX) init, dropout 0, shuffle off."""
    seeds = (1, 2, 3)
    Xs = _rows([40, 33, 37], n_features=n_features)
    full = dict(kwargs, dropout=0.0, n_features=n_features, n_features_out=n_features)
    jax_est = jax_cls(**full)
    keys, stacked, trees = _jax_params(jax_est, n_features, seeds)
    spec = jax_est._build_spec()
    fit = dict(batch_size=8, shuffle=False)
    jt = JaxFleetTrainer(spec, donate=False)
    jdata = JaxStackedData.from_ragged(Xs, Xs)
    jckpt = JaxFleetCheckpointer(str(tmp_path / "jax"))
    jt.fit(jdata, keys, params=stacked, epochs=1, checkpointer=jckpt, **fit)
    jax_params, jax_losses = jt.fit(jdata, keys, params=stacked, epochs=3, checkpointer=jckpt,
                                    **fit)
    jckpt.close()

    pt = FleetTrainer(port_cls(**full)._build_spec(), device="cpu")
    pdata = StackedData.from_ragged(Xs, Xs, device="cpu")
    init = pt.stack_params([convert(tree) for tree in trees])
    ckpt = FleetCheckpointer(tmp_path / "port")
    pt.fit(pdata, params=init, epochs=1, checkpointer=ckpt, **fit)
    port_params, port_losses = pt.fit(pdata, params=init, epochs=3, checkpointer=ckpt, **fit)

    assert port_losses.shape == np.asarray(jax_losses).shape == (2, 3)
    np.testing.assert_allclose(port_losses, np.asarray(jax_losses), rtol=1e-4)
    for i in range(3):
        want = convert(jax.tree.map(lambda a: np.asarray(a[i]), jax_params))
        for name, value in want.items():
            if any(name.endswith(s) for s in skip):
                continue
            np.testing.assert_allclose(port_params[name][i].numpy(), value, atol=1e-4,
                                       err_msg=f"{name} machine {i}")
