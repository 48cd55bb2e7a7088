"""
The port's optimizer-hyperparameter sweep (``gordo_tpu_torch.parallel.sweep``,
the inject-hyperparams form of ``models/optim.py`` and the ``sweep``
command) on the CPU, at a small size.

- Per-variant losses against ``gordo_tpu.parallel.HyperparamSweep`` over
  the same grid (adam learning rates, an adamw ``weight_decay``; the
  feedforward net and the flash Transformer), both from JAX's init of the
  sweep's key and, where the net shuffles, JAX's shuffle draws: within
  rtol 1e-4.
- Trial i against a one-machine port fleet fit at grid point i with the
  same seed, dropout on: within 1e-5 (the hyperparameters ride the state
  as float32, as in optax).
- The sweepable names equal optax's; the unknown-name, unequal-length and
  empty-grid errors.
- The ``sweep`` command's lines against the JAX command's.
"""

import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from click.testing import CliRunner

from gordo_tpu.cli.cli import gordo as jax_gordo
from gordo_tpu.models import AutoEncoder as JaxAutoEncoder
from gordo_tpu.models import TransformerAutoEncoder as JaxTransformerAutoEncoder
from gordo_tpu.parallel import HyperparamSweep as JaxHyperparamSweep
from gordo_tpu_torch.cli import cli
from gordo_tpu_torch.convert import feedforward_state_dict, transformer_state_dict
from gordo_tpu_torch.models import AutoEncoder, TransformerAutoEncoder
from gordo_tpu_torch.models.optim import OPTIMIZERS, inject_hyperparams
from gordo_tpu_torch.models.specs import make_optimizer
from gordo_tpu_torch.parallel.fleet import FleetTrainer, StackedData
from gordo_tpu_torch.parallel.sweep import HyperparamSweep

torch.set_num_threads(1)
F = 4
FEEDFORWARD = dict(kind="feedforward_hourglass")
TRANSFORMER = dict(kind="transformer_model", lookback_window=8, d_model=16, n_heads=2,
                   n_layers=2, attention_impl="flash")


def _X(n=96, n_features=F, seed=0):
    t = np.arange(n)[:, None]
    rng = np.random.default_rng(seed)
    return (np.sin(2 * np.pi * t / 24 + np.arange(n_features))
            + 0.1 * rng.normal(size=(n, n_features))).astype(np.float32)


CASES = {
    "feedforward-adam-lr": (JaxAutoEncoder, AutoEncoder, FEEDFORWARD, feedforward_state_dict,
                            F, {"learning_rate": [1e-3, 3e-3, 1e-2]}),
    "feedforward-adamw-decay": (JaxAutoEncoder, AutoEncoder, dict(FEEDFORWARD, optimizer="AdamW"),
                                feedforward_state_dict, F, {"decay": [0.0, 0.1, 1.0]}),
    "flash-transformer-adam-lr": (JaxTransformerAutoEncoder, TransformerAutoEncoder,
                                  dict(TRANSFORMER, dropout=0.0), transformer_state_dict, 3,
                                  {"lr": [1e-3, 1e-2]}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sweep_losses_match_jax(case, monkeypatch):
    jax_cls, port_cls, kwargs, convert, n_features, grid = CASES[case]
    seed, epochs = 3, 2
    X = _X(n_features=n_features)
    full = dict(kwargs, n_features=n_features, n_features_out=n_features)
    jax_sweep = JaxHyperparamSweep(jax_cls(**full)._build_spec(), grid)
    want = jax_sweep.fit(X, epochs=epochs, batch_size=16, seed=seed)

    # JAX's init and shuffle draws of the sweep's one key
    jt = jax_sweep.trainer
    key = np.asarray(jt.machine_keys(1, seed=seed))[0]
    init = jt.init_params(jnp.asarray(key)[None], n_features)
    state = convert(jax.tree.map(lambda a: np.asarray(a[0]), init))
    sweep = HyperparamSweep(port_cls(**full)._build_spec(), grid, device="cpu")
    n = sweep.n_variants
    monkeypatch.setattr(sweep.trainer, "init_params",
                        lambda seeds: sweep.trainer.stack_params([state] * len(seeds)))

    def jax_noise(m, n_samples, epoch):
        noise = jax.random.uniform(jax.random.fold_in(jnp.asarray(key), epoch), (n_samples,))
        return torch.from_numpy(np.array(noise))[None]

    monkeypatch.setattr(sweep.trainer, "_shuffle_noise", jax_noise)
    got = sweep.fit(X, epochs=epochs, batch_size=16, seed=seed)
    assert got.losses.shape == (epochs, n) == np.asarray(want.losses).shape
    np.testing.assert_allclose(got.losses, np.asarray(want.losses), rtol=1e-4)
    assert got.best_index == want.best_index
    assert got.grid == want.grid


@pytest.mark.parametrize("kwargs,n_features,grid", [
    (dict(FEEDFORWARD, dropout=0.1), F, {"lr": [1e-3, 1e-2, 3e-2]}),
    (dict(TRANSFORMER, dropout=0.1), 3, {"learning_rate": [1e-3, 1e-2], "b1": [0.9, 0.5]}),
])
def test_each_trial_is_a_plain_fit_at_its_grid_point(kwargs, n_features, grid):
    cls = TransformerAutoEncoder if "lookback_window" in kwargs else AutoEncoder
    est = cls(**kwargs, n_features=n_features, n_features_out=n_features)
    X = _X(n_features=n_features)
    result = HyperparamSweep(est._build_spec(), grid, device="cpu").fit(
        X, epochs=2, batch_size=16, seed=5)
    for i, point in enumerate(zip(*grid.values())):
        spec = est._build_spec()
        values = dict(zip(grid, point))
        values = {{"lr": "learning_rate"}.get(k, k): v for k, v in values.items()}
        trainer = FleetTrainer(spec, device="cpu", seed=5, optimizer=make_optimizer(
            spec.optimizer, dict(spec.optimizer_kwargs, **values)))
        _, losses = trainer.fit(StackedData.from_ragged([X], [X], device="cpu"), seeds=[5],
                                epochs=2, batch_size=16)
        np.testing.assert_allclose(result.losses[:, i], losses[:, 0], rtol=1e-5)


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_sweepable_names_are_optax(name):
    ours = OPTIMIZERS[name](learning_rate=1e-3).sweepable()
    injected = optax.inject_hyperparams(getattr(optax, name))(learning_rate=1e-3)
    assert list(ours) == sorted(injected.init({"w": jnp.zeros((1,))}).hyperparams)


def test_injected_state_rides_per_machine():
    opt = inject_hyperparams(OPTIMIZERS["adamw"](learning_rate=1e-3), ("learning_rate",))
    state = opt.init({"w": torch.zeros(3, 2)}, n_machines=3)
    assert state["hyperparams"]["learning_rate"].dtype == torch.float32
    assert state["hyperparams"]["learning_rate"].shape == (3,)


def test_grid_errors():
    spec = AutoEncoder(**FEEDFORWARD, n_features=F, n_features_out=F)._build_spec()
    with pytest.raises(ValueError, match="at least one"):
        HyperparamSweep(spec, {}, device="cpu")
    with pytest.raises(ValueError, match="share one length"):
        HyperparamSweep(spec, {"learning_rate": [1e-3], "b1": [0.9, 0.8]}, device="cpu")
    with pytest.raises(ValueError, match="empty"):
        HyperparamSweep(spec, {"learning_rate": []}, device="cpu")
    with pytest.raises(ValueError, match="sweepable") as err:
        HyperparamSweep(spec, {"bogus_hp": [1.0, 2.0]}, device="cpu")
    assert "learning_rate" in str(err.value)
    assert HyperparamSweep(spec, {"lr": [1e-4, 1e-3]}, device="cpu").grid == {
        "learning_rate": [1e-4, 1e-3]}


MACHINE = {
    "name": "sweep-pump",
    "project_name": "sweep-project",
    "dataset": {
        "type": "RandomDataset",
        "tags": ["tag-0", "tag-1", "tag-2"],
        "train_start_date": "2019-01-01T00:00:00+00:00",
        "train_end_date": "2019-01-02T00:00:00+00:00",
        "asset": "gra",
    },
}
LINE = re.compile(r"^trial-(\d+): (.*) loss=(\S+)$")


def _parsed(lines):
    trials = [LINE.match(line) for line in lines[:-1]]
    assert all(trials), lines
    assert lines[-1].startswith("best: ")
    return [(int(m.group(1)), m.group(2), float(m.group(3))) for m in trials], lines[-1]


def test_sweep_command_lines_match_jax(capsys):
    grid = ["--param", "lr=0.00001,0.01", "--param", "b1=0.9,0.8"]
    jax_machine = dict(MACHINE, model={"gordo_tpu.models.AutoEncoder": {
        "kind": "feedforward_hourglass", "epochs": 2, "batch_size": 16}})
    port_machine = dict(MACHINE, model={"gordo_tpu_torch.models.AutoEncoder": {
        "kind": "feedforward_hourglass", "epochs": 2, "batch_size": 16}})
    result = CliRunner().invoke(jax_gordo, ["sweep", json.dumps(jax_machine), *grid])
    assert result.exit_code == 0, result.output
    jax_lines = [line for line in result.output.splitlines() if line.startswith(("trial-", "best"))]
    assert cli.main(["sweep", json.dumps(port_machine), *grid, "--device", "cpu"]) == 0
    port_lines = capsys.readouterr().out.strip().splitlines()
    jax_trials, jax_best = _parsed(jax_lines)
    port_trials, port_best = _parsed(port_lines)
    # the same trials, best first, and the same best point (the grid's
    # losses are far apart); the losses themselves come from each
    # package's own init
    assert [t[:2] for t in port_trials] == [t[:2] for t in jax_trials]
    assert port_best == jax_best == "best: learning_rate=0.01 b1=0.8"
    assert [t[2] for t in port_trials] == sorted(t[2] for t in port_trials)


def test_sweep_command_usage_errors(capsys):
    machine = json.dumps(dict(MACHINE, model={"gordo_tpu_torch.models.AutoEncoder": {
        "kind": "feedforward_hourglass"}}))
    for params, message in ((["lr=1,2", "b1=0.9"], "same number of values"),
                            (["lr"], "name=v1,v2"), (["lr=a,b"], "must be numbers")):
        args = [a for p in params for a in ("--param", p)]
        with pytest.raises(SystemExit) as exit_info:
            cli.main(["sweep", machine, *args, "--device", "cpu"])
        assert exit_info.value.code == 2
        assert message in capsys.readouterr().err
