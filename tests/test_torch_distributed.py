"""
The port's process-group start-up and mesh (``parallel/distributed.py``,
``parallel/mesh.py``), as ``tests/test_distributed.py`` holds JAX's:
``initialize`` is a no-op in a single process, starts from torchrun's or
JAX's variables, or takes explicit arguments, and runs once;
``process_info`` keeps JAX's keys. Then the counterpart of JAX's
``test_two_process_fleet_step_executes``: 2 gloo ranks train a
4-machine fleet for 2 epochs, each rank its slice, agree on the whole
fleet's losses and parameters, and match a one-process fit within 1e-5;
a ``FleetModelBuilder`` over 2 ranks pads a bucket of 3 machines to 4
and builds what one process builds; and a ``HyperparamSweep`` of 3
variants over 2 ranks pads them to 4 and reports what one process does.

Each of the three is also held to the JAX package's sharded counterpart
on 2 virtual devices (``FleetTrainer``, ``FleetModelBuilder`` and
``HyperparamSweep`` with ``mesh=``), from JAX's initial weights (carried
across by ``convert.feedforward_state_dict``) and, where the fit
shuffles, JAX's shuffle draws: a 3-machine fleet padded to 4 and fitted
unshuffled, the padded build and the padded sweep. Tolerances against
JAX: losses rtol 1e-4, parameters atol 1e-5 (float32 in another
summation order, as ``tests/test_torch_fleet.py``).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gordo_tpu.models.core import solo_init_key
from gordo_tpu.parallel.mesh import get_device_mesh as jax_mesh
from gordo_tpu_torch.convert import feedforward_state_dict
from gordo_tpu_torch.parallel import distributed, mesh
from gordo_tpu_torch.parallel.fleet import FleetTrainer, StackedData, host_fetch
from gordo_tpu_torch.workflow.yaml_reader import safe_load
from tests.torch_distributed_helpers import run_cluster

ATOL = 1e-5
JAX_RTOL = 1e-4
N_MACHINES, EPOCHS, BATCH = 4, 2, 16
# the fleet held to JAX: 3 machines padded to 4 over 2 ranks
N_PAD = 3


@pytest.fixture
def recorded(monkeypatch):
    """torch.distributed's start-up replaced by a recorder."""
    calls = []
    monkeypatch.setattr(distributed, "_initialized", False)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **kw: calls.append(dict(kw, backend=backend)))
    for var in distributed.JAX_COORDINATOR_ENV + distributed.TORCHRUN_ENV + ("LOCAL_RANK",):
        monkeypatch.delenv(var, raising=False)
    return calls


def test_initialize_noop_single_process(recorded):
    distributed.initialize(device="cpu")
    assert recorded == []
    assert distributed._initialized is False


def test_initialize_from_torchrun_env(recorded, monkeypatch):
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "2")
    distributed.initialize(device="cpu")
    assert recorded == [{"backend": "gloo", "init_method": "env://", "world_size": 4,
                         "rank": 2}]
    assert distributed._initialized is True
    distributed.initialize(device="cpu")  # once only
    assert len(recorded) == 1


def test_initialize_from_jax_env(recorded, monkeypatch):
    monkeypatch.setenv("COORDINATOR_ADDRESS", "10.0.0.1:8476")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    distributed.initialize(device="cpu")
    assert recorded == [{"backend": "gloo", "init_method": "tcp://10.0.0.1:8476",
                         "world_size": 2, "rank": 1}]


def test_initialize_jax_env_without_rank_raises(recorded, monkeypatch):
    monkeypatch.setenv("TPU_WORKER_HOSTNAMES", "host-a,host-b")
    with pytest.raises(ValueError, match="WORLD_SIZE and RANK"):
        distributed.initialize(device="cpu")
    assert recorded == []


def test_initialize_explicit_args(recorded):
    distributed.initialize(coordinator_address="host:1234", num_processes=4, process_id=2,
                           device="cpu")
    assert recorded == [{"backend": "gloo", "init_method": "tcp://host:1234", "world_size": 4,
                         "rank": 2}]


def test_initialize_without_a_card_refuses_the_card(recorded, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(Exception):
        distributed.initialize(coordinator_address="host:1234", num_processes=2, process_id=0)
    assert recorded == []


def test_process_info_single_process():
    assert distributed.process_info() == {"process_index": 0, "process_count": 1,
                                          "local_device_count": 1, "global_device_count": 1}


def test_mesh_needs_a_process_group_and_enough_ranks(tmp_path):
    assert mesh.auto_device_mesh() is None
    with pytest.raises(RuntimeError, match="distributed.initialize"):
        mesh.get_device_mesh()
    distributed.initialize(f"file://{tmp_path / 'rendezvous'}", 1, 0, device="cpu")
    try:
        assert distributed.process_info()["process_count"] == 1
        assert mesh.auto_device_mesh() is None  # one rank: no sharding
        fleet = distributed.global_mesh()
        assert fleet.mesh_dim_names == (mesh.FLEET_AXIS,)
        assert mesh.axis_size(fleet, mesh.FLEET_AXIS) == 1
        with pytest.raises(ValueError, match=r"Mesh shape \(2,\) needs 2 devices; only 1"):
            mesh.get_device_mesh((2,))
        assert [type(p).__name__ for p in mesh.fleet_sharding(fleet)] == ["Shard"]
        assert [type(p).__name__ for p in mesh.replicated_sharding(fleet)] == ["Replicate"]
        assert FleetTrainer.pad_fleet_size(3, fleet) == 3
        assert FleetTrainer.pad_fleet_size(3, None) == 3
        assert host_fetch(torch.tensor([True, False]), fleet).tolist() == [True, False]
    finally:
        distributed.shutdown()
    assert mesh.pad_to_multiple(5, 4) == 8 and mesh.pad_to_multiple(8, 4) == 8


def _fleet_data():
    rng = np.random.default_rng(0)
    return [rng.random((64, 3)).astype("float32") for _ in range(N_MACHINES)]


def _unstack(tree, i):
    return jax.tree.map(lambda a: np.asarray(a[i]), tree)


def _jax_padded_fleet_fit(Xs):
    """JAX's fleet fit of the first N_PAD machines padded to a 2-device
    mesh, unshuffled: (stacked port-named initial weights, losses, stacked
    port-named parameters, predictions)."""
    from gordo_tpu.models.factories.feedforward import feedforward_hourglass as jax_hourglass
    from gordo_tpu.parallel.fleet import FleetTrainer as JaxFleetTrainer
    from gordo_tpu.parallel.fleet import StackedData as JaxStackedData

    two = jax_mesh(shape=(2,))
    m_padded = JaxFleetTrainer.pad_fleet_size(N_PAD, two)
    data = JaxStackedData.from_ragged(Xs[:N_PAD], [x.copy() for x in Xs[:N_PAD]],
                                      n_machines_padded=m_padded)
    trainer = JaxFleetTrainer(jax_hourglass(n_features=3), mesh=two)
    keys = trainer.machine_keys(m_padded)
    init = trainer.init_params(keys, 3)
    # read before the fit, which donates its arguments' buffers
    start = jax.device_get(init)
    params, losses = trainer.fit(data, keys, epochs=EPOCHS, batch_size=BATCH, shuffle=False,
                                 params=init)

    def stacked(tree):
        states = [feedforward_state_dict(_unstack(tree, i)) for i in range(m_padded)]
        return {name: np.stack([s[name] for s in states]) for name in states[0]}

    return (stacked(start), np.asarray(losses),
            stacked(jax.device_get(params)), np.asarray(trainer.predict(params, data.X)))


def test_two_rank_fleet_fit_matches_one_process(tmp_path):
    from gordo_tpu_torch.models.factories.feedforward import feedforward_hourglass

    Xs = _fleet_data()
    init, jax_losses, jax_params, jax_predict = _jax_padded_fleet_fit(Xs)
    outs = run_cluster("fleet", 2, tmp_path,
                       {"n_machines": N_MACHINES, "epochs": EPOCHS, "batch_size": BATCH,
                        "pad_machines": N_PAD},
                       {**{f"X{i}": x for i, x in enumerate(Xs)},
                        **{f"init.{name}": value for name, value in init.items()}})
    data = StackedData.from_ragged(Xs, [x.copy() for x in Xs], device="cpu")
    trainer = FleetTrainer(feedforward_hourglass(n_features=3), device="cpu")
    params, losses = trainer.fit(data, seeds=list(range(N_MACHINES)), epochs=EPOCHS,
                                 batch_size=BATCH)
    assert losses.shape == (EPOCHS, N_MACHINES)
    assert np.all(losses[-1] < losses[0])
    # both ranks hold the whole fleet's losses and parameters
    np.testing.assert_array_equal(outs[0]["losses"], outs[1]["losses"])
    for got in outs:
        np.testing.assert_allclose(got["losses"], losses, rtol=0, atol=ATOL)
        for name, value in params.items():
            np.testing.assert_allclose(got[f"param.{name}"], value.numpy(), rtol=0, atol=ATOL)
        np.testing.assert_allclose(got["predict"], trainer.predict(params, data.X), rtol=0,
                                   atol=ATOL)
        # the padded fleet against JAX's sharded trainer, pad machine included
        assert got["pad-losses"].shape == jax_losses.shape == (EPOCHS, 4)
        np.testing.assert_allclose(got["pad-losses"], jax_losses, rtol=JAX_RTOL, atol=1e-7)
        for name, value in jax_params.items():
            np.testing.assert_allclose(got[f"pad-param.{name}"], value, rtol=0, atol=ATOL,
                                       err_msg=name)
        np.testing.assert_allclose(got["pad-predict"], jax_predict, rtol=0, atol=ATOL)


def test_uneven_fleet_is_refused():
    class _Mesh:
        mesh_dim_names = (mesh.FLEET_AXIS,)
        shape = (2,)

        def get_local_rank(self, axis):
            return 0

    from gordo_tpu_torch.models.factories.feedforward import feedforward_hourglass

    Xs = _fleet_data()[:3]
    trainer = FleetTrainer(feedforward_hourglass(n_features=3), device="cpu", mesh=_Mesh())
    data = StackedData.from_ragged(Xs, Xs, device="cpu")
    with pytest.raises(ValueError, match="pad the fleet to FleetTrainer.pad_fleet_size"):
        trainer.fit(data, seeds=[0, 1, 2])
    assert FleetTrainer.pad_fleet_size(3, _Mesh()) == 4


def test_two_rank_fleet_build_pads_and_matches_one_process(tmp_path, monkeypatch):
    from gordo_tpu.builder.fleet_build import FleetModelBuilder as JaxFleetModelBuilder
    from gordo_tpu_torch.builder.build_model import fitted_estimator
    from gordo_tpu_torch.builder.fleet_build import FleetModelBuilder
    from gordo_tpu_torch.machine import Machine
    from gordo_tpu_torch.models import AutoEncoder
    from tests.test_torch_fleet_build import _jax_machines
    from tests.test_torch_pipeline import _jax_initial_state

    with open("examples/machines_fleet.yaml") as fh:
        configs = safe_load(fh.read())
    # a bucket of three pumps (the file's two and a copy): padded to 4 for 2 ranks
    pumps = [c for c in configs if c["name"].startswith("example-pump")]
    pumps.append(dict(copy.deepcopy(pumps[0]), name="example-pump-2"))

    # the one-process build, from JAX's init and shuffle draws (every pump
    # has seed 0), which it records for the ranks
    init, noise = {}, {}

    def jax_init(self, spec, seed):
        state = _jax_initial_state(self, spec, seed)
        init.update({f"init.{name}": value.numpy() for name, value in state.items()})
        return state

    def jax_noise(self, m, n_samples, epoch):
        key = jax.random.fold_in(solo_init_key(0), epoch)
        row = np.asarray(jax.random.uniform(key, (n_samples,)))
        noise[f"noise.{n_samples}.{epoch}"] = row
        return torch.from_numpy(np.stack([row] * m))

    monkeypatch.setattr(AutoEncoder, "_initial_state", jax_init)
    monkeypatch.setattr(FleetTrainer, "_shuffle_noise", jax_noise)
    machines = [Machine.from_config(dict(c), project_name=c["project_name"])
                for c in copy.deepcopy(pumps)]
    builder = FleetModelBuilder(machines, device="cpu")
    built = builder.build()
    assert [r["n_machines_padded"] for r in builder.bucket_reports_] == [len(pumps)]
    outs = run_cluster("fleet_build", 2, tmp_path, {"machines": pumps}, {**init, **noise})

    jax_builder = JaxFleetModelBuilder(_jax_machines(pumps), mesh=jax_mesh(shape=(2,)))
    jax_built = {machine.name: model for model, machine in jax_builder.build()}
    assert [r["n_machines_padded"] for r in jax_builder.telemetry_report_["buckets"]] == [4]
    for got in outs:
        assert got["n_machines_padded"].tolist() == [4]
        for model, machine in built:
            for name, value in fitted_estimator(model).spec_.module.state_dict().items():
                np.testing.assert_allclose(got[f"{machine.name}.{name}"], value.numpy(),
                                           rtol=0, atol=ATOL)
            want = feedforward_state_dict(jax.device_get(jax_built[machine.name].params_))
            for name, value in want.items():
                np.testing.assert_allclose(got[f"{machine.name}.{name}"], value, rtol=0,
                                           atol=ATOL, err_msg=f"{machine.name} {name}")


def test_two_rank_sweep_pads_and_matches_one_process(tmp_path):
    from gordo_tpu_torch.models.factories.feedforward import feedforward_hourglass
    from gordo_tpu_torch.parallel.sweep import HyperparamSweep

    from gordo_tpu.models.factories.feedforward import feedforward_hourglass as jax_hourglass
    from gordo_tpu.parallel import HyperparamSweep as JaxHyperparamSweep

    X = _fleet_data()[0]
    grid = {"lr": [1e-3, 3e-3, 1e-2]}
    jax_sweep = JaxHyperparamSweep(jax_hourglass(n_features=3), grid, mesh=jax_mesh(shape=(2,)))
    assert jax_sweep.n_padded == 4
    want = jax_sweep.fit(X, epochs=EPOCHS, batch_size=BATCH)
    # JAX's init and shuffle draws of the sweep's one key (seed 0)
    jt = jax_sweep.trainer
    key = np.asarray(jt.machine_keys(1, seed=0))[0]
    init = feedforward_state_dict(jax.device_get(
        jax_hourglass(n_features=3).module.init(jnp.asarray(key), jnp.zeros((1, 3)))))
    noise = {f"noise.{len(X)}.{e}": np.asarray(jax.random.uniform(
        jax.random.fold_in(jnp.asarray(key), e), (len(X),))) for e in range(EPOCHS)}
    outs = run_cluster("sweep", 2, tmp_path, {"grid": grid, "epochs": EPOCHS,
                                               "batch_size": BATCH},
                       {"X": X, **{f"init.{k}": v for k, v in init.items()}, **noise})
    sweeper = HyperparamSweep(feedforward_hourglass(n_features=3), grid, device="cpu")
    assert sweeper.n_padded == 3
    trainer = sweeper.trainer
    trainer.init_params = lambda seeds: trainer.stack_params([init] * len(seeds))
    trainer._shuffle_noise = lambda m, n_samples, epoch: torch.from_numpy(
        noise[f"noise.{n_samples}.{epoch}"])[None]
    result = sweeper.fit(X, epochs=EPOCHS, batch_size=BATCH)
    jax_params = jax.device_get(want.params)
    for got in outs:
        assert int(got["n_padded"]) == 4
        assert got["losses"].shape == result.losses.shape == (EPOCHS, 3)
        np.testing.assert_allclose(got["losses"], result.losses, rtol=0, atol=ATOL)
        np.testing.assert_allclose(got["losses"], np.asarray(want.losses), rtol=JAX_RTOL)
        for name, value in result.params.items():
            np.testing.assert_allclose(got[f"param.{name}"][:3], value.numpy(), rtol=0,
                                       atol=ATOL)
        for i in range(3):
            for name, value in feedforward_state_dict(_unstack(jax_params, i)).items():
                np.testing.assert_allclose(got[f"param.{name}"][i], value, rtol=0, atol=ATOL,
                                           err_msg=f"variant {i} {name}")
