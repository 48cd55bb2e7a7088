"""
One rank of a CPU (gloo) cluster for the port's multi-rank tests; not a
pytest file (the leading underscore keeps collection away). It imports
torch and the port only.

    python tests/_torch_distributed_worker.py TASK RANK WORLD DIR

The ranks meet through ``file://DIR/rendezvous`` (no port to collide on
between test workers), read ``DIR/config.json`` and ``DIR/inputs.npz``,
run TASK and write ``DIR/out<RANK>.npz``. Where a test holds a task to
the JAX package, the inputs carry JAX's initial weights (``init.``) and
shuffle draws (``noise.``), which the task puts in place of the port's.
"""

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gordo_tpu_torch.parallel import distributed  # noqa: E402
from gordo_tpu_torch.parallel.mesh import DATA_AXIS, get_device_mesh  # noqa: E402


def _tensors(arrays, prefix):
    return {key[len(prefix):]: arrays[key] for key in arrays.files if key.startswith(prefix)}


def _noise_row(arrays, n_samples, epoch):
    """JAX's shuffle draws of ``n_samples`` in ``epoch``, one row."""
    return torch.from_numpy(arrays[f"noise.{n_samples}.{epoch}"])[None]


def sequence(config, arrays, out):
    from gordo_tpu_torch.parallel.sequence import SEQ_AXIS, sequence_sharded_attention

    mesh = get_device_mesh(axis_names=(SEQ_AXIS,))
    q, k, v = (torch.tensor(arrays[name], requires_grad=True) for name in ("q", "k", "v"))
    cot = torch.tensor(arrays["cot"])
    for impl in ("ring", "ulysses"):
        for causal in (False, True):
            got = sequence_sharded_attention(q, k, v, mesh, impl=impl, causal=causal)
            grads = torch.autograd.grad((got * cot).sum(), (q, k, v))
            tag = f"{impl}-{int(causal)}"
            out[f"{tag}-out"] = got.detach().numpy()
            for name, grad in zip(("dq", "dk", "dv"), grads):
                out[f"{tag}-{name}"] = grad.numpy()


def long_context(config, arrays, out):
    from gordo_tpu_torch.parallel.long_context import LongContextTrainer
    from gordo_tpu_torch.parallel.sequence import SEQ_AXIS

    mesh = get_device_mesh(axis_names=(SEQ_AXIS,))
    for impl in ("ring", "ulysses"):
        for remat in (False, True):
            trainer = LongContextTrainer(config["n_features"], mesh, attention_impl=impl,
                                         remat=remat, device="cpu", **config["net"])
            params, opt_state = trainer.init(params=_tensors(arrays, "param."))
            losses = []
            for _ in range(config["steps"]):
                params, opt_state, loss = trainer.train_step(
                    params, opt_state, arrays["windows"], arrays["targets"])
                losses.append(float(loss))
            tag = f"{impl}-{int(remat)}"
            out[f"{tag}-losses"] = np.array(losses)
            for name, value in params.items():
                out[f"{tag}-param.{name}"] = value.numpy()
            out[f"{tag}-predict"] = trainer.predict(params, arrays["windows"])


def data_parallel(config, arrays, out):
    from gordo_tpu_torch.models.factories.feedforward import feedforward_hourglass
    from gordo_tpu_torch.models.factories.transformer import transformer_model
    from gordo_tpu_torch.parallel.data_parallel import DataParallelTrainer

    mesh = get_device_mesh(axis_names=(DATA_AXIS,))
    for model in ("feedforward", "transformer"):
        for zero1 in (False, True):
            if model == "feedforward":
                spec = feedforward_hourglass(n_features=config["n_features"])
            else:
                spec = transformer_model(**config["transformer"])
            trainer = DataParallelTrainer(spec, mesh, zero1=zero1, device="cpu")
            params, opt_state = trainer.init(params=_tensors(arrays, f"{model}.param."))
            xb = trainer.shard_batch(arrays[f"{model}.x"])
            yb = trainer.shard_batch(arrays[f"{model}.y"])
            losses = []
            for _ in range(config["steps"]):
                params, opt_state, loss = trainer.train_step(params, opt_state, xb, yb)
                losses.append(float(loss))
            tag = f"{model}-{int(zero1)}"
            out[f"{tag}-losses"] = np.array(losses)
            for name, value in params.items():
                out[f"{tag}-param.{name}"] = value.numpy()


def fleet(config, arrays, out):
    from gordo_tpu_torch.models.factories.feedforward import feedforward_hourglass
    from gordo_tpu_torch.parallel.fleet import FleetTrainer, StackedData

    mesh = get_device_mesh()
    n = config["n_machines"]
    Xs = [arrays[f"X{i}"] for i in range(n)]
    data = StackedData.from_ragged(Xs, [x.copy() for x in Xs], device="cpu")
    trainer = FleetTrainer(feedforward_hourglass(n_features=Xs[0].shape[1]), device="cpu",
                           mesh=mesh)
    params, losses = trainer.fit(data, seeds=list(range(n)), epochs=config["epochs"],
                                 batch_size=config["batch_size"])
    out["losses"] = losses
    for name, value in params.items():
        out[f"param.{name}"] = value.numpy()
    out["predict"] = trainer.predict(params, data.X)
    # fewer machines, padded to the mesh, from the given stacked weights, unshuffled
    n_pad = config["pad_machines"]
    data = StackedData.from_ragged(Xs[:n_pad], [x.copy() for x in Xs[:n_pad]],
                                   n_machines_padded=FleetTrainer.pad_fleet_size(n_pad, mesh),
                                   device="cpu")
    init = {name: torch.tensor(value) for name, value in _tensors(arrays, "init.").items()}
    params, losses = trainer.fit(data, params=init, epochs=config["epochs"],
                                 batch_size=config["batch_size"], shuffle=False)
    out["pad-losses"] = losses
    for name, value in params.items():
        out[f"pad-param.{name}"] = value.numpy()
    out["pad-predict"] = trainer.predict(params, data.X)


def fleet_build(config, arrays, out):
    from gordo_tpu_torch.builder.build_model import fitted_estimator
    from gordo_tpu_torch.builder.fleet_build import FleetModelBuilder
    from gordo_tpu_torch.machine import Machine
    from gordo_tpu_torch.models import AutoEncoder
    from gordo_tpu_torch.parallel.fleet import FleetTrainer
    from gordo_tpu_torch.parallel.mesh import auto_device_mesh

    init = _tensors(arrays, "init.")
    AutoEncoder._initial_state = lambda self, spec, seed: {
        name: torch.tensor(value) for name, value in init.items()}
    FleetTrainer._shuffle_noise = lambda self, m, n_samples, epoch: _noise_row(
        arrays, n_samples, epoch).expand(m, -1)
    machines = [Machine.from_config(dict(c), project_name=c["project_name"])
                for c in config["machines"]]
    builder = FleetModelBuilder(machines, device="cpu", mesh=auto_device_mesh())
    for model, machine in builder.build():
        state = fitted_estimator(model).spec_.module.state_dict()
        for name, value in state.items():
            out[f"{machine.name}.{name}"] = value.numpy()
    out["n_machines_padded"] = np.array([r["n_machines_padded"]
                                         for r in builder.bucket_reports_])


def sweep(config, arrays, out):
    from gordo_tpu_torch.models.factories.feedforward import feedforward_hourglass
    from gordo_tpu_torch.parallel.mesh import auto_device_mesh
    from gordo_tpu_torch.parallel.sweep import HyperparamSweep

    sweeper = HyperparamSweep(feedforward_hourglass(n_features=arrays["X"].shape[1]),
                              config["grid"], device="cpu", mesh=auto_device_mesh())
    trainer = sweeper.trainer
    init = _tensors(arrays, "init.")
    trainer.init_params = lambda seeds: trainer.stack_params([init] * len(seeds))
    trainer._shuffle_noise = lambda m, n_samples, epoch: _noise_row(arrays, n_samples, epoch)
    result = sweeper.fit(arrays["X"], epochs=config["epochs"], batch_size=config["batch_size"])
    out["losses"] = result.losses
    out["n_padded"] = np.array(sweeper.n_padded)
    for name, value in result.params.items():
        out[f"param.{name}"] = value.numpy()


TASKS = {"sequence": sequence, "long_context": long_context,
         "data_parallel": data_parallel, "fleet": fleet, "fleet_build": fleet_build,
         "sweep": sweep}


def main() -> None:
    task, rank, world, directory = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    torch.manual_seed(0)
    with open(os.path.join(directory, "config.json")) as fh:
        config = json.load(fh)
    arrays = np.load(os.path.join(directory, "inputs.npz"))
    distributed.initialize(f"file://{os.path.join(directory, 'rendezvous')}", world, rank,
                           device="cpu")
    out = {}
    try:
        TASKS[task](config, arrays, out)
    finally:
        distributed.shutdown()
    np.savez(os.path.join(directory, f"out{rank}.npz"), **out)


if __name__ == "__main__":
    main()
