"""
Launch a CPU (gloo) cluster of the port's ranks for a test: each rank is a
process running ``tests/_torch_distributed_worker.py``, which imports
torch and the port only; the ranks meet through a ``file://`` rendezvous
in the test's own directory, so parallel test workers never share a port.
"""

import json
import os
import subprocess
import sys
from typing import List

import numpy as np

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_torch_distributed_worker.py")

#: torchrun's and JAX's variables, which would steer initialize()
_CLUSTER_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
                "COORDINATOR_ADDRESS", "JAX_COORDINATOR_ADDRESS",
                "MEGASCALE_COORDINATOR_ADDRESS", "TPU_WORKER_HOSTNAMES")


def run_cluster(task: str, world: int, directory, config: dict, inputs: dict,
                timeout: float = 240.0) -> List[dict]:
    """Run ``task`` on ``world`` ranks; each rank's outputs by name."""
    directory = str(directory)
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "config.json"), "w") as fh:
        json.dump(config, fh)
    np.savez(os.path.join(directory, "inputs.npz"), **inputs)
    env = {key: value for key, value in os.environ.items() if key not in _CLUSTER_ENV}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen([sys.executable, WORKER, task, str(rank), str(world), directory],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env)
             for rank in range(world)]
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=timeout)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for rank, (proc, log) in enumerate(zip(procs, logs)):
        assert proc.returncode == 0, f"rank {rank} of {task} failed:\n{log[-4000:]}"
    outs = []
    for rank in range(world):
        with np.load(os.path.join(directory, f"out{rank}.npz")) as npz:
            outs.append({key: npz[key] for key in npz.files})
    return outs
