"""
Multi-process start-up on ``torch.distributed`` (the port of
``gordo_tpu.parallel.distributed``)::

    from gordo_tpu_torch.parallel import distributed
    distributed.initialize()          # from the environment (torchrun)
    mesh = distributed.global_mesh()  # spans every rank

One process is one rank is one device. The backend follows the device:
``nccl`` for a card (the rank's card chosen with ``torch.cuda.set_device``
by ``LOCAL_RANK``, else the rank modulo the cards it sees), ``gloo`` for
the CPU (``device="cpu"``); no silent switch between them. Where the JAX
package sets XLA's CPU collectives to gloo (``_enable_cpu_collectives``),
the port has nothing to do: gloo is its CPU backend.

``initialize`` takes JAX's arguments: ``coordinator_address`` becomes
``init_method="tcp://<address>"`` (an address with a scheme, such as
``file://<path>``, is taken as it is), ``num_processes`` the world size
and ``process_id`` the rank. With no arguments it is a no-op unless the
environment names a coordinator: torchrun's ``MASTER_ADDR``,
``WORLD_SIZE`` and ``RANK`` (``init_method="env://"``), the port's
counterpart of JAX's auto-detection, or one of JAX's four variables
(``COORDINATOR_ADDRESS``, ``JAX_COORDINATOR_ADDRESS``,
``MEGASCALE_COORDINATOR_ADDRESS``, ``TPU_WORKER_HOSTNAMES``), with the
world size and rank from ``WORLD_SIZE`` and ``RANK``. A second call is a
no-op, and so is a call in a process whose group is already up.

Fleet training needs no collective between machines (each rank trains
its slice of the stack and the host reads are all-gathered); within-model
data parallelism averages gradients over the mesh's ``data`` axis, and
sequence parallelism rotates or exchanges keys and values over its
``seq`` axis.
"""

import logging
import os
from typing import Optional, Sequence, Tuple

from gordo_tpu_torch.device import DeviceLike, resolve_device
from gordo_tpu_torch.parallel.mesh import FLEET_AXIS, get_device_mesh

logger = logging.getLogger(__name__)

#: the JAX package's multi-host variables
JAX_COORDINATOR_ENV = (
    "COORDINATOR_ADDRESS",
    "JAX_COORDINATOR_ADDRESS",
    "MEGASCALE_COORDINATOR_ADDRESS",
    "TPU_WORKER_HOSTNAMES",
)
#: torchrun's
TORCHRUN_ENV = ("MASTER_ADDR", "WORLD_SIZE", "RANK")

#: JAX's default coordinator port, for a host list without one
_DEFAULT_PORT = 8476

_initialized = False


def _env_coordinator() -> Optional[str]:
    """The coordinator address JAX's variables name, if one does."""
    for var in JAX_COORDINATOR_ENV[:3]:
        if os.environ.get(var):
            return os.environ[var]
    hosts = os.environ.get("TPU_WORKER_HOSTNAMES")
    if hosts:
        return f"{hosts.split(',')[0].strip()}:{_DEFAULT_PORT}"
    return None


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return None if value in (None, "") else int(value)


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: DeviceLike = None,
) -> None:
    """
    Start the process group for a multi-process run on ``device`` (the
    card unless ``"cpu"``). A no-op in a single-process environment
    (module docstring), on a second call, or when the group is already up.
    """
    global _initialized
    if _initialized:
        return
    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        _initialized = True
        return
    torchrun_env = all(var in os.environ for var in TORCHRUN_ENV)
    jax_env = any(var in os.environ for var in JAX_COORDINATOR_ENV)
    if coordinator_address is None and num_processes is None and not (torchrun_env or jax_env):
        logger.info("Single-process environment; skipping torch.distributed initialization")
        return
    device = resolve_device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if coordinator_address is None and not torchrun_env:
        coordinator_address = _env_coordinator()
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    world_size = num_processes if num_processes is not None else _env_int("WORLD_SIZE")
    rank = process_id if process_id is not None else _env_int("RANK")
    if world_size is None or rank is None:
        raise ValueError(
            "torch.distributed needs the number of processes and this process's id: pass "
            "num_processes and process_id, or set WORLD_SIZE and RANK"
        )
    if device.type == "cuda":
        local = _env_int("LOCAL_RANK")
        torch.cuda.set_device(local if local is not None else rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, world_size=int(world_size),
                            rank=int(rank))
    _initialized = True
    logger.info("torch.distributed initialized (%s): process %d of %d", backend, rank,
                world_size)


def shutdown() -> None:
    """Tear the process group down (every rank calls it); a no-op when
    none is up."""
    global _initialized
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _initialized = False


def global_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = (FLEET_AXIS,),
):
    """A mesh spanning every rank of the process group."""
    return get_device_mesh(shape=shape, axis_names=axis_names)


def process_info() -> dict:
    """The process topology for logs and build metadata, by JAX's keys:
    one device a rank, so each process has one local device and the
    world size is the global device count."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        index, count = dist.get_rank(), dist.get_world_size()
    else:
        index, count = 0, 1
    return {
        "process_index": index,
        "process_count": count,
        "local_device_count": 1,
        "global_device_count": count,
    }
