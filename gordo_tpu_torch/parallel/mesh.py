"""
Device meshes and placements over ``torch.distributed`` ranks (the port
of ``gordo_tpu.parallel.mesh``).

One rank is one device: a card under the ``nccl`` backend, the CPU under
``gloo`` (``parallel/distributed.py`` starts the process group). A mesh is
a ``torch.distributed.device_mesh.DeviceMesh`` over the group's ranks,
with named axes:

- ``fleet``: the machine axis; each rank trains its slice of a fleet's
  stacked machines (``parallel/fleet.py``);
- ``data``: within-model data parallelism, the batch split over the
  ranks and the gradients averaged (``parallel/data_parallel.py``);
- ``seq`` (``parallel/sequence.py``): a window's timesteps split over the
  ranks (ring and Ulysses attention, ``parallel/long_context.py``).

``fleet_sharding`` and ``replicated_sharding`` are the DTensor placements
(``Shard(0)`` on the axis, ``Replicate()``) of an array laid out as the
JAX package's ``NamedSharding`` lays it.
"""

import logging
from typing import List, Optional, Sequence, Tuple

logger = logging.getLogger(__name__)

FLEET_AXIS = "fleet"
DATA_AXIS = "data"


def _world() -> Tuple[int, str]:
    """(world size, device type) of the initialized process group."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "torch.distributed is not initialized: call "
            "gordo_tpu_torch.parallel.distributed.initialize first"
        )
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return dist.get_world_size(), device_type


def auto_device_mesh():
    """The default fleet mesh when the process group holds more than one
    rank, else None (a one-rank program skips sharding entirely). The one
    place the "should this process shard?" policy lives."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return get_device_mesh()
    return None


def get_device_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = (FLEET_AXIS,),
):
    """A ``DeviceMesh`` over the process group's ranks; by default 1-D over
    every rank, its axis named ``fleet``. Raises when ``shape`` needs more
    ranks than the group has."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    n_ranks, device_type = _world()
    if shape is None:
        shape = (n_ranks,) + (1,) * (len(axis_names) - 1)
    n_needed = 1
    for size in shape:
        n_needed *= int(size)
    if n_needed > n_ranks:
        raise ValueError(
            f"Mesh shape {tuple(shape)} needs {n_needed} devices; only {n_ranks} available"
        )
    ranks = torch.arange(n_needed).reshape(tuple(shape))
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(axis_names))


def axis_size(mesh, axis: str) -> int:
    """The number of ranks along ``axis`` of ``mesh``."""
    return int(mesh.shape[list(mesh.mesh_dim_names).index(axis)])


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` of ``mesh``."""
    return int(mesh.get_local_rank(axis))


def fleet_sharding(mesh, axis: str = FLEET_AXIS) -> List:
    """Placements sharding an array's leading (machine) dimension over
    ``axis`` and replicating it over the mesh's other axes."""
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(0) if name == axis else Replicate() for name in mesh.mesh_dim_names]


def replicated_sharding(mesh) -> List:
    """Placements replicating an array over every axis of ``mesh``."""
    from torch.distributed.tensor import Replicate

    return [Replicate() for _ in mesh.mesh_dim_names]


def pad_to_multiple(n: int, multiple: int) -> int:
    """Smallest value >= n divisible by ``multiple``."""
    return ((n + multiple - 1) // multiple) * multiple
