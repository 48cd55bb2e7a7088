"""
The routing tier (the port of ``gordo_tpu.router``): one collection's
machines partitioned across N ``run-server`` replicas by a consistent
hash ring (``ring.py``), fleet requests fanned out to the owners and
joined again, and a replica's death absorbed by ejection and failover to
ring successors (``health.py``, ``app.py``). The router touches no model
and no card: it reads the collection's directory and build report.
"""

from gordo_tpu_torch.router.health import ReplicaHealthTracker
from gordo_tpu_torch.router.ring import DEFAULT_VNODES, HashRing

__all__ = ["DEFAULT_VNODES", "HashRing", "ReplicaHealthTracker"]
