"""
The snapshot a serving process answers ``/telemetry/snapshot`` with (the
port of ``gordo_tpu.observability.rollup.snapshot_payload``): its whole
metrics registry and its identity, versioned, the one shape every member
of a serving plane speaks.

The JAX module's poller, merge, signals and persistence (the router's
plane rollup) are not ported (ROADMAP.md queue 1 item 9).
"""

import os
import time
from typing import Optional, Tuple

from gordo_tpu_torch.observability.registry import get_registry

#: bumped when the payload changes shape (the JAX module's number)
SNAPSHOT_VERSION = 1

#: module import time: the uptime epoch of a process that passes none
_PROCESS_STARTED_AT = time.time()


def _now_stamp(now: Optional[float] = None) -> Tuple[str, int]:
    now = time.time() if now is None else now
    ts = time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(now)) + "Z"
    return ts, int(now * 1000)


def snapshot_payload(
    role: str,
    replica_id: Optional[str] = None,
    revision: Optional[str] = None,
    status: Optional[dict] = None,
    registry=None,
    started_at: Optional[float] = None,
    now: Optional[float] = None,
) -> dict:
    """The versioned ``/telemetry/snapshot`` body: the registry's
    snapshot and the process's identity, with the JAX payload's keys."""
    registry = registry if registry is not None else get_registry()
    started = _PROCESS_STARTED_AT if started_at is None else started_at
    ts, unix_ms = _now_stamp(now)
    return {
        "snapshot_version": SNAPSHOT_VERSION,
        "role": role,
        "replica_id": replica_id,
        "revision": revision,
        "pid": os.getpid(),
        "uptime_s": max(0.0, (unix_ms / 1000.0) - started),
        "ts": ts,
        "unix_ms": unix_ms,
        "metrics": registry.snapshot(),
        "status": status or {},
    }
