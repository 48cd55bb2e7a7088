"""
Each replica's health as the router sees it: a circuit breaker (the port
of ``gordo_tpu.router.health``).

- ``healthy``: routable; ``eject_after`` consecutive failures (request
  outcomes, or failed ``/healthz`` probes) eject it.
- ``ejected``: not routable, its shard routed to ring successors, for a
  window of the house retry policy (8, 16, 32 s, ..., each less up to a
  quarter of jitter) scaled by ``backoff_scale`` and growing with
  consecutive ejections.
- ``probation``: the window passed (and, with active probing, a probe
  answered): routable again, but the first failure ejects it with a
  longer window and the first success makes it ``healthy``.

Request outcomes drive it; the router's prober only shortens the
ejected-to-probation leg, so the tracker works the same without one.
``gordo_router_replica_healthy{replica}`` is 1 while a replica is
routable and 0 while it is ejected, as the JAX tracker's gauge; a
forgotten replica's series is removed. An ejection writes a
``replica_ejected`` event (``via`` a request or a probe, the consecutive
failures, the window's seconds), and the success that closes the breaker
a ``replica_recovered`` one; a probe's success only moves the replica to
probation, so the recovery waits for real traffic.
"""

import random
import threading
import time
from typing import Callable, Dict, Iterable, Optional

from gordo_tpu_torch.observability.events import emit_event
from gordo_tpu_torch.observability.registry import get_registry
from gordo_tpu_torch.utils.utils import backoff_seconds

HEALTHY = "healthy"
EJECTED = "ejected"
PROBATION = "probation"
#: the jitter fraction of the ejection windows
RETRY_JITTER = 0.25


def _healthy_gauge():
    return get_registry().gauge(
        "gordo_router_replica_healthy",
        "1 while the router considers the replica routable "
        "(healthy/probation), 0 while ejected",
        ("replica",),
    )


class _ReplicaState:
    __slots__ = ("state", "consecutive_failures", "ejections", "eject_until")

    def __init__(self):
        self.state = HEALTHY
        self.consecutive_failures = 0
        #: consecutive ejections since the last recovery: the backoff's step
        self.ejections = 0
        self.eject_until = 0.0


class ReplicaHealthTracker:
    """Thread-safe health of a set of replica ids. ``backoff_scale`` maps
    the 8/16/32 s schedule onto serving timescales (0.25: 2/4/8 s);
    ``now`` and ``rng`` (the jitter's stream) are injectable for tests."""

    def __init__(self, replicas: Iterable[str], eject_after: int = 3,
                 backoff_scale: float = 0.25, lazy_half_open: bool = True,
                 now: Callable[[], float] = time.monotonic,
                 rng: Optional[random.Random] = None):
        self.eject_after = max(1, int(eject_after))
        self.backoff_scale = float(backoff_scale)
        #: without a prober the window's end alone re-admits a replica;
        #: with one the probe does
        self.lazy_half_open = bool(lazy_half_open)
        self._now = now
        self._rng = rng if rng is not None else random.Random()
        self._lock = threading.Lock()
        self._states: Dict[str, _ReplicaState] = {r: _ReplicaState() for r in replicas}
        gauge = _healthy_gauge()
        for replica in self._states:
            gauge.set(1, replica=replica)

    # -- membership ------------------------------------------------------
    def ensure(self, replicas: Iterable[str]) -> None:
        """Track new replica ids; known ones keep their state (re-adding a
        live replica must not close an open breaker)."""
        with self._lock:
            fresh = [r for r in replicas if r not in self._states]
            for replica in fresh:
                self._states[replica] = _ReplicaState()
        for replica in fresh:
            _healthy_gauge().set(1, replica=replica)

    def forget(self, replica: str) -> None:
        """Drop a replica taken out of the membership."""
        with self._lock:
            self._states.pop(replica, None)
        _healthy_gauge().remove(replica=replica)

    # -- queries ---------------------------------------------------------
    def state(self, replica: str) -> str:
        with self._lock:
            entry = self._states.get(replica)
            if entry is None:
                return EJECTED
            flipped = self._maybe_expire(entry)
            state = entry.state
        if flipped:
            _healthy_gauge().set(1, replica=replica)
        return state

    def routable(self, replica: str) -> bool:
        """Healthy or on probation: the router may send it traffic."""
        return self.state(replica) != EJECTED

    def probe_due(self, replica: str) -> bool:
        """Ejected and past its window: the prober should ask now."""
        with self._lock:
            entry = self._states.get(replica)
            return (entry is not None and entry.state == EJECTED
                    and self._now() >= entry.eject_until)

    def snapshot(self) -> Dict[str, dict]:
        """Each replica's state, for ``/healthz`` and ``/router/replicas``."""
        out: Dict[str, dict] = {}
        flipped = []
        with self._lock:
            for replica, entry in self._states.items():
                if self._maybe_expire(entry):
                    flipped.append(replica)
                out[replica] = {
                    "state": entry.state,
                    "consecutive_failures": entry.consecutive_failures,
                    "ejections": entry.ejections,
                    "retry_in_s": (round(max(0.0, entry.eject_until - self._now()), 3)
                                   if entry.state == EJECTED else 0.0),
                }
        for replica in flipped:
            _healthy_gauge().set(1, replica=replica)
        return out

    def retry_after_s(self, replica: str) -> float:
        """Seconds until the replica's window ends (0 when routable)."""
        with self._lock:
            entry = self._states.get(replica)
            if entry is None or entry.state != EJECTED:
                return 0.0
            return max(0.0, entry.eject_until - self._now())

    # -- transitions -----------------------------------------------------
    def record_success(self, replica: str, via: str = "request") -> None:
        with self._lock:
            entry = self._states.get(replica)
            if entry is None:
                return
            self._maybe_expire(entry)
            entry.consecutive_failures = 0
            recovered = entry.state in (PROBATION, EJECTED)
            if recovered:
                # a success on an ejected replica (a probe racing its
                # window, a hedge that landed) closes the breaker too
                entry.state = HEALTHY
                entry.ejections = 0
        if recovered:
            _healthy_gauge().set(1, replica=replica)
            emit_event("replica_recovered", replica=replica, via=via)

    def record_failure(self, replica: str, via: str = "request") -> bool:
        """One failed call or probe; True when it ejected the replica."""
        with self._lock:
            entry = self._states.get(replica)
            if entry is None:
                return False
            self._maybe_expire(entry)
            entry.consecutive_failures += 1
            eject = entry.state == PROBATION or entry.consecutive_failures >= self.eject_after
            if not eject or entry.state == EJECTED:
                return False
            entry.state = EJECTED
            entry.ejections += 1
            failures = entry.consecutive_failures
            backoff = backoff_seconds(entry.ejections, jitter=RETRY_JITTER,
                                      rng=self._rng) * self.backoff_scale
            entry.eject_until = self._now() + backoff
        _healthy_gauge().set(0, replica=replica)
        emit_event("replica_ejected", replica=replica, via=via, consecutive_failures=failures,
                   backoff_s=round(backoff, 3))
        return True

    def note_probe(self, replica: str, ok: bool) -> None:
        """An active ``/healthz`` probe's outcome: a success moves an
        expired ejection to probation (real traffic has the last word)."""
        if not ok:
            self.record_failure(replica, via="probe")
            return
        with self._lock:
            entry = self._states.get(replica)
            if entry is not None and entry.state == EJECTED and self._now() >= entry.eject_until:
                entry.state = PROBATION
                entry.consecutive_failures = 0
        # probation is routable
        if self.state(replica) == PROBATION:
            _healthy_gauge().set(1, replica=replica)

    def _maybe_expire(self, entry: _ReplicaState) -> bool:
        """Ejected -> probation once the window passed, without a prober
        (the caller holds the lock); True when it flipped, so the caller
        sets the gauge outside the lock."""
        if self.lazy_half_open and entry.state == EJECTED and self._now() >= entry.eject_until:
            entry.state = PROBATION
            entry.consecutive_failures = 0
            return True
        return False
