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
The JAX tracker's Prometheus gauge and events are not ported
(ROADMAP.md queue 1 item 9).
"""

import random
import threading
import time
from typing import Callable, Dict, Iterable, Optional

from gordo_tpu_torch.utils.utils import backoff_seconds

HEALTHY = "healthy"
EJECTED = "ejected"
PROBATION = "probation"
#: the jitter fraction of the ejection windows
RETRY_JITTER = 0.25


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

    # -- membership ------------------------------------------------------
    def ensure(self, replicas: Iterable[str]) -> None:
        """Track new replica ids; known ones keep their state (re-adding a
        live replica must not close an open breaker)."""
        with self._lock:
            for replica in replicas:
                self._states.setdefault(replica, _ReplicaState())

    def forget(self, replica: str) -> None:
        """Drop a replica taken out of the membership."""
        with self._lock:
            self._states.pop(replica, None)

    # -- queries ---------------------------------------------------------
    def state(self, replica: str) -> str:
        with self._lock:
            entry = self._states.get(replica)
            if entry is None:
                return EJECTED
            self._maybe_expire(entry)
            return entry.state

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
        with self._lock:
            for replica, entry in self._states.items():
                self._maybe_expire(entry)
                out[replica] = {
                    "state": entry.state,
                    "consecutive_failures": entry.consecutive_failures,
                    "ejections": entry.ejections,
                    "retry_in_s": (round(max(0.0, entry.eject_until - self._now()), 3)
                                   if entry.state == EJECTED else 0.0),
                }
        return out

    def retry_after_s(self, replica: str) -> float:
        """Seconds until the replica's window ends (0 when routable)."""
        with self._lock:
            entry = self._states.get(replica)
            if entry is None or entry.state != EJECTED:
                return 0.0
            return max(0.0, entry.eject_until - self._now())

    # -- transitions -----------------------------------------------------
    def record_success(self, replica: str) -> None:
        with self._lock:
            entry = self._states.get(replica)
            if entry is None:
                return
            self._maybe_expire(entry)
            entry.consecutive_failures = 0
            if entry.state in (PROBATION, EJECTED):
                # a success on an ejected replica (a probe racing its
                # window, a hedge that landed) closes the breaker too
                entry.state = HEALTHY
                entry.ejections = 0

    def record_failure(self, replica: str) -> bool:
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
            backoff = backoff_seconds(entry.ejections, jitter=RETRY_JITTER, rng=self._rng)
            entry.eject_until = self._now() + backoff * self.backoff_scale
            return True

    def note_probe(self, replica: str, ok: bool) -> None:
        """An active ``/healthz`` probe's outcome: a success moves an
        expired ejection to probation (real traffic has the last word)."""
        if not ok:
            self.record_failure(replica)
            return
        with self._lock:
            entry = self._states.get(replica)
            if entry is not None and entry.state == EJECTED and self._now() >= entry.eject_until:
                entry.state = PROBATION
                entry.consecutive_failures = 0

    def _maybe_expire(self, entry: _ReplicaState) -> None:
        """Ejected -> probation once the window passed, without a prober
        (the caller holds the lock)."""
        if self.lazy_half_open and entry.state == EJECTED and self._now() >= entry.eject_until:
            entry.state = PROBATION
            entry.consecutive_failures = 0
