"""
Stream sessions (the port of ``gordo_tpu.streaming.session``): the
protocol and state of streaming scoring.

One :class:`StreamSession` an open stream (a group of machines scored
together) holds each machine's device-resident
:class:`~gordo_tpu_torch.streaming.window.MachineWindow`, serializes the
updates and bounds its backlog: an update arriving while ``max_backlog``
are in flight is shed (:class:`StreamShed`, a 503 with ``Retry-After``).
An update is all or nothing: a failed dispatch commits no window.

The :class:`SessionManager` is the table of live sessions, owned by the
serving catalog so that a revision roll expires them as it stops the
old batchers. It is an LRU over an insertion-ordered dict: on the card
the device's free memory (``torch.cuda.mem_get_info``) governs growth
past ``max_sessions`` while it stays above ``GORDO_PROGRAM_MIN_HEADROOM``
(default 0.1); on the CPU, which reports no headroom, the count bound
``GORDO_STREAM_MAX_SESSIONS`` applies. Opening a stream sheds rather
than evict a session that is still active. A lost session is never
fatal: the client resumes by replaying its window tail. An update on a
session that a revision roll expired is told so (``revision_rolled``),
where the JAX server, having dropped it from its table, answers
``unknown_session``.

Left out until ROADMAP.md queue 1 item 9: the attribution ledger,
tracing spans, events and metrics registry of the JAX sessions, their
chaos sites, and the drift feed of each update's anomaly ratio
(:meth:`MachineStream.anomaly_ratio` computes it; an update's ``y`` is
checked, and feeds nothing yet). The session's own counters, which
:meth:`StreamSession.stats` and ``/healthz`` read, are kept.
"""

import logging
import math
import os
import threading
import time
import uuid
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gordo_tpu_torch.device import DeviceLike, resolve_device
from gordo_tpu_torch.parallel import transfer
from gordo_tpu_torch.streaming.window import MachineWindow, SequenceGap, WindowUpdate

logger = logging.getLogger(__name__)

#: default count bound on live sessions
DEFAULT_MAX_SESSIONS = 64
#: default bound on a session's updates in flight
DEFAULT_MAX_BACKLOG = 8
#: a session untouched this long is idle: a new stream may evict it
DEFAULT_IDLE_AFTER_S = 30.0
#: default floor on the device's free memory fraction (the JAX
#: package's ``GORDO_PROGRAM_MIN_HEADROOM`` default)
DEFAULT_MIN_HEADROOM = 0.1
#: the expired sessions whose reason an update still gets
EXPIRED_MEMORY = 1024


class StreamShed(Exception):
    """The session table is full of active streams (open), or this
    session's backlog is saturated (update): a 503 with ``Retry-After``."""

    def __init__(self, message: str, retry_after_s: int):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class StreamGone(Exception):
    """The session cannot go on (unknown or evicted id, revision rolled,
    sequence gap): the update answers the structured resume 409 and the
    client replays its window tail into a new session."""

    def __init__(self, reason: str, machines: Sequence[str] = ()):
        super().__init__(f"Stream session gone ({reason})")
        self.reason = reason
        self.machines = list(machines)


def min_headroom_fraction() -> float:
    raw = os.environ.get("GORDO_PROGRAM_MIN_HEADROOM")
    try:
        return float(raw) if raw not in (None, "") else DEFAULT_MIN_HEADROOM
    except ValueError:
        return DEFAULT_MIN_HEADROOM


def device_headroom(device: DeviceLike = None) -> Optional[float]:
    """The fraction of the card's memory that is free, or None for a
    device that reports none (the CPU)."""
    device = resolve_device(device)
    if device.type != "cuda":
        return None
    free, total = torch.cuda.mem_get_info(device)
    return free / total if total else None


def evict_lru(cache: Dict, bound: int, headroom: Callable[[], Optional[float]]) -> None:
    """Drop the oldest entries of an insertion-ordered dict: none while
    the device reports headroom above the floor, else down to ``bound``
    (at least one entry stays)."""
    free = headroom()
    if free is not None and free >= min_headroom_fraction():
        return
    while len(cache) > max(1, bound):
        cache.pop(next(iter(cache)))


class MachineStream:
    """One machine's part of a session: its window, its host prefix
    transform, and the anomaly-ratio pieces (None unless the model is an
    anomaly detector with a calibrated threshold)."""

    def __init__(self, name: str, lookback: int, lookahead: int, n_features: int,
                 transform: Callable[[np.ndarray], np.ndarray], scaler=None,
                 threshold: Optional[float] = None, device: DeviceLike = None):
        self.name = name
        self.window = MachineWindow(lookback, lookahead, n_features, device)
        self.transform = transform
        self.scaler = scaler
        self.threshold = (
            float(threshold) if threshold and np.isfinite(threshold) and threshold > 0 else None
        )

    @property
    def monitorable(self) -> bool:
        return self.threshold is not None and self.scaler is not None

    def anomaly_ratio(self, outputs: np.ndarray, y_tail: np.ndarray) -> Optional[np.ndarray]:
        """Each new output row's scaled squared-gap mean over the
        detector's aggregate threshold (the one-shot anomaly frame's
        ``total-anomaly-scaled / aggregate_threshold_``), or None."""
        if not self.monitorable or not len(outputs):
            return None
        try:
            gap = np.abs(self.scaler.transform(np.asarray(outputs))
                         - self.scaler.transform(np.asarray(y_tail)))
            return np.asarray(np.square(gap).mean(axis=1), dtype=float) / self.threshold
        except Exception as exc:  # noqa: BLE001 - a statistic, not the reply
            logger.warning("Stream anomaly ratio failed for %s (%s); update still served",
                           self.name, exc)
            return None


class StreamSession:
    """One open stream (module docstring)."""

    def __init__(self, session_id: str, collection_dir: str, revision: str,
                 machines: Dict[str, MachineStream], max_backlog: int = DEFAULT_MAX_BACKLOG):
        self.id = session_id
        self.collection_dir = collection_dir
        self.revision = revision
        self.machines = machines
        self.names: Tuple[str, ...] = tuple(sorted(machines))
        self.max_backlog = max(1, int(max_backlog))
        self.lock = threading.Lock()
        self._pending_lock = threading.Lock()
        self.pending = 0
        self.last_active = time.monotonic()
        self.updates_total = 0
        self.rows_total = 0
        #: moving average of an update's wall time: the Retry-After estimate
        self._ema_update_s = 0.0
        #: the last update's rows copied to the device and rows resident there
        self.last_transfer_rows = 0
        self.last_resident_rows = 0

    @classmethod
    def new_id(cls) -> str:
        return uuid.uuid4().hex[:16]

    def retry_after_s(self) -> int:
        """About two updates' time, in whole seconds, at least 1."""
        return max(1, int(math.ceil(2.0 * self._ema_update_s)))

    def admit(self, weight: int = 1) -> None:
        """Count an arriving update against the backlog bound, or shed it."""
        weight = max(1, int(weight))
        with self._pending_lock:
            if self.pending + weight > self.max_backlog:
                raise StreamShed(
                    f"Stream session {self.id} backlog saturated "
                    f"({self.pending}/{self.max_backlog} updates in flight)",
                    self.retry_after_s(),
                )
            self.pending += weight

    def release(self, weight: int = 1) -> None:
        with self._pending_lock:
            self.pending = max(0, self.pending - max(1, int(weight)))

    def apply_update(
        self,
        updates: Dict[str, dict],
        dispatch: Callable[[Dict[str, WindowUpdate]], Dict[str, np.ndarray]],
    ) -> Dict[str, dict]:
        """Score one update against the resident windows. ``updates`` maps
        a machine to ``{"rows": (k, f) raw rows, "seq": int[, "y": (k,
        f_out) targets]}``; ``dispatch`` is the server's fleet scoring (the
        batcher when batching is on, so streams and one-shot requests
        share dispatches). Each machine's ``{"rows": outputs, "seq":
        acked, "warming": bool}``. Nothing is committed when the dispatch
        fails; a sequence gap raises :class:`StreamGone`."""
        unknown = sorted(set(updates) - set(self.machines))
        if unknown:
            raise KeyError(f"Machine(s) not in stream session {self.id}: {unknown}")
        start = time.perf_counter()
        with self.lock:
            self.last_active = time.monotonic()
            pending_commits = []
            inputs: Dict[str, WindowUpdate] = {}
            results: Dict[str, dict] = {}
            transferred = resident = 0
            for name in sorted(updates):
                stream = self.machines[name]
                payload = updates[name]
                # float64 until the prefix transform, float32 after: the
                # one-shot route's walk, so both carry the same bits
                rows = np.asarray(payload["rows"], dtype="float64")
                if rows.ndim != 2:
                    raise ValueError(
                        f"Machine {name!r}: update rows must be 2-D "
                        f"(rows, features), got shape {rows.shape}"
                    )
                if payload.get("y") is not None and len(np.asarray(payload["y"])) != len(rows):
                    raise ValueError(
                        f"Machine {name!r}: 'y' must carry one target row per input row "
                        f"({len(rows)}), got {len(np.asarray(payload['y']))}"
                    )
                seq = int(payload.get("seq", stream.window.seq))
                transformed = stream.transform(rows)
                try:
                    update, fresh = stream.window.begin(name, transformed, seq)
                except SequenceGap as gap:
                    raise StreamGone("sequence_gap", [name]) from gap
                pending_commits.append((stream, update, fresh))
                if update is not None:
                    inputs[name] = update
                    transferred += update.n_new
                    resident += update.n_context
                results[name] = {
                    "rows": [],
                    "seq": stream.window.seq + len(fresh),
                    "warming": update is None and len(fresh) > 0,
                }
            outputs: Dict[str, np.ndarray] = {}
            if inputs:
                if transfer.env_prefetch_depth() > 0:
                    for update in inputs.values():
                        update.prefetch()
                outputs = dispatch(inputs)  # raises: windows untouched, the retry is exact
            for stream, update, fresh in pending_commits:
                stream.window.commit(update, fresh)
            self.updates_total += 1
            self.last_transfer_rows = transferred
            self.last_resident_rows = resident
            for name, out in outputs.items():
                stream = self.machines[name]
                out = np.asarray(out)
                stream.window.n_scored += len(out)
                self.rows_total += len(out)
                results[name]["rows"] = out.tolist()
        elapsed = time.perf_counter() - start
        self._ema_update_s = (elapsed if self._ema_update_s == 0.0
                              else 0.8 * self._ema_update_s + 0.2 * elapsed)
        return results

    def stats(self) -> dict:
        with self._pending_lock:
            pending = self.pending
        return {
            "session": self.id,
            "machines": list(self.names),
            "revision": self.revision,
            "pending": pending,
            "max_backlog": self.max_backlog,
            "saturated": pending >= self.max_backlog,
            "updates_total": self.updates_total,
            "rows_total": self.rows_total,
            "last_transfer_rows": self.last_transfer_rows,
            "last_resident_rows": self.last_resident_rows,
            "retry_after_s": self.retry_after_s(),
            "windows": {name: s.window.stats() for name, s in self.machines.items()},
        }


class SessionManager:
    """The live-session table (module docstring)."""

    def __init__(self, max_sessions: int = DEFAULT_MAX_SESSIONS,
                 max_backlog: int = DEFAULT_MAX_BACKLOG,
                 idle_after_s: float = DEFAULT_IDLE_AFTER_S, device: DeviceLike = None):
        self.max_sessions = max(1, int(max_sessions))
        self.max_backlog = max(1, int(max_backlog))
        self.idle_after_s = float(idle_after_s)
        self.device = resolve_device(device)
        self._sessions: Dict[str, StreamSession] = {}
        # sessions a revision roll expired, by id: their next update is
        # told why (the newest EXPIRED_MEMORY of them)
        self._rolled: Dict[str, Tuple[str, ...]] = {}
        self._lock = threading.Lock()

    def headroom(self) -> Optional[float]:
        return device_headroom(self.device)

    def open(self, session: StreamSession) -> StreamSession:
        with self._lock:
            if len(self._sessions) >= self.max_sessions:
                free = self.headroom()
                if free is None or free < min_headroom_fraction():
                    # the LRU victim would be evicted: shed while it is active
                    victim = next(iter(self._sessions.values()))
                    if time.monotonic() - victim.last_active < self.idle_after_s:
                        raise StreamShed(
                            f"Session table full ({len(self._sessions)}/{self.max_sessions}) "
                            "and every stream is active",
                            max(1, victim.retry_after_s()),
                        )
            self._sessions[session.id] = session
            evict_lru(self._sessions, self.max_sessions, self.headroom)
        return session

    def get(self, session_id: str) -> Optional[StreamSession]:
        with self._lock:
            session = self._sessions.pop(session_id, None)
            if session is not None:
                self._sessions[session_id] = session  # most recently used
            return session

    def close(self, session_id: str) -> Optional[StreamSession]:
        with self._lock:
            self._rolled.pop(session_id, None)
            return self._sessions.pop(session_id, None)

    def require(self, session_id: str) -> StreamSession:
        """The live session, or :class:`StreamGone`: ``revision_rolled``
        for one a roll expired, else ``unknown_session``."""
        session = self.get(session_id)
        if session is not None:
            return session
        with self._lock:
            machines = self._rolled.get(session_id)
        if machines is not None:
            raise StreamGone("revision_rolled", machines)
        raise StreamGone("unknown_session")

    def expire_stale(self, keep_collection_dir: str) -> int:
        """Expire every session of another revision (the ``latest``
        symlink rolled): its next update answers the resume contract."""
        with self._lock:
            stale = [sid for sid, s in self._sessions.items()
                     if s.collection_dir != keep_collection_dir]
            expired = [self._sessions.pop(sid) for sid in stale]
            for session in expired:
                self._rolled[session.id] = session.names
            while len(self._rolled) > EXPIRED_MEMORY:
                self._rolled.pop(next(iter(self._rolled)))
        return len(expired)

    def stats(self) -> List[dict]:
        with self._lock:
            sessions = list(self._sessions.values())
        return [s.stats() for s in sessions]

    def __len__(self) -> int:
        with self._lock:
            return len(self._sessions)
