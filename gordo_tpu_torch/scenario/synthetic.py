"""
Synthetic clients for game days (the port of
``gordo_tpu.scenario.synthetic``, standard library only): streams and
one-shot arrivals driven by one heap-scheduled loop, with no thread per
client.

:class:`EventLoop` keeps ``(due, tie, callback, args)`` entries in a heap.
In virtual time (the default) ``run_until`` jumps from event to event, so
a harness of 10^5 streams runs a simulated minute in wall milliseconds;
in real time (``real_time=True``, the scenario runner's mode) it sleeps
the gaps, and an event that overruns fires late (open-loop pacing, the
arrivals a shed must absorb). :class:`SyntheticStream` is one stream's
``__slots__`` state; :class:`StubPlane` is the in-memory transport that
keeps only the sessions' books (what bounds the harness itself).
"""

import heapq
import time
from typing import Dict, List, Optional


class EventLoop:
    """A heap of ``(due, tie, callback, args)``; no threads, no polling."""

    __slots__ = ("_heap", "_tie", "_now", "real_time", "_stopped")

    def __init__(self, real_time: bool = False, start: float = 0.0):
        self._heap: List[tuple] = []
        self._tie = 0
        self.real_time = bool(real_time)
        self._now = time.monotonic() if self.real_time else float(start)
        self._stopped = False

    @property
    def now(self) -> float:
        return time.monotonic() if self.real_time else self._now

    def call_at(self, when: float, callback, *args) -> None:
        self._tie += 1
        heapq.heappush(self._heap, (float(when), self._tie, callback, args))

    def call_later(self, delay: float, callback, *args) -> None:
        self.call_at(self.now + max(0.0, float(delay)), callback, *args)

    def stop(self) -> None:
        """End ``run_until`` after the event firing now."""
        self._stopped = True

    def run_until(self, deadline: float) -> int:
        """Fire every event due by ``deadline``; the number fired."""
        fired = 0
        self._stopped = False
        while self._heap and not self._stopped:
            due = self._heap[0][0]
            if due > deadline:
                break
            if self.real_time:
                gap = due - time.monotonic()
                if gap > 0:
                    time.sleep(gap)
            else:
                self._now = max(self._now, due)
            _, _, callback, args = heapq.heappop(self._heap)
            callback(*args)
            fired += 1
        if not self.real_time:
            self._now = max(self._now, deadline)
        return fired


class SyntheticStream:
    """One simulated monitoring stream: opens once, then pushes
    ``rows_per_update`` rows every ``interval`` seconds through its
    transport."""

    __slots__ = ("name", "machine", "interval", "rows_per_update", "transport", "opened",
                 "closed", "updates", "rows_sent", "seq", "session")

    def __init__(self, name: str, machine: str, interval: float, rows_per_update: int,
                 transport: "StubPlane"):
        self.name = name
        self.machine = machine
        self.interval = float(interval)
        self.rows_per_update = int(rows_per_update)
        self.transport = transport
        self.opened = False
        self.closed = False
        self.updates = 0
        self.rows_sent = 0
        self.seq = 0
        self.session: Optional[str] = None

    def start(self, loop: EventLoop, at: float) -> None:
        loop.call_at(at, self._open, loop)

    def _open(self, loop: EventLoop) -> None:
        self.session = self.transport.open(self)
        self.opened = True
        loop.call_later(self.interval, self._update, loop)

    def _update(self, loop: EventLoop) -> None:
        if self.closed:
            return
        self.seq = self.transport.update(self)
        self.updates += 1
        self.rows_sent += self.rows_per_update
        loop.call_later(self.interval, self._update, loop)

    def close(self) -> None:
        if self.opened and not self.closed:
            self.transport.close(self)
        self.closed = True


class StubPlane:
    """The in-memory transport of harness-scale runs: sessions and their
    acknowledged rows, no scoring."""

    __slots__ = ("sessions", "live", "peak_live", "updates", "rows")

    def __init__(self):
        self.sessions: Dict[str, int] = {}
        self.live = 0
        self.peak_live = 0
        self.updates = 0
        self.rows = 0

    def open(self, stream: SyntheticStream) -> str:
        sid = f"s{len(self.sessions)}"
        self.sessions[sid] = 0
        self.live += 1
        self.peak_live = max(self.peak_live, self.live)
        return sid

    def update(self, stream: SyntheticStream) -> int:
        acked = self.sessions[stream.session] + stream.rows_per_update
        self.sessions[stream.session] = acked
        self.updates += 1
        self.rows += stream.rows_per_update
        return acked

    def close(self, stream: SyntheticStream) -> None:
        self.live -= 1
