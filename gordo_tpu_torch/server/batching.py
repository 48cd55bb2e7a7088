"""
Cross-request dynamic batching for the port's server (the port of
``gordo_tpu.server.batching``).

A :class:`RequestBatcher` sits between the request threads and the card,
one for each (collection, machine set) fleet scorer: a handler thread
enqueues its request's inputs and blocks on a future, while one drainer
thread coalesces every waiting request into ONE
``FleetScorer.predict_requests`` call (one forward a group, on the
machine axis a solo request uses) and hands each request its outputs.

A batch goes when it is full (``queue_limit`` requests) or when its
oldest request has waited ``wait_s``, whichever comes first; an arrival
wakes the drainer, so an idle batcher does nothing. A submit that would
take the queue past ``queue_limit`` is shed at once with
:class:`BatchQueueFull`, which the server answers with a 503 and
``Retry-After``.

A batch is not a fault domain: when a coalesced call raises, each of its
requests is run again alone, so only the failing requests' futures
carry an error.

Left out: the metrics registry, tracing spans and fault injection of the
JAX batcher (ROADMAP.md queue 1 item 9).
"""

import collections
import logging
import math
import threading
import time
from typing import Any, Deque, Dict, List, Optional

logger = logging.getLogger(__name__)

#: /healthz reads ``shedding`` for this many Retry-After windows after a shed
SHED_READINESS_WINDOW = 1.0


class BatcherStopped(Exception):
    """This batcher was stopped (its scorer was rebuilt, or the LRU evicted
    it) between the caller's lookup and its submit: fetch a live batcher
    and submit again."""


class BatchQueueFull(Exception):
    """The queue is at ``queue_limit``: the request is shed, to be retried
    after ``retry_after_s`` seconds."""

    def __init__(self, retry_after_s: int, queue_depth: int, queue_limit: int):
        super().__init__(
            f"Batching queue full ({queue_depth}/{queue_limit} waiting); "
            f"retry after {retry_after_s}s"
        )
        self.retry_after_s = retry_after_s
        self.queue_depth = queue_depth
        self.queue_limit = queue_limit


class Pending:
    """One enqueued request: the future its handler thread waits on."""

    __slots__ = ("inputs", "event", "outputs", "error", "enqueued_perf", "queue_wait_s",
                 "n_coalesced")

    def __init__(self, inputs: Dict[str, Any]):
        self.inputs = inputs
        self.event = threading.Event()
        self.outputs: Optional[Dict[str, Any]] = None
        self.error: Optional[BaseException] = None
        self.enqueued_perf = time.perf_counter()
        self.queue_wait_s = 0.0
        self.n_coalesced = 1


class RequestBatcher:
    """
    A bounded queue and its drainer for one scorer, which must have
    ``predict_requests(list of inputs)``. ``wait_s`` caps a request's wait
    for batch-mates; ``queue_limit`` is both the batch's capacity and the
    admission bound.
    """

    def __init__(self, scorer, wait_s: float, queue_limit: int):
        self.scorer = scorer
        self.wait_s = max(0.0, float(wait_s))
        self.queue_limit = max(1, int(queue_limit))
        self._pending: Deque[Pending] = collections.deque()
        self._lock = threading.Lock()
        self._arrived = threading.Condition(self._lock)
        self._stopped = False
        self._sheds_total = 0
        self._last_shed_monotonic: Optional[float] = None
        self._dispatches_total = 0
        self._requests_total = 0
        #: moving average of a dispatch's wall time, for Retry-After
        self._ema_dispatch_s = 0.0
        self._drainer = threading.Thread(
            target=self._drain_loop, daemon=True, name="gordo-batch-drainer"
        )
        self._drainer.start()

    # -- handler side ------------------------------------------------------
    def submit(self, inputs: Dict[str, Any]) -> Pending:
        """
        Enqueue one request's inputs (prefix transformers applied) and
        block until the drainer has scored them: the finished
        :class:`Pending` (``outputs``, ``queue_wait_s``, ``n_coalesced``),
        or the request's own error raised. :class:`BatchQueueFull` without
        enqueueing when the queue is at ``queue_limit``.
        """
        with self._lock:
            if self._stopped:
                raise BatcherStopped("Batcher stopped (scorer rebuilt or evicted)")
            if len(self._pending) >= self.queue_limit:
                self._sheds_total += 1
                self._last_shed_monotonic = time.monotonic()
                raise BatchQueueFull(self.retry_after_s(), len(self._pending), self.queue_limit)
            pending = Pending(inputs)
            self._pending.append(pending)
            self._arrived.notify_all()
        # the drainer sets every future it pops, so this loops only if the
        # drainer thread itself died
        while not pending.event.wait(timeout=60.0):
            if not self._drainer.is_alive():
                raise RuntimeError("Batching drainer thread died")
        if pending.error is not None:
            raise pending.error
        return pending

    # -- drainer side ------------------------------------------------------
    def _drain_loop(self) -> None:
        while True:
            with self._arrived:
                while not self._pending and not self._stopped:
                    self._arrived.wait()
                if self._stopped and not self._pending:
                    return
                # full, or the oldest request's wait reached the cap
                while len(self._pending) < self.queue_limit and not self._stopped:
                    remaining = self.wait_s - (time.perf_counter() - self._pending[0].enqueued_perf)
                    if remaining <= 0:
                        break
                    self._arrived.wait(timeout=remaining)
                batch = list(self._pending)
                self._pending.clear()
            self._dispatch(batch)

    def _dispatch(self, batch: List[Pending]) -> None:
        start = time.perf_counter()
        for pending in batch:
            pending.queue_wait_s = start - pending.enqueued_perf
            pending.n_coalesced = len(batch)
        try:
            self._dispatch_batch(batch)
        except BaseException as exc:  # noqa: BLE001 - to the futures, not the thread
            for pending in batch:
                if pending.error is None and pending.outputs is None:
                    pending.error = exc
        finally:
            elapsed = time.perf_counter() - start
            with self._lock:
                self._dispatches_total += 1
                self._requests_total += len(batch)
                self._ema_dispatch_s = (
                    elapsed if self._ema_dispatch_s == 0.0
                    else 0.8 * self._ema_dispatch_s + 0.2 * elapsed
                )
            for pending in batch:
                pending.event.set()

    def _dispatch_batch(self, batch: List[Pending]) -> None:
        try:
            results = self.scorer.predict_requests([p.inputs for p in batch])
        except BaseException:  # noqa: BLE001 - isolate the culprit
            # one bad request must not fail its batch-mates: each runs alone
            logger.warning("A coalesced batch of %d failed; scoring each alone", len(batch))
            results = []
            for pending in batch:
                try:
                    results.append(self.scorer.predict_requests([pending.inputs])[0])
                except BaseException as exc:  # noqa: BLE001 - to its future
                    pending.error = exc
                    results.append(None)
        for pending, outputs in zip(batch, results):
            if pending.error is None:
                pending.outputs = outputs

    # -- state ---------------------------------------------------------------
    @property
    def stopped(self) -> bool:
        return self._stopped

    def retry_after_s(self) -> int:
        """Seconds a shed request is told to wait: about two dispatches,
        whole seconds, at least 1."""
        return max(1, int(math.ceil(2.0 * self._ema_dispatch_s)))

    def stats(self) -> dict:
        """This batcher as ``/healthz`` reports it."""
        with self._lock:
            depth = len(self._pending)
            sheds = self._sheds_total
            last_shed = self._last_shed_monotonic
            dispatches = self._dispatches_total
            requests = self._requests_total
        retry_after = self.retry_after_s()
        shedding = (
            last_shed is not None
            and time.monotonic() - last_shed < SHED_READINESS_WINDOW * retry_after
        )
        return {
            "queue_depth": depth,
            "queue_limit": self.queue_limit,
            "saturated": depth >= self.queue_limit,
            "sheds_total": sheds,
            "shedding": shedding,
            "dispatches_total": dispatches,
            "requests_total": requests,
            "mean_batch_size": round(requests / dispatches, 3) if dispatches else None,
            "retry_after_s": retry_after,
        }

    def stop(self, join: bool = False) -> None:
        """Stop the drainer once the queue is empty; requests already
        queued are still scored."""
        with self._arrived:
            self._stopped = True
            self._arrived.notify_all()
        if join:
            self._drainer.join(timeout=30.0)
