"""
Host/device time attribution: the phase ledger (the port of
``gordo_tpu.observability.attribution``, its server and train planes).

A request crosses seven seams, one closed vocabulary of phases:

==============  ============================================================
phase           what it covers
==============  ============================================================
``parse``       request bytes -> host arrays (routing, JSON decode, frames)
``transform``   host prefix transformers and the estimator's host remainder
``queue``       the dynamic-batching wait
``transfer``    host -> device staging (batch assembly, the input's copy)
``device``      the forward, ended at the sync the serving path already
                has: the output's copy to the host
``postprocess`` anomaly statistic and threshold math on the way out
``serialize``   response frame -> JSON bytes
==============  ============================================================

Each request carries a :class:`PhaseLedger` (:func:`ledger_for`); its
phases go into ``gordo_phase_seconds{plane,phase}`` and onto the request
span as ``phase_<name>_ms``, ``host_fraction``, ``device_fraction`` and
``ledger_coverage``. The ledger is on by default; ``GORDO_PHASE_LEDGER=0``
turns it off: one environment lookup a request, then process-wide no-op
singletons. It adds no device synchronisation: ``device`` ends where the
output is copied to the host anyway.

The fleet trainer has no per-request ledger: each epoch's dispatch
accounts itself with :func:`record` on the ``train`` plane (``device``:
the epoch's steps queued on the card; ``transfer``: the next epoch
chunk's staged copy), as the JAX trainer records its dispatches.
:func:`phase_totals` reads the accounting back from a registry
snapshot (``telemetry summarize``'s ``phases`` section). A stream update
has a ledger of its own on the ``stream`` plane
(``streaming/session.py``), and a routed request one on the ``router``
plane (``router/app.py``: the replicas' wait as ``queue``, the reply's
re-stamp as ``serialize``). Each bracket also tells the sampling
profiler (:mod:`.sampling`, ``GORDO_PROFILE_HZ``) which phase its thread
is in; with the sampler off that hook is one module-global read.
"""

import os
import threading
import time
import typing

from gordo_tpu_torch.observability import sampling
from gordo_tpu_torch.observability.registry import get_registry

LEDGER_ENV_VAR = "GORDO_PHASE_LEDGER"

#: the closed phase vocabulary
PHASES: typing.Tuple[str, ...] = (
    "parse",
    "transform",
    "queue",
    "transfer",
    "device",
    "postprocess",
    "serialize",
)

#: phases whose time is host CPU
HOST_PHASES = frozenset(
    {"parse", "transform", "queue", "postprocess", "serialize"}
)
#: phases on the accelerator side of the seam
DEVICE_PHASES = frozenset({"transfer", "device"})

#: the planes a ledger can account for (the ``plane`` label's vocabulary)
PLANES: typing.Tuple[str, ...] = ("server", "stream", "train", "router")

#: per-thread stack of active ledgers: cross-layer code (the fleet
#: scorer, the estimator hot path) attributes via
#: :func:`record_current` without threading a ledger through every
#: signature
_TLS = threading.local()


def _phase_histogram():
    return get_registry().histogram(
        "gordo_phase_seconds",
        "Per-request host/device phase attribution (the phase ledger)",
        ("plane", "phase"),
    )


def ledger_enabled() -> bool:
    """One env dict lookup: the ledger is on unless explicitly off."""
    return os.environ.get(LEDGER_ENV_VAR, "1").lower() not in (
        "0",
        "false",
        "off",
    )


# -- the no-op half (GORDO_PHASE_LEDGER=0) ---------------------------------


class _NoopContextManager:
    """Reusable disabled-path bracket: no allocation, no clock reads."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return False


_NOOP_CM = _NoopContextManager()


class _NoopLedger:
    """The disabled-path singleton: every operation is a pass."""

    __slots__ = ()
    plane = None
    phases: typing.Dict[str, float] = {}

    def phase(self, name: str):
        return _NOOP_CM

    def add(self, name: str, seconds: float) -> None:
        pass

    def activate(self):
        return _NOOP_CM

    def finish(self, span=None, wall_s=None, record_spans=False) -> dict:
        return {}


NOOP_LEDGER = _NoopLedger()


# -- the real half ---------------------------------------------------------


class _PhaseBracket:
    """One ``with ledger.phase(name):`` bracket: two ``perf_counter``
    calls, one dict add, and one module-global read for the sampling
    profiler's hook (its phase map is touched only while a sampler
    runs)."""

    __slots__ = ("_ledger", "_name", "_start", "_prev_phase")

    def __init__(self, ledger: "PhaseLedger", name: str):
        self._ledger = ledger
        self._name = name

    def __enter__(self):
        if sampling._ACTIVE:
            self._prev_phase = sampling.current_phase()
            sampling.set_phase(self._ledger.plane, self._name)
        else:
            self._prev_phase = None
        self._start = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        self._ledger.add(self._name, time.perf_counter() - self._start)
        if sampling._ACTIVE:
            sampling.clear_phase(self._prev_phase)
        return False


class _Activation:
    """Pushes a ledger onto the calling thread's sink stack so
    :func:`record_current` calls from deeper layers land on it."""

    __slots__ = ("_ledger",)

    def __init__(self, ledger: "PhaseLedger"):
        self._ledger = ledger

    def __enter__(self):
        stack = getattr(_TLS, "sinks", None)
        if stack is None:
            stack = _TLS.sinks = []
        stack.append(self._ledger)
        return self._ledger

    def __exit__(self, exc_type, exc, tb):
        _TLS.sinks.pop()
        return False


class PhaseLedger:
    """Per-request/update/dispatch phase accounting for one plane.

    Create via :func:`ledger_for` (which owns the enabled check), bracket
    hot-path seams with :meth:`phase` / :meth:`add`, then :meth:`finish`
    once to observe the histograms and stamp the enclosing span.
    """

    __slots__ = ("plane", "phases", "_created")

    def __init__(self, plane: str):
        self.plane = plane
        self.phases: typing.Dict[str, float] = {}
        self._created = time.perf_counter()

    def phase(self, name: str) -> _PhaseBracket:
        """Context manager timing one phase bracket."""
        return _PhaseBracket(self, name)

    def add(self, name: str, seconds: float) -> None:
        """Fold an already-measured duration into a phase."""
        self.phases[name] = self.phases.get(name, 0.0) + float(seconds)

    def activate(self) -> _Activation:
        """Make this ledger the thread's :func:`record_current` sink for
        the ``with`` body (innermost activation wins)."""
        return _Activation(self)

    def finish(
        self,
        span=None,
        wall_s: typing.Optional[float] = None,
        record_spans: bool = False,
    ) -> dict:
        """Observe every phase into ``gordo_phase_seconds``, stamp the
        attribution summary onto ``span`` (when recording), and return
        it. ``wall_s`` (the request's measured wall time) adds the
        coverage accounting — what fraction of the wall the ledger
        explains. ``record_spans=True`` additionally persists each phase
        as a completed child span (planes whose phases do not already
        ride the Server-Timing ``record_phase`` path)."""
        if not self.phases:
            return {}
        histogram = _phase_histogram()
        host_s = device_s = 0.0
        for name, seconds in self.phases.items():
            histogram.observe(seconds, plane=self.plane, phase=name)
            if name in DEVICE_PHASES:
                device_s += seconds
            else:
                host_s += seconds
        total = host_s + device_s
        summary: typing.Dict[str, typing.Any] = {
            "plane": self.plane,
            "phases": dict(self.phases),
            "host_s": host_s,
            "device_s": device_s,
            "host_fraction": host_s / total if total else None,
            "device_fraction": device_s / total if total else None,
        }
        if wall_s is None:
            wall_s = time.perf_counter() - self._created
        summary["wall_s"] = wall_s
        summary["coverage"] = min(1.0, total / wall_s) if wall_s > 0 else None
        if span is not None and getattr(span, "recording", False):
            for name, seconds in self.phases.items():
                span.set_attribute(
                    f"phase_{name}_ms", round(seconds * 1000.0, 3)
                )
            if summary["host_fraction"] is not None:
                span.set_attribute(
                    "host_fraction", round(summary["host_fraction"], 4)
                )
                span.set_attribute(
                    "device_fraction", round(summary["device_fraction"], 4)
                )
            if summary["coverage"] is not None:
                span.set_attribute(
                    "ledger_coverage", round(summary["coverage"], 4)
                )
        if record_spans:
            from gordo_tpu_torch.observability import tracing

            parent = span if span is not None else None
            for name, seconds in self.phases.items():
                tracing.record_span(
                    name, seconds, parent=parent, plane=self.plane
                )
        return summary


def ledger_for(plane: str):
    """A :class:`PhaseLedger` for ``plane`` — or the no-op singleton
    when ``GORDO_PHASE_LEDGER`` disables attribution (one env lookup,
    nothing else)."""
    if not ledger_enabled():
        return NOOP_LEDGER
    return PhaseLedger(plane)


def record_current(phase: str, seconds: float) -> bool:
    """Attribute ``seconds`` to ``phase`` on the calling thread's active
    ledger (scorer/estimator hot paths, which don't know whose request
    they serve). Returns whether a ledger was listening."""
    stack = getattr(_TLS, "sinks", None)
    if not stack:
        return False
    stack[-1].add(phase, seconds)
    return True


def record(plane: str, phase: str, seconds: float) -> None:
    """Observe one phase's seconds directly (the trainer: a fit has no
    per-request ledger, each dispatch accounts itself). One environment
    lookup when the ledger is off."""
    if not ledger_enabled():
        return
    _phase_histogram().observe(seconds, plane=plane, phase=phase)


def phase_totals(
    snapshot: typing.Optional[typing.Mapping[str, dict]] = None,
) -> typing.Dict[typing.Tuple[str, str], dict]:
    """``{(plane, phase): {"count", "sum"}}`` from a registry snapshot (by
    default the process's registry): the ledger's lifetime totals."""
    if snapshot is None:
        snapshot = get_registry().snapshot()
    dump = snapshot.get("gordo_phase_seconds") or {}
    out: typing.Dict[typing.Tuple[str, str], dict] = {}
    for series in dump.get("series") or []:
        labels = series.get("labels") or {}
        out[(labels.get("plane", "?"), labels.get("phase", "?"))] = {
            "count": int(series.get("count") or 0),
            "sum": float(series.get("sum") or 0.0),
        }
    return out


# -- overhead --------------------------------------------------------------


def measure_overhead(samples: int = 2000) -> dict:
    """Nanoseconds per phase bracket in both regimes — disabled (the
    strict no-op) and enabled (the always-on default) — mirroring
    ``tracing.measure_overhead`` so benches report the attribution tax
    as a number. Mutates ``GORDO_PHASE_LEDGER`` while running; call
    after the measured workload has drained."""
    saved = os.environ.pop(LEDGER_ENV_VAR, None)

    def _time_loop() -> float:
        ledger = ledger_for("server")
        start = time.perf_counter()
        for _ in range(samples):
            with ledger.phase("parse"):
                pass
        return (time.perf_counter() - start) / samples * 1e9

    try:
        os.environ[LEDGER_ENV_VAR] = "0"
        disabled = _time_loop()
        os.environ.pop(LEDGER_ENV_VAR, None)
        enabled = _time_loop()
    finally:
        if saved is None:
            os.environ.pop(LEDGER_ENV_VAR, None)
        else:
            os.environ[LEDGER_ENV_VAR] = saved
    return {
        "samples": samples,
        "disabled_ns_per_phase": round(disabled, 1),
        "enabled_ns_per_phase": round(enabled, 1),
    }
