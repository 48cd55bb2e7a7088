"""
Distributed tracing (the port of ``gordo_tpu.observability.tracing``):
spans that carry one trace id through a client's retries, the server
request they land on, the request's phases, and the event-log records
emitted along the way.

- **A strict no-op while off.** Tracing is on when
  ``GORDO_TPU_TRACE_LOG`` names a span JSONL file. Every entry point
  starts with one ``os.environ`` lookup and, when it misses, returns a
  process-wide no-op singleton.
- **Standard library only.** Spans are dicts on a JSONL file, ids are
  ``os.urandom`` hex, the active span is one :mod:`contextvars`
  variable.
- **W3C trace context on the wire.** The ``traceparent`` header
  (``00-<32 hex trace id>-<16 hex span id>-<flags>``) carries the
  context; the server echoes the trace id (``X-Gordo-Trace-Id``) even
  when its own recording is off.

``GORDO_TPU_TRACE_SAMPLE`` (a rate in [0, 1], default 1) samples at the
head: a root span's verdict is a threshold test on its trace id, so
every process that sees the trace agrees, and a remote parent's verdict
rides the ``traceparent`` flag. Unsampled spans keep their ids (they
propagate and are echoed) but write nothing. Writing a span never
raises into the work it observes. Records, formats and sampling are the
JAX module's, so either package reads the other's span files.
"""

import contextvars
import json
import logging
import os
import threading
import time
import typing

logger = logging.getLogger(__name__)

TRACE_LOG_ENV_VAR = "GORDO_TPU_TRACE_LOG"
TRACE_SAMPLE_ENV_VAR = "GORDO_TPU_TRACE_SAMPLE"

#: the W3C trace-context request header the client injects and the
#: server extracts
TRACEPARENT_HEADER = "traceparent"
#: the response header the server echoes the trace id in, so a failed
#: request is greppable in server-side logs and span/event files
TRACE_ID_RESPONSE_HEADER = "X-Gordo-Trace-Id"

_TRACEPARENT_VERSION = "00"
_SAMPLED_FLAG = 0x01

#: the active span of the current thread/async context (never holds the
#: disabled-path singleton: with tracing off the variable is untouched)
_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "gordo_tpu_current_span", default=None
)

#: sentinel: "parent not given — use the context's current span"
_USE_CURRENT = object()


class SpanContext(typing.NamedTuple):
    """The propagatable identity of a span (what ``traceparent`` carries)."""

    trace_id: str
    span_id: str
    sampled: bool = True


class _NoopSpan:
    """The disabled-path singleton: every operation is a pass."""

    __slots__ = ()
    recording = False
    trace_id: typing.Optional[str] = None
    span_id: typing.Optional[str] = None
    context: typing.Optional[SpanContext] = None

    def set_attribute(self, key: str, value) -> None:
        pass

    def set_status(self, status: str) -> None:
        pass


NOOP_SPAN = _NoopSpan()


class Span:
    """One open span. Create via :func:`start_span`, never directly."""

    __slots__ = (
        "name",
        "trace_id",
        "span_id",
        "parent_span_id",
        "sampled",
        "attributes",
        "status",
        "start_unix_ms",
        "_start_perf",
    )

    def __init__(
        self,
        name: str,
        trace_id: str,
        span_id: str,
        parent_span_id: typing.Optional[str],
        sampled: bool,
        attributes: dict,
    ):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_span_id = parent_span_id
        self.sampled = sampled
        self.attributes = dict(attributes) if sampled else {}
        self.status = "ok"
        self.start_unix_ms = time.time() * 1000.0
        self._start_perf = time.perf_counter()

    @property
    def recording(self) -> bool:
        return self.sampled

    @property
    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id, self.sampled)

    def set_attribute(self, key: str, value) -> None:
        if self.sampled:
            self.attributes[key] = value

    def set_status(self, status: str) -> None:
        self.status = status

    def _finish_record(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_span_id": self.parent_span_id,
            "name": self.name,
            "start_unix_ms": round(self.start_unix_ms, 3),
            "duration_ms": round(
                (time.perf_counter() - self._start_perf) * 1000.0, 4
            ),
            "status": self.status,
            "pid": os.getpid(),
            "attributes": self.attributes,
        }


# -- enablement / sampling -------------------------------------------------


def tracing_enabled() -> bool:
    """One dict lookup: is a span log configured?"""
    return bool(os.environ.get(TRACE_LOG_ENV_VAR))


def sample_rate() -> float:
    """The configured head-sampling rate, clamped to [0, 1] (default 1)."""
    raw = os.environ.get(TRACE_SAMPLE_ENV_VAR)
    if not raw:
        return 1.0
    try:
        rate = float(raw)
    except ValueError:
        logger.warning(
            "Unparseable %s=%r; sampling everything", TRACE_SAMPLE_ENV_VAR, raw
        )
        return 1.0
    return min(1.0, max(0.0, rate))


def _sampled(trace_id: str) -> bool:
    """
    Deterministic head sampling: a threshold test on the trace id's
    leading 32 bits, so every process holding the same trace id reaches
    the same verdict without coordination.
    """
    rate = sample_rate()
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    return int(trace_id[:8], 16) < rate * 0x100000000


# -- traceparent (W3C trace context) ---------------------------------------


def format_traceparent(ctx: SpanContext) -> str:
    """``00-<trace_id>-<span_id>-<01|00>`` for the given context."""
    flags = _SAMPLED_FLAG if ctx.sampled else 0
    return f"{_TRACEPARENT_VERSION}-{ctx.trace_id}-{ctx.span_id}-{flags:02x}"


def parse_traceparent(value: typing.Optional[str]) -> typing.Optional[SpanContext]:
    """
    Parse a ``traceparent`` header into a :class:`SpanContext`, or None
    when absent/malformed (a bad header must degrade to "no context",
    never to a failed request).
    """
    if not value:
        return None
    parts = value.strip().lower().split("-")
    if len(parts) < 4:
        return None
    version, trace_id, span_id, flags = parts[0], parts[1], parts[2], parts[3]
    if version == _TRACEPARENT_VERSION and len(parts) != 4:
        # W3C: version 00 has EXACTLY four fields; future versions may
        # append more, so only the version we speak is held to it
        return None
    if len(version) != 2 or len(trace_id) != 32 or len(span_id) != 16:
        return None
    if len(flags) != 2:
        return None
    try:
        int(version, 16)
        int(trace_id, 16)
        int(span_id, 16)
        flag_bits = int(flags, 16)
    except ValueError:
        return None
    if version == "ff" or set(trace_id) == {"0"} or set(span_id) == {"0"}:
        return None
    return SpanContext(trace_id, span_id, bool(flag_bits & _SAMPLED_FLAG))


# -- span lifecycle --------------------------------------------------------


def _begin_span(
    name: str,
    parent,
    attributes: dict,
) -> Span:
    """Resolve the parent (explicit Span/SpanContext, None = new root,
    or the context's current span) and mint the child."""
    if parent is _USE_CURRENT:
        parent = _CURRENT.get()
    if isinstance(parent, (Span, _NoopSpan)):
        parent = parent.context
    if parent is None:
        trace_id = os.urandom(16).hex()
        return Span(
            name, trace_id, os.urandom(8).hex(), None, _sampled(trace_id),
            attributes,
        )
    return Span(
        name,
        parent.trace_id,
        os.urandom(8).hex(),
        parent.span_id,
        parent.sampled,
        attributes,
    )


class _NoopSpanContextManager:
    """The reusable disabled-path context manager: ``start_span`` with
    tracing off costs one env dict lookup and returns this singleton —
    no generator, no per-call allocation (beyond the call's own
    kwargs), no contextvar touch."""

    __slots__ = ()

    def __enter__(self):
        return NOOP_SPAN

    def __exit__(self, exc_type, exc, tb):
        return False


_NOOP_CM = _NoopSpanContextManager()


class _SpanContextManager:
    __slots__ = ("_name", "_parent", "_attributes", "_path", "_span", "_token")

    def __init__(self, name, parent, attributes, path):
        self._name = name
        self._parent = parent
        self._attributes = attributes
        self._path = path

    def __enter__(self):
        span = _begin_span(self._name, self._parent, self._attributes)
        self._span = span
        self._token = _CURRENT.set(span)
        return span

    def __exit__(self, exc_type, exc, tb):
        span = self._span
        _CURRENT.reset(self._token)
        if span.recording:
            if exc is not None:
                span.status = "error"
                span.attributes.setdefault("error", repr(exc))
            _write_span(span._finish_record(), self._path)
        return False


def start_span(name: str, parent=_USE_CURRENT, **attributes):
    """
    Open a span around the ``with`` body and make it the current span.

    - disabled (``GORDO_TPU_TRACE_LOG`` unset): one dict lookup, then
      the process-wide no-op context manager yielding :data:`NOOP_SPAN`;
      the contextvar is never touched.
    - ``parent``: a :class:`Span` / :class:`SpanContext` to attach under
      (the cross-thread handoff — contextvars do not follow
      ``ThreadPoolExecutor`` workers), ``None`` to force a new root, or
      omitted to nest under the current span.
    - an escaping exception marks the span ``status="error"`` (with the
      repr in attributes) and re-raises.

    The span is written to the JSONL log when the body exits. Always use
    as a context manager: an unclosed span is never persisted.
    """
    path = os.environ.get(TRACE_LOG_ENV_VAR)
    if not path:
        return _NOOP_CM
    return _SpanContextManager(name, parent, attributes, path)


def record_span(
    name: str, seconds: float, parent=_USE_CURRENT, **attributes
) -> typing.Optional[dict]:
    """
    Persist an already-measured phase as a completed span ending now
    (the ``Server-Timing`` phases are timed with ``timeit`` before any
    span exists for them). Returns the record, or None when tracing is
    disabled/unsampled.
    """
    path = os.environ.get(TRACE_LOG_ENV_VAR)
    if not path:
        return None
    span = _begin_span(name, parent, attributes)
    if not span.recording:
        return None
    record = span._finish_record()
    record["start_unix_ms"] = round(time.time() * 1000.0 - seconds * 1000.0, 3)
    record["duration_ms"] = round(seconds * 1000.0, 4)
    _write_span(record, path)
    return record


def current_span():
    """The context's current span, or None (never the no-op singleton)."""
    return _CURRENT.get()


def current_context() -> typing.Optional[SpanContext]:
    """
    The current span's propagatable context, or None. The cross-thread
    handoff: capture this before submitting work to an executor and pass
    it as ``start_span(..., parent=ctx)`` in the worker.
    """
    span = _CURRENT.get()
    return span.context if span is not None else None


def current_traceparent() -> typing.Optional[str]:
    """``traceparent`` header value for the current span, or None."""
    span = _CURRENT.get()
    if span is None:
        return None
    return format_traceparent(span.context)


def propagation_headers(span=None) -> dict:
    """
    The request headers that propagate ``span``'s context (default: the
    current span) — ``{"traceparent": ...}``, or ``{}`` when there is
    nothing to propagate (tracing off / no span). The ONE spelling of
    header injection, so every POST path stays in sync.
    """
    if span is None:
        span = _CURRENT.get()
    ctx = span.context if span is not None else None
    if ctx is None:
        return {}
    return {TRACEPARENT_HEADER: format_traceparent(ctx)}


def trace_fields(span=None) -> dict:
    """
    ``{"trace_id": ..., "span_id": ...}`` for ``span`` (default: the
    current span), or ``{}`` when there is none / it is unsampled. THE
    stamping helper: event emission goes through this (implicitly via
    ``emit_event``, or explicitly when handing context across threads)
    so trace fields keep one spelling everywhere.
    """
    if span is None:
        span = _CURRENT.get()
    if span is None or not span.recording:
        return {}
    return {"trace_id": span.trace_id, "span_id": span.span_id}


# -- persistence -----------------------------------------------------------

_write_lock = threading.Lock()


def _write_span(record: dict, path: str) -> None:
    """One span line, O_APPEND, never raising (telemetry must not be
    able to crash the workload it observes)."""
    try:
        line = json.dumps(record, default=str)
    except Exception:
        logger.warning("Unserializable span %r dropped", record.get("name"))
        return
    try:
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        with _write_lock, open(path, "a") as fh:
            fh.write(line + "\n")
    except OSError:
        logger.warning("Could not write span to %s", path, exc_info=True)


def read_spans(path: str) -> typing.List[dict]:
    """Span records from a JSONL file (malformed lines skipped, like the
    event-log reader — a crash mid-write may truncate the last line)."""
    from gordo_tpu_torch.observability.events import read_events

    return [
        r
        for r in read_events(path)
        if isinstance(r, dict) and r.get("trace_id") and r.get("span_id")
    ]


# -- export / summarize (the `gordo-tpu trace` surface) --------------------


def spans_to_chrome_trace(records: typing.Sequence[dict]) -> dict:
    """
    Chrome-trace ("Trace Event Format") JSON loadable in Perfetto /
    chrome://tracing: one complete ("X") event per span, microsecond
    timestamps, one synthetic tid per trace so each trace renders as its
    own row, with the gordo ids preserved under ``args``.

    Phase-ledger spans (names from the closed phase vocabulary, emitted
    by ``PhaseLedger.finish(record_spans=True)``) additionally land on
    two dedicated per-process tracks — "host phases" and "device
    phases" — so the host/device cost seam reads as two rows in
    Perfetto instead of being buried inside each trace's row.
    """
    from gordo_tpu_torch.observability.attribution import DEVICE_PHASES, PHASES

    # synthetic tids far above the per-trace counter: the phase tracks
    host_tid, device_tid = 1_000_000, 1_000_001
    events: typing.List[dict] = []
    tids: typing.Dict[str, int] = {}
    # Chrome-trace tracks are keyed (pid, tid): a trace that crossed
    # processes (client + server pids in one trace) occupies one row per
    # process, and each such row needs its own thread_name metadata or
    # the label attaches to nothing
    rows: typing.Set[typing.Tuple[int, int, str]] = set()
    phase_rows: typing.Set[typing.Tuple[int, int]] = set()
    for record in records:
        if "duration_ms" not in record or "start_unix_ms" not in record:
            continue
        trace_id = record["trace_id"]
        name = record.get("name", "span")
        pid = int(record.get("pid") or 0)
        if name in PHASES:
            tid = device_tid if name in DEVICE_PHASES else host_tid
            phase_rows.add((pid, tid))
        else:
            tid = tids.setdefault(trace_id, len(tids) + 1)
            rows.add((pid, tid, trace_id))
        args = dict(record.get("attributes") or {})
        args.update(
            trace_id=trace_id,
            span_id=record["span_id"],
            parent_span_id=record.get("parent_span_id"),
            status=record.get("status", "ok"),
        )
        events.append(
            {
                "name": name,
                "cat": "gordo-phase" if name in PHASES else "gordo-tpu",
                "ph": "X",
                "ts": float(record["start_unix_ms"]) * 1000.0,
                "dur": float(record["duration_ms"]) * 1000.0,
                "pid": pid,
                "tid": tid,
                "args": args,
            }
        )
    for pid, tid in sorted(phase_rows):
        events.append(
            {
                "name": "thread_name",
                "ph": "M",
                "pid": pid,
                "tid": tid,
                "args": {
                    "name": (
                        "device phases"
                        if tid == device_tid
                        else "host phases"
                    )
                },
            }
        )
    for pid, tid, trace_id in sorted(rows):
        # name each row by its trace id so Perfetto's track labels are
        # greppable back to the span/event logs
        events.append(
            {
                "name": "thread_name",
                "ph": "M",
                "pid": pid,
                "tid": tid,
                "args": {"name": f"trace {trace_id[:16]}"},
            }
        )
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def _critical_path(spans: typing.List[dict]) -> typing.List[dict]:
    """Root → longest-child chain of one trace's spans."""
    by_parent: typing.Dict[typing.Optional[str], typing.List[dict]] = {}
    ids = {s["span_id"] for s in spans}
    for span in spans:
        parent = span.get("parent_span_id")
        key = parent if parent in ids else None
        by_parent.setdefault(key, []).append(span)
    roots = by_parent.get(None, [])
    if not roots:
        return []
    path = [max(roots, key=lambda s: s.get("duration_ms") or 0)]
    visited = {path[0]["span_id"]}
    while True:
        children = by_parent.get(path[-1]["span_id"])
        if not children:
            return path
        nxt = max(children, key=lambda s: s.get("duration_ms") or 0)
        if nxt["span_id"] in visited:
            # a hand-edited/merged log can hold parent cycles; the rest
            # of the reader stack tolerates malformed input, so do we
            return path
        visited.add(nxt["span_id"])
        path.append(nxt)


def summarize_spans(records: typing.Sequence[dict], top: int = 5) -> str:
    """
    Human summary of a span log: per-span-name totals, per-machine
    totals (the ``machine`` attribute), and the critical path of the
    slowest traces — where one slow request or build actually spent its
    time, by phase and by machine.
    """
    spans = [r for r in records if "duration_ms" in r]
    if not spans:
        return "no spans"
    by_trace: typing.Dict[str, typing.List[dict]] = {}
    for span in spans:
        by_trace.setdefault(span["trace_id"], []).append(span)
    lines = [f"{len(spans)} spans in {len(by_trace)} traces", "", "by span name:"]

    def _rows(groups: typing.Dict[str, typing.List[float]]):
        width = max(len(k) for k in groups)
        for key, durations in sorted(
            groups.items(), key=lambda kv: -sum(kv[1])
        ):
            total = sum(durations)
            lines.append(
                f"  {key:<{width}}  n={len(durations):<5d} "
                f"total={total:9.1f}ms  mean={total / len(durations):8.2f}ms "
                f"max={max(durations):8.2f}ms"
            )

    by_name: typing.Dict[str, typing.List[float]] = {}
    by_machine: typing.Dict[str, typing.List[float]] = {}
    n_errors = 0
    for span in spans:
        duration = float(span["duration_ms"])
        by_name.setdefault(span.get("name", "span"), []).append(duration)
        machine = (span.get("attributes") or {}).get("machine")
        if machine:
            by_machine.setdefault(str(machine), []).append(duration)
        if span.get("status") == "error":
            n_errors += 1
    _rows(by_name)
    if by_machine:
        lines.append("")
        lines.append("by machine:")
        _rows(by_machine)
    if n_errors:
        lines.append("")
        lines.append(f"{n_errors} span(s) ended in error")
    lines.append("")
    lines.append(f"slowest traces (top {top}, critical path):")
    ranked = sorted(
        by_trace.items(),
        key=lambda kv: -max(float(s["duration_ms"]) for s in kv[1]),
    )
    for trace_id, tspans in ranked[:top]:
        path = _critical_path(tspans)
        if not path:
            continue
        chain = " > ".join(
            f"{s.get('name', 'span')} {float(s['duration_ms']):.1f}ms"
            for s in path
        )
        lines.append(f"  {trace_id}: {chain}")
    return "\n".join(lines)


# -- overhead --------------------------------------------------------------


def measure_overhead(samples: int = 2000) -> dict:
    """
    Nanoseconds per :func:`start_span` enter/exit in the three regimes —
    disabled (the strict no-op), enabled-but-sampled-out, and enabled
    with a real JSONL write — so benchmarks can report the cost tracing
    adds per request or phase.

    Measures the REAL entry path (env lookup included), so it mutates
    the process-wide tracing env vars while running: any span another
    thread opens concurrently is dropped or misdirected to the
    temporary log. Call it only once the traced workload has drained.
    """
    import tempfile

    saved = {
        var: os.environ.pop(var, None)
        for var in (TRACE_LOG_ENV_VAR, TRACE_SAMPLE_ENV_VAR)
    }

    def _time_loop() -> float:
        start = time.perf_counter()
        for _ in range(samples):
            with start_span("tracing.overhead"):
                pass
        return (time.perf_counter() - start) / samples * 1e9

    try:
        disabled = _time_loop()
        with tempfile.TemporaryDirectory() as tmp:
            os.environ[TRACE_LOG_ENV_VAR] = os.path.join(tmp, "spans.jsonl")
            os.environ[TRACE_SAMPLE_ENV_VAR] = "0"
            sampled_out = _time_loop()
            os.environ[TRACE_SAMPLE_ENV_VAR] = "1"
            enabled = _time_loop()
    finally:
        for var, value in saved.items():
            if value is None:
                os.environ.pop(var, None)
            else:
                os.environ[var] = value
    return {
        "samples": samples,
        "disabled_ns_per_span": round(disabled, 1),
        "sampled_out_ns_per_span": round(sampled_out, 1),
        "enabled_ns_per_span": round(enabled, 1),
    }
