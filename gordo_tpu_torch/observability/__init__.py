"""
Telemetry of the port (the counterpart of ``gordo_tpu.observability``):
the structured JSONL event log (:mod:`.events`), the metrics registry
(:mod:`.registry`) and its Prometheus text (:mod:`.prom_text`), tracing
(:mod:`.tracing`), the phase ledger's server plane (:mod:`.attribution`)
and the ``/telemetry/snapshot`` payload (:mod:`.rollup`). None of them
needs torch. The JAX package's plane rollup, SLOs, sampling profiler,
device-memory and report modules wait for ROADMAP.md queue 1 item 9.
"""

from .events import (
    EVENT_LOG_ENV_VAR,
    EVENT_LOG_MAX_MB_ENV_VAR,
    EventEmitter,
    emit_event,
    read_events,
)
from .registry import get_registry
from .tracing import TRACE_LOG_ENV_VAR, start_span, trace_fields

__all__ = [
    "EVENT_LOG_ENV_VAR",
    "EVENT_LOG_MAX_MB_ENV_VAR",
    "EventEmitter",
    "emit_event",
    "read_events",
    "get_registry",
    "TRACE_LOG_ENV_VAR",
    "start_span",
    "trace_fields",
]
