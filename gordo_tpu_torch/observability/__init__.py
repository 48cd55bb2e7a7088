"""
Telemetry of the port (the counterpart of ``gordo_tpu.observability``):
so far the structured JSONL event log (:mod:`.events`). The metrics
registry, tracing, rollups and the rest of the JAX package's
observability wait for ROADMAP.md queue 1 item 9.
"""

from .events import (
    EVENT_LOG_ENV_VAR,
    EVENT_LOG_MAX_MB_ENV_VAR,
    EventEmitter,
    emit_event,
    read_events,
)

__all__ = [
    "EVENT_LOG_ENV_VAR",
    "EVENT_LOG_MAX_MB_ENV_VAR",
    "EventEmitter",
    "emit_event",
    "read_events",
]
