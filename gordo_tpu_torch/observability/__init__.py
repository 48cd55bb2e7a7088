"""
Telemetry of the port (the counterpart of ``gordo_tpu.observability``):
the structured JSONL event log (:mod:`.events`), the metrics registry
(:mod:`.registry`) and its Prometheus text (:mod:`.prom_text`), tracing
(:mod:`.tracing`), the phase ledger's server, stream, train and router
planes (:mod:`.attribution`), the card's memory watermarks
(:mod:`.device_memory`), the fleet build's telemetry reports and
``telemetry summarize`` (:mod:`.report`), the serving plane's rollup
(:mod:`.rollup`: the ``/telemetry/snapshot`` payload, the merge, the
control signals and the poller) and SLOs as error budgets
(:mod:`.slo`), the sampling wall profiler (:mod:`.sampling`,
``GORDO_PROFILE_HZ``) and the ``torch.profiler`` trace hooks
(:mod:`.profiler`, ``GORDO_TPU_PROFILE_DIR``). None of them imports torch
at import time. The names are the JAX package's.
"""

from .attribution import (
    DEVICE_PHASES,
    HOST_PHASES,
    LEDGER_ENV_VAR,
    PHASES,
    PLANES,
    PhaseLedger,
    ledger_enabled,
    ledger_for,
    phase_totals,
    record_current,
)
from .device_memory import device_memory_stats, memory_watermarks, save_device_memory_profile
from .events import (
    EVENT_LOG_ENV_VAR,
    EVENT_LOG_MAX_MB_ENV_VAR,
    EventEmitter,
    emit_event,
    read_events,
)
from .profiler import PROFILE_DIR_ENV_VAR, annotate, maybe_trace, profile_dir
from .sampling import (
    PROFILE_HZ_ENV_VAR,
    PROFILE_OUT_ENV_VAR,
    WallSampler,
    active_sampler,
    folded_lines,
    maybe_start_from_env,
    profiler_active,
)
from .registry import (
    Counter,
    Gauge,
    Histogram,
    HistogramMergeError,
    MetricsRegistry,
    get_registry,
    histogram_quantile,
    histogram_stat,
    histogram_state,
    merge_histogram_states,
)
from .report import (
    TELEMETRY_REPORT_FILENAME,
    load_reports,
    summarize_directory,
    summary_payload,
    write_telemetry_report,
)
from .rollup import (
    SNAPSHOT_VERSION,
    RollupPoller,
    compute_signals,
    merge_snapshots,
    plane_status,
    render_prometheus_text,
    snapshot_payload,
)
from .slo import (
    SloObjective,
    SloReport,
    SloSpec,
    evaluate,
    evaluate_values,
    load_slo_spec,
    parse_slo_spec,
)
from .tracing import (
    TRACE_ID_RESPONSE_HEADER,
    TRACE_LOG_ENV_VAR,
    TRACE_SAMPLE_ENV_VAR,
    TRACEPARENT_HEADER,
    SpanContext,
    current_context,
    current_span,
    current_traceparent,
    format_traceparent,
    parse_traceparent,
    propagation_headers,
    read_spans,
    record_span,
    spans_to_chrome_trace,
    start_span,
    summarize_spans,
    trace_fields,
    tracing_enabled,
)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "get_registry",
    "EVENT_LOG_ENV_VAR",
    "EventEmitter",
    "emit_event",
    "read_events",
    "TRACE_ID_RESPONSE_HEADER",
    "TRACE_LOG_ENV_VAR",
    "TRACE_SAMPLE_ENV_VAR",
    "TRACEPARENT_HEADER",
    "SpanContext",
    "current_context",
    "current_span",
    "current_traceparent",
    "format_traceparent",
    "parse_traceparent",
    "propagation_headers",
    "read_spans",
    "record_span",
    "spans_to_chrome_trace",
    "start_span",
    "summarize_spans",
    "trace_fields",
    "tracing_enabled",
    "device_memory_stats",
    "memory_watermarks",
    "save_device_memory_profile",
    "TELEMETRY_REPORT_FILENAME",
    "write_telemetry_report",
    "load_reports",
    "summarize_directory",
    "summary_payload",
    "EVENT_LOG_MAX_MB_ENV_VAR",
    "HistogramMergeError",
    "histogram_quantile",
    "histogram_stat",
    "histogram_state",
    "merge_histogram_states",
    "SNAPSHOT_VERSION",
    "RollupPoller",
    "compute_signals",
    "merge_snapshots",
    "plane_status",
    "render_prometheus_text",
    "snapshot_payload",
    "SloObjective",
    "SloReport",
    "SloSpec",
    "evaluate",
    "evaluate_values",
    "load_slo_spec",
    "parse_slo_spec",
    "DEVICE_PHASES",
    "HOST_PHASES",
    "LEDGER_ENV_VAR",
    "PHASES",
    "PLANES",
    "PhaseLedger",
    "ledger_enabled",
    "ledger_for",
    "phase_totals",
    "record_current",
    "PROFILE_DIR_ENV_VAR",
    "annotate",
    "maybe_trace",
    "profile_dir",
    "PROFILE_HZ_ENV_VAR",
    "PROFILE_OUT_ENV_VAR",
    "WallSampler",
    "active_sampler",
    "folded_lines",
    "maybe_start_from_env",
    "profiler_active",
]
