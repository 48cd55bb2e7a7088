"""
Telemetry reports (the port of ``gordo_tpu.observability.report``): the
``telemetry_report.json`` a fleet build leaves beside its artifacts, and
the aggregation behind ``telemetry summarize <dir>``: every report and
JSONL event log under a directory (models built, models/hour, casualties,
peak device memory, the ledger's units and steals, events by subsystem
and any crash context), as text or as JAX's versioned JSON payload
(``SUMMARY_SCHEMA_VERSION``). The ``rollup`` and ``phases`` sections read
the persisted rollup files under the directory (JSONL lines with
``snapshot_version`` and ``metrics``, as ``run-router --rollup-persist``
and ``rollup --persist`` write them): each file's members and last
signals, and the phase ledger's host and device seconds. Stdlib only: no
torch.
"""

import json
import logging
import os
import typing
from pathlib import Path

logger = logging.getLogger(__name__)

TELEMETRY_REPORT_FILENAME = "telemetry_report.json"
TELEMETRY_REPORT_VERSION = 1
#: schema of the ``telemetry summarize --as-json`` payload (the JAX
#: package's number: 4 has the ``phases`` and ``rollup`` sections)
SUMMARY_SCHEMA_VERSION = 4

#: event-type -> subsystem classification for the per-subsystem summary
#: sections: ordered (prefix | exact-name set) rules, first match wins
#: (the JAX package's table).
EVENT_SUBSYSTEM_RULES: typing.Tuple[
    typing.Tuple[str, typing.Tuple[str, ...], typing.Tuple[str, ...]], ...
] = (
    ("batching", ("batch_",), ("request_shed",)),
    ("ledger", ("lease_", "worker_", "ledger_"), ("unit_poisoned",)),
    ("router", ("replica_", "router_"), ("shard_failover",)),
    ("streaming", ("stream_",), ()),
    (
        "lifecycle",
        ("drift_", "refit_", "revision_", "lifecycle_"),
        ("machine_drifted", "checkpoint_fallback"),
    ),
    ("programs", ("program_cache_", "compile_cache_"), ()),
    ("tuning", ("tuning_",), ()),
    ("rollup", ("rollup_", "slo_"), ()),
    (
        "robustness",
        ("fault_",),
        ("machine_quarantined", "build_machine_failed"),
    ),
)


def classify_event(event: str) -> str:
    """The summary subsystem an event type belongs to ('build' for the
    original build/training family and anything unrecognized)."""
    for subsystem, prefixes, names in EVENT_SUBSYSTEM_RULES:
        if event in names or any(event.startswith(p) for p in prefixes):
            return subsystem
    return "build"


def write_telemetry_report(
    directory: typing.Union[str, Path], report: dict
) -> Path:
    """Persist ``report`` as ``<directory>/telemetry_report.json`` (with
    the report's ``version``), published whole: concurrent finalizers of
    one ledger write the same report."""
    from gordo_tpu_torch.utils.atomic import atomic_write_json

    payload = {"version": TELEMETRY_REPORT_VERSION}
    payload.update(report)
    return atomic_write_json(Path(directory) / TELEMETRY_REPORT_FILENAME, payload, indent=2,
                             sort_keys=True, default=str)


def load_reports(
    directory: typing.Union[str, Path]
) -> typing.List[typing.Tuple[Path, dict]]:
    """Every parseable ``telemetry_report*.json`` under ``directory``."""
    out: typing.List[typing.Tuple[Path, dict]] = []
    for path in sorted(Path(directory).rglob("telemetry_report*.json")):
        try:
            with open(path) as fh:
                out.append((path, json.load(fh)))
        except (OSError, ValueError):
            logger.warning("Skipping unreadable telemetry report %s", path)
    return out


def load_event_files(
    directory: typing.Union[str, Path]
) -> typing.List[typing.Tuple[Path, typing.List[dict]]]:
    """Every JSONL file under ``directory`` that holds event records."""
    from gordo_tpu_torch.observability.events import read_events

    out = []
    for path in sorted(Path(directory).rglob("*.jsonl")):
        try:
            records = read_events(str(path))
        except OSError:
            continue
        if records and all("event" in r for r in records):
            out.append((path, records))
    return out


def load_rollup_files(
    directory: typing.Union[str, Path]
) -> typing.List[typing.Tuple[Path, typing.List[dict]]]:
    """Every JSONL file under ``directory`` holding persisted merged
    plane snapshots (rollup.py): recognized by the ``snapshot_version``
    + ``metrics`` keys every line carries. Disjoint from
    :func:`load_event_files` — snapshot lines have no ``event`` key."""
    out = []
    for path in sorted(Path(directory).rglob("*.jsonl")):
        records: typing.List[dict] = []
        try:
            with open(path) as fh:
                for line in fh:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        record = json.loads(line)
                    except ValueError:
                        continue  # torn last line — a crashed writer
                    if isinstance(record, dict):
                        records.append(record)
        except OSError:
            continue
        if records and all(
            "snapshot_version" in r and "metrics" in r for r in records
        ):
            out.append((path, records))
    return out


def summarize_rollups(
    rollup_files: typing.Sequence[typing.Tuple[Path, typing.List[dict]]]
) -> typing.List[dict]:
    """One summary object per merged-snapshot file: snapshot count,
    per-replica breakdown and the latest control signals — the
    machine-readable ``rollup`` section of the summary payload."""
    out = []
    for path, records in rollup_files:
        last = records[-1]
        members = last.get("members") or {}
        replicas = {
            mid: {
                "role": info.get("role"),
                "revision": info.get("revision"),
                "status": (info.get("status") or {}).get("status"),
                "uptime_s": info.get("uptime_s"),
            }
            for mid, info in members.items()
        }
        out.append(
            {
                "path": str(path),
                "n_snapshots": len(records),
                "first_ts": records[0].get("ts"),
                "last_ts": last.get("ts"),
                "members": replicas,
                "signals": last.get("signals") or {},
                "merge_errors": last.get("merge_errors") or [],
            }
        )
    return out


def summarize_phases(
    rollup_files: typing.Sequence[typing.Tuple[Path, typing.List[dict]]]
) -> dict:
    """The ``phases`` section of the summary payload: the phase
    ledger's ``gordo_phase_seconds`` accounting aggregated across the
    LAST snapshot of every persisted rollup file (counters in a
    snapshot are lifetime totals, so the last line is the file's
    complete view). ``{}`` when no rollup carried ledger data."""
    from gordo_tpu_torch.observability.attribution import DEVICE_PHASES, phase_totals

    merged: typing.Dict[str, typing.Dict[str, float]] = {}
    for _, records in rollup_files:
        metrics = records[-1].get("metrics") or {}
        for (plane, phase), state in phase_totals(snapshot=metrics).items():
            entry = merged.setdefault(
                f"{plane}/{phase}", {"count": 0, "sum_s": 0.0}
            )
            entry["count"] += int(state["count"])
            entry["sum_s"] += float(state["sum"])
    if not merged:
        return {}
    host_s = sum(
        e["sum_s"]
        for key, e in merged.items()
        if key.rpartition("/")[2] not in DEVICE_PHASES
    )
    total_s = sum(e["sum_s"] for e in merged.values())
    device_s = total_s - host_s
    return {
        "phases": merged,
        "host_s": host_s,
        "device_s": device_s,
        "host_fraction": host_s / total_s if total_s else None,
        "device_fraction": device_s / total_s if total_s else None,
    }


def _fmt_rate(value: typing.Optional[float]) -> str:
    if value is None:
        return "n/a"
    if value >= 1e6:
        return f"{value / 1e6:.2f}M"
    if value >= 1e3:
        return f"{value / 1e3:.1f}k"
    return f"{value:.1f}"


def _fmt_bytes(value: typing.Optional[int]) -> str:
    if value is None:
        return "n/a"
    size = float(value)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if size < 1024 or unit == "TiB":
            return f"{size:.1f} {unit}"
        size /= 1024
    return f"{size:.1f} TiB"  # pragma: no cover - loop always returns


def _fmt_seconds(value: typing.Optional[float]) -> str:
    return "n/a" if value is None else f"{value:.3g} s"


def summarize_report(path: Path, report: dict) -> typing.List[str]:
    """Render one build report as indented human-readable lines."""
    lines = [f"{path}:"]
    lines.append(
        "  fleet build: {m} machines in {b} bucket(s), {w} wall, "
        "{r} models/hour{res}".format(
            m=report.get("n_machines", "?"),
            b=report.get("n_buckets", "?"),
            w=_fmt_seconds(report.get("wall_time_s")),
            r=_fmt_rate(report.get("models_per_hour")),
            res=(
                f", {report['n_resumed']} resumed"
                if report.get("n_resumed")
                else ""
            ),
        )
    )
    for i, bucket in enumerate(report.get("buckets", [])):
        fit = bucket.get("fit") or {}
        lines.append(
            "  bucket {i}: {m} machines x {n} timesteps, cv {cv} + fit {ft}"
            .format(
                i=i,
                m=bucket.get("n_machines", "?"),
                n=bucket.get("n_timesteps_grid", "?"),
                cv=_fmt_seconds(bucket.get("cv_duration_s")),
                ft=_fmt_seconds(bucket.get("fit_duration_s")),
            )
        )
        lines.append(
            "    compile {c}, steady epoch {e}, {t} sensor-timesteps/s"
            .format(
                c=_fmt_seconds(fit.get("compile_time_s")),
                e=_fmt_seconds(fit.get("steady_state_epoch_s")),
                t=_fmt_rate(fit.get("sensor_timesteps_per_s")),
            )
        )
        mem = bucket.get("device_memory") or {}
        lines.append(
            "    peak HBM: "
            + (
                _fmt_bytes(mem.get("peak_bytes_in_use"))
                if mem.get("available")
                else "n/a (backend reports no memory stats)"
            )
        )
    # optional report fields (older reports lack them)
    if report.get("bucket_policy"):
        lines.append(f"  bucket policy: {report['bucket_policy']}")
    cache = report.get("compile_cache") or {}
    if cache.get("end_bytes") is not None:
        grown = cache.get("grown_bytes")
        lines.append(
            "  compile cache: {e}{g}".format(
                e=_fmt_bytes(cache.get("end_bytes")),
                g=(
                    f" (+{_fmt_bytes(grown)} this build)"
                    if grown
                    else ""
                ),
            )
        )
    failed = report.get("machines_failed") or []
    quarantined = report.get("machines_quarantined") or []
    if failed or quarantined:
        lines.append(
            f"  casualties: {len(failed)} failed, "
            f"{len(quarantined)} quarantined"
        )
        for record in failed:
            lines.append(
                "    FAILED {m} ({p}): {e}".format(
                    m=record.get("machine", "?"),
                    p=record.get("phase", "?"),
                    e=record.get("error", "?"),
                )
            )
        for record in quarantined:
            lines.append(
                "    QUARANTINED {m} at epoch {e}".format(
                    m=record.get("machine", "?"),
                    e=record.get("epoch", "?"),
                )
            )
    return lines


def group_events_by_subsystem(
    event_files: typing.Sequence[typing.Tuple[Path, typing.List[dict]]]
) -> typing.Dict[str, typing.Dict[str, int]]:
    """``{subsystem: {event type: count}}`` across the event logs."""
    out: typing.Dict[str, typing.Dict[str, int]] = {}
    for _, records in event_files:
        for record in records:
            event = record["event"]
            counts = out.setdefault(classify_event(event), {})
            counts[event] = counts.get(event, 0) + 1
    return out


def summary_payload(directory: typing.Union[str, Path]) -> dict:
    """
    The ``telemetry summarize --as-json`` payload: versioned
    (``schema_version``) object carrying every report plus the event
    counts grouped per subsystem — the machine-readable sibling of
    :func:`summarize_directory`.
    """
    directory = Path(directory)
    reports = load_reports(directory)
    event_files = load_event_files(directory)
    rollup_files = load_rollup_files(directory)
    return {
        "schema_version": SUMMARY_SCHEMA_VERSION,
        "directory": str(directory),
        "reports": [
            {"path": str(path), "report": report} for path, report in reports
        ],
        "n_events": sum(len(records) for _, records in event_files),
        "events": group_events_by_subsystem(event_files),
        "rollup": summarize_rollups(rollup_files),
        "phases": summarize_phases(rollup_files),
    }


def summarize_directory(directory: typing.Union[str, Path]) -> str:
    """
    The ``gordo-tpu telemetry summarize`` body: every telemetry report
    and event log under ``directory``, aggregated into one fleet view
    with per-subsystem event sections (batching, ledger, router,
    streaming, lifecycle, programs, tuning, robustness, build).
    """
    directory = Path(directory)
    reports = load_reports(directory)
    event_files = load_event_files(directory)
    lines = [f"Telemetry summary for {directory}"]

    lines.append(f"Reports: {len(reports)}")
    for path, report in reports:
        lines.extend(summarize_report(path.relative_to(directory), report))
    if reports:
        total_machines = sum(r.get("n_machines") or 0 for _, r in reports)
        # aggregate rate over machines BUILT (resume-reused ones were
        # loaded, not built); older reports without n_built fall back to
        # n_machines
        total_built = sum(
            (
                r["n_built"]
                if r.get("n_built") is not None
                else r.get("n_machines")
            )
            or 0
            for _, r in reports
        )
        total_wall = sum(r.get("wall_time_s") or 0.0 for _, r in reports)
        peaks = [
            (r.get("device_memory") or {}).get("peak_bytes_in_use")
            for _, r in reports
        ]
        peaks = [p for p in peaks if p is not None]
        lines.append(
            "Fleet total: {m} machines, {w}; aggregate {r} models/hour; "
            "peak HBM {p}".format(
                m=total_machines,
                w=_fmt_seconds(total_wall),
                r=_fmt_rate(
                    total_built / total_wall * 3600 if total_wall else None
                ),
                p=_fmt_bytes(max(peaks)) if peaks else "n/a",
            )
        )

    rollup_files = load_rollup_files(directory)
    phases = summarize_phases(rollup_files)
    if phases:
        lines.append("Time attribution (phase ledger):")
        for key, entry in sorted(
            phases["phases"].items(), key=lambda kv: -kv[1]["sum_s"]
        ):
            lines.append(
                "  {k}: {s} over {c} bracket(s)".format(
                    k=key,
                    s=_fmt_seconds(entry["sum_s"]),
                    c=entry["count"],
                )
            )
        lines.append(
            "  host {h} ({hf:.1%}) / device {d} ({df:.1%})".format(
                h=_fmt_seconds(phases["host_s"]),
                hf=phases["host_fraction"] or 0.0,
                d=_fmt_seconds(phases["device_s"]),
                df=phases["device_fraction"] or 0.0,
            )
        )

    rollups = summarize_rollups(rollup_files)
    if rollups:
        lines.append(f"Plane rollups: {len(rollups)} file(s)")
        for entry in rollups:
            lines.append(
                "  {p}: {n} merged snapshot(s), {f} .. {l}".format(
                    p=entry["path"],
                    n=entry["n_snapshots"],
                    f=entry["first_ts"] or "?",
                    l=entry["last_ts"] or "?",
                )
            )
            for mid, info in sorted(entry["members"].items()):
                lines.append(
                    "    {m} [{r}] status={s} revision={rev}".format(
                        m=mid,
                        r=info.get("role") or "?",
                        s=info.get("status") or "?",
                        rev=info.get("revision") or "?",
                    )
                )
            signals = {
                k: v
                for k, v in sorted(entry["signals"].items())
                if v is not None
            }
            if signals:
                lines.append(
                    "    signals: "
                    + ", ".join(f"{k}={v:.4g}" for k, v in signals.items())
                )
            for err in entry["merge_errors"]:
                lines.append(
                    "    MERGE REFUSED {m}: {e}".format(
                        m=err.get("metric", "?"), e=err.get("error", "?")
                    )
                )

    n_events = sum(len(records) for _, records in event_files)
    lines.append(f"Event logs: {len(event_files)} file(s), {n_events} event(s)")
    for subsystem, counts in sorted(
        group_events_by_subsystem(event_files).items()
    ):
        total = sum(counts.values())
        lines.append(f"  [{subsystem}] {total} event(s)")
        for event, count in sorted(counts.items()):
            lines.append(f"    {event}: {count}")
    crashes = [
        record
        for _, records in event_files
        for record in records
        if "crash" in record["event"]
    ]
    for crash in crashes:
        lines.append(
            "  CRASH CONTEXT: {e} at {ts}: {err}".format(
                e=crash["event"],
                ts=crash.get("ts", "?"),
                err=crash.get("error", "?"),
            )
        )
    if not reports and not event_files:
        lines.append(
            "(nothing found — expected telemetry_report*.json or *.jsonl "
            f"event logs under {os.fspath(directory)})"
        )
    return "\n".join(lines)
