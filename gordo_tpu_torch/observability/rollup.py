"""
The serving plane's telemetry rollup (the port of
``gordo_tpu.observability.rollup``): one live view of the whole plane.

Every serving process (a replica, the router, a lifecycle daemon)
answers ``/telemetry/snapshot`` with its registry and identity,
versioned (:func:`snapshot_payload`). A :class:`RollupPoller`, inside
the router or run alone by ``rollup``, fetches the members' snapshots on
an interval and merges them into one plane registry:

- counters sum across members, after a per-member monotonic clamp
  (:class:`CounterClamp`): a replica's restart never makes a plane
  counter go backwards;
- gauges take the labelled union, each series gaining a ``replica``
  label that names its member;
- histograms merge bucket-wise through the registry's
  ``merge_histogram_states``; a metric whose bucket bounds (or kind)
  differ between members is refused, dropped from the merge and named
  under ``merge_errors``, never mis-merged.

The merge serves as the plane's ``/metrics`` (:func:`render_prometheus_text`)
and ``/status`` (:func:`plane_status`: each replica's health and the
windowed control signals of :func:`compute_signals`). The poller can
persist each merge as a stamped JSONL line (:meth:`RollupPoller.persist`),
with the knob values every replica agrees on lifted to the top level, so
the tuning corpus reader (``tuning/corpus.py``) takes the lines as
observations. Members are fetched over ``utils/http.py`` (the card's
machine has no ``requests``). With no poller configured nothing runs: no
thread and no request. Standard library only: no torch.
"""

import json
import logging
import os
import threading
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Set, Tuple

from gordo_tpu_torch.observability.attribution import DEVICE_PHASES
from gordo_tpu_torch.observability.events import emit_event
from gordo_tpu_torch.observability.registry import (
    HistogramMergeError,
    get_registry,
    histogram_stat,
    histogram_state,
    merge_histogram_states,
)

logger = logging.getLogger(__name__)

#: bumped when the payload changes shape (the JAX module's number)
SNAPSHOT_VERSION = 1

#: module import time: the uptime epoch of a process that passes none
_PROCESS_STARTED_AT = time.time()


def _now_stamp(now: Optional[float] = None) -> Tuple[str, int]:
    now = time.time() if now is None else now
    ts = time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(now)) + "Z"
    return ts, int(now * 1000)


def snapshot_payload(
    role: str,
    replica_id: Optional[str] = None,
    revision: Optional[str] = None,
    status: Optional[dict] = None,
    registry=None,
    started_at: Optional[float] = None,
    now: Optional[float] = None,
) -> dict:
    """The versioned ``/telemetry/snapshot`` body: the registry's
    snapshot and the process's identity, with the JAX payload's keys."""
    registry = registry if registry is not None else get_registry()
    started = _PROCESS_STARTED_AT if started_at is None else started_at
    ts, unix_ms = _now_stamp(now)
    return {
        "snapshot_version": SNAPSHOT_VERSION,
        "role": role,
        "replica_id": replica_id,
        "revision": revision,
        "pid": os.getpid(),
        "uptime_s": max(0.0, (unix_ms / 1000.0) - started),
        "ts": ts,
        "unix_ms": unix_ms,
        "metrics": registry.snapshot(),
        "status": status or {},
    }


# -- the registry merge ------------------------------------------------------


def _series_key(labels: Mapping[str, str]) -> Tuple:
    return tuple(sorted(labels.items()))


def _rollup_metrics() -> dict:
    reg = get_registry()
    return {
        "polls": reg.counter("gordo_rollup_polls_total",
                             "Rollup member polls by outcome (ok/error)", ("outcome",)),
        "refusals": reg.counter("gordo_rollup_merge_refusals_total",
                                "Metrics dropped from a rollup merge (shape/bucket mismatch)"),
        "resets": reg.counter("gordo_rollup_counter_resets_total",
                              "Counter resets observed across polls (member restarts)"),
    }


def merge_metrics(member_metrics: Mapping[str, Mapping[str, dict]]
                  ) -> Tuple[Dict[str, dict], List[dict]]:
    """Merge the members' registry snapshots into one: ``(merged,
    errors)``. A metric whose shape differs between members (its kind,
    its histogram bounds) is refused: dropped from ``merged`` and named in
    ``errors``, with a ``rollup_merge_refused`` event; part of it would
    read as the plane's truth."""
    merged: Dict[str, dict] = {}
    errors: List[dict] = []
    refused: Set[str] = set()
    for member_id in sorted(member_metrics):
        metrics = member_metrics[member_id] or {}
        for name, dump in metrics.items():
            if name in refused or not isinstance(dump, dict):
                continue
            kind = dump.get("type") or dump.get("kind")
            try:
                if name not in merged:
                    merged[name] = _fresh_merge_target(member_id, dump, kind)
                    continue
                target = merged[name]
                if target["type"] != kind:
                    raise HistogramMergeError(f"kind mismatch: {target['type']} vs {kind}")
                _merge_into(member_id, target, dump, kind)
            except (HistogramMergeError, KeyError, TypeError, ValueError) as exc:
                refused.add(name)
                merged.pop(name, None)
                errors.append({"metric": name, "member": member_id, "error": str(exc)})
                _rollup_metrics()["refusals"].inc()
                emit_event("rollup_merge_refused", metric=name, member=member_id,
                           error=str(exc))
    return merged, errors


def _fresh_merge_target(member_id: str, dump: dict, kind: str) -> dict:
    target = {
        "type": kind,
        "description": dump.get("description", ""),
        "labelnames": list(dump.get("labelnames") or []),
        "series": [],
    }
    _merge_into(member_id, target, dump, kind)
    return target


def _merge_into(member_id: str, target: dict, dump: dict, kind: str) -> None:
    if kind == "gauge":
        # the labelled union; a series that already names a replica (the
        # router's replica-health gauge) keeps its label
        if "replica" not in target["labelnames"]:
            target["labelnames"] = sorted(set(target["labelnames"]) | {"replica"})
        for series in dump.get("series") or []:
            labels = dict(series.get("labels") or {})
            labels.setdefault("replica", member_id)
            target["series"].append({"labels": labels, "value": series.get("value")})
        return
    by_key = {_series_key(s.get("labels") or {}): s for s in target["series"]}
    for series in dump.get("series") or []:
        labels = dict(series.get("labels") or {})
        key = _series_key(labels)
        existing = by_key.get(key)
        if kind == "histogram":
            state = {"count": series["count"], "sum": series["sum"],
                     "buckets": dict(series["buckets"])}
            if existing is None:
                entry = {"labels": labels, **state}
                target["series"].append(entry)
                by_key[key] = entry
            else:
                prior = {"count": existing["count"], "sum": existing["sum"],
                         "buckets": existing["buckets"]}
                existing.update(merge_histogram_states(prior, state))
        else:  # a counter: the sum
            value = float(series.get("value") or 0.0)
            if existing is None:
                entry = {"labels": labels, "value": value}
                target["series"].append(entry)
                by_key[key] = entry
            else:
                existing["value"] = float(existing["value"]) + value


class CounterClamp:
    """Each member's counters kept monotonic across polls: a restarted
    replica's counters start again from 0, so a series that went down
    folds its last value into a standing base (the traffic before the
    restart was real) and emits ``rollup_counter_reset``. The adjusted
    value is base + current."""

    def __init__(self):
        self._state: Dict[Tuple, Dict[str, float]] = {}

    def adjust(self, member_id: str, metrics: Mapping[str, dict]) -> dict:
        """A copy of ``metrics`` with every counter series clamped."""
        out: Dict[str, dict] = {}
        for name, dump in (metrics or {}).items():
            kind = isinstance(dump, dict) and (dump.get("type") or dump.get("kind"))
            if kind != "counter":
                out[name] = dump
                continue
            adjusted = dict(dump)
            adjusted["series"] = [self._adjust_series(member_id, name, series)
                                  for series in dump.get("series") or []]
            out[name] = adjusted
        return out

    def _adjust_series(self, member_id: str, name: str, series: dict) -> dict:
        labels = series.get("labels") or {}
        key = (member_id, name, _series_key(labels))
        value = float(series.get("value") or 0.0)
        state = self._state.setdefault(key, {"last": 0.0, "base": 0.0})
        if value < state["last"]:
            state["base"] += state["last"]
            _rollup_metrics()["resets"].inc()
            emit_event("rollup_counter_reset", member=member_id, metric=name,
                       labels=dict(labels), last=state["last"], current=value)
        state["last"] = value
        return {**series, "value": state["base"] + value}


def merge_snapshots(members: Mapping[str, dict], now: Optional[float] = None) -> dict:
    """The members' ``/telemetry/snapshot`` payloads merged into one
    plane snapshot (the same envelope, role ``plane``)."""
    ts, unix_ms = _now_stamp(now)
    merged_metrics, errors = merge_metrics(
        {mid: snap.get("metrics") or {} for mid, snap in members.items()})
    identities = {}
    for mid in sorted(members):
        snap = members[mid]
        identities[mid] = {
            "role": snap.get("role"),
            "replica_id": snap.get("replica_id"),
            "revision": snap.get("revision"),
            "pid": snap.get("pid"),
            "uptime_s": snap.get("uptime_s"),
            "unix_ms": snap.get("unix_ms"),
            "status": snap.get("status") or {},
        }
    return {
        "snapshot_version": SNAPSHOT_VERSION,
        "role": "plane",
        "ts": ts,
        "unix_ms": unix_ms,
        "members": identities,
        "metrics": merged_metrics,
        "merge_errors": errors,
    }


# -- the control signals -----------------------------------------------------


def _counter_values(metrics: Mapping[str, dict], name: str) -> Dict[Tuple, float]:
    dump = metrics.get(name) or {}
    return {_series_key(s.get("labels") or {}): float(s.get("value") or 0.0)
            for s in dump.get("series") or []}


def _counter_delta(current: Mapping[str, dict], previous: Optional[Mapping[str, dict]],
                   name: str) -> Dict[Tuple, float]:
    cur = _counter_values(current, name)
    prev = _counter_values(previous or {}, name)
    return {key: max(0.0, value - prev.get(key, 0.0)) for key, value in cur.items()}


def _gauge_sum(metrics: Mapping[str, dict], name: str) -> Optional[float]:
    dump = metrics.get(name)
    if not dump:
        return None
    return sum(float(s.get("value") or 0.0) for s in dump.get("series") or [])


def _histogram_window(current: Mapping[str, dict], previous: Optional[Mapping[str, dict]],
                      name: str, labels: Optional[Mapping[str, str]] = None
                      ) -> Optional[dict]:
    """One series' histogram over the window since the last poll (its
    lifetime state on the first poll); None with no new observation."""
    dump = current.get(name)
    if not dump:
        return None
    want = _series_key(labels) if labels else None
    cur_state = None
    for series in dump.get("series") or []:
        if want is None or _series_key(series.get("labels") or {}) == want:
            cur_state = histogram_state(series)
            break
    if cur_state is None:
        return None
    prev_state = None
    for series in ((previous or {}).get(name) or {}).get("series") or []:
        if want is None or _series_key(series.get("labels") or {}) == want:
            prev_state = histogram_state(series)
            break
    if prev_state is None:
        return cur_state
    try:
        delta_count = int(cur_state["count"]) - int(prev_state["count"])
        if delta_count <= 0:
            return None
        return {
            "count": delta_count,
            "sum": float(cur_state["sum"]) - float(prev_state["sum"]),
            "buckets": {bound: int(cum) - int(prev_state["buckets"].get(bound, 0))
                        for bound, cum in cur_state["buckets"].items()},
        }
    except (KeyError, TypeError, ValueError):
        return cur_state


def _rate(numerator: float, denominator: float) -> Optional[float]:
    if denominator <= 0:
        return None
    return numerator / denominator


def compute_signals(current: dict, previous: Optional[dict] = None,
                    now: Optional[float] = None) -> dict:
    """The plane's control signals over the window between two merged
    snapshots (lifetime totals when ``previous`` is None): ``shed_rate``,
    ``queue_depth``, ``stream_backlog`` and ``replicas_healthy``, and the
    SLO signals ``predict_p99_ms``, ``unstructured_error_rate``,
    ``stream_resume_rate``, ``drift_scan_staleness_s``, with
    ``program_cache_hit_rate`` and the host and device fractions of the
    phase ledger. A signal whose inputs the merge lacks is None."""
    metrics = current.get("metrics") or {}
    prev_metrics = (previous or {}).get("metrics") or {}
    signals: Dict[str, Optional[float]] = {}

    # shed and error rates: the router's outcomes, else the batchers' sheds
    outcomes = _counter_delta(metrics, prev_metrics, "gordo_router_requests_total")
    total = sum(outcomes.values())
    if total > 0:
        shed = sum(v for k, v in outcomes.items() if dict(k).get("outcome") == "shed")
        structured = {"ok", "partial", "shed", "refused"}
        errors = sum(v for k, v in outcomes.items()
                     if dict(k).get("outcome") not in structured)
        signals["shed_rate"] = shed / total
        signals["unstructured_error_rate"] = errors / total
    else:
        sheds = sum(_counter_delta(metrics, prev_metrics, "gordo_serve_batch_shed_total").values())
        batched = _histogram_window(metrics, prev_metrics, "gordo_serve_batch_requests")
        served = float(batched["sum"]) if batched else 0.0
        signals["shed_rate"] = _rate(sheds, sheds + served)
        signals["unstructured_error_rate"] = None if total == 0 else 0.0

    updates = _counter_delta(metrics, prev_metrics, "gordo_stream_updates_total")
    resumes = sum(v for k, v in updates.items() if dict(k).get("outcome") == "resume_required")
    signals["stream_resume_rate"] = _rate(resumes, sum(updates.values()))

    predict = _histogram_window(metrics, prev_metrics, "gordo_server_phase_seconds",
                                labels={"phase": "predict"})
    p99 = histogram_stat(predict, "p99") if predict else None
    signals["predict_p99_ms"] = None if p99 is None else p99 * 1000.0

    signals["queue_depth"] = _gauge_sum(metrics, "gordo_serve_batch_queue_depth")
    signals["stream_sessions"] = _gauge_sum(metrics, "gordo_stream_sessions")

    members = current.get("members") or {}
    backlog = None
    healthy = n_replicas = 0
    last_tick_ms: Optional[int] = None
    for info in members.values():
        status = info.get("status") or {}
        streaming = status.get("streaming") or {}
        if "backlog" in streaming:
            backlog = (backlog or 0) + float(streaming["backlog"] or 0)
        if info.get("role") == "replica":
            n_replicas += 1
            if status.get("status") == "ok":
                healthy += 1
        if info.get("role") == "lifecycle":
            tick_ms = status.get("last_tick_unix_ms") or info.get("unix_ms")
            if tick_ms:
                last_tick_ms = max(last_tick_ms or 0, int(tick_ms))
    signals["stream_backlog"] = backlog
    signals["replicas_healthy"] = float(healthy) if n_replicas else None
    signals["replicas_total"] = float(n_replicas) if n_replicas else None

    if last_tick_ms is not None:
        now = time.time() if now is None else now
        signals["drift_scan_staleness_s"] = max(0.0, now - last_tick_ms / 1000.0)
    else:
        signals["drift_scan_staleness_s"] = None

    hits = sum(_counter_delta(metrics, prev_metrics, "gordo_program_cache_hits_total").values())
    misses = sum(_counter_delta(metrics, prev_metrics,
                                "gordo_program_cache_misses_total").values())
    signals["program_cache_hit_rate"] = _rate(hits, hits + misses)

    # the phase ledger's window split into host and device seconds
    host_s = device_s = 0.0
    for series in (metrics.get("gordo_phase_seconds") or {}).get("series") or []:
        labels = dict(series.get("labels") or {})
        window = _histogram_window(metrics, prev_metrics, "gordo_phase_seconds", labels=labels)
        if not window:
            continue
        if labels.get("phase") in DEVICE_PHASES:
            device_s += float(window["sum"])
        else:
            host_s += float(window["sum"])
    signals["host_fraction"] = _rate(host_s, host_s + device_s)
    signals["device_fraction"] = _rate(device_s, host_s + device_s)
    return signals


# -- the Prometheus text of a merge ------------------------------------------


def render_prometheus_text(metrics: Mapping[str, dict]) -> str:
    """A (merged) registry dump in the Prometheus text format, the JAX
    function's lines."""
    lines: List[str] = []
    for name in sorted(metrics):
        dump = metrics[name]
        kind = dump.get("type") or dump.get("kind") or "untyped"
        description = str(dump.get("description") or "").replace("\n", " ")
        lines.append(f"# HELP {name} {description}")
        lines.append(f"# TYPE {name} {kind}")
        for series in dump.get("series") or []:
            labels = series.get("labels") or {}
            if kind == "histogram":
                state = histogram_state(series)
                if state is None:
                    continue
                for bound, cum in sorted(
                    state["buckets"].items(),
                    key=lambda kv: float("inf") if kv[0] == "+Inf" else float(kv[0]),
                ):
                    lines.append(f"{name}_bucket{_label_text({**labels, 'le': bound})} {cum}")
                lines.append(f"{name}_sum{_label_text(labels)} {state['sum']}")
                lines.append(f"{name}_count{_label_text(labels)} {state['count']}")
            else:
                value = series.get("value")
                if value is None:
                    continue
                lines.append(f"{name}{_label_text(labels)} {value}")
    return "\n".join(lines) + "\n"


def _label_text(labels: Mapping[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label(v)}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _escape_label(value) -> str:
    return str(value).replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


# -- the poller --------------------------------------------------------------

#: knob fields lifted to the top of a persisted line when every replica
#: of the plane agrees on the value: the corpus reader then pairs the arm
#: with the histogram signals nested in ``metrics``
_PLANE_KNOB_FIELDS = (
    ("batching", "batch_wait_ms"),
    ("batching", "queue_limit"),
)

_TRANSPORT = None
_TRANSPORT_LOCK = threading.Lock()


def _transport():
    global _TRANSPORT
    with _TRANSPORT_LOCK:
        if _TRANSPORT is None:
            from gordo_tpu_torch.utils.http import HttpTransport

            _TRANSPORT = HttpTransport()
        return _TRANSPORT


def fetch_json(url: str, timeout: float = 10.0, transport=None) -> dict:
    """GET ``url`` as JSON over a pooled keep-alive connection; a status
    of 400 or more raises ``IOError``."""
    reply = (transport or _transport()).request("GET", url, timeout=timeout)
    if reply.status >= 400:
        raise IOError(f"{url} answered {reply.status}: {reply.body[:200]!r}")
    return reply.json()


def default_fetch(url: str, timeout: float = 5.0) -> dict:
    """One member's snapshot: ``url`` is its base URL (``/telemetry/snapshot``
    is added unless there) or the path of a snapshot JSON file (a
    lifecycle daemon's ``last_tick.json``)."""
    if "://" not in url or url.startswith("file://"):
        path = url[len("file://"):] if url.startswith("file://") else url
        with open(path) as fh:
            return json.load(fh)
    if not url.rstrip("/").endswith("/telemetry/snapshot"):
        url = url.rstrip("/") + "/telemetry/snapshot"
    return fetch_json(url, timeout=timeout)


class RollupPoller:
    """Polls the members' ``/telemetry/snapshot``, merges, computes the
    windowed signals and, with ``persist_path``, appends each merge to a
    JSONL file. ``members`` returns ``{member id: url}`` (the router's
    live replica set); ``local_members`` maps ids to callables that make
    a snapshot in this process (the router's own). With ``interval_s``
    of 0 no thread exists: callers call :meth:`poll_once`."""

    def __init__(
        self,
        members: Callable[[], Dict[str, str]],
        interval_s: float = 0.0,
        fetch: Optional[Callable[[str], dict]] = None,
        local_members: Optional[Dict[str, Callable[[], dict]]] = None,
        persist_path: Optional[str] = None,
        retention: int = 500,
        name: str = "rollup",
    ):
        self.members = members
        self.interval_s = float(interval_s)
        self.fetch = fetch or default_fetch
        self.local_members = dict(local_members or {})
        self.persist_path = persist_path
        self.retention = int(retention)
        self.name = name
        self.clamp = CounterClamp()
        self._lock = threading.Lock()
        self._merged: Optional[dict] = None
        self._previous: Optional[dict] = None
        self._signals: Dict[str, Any] = {}
        self._poll_errors: Dict[str, str] = {}
        self._n_polls = 0
        self._stopping = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        """Start the poll loop (only with an interval above 0)."""
        if self.interval_s <= 0 or self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop, name=f"gordo-{self.name}-poller",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stopping.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _loop(self) -> None:
        while not self._stopping.wait(self.interval_s):
            try:
                self.poll_once()
            except Exception:  # the plane's view outlives a failed poll
                logger.exception("Rollup poll failed")

    def poll_once(self, now: Optional[float] = None) -> dict:
        """One poll: fetch every member, clamp the counters, merge,
        compute the signals, persist. The merge, with its ``signals``
        and ``poll`` blocks."""
        snapshots: Dict[str, dict] = {}
        errors: Dict[str, str] = {}
        counters = _rollup_metrics()
        targets = dict(self.members() or {})
        for member_id, url in targets.items():
            try:
                snapshots[member_id] = self.fetch(url)
                counters["polls"].inc(outcome="ok")
            except Exception as exc:  # a dead member is data
                errors[member_id] = str(exc)
                counters["polls"].inc(outcome="error")
        for member_id, produce in self.local_members.items():
            try:
                snapshots[member_id] = produce()
            except Exception as exc:
                errors[member_id] = str(exc)
        clamped = {mid: {**snap, "metrics": self.clamp.adjust(mid, snap.get("metrics") or {})}
                   for mid, snap in snapshots.items()}
        merged = merge_snapshots(clamped, now=now)
        with self._lock:
            previous = self._merged
            signals = compute_signals(merged, previous, now=now)
            merged["signals"] = signals
            merged["poll"] = {
                "interval_s": self.interval_s,
                "n_polls": self._n_polls + 1,
                "members_polled": sorted(targets) + sorted(self.local_members),
                "member_errors": errors,
            }
            self._previous = previous
            self._merged = merged
            self._signals = signals
            self._poll_errors = errors
            self._n_polls += 1
        if self.persist_path:
            try:
                self.persist(merged)
            except OSError as exc:
                logger.warning("Rollup persist failed: %s", exc)
        return merged

    def merged(self) -> Optional[dict]:
        """The latest merge (None before the first poll)."""
        with self._lock:
            return self._merged

    def status_payload(self, now: Optional[float] = None) -> dict:
        """The plane's ``/status`` body, from the latest merge."""
        with self._lock:
            merged = self._merged
        if merged is None:
            merged = self.poll_once(now=now)
        return plane_status(merged)

    def persist(self, merged: dict) -> None:
        """Append one stamped JSONL line, with the plane-uniform knob
        values lifted to its top, and trim the file to ``retention``
        lines."""
        line = dict(merged)
        line.update(_plane_uniform_knobs(merged))
        parent = os.path.dirname(self.persist_path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(self.persist_path, "a") as fh:
            fh.write(json.dumps(line, default=str) + "\n")
        self._trim()

    def _trim(self) -> None:
        if self.retention <= 0:
            return
        try:
            with open(self.persist_path) as fh:
                lines = fh.readlines()
        except OSError:
            return
        if len(lines) <= self.retention:
            return
        tmp = self.persist_path + ".tmp"
        with open(tmp, "w") as fh:
            fh.writelines(lines[-self.retention:])
        os.replace(tmp, self.persist_path)


def _plane_uniform_knobs(merged: dict) -> dict:
    """The knob values every replica of the merge agrees on; a plane of
    mixed settings lifts none (an observation must not name a mixed arm)."""
    out: Dict[str, Any] = {}
    members = [info for info in (merged.get("members") or {}).values()
               if info.get("role") == "replica"]
    if not members:
        return out
    for section, field in _PLANE_KNOB_FIELDS:
        values = set()
        for info in members:
            block = (info.get("status") or {}).get(section) or {}
            if field not in block:
                values = set()
                break
            values.add(block[field])
        if len(values) == 1:
            out[field] = values.pop()
    return out


def plane_status(merged: dict) -> dict:
    """The plane's ``/status`` body: each replica's health and load, the
    control signals, the routers' and lifecycle daemons' status."""
    members = merged.get("members") or {}
    signals = merged.get("signals") or {}
    replicas = {}
    for mid, info in members.items():
        status = info.get("status") or {}
        if info.get("role") != "replica":
            continue
        replicas[mid] = {
            "status": status.get("status"),
            "revision": info.get("revision"),
            "uptime_s": info.get("uptime_s"),
            "queue_depth": (status.get("batching") or {}).get("queue_depth"),
            "sheds_total": (status.get("batching") or {}).get("sheds_total"),
            "stream_sessions": (status.get("streaming") or {}).get("sessions"),
            "stream_backlog": (status.get("streaming") or {}).get("backlog"),
        }
    routers = {mid: (info.get("status") or {}) for mid, info in members.items()
               if info.get("role") == "router"}
    # a router member's breaker state rides each replica's row (member
    # ids are the ring's replica ids)
    for status in routers.values():
        for rid, health in (status.get("replicas") or {}).items():
            if rid in replicas:
                replicas[rid]["health"] = health
            else:
                replicas[rid] = {"health": health}
    lifecycle = {mid: {"unix_ms": info.get("unix_ms"), "status": info.get("status") or {}}
                 for mid, info in members.items() if info.get("role") == "lifecycle"}
    return {
        "snapshot_version": merged.get("snapshot_version"),
        "role": "plane",
        "ts": merged.get("ts"),
        "unix_ms": merged.get("unix_ms"),
        "signals": signals,
        "replicas": replicas,
        "routers": routers,
        "lifecycle": lifecycle,
        "merge_errors": merged.get("merge_errors") or [],
        "poll": merged.get("poll") or {},
    }


# -- the standalone WSGI app (`rollup`, a plane with no router) --------------


def rollup_wsgi_app(poller: RollupPoller):
    """A WSGI app serving the merged view: ``/metrics`` (Prometheus
    text), ``/status`` (JSON), ``/telemetry/snapshot`` (the whole merge)
    and ``/healthcheck``."""

    def app(environ, start_response):
        path = environ.get("PATH_INFO", "/")
        if path == "/healthcheck":
            body = json.dumps({"gordo-tpu-rollup": True}).encode()
            content_type = "application/json"
        elif path == "/metrics":
            merged = poller.merged() or poller.poll_once()
            body = render_prometheus_text(merged.get("metrics") or {}).encode()
            content_type = "text/plain; version=0.0.4"
        elif path == "/status":
            body = json.dumps(poller.status_payload(), default=str).encode()
            content_type = "application/json"
        elif path == "/telemetry/snapshot":
            merged = poller.merged() or poller.poll_once()
            body = json.dumps(merged, default=str).encode()
            content_type = "application/json"
        else:
            body = json.dumps({"error": "Not found"}).encode()
            start_response("404 NOT FOUND", [("Content-Type", "application/json"),
                                             ("Content-Length", str(len(body)))])
            return [body]
        start_response("200 OK", [("Content-Type", content_type),
                                  ("Content-Length", str(len(body)))])
        return [body]

    return app
