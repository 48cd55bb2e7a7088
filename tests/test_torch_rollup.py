"""
The serving plane's telemetry in the port (``observability/{rollup,
slo}.py``, the router's ``/status``, ``/metrics`` and
``/telemetry/snapshot``, ``cli/plane.py``) against the JAX package's, on
the same member snapshots. Exact unless stated: the merge, the counter
clamp across a replica's restart, the control signals, the Prometheus
text and the ``/status`` body are plain-Python arithmetic in the same
order in both packages.

- A histogram whose bucket bounds differ between members is refused
  under ``merge_errors`` by both, never mis-merged; a JAX-written
  registry snapshot and a port-written one of the same series merge.
- The poller's persisted lines (stamped, trimmed to retention, the
  plane-uniform knobs lifted) are the JAX poller's, and both corpus
  readers take them as the same observations.
- SLO specs (JSON and YAML) parse, evaluate and render as JAX's, and
  ``slo check`` exits as the JAX command does.
- With no poller the router starts no thread and asks no replica for a
  snapshot; with an interval its poller thread runs and persists.
- The router's ``/status`` and ``/metrics`` over two replicas equal the
  JAX router's over the same replica snapshots (stamps, uptimes and the
  JAX router's phase-ledger series aside: the router plane of the phase
  ledger is not ported).
"""

import copy
import json
import threading
import time

import pytest
from click.testing import CliRunner

from gordo_tpu.cli import gordo as jax_gordo
from gordo_tpu.observability import registry as jax_registry
from gordo_tpu.observability import rollup as jax_rollup
from gordo_tpu.observability import slo as jax_slo
from gordo_tpu.tuning.corpus import read_corpus as jax_read_corpus
from gordo_tpu_torch.cli import plane
from gordo_tpu_torch.observability import registry, rollup, slo
from gordo_tpu_torch.router.app import RouterApp
from gordo_tpu_torch.tuning.corpus import read_corpus
from gordo_tpu_torch.utils.http import Reply

NOW = 1_760_000_000.0


@pytest.fixture(autouse=True)
def _fresh_registries():
    registry.get_registry().reset()
    jax_registry.get_registry().reset()
    yield
    registry.get_registry().reset()
    jax_registry.get_registry().reset()


def _counter(value, labels=None, labelnames=()):
    return {"type": "counter", "description": "d", "labelnames": list(labelnames),
            "series": [{"labels": dict(labels or {}), "value": value}]}


def _gauge(value, labels=None, labelnames=()):
    return {"type": "gauge", "description": "d", "labelnames": list(labelnames),
            "series": [{"labels": dict(labels or {}), "value": value}]}


def _histogram(count, total, buckets, labels=None, labelnames=()):
    return {"type": "histogram", "description": "d", "labelnames": list(labelnames),
            "series": [{"labels": dict(labels or {}), "count": count, "sum": total,
                        "buckets": dict(buckets)}]}


def _member(role, metrics, status=None, unix_ms=None, replica_id=None, revision="rev-1"):
    return {"snapshot_version": 1, "role": role, "replica_id": replica_id,
            "revision": revision, "pid": 7, "uptime_s": 3.0, "ts": "2025-10-09T08:53:20Z",
            "unix_ms": unix_ms or int(NOW * 1000), "metrics": metrics, "status": status or {}}


def _replica(rid, requests, predict, wait_ms=5.0, status="ok", backlog=0, bounds=None):
    """A replica's snapshot: request and phase series, a batching
    histogram, its queue gauge and its /healthz status."""
    phase_buckets = bounds or {"0.01": predict // 2, "0.5": predict, "+Inf": predict}
    return _member("replica", {
        "gordo_server_requests_total": _counter(requests, {"route": "fleet", "status": "200"},
                                                ["route", "status"]),
        "gordo_server_phase_seconds": _histogram(predict, 0.02 * predict, phase_buckets,
                                                 {"phase": "predict"}, ["phase"]),
        "gordo_phase_seconds": {
            "type": "histogram", "description": "d", "labelnames": ["plane", "phase"],
            "series": [
                {"labels": {"plane": "server", "phase": "parse"}, "count": predict,
                 "sum": 0.001 * predict, "buckets": {"0.001": predict, "+Inf": predict}},
                {"labels": {"plane": "server", "phase": "device"}, "count": predict,
                 "sum": 0.003 * predict, "buckets": {"0.001": 0, "+Inf": predict}},
            ]},
        "gordo_serve_batch_queue_wait_seconds": _histogram(predict, 0.002 * predict,
                                                           {"0.005": predict, "+Inf": predict}),
        "gordo_serve_batch_requests": _histogram(predict, 1.5 * predict,
                                                 {"1": 0, "2": predict, "+Inf": predict}),
        "gordo_serve_batch_queue_depth": _gauge(1.0),
        "gordo_stream_updates_total": {
            "type": "counter", "description": "d", "labelnames": ["outcome"],
            "series": [{"labels": {"outcome": "ok"}, "value": 9.0},
                       {"labels": {"outcome": "resume_required"}, "value": 1.0}]},
    }, status={"status": status,
               "batching": {"enabled": wait_ms > 0, "batch_wait_ms": wait_ms, "queue_limit": 64,
                            "queue_depth": 1, "sheds_total": 0},
               "streaming": {"sessions": 1, "backlog": backlog}},
        replica_id=rid)


def _router(ok, shed, error, healthy=(1.0, 1.0)):
    return _member("router", {
        "gordo_router_requests_total": {
            "type": "counter", "description": "d", "labelnames": ["outcome"],
            "series": [{"labels": {"outcome": "ok"}, "value": ok},
                       {"labels": {"outcome": "shed"}, "value": shed},
                       {"labels": {"outcome": "error"}, "value": error}]},
        "gordo_router_replica_healthy": {
            "type": "gauge", "description": "d", "labelnames": ["replica"],
            "series": [{"labels": {"replica": f"r{i}"}, "value": v}
                       for i, v in enumerate(healthy)]},
    }, status={"status": "ok", "replicas": {"r0": {"state": "healthy"},
                                            "r1": {"state": "ejected"}}},
        revision=None)


def _planes():
    """(label, members) cases for the merge."""
    lifecycle = _member("lifecycle", {}, status={"last_tick_unix_ms": int(NOW * 1000) - 90_000})
    mismatched = _replica("r1", 30, 12, bounds={"0.02": 6, "1.0": 12, "+Inf": 12})
    kind_clash = _replica("r1", 30, 12)
    kind_clash["metrics"]["gordo_serve_batch_queue_depth"] = _counter(3)
    return [
        ("two-replicas-and-a-router", {"r0": _replica("r0", 40, 20), "r1": _replica("r1", 30, 12),
                                       "__router__": _router(60, 5, 1)}),
        ("lifecycle-member", {"r0": _replica("r0", 4, 2, status="overloaded", backlog=3),
                              "lc": lifecycle}),
        ("bucket-bounds-mismatch", {"r0": _replica("r0", 40, 20), "r1": mismatched}),
        ("kind-mismatch", {"r0": _replica("r0", 40, 20), "r1": kind_clash}),
        ("mixed-batch-waits", {"r0": _replica("r0", 40, 20, wait_ms=5.0),
                               "r1": _replica("r1", 30, 12, wait_ms=0.0)}),
    ]


@pytest.mark.parametrize("label, members", _planes(), ids=[p[0] for p in _planes()])
def test_merge_signals_text_and_status_are_jaxs(label, members):
    got = rollup.merge_snapshots(copy.deepcopy(members), now=NOW)
    want = jax_rollup.merge_snapshots(copy.deepcopy(members), now=NOW)
    assert got == want
    if "mismatch" in label:
        assert got["merge_errors"] and want["merge_errors"]
    got["signals"] = rollup.compute_signals(got, now=NOW + 30)
    want["signals"] = jax_rollup.compute_signals(want, now=NOW + 30)
    assert got["signals"] == want["signals"]
    assert rollup.render_prometheus_text(got["metrics"]) == \
        jax_rollup.render_prometheus_text(want["metrics"])
    assert rollup.plane_status(got) == jax_rollup.plane_status(want)
    assert rollup._plane_uniform_knobs(got) == jax_rollup._plane_uniform_knobs(want)


def test_windowed_signals_between_two_merges_are_jaxs():
    first = {"r0": _replica("r0", 40, 20), "r1": _replica("r1", 30, 12),
             "__router__": _router(60, 5, 1)}
    second = {"r0": _replica("r0", 90, 50), "r1": _replica("r1", 30, 12),
              "__router__": _router(100, 9, 1)}
    signals = []
    for mod in (rollup, jax_rollup):
        previous = mod.merge_snapshots(copy.deepcopy(first), now=NOW)
        current = mod.merge_snapshots(copy.deepcopy(second), now=NOW + 1)
        signals.append(mod.compute_signals(current, previous, now=NOW + 1))
    assert signals[0] == signals[1]
    assert signals[0]["shed_rate"] == pytest.approx(4 / 44)


def test_counter_clamp_across_a_restart_is_jaxs():
    ours, theirs = rollup.CounterClamp(), jax_rollup.CounterClamp()
    # r0 restarts between the second and third polls: its counters fall
    for value in (10.0, 25.0, 3.0, 8.0):
        metrics = {"gordo_server_requests_total": _counter(value, {"route": "fleet"}, ["route"]),
                   "gordo_serve_batch_queue_depth": _gauge(value)}
        mine = ours.adjust("r0", copy.deepcopy(metrics))
        ref = theirs.adjust("r0", copy.deepcopy(metrics))
        assert mine == ref
    assert mine["gordo_server_requests_total"]["series"][0]["value"] == 33.0
    assert registry.get_registry().counter("gordo_rollup_counter_resets_total").value() == 1.0


def test_a_jax_written_and_a_port_written_snapshot_merge():
    """The same serving series written by each package's registry merge
    (equal names and default bounds); a histogram of other bounds is
    refused, never mis-merged."""
    snaps = {}
    for name, reg in (("jax", jax_registry.MetricsRegistry()), ("port", registry.MetricsRegistry())):
        reg.counter("gordo_server_requests_total", "d", ("route",)).inc(3, route="fleet")
        hist = reg.histogram("gordo_server_phase_seconds", "d", ("phase",))
        for v in (0.002, 0.03, 0.4):
            hist.observe(v, phase="predict")
        reg.histogram("gordo_serve_batch_requests", "d",
                      buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256)).observe(2)
        snaps[name] = {"metrics": reg.snapshot()}
    for mod in (rollup, jax_rollup):
        merged = mod.merge_snapshots(copy.deepcopy(snaps), now=NOW)
        assert merged["merge_errors"] == []
        series = merged["metrics"]["gordo_server_phase_seconds"]["series"][0]
        assert series["count"] == 6 and series["buckets"]["+Inf"] == 6
        assert merged["metrics"]["gordo_server_requests_total"]["series"][0]["value"] == 6.0
    other = registry.MetricsRegistry()
    other.histogram("gordo_serve_batch_requests", "d", buckets=(1, 3)).observe(2)
    snaps["odd"] = {"metrics": other.snapshot()}
    got = rollup.merge_snapshots(copy.deepcopy(snaps), now=NOW)
    want = jax_rollup.merge_snapshots(copy.deepcopy(snaps), now=NOW)
    assert got == want
    assert [e["metric"] for e in got["merge_errors"]] == ["gordo_serve_batch_requests"]
    assert "gordo_serve_batch_requests" not in got["metrics"]


def _local(mod, value):
    reg = (registry if mod is rollup else jax_registry).MetricsRegistry()
    reg.counter("gordo_router_requests_total", "d", ("outcome",)).inc(value, outcome="ok")
    hist = reg.histogram("gordo_serve_batch_queue_wait_seconds", "d")
    for v in (0.001, 0.002, 0.004):
        hist.observe(v)
    return mod.snapshot_payload(
        role="replica", replica_id="r0", registry=reg, started_at=NOW - 5, now=NOW,
        status={"status": "ok", "batching": {"batch_wait_ms": 5.0, "queue_limit": 64}})


def test_the_pollers_persisted_lines_are_jaxs_and_read_as_the_same_corpus(tmp_path):
    lifecycle = rollup.snapshot_payload(role="lifecycle", status={"last_tick_unix_ms": 123},
                                        registry=registry.MetricsRegistry(), now=NOW)
    lc_path = tmp_path / "last_tick.json"
    lc_path.write_text(json.dumps(lifecycle))
    lines = {}
    for mod in (rollup, jax_rollup):
        persist = tmp_path / mod.__name__.split(".")[0] / "plane.jsonl"
        poller = mod.RollupPoller(members=lambda: {"lifecycle": str(lc_path)},
                                  local_members={"r0": lambda mod=mod: _local(mod, 10.0)},
                                  persist_path=str(persist), retention=2)
        for i in range(3):
            poller.poll_once(now=NOW + i)
        lines[mod] = [json.loads(line) for line in persist.read_text().splitlines()]
    assert len(lines[rollup]) == 2
    assert lines[rollup] == lines[jax_rollup]
    assert lines[rollup][-1]["batch_wait_ms"] == 5.0 and lines[rollup][-1]["queue_limit"] == 64
    ours = read_corpus([str(tmp_path / "gordo_tpu_torch" / "plane.jsonl")])
    theirs = jax_read_corpus([str(tmp_path / "gordo_tpu" / "plane.jsonl")])
    assert [(o.knob, o.value, o.metric, o.metric_value, o.context) for o in ours.observations] \
        == [(o.knob, o.value, o.metric, o.metric_value, o.context) for o in theirs.observations]
    assert any(o.knob == "batch_wait_ms" for o in ours.observations)


def test_a_dead_member_is_data_and_no_interval_is_no_thread(tmp_path):
    poller = rollup.RollupPoller(members=lambda: {"gone": str(tmp_path / "missing.json")},
                                 local_members={"r0": lambda: _local(rollup, 1.0)})
    before = threading.active_count()
    poller.start()
    assert threading.active_count() == before and poller._thread is None
    merged = poller.poll_once(now=NOW)
    assert "gone" in merged["poll"]["member_errors"] and set(merged["members"]) == {"r0"}
    assert rollup.plane_status(merged)["poll"]["member_errors"]


# -- SLOs ----------------------------------------------------------------------

SPEC = {"name": "serving", "objectives": [
    {"name": "latency", "signal": "predict_p99_ms", "threshold": 250, "window_s": 60,
     "budget": 0.25},
    {"signal": "unstructured_error_rate", "threshold": 0.01},
    {"signal": "shed_rate", "threshold": 0.05, "budget": 0.5}]}
SPEC_YAML = """\
name: serving
objectives:
  - name: latency
    signal: predict_p99_ms
    threshold: 250        # milliseconds
    window_s: 60
    budget: 0.25
  - signal: unstructured_error_rate
    threshold: 0.01
  - signal: shed_rate
    threshold: 0.05
    budget: 0.5
"""


def _history():
    """Merged snapshots a second apart: one too old for the latency
    window, one with no latency sample, one raw (signals computed from
    its metrics)."""
    base = int(NOW * 1000)
    return [
        {"unix_ms": base - 120_000, "signals": {"predict_p99_ms": 900.0, "shed_rate": 0.0}},
        {"unix_ms": base - 2000, "signals": {"predict_p99_ms": 100.0, "shed_rate": 0.2,
                                             "unstructured_error_rate": 0.0}},
        {"unix_ms": base - 1000, "signals": {"predict_p99_ms": None, "shed_rate": 0.01}},
        {"unix_ms": base, "metrics": {"gordo_router_requests_total": {
            "type": "counter", "labelnames": ["outcome"],
            "series": [{"labels": {"outcome": "ok"}, "value": 95.0},
                       {"labels": {"outcome": "error"}, "value": 5.0}]}}},
    ]


@pytest.mark.parametrize("suffix", ["json", "yaml"])
def test_slo_specs_load_evaluate_and_render_as_jaxs(tmp_path, suffix):
    path = tmp_path / f"spec.{suffix}"
    path.write_text(json.dumps(SPEC) if suffix == "json" else SPEC_YAML)
    spec, jax_spec = slo.load_slo_spec(str(path)), jax_slo.load_slo_spec(str(path))
    assert spec.to_dict() == jax_spec.to_dict()
    report = slo.evaluate(spec, _history())
    jax_report = jax_slo.evaluate(jax_spec, _history())
    assert report.to_dict() == jax_report.to_dict()
    assert not report.ok and report.max_burn_rate == jax_report.max_burn_rate
    assert slo.render_report(report) == jax_slo.render_report(jax_report)
    values = {"predict_p99_ms": 300.0, "shed_rate": 0.0}
    assert slo.evaluate_values(spec, values).to_dict() == \
        jax_slo.evaluate_values(jax_spec, values).to_dict()


@pytest.mark.parametrize("document", [
    {"objectives": [{"signal": "made_up", "threshold": 1}]},
    {"objectives": []},
    {"objectives": [{"signal": "shed_rate"}]},
    ["not", "a", "mapping"],
])
def test_bad_specs_are_refused_as_jax_refuses_them(document):
    with pytest.raises(jax_slo.SloSpecError) as theirs:
        jax_slo.parse_slo_spec(document)
    with pytest.raises(slo.SloSpecError) as ours:
        slo.parse_slo_spec(document)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("history, code", [("passing", 0), ("burning", 1)])
def test_slo_check_exits_as_the_jax_command(tmp_path, capsys, history, code):
    spec = tmp_path / "spec.yaml"
    spec.write_text(SPEC_YAML)
    records = _history()[1:2] if history == "passing" else _history()
    if history == "passing":
        records[0]["signals"]["shed_rate"] = 0.0
    target = tmp_path / "plane.jsonl"
    target.write_text("\n".join(json.dumps(r) for r in records) + "\n{\"torn")
    for as_json in ([], ["--as-json"]):
        assert plane.main(["slo", "check", str(spec), str(target), *as_json]) == code
        ours = capsys.readouterr().out
        result = CliRunner().invoke(jax_gordo, ["slo", "check", str(spec), str(target),
                                                *as_json])
        assert result.exit_code == code
        assert ours == result.output
    with pytest.raises(SystemExit) as usage:
        plane.main(["slo", "check", str(tmp_path / "missing.yaml"), str(target)])
    assert usage.value.code == 2 == CliRunner().invoke(
        jax_gordo, ["slo", "check", str(tmp_path / "missing.yaml"), str(target)]).exit_code


def test_top_renders_the_jax_frame():
    from gordo_tpu.cli.plane import _render_top

    merged = rollup.merge_snapshots(copy.deepcopy(_planes()[0][1]), now=NOW)
    merged["signals"] = rollup.compute_signals(merged, now=NOW)
    merged["merge_errors"] = [{"metric": "gordo_x", "error": "bounds differ"}]
    status = rollup.plane_status(merged)
    assert plane.render_top(status) == _render_top(status)


# -- the router ------------------------------------------------------------------

REPLICA_SNAPSHOTS = {"r0": _replica("r0", 40, 20), "r1": _replica("r1", 30, 12)}


class SnapshotTransport:
    """Replicas that answer only ``/telemetry/snapshot``, with fixed
    payloads; counts the calls."""

    def __init__(self):
        self.calls = []

    def request(self, method, url, body=None, headers=None, timeout=30.0):
        self.calls.append(url)
        rid = url.split("//", 1)[1].split(".", 1)[0]
        return Reply(200, {"content-type": "application/json"},
                     json.dumps(REPLICA_SNAPSHOTS[rid]).encode())


class SnapshotSession:
    """The same replicas for the JAX router's ``requests`` session."""

    class _Response:
        def __init__(self, payload):
            self._payload = payload

        def raise_for_status(self):
            pass

        def json(self):
            return copy.deepcopy(self._payload)

    def get(self, url, timeout=None):
        rid = url.split("//", 1)[1].split(".", 1)[0]
        return self._Response(REPLICA_SNAPSHOTS[rid])

    def close(self):
        pass


REPLICAS = {"r0": "http://r0.test", "r1": "http://r1.test"}


def _strip(value):
    """A body without its clocks: stamps, uptimes and pids, and the JAX
    router's phase-ledger series."""
    if isinstance(value, dict):
        return {k: _strip(v) for k, v in value.items()
                if k not in ("ts", "unix_ms", "uptime_s", "pid", "gordo_phase_seconds")}
    if isinstance(value, list):
        return [_strip(v) for v in value]
    return value


def test_no_poller_means_no_thread_and_no_snapshot_request(tmp_path):
    transport = SnapshotTransport()
    before = {t.name for t in threading.enumerate()}
    router = RouterApp({"REPLICAS": REPLICAS, "COLLECTION_DIR": str(tmp_path),
                        "PROBE_INTERVAL_S": 0, "TRANSPORT": transport})
    try:
        assert {t.name for t in threading.enumerate()} - before == set()
        assert router._rollup is None and transport.calls == []
        router.dispatch("GET", "/healthz")
        assert transport.calls == []
        assert router.dispatch("GET", "/status").status == 200
        assert sorted(transport.calls) == ["http://r0.test/telemetry/snapshot",
                                           "http://r1.test/telemetry/snapshot"]
        assert router._rollup._thread is None
    finally:
        router.close()


def test_a_rollup_interval_runs_a_poller_that_persists(tmp_path):
    persist = tmp_path / "rollup.jsonl"
    router = RouterApp({"REPLICAS": REPLICAS, "COLLECTION_DIR": str(tmp_path),
                        "PROBE_INTERVAL_S": 0, "TRANSPORT": SnapshotTransport(),
                        "ROLLUP_INTERVAL_S": 0.05, "ROLLUP_PERSIST_PATH": str(persist),
                        "ROLLUP_RETENTION": 3})
    try:
        assert router._rollup._thread.is_alive()
        deadline = time.time() + 10
        while time.time() < deadline and (not persist.exists()
                                          or len(persist.read_text().splitlines()) < 3):
            time.sleep(0.05)
        time.sleep(0.2)
        lines = [json.loads(line) for line in persist.read_text().splitlines()]
        assert len(lines) == 3  # trimmed to the retention
        assert set(lines[-1]["members"]) == {"r0", "r1", "__router__"}
        assert lines[-1]["batch_wait_ms"] == 5.0
    finally:
        router.close()
    assert router._rollup is None


def test_the_routers_status_and_metrics_are_the_jax_routers(tmp_path, monkeypatch):
    from gordo_tpu.router.app import RouterApp as JaxRouterApp
    from werkzeug.test import Client

    monkeypatch.setenv("MODEL_COLLECTION_DIR", str(tmp_path))
    ours = RouterApp({"REPLICAS": REPLICAS, "COLLECTION_DIR": str(tmp_path),
                      "PROBE_INTERVAL_S": 0, "TRANSPORT": SnapshotTransport()})
    theirs = JaxRouterApp({"REPLICAS": REPLICAS, "PROBE_INTERVAL_S": 0,
                           "SESSION": SnapshotSession()})
    try:
        jax_client = Client(theirs)
        # /metrics first: a JSON reply adds the JAX router's phase series
        got = ours.dispatch("GET", "/metrics")
        want = jax_client.get("/metrics")
        assert (got.status, want.status_code) == (200, 200)
        strip = [line for line in got.body.decode().splitlines() if "uptime" not in line]
        assert strip == [line for line in want.get_data(as_text=True).splitlines()
                         if "uptime" not in line]
        got = ours.dispatch("GET", "/status")
        want = jax_client.get("/status")
        assert _strip(json.loads(got.body)) == _strip(json.loads(want.get_data()))
        got = ours.dispatch("GET", "/telemetry/snapshot")
        want = jax_client.get("/telemetry/snapshot")
        assert _strip(json.loads(got.body)) == _strip(json.loads(want.get_data()))
        status = json.loads(ours.dispatch("GET", "/status").body)
        assert status["replicas"]["r0"]["health"]["state"] == "healthy"
        assert status["signals"]["replicas_healthy"] == 2.0
    finally:
        ours.close()
        theirs.close()


def test_the_package_exports_the_jax_names_the_port_has():
    import gordo_tpu.observability as jax_observability
    import gordo_tpu.tuning as jax_tuning
    import gordo_tpu_torch.observability as observability
    import gordo_tpu_torch.tuning as tuning

    lacking = {"phase_attribution_block", "split_host_device"}
    assert set(jax_observability.__all__) - set(observability.__all__) == lacking
    assert set(jax_tuning.__all__) <= set(tuning.__all__)
    for name in observability.__all__ + tuning.__all__:
        assert getattr(observability, name, None) is not None or hasattr(tuning, name), name
