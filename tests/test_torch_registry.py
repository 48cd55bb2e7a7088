"""
The port's metrics registry and its Prometheus text against the JAX
package's (``gordo_tpu.observability.registry``, ``prom_bridge`` and
``prometheus_client``'s ``generate_latest``) on the same observations:
equal snapshots, quantiles, statistics and merges, the same exposition
(parsed with ``prometheus_client.parser``), the same request series on
both servers' ``/metrics``, and the batcher's series and the transfer
counter recorded under the JAX names. Exact throughout.
"""

import json
import threading
import time

import numpy as np
import pytest
from prometheus_client import CollectorRegistry, generate_latest
from prometheus_client.parser import text_string_to_metric_families
from werkzeug.test import Client

from gordo_tpu.observability import registry as jax_registry
from gordo_tpu.observability.prom_bridge import export_to_prometheus
from gordo_tpu.parallel import transfer as jax_transfer
from gordo_tpu.server import batching as jax_batching
from gordo_tpu.server import build_app as jax_build_app
from gordo_tpu.server import utils as jax_server_utils
from gordo_tpu_torch.observability import prom_text
from gordo_tpu_torch.observability import registry
from gordo_tpu_torch.parallel import transfer
from gordo_tpu_torch.server import batching
from gordo_tpu_torch.server.app import build_app
from tests.test_torch_fleet_serving import PROJECT, fleet_body, fleet_collections, frame_dict

OBSERVATIONS = {
    "counter": [("counter", "gordo_x_total", ("a",), [(2.0, {"a": "1"}), (1.0, {"a": "2"}),
                                                      (0.5, {"a": "1"})])],
    "gauge": [("gauge", "gordo_depth", (), [("set", 3.0, {}), ("inc", 2.0, {}),
                                            ("dec", 0.5, {}), ("set_max", 1.0, {}),
                                            ("set_max", 9.0, {})])],
    "histogram": [("histogram", "gordo_h_seconds", ("phase",),
                   [(v, {"phase": p}) for v, p in zip(
                       [0.0004, 0.001, 0.3, 7.0, 1000.0, 0.02, 5.0], "aabbaab")])],
    "buckets": [("histogram", "gordo_batch", (), [(v, {}) for v in (1, 3, 3, 9, 300)],
                 (1, 2, 4, 8, 16, 32, 64, 128, 256))],
    "removed": [("counter", "gordo_r_total", ("replica",),
                 [(1.0, {"replica": "r0"}), (1.0, {"replica": "r1"}),
                  ("remove", {"replica": "r0"})])],
}


def _record(reg, spec):
    kind, name, labels, ops, *buckets = spec
    if kind == "counter":
        metric = reg.counter(name, f"{name} help", labels)
    elif kind == "gauge":
        metric = reg.gauge(name, f"{name} help", labels)
    else:
        metric = reg.histogram(name, f"{name} help", labels,
                               buckets=buckets[0] if buckets else None)
    for op in ops:
        if op[0] == "remove":
            metric.remove(**op[1])
        elif kind == "gauge":
            getattr(metric, op[0])(op[1], **op[2])
        elif kind == "counter":
            metric.inc(op[0], **op[1])
        else:
            metric.observe(op[0], **op[1])


def _pair(specs):
    jax_reg, port_reg = jax_registry.MetricsRegistry(), registry.MetricsRegistry()
    for spec in specs:
        _record(jax_reg, spec)
        _record(port_reg, spec)
    return jax_reg, port_reg


@pytest.mark.parametrize("case", list(OBSERVATIONS))
def test_snapshots_are_equal(case):
    jax_reg, port_reg = _pair(OBSERVATIONS[case])
    assert port_reg.snapshot() == jax_reg.snapshot()
    assert registry.DEFAULT_BUCKETS == jax_registry.DEFAULT_BUCKETS


def test_registration_errors_match():
    for reg in (jax_registry.MetricsRegistry(), registry.MetricsRegistry()):
        reg.counter("gordo_a_total", "", ("x",))
        with pytest.raises(ValueError, match="already registered"):
            reg.gauge("gordo_a_total", "", ("x",))
        with pytest.raises(ValueError, match="takes labels"):
            reg.counter("gordo_a_total", "", ("x",)).inc(y="1")
        with pytest.raises(ValueError, match="Invalid metric name"):
            reg.counter("Bad-Name")


@pytest.mark.parametrize("stat", ["mean", "count", "sum", "p50", "p90", "p99", "p99.9", "p0",
                                  "p101", "pxx", "median"])
def test_quantiles_and_stats_match(stat):
    jax_reg, port_reg = _pair(OBSERVATIONS["histogram"] + OBSERVATIONS["buckets"])
    for name in ("gordo_h_seconds", "gordo_batch"):
        want = jax_registry.histogram_state(jax_reg.snapshot()[name])
        got = registry.histogram_state(port_reg.snapshot()[name])
        assert got == want
        assert registry.histogram_stat(got, stat) == jax_registry.histogram_stat(want, stat)
        for q in (0.1, 0.5, 0.95, 1.0):
            assert registry.histogram_quantile(got, q) == jax_registry.histogram_quantile(want, q)


def test_merges_match_and_refuse_mismatched_buckets():
    jax_reg, port_reg = _pair(OBSERVATIONS["histogram"])
    other_jax, other_port = _pair([("histogram", "gordo_h_seconds", ("phase",),
                                    [(0.2, {"phase": "a"}), (40.0, {"phase": "a"})])])
    states = [registry.histogram_state(r.snapshot()["gordo_h_seconds"])
              for r in (port_reg, other_port)]
    want = jax_registry.merge_histogram_states(
        *[jax_registry.histogram_state(r.snapshot()["gordo_h_seconds"])
          for r in (jax_reg, other_jax)])
    assert registry.merge_histogram_states(*states) == want
    _, odd = _pair(OBSERVATIONS["buckets"])
    with pytest.raises(registry.HistogramMergeError):
        registry.merge_histogram_states(states[0], registry.histogram_state(
            odd.snapshot()["gordo_batch"]))


def _families(text):
    return {
        family.name: (family.type, family.documentation,
                      sorted((s.name, tuple(sorted(s.labels.items())), s.value)
                             for s in family.samples))
        for family in text_string_to_metric_families(text)
    }


def test_exposition_matches_prometheus_client():
    specs = [spec for specs in OBSERVATIONS.values() for spec in specs]
    jax_reg, port_reg = _pair(specs)
    port_reg.counter("gordo_empty_total", "no series yet", ("k",))
    jax_reg.counter("gordo_empty_total", "no series yet", ("k",))
    prom = CollectorRegistry(auto_describe=True)
    export_to_prometheus(jax_reg, prom)
    want = generate_latest(prom).decode()
    got = prom_text.registry_text(port_reg.snapshot())
    assert _families(got) == _families(want)
    assert got == want
    # the port's own reader agrees with prometheus_client's
    parsed = prom_text.parse_samples(got)
    for family in text_string_to_metric_families(want):
        for sample in family.samples:
            key = (sample.name, tuple(sorted(sample.labels.items())))
            assert parsed[key] == sample.value


def test_format_value_spells_numbers_as_prometheus_client():
    from prometheus_client.utils import floatToGoString

    for value in (0.0, 1.0, -2.5, 1e-9, 12345678.9, 1e22, float("inf"), float("-inf"), 0.001):
        assert prom_text.format_value(value) == floatToGoString(value)
    assert prom_text.format_value(float("nan")) == "NaN"


def _served(jax_dir, port_dir, monkeypatch):
    monkeypatch.setenv("MODEL_COLLECTION_DIR", str(jax_dir))
    monkeypatch.delenv("GORDO_BATCH_WAIT_MS", raising=False)
    monkeypatch.delenv("GORDO_TPU_TRACE_LOG", raising=False)
    jax_server_utils.clear_caches()
    jax_app = jax_build_app({"ENABLE_PROMETHEUS": True}, prometheus_registry=CollectorRegistry())
    port_app = build_app(str(port_dir), device="cpu", enable_prometheus=True)
    return Client(jax_app), Client(port_app)


def _request_series(text):
    out = {}
    for family in text_string_to_metric_families(text):
        for sample in family.samples:
            if sample.name in ("gordo_server_requests_total",
                               "gordo_server_request_duration_seconds_count"):
                out[(sample.name, tuple(sorted(sample.labels.items())))] = sample.value
    return out


def test_metrics_route_counts_the_requests_as_the_jax_server(tmp_path, monkeypatch):
    jax_dir, port_dir = fleet_collections(tmp_path)
    clients = _served(jax_dir, port_dir, monkeypatch)
    body = {"X": frame_dict(20, ["GRA-PUMP-FLOW 1", "GRA-PUMP-TEMP 2", "GRA-PUMP-PRES 3",
                                 "GRA-PUMP-VIB 4"], 3)}
    for client in clients:
        client.get(f"/gordo/v0/{PROJECT}/models")
        client.get(f"/gordo/v0/{PROJECT}/models")
        client.post(f"/gordo/v0/{PROJECT}/pump-ff-0/prediction", json=body)
        client.post(f"/gordo/v0/{PROJECT}/anomaly/prediction/fleet",
                    json=fleet_body(["turbine-tf-0", "turbine-tf-1"], anomaly=True))
        client.get(f"/gordo/v0/{PROJECT}/no-such/metadata")
        client.get("/healthz")  # probes and scrapes are not counted
        client.get("/metrics")
    jax_text, port_text = (c.get("/metrics").get_data(as_text=True) for c in clients)
    want, got = _request_series(jax_text), _request_series(port_text)
    assert want and got == want
    assert ('gordo_server_info{version="' in port_text and "gordo_server_info" in jax_text)
    # a plain server answers /metrics with 404, as the JAX one does
    plain = build_app(str(port_dir), device="cpu", enable_prometheus=False)
    assert Client(plain).get("/metrics").status_code == 404


def test_metrics_setting_comes_from_the_environment(tmp_path, monkeypatch):
    _, port_dir = fleet_collections(tmp_path)
    monkeypatch.setenv("ENABLE_PROMETHEUS", "true")
    client = Client(build_app(str(port_dir), device="cpu"))
    reply = client.get("/metrics")
    assert reply.status_code == 200
    assert reply.headers["Content-Type"] == prom_text.CONTENT_TYPE
    monkeypatch.setenv("ENABLE_PROMETHEUS", "0")
    assert Client(build_app(str(port_dir), device="cpu")).get("/metrics").status_code == 404


class _Scorer:
    """A scorer whose dispatch waits for a gate, so requests queue."""

    def __init__(self):
        self.gate = threading.Event()
        self.entered = threading.Event()

    def predict_requests(self, requests):
        self.entered.set()
        self.gate.wait(timeout=10)
        return [{name: np.zeros((1, 1), np.float32) for name in inputs} for inputs in requests]


def _series(snapshot, name):
    return {tuple(sorted(s["labels"].items())): s for s in snapshot.get(name, {}).get("series", [])}


def _delta(before, after, name, field):
    b, a = _series(before, name), _series(after, name)
    return {key: a[key][field] - (b[key][field] if key in b else 0) for key in a}


def _wait_for(condition):
    deadline = time.monotonic() + 10
    while not condition() and time.monotonic() < deadline:
        time.sleep(0.005)
    assert condition()


def _drive(batcher_cls, full_cls, reg):
    """A request in dispatch, one queued behind it, one shed, against a
    gated batcher of queue limit 1."""
    before = reg.snapshot()
    scorer = _Scorer()
    batcher = batcher_cls(scorer, wait_s=10.0, queue_limit=1)
    first = threading.Thread(target=batcher.submit, args=({"m0": None},), daemon=True)
    first.start()
    _wait_for(scorer.entered.is_set)
    second = threading.Thread(target=batcher.submit, args=({"m1": None},), daemon=True)
    second.start()
    _wait_for(lambda: batcher.stats()["queue_depth"] == 1)
    with pytest.raises(full_cls):
        batcher.submit({"m9": None})
    scorer.gate.set()
    for thread in (first, second):
        thread.join(timeout=10)
    batcher.stop(join=True)
    after = reg.snapshot()
    return {
        "requests": _delta(before, after, "gordo_serve_batch_requests", "count"),
        "queue_wait": _delta(before, after, "gordo_serve_batch_queue_wait_seconds", "count"),
        "dispatch": _delta(before, after, "gordo_serve_batch_dispatch_seconds", "count"),
        "shed": _delta(before, after, "gordo_serve_batch_shed_total", "value"),
        "depth": after["gordo_serve_batch_queue_depth"]["series"][0]["value"],
        "kinds": {name: after[name]["type"] for name in after
                  if name.startswith("gordo_serve_batch")},
    }


def test_batcher_series_match_the_jax_batcher(monkeypatch):
    monkeypatch.delenv("GORDO_TPU_TRACE_LOG", raising=False)
    monkeypatch.delenv("GORDO_FAULT_INJECT", raising=False)
    want = _drive(jax_batching.RequestBatcher, jax_batching.BatchQueueFull,
                  jax_registry.get_registry())
    got = _drive(batching.RequestBatcher, batching.BatchQueueFull, registry.get_registry())
    assert got == want
    assert got["requests"] == {(): 2} and got["shed"] == {(): 1.0}


def test_transfer_counter_matches_the_jax_counter():
    def counted(count, reg):
        before = reg.snapshot()
        count("stream", "direct", 3)
        count("train", "prefetched", 2)
        count("train", "prefetched", 0)
        return _delta(before, reg.snapshot(), "gordo_transfer_chunks_total", "value")

    want = counted(jax_transfer.count_transfer, jax_registry.get_registry())
    got = counted(transfer.count_transfer, registry.get_registry())
    assert got == want == {(("mode", "direct"), ("plane", "stream")): 3.0,
                           (("mode", "prefetched"), ("plane", "train")): 2.0}
    assert json.dumps(registry.get_registry().snapshot()["gordo_transfer_chunks_total"]
                      ["description"]) == json.dumps(jax_registry.get_registry().snapshot()
                                                     ["gordo_transfer_chunks_total"]["description"])
