"""
Dynamic batching on the port's server (``gordo_tpu_torch.server.
batching`` and the catalog's batchers), the counterparts of
tests/test_batching.py: concurrent fleet requests coalesce into one
``predict_requests`` call, a lone request goes at the wait cap,
admission control sheds with a 503 and ``Retry-After``, a stopped
batcher refuses, a failing request fails only its own future, batching
off builds no batcher, and coalesced replies are bitwise equal to
unbatched ones on the CPU (as the JAX test pins them; one torch thread).
"""

import json
import threading
import time

import numpy as np
import pytest
import torch
from werkzeug.test import Client

from gordo_tpu_torch.models import AutoEncoder, TransformerAutoEncoder
from gordo_tpu_torch.server import batching, fleet_serving
from gordo_tpu_torch.server.app import build_app
from gordo_tpu_torch.server.batching import BatchQueueFull, BatcherStopped, RequestBatcher
from gordo_tpu_torch.server.catalog import ServingCatalog
from gordo_tpu_torch.server.fleet_serving import FleetScorer
from tests.test_torch_fleet_serving import (
    PROJECT,
    PUMPS,
    TURBINES,
    fleet_body,
    fleet_collections,
)

torch.set_num_threads(1)
FLEET_URL = f"/gordo/v0/{PROJECT}/prediction/fleet"
ANOMALY_URL = f"/gordo/v0/{PROJECT}/anomaly/prediction/fleet"


class StubScorer:
    """A ``predict_requests`` stand-in recording every call."""

    def __init__(self, block=None, fail_names=()):
        self.calls = []
        self.block = block
        self.fail_names = set(fail_names)
        self._lock = threading.Lock()

    def predict_requests(self, requests):
        with self._lock:
            self.calls.append([dict(r) for r in requests])
        if self.block is not None:
            self.block.wait()
        for inputs in requests:
            bad = self.fail_names & set(inputs)
            if bad:
                raise ValueError(f"failing machines: {sorted(bad)}")
        return [{name: np.asarray(x) * 2.0 for name, x in inputs.items()} for inputs in requests]


def _submit_all(batcher, payloads):
    """Each payload submitted from its own thread: (results, errors)."""
    results, errors = [None] * len(payloads), [None] * len(payloads)

    def run(i):
        try:
            results[i] = batcher.submit(payloads[i])
        except BaseException as exc:  # noqa: BLE001 - recorded for the asserts
            errors[i] = exc

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(payloads))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return results, errors


# -- RequestBatcher ------------------------------------------------------------


def test_concurrent_submissions_coalesce_into_one_dispatch():
    scorer = StubScorer()
    batcher = RequestBatcher(scorer, wait_s=5.0, queue_limit=2)
    try:
        a = {"m0": np.ones((4, 3), dtype=np.float32)}
        b = {"m1": np.full((4, 3), 3.0, dtype=np.float32)}
        results, errors = _submit_all(batcher, [a, b])
        assert errors == [None, None]
        # full at queue_limit before the 5 s cap: one call
        assert len(scorer.calls) == 1 and len(scorer.calls[0]) == 2
        np.testing.assert_array_equal(results[0].outputs["m0"], a["m0"] * 2)
        np.testing.assert_array_equal(results[1].outputs["m1"], b["m1"] * 2)
        assert results[0].n_coalesced == 2 and results[0].queue_wait_s >= 0.0
        stats = batcher.stats()
        assert (stats["dispatches_total"], stats["requests_total"], stats["mean_batch_size"]) == (
            1, 2, 2.0)
    finally:
        batcher.stop(join=True)


def test_lone_request_dispatches_at_the_wait_cap():
    scorer = StubScorer()
    batcher = RequestBatcher(scorer, wait_s=0.05, queue_limit=8)
    try:
        start = time.perf_counter()
        pending = batcher.submit({"m0": np.ones((2, 2), dtype=np.float32)})
        elapsed = time.perf_counter() - start
        assert scorer.calls == [[pending.inputs]]
        assert 0.04 <= elapsed < 2.0
        assert pending.n_coalesced == 1
    finally:
        batcher.stop(join=True)


def test_admission_control_sheds_past_queue_limit():
    gate = threading.Event()
    scorer = StubScorer(block=gate)
    batcher = RequestBatcher(scorer, wait_s=10.0, queue_limit=2)
    try:
        results = {}

        def run(i):
            try:
                results[i] = batcher.submit({f"m{i}": np.ones((2, 2), dtype=np.float32)})
            except BaseException as exc:  # noqa: BLE001
                results[i] = exc

        threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
        for t in threads[:2]:  # a full batch, held at the gate
            t.start()
        deadline = time.monotonic() + 5
        while not scorer.calls and time.monotonic() < deadline:
            time.sleep(0.01)
        for t in threads[2:]:  # two more fill the queue again
            t.start()
        while batcher.stats()["queue_depth"] < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        with pytest.raises(BatchQueueFull) as shed:
            batcher.submit({"m9": np.ones((2, 2), dtype=np.float32)})
        assert (shed.value.queue_depth, shed.value.queue_limit) == (2, 2)
        assert shed.value.retry_after_s >= 1
        stats = batcher.stats()
        assert stats["saturated"] and stats["shedding"] and stats["sheds_total"] == 1
        gate.set()
        for t in threads:
            t.join()
        assert all(not isinstance(r, BaseException) for r in results.values())
    finally:
        gate.set()
        batcher.stop(join=True)


def test_submit_after_stop_raises_batcher_stopped():
    batcher = RequestBatcher(StubScorer(), wait_s=0.0, queue_limit=2)
    batcher.stop(join=True)
    assert batcher.stopped
    with pytest.raises(BatcherStopped):
        batcher.submit({"m0": np.ones((2, 2), dtype=np.float32)})


def test_mid_batch_failure_poisons_only_the_culprit():
    scorer = StubScorer(fail_names=("bad",))
    batcher = RequestBatcher(scorer, wait_s=5.0, queue_limit=2)
    try:
        good = {"m0": np.ones((2, 2), dtype=np.float32)}
        bad = {"bad": np.ones((2, 2), dtype=np.float32)}
        results, errors = _submit_all(batcher, [good, bad])
        assert errors[0] is None
        np.testing.assert_array_equal(results[0].outputs["m0"], good["m0"] * 2)
        assert isinstance(errors[1], ValueError)
        # one coalesced try, then one alone each
        assert len(scorer.calls) == 3
    finally:
        batcher.stop(join=True)


def test_catalog_rebuilds_a_stale_batcher_and_stops_evicted_ones():
    catalog = ServingCatalog(scorer_cache_size=2, batch_wait_s=0.01, batch_queue_limit=4,
                             device="cpu")
    first, other = StubScorer(), StubScorer()
    a = catalog.batcher(("rev", ("a",)), first)
    assert catalog.batcher(("rev", ("a",)), first) is a
    rebuilt = catalog.batcher(("rev", ("a",)), other)  # the key's scorer changed
    assert rebuilt is not a and a.stopped
    b = catalog.batcher(("rev", ("b",)), first)
    catalog.batcher(("rev", ("c",)), first)  # over the bound: the oldest goes
    assert rebuilt.stopped and not b.stopped
    assert len(catalog.batcher_stats()) == 2
    catalog.stop()


# -- FleetScorer coalescing ------------------------------------------------------


def _scorer(family, n_machines=3, rows=60):
    rng = np.random.default_rng(5)
    estimators = {}
    for i in range(n_machines):
        if family == "feedforward":
            X = rng.random((rows, 4)).astype("float32")
            est = AutoEncoder("feedforward_hourglass", epochs=1, seed=i)
        else:
            X = rng.random((rows, 3)).astype("float32")
            est = TransformerAutoEncoder("transformer_model", lookback_window=8, d_model=16,
                                         n_heads=2, n_layers=1, epochs=1, seed=i,
                                         attention_impl="flash")
        estimators[f"m{i}"] = est.fit(X, X.copy(), device="cpu")
    return FleetScorer(estimators), rng, X.shape[1]


@pytest.mark.parametrize("family", ["feedforward", "transformer"])
def test_predict_requests_bitwise_matches_solo_predict(family):
    """The same bits a solo request gets, with a machine named twice
    (gathered rows) and row counts in another power-of-two bucket."""
    scorer, rng, f = _scorer(family)
    req_a = {name: rng.random((40, f)).astype("float32") for name in ("m0", "m1", "m2")}
    req_b = {"m0": rng.random((17, f)).astype("float32"),
             "m2": rng.random((40, f)).astype("float32")}
    solo_a, solo_b = scorer.predict(req_a), scorer.predict(req_b)
    coalesced = scorer.predict_requests([req_a, req_b])
    for name in req_a:
        np.testing.assert_array_equal(coalesced[0][name], solo_a[name])
    for name in req_b:
        np.testing.assert_array_equal(coalesced[1][name], solo_b[name])


def test_predict_requests_chunks_oversized_batches_bit_identically(monkeypatch):
    scorer, rng, f = _scorer("feedforward", n_machines=1)
    monkeypatch.setattr(fleet_serving, "MIN_DISPATCH_ENTRIES", 2)
    reqs = [{"m0": rng.random((20, f)).astype("float32")} for _ in range(5)]
    solo = [scorer.predict(r) for r in reqs]
    for expect, got in zip(solo, scorer.predict_requests(reqs)):
        np.testing.assert_array_equal(got["m0"], expect["m0"])


# -- through the server ------------------------------------------------------------


@pytest.fixture(scope="module")
def port_collection(tmp_path_factory):
    return fleet_collections(tmp_path_factory.mktemp("batching"))[1]


@pytest.fixture
def batching_app(port_collection, monkeypatch):
    """The port's app with batching on: a 50 ms cap, two to a batch."""
    monkeypatch.delenv("GORDO_BATCH_WAIT_MS", raising=False)
    app = build_app(str(port_collection), device="cpu", batch_wait_ms=50.0, batch_queue_limit=2)
    yield app
    app.catalog.stop()


def _concurrent_posts(app, url, bodies):
    responses = {}

    def post(key, body):
        responses[key] = Client(app).post(url, json=body)

    threads = [threading.Thread(target=post, args=item) for item in bodies.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return responses


def test_settings_come_from_the_environment(port_collection, monkeypatch):
    monkeypatch.setenv("GORDO_BATCH_WAIT_MS", "7.5")
    monkeypatch.setenv("GORDO_BATCH_QUEUE_LIMIT", "3")
    monkeypatch.setenv("GORDO_SCORER_CACHE_SIZE", "5")
    app = build_app(str(port_collection), device="cpu")
    assert (app.catalog.batch_wait_s, app.catalog.batch_queue_limit,
            app.catalog.scorer_cache_size) == (0.0075, 3, 5)
    app = build_app(str(port_collection), device="cpu", batch_wait_ms=0, batch_queue_limit=9)
    assert (app.catalog.batch_wait_s, app.catalog.batch_queue_limit) == (0.0, 9)


def test_batching_disabled_is_strict_pass_through(port_collection, monkeypatch):
    def explode(*args, **kwargs):
        raise AssertionError("RequestBatcher constructed on the disabled path")

    monkeypatch.delenv("GORDO_BATCH_WAIT_MS", raising=False)
    monkeypatch.setattr(batching, "RequestBatcher", explode)
    app = build_app(str(port_collection), device="cpu")
    reply = Client(app).post(FLEET_URL, json=fleet_body(PUMPS, anomaly=False))
    assert reply.status_code == 200, reply.get_data()
    assert app.catalog.batcher_stats() == []


@pytest.mark.parametrize("url,names", [(FLEET_URL, PUMPS + TURBINES), (ANOMALY_URL, TURBINES)])
def test_batched_replies_bitwise_equal_unbatched(batching_app, port_collection, url, names):
    """Two concurrent fleet requests coalesced into one call give the
    bytes the unbatched server gives."""
    anomaly = url == ANOMALY_URL
    body_a = fleet_body(names, anomaly, seed=51)
    body_b = fleet_body(names, anomaly, seed=61, n_rows=33)
    plain = Client(build_app(str(port_collection), device="cpu", batch_wait_ms=0))
    expect = {key: json.loads(plain.post(url, json=body).get_data())["data"]
              for key, body in (("a", body_a), ("b", body_b))}
    # one request first, so the scorer and batcher exist; then a long cap
    assert Client(batching_app).post(url, json=body_a).status_code == 200
    (batcher,) = batching_app.catalog._batchers.values()
    batcher.wait_s = 2.0
    base = batcher.stats()
    replies = _concurrent_posts(batching_app, url, {"a": body_a, "b": body_b})
    stats = batcher.stats()
    assert stats["dispatches_total"] == base["dispatches_total"] + 1
    assert stats["requests_total"] == base["requests_total"] + 2
    for key in ("a", "b"):
        assert replies[key].status_code == 200, replies[key].get_data()
        assert json.loads(replies[key].get_data())["data"] == expect[key]


def test_queue_full_is_a_structured_503_with_retry_after(batching_app, monkeypatch):
    def shed(self, inputs, trace_id=""):
        raise BatchQueueFull(3, 2, 2)

    monkeypatch.setattr(RequestBatcher, "submit", shed)
    reply = Client(batching_app).post(FLEET_URL, json=fleet_body(PUMPS[:1], anomaly=False))
    assert reply.status_code == 503
    assert reply.headers["Retry-After"] == "3"
    payload = json.loads(reply.get_data())
    assert payload["error"].startswith("Batching queue full (2/2 waiting)")
    assert (payload["queue_depth"], payload["queue_limit"], payload["retry_after_s"]) == (2, 2, 3)


def test_healthz_ok_when_idle(port_collection, monkeypatch):
    monkeypatch.delenv("GORDO_BATCH_WAIT_MS", raising=False)
    reply = Client(build_app(str(port_collection), device="cpu")).get("/healthz")
    assert reply.status_code == 200
    payload = json.loads(reply.get_data())
    assert payload["status"] == "ok"
    assert payload["batching"]["enabled"] is False and payload["batching"]["queue_depth"] == 0
    assert payload["streaming"]["sessions"] == 0


def test_healthz_reports_saturation_as_503(batching_app):
    class Saturated:
        def stats(self):
            return {"queue_depth": 2, "queue_limit": 2, "saturated": True, "sheds_total": 5,
                    "shedding": True, "dispatches_total": 7, "requests_total": 9,
                    "mean_batch_size": 1.3, "retry_after_s": 2}

        def stop(self, join=False):
            pass

    batching_app.catalog._batchers[("fake", ("m",))] = Saturated()
    reply = Client(batching_app).get("/healthz")
    assert reply.status_code == 503
    assert reply.headers["Retry-After"] == "2"
    payload = json.loads(reply.get_data())
    assert payload["status"] == "overloaded"
    assert payload["batching"]["enabled"] is True and payload["batching"]["batch_wait_ms"] == 50.0
    assert (payload["batching"]["queue_depth"], payload["batching"]["sheds_total"]) == (2, 5)
    assert payload["batching"]["shedding"] is True


def test_healthz_body_has_the_jax_servers_keys(port_collection, monkeypatch):
    from gordo_tpu.server import build_app as jax_build_app
    from gordo_tpu.server import utils as jax_server_utils

    monkeypatch.setenv("MODEL_COLLECTION_DIR", str(port_collection))
    monkeypatch.delenv("GORDO_BATCH_WAIT_MS", raising=False)
    jax_server_utils.clear_caches()
    want = json.loads(Client(jax_build_app()).get("/healthz").get_data())
    got = json.loads(Client(build_app(str(port_collection), device="cpu")).get("/healthz")
                     .get_data())
    jax_server_utils.clear_caches()
    assert got == want
