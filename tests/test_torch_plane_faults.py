"""
The serving plane's fault sites and emitters against the JAX package's
on the CPU, over the shard collection of ``tests/test_torch_shard.py``:

- ``serve:raise`` on each prediction route: the JAX server's status and
  body, on the named machine only;
- ``batch:raise``: only the named request of a coalesced batch fails, the
  others score as unbatched (no poisoned batch); a lone one answers as
  JAX's;
- the router's ``replica`` seam with a dying replica: the same replies,
  and the same ``fault_injected``, ``replica_ejected``, ``shard_failover``,
  ``replica_recovered`` and ``router_membership_changed`` events (names
  and fields, apart from time, pid and ids), and a hedge's spans;
- the fleet scorer's ``gordo_serve_*``, the streams' ``gordo_stream_*``
  and the router plane's ``gordo_phase_seconds`` series: names, label
  sets and counts after the same requests.
"""

import os
import shutil
import threading
import time

import numpy as np
import pytest
import torch
from werkzeug.test import Client

from gordo_tpu.observability import get_registry as jax_get_registry
from gordo_tpu.robustness import faults as jax_faults
from gordo_tpu.server import build_app as jax_build_app
from gordo_tpu.server import utils as jax_server_utils
from gordo_tpu_torch.observability import read_events, tracing
from gordo_tpu_torch.observability.registry import get_registry
from gordo_tpu_torch.robustness import faults
from gordo_tpu_torch.server.app import build_app
from tests.test_torch_fleet_serving import PROJECT, fleet_body
from tests.test_torch_router import (  # noqa: F401 - fixtures
    FLEET,
    RING,
    SHARDS,
    VICTIM,
    _single_body,
    jax_call,
    jax_plane,
    manifest,
    plane,
    single_call,
)
from tests.test_torch_shard import PUMPS, TURBINES, collections  # noqa: F401

torch.set_num_threads(1)

#: event fields that differ between any two runs
VOLATILE = {"ts", "unix_ms", "pid", "trace_id", "span_id", "backoff_s"}
ROUTES = [("prediction", False, False), ("anomaly/prediction", True, False),
          ("prediction/fleet", False, True), ("anomaly/prediction/fleet", True, True)]


@pytest.fixture(autouse=True)
def _no_faults(monkeypatch):
    for var in (faults.FAULT_INJECT_ENV_VAR, faults.FAULT_INJECT_FILE_ENV_VAR,
                "GORDO_BATCH_WAIT_MS", "GORDO_TPU_EVENT_LOG", tracing.TRACE_LOG_ENV_VAR):
        monkeypatch.delenv(var, raising=False)
    faults.reset()
    jax_faults.reset()
    yield
    faults.reset()
    jax_faults.reset()


def _arm(monkeypatch, spec):
    monkeypatch.setenv(faults.FAULT_INJECT_ENV_VAR, spec)
    faults.reset()
    jax_faults.reset()


def _jax_app(collections, monkeypatch, **env):  # noqa: F811
    monkeypatch.setenv("MODEL_COLLECTION_DIR", str(collections[0]))
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    jax_server_utils.clear_caches()
    return Client(jax_build_app())


def _request(name, route, anomaly, fleet):
    if fleet:
        return f"/gordo/v0/{PROJECT}/{route}", fleet_body([name], anomaly)
    return f"/gordo/v0/{PROJECT}/{name}/{route}", _single_body(name, anomaly)


@pytest.mark.parametrize("route,anomaly,fleet", ROUTES)
def test_serve_fault_answers_as_the_jax_server(  # noqa: F811
        collections, monkeypatch, route, anomaly, fleet):
    victim, other = TURBINES[0], TURBINES[1]
    _arm(monkeypatch, f"serve:raise:{victim}")
    port = build_app(str(collections[1]), device="cpu", batch_wait_ms=0)
    jax = _jax_app(collections, monkeypatch)
    for name, status in ((victim, 503), (other, 200), (victim, 503)):
        path, body = _request(name, route, anomaly, fleet)
        got = single_call(port, "POST", path, body)
        want = jax_call(jax, "POST", path, body)[:2]
        assert got[0] == want[0] == status
        if status == 503:
            assert got[1] == want[1]
            assert got[1]["error"].startswith("Fault injection: Injected fault at site 'serve'")


def test_a_batch_fault_fails_only_its_request(collections, monkeypatch):  # noqa: F811
    """Four concurrent requests coalesce in one batch; the one naming the
    armed machine answers the fault's 503, the others score bitwise as
    without batching, and a lone faulted request answers as JAX's."""
    names = [*PUMPS, TURBINES[0]]
    _arm(monkeypatch, f"batch:raise:{PUMPS[0]}")
    batched = build_app(str(collections[1]), device="cpu", batch_wait_ms=300)
    unbatched = build_app(str(collections[1]), device="cpu", batch_wait_ms=0)
    bodies = {name: fleet_body([name], False, seed=7) for name in names}
    # the revision's scorer and batcher exist before the burst
    assert single_call(batched, "POST", FLEET, bodies[PUMPS[1]])[0] == 200
    replies, barrier = {}, threading.Barrier(len(names))

    def post(name):
        barrier.wait()
        replies[name] = single_call(batched, "POST", FLEET, bodies[name])

    threads = [threading.Thread(target=post, args=(name,)) for name in names]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(timeout=60)
    assert replies[PUMPS[0]][0] == 503
    assert "Injected fault at site 'batch'" in replies[PUMPS[0]][1]["error"]
    for name in names[1:]:
        assert replies[name][0] == 200
        assert replies[name][1]["data"] == single_call(unbatched, "POST", FLEET,
                                                       bodies[name])[1]["data"]
    stats = [b.stats() for b in batched.catalog._batchers.values()]
    assert sum(s["dispatches_total"] for s in stats) == 2
    assert sum(s["requests_total"] for s in stats) == 1 + len(names)

    faults.reset()
    jax_faults.reset()
    lone = build_app(str(collections[1]), device="cpu", batch_wait_ms=5)
    jax = _jax_app(collections, monkeypatch, GORDO_BATCH_WAIT_MS="5")
    got = single_call(lone, "POST", FLEET, bodies[PUMPS[0]])
    want = jax_call(jax, "POST", FLEET, bodies[PUMPS[0]])[:2]
    assert got == want and got[0] == 503


def _story(call, set_replicas, wait):
    """A replica dies for one call under ``replica:die@attempts:1``: its
    shard's request answers the transient 409 and ejects it; the next is
    failed over to the successor; after the window the owner serves again
    (recovered); then the membership drops r2."""
    body = fleet_body(SHARDS[VICTIM], anomaly=False)
    statuses = [call(body)[0], call(body)[0]]
    wait(0.6)
    statuses.append(call(body)[0])
    statuses.append(set_replicas()[0])
    return statuses


def _events(path, keep):
    return [{k: v for k, v in record.items() if k not in VOLATILE}
            for record in read_events(str(path)) if record["event"] in keep]


def test_router_fault_events_equal_jax(plane, jax_plane, monkeypatch, tmp_path):  # noqa: F811
    keep = {"fault_injected", "replica_ejected", "shard_failover", "replica_recovered",
            "router_membership_changed"}
    config = dict(EJECT_AFTER=1, PROBE_INTERVAL_S=0.0, BACKOFF_SCALE=0.05)
    p = plane(**config)
    jp = jax_plane(**config)
    _arm(monkeypatch, f"replica:die:{VICTIM}@attempts:1")
    monkeypatch.setenv("GORDO_TPU_EVENT_LOG", str(tmp_path / "port.jsonl"))
    got = _story(lambda body: p.call("POST", FLEET, body), lambda: p.call(
        "POST", "/router/replicas", {"replicas": {r: p.urls[r] for r in ("r0", "r1")}}),
        time.sleep)
    _arm(monkeypatch, f"replica:die:{VICTIM}@attempts:1")
    monkeypatch.setenv("GORDO_TPU_EVENT_LOG", str(tmp_path / "jax.jsonl"))
    want = _story(lambda body: jax_call(jp.client, "POST", FLEET, body), lambda: jax_call(
        jp.client, "POST", "/router/replicas",
        {"replicas": {"r0": "http://r0.test", "r1": "http://r1.test"}}), time.sleep)
    assert got == want == [409, 200, 200, 200]
    port_events = _events(tmp_path / "port.jsonl", keep)
    jax_events = _events(tmp_path / "jax.jsonl", keep)
    assert port_events == jax_events
    kinds = [e["event"] for e in port_events]
    assert kinds[:2] == ["fault_injected", "replica_ejected"]
    assert kinds[-2:] == ["replica_recovered", "router_membership_changed"]
    # the shard's machines went to their successors, counted by target
    failovers = [e for e in port_events if e["event"] == "shard_failover"]
    successors = {}
    for name in SHARDS[VICTIM]:
        target = next(r for r in RING.preference(name) if r != VICTIM)
        successors[target] = successors.get(target, 0) + 1
    assert {e["target"]: e["n_machines"] for e in failovers} == successors
    assert {e["from_replica"] for e in failovers} == {VICTIM}


def test_hedge_and_failover_spans_equal_jax(plane, jax_plane, monkeypatch, tmp_path):  # noqa: F811
    """A slow shard under ``replica:slow`` is hedged: the router request's
    spans (names and attribute keys) are JAX's."""
    slow = RING.owner(PUMPS[0])
    body = fleet_body(SHARDS[slow], anomaly=False)
    p = plane(HEDGE_MS=40.0, PROBE_INTERVAL_S=0.0)
    jp = jax_plane(HEDGE_MS=40.0, PROBE_INTERVAL_S=0.0)
    spans = {}
    for name, post in (("port", lambda: p.call("POST", FLEET, body)),
                       ("jax", lambda: jax_call(jp.client, "POST", FLEET, body))):
        _arm(monkeypatch, f"replica:slow:{slow}@ms:600@attempts:1")
        monkeypatch.setenv(tracing.TRACE_LOG_ENV_VAR, str(tmp_path / f"{name}.jsonl"))
        assert post()[0] == 200
        time.sleep(0.8)  # the straggler's span ends after the reply
        spans[name] = sorted(
            (s["name"], tuple(sorted(k for k in s.get("attributes", {})
                                     if k not in ("replica", "status_code", "path"))))
            for s in tracing.read_spans(str(tmp_path / f"{name}.jsonl"))
            if s["name"].startswith("router."))
    assert spans["port"] == spans["jax"]
    assert ("router.fanout", ("hedge", "n_machines")) in spans["port"]


def _series(snapshot, name):
    """{labels tuple: value or count} of one metric of a registry snapshot."""
    out = {}
    for series in (snapshot.get(name) or {}).get("series", []):
        key = tuple(sorted(series["labels"].items()))
        out[key] = series.get("value", series.get("count"))
    return out


def _labelnames(snapshot, name):
    return (snapshot.get(name) or {}).get("labelnames")


def _delta(before, after, name):
    b, a = _series(before, name), _series(after, name)
    return {k: v - b.get(k, 0) for k, v in a.items() if v != b.get(k, 0)}


SERVE_SERIES = ["gordo_serve_group_latency_seconds", "gordo_serve_group_batch_size",
                "gordo_serve_machines_scored_total"]
STREAM_SERIES = ["gordo_stream_updates_total", "gordo_stream_update_seconds",
                 "gordo_stream_update_rows"]


def _serve_and_stream(call):
    """The same fleet request and a two-update stream of a pump."""
    call("POST", FLEET, fleet_body([*PUMPS, *TURBINES], anomaly=False))
    status, opened = call("POST", f"/gordo/v0/{PROJECT}/stream/open",
                          {"machines": [PUMPS[1]]})[:2]
    assert status == 201
    rows = np.random.default_rng(3).normal(size=(10, 4))
    for seq in (0, 5):
        status, reply = call("POST", f"/gordo/v0/{PROJECT}/stream/{opened['session']}/update",
                             {"updates": {PUMPS[1]: {"rows": rows[seq:seq + 5].tolist(),
                                                     "seq": seq}}})[:2]
        assert status == 200, reply
    call("POST", f"/gordo/v0/{PROJECT}/stream/{opened['session']}/close", {})


def test_serving_series_equal_jax(collections, monkeypatch):  # noqa: F811
    port = build_app(str(collections[1]), device="cpu", batch_wait_ms=0)
    before = get_registry().snapshot()
    _serve_and_stream(lambda *a: single_call(port, *a))
    after = get_registry().snapshot()
    jax = _jax_app(collections, monkeypatch)
    jax_before = jax_get_registry().snapshot()
    _serve_and_stream(lambda *a: jax_call(jax, *a))
    jax_after = jax_get_registry().snapshot()
    for name in [*SERVE_SERIES, *STREAM_SERIES, "gordo_stream_sessions"]:
        assert _labelnames(after, name) == _labelnames(jax_after, name), name
        assert after[name]["type"] == jax_after[name]["type"], name
    for name in ["gordo_serve_machines_scored_total", "gordo_stream_updates_total",
                 "gordo_serve_group_batch_size", "gordo_stream_update_rows"]:
        assert _delta(before, after, name) == _delta(jax_before, jax_after, name), name
    assert _delta(before, after, "gordo_stream_updates_total") == {(("outcome", "ok"),): 2}
    phases = {dict(k).get("plane") for k in _series(after, "gordo_phase_seconds")}
    assert "stream" in phases


def test_router_plane_of_the_phase_ledger(plane, jax_plane):  # noqa: F811
    p, jp = plane(), jax_plane()
    body = fleet_body(list(SHARDS[VICTIM]), anomaly=False)

    def router_phases(snapshot):
        return {dict(k)["phase"] for k in _series(snapshot, "gordo_phase_seconds")
                if dict(k).get("plane") == "router"}

    assert p.call("POST", FLEET, body)[0] == 200
    assert jax_call(jp.client, "POST", FLEET, body)[0] == 200
    got, want = router_phases(get_registry().snapshot()), router_phases(
        jax_get_registry().snapshot())
    assert {"queue", "serialize"} <= got and got == want
    reply = p.call("POST", FLEET, body, headers={
        "traceparent": "00-" + "a" * 32 + "-" + "b" * 16 + "-01"})[2]
    assert reply.headers[tracing.TRACE_ID_RESPONSE_HEADER] == "a" * 32


def _roll_story(revisions, post):
    """A stream of a turbine, the ``latest`` symlink re-pointed, one more
    update (the resume 409), then a shed request at a full queue."""
    status, opened = post("stream/open", {"machines": [TURBINES[0]]})
    assert status == 201, opened
    rows = np.random.default_rng(5).normal(size=(24, 3))
    status, _ = post(f"stream/{opened['session']}/update",
                     {"updates": {TURBINES[0]: {"rows": rows[:12].tolist(), "seq": 0}}})
    assert status == 200
    swap = revisions / ".latest-swap"
    swap.symlink_to(revisions / "rev-b")
    os.replace(swap, revisions / "latest")
    status, _ = post(f"stream/{opened['session']}/update",
                     {"updates": {TURBINES[0]: {"rows": rows[12:].tolist(), "seq": 12}}})
    assert status == 409


def test_roll_and_stream_events_equal_jax(collections, monkeypatch, tmp_path):  # noqa: F811
    """A ``latest`` roll mid-stream: the same ``stream_opened``,
    ``stream_observation``, ``revision_rolled`` and ``stream_closed``
    events, fields equal apart from time, pid, ids and the statistic."""
    keep = {"stream_opened", "stream_observation", "revision_rolled", "stream_closed"}
    logs = {}
    for pkg, source in (("port", collections[1]), ("jax", collections[0])):
        revisions = tmp_path / pkg
        for name in ("rev-a", "rev-b"):
            shutil.copytree(source, revisions / name)
        (revisions / "latest").symlink_to(revisions / "rev-a")
        logs[pkg] = tmp_path / f"{pkg}.jsonl"
        monkeypatch.setenv("GORDO_TPU_EVENT_LOG", str(logs[pkg]))
        monkeypatch.setenv("GORDO_BATCH_WAIT_MS", "1")
        if pkg == "port":
            app = build_app(str(revisions / "latest") + os.sep, device="cpu")
            post = lambda route, body: single_call(  # noqa: E731
                app, "POST", f"/gordo/v0/{PROJECT}/{route}", body)
        else:
            client = _jax_app({0: revisions / "latest"}, monkeypatch)
            post = lambda route, body: jax_call(  # noqa: E731
                client, "POST", f"/gordo/v0/{PROJECT}/{route}", body)[:2]
        _roll_story(revisions, post)
        if pkg == "port":
            app.catalog.stop()
    events = {}
    for pkg, path in logs.items():
        events[pkg] = [
            {k: (v if k not in ("ratio_mean", "exceedance") else "number")
             for k, v in record.items() if k not in VOLATILE | {"session"}}
            for record in read_events(str(path)) if record["event"] in keep]
    assert events["port"] == events["jax"]
    assert [e["event"] for e in events["port"]] == [
        "stream_opened", "stream_observation", "stream_closed", "revision_rolled"]
    assert events["port"][2]["reason"] == "revision_rolled"
    assert events["port"][3] == {"event": "revision_rolled", "previous": "rev-a",
                                 "current": "rev-b", "n_batchers_stopped": 1,
                                 "n_streams_expired": 1}


def test_a_shed_writes_request_shed_as_jax(collections, monkeypatch, tmp_path):  # noqa: F811
    """A full batching queue sheds with a 503 and a ``request_shed`` event
    carrying the JAX fields."""
    from gordo_tpu_torch.server import batching

    log = tmp_path / "events.jsonl"
    monkeypatch.setenv("GORDO_TPU_EVENT_LOG", str(log))
    app = build_app(str(collections[1]), device="cpu", batch_wait_ms=5, batch_queue_limit=1)
    body = fleet_body([PUMPS[0]], False)
    assert single_call(app, "POST", FLEET, body)[0] == 200
    (batcher,) = app.catalog._batchers.values()
    batcher._pending.append(batching.Pending({}))  # the queue, full
    try:
        status, reply = single_call(app, "POST", FLEET, body)
    finally:
        batcher._pending.clear()
    assert status == 503 and reply["queue_limit"] == 1
    (shed,) = [e for e in read_events(str(log)) if e["event"] == "request_shed"]
    assert {k: v for k, v in shed.items() if k not in VOLATILE} == {
        "event": "request_shed", "queue_depth": 1, "queue_limit": 1,
        "retry_after_s": reply["retry_after_s"]}
    app.catalog.stop()


def test_rowwise_chunks_score_bitwise_as_the_whole(collections):  # noqa: F811
    """A feedforward machine's rows scored four at a time (a stream's
    updates) equal the same rows scored at once, bit for bit: a row-wise
    group's rows are padded to ``MIN_ROWWISE_ROWS``."""
    from gordo_tpu_torch.server.fleet_serving import MIN_ROWWISE_ROWS

    app = build_app(str(collections[1]), device="cpu", batch_wait_ms=0)
    served = app._current_revision()
    _, (scorer, prefixes, _) = app._fleet_scorer(served, (PUMPS[0],))
    rows = np.random.default_rng(11).normal(size=(52, 4)).astype("float32")
    whole = scorer.predict({PUMPS[0]: rows})[PUMPS[0]]
    chunks = np.concatenate([scorer.predict({PUMPS[0]: rows[i:i + 4]})[PUMPS[0]]
                             for i in range(0, len(rows), 4)])
    assert MIN_ROWWISE_ROWS >= 512 and whole.tobytes() == chunks.tobytes()
