"""
The port's router (``gordo_tpu_torch.router``) on the CPU: three port
replicas, each a sharded port server on a real HTTP server in a thread,
behind a port router that calls them over ``http.client`` (through a
transport that can kill, slow and count calls per replica), over the
collection of ``tests/test_torch_shard.py``.

- Routed fleet and single-machine replies are bitwise equal to one
  unsharded port server's.
- The failure paths: a replica's death names exactly its shard as
  transient, then failover answers everything (bitwise equal again);
  re-adoption; hedging; the router's 503 shed; a replica's 503 passed
  through; membership change; manifest drift; revision pinning; streams.
- Status codes and JSON keys equal the JAX router's in the same
  scenarios, its plane built as ``tests/test_router.py`` builds it.
- The health tracker moves through the same states as JAX's under the
  same outcomes, a fake clock and the same jitter seed.
"""

import json
import random
import threading
import time
import urllib.request
from urllib.parse import urlsplit

import numpy as np
import pytest
import torch

from gordo_tpu.client import utils as jax_client_utils
from gordo_tpu.router.app import parse_replica_entries as jax_parse_replica_entries
from gordo_tpu.router.health import ReplicaHealthTracker as JaxTracker
from gordo_tpu_torch.cli import cli
from gordo_tpu_torch.router import health
from gordo_tpu_torch.router.app import (
    HttpTransport,
    RouterApp,
    build_router_app,
    parse_replica_entries,
)
from gordo_tpu_torch.router.ring import HashRing
from gordo_tpu_torch.server.app import build_app
from gordo_tpu_torch.server.catalog import write_shard_manifest
from gordo_tpu_torch.server.runner import make_http_server
from tests.test_router import _LIVE_ROUTERS
from tests.test_router import make_plane as jax_make_plane
from tests.test_torch_fleet_serving import FF_TAGS, PROJECT, TF_TAGS, fleet_body, frame_dict
from tests.test_torch_shard import MACHINES, PUMPS, REPLICAS, TURBINES, collections, keys_of  # noqa: F401,E501

torch.set_num_threads(1)
RING = HashRing(REPLICAS)
SHARDS = RING.partition(MACHINES)
VICTIM = "r2"


class Transport(HttpTransport):
    """The router's transport with a kill switch, a delay and a call
    count per replica, and the URLs called."""

    def __init__(self, urls):
        super().__init__()
        self.by_netloc = {urlsplit(url).netloc: rid for rid, url in urls.items()}
        self.killed, self.delay_s = set(), {}
        self.calls = {rid: 0 for rid in urls}
        self.urls = []
        self._count_lock = threading.Lock()

    def request(self, method, url, body=None, headers=None, timeout=30.0):
        rid = self.by_netloc.get(urlsplit(url).netloc)
        with self._count_lock:
            self.calls[rid] = self.calls.get(rid, 0) + 1
            self.urls.append(url)
        if rid in self.killed:
            raise ConnectionRefusedError(f"{rid} is down")
        time.sleep(self.delay_s.get(rid, 0.0))
        return super().request(method, url, body, headers, timeout)


class Plane:
    """Port replicas on HTTP servers and a port router in front."""

    def __init__(self, port_dir, manifest, **config):
        self.servers, urls = {}, {}
        for rid in REPLICAS:
            app = build_app(str(port_dir), device="cpu", shard_manifest=manifest, replica_id=rid,
                            batch_wait_ms=0)
            server = make_http_server(app, "127.0.0.1", 0)
            threading.Thread(target=server.serve_forever, daemon=True).start()
            self.servers[rid] = server
            urls[rid] = f"http://127.0.0.1:{server.server_port}"
        self.urls = urls
        self.transport = Transport(urls)
        self.router = RouterApp(dict({"REPLICAS": urls, "COLLECTION_DIR": str(port_dir),
                                      "TRANSPORT": self.transport, "PROBE_INTERVAL_S": 0.05,
                                      "BACKOFF_SCALE": 0.002}, **config))

    def call(self, method, path, body=None, headers=None, query=""):
        data = json.dumps(body).encode() if body is not None else b""
        reply = self.router.dispatch(method, path, data, query,
                                     dict({"Content-Type": "application/json"}, **(headers or {})))
        return reply.status, json.loads(reply.body or b"null"), reply

    def close(self):
        self.router.close()
        for server in self.servers.values():
            server.shutdown()
            server.server_close()


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    return write_shard_manifest(str(tmp_path_factory.mktemp("router") / "m.json"), REPLICAS)


@pytest.fixture
def plane(collections, manifest):  # noqa: F811
    planes = []

    def make(**config):
        planes.append(Plane(collections[1], manifest, **config))
        return planes[-1]

    yield make
    for p in planes:
        p.close()


@pytest.fixture
def jax_plane(collections, monkeypatch, tmp_path):  # noqa: F811
    def make(**config):
        return jax_make_plane(collections[0], monkeypatch, tmp_path, n_replicas=3, **config)

    yield make
    while _LIVE_ROUTERS:
        _LIVE_ROUTERS.pop().close()


@pytest.fixture(scope="module")
def single(collections):  # noqa: F811
    """One unsharded port server over the collection."""
    return build_app(str(collections[1]), device="cpu", batch_wait_ms=0)


def single_call(app, method, path, body=None):
    reply = app.dispatch(method, path, lambda: json.dumps(body).encode() if body else b"",
                         content_type="application/json")
    return reply.status, json.loads(reply.body or b"null")


def jax_call(client, method, path, body=None, headers=None):
    reply = client.open(path, method=method, json=body, headers=headers or {})
    return reply.status_code, json.loads(reply.get_data() or b"null"), reply


FLEET = f"/gordo/v0/{PROJECT}/prediction/fleet"
ANOMALY_FLEET = f"/gordo/v0/{PROJECT}/anomaly/prediction/fleet"


def _single_body(name, anomaly):
    frame = frame_dict(24, TF_TAGS if name in TURBINES else FF_TAGS, 5)
    return {"X": frame, "y": frame} if anomaly else {"X": frame}


# -- routed replies ----------------------------------------------------------


def test_routed_replies_bitwise_equal_one_unsharded_server(plane, single, jax_plane):
    p, jp = plane(), jax_plane()
    for path, names, anomaly in ((FLEET, MACHINES, False), (ANOMALY_FLEET, TURBINES, True),
                                 (FLEET, PUMPS[:1], False)):
        body = fleet_body(names, anomaly=anomaly)
        want_status, want = single_call(single, "POST", path, body)
        status, got, reply = p.call("POST", path, body)
        assert status == want_status == 200
        assert got["data"] == want["data"]
        assert sorted(got) == sorted(want) and reply.headers["revision"] == want["revision"]
        jax_status, jax_body, _ = jax_call(jp.client, "POST", path, body)
        assert jax_status == status and sorted(jax_body) == sorted(got)
    for name in MACHINES:
        for anomaly in (False, True):
            route = "anomaly/prediction" if anomaly else "prediction"
            path = f"/gordo/v0/{PROJECT}/{name}/{route}"
            body = _single_body(name, anomaly)
            want_status, want = single_call(single, "POST", path, body)
            status, got, _ = p.call("POST", path, body)
            assert status == want_status, (name, route, got)
            assert got.get("data") == want.get("data") and sorted(got) == sorted(want)
            jax_status, jax_body, _ = jax_call(jp.client, "POST", path, body)
            assert jax_status == status and sorted(jax_body) == sorted(got), (name, route)
    # each replica was called for its own shard only
    assert all(p.transport.calls[rid] > 0 for rid in REPLICAS)


def test_models_metadata_and_download_through_the_router(plane, single, jax_plane):
    p, jp = plane(), jax_plane()
    for path in (f"/gordo/v0/{PROJECT}/models", f"/gordo/v0/{PROJECT}/{PUMPS[0]}/metadata",
                 f"/gordo/v0/{PROJECT}/revisions", "/server-version", "/healthz",
                 "/router/replicas"):
        status, got, _ = p.call("GET", path)
        jax_status, want, _ = jax_call(jp.client, "GET", path)
        assert status == jax_status == 200, path
        assert sorted(got) == sorted(want), path
    status, got, _ = p.call("GET", f"/gordo/v0/{PROJECT}/models")
    assert got["models"] == MACHINES
    assert got["revision"] == single_call(single, "GET", f"/gordo/v0/{PROJECT}/models")[1][
        "revision"]
    reply = p.router.dispatch("GET", f"/gordo/v0/{PROJECT}/{PUMPS[0]}/download-model")
    assert reply.status == 200 and reply.mimetype == "application/octet-stream"
    for path in ("/metrics", "/status", "/telemetry/snapshot"):
        status, got, _ = p.call("GET", path)
        assert status == 404 and "ROADMAP.md queue 1 item 9" in got["error"]


# -- failures ----------------------------------------------------------------


def _death(call, kill, state, post_all):
    """Kill the victim; the requests until its ejection answer 409 naming
    exactly its shard; then failover answers everything."""
    kill(VICTIM)
    statuses = []
    for _ in range(3):  # EJECT_AFTER
        status, payload = post_all()
        statuses.append((status, sorted(payload)))
        if status != 409:
            break
        assert payload["transient"] is True
        assert set(payload["unavailable"]) == set(SHARDS[VICTIM])
        assert {i["reason"] for i in payload["unavailable"].values()} == {"replica_unavailable"}
    assert statuses[0][0] == 409 and state(VICTIM) == health.EJECTED
    return statuses, post_all()


def test_replica_death_names_its_shard_then_fails_over(plane, single, jax_plane):
    p, jp = plane(), jax_plane()
    body = fleet_body(MACHINES, anomaly=False)
    got = _death(p.call, p.transport.killed.add, p.router.health.state,
                 lambda: p.call("POST", FLEET, body)[:2])
    want = _death(jp.client, jp.kill, jp.router.health.state,
                  lambda: jax_call(jp.client, "POST", FLEET, body)[:2])
    assert got[0] == want[0]  # the same statuses and keys during the window
    status, payload = got[1]
    assert status == want[1][0] == 200 and sorted(payload) == sorted(want[1][1])
    assert payload["data"] == single_call(single, "POST", FLEET, body)[1]["data"]


def test_dead_replica_is_readopted_without_a_restart(plane):
    p = plane()
    body = fleet_body(MACHINES, anomaly=False)
    p.transport.killed.add(VICTIM)
    while p.router.health.state(VICTIM) != health.EJECTED:
        p.call("POST", FLEET, body)
    p.transport.killed.discard(VICTIM)
    assert p.call("POST", FLEET, body)[0] == 200
    calls = p.transport.calls[VICTIM]
    deadline = time.monotonic() + 5.0
    while p.router.health.state(VICTIM) == health.EJECTED:
        assert time.monotonic() < deadline, "the replica never left its ejection"
        p.router.probe_ejected()
        time.sleep(0.01)
    assert p.call("POST", FLEET, body)[0] == 200
    assert p.router.health.state(VICTIM) == health.HEALTHY
    assert p.transport.calls[VICTIM] > calls


def test_a_slow_shard_is_hedged_to_its_successor(plane, single):
    p = plane(HEDGE_MS=40.0)
    slow = RING.owner(PUMPS[0])
    p.transport.delay_s[slow] = 1.5
    body = fleet_body(SHARDS[slow], anomaly=False)
    start = time.monotonic()
    status, got, _ = p.call("POST", FLEET, body)
    assert status == 200 and time.monotonic() - start < 1.2
    assert got["data"] == single_call(single, "POST", FLEET, body)[1]["data"]


def test_the_router_sheds_past_max_inflight(plane, jax_plane):
    p, jp = plane(MAX_INFLIGHT=1), jax_plane(MAX_INFLIGHT=1)
    body = fleet_body(PUMPS[:2], anomaly=False)
    for router, post in ((p.router, lambda: p.call("POST", FLEET, body)),
                         (jp.router, lambda: jax_call(jp.client, "POST", FLEET, body))):
        router._inflight.acquire()
        try:
            status, payload, reply = post()
        finally:
            router._inflight.release()
        assert status == 503 and "max_inflight" in payload
        assert float(reply.headers["Retry-After"]) > 0
        assert post()[0] == 200


def _shedding(environ, start_response):
    start_response("503 SERVICE UNAVAILABLE", [("Content-Type", "application/json"),
                                               ("Retry-After", "2.5"), ("Content-Length", "24")])
    return [json.dumps({"error": "queue full!"}).encode()]


def test_a_replicas_503_passes_through(plane, jax_plane):
    from tests.utils import WSGIAdapter

    p, jp = plane(), jax_plane()
    p.servers["r0"].set_app(_shedding)
    jp.adapter.adapters["r0.test"] = WSGIAdapter(_shedding)
    body = fleet_body(MACHINES, anomaly=False)
    status, payload, reply = p.call("POST", FLEET, body)
    jax_status, jax_payload, jax_reply = jax_call(jp.client, "POST", FLEET, body)
    assert status == jax_status == 503 and sorted(payload) == sorted(jax_payload)
    assert reply.headers["Retry-After"] == jax_reply.headers["Retry-After"] == "2.5"
    assert p.router.health.state("r0") == health.HEALTHY  # a shed is no failure
    name = SHARDS["r0"][0]
    status, _, reply = p.call("POST", f"/gordo/v0/{PROJECT}/{name}/prediction",
                              _single_body(name, False))
    assert status == 503 and reply.headers["Retry-After"] == "2.5"


def test_membership_change_drains_and_adopts(plane, jax_plane):
    p, jp = plane(), jax_plane()
    status, got, _ = p.call("POST", "/router/replicas",
                            {"replicas": {r: p.urls[r] for r in ("r0", "r1")}})
    jax_status, want, _ = jax_call(jp.client, "POST", "/router/replicas", {
        "replicas": {"r0": "http://r0.test", "r1": "http://r1.test"}})
    assert status == jax_status == 200 and sorted(got) == sorted(want)
    assert sorted(got["replicas"]) == sorted(got["health"]) == ["r0", "r1"]
    calls = p.transport.calls["r2"]
    status, got, _ = p.call("POST", FLEET, fleet_body(MACHINES, anomaly=False))
    assert status == 200 and sorted(got["data"]) == MACHINES
    assert p.transport.calls["r2"] == calls  # drained
    status, got, _ = p.call("POST", "/router/replicas", {"replicas": {}})
    assert status == 400


def test_healthz_degrades_only_when_nothing_is_routable(plane, jax_plane):
    p = plane(PROBE_INTERVAL_S=0.0, BACKOFF_SCALE=1.0)
    assert p.call("GET", "/healthz")[0] == 200
    body = fleet_body(MACHINES, anomaly=False)
    p.transport.killed.update(REPLICAS)
    while any(p.router.health.state(r) != health.EJECTED for r in REPLICAS):
        p.call("POST", FLEET, body)
    status, payload, reply = p.call("GET", "/healthz")
    assert status == 503 and payload["status"] == "no_replicas"
    assert float(reply.headers["Retry-After"]) >= 0
    status, payload, _ = p.call("POST", FLEET, body)
    assert status == 409 and payload["transient"] and set(payload["unavailable"]) == set(MACHINES)


def test_manifest_drift_heals_by_adopting(plane):
    p = plane(VNODES=8)
    drifted = [m for m in MACHINES if HashRing(REPLICAS, 8).owner(m) != RING.owner(m)]
    assert drifted
    for name in MACHINES:
        status, got, _ = p.call("POST", f"/gordo/v0/{PROJECT}/{name}/prediction",
                                _single_body(name, False))
        assert status == 200, (name, got)
    status, got, _ = p.call("POST", FLEET, fleet_body(MACHINES, anomaly=False))
    assert status == 200 and sorted(got["data"]) == MACHINES


def test_a_pinned_revision_rides_every_replica_call(plane, collections):  # noqa: F811
    p = plane()
    revision = collections[1].name
    before = len(p.transport.urls)
    status, got, reply = p.call("POST", FLEET, fleet_body(MACHINES[:2], anomaly=False),
                                headers={"revision": revision})
    assert status == 200 and reply.headers["revision"] == revision
    forwarded = p.transport.urls[before:]
    assert forwarded and all(f"revision={revision}" in url for url in forwarded)
    status, got, _ = p.call("POST", FLEET, fleet_body(MACHINES[:2], anomaly=False),
                            query="revision=no-such")
    assert status == 410


def test_build_casualties_409_at_the_router(plane, collections):  # noqa: F811
    p = plane()
    report = collections[1] / "build_report.json"
    report.write_text(json.dumps({"quarantined": [{"machine": PUMPS[0], "epoch": 1}]}))
    try:
        status, got, _ = p.call("POST", FLEET, fleet_body(PUMPS, anomaly=False))
        assert status == 409 and "transient" not in got
        assert got["unavailable"] == {PUMPS[0]: {"reason": "quarantined", "epoch": 1}}
        status, got, _ = p.call("GET", f"/gordo/v0/{PROJECT}/models")
        assert PUMPS[0] not in got["models"] and PUMPS[0] in got["unavailable"]
    finally:
        report.unlink()


# -- streams -----------------------------------------------------------------


def _rows(names, n, seed):
    """{machine: (n, its width) rows}."""
    rng = np.random.default_rng(seed)
    return {name: rng.normal(size=(n, len(TF_TAGS if name in TURBINES else FF_TAGS))).round(6)
            for name in names}


def _stream(call, names, chunks):
    status, opened = call("POST", f"/gordo/v0/{PROJECT}/stream/open", {"machines": names})[:2]
    assert status == 201, opened
    sid, scores, seq = opened["session"], [], 0
    for chunk in chunks:
        status, got = call("POST", f"/gordo/v0/{PROJECT}/stream/{sid}/update", {"updates": {
            name: {"rows": chunk[name].tolist(), "seq": seq} for name in names}})[:2]
        assert status == 200, got
        scores.append(got["scores"])
        seq += len(chunk[names[0]])
    return sid, opened, scores


def test_streams_through_the_router_match_a_direct_stream(plane, single):
    p = plane()
    names = TURBINES + PUMPS[:1]
    rows = _rows(names, 60, 9)
    chunks = [{n: r[a:b] for n, r in rows.items()} for a, b in ((0, 20), (20, 40), (40, 60))]
    direct = _stream(lambda *a: single_call(single, *a), names, chunks)
    routed = _stream(p.call, names, chunks)
    assert routed[2] == direct[2]
    assert sorted(routed[1]["machines"]) == sorted(names)
    sid = routed[0]
    # a membership change: the next update answers the resume contract
    p.router.set_replicas(dict(p.urls))
    status, got, _ = p.call("POST", f"/gordo/v0/{PROJECT}/stream/{sid}/update",
                            {"updates": {names[0]: {"rows": rows[names[0]][:1].tolist(),
                                                    "seq": 60}}})
    assert status == 409 and got["stream_resume"]["reason"] == "membership_changed"
    status, got, _ = p.call("POST", f"/gordo/v0/{PROJECT}/stream/{sid}/update",
                            {"updates": {names[0]: {"rows": rows[names[0]][:1].tolist(),
                                                    "seq": 60}}})
    assert status == 409 and got["stream_resume"]["reason"] == "unknown_session"
    # a replica dies mid-stream: resume contract, naming the session's machines
    sid = _stream(p.call, names, chunks[:1])[0]
    p.transport.killed.add(RING.owner(TURBINES[0]))
    status, got, _ = p.call("POST", f"/gordo/v0/{PROJECT}/stream/{sid}/update", {"updates": {
        name: {"rows": rows[name][20:30].tolist(), "seq": 20} for name in names}})
    assert status == 409 and got["stream_resume"]["machines"] == sorted(names)
    status, got, _ = p.call("POST", f"/gordo/v0/{PROJECT}/stream/{sid}/close")
    assert status == 200 and got["closed"] is True


# -- the health tracker against JAX's ----------------------------------------


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("lazy", [True, False])
def test_health_tracker_states_equal_jax(lazy):
    outcomes = ["fail", "fail", "ok", "fail", "fail", "fail", "tick:1", "probe:ok", "fail",
                "tick:3", "probe:ok", "ok", "fail", "fail", "fail", "tick:50", "ok", "fail",
                "probe:fail", "tick:0.5", "fail", "fail", "fail", "tick:9", "probe:ok", "ok"]
    clock_a, clock_b = _Clock(), _Clock()
    jax_client_utils.seed_backoff_jitter(4)
    theirs = JaxTracker(["a", "b"], eject_after=3, backoff_scale=0.25, lazy_half_open=lazy,
                        now=clock_a)
    ours = health.ReplicaHealthTracker(["a", "b"], eject_after=3, backoff_scale=0.25,
                                       lazy_half_open=lazy, now=clock_b, rng=random.Random(4))
    for step in outcomes:
        for tracker, clock in ((theirs, clock_a), (ours, clock_b)):
            if step == "fail":
                tracker.record_failure("a")
            elif step == "ok":
                tracker.record_success("a")
            elif step.startswith("probe:"):
                tracker.note_probe("a", step.endswith("ok"))
            else:
                clock.t += float(step.split(":")[1])
        assert ours.snapshot() == theirs.snapshot(), step
        assert ours.probe_due("a") == theirs.probe_due("a")
        assert ours.retry_after_s("a") == theirs.retry_after_s("a")
    ours.forget("b")
    theirs.forget("b")
    assert ours.snapshot() == theirs.snapshot()
    assert ours.state("gone") == theirs.state("gone") == health.EJECTED


# -- configuration and the command -------------------------------------------


def test_parse_replica_entries_as_jax():
    for entries in (["r0=http://h0:1/", "r1=http://h1:2"], ["r0=http://a,r1=http://b"], []):
        assert parse_replica_entries(entries) == jax_parse_replica_entries(entries)
    for bad in (["r0"], ["=http://x"], ["r0="]):
        with pytest.raises(ValueError):
            parse_replica_entries(bad)
        with pytest.raises(ValueError):
            jax_parse_replica_entries(bad)


def test_router_from_the_environment_needs_no_card(monkeypatch):
    monkeypatch.setenv("GORDO_ROUTER_REPLICAS", "r0=http://127.0.0.1:9,r1=http://127.0.0.1:10")
    monkeypatch.setenv("GORDO_ROUTER_HEDGE_MS", "25")
    router = build_router_app({"PROBE_INTERVAL_S": 0})
    assert sorted(router.routing_view()[0]) == ["r0", "r1"] and router.hedge_s == 0.025
    with pytest.raises(ValueError):
        RouterApp({})


def test_run_router_usage_errors(monkeypatch, capsys):
    monkeypatch.delenv("GORDO_ROUTER_REPLICAS", raising=False)
    monkeypatch.delenv("MODEL_COLLECTION_DIR", raising=False)
    for args, message in ((["--collection-dir", "/x"], "At least one --replica"),
                          (["--replica", "r0=http://h:1"], "--collection-dir is required"),
                          (["--replica", "r0"], "must be id=url"),
                          (["--replica", "r0=http://h:1", "--collection-dir", "/x",
                            "--rollup-interval", "5"], "not ported yet")):
        with pytest.raises(SystemExit) as exit_info:
            cli.main(["run-router", *args])
        assert exit_info.value.code == 2
        assert message in capsys.readouterr().err


def test_the_router_over_http(plane, single):
    """The router's WSGI side: served by the port's HTTP server and asked
    over HTTP, as ``run-router`` serves it."""
    p = plane()
    server = make_http_server(p.router, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        body = fleet_body(MACHINES, anomaly=False)
        request = urllib.request.Request(
            f"http://127.0.0.1:{server.server_port}{FLEET}", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(request, timeout=30) as reply:
            got = json.loads(reply.read())
            assert reply.headers["Server-Timing"].startswith("router_total")
        assert got["data"] == single_call(single, "POST", FLEET, body)[1]["data"]
    finally:
        server.shutdown()
        server.server_close()
