"""
The port's server against the JAX server on one converted collection
(``tests/test_torch_fleet_serving.py``'s two flash Transformer detectors
and two feedforward AutoEncoders), with tracing on: for each request the
span tree (names, parent links, attribute keys, ``endpoint``,
``status_code``), the ``X-Gordo-Trace-Id`` echo of the incoming
``traceparent`` (on 200, 404, 409 and 503 replies), the ``Server-Timing``
entry names and ``/telemetry/snapshot``'s keys are the JAX server's;
probe paths echo but record nothing.

The JAX server writes the phase ledger's spans (``parse``,
``serialize``, ...) beside ``server.request`` on every route, which its
own ``tests/test_trace_context.py::test_server_request_span_children_and_echo``
does not expect (ROADMAP.md queue 3 item 2); the port is held to what the
JAX server writes.
"""

import json
import os

import pytest
from werkzeug.test import Client

from gordo_tpu.observability.tracing import read_spans
from gordo_tpu.server import build_app as jax_build_app
from gordo_tpu.server import utils as jax_server_utils
from gordo_tpu_torch.observability import tracing
from gordo_tpu_torch.server.app import build_app
from tests.test_torch_fleet_serving import (
    FF_TAGS,
    PROJECT,
    fleet_body,
    fleet_collections,
    frame_dict,
)

TRACEPARENT = "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01"
TRACE_ID = "0af7651916cd43dd8448eb211c80319c"
CASUALTY = "pump-ff-1"


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    jax_dir, port_dir = fleet_collections(tmp_path_factory.mktemp("server-tracing"))
    report = {"failed": [], "quarantined": [{"machine": CASUALTY, "epoch": 0}]}
    for directory in (jax_dir, port_dir):
        (directory / "build_report.json").write_text(json.dumps(report))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MODEL_COLLECTION_DIR", str(jax_dir))
        for var in ("GORDO_BATCH_WAIT_MS", "GORDO_PHASE_LEDGER", tracing.TRACE_LOG_ENV_VAR,
                    tracing.TRACE_SAMPLE_ENV_VAR, "ENABLE_PROMETHEUS"):
            mp.delenv(var, raising=False)
        jax_server_utils.clear_caches()
        yield (Client(jax_build_app({"STREAM_MAX_SESSIONS": 1})),
               Client(build_app(str(port_dir), device="cpu", stream_max_sessions=1)))
    jax_server_utils.clear_caches()


def _shape(records):
    by_id = {r["span_id"]: r for r in records}
    return sorted(
        (r["name"],
         by_id[r["parent_span_id"]]["name"] if r["parent_span_id"] in by_id
         else ("remote" if r["parent_span_id"] else None),
         tuple(sorted(r["attributes"])), r["attributes"].get("endpoint"),
         r["attributes"].get("status_code"))
        for r in records
    )


def _traced(client, method, path, body, log, monkeypatch, warm=True):
    """One request with tracing on (after an untraced one, so caches are
    warm as in steady serving): (status, echoed id, Server-Timing names,
    span shape, records)."""
    if warm:
        client.open(path, method=method, json=body)
    if os.path.exists(log):
        os.remove(log)
    monkeypatch.setenv(tracing.TRACE_LOG_ENV_VAR, log)
    reply = client.open(path, method=method, json=body, headers={"traceparent": TRACEPARENT})
    monkeypatch.delenv(tracing.TRACE_LOG_ENV_VAR)
    records = read_spans(log) if os.path.exists(log) else []
    timing = [entry.split(";")[0] for entry in reply.headers.get("Server-Timing", "").split(", ")]
    return (reply.status_code, reply.headers.get("X-Gordo-Trace-Id"), timing,
            _shape(records)), records


def _both(servers, method, path, body, tmp_path, monkeypatch, warm=True):
    return [_traced(c, method, path, body, str(tmp_path / f"{i}.jsonl"), monkeypatch, warm)
            for i, c in enumerate(servers)]


def _anomaly_body(tags, seed):
    frame = frame_dict(30, tags, seed)
    return {"X": frame, "y": frame}


REQUESTS = {
    "models": ("GET", f"/gordo/v0/{PROJECT}/models", None, 200),
    "metadata": ("GET", f"/gordo/v0/{PROJECT}/turbine-tf-0/metadata", None, 200),
    "prediction": ("POST", f"/gordo/v0/{PROJECT}/pump-ff-0/prediction",
                   {"X": frame_dict(25, FF_TAGS, 4)}, 200),
    "anomaly-transformer": ("POST", f"/gordo/v0/{PROJECT}/turbine-tf-1/anomaly/prediction",
                            _anomaly_body(["GRA-TURB-SPEED 1", "GRA-TURB-TEMP 2",
                                           "GRA-TURB-LOAD 3"], 5), 200),
    "fleet": ("POST", f"/gordo/v0/{PROJECT}/prediction/fleet",
              fleet_body(["pump-ff-0", "turbine-tf-0"], anomaly=False), 200),
    "fleet-anomaly": ("POST", f"/gordo/v0/{PROJECT}/anomaly/prediction/fleet",
                      fleet_body(["turbine-tf-0", "turbine-tf-1"], anomaly=True), 200),
    "casualty-409": ("POST", f"/gordo/v0/{PROJECT}/{CASUALTY}/prediction",
                     {"X": frame_dict(25, FF_TAGS, 6)}, 409),
    "fleet-casualty-409": ("POST", f"/gordo/v0/{PROJECT}/prediction/fleet",
                           fleet_body(["pump-ff-0", CASUALTY], anomaly=False), 409),
    "bad-input-400": ("POST", f"/gordo/v0/{PROJECT}/pump-ff-0/prediction", {"nope": 1}, 400),
    "gone-410": ("GET", f"/gordo/v0/{PROJECT}/models?revision=.hidden", None, 410),
    "unmatched-404": ("GET", "/no/such/route", None, 404),
}


@pytest.mark.parametrize("name", list(REQUESTS))
def test_request_span_tree_matches_jax(servers, name, tmp_path, monkeypatch):
    method, path, body, status = REQUESTS[name]
    (want, want_records), (got, got_records) = _both(servers, method, path, body, tmp_path,
                                                     monkeypatch)
    assert got == want
    assert got[0] == status and got[1] == TRACE_ID
    request = [r for r in got_records if r["name"] == "server.request"]
    assert len(request) == 1 and request[0]["parent_span_id"] == "b7ad6b7169203331"
    assert request[0]["trace_id"] == TRACE_ID
    assert {r["trace_id"] for r in got_records} == {TRACE_ID}


def test_a_shed_stream_open_is_a_503_with_the_jax_trace(servers, tmp_path, monkeypatch):
    path = f"/gordo/v0/{PROJECT}/stream/open"
    body = {"machines": ["turbine-tf-0"]}
    held = [c.post(path, json=body) for c in servers]
    assert [r.status_code for r in held] == [201, 201]
    try:
        (want, _), (got, _) = _both(servers, "POST", path, body, tmp_path, monkeypatch,
                                    warm=False)
        assert got[:3] == want[:3] and got[0] == 503 and got[1] == TRACE_ID
        # the JAX stream plane's own ``stream.session`` span (the parent of
        # its model loads there) is not ported: the request span is equal
        assert [s for s in got[3] if s[0] == "server.request"] == [
            s for s in want[3] if s[0] == "server.request"]
    finally:
        for client, reply in zip(servers, held):
            client.post(f"/gordo/v0/{PROJECT}/stream/{json.loads(reply.get_data())['session']}"
                        "/close")


@pytest.mark.parametrize("path", ["/healthz", "/healthcheck", "/telemetry/snapshot", "/metrics"])
def test_probe_paths_echo_but_record_nothing(servers, path, tmp_path, monkeypatch):
    (want, want_records), (got, got_records) = _both(servers, "GET", path, None, tmp_path,
                                                     monkeypatch)
    assert got_records == [] and want_records == []
    assert got[1] == want[1] == TRACE_ID
    assert got[2] == want[2] == ["total", "request_walltime_s"]


def test_no_traceparent_echoes_the_servers_own_trace(servers, tmp_path, monkeypatch):
    monkeypatch.setenv(tracing.TRACE_LOG_ENV_VAR, str(tmp_path / "own.jsonl"))
    reply = servers[1].get(f"/gordo/v0/{PROJECT}/models")
    (record,) = [r for r in read_spans(str(tmp_path / "own.jsonl"))
                 if r["name"] == "server.request"]
    assert reply.headers["X-Gordo-Trace-Id"] == record["trace_id"]
    assert record["parent_span_id"] is None
    monkeypatch.delenv(tracing.TRACE_LOG_ENV_VAR)
    # off: a traceparent is still echoed, nothing is written, no id minted
    quiet = servers[1].get(f"/gordo/v0/{PROJECT}/models", headers={"traceparent": TRACEPARENT})
    assert quiet.headers["X-Gordo-Trace-Id"] == TRACE_ID
    assert "X-Gordo-Trace-Id" not in servers[1].get(f"/gordo/v0/{PROJECT}/models").headers


def test_telemetry_snapshot_has_the_jax_keys(servers):
    want, got = (json.loads(c.get("/telemetry/snapshot").get_data()) for c in servers)
    assert set(got) == set(want)
    assert set(got["status"]) == set(want["status"])
    assert got["role"] == want["role"] == "replica"
    assert got["snapshot_version"] == want["snapshot_version"]
    assert "revision" not in got or got["revision"] == want["revision"]
    assert "gordo_server_phase_seconds" in got["metrics"]


def test_ledger_off_writes_no_phases(servers, tmp_path, monkeypatch):
    monkeypatch.setenv("GORDO_PHASE_LEDGER", "0")
    method, path, body, _ = REQUESTS["prediction"]
    (want, _), (got, _) = _both(servers, method, path, body, tmp_path, monkeypatch)
    assert got == want
    assert got[2] == ["model_load", "predict", "total", "request_walltime_s"]
