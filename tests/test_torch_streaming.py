"""
Streaming sessions on the port's server (``gordo_tpu_torch.streaming``,
the ``stream/`` routes of ``server/app.py``) on the CPU, over a small
fleet of two flash Transformer detectors (lookback 8) and two
feedforward AutoEncoders converted from JAX ones:

- the window cases of the JAX package's ``tests/test_streaming.py``
  (warming, overlap trim, gaps, resume), and that an update copies only
  its new rows to the device (the ``stream`` transfer counters);
- streamed outputs against the JAX server's one-shot ``/prediction/fleet``
  of the same rows (rtol 1e-4, atol 1e-5, the fleet routes' tolerance;
  not against the JAX server's own stream, see ROADMAP.md queue 3 item 2),
  and against the port's one-shot route (rtol 1e-5, atol 1e-6);
- stream and one-shot entries coalesced in one stacked dispatch;
- the resume, sequence-gap, shed, 400, 409 (casualty) and 422 bodies;
  ``/healthz``'s streaming block; and the ``latest`` symlink roll.
"""

import json
import os
import shutil
from wsgiref.validate import validator

import numpy as np
import pandas as pd
import pytest
import torch
from werkzeug.test import Client

from gordo_tpu.server import build_app as jax_build_app
from gordo_tpu.server import utils as jax_server_utils
from gordo_tpu_torch.parallel import transfer
from gordo_tpu_torch.server.app import build_app
from gordo_tpu_torch.server.fleet_serving import FleetScorer
from gordo_tpu_torch.streaming import MachineWindow, SequenceGap
from tests.test_torch_fleet_serving import (
    FF_TAGS,
    PROJECT,
    ROUTE_ATOL,
    ROUTE_RTOL,
    TF_TAGS,
    fleet_collections,
    jax_transformers,
    to_port,
)

torch.set_num_threads(1)

TURBINES = ["turbine-tf-0", "turbine-tf-1"]
PUMP = "pump-ff-0"
STREAMED = [*TURBINES, PUMP]
N_ROWS = 40
CHUNKS = (5, 6, 6, 9, 14)  # the first update only warms the turbines' windows
RTOL, ATOL = 1e-5, 1e-6


def _tags(name):
    return TF_TAGS if name.startswith("turbine") else FF_TAGS


def _rows(name, n=N_ROWS, seed=0):
    return np.random.default_rng(seed + len(name)).normal(size=(n, len(_tags(name))))


@pytest.fixture(scope="module")
def collections(tmp_path_factory):
    return fleet_collections(tmp_path_factory.mktemp("streaming"))


@pytest.fixture
def app(collections, monkeypatch):
    monkeypatch.delenv("GORDO_BATCH_WAIT_MS", raising=False)
    monkeypatch.delenv("GORDO_PREFETCH_DEPTH", raising=False)
    return build_app(str(collections[1]), device="cpu")


def _post(client, route, body=None):
    reply = client.post(f"/gordo/v0/{PROJECT}/{route}", json=body)
    return reply.status_code, json.loads(reply.get_data()), reply.headers


def _open(client, machines):
    code, body, _ = _post(client, "stream/open", {"machines": machines})
    assert code == 201, body
    return body["session"], body


def _update(client, sid, chunk_by_machine, seq_by_machine):
    return _post(client, f"stream/{sid}/update", {"updates": {
        name: {"rows": rows.tolist(), "seq": seq_by_machine[name]}
        for name, rows in chunk_by_machine.items()}})


def _stream(client, sid, data, chunks=CHUNKS, start=0):
    """Each machine's concatenated outputs over ``chunks`` of ``data``
    from row ``start``, and each update's results."""
    outs = {name: [] for name in data}
    results, i = [], start
    for k in chunks:
        code, body, _ = _update(client, sid, {n: d[i:i + k] for n, d in data.items()},
                                {n: i for n in data})
        assert code == 200, body
        results.append(body["scores"])
        for name, result in body["scores"].items():
            outs[name].extend(result["rows"])
            assert result["seq"] == i + k
        i += k
    return {n: np.asarray(o, dtype=np.float32) for n, o in outs.items()}, results


def _model_output(frame):
    return np.asarray([list(col.values()) for col in frame["model-output"].values()]).T


def _one_shot(client, data):
    body = {"machines": {name: frame_dict_from(rows, name) for name, rows in data.items()}}
    code, reply, _ = _post(client, "prediction/fleet", body)
    assert code == 200, reply
    return {name: _model_output(frame) for name, frame in reply["data"].items()}


def frame_dict_from(rows, name):
    index = pd.date_range("2019-06-01", periods=len(rows), freq="10min", tz="UTC")
    return jax_server_utils.dataframe_to_dict(pd.DataFrame(rows, columns=_tags(name), index=index))


# -- the window -----------------------------------------------------------------


def test_window_overlap_trim_gap_and_warming():
    win = MachineWindow(lookback=4, lookahead=0, n_features=3, device="cpu")
    rows = np.arange(30, dtype="float32").reshape(10, 3)
    update, fresh = win.begin("m", rows[:2], seq=0)
    assert update is None and len(fresh) == 2  # warming
    win.commit(update, fresh)
    assert win.seq == 2
    update, fresh = win.begin("m", rows[2:6], seq=2)
    assert update is not None and win.n_outputs(update) == 3
    win.commit(update, fresh)
    assert win.seq == 6 and int(update.materialize().shape[0]) == 6
    update, fresh = win.begin("m", rows[4:8], seq=4)  # a retry: trimmed
    assert len(fresh) == 2 and update.n_new == 2 and update.n_context == 3
    win.commit(update, fresh)
    assert win.seq == 8
    with pytest.raises(SequenceGap):
        win.begin("m", rows[9:], seq=9)
    win2 = MachineWindow(lookback=4, lookahead=0, n_features=3, device="cpu")
    win2.resume(rows[:8], seq=0)
    assert win2.seq == 8 and int(win2.context.shape[0]) == 3
    np.testing.assert_array_equal(win2.context.numpy(), rows[5:8])


def test_an_update_copies_only_its_new_rows():
    win = MachineWindow(lookback=8, lookahead=0, n_features=3, device="cpu")
    rows = np.random.default_rng(1).normal(size=(40, 3)).astype("float32")
    transfer.reset_transfer_counts()
    for start, k in ((0, 5), (5, 6), (11, 20)):
        before = transfer.transfer_rows.get(("stream", "direct"), 0)
        update, fresh = win.begin("m", rows[start:start + k], seq=start)
        if update is not None:
            np.testing.assert_array_equal(update.materialize().numpy(),
                                          rows[max(0, start - 7):start + k])
        win.commit(update, fresh)
        assert transfer.transfer_rows[("stream", "direct")] - before == k
    update, fresh = win.begin("m", rows[31:35], seq=31)
    update.prefetch()
    np.testing.assert_array_equal(update.materialize().numpy(), rows[24:35])
    assert transfer.transfer_rows[("stream", "prefetched")] == 4
    assert transfer.transfer_counts[("stream", "direct")] == 3


def test_stream_and_one_shot_entries_coalesce_in_one_dispatch():
    """A stream's update and a host array of the same group in one
    ``predict_requests``: each equals its own dispatch."""
    ests = to_port(jax_transformers(2))
    scorer = FleetScorer(ests)
    rows = np.random.default_rng(2).normal(size=(30, 3)).astype("float32")
    win = MachineWindow(lookback=8, lookahead=0, n_features=3, device="cpu")
    first, fresh = win.begin("tf-0", rows[:20], seq=0)
    win.commit(first, fresh)
    update, _ = win.begin("tf-0", rows[20:], seq=20)
    host = np.random.default_rng(3).normal(size=(17, 3)).astype("float32")
    mixed = scorer.predict_requests([{"tf-0": update}, {"tf-1": host}])
    np.testing.assert_array_equal(mixed[0]["tf-0"], scorer.predict({"tf-0": update})["tf-0"])
    np.testing.assert_allclose(mixed[0]["tf-0"], scorer.predict({"tf-0": rows[13:]})["tf-0"],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(mixed[1]["tf-1"], scorer.predict({"tf-1": host})["tf-1"],
                               rtol=RTOL, atol=ATOL)


# -- the routes -------------------------------------------------------------------


def test_streamed_outputs_equal_the_one_shot_routes(collections, app, monkeypatch):
    data = {name: _rows(name) for name in STREAMED}
    client = Client(app)
    sid, opened = _open(client, STREAMED)
    assert opened["machines"][TURBINES[0]] == {
        "seq": 0, "tail_rows": 7, "lookback": 8, "lookahead": 0, "monitored": True}
    assert opened["machines"][PUMP]["tail_rows"] == 0
    outs, results = _stream(client, sid, data)
    assert results[0][TURBINES[0]] == {"rows": [], "seq": 5, "warming": True}
    assert len(results[0][PUMP]["rows"]) == 5 and not results[0][PUMP]["warming"]
    port = _one_shot(client, data)
    monkeypatch.setenv("MODEL_COLLECTION_DIR", str(collections[0]))
    jax_server_utils.clear_caches()
    want = _one_shot(Client(jax_build_app()), data)
    jax_server_utils.clear_caches()
    for name in STREAMED:
        assert outs[name].shape == want[name].shape == (N_ROWS - (7 if name in TURBINES else 0),
                                                        len(_tags(name)))
        np.testing.assert_allclose(outs[name], port[name], rtol=RTOL, atol=ATOL, err_msg=name)
        np.testing.assert_allclose(outs[name], want[name], rtol=ROUTE_RTOL, atol=ROUTE_ATOL,
                                   err_msg=name)
    stats = app.catalog.streams.get(sid).stats()
    assert stats["updates_total"] == len(CHUNKS) and stats["last_transfer_rows"] == 3 * 14
    assert stats["last_resident_rows"] == 2 * 7


def test_every_stream_answer_is_a_valid_wsgi_status(app):
    """wsgiref's validator over the app: ``201 CREATED`` and the 409/503
    answers carry their reason phrases (a bare code is refused)."""
    client = Client(validator(app))
    sid, _ = _open(client, [PUMP])
    assert _update(client, sid, {PUMP: _rows(PUMP, 3)}, {PUMP: 7})[0] == 409
    assert _post(client, f"stream/{sid}/close")[0] == 200


def test_anomaly_ratio_is_the_one_shot_total_anomaly_confidence(app):
    """A streamed detector's ratio over its new outputs equals the
    one-shot anomaly frame's ``total-anomaly-confidence`` on those rows."""
    name, rows = TURBINES[1], _rows(TURBINES[1], seed=2)
    client = Client(app)
    sid, opened = _open(client, [name])
    assert opened["machines"][name]["monitored"] is True
    outs, _ = _stream(client, sid, {name: rows})
    ratio = app.catalog.streams.get(sid).machines[name].anomaly_ratio(outs[name], rows[7:])
    frame = frame_dict_from(rows, name)
    code, reply, _ = _post(client, f"{name}/anomaly/prediction", {"X": frame, "y": frame})
    assert code == 200, reply
    want = list(reply["data"]["total-anomaly-confidence"].values())[0]
    np.testing.assert_allclose(ratio, list(want.values()), rtol=1e-4, atol=1e-6)


def test_a_closed_session_resumes_from_the_replayed_tail(app):
    data = {name: _rows(name, seed=5) for name in TURBINES}
    client = Client(app)
    unbroken, _ = _stream(client, _open(client, TURBINES)[0], data)
    sid, _ = _open(client, TURBINES)
    before, _ = _stream(client, sid, data, chunks=CHUNKS[:3])
    code, body, _ = _post(client, f"stream/{sid}/close")
    assert (code, body["closed"]) == (200, True)
    assert _post(client, f"stream/{sid}/close")[1]["closed"] is False  # idempotent
    code, body, _ = _update(client, sid, {n: d[17:20] for n, d in data.items()},
                            {n: 17 for n in data})
    assert code == 409 and body["stream_resume"] == {"reason": "unknown_session", "machines": []}
    assert body["transient"] is True and body["retry_after_s"] == 1
    consumed = sum(CHUNKS[:3])
    resume = {name: {"resume": {"rows": d[consumed - 7:consumed].tolist(), "seq": consumed - 7}}
              for name, d in data.items()}
    code, body, _ = _post(client, "stream/open", {"machines": resume})
    assert code == 201 and body["machines"][TURBINES[0]]["seq"] == consumed
    after, _ = _stream(client, body["session"], data, chunks=CHUNKS[3:], start=consumed)
    for name in TURBINES:
        np.testing.assert_allclose(np.concatenate([before[name], after[name]]), unbroken[name],
                                   rtol=RTOL, atol=ATOL)


def test_a_sequence_gap_ends_the_session(app):
    client = Client(app)
    sid, _ = _open(client, [PUMP])
    code, body, _ = _update(client, sid, {PUMP: _rows(PUMP, 3)}, {PUMP: 7})
    assert code == 409 and body["stream_resume"] == {"reason": "sequence_gap", "machines": [PUMP]}
    code, body, _ = _update(client, sid, {PUMP: _rows(PUMP, 3)}, {PUMP: 0})
    assert body["stream_resume"]["reason"] == "unknown_session"


def test_bad_bodies_answer_400(app):
    client = Client(app)
    for machines in ({PUMP: "oops"}, {PUMP: ["oops"]}, {PUMP: {"resume": "nope"}}, [], None):
        assert _post(client, "stream/open", {"machines": machines})[0] == 400
    code, body, _ = _post(client, "stream/open",
                          {"machines": {PUMP: {"resume": {"rows": [[1.0, 2.0]], "seq": 0}}}})
    assert code == 400 and "expected 4" in body["error"]
    sid, _ = _open(client, [PUMP])
    rows = _rows(PUMP, 5).tolist()
    for updates in (None, {}, {PUMP: [1]}, {PUMP: {"seq": 0}}):
        assert _post(client, f"stream/{sid}/update", {"updates": updates})[0] == 400
    code, body, _ = _post(client, f"stream/{sid}/update",
                          {"updates": {PUMP: {"rows": rows, "seq": 0, "y": rows[:2]}}})
    assert code == 400 and "one target row per input row" in body["error"]
    code, body, _ = _post(client, f"stream/{sid}/update",
                          {"updates": {PUMP: {"rows": [r[:3] for r in rows], "seq": 0}}})
    assert code == 400 and "expects 4 feature column(s), got 3" in body["error"]
    code, body, _ = _post(client, f"stream/{sid}/update",
                          {"updates": {TURBINES[0]: {"rows": rows, "seq": 0}}})
    assert code == 400 and "not in stream session" in body["error"]
    # nothing was committed: the first good update starts at row 0
    code, body, _ = _post(client, f"stream/{sid}/update",
                          {"updates": {PUMP: {"rows": rows, "seq": 0}}})
    assert code == 200 and body["scores"][PUMP]["seq"] == 5


def test_sheds_answer_503_with_retry_after(collections, monkeypatch):
    monkeypatch.delenv("GORDO_BATCH_WAIT_MS", raising=False)
    app = build_app(str(collections[1]), device="cpu", stream_max_sessions=1,
                    stream_max_backlog=2)
    client = Client(app)
    sid, _ = _open(client, [PUMP])
    code, body, headers = _post(client, "stream/open", {"machines": [TURBINES[0]]})
    assert code == 503 and headers["Retry-After"] == str(body["retry_after_s"]) == "1"
    session = app.catalog.streams.get(sid)
    session.admit()
    session.admit()
    code, body, headers = _update(client, sid, {PUMP: _rows(PUMP, 3)}, {PUMP: 0})
    assert code == 503 and "backlog saturated" in body["error"] and headers["Retry-After"]
    session.release()
    session.release()
    _post(client, f"stream/{sid}/close")
    assert _post(client, "stream/open", {"machines": [TURBINES[0]]})[0] == 201
    idle = build_app(str(collections[1]), device="cpu", stream_max_sessions=1, stream_idle_s=0.0)
    client = Client(idle)
    old, _ = _open(client, [PUMP])
    _open(client, [TURBINES[0]])  # the idle session is evicted instead
    code, body, _ = _update(client, old, {PUMP: _rows(PUMP, 3)}, {PUMP: 0})
    assert code == 409 and body["stream_resume"]["reason"] == "unknown_session"


def test_healthz_reports_the_streaming_block(app):
    client = Client(app)
    assert json.loads(client.get("/healthz").get_data())["streaming"] == {
        "sessions": 0, "max_sessions": 64, "max_backlog": 8, "backlog": 0,
        "saturated_sessions": 0}
    sid, _ = _open(client, [PUMP])
    session = app.catalog.streams.get(sid)
    for _ in range(8):
        session.admit()
    reply = client.get("/healthz")
    payload = json.loads(reply.get_data())
    assert reply.status_code == 503 and reply.headers["Retry-After"] == "1"
    assert payload["status"] == "overloaded"
    assert payload["streaming"] == {"sessions": 1, "max_sessions": 64, "max_backlog": 8,
                                    "backlog": 8, "saturated_sessions": 1}
    for _ in range(8):
        session.release()
    assert client.get("/healthz").status_code == 200


def test_casualties_answer_409_and_unstackable_machines_422(collections, tmp_path, monkeypatch):
    revision = tmp_path / "1700000000001"
    shutil.copytree(collections[1], revision)
    (revision / "build_report.json").write_text(json.dumps(
        {"failed": [{"machine": PUMP, "phase": "fit", "error": "boom"}], "quarantined": []}))
    monkeypatch.delenv("GORDO_BATCH_WAIT_MS", raising=False)
    app = build_app(str(revision), device="cpu")
    client = Client(app)
    code, body, _ = _post(client, "stream/open", {"machines": [PUMP, TURBINES[0]]})
    assert code == 409 and body["unavailable"][PUMP]["reason"] == "fit_failed"
    assert _post(client, "stream/open", {"machines": ["no-such-machine"]})[0] == 404
    original = app.catalog.fleet_scorer

    def without_turbine(*args, **kwargs):
        scorer, prefixes, fallback = original(*args, **kwargs)
        return scorer, prefixes, dict(fallback, **{TURBINES[1]: object()})

    monkeypatch.setattr(app.catalog, "fleet_scorer", without_turbine)
    code, body, _ = _post(client, "stream/open", {"machines": [TURBINES[1]]})
    assert code == 422 and TURBINES[1] in body["message"]


def test_a_latest_symlink_roll_expires_sessions_and_batchers(collections, tmp_path, monkeypatch):
    revisions = tmp_path / "revisions"
    for name in ("rev-a", "rev-b"):
        shutil.copytree(collections[1], revisions / name)
    latest = revisions / "latest"
    latest.symlink_to(revisions / "rev-a")
    monkeypatch.setenv("GORDO_BATCH_WAIT_MS", "1")
    app = build_app(str(latest) + os.sep, device="cpu")
    client = Client(app)
    data = {name: _rows(name, seed=9) for name in TURBINES}
    unbroken, _ = _stream(client, _open(client, TURBINES)[0], data)
    sid, _ = _open(client, TURBINES)
    code, body, headers = _update(client, sid, {n: d[:20] for n, d in data.items()},
                                  {n: 0 for n in data})
    assert code == 200 and headers["revision"] == "rev-a"
    assert {key[0] for key in app.catalog._batchers} == {str(revisions / "rev-a")}
    swap = revisions / ".latest-swap"
    swap.symlink_to(revisions / "rev-b")
    os.replace(swap, latest)
    code, body, headers = _update(client, sid, {n: d[20:] for n, d in data.items()},
                                  {n: 20 for n in data})
    assert code == 409 and body["stream_resume"] == {"reason": "revision_rolled",
                                                     "machines": TURBINES}
    assert headers["revision"] == "rev-b" and len(app.catalog.streams) == 0
    assert json.loads(client.get(f"/gordo/v0/{PROJECT}/revisions").get_data())["latest"] == "rev-b"
    resume = {n: {"resume": {"rows": d[13:20].tolist(), "seq": 13}} for n, d in data.items()}
    code, body, _ = _post(client, "stream/open", {"machines": resume})
    assert code == 201
    after, _ = _stream(client, body["session"], data, chunks=(20,), start=20)
    for name in TURBINES:
        np.testing.assert_allclose(after[name], unbroken[name][13:], rtol=RTOL, atol=ATOL)
    assert {key[0] for key in app.catalog._batchers} == {str(revisions / "rev-b")}
    app.catalog.stop()
