"""
The port's client helpers against the JAX client's on the same inputs:
``make_date_ranges`` (hypothesis), the seeded backoff and Retry-After
delays, ``handle_response`` over every status it maps, ``_row_chunks``,
``_adjust_for_offset``, ``_min_chunk_rows``, ``cached_method``'s TTL,
``parse_influx_uri``, and the frames a reply's ``data`` reads into (the
JAX server utils' pandas frames). Also the shared HTTP transport: a
pooled connection takes each call's timeout (the Step 0 repair), a
timed-out call is not sent again, and a closed idle connection is. And
the options that need packages the port does not use refuse, naming
them. Exact throughout.
"""

import json
import math
import random
import threading
import time
from datetime import datetime, timedelta, timezone
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pandas as pd
import pytest
import requests
from hypothesis import given, settings
from hypothesis import strategies as st

from gordo_tpu.client import client as jax_client
from gordo_tpu.client import io as jax_io
from gordo_tpu.client import utils as jax_utils
from gordo_tpu.machine import Machine as JaxMachine
from gordo_tpu.server import utils as jax_server_utils
from gordo_tpu_torch.client import client, io, utils
from gordo_tpu_torch.client.forwarders import ForwardPredictionsIntoInflux
from gordo_tpu_torch.client.frames import concat_frames, frame_from_reply, frame_to_dict
from gordo_tpu_torch.machine import Machine
from gordo_tpu_torch.models.utils import Frame
from gordo_tpu_torch.utils.http import HttpTransport, Reply
from tests.torch_client_helpers import assert_frame_matches

UTC = timezone.utc


@settings(max_examples=60, deadline=None)
@given(
    start_s=st.integers(0, 3 * 86400),
    span_s=st.integers(0, 6 * 86400),
    max_days=st.integers(0, 4),
    freq=st.sampled_from(["h", "30min", "2h", "1D", "10min"]),
)
def test_make_date_ranges_matches_jax(start_s, span_s, max_days, freq):
    start = datetime(2020, 3, 1, tzinfo=UTC) + timedelta(seconds=start_s)
    end = start + timedelta(seconds=span_s)
    want = jax_client.make_date_ranges(start, end, max_days, freq=freq)
    got = client.make_date_ranges(start, end, max_days, freq=freq)
    assert got == [(pd.Timestamp(a).to_pydatetime(), pd.Timestamp(b).to_pydatetime())
                   for a, b in want]


def test_make_date_ranges_keeps_the_start_zone():
    from zoneinfo import ZoneInfo

    oslo = ZoneInfo("Europe/Oslo")
    start = datetime(2020, 3, 28, 12, tzinfo=oslo)  # across the DST switch
    end = datetime(2020, 3, 30, 0, 30, tzinfo=oslo)
    want = jax_client.make_date_ranges(start, end, 1)
    got = client.make_date_ranges(start, end, 1)
    assert got == [(a.to_pydatetime(), pd.Timestamp(b).to_pydatetime()) for a, b in want]
    assert all(a.tzinfo is oslo for a, _ in got)


@pytest.mark.parametrize("seed", [0, 7, 42])
def test_seeded_backoff_and_retry_after_draws_match(seed):
    def draws(module):
        module.seed_backoff_jitter(seed)
        out = [module.backoff_seconds(n, jitter=0.25) for n in range(1, 9)]
        out += [module.retry_after_seconds(r, jitter=0.25) for r in (0, 1, 2.5, 300)]
        out += [module.backoff_seconds(n) for n in (1, 2, 3, 7)]
        out += [module.backoff_seconds(3, jitter=0.5, rng=random.Random(seed))]
        return out

    assert draws(utils) == draws(jax_utils)


@pytest.mark.parametrize("value", [None, "3", "2.5", "-1", "inf", "nan", "86400", "Wed, 21 Oct",
                                   "", 7, 0])
def test_parse_retry_after_matches(value):
    assert io._parse_retry_after(value) == jax_io._parse_retry_after(value)


def _requests_response(status, body, headers):
    resp = requests.Response()
    resp.status_code = status
    resp._content = body
    resp.headers.update(headers)
    return resp


REPLIES = {
    "json-200": (200, b'{"a": 1}', {"Content-Type": "application/json"}),
    "json-charset-201": (201, b'{"a": [1]}', {"Content-Type": "application/json; charset=utf-8"}),
    "bytes-200": (200, b"\x1f\x8b tar", {"Content-Type": "application/octet-stream"}),
    "422": (422, b'{"message": "not a detector"}', {"Content-Type": "application/json"}),
    "410": (410, b'{"error": "gone"}', {}),
    "404": (404, b"<html>nf</html>", {"X-Gordo-Trace-Id": "ab" * 16}),
    "409": (409, b'{"error": "x", "unavailable": {"m": {"reason": "quarantined"}}}',
            {"X-Gordo-Trace-Id": "cd" * 16}),
    "409-transient": (409, b'{"transient": true, "unavailable": {"m": {"reason": "replica"}},'
                           b' "retry_after_s": 4}', {}),
    "409-transient-header": (409, b'{"transient": true}', {"Retry-After": "2"}),
    "409-not-json": (409, b"oops", {}),
    "400": (400, b'{"error": "bad"}', {}),
    "418": (418, b"teapot", {}),
    "503-retry": (503, b'{"error": "shed"}', {"Retry-After": "3"}),
    "503-date": (503, b"shed", {"Retry-After": "Wed, 21 Oct 2015 07:28:00 GMT"}),
    "503-bare": (503, b"down", {}),
    "500": (500, b"boom", {}),
    "302": (302, b"", {}),
}


def _outcome(call):
    try:
        return ("value", call())
    except Exception as exc:  # noqa: BLE001 - compared below
        return (type(exc).__name__, str(exc), getattr(exc, "unavailable", None),
                getattr(exc, "trace_id", None), getattr(exc, "retry_after", None),
                isinstance(exc, IOError))


@pytest.mark.parametrize("case", list(REPLIES))
@pytest.mark.parametrize("resource", [None, "Model listing"])
def test_handle_response_maps_statuses_as_jax(case, resource):
    status, body, headers = REPLIES[case]
    want = _outcome(lambda: jax_io.handle_response(_requests_response(status, body, headers),
                                                   resource_name=resource))
    got = _outcome(lambda: io.handle_response(
        Reply(status, {k.lower(): v for k, v in headers.items()}, body), resource_name=resource))
    assert got == want


def test_row_chunks_and_offsets_match():
    for n_rows, batch, min_rows in [(78, 40, 5), (81, 40, 5), (90, 40, 5), (90, 17, 32), (0, 10, 1),
                                    (5, 10, 1), (100, 1, 1), (33, 10, 8)]:
        assert client.Client._row_chunks(n_rows, batch, min_rows) == (
            jax_client.Client._row_chunks(n_rows, batch, min_rows))
    date = datetime(2019, 1, 1, 12, tzinfo=UTC)
    for resolution, n in [("15min", 5), ("10T", 12), ("1h", 3), ("1D", 2)]:
        assert client.Client._adjust_for_offset(date, resolution, n) == (
            jax_client.Client._adjust_for_offset(date, resolution, n))


@pytest.mark.parametrize("offset", [None, 0, 7])
def test_min_chunk_rows_matches(offset):
    meta = {} if offset is None else {"build_metadata": {"model": {"model_offset": offset}}}
    kwargs = dict(name="m", model={"gordo_tpu.models.AutoEncoder": {}}, project_name="p",
                  dataset={"type": "RandomDataset", "tag_list": ["a"], "asset": "gra",
                           "train_start_date": "2019-01-01T00:00:00+00:00",
                           "train_end_date": "2019-01-02T00:00:00+00:00"},
                  metadata=meta)
    assert client.Client._min_chunk_rows(Machine.unvalidated(**kwargs)) == (
        jax_client.Client._min_chunk_rows(JaxMachine.unvalidated(**kwargs)))


def test_cached_method_ttl_matches(monkeypatch):
    now = [1000.0]
    monkeypatch.setattr(time, "monotonic", lambda: now[0])

    def counting(module):
        class Thing:
            calls = 0

            @module.cached_method(maxsize=2, ttl=5)
            def get(self, key):
                Thing.calls += 1
                return (key, Thing.calls)

        thing, seen = Thing(), []
        for step, key in [(0, "a"), (1, "a"), (4, "b"), (5, "a"), (6, "a"), (6, "c"), (6, "b"),
                          (20, "c")]:
            now[0] = 1000.0 + step
            seen.append(thing.get(key))
        return seen, Thing.calls

    assert counting(utils) == counting(jax_utils)


@pytest.mark.parametrize("uri", ["admin:pw@localhost:8086/gordo", "u:p@h:80/api/v1/db",
                                 "a:b@c:1/x/y/z/db"])
def test_parse_influx_uri_matches(uri):
    assert utils.parse_influx_uri(uri) == jax_utils.parse_influx_uri(uri)


def test_prediction_result_is_the_jax_tuple():
    got = utils.PredictionResult("m", "frame", ["e"], revision="r1")
    want = jax_utils.PredictionResult("m", "frame", ["e"], revision="r1")
    assert tuple(got) == tuple(want) and got.revision == want.revision == "r1"
    import copy
    import pickle

    assert pickle.loads(pickle.dumps(got)).revision == copy.copy(got).revision == "r1"


def _reply_frame(n_rows, seed):
    rng = np.random.default_rng(seed)
    index = pd.date_range("2019-06-01", periods=n_rows, freq="10min", tz="UTC")
    columns = pd.MultiIndex.from_tuples(
        [("start", "start"), ("model-input", "a"), ("model-input", "b"), ("model-output", "a"),
         ("model-output", "b"), ("total-anomaly-scaled", "total-anomaly-scaled")])
    frame = pd.DataFrame(rng.normal(size=(n_rows, 6)), index=index, columns=columns)
    frame[("start", "start")] = [stamp.isoformat() for stamp in index]
    return frame


def test_reply_frames_read_and_join_as_the_jax_client():
    chunks = [_reply_frame(7, 1).iloc[3:], _reply_frame(7, 1).iloc[:3], _reply_frame(4, 2)]
    payloads = [json.loads(json.dumps(jax_server_utils.dataframe_to_dict(c))) for c in chunks]
    want = [jax_server_utils.dataframe_from_dict(p) for p in payloads]
    got = [frame_from_reply(p) for p in payloads]
    for g, w in zip(got, want):
        assert_frame_matches(g, w)
    # three chunks of one machine, one with the same stamps again
    joined = concat_frames(got[:2])
    assert_frame_matches(joined, pd.concat(want[:2]).sort_index())
    assert len(concat_frames([]).index) == 0


def test_a_frame_posts_the_jax_clients_json():
    index = pd.date_range("2019-06-01 00:00:00.5", periods=5, freq="10min", tz="UTC")
    values = np.random.default_rng(3).normal(size=(5, 2))
    values[2, 1] = np.nan
    want = jax_server_utils.dataframe_to_dict(pd.DataFrame(values, index=index,
                                                           columns=["x", "y"]))
    got = frame_to_dict(Frame(values, ["x", "y"], [t.to_pydatetime() for t in index]))
    assert json.dumps(got) == json.dumps(want)
    part = frame_to_dict(Frame(values, ["x", "y"], list(index.to_pydatetime())), slice(1, 3))
    assert json.dumps(part) == json.dumps({col: dict(list(d.items())[1:3])
                                           for col, d in want.items()})


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    served = []

    def do_GET(self):
        if self.path.startswith("/slow"):
            time.sleep(0.6)
        body = json.dumps({"path": self.path}).encode()
        _Handler.served.append(self.path)
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):
        pass


@pytest.fixture
def http_server():
    server = ThreadingHTTPServer(("127.0.0.1", 0), _Handler)
    server.daemon_threads = True
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_port}"
    server.shutdown()
    server.server_close()
    thread.join(timeout=10)


def test_a_pooled_connection_takes_each_calls_timeout(http_server):
    """The Step 0 repair: the router's pool kept the timeout a connection
    was opened with, so a replica call reusing a probe's connection
    (probes time out after at most 3 s) failed at the probe's bound."""
    transport = HttpTransport()
    try:
        assert transport.request("GET", f"{http_server}/fast", timeout=0.2).status == 200
        assert len(transport._idle[("http", "127.0.0.1", int(http_server.rsplit(":", 1)[1]))]) == 1
        reply = transport.request("GET", f"{http_server}/slow", timeout=5.0)
        assert reply.json() == {"path": "/slow"}
        # a read bound of None waits as long as the peer takes
        assert transport.request("GET", f"{http_server}/slow", timeout=(5.0, None)).status == 200
        _Handler.served.clear()
        with pytest.raises(TimeoutError):
            transport.request("GET", f"{http_server}/slow-again", timeout=0.1)
        time.sleep(0.8)
        assert _Handler.served == ["/slow-again"]  # sent once, never again
    finally:
        transport.close()


def test_unsupported_options_name_their_packages():
    with pytest.raises(ImportError, match="pyarrow"):
        client.Client("p", use_parquet=True)
    with pytest.raises(ImportError, match="influxdb"):
        ForwardPredictionsIntoInflux(destination_influx_uri="u:p@h:1/db")
    with pytest.raises(ImportError, match="influxdb"):
        utils.influx_client_from_uri("u:p@h:1/db")
    with pytest.raises(ImportError, match="pyarrow"):
        client.Client.dataframe_from_response(b"PAR1")
    assert math.isfinite(io.MAX_RETRY_AFTER_S) and io.MAX_RETRY_AFTER_S == jax_io.MAX_RETRY_AFTER_S
