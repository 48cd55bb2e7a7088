"""
The port's ``StreamPublisher`` (``gordo_tpu_torch.client.streaming``)
against the JAX publisher, both streaming to the port's server, a
process of its own on loopback HTTP (``tests/test_torch_fleet_serving.py``'s
flash Transformer detectors, lookback 8, and feedforward AutoEncoders):
the same rows in
the same updates give bitwise equal scores; a session the server closes
mid-stream, or a ``latest`` roll to another revision of the same
weights, makes the publisher reopen with its window tail and go on
exactly as the unbroken stream (``backoff_scale=0``: no sleeps); a shed
open is reported once its retries are spent; each outcome is counted in
``gordo_client_stream_requests_total``.
"""

import os
import shutil

import numpy as np
import pytest

from gordo_tpu.client import Client as JaxClient
from gordo_tpu_torch.client import Client
from gordo_tpu_torch.client.streaming import StreamBroken
from gordo_tpu_torch.observability import registry, tracing
from gordo_tpu_torch.server.app import build_app
from tests import torch_client_helpers as helpers
from tests.test_torch_fleet_serving import FF_TAGS, PROJECT, REVISION, TF_TAGS, fleet_collections

UPDATES = (5, 6, 3, 9, 14, 1, 7)
STREAMS = {"turbine-tf-0": TF_TAGS, "pump-ff-0": FF_TAGS}


@pytest.fixture(scope="module")
def collection(tmp_path_factory):
    _, port_dir = fleet_collections(tmp_path_factory.mktemp("client-streaming"))
    # a second revision of the same weights, and a `latest` link to the first
    shutil.copytree(port_dir, port_dir.parent / "1700000000002")
    os.symlink(REVISION, port_dir.parent / "latest")
    return port_dir.parent / "latest"


@pytest.fixture(scope="module")
def server(collection):
    served = helpers.ServerProcess(collection)
    yield served
    served.close()


@pytest.fixture(autouse=True)
def _first_revision(collection, monkeypatch):
    """Each test starts on the first revision, tracing off."""
    monkeypatch.delenv(tracing.TRACE_LOG_ENV_VAR, raising=False)
    yield
    if os.readlink(collection) != REVISION:
        os.remove(collection)
        os.symlink(REVISION, collection)


def _rows(name, seed=11):
    rng = np.random.default_rng(seed + len(name))
    return rng.normal(size=(sum(UPDATES), len(STREAMS[name])))


def _chunks(rows):
    out, start = [], 0
    for n in UPDATES:
        out.append(rows[start:start + n])
        start += n
    return out


def _stream(publisher_factory, name, interrupt=None):
    """Each update's scores, with ``interrupt(publisher)`` run before the
    fourth update."""
    scores = []
    with publisher_factory(name) as stream:
        for k, chunk in enumerate(_chunks(_rows(name))):
            if k == 3 and interrupt is not None:
                interrupt(stream)
            scores.append(stream.send(chunk))
        reconnects = stream.reconnects
    return scores, reconnects


def _port(server):
    return lambda name: Client(PROJECT, host="127.0.0.1", port=server.port, scheme="http",
                               n_retries=2).stream_machine(name, backoff_scale=0.0)


def _jax(server):
    return lambda name: JaxClient(PROJECT, host="127.0.0.1", port=server.port, scheme="http",
                                  n_retries=2).stream_machine(name, backoff_scale=0.0)


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", list(STREAMS))
def test_port_publisher_equals_the_jax_publisher(server, name):
    got, _ = _stream(_port(server), name)
    want, _ = _stream(_jax(server), name)
    _assert_same(got, want)
    # the windowed model warms for lookback - 1 rows
    assert sum(len(s) for s in got) == sum(UPDATES) - (7 if name.startswith("turbine") else 0)


def _close_out_of_band(server):
    def interrupt(stream):
        transport = Client(PROJECT, host="127.0.0.1", port=server.port, scheme="http").transport
        reply = transport.request(
            "POST", f"http://127.0.0.1:{server.port}/gordo/v0/{PROJECT}/stream/"
                    f"{stream.session_id}/close", body=b"{}", timeout=10)
        assert reply.status == 200
    return interrupt


def _roll_latest(collection):
    def interrupt(stream):
        tmp = collection.parent / ".latest-tmp"
        os.symlink("1700000000002", tmp)
        os.replace(tmp, collection)
    return interrupt


@pytest.mark.parametrize("name", list(STREAMS))
@pytest.mark.parametrize("how", ["closed", "rolled"])
def test_a_lost_session_resumes_as_the_unbroken_stream(server, collection, name, how):
    unbroken, _ = _stream(_port(server), name)
    interrupt = _close_out_of_band(server) if how == "closed" else _roll_latest(collection)
    before = registry.get_registry().snapshot().get("gordo_client_stream_requests_total", {})
    broken, reconnects = _stream(_port(server), name, interrupt)
    assert reconnects == 1
    _assert_same(broken, unbroken)
    after = registry.get_registry().snapshot()["gordo_client_stream_requests_total"]

    def resumed(snapshot):
        return sum(s["value"] for s in snapshot.get("series", [])
                   if s["labels"] == {"outcome": "resumed"})

    assert resumed(after) == resumed(before) + 1
    if how == "closed":
        # the JAX publisher resumes the same way, to the same scores
        jax_broken, jax_reconnects = _stream(_jax(server), name, _close_out_of_band(server))
        assert jax_reconnects == 1
        _assert_same(broken, jax_broken)


def test_a_shed_open_is_counted_and_reported(collection, monkeypatch):
    monkeypatch.delenv(tracing.TRACE_LOG_ENV_VAR, raising=False)
    server = helpers.HttpServer(build_app(str(collection), device="cpu", stream_max_sessions=1))
    try:
        client = Client(PROJECT, host="127.0.0.1", port=server.port, scheme="http", n_retries=0)
        with client.stream_machine("pump-ff-0", backoff_scale=0.0) as first:
            second = client.stream_machine("pump-ff-0", backoff_scale=0.0)
            with pytest.raises(StreamBroken, match="503"):
                second.open()
            assert second.sheds_honored == 1
            first.send(_rows("pump-ff-0")[:3])
        # the first session closed: a new one opens
        with client.stream_machine("pump-ff-0", backoff_scale=0.0) as third:
            assert len(third.send(_rows("pump-ff-0")[:2])) == 2
    finally:
        server.close()
