"""
The port's server against the JAX server on one collection of revisions:
revision selection (``?revision=``, the ``revision`` header and the 410
for a name it refuses), ``/revisions``, ``/expected-models`` and
``/download-model``; then ``gordo_tpu.client.Client`` predicting through
the port's server over HTTP.

The collection holds two sibling revisions (the older one served, the
newer one with other thresholds and a second machine), a dot directory,
a ``latest`` symlink and a loose file, for each package. Its machine is
an LSTM ``DiffBasedAnomalyDetector`` built by the JAX ``local_build`` and
carried over with ``gordo_tpu_torch.convert``. Tolerances: JSON values
rtol 1e-4 / atol 1e-5 (float32 nets in another summation order, as in
tests/test_torch_serving.py), everything else exactly.
"""

import json
import os
import shutil
import threading

import numpy as np
import pandas as pd
import pytest
from dateutil.parser import isoparse
from werkzeug.test import Client as WsgiClient

from gordo_tpu import serializer as jax_serializer
from gordo_tpu.builder import local_build
from gordo_tpu.client import Client as JaxClient
from gordo_tpu.data.providers.random_provider import RandomDataProvider
from gordo_tpu.serializer import into_definition
from gordo_tpu.server import build_app as jax_build_app
from gordo_tpu.server import utils as jax_server_utils
from gordo_tpu_torch import convert, serializer
from gordo_tpu_torch.server.app import build_app
from gordo_tpu_torch.server.runner import make_http_server
from tests.utils import loopback_session

PROJECT = "plant-b"
MACHINE = "lstm-a"
SECOND = "lstm-b"
OLD, NEW = "1700000000000", "1700000000001"
TAGS = ["tag-0", "tag-1", "tag-2"]
LOOKBACK = 6
RTOL, ATOL = 1e-4, 1e-5
CONFIG = f"""
machines:
  - name: {MACHINE}
    dataset:
      type: RandomDataset
      tags: {TAGS}
      target_tag_list: {TAGS}
      train_start_date: '2019-01-01T00:00:00+00:00'
      train_end_date: '2019-01-04T00:00:00+00:00'
      asset: gra
    model:
      gordo_tpu.models.anomaly.DiffBasedAnomalyDetector:
        base_estimator:
          gordo_tpu.models.KerasLSTMAutoEncoder:
            kind: lstm_hourglass
            lookback_window: {LOOKBACK}
            fused: true
            epochs: 1
"""


def _thresholds(detector):
    return {
        "aggregate_threshold_": detector.aggregate_threshold_,
        "feature_thresholds_": np.asarray(detector.feature_thresholds_),
    }


def _port_copy(jax_artifact, port_artifact):
    loaded = jax_serializer.load(jax_artifact)
    convert.write_artifact(
        port_artifact,
        params=loaded.base_estimator.params_,
        definition=into_definition(loaded),
        scaler_center=loaded.scaler.center_,
        scaler_scale=loaded.scaler.scale_,
        thresholds=_thresholds(loaded),
        metadata=jax_serializer.load_metadata(jax_artifact),
    )


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """{"jax": root, "port": root}, each holding OLD/ and NEW/ with the same
    machines, plus .staging/, a `latest` symlink to NEW and a loose file."""
    (model, machine), = local_build(CONFIG)
    base = tmp_path_factory.mktemp("revisions")
    roots = {"jax": base / "jax", "port": base / "port"}
    jax_old = roots["jax"] / OLD / MACHINE
    jax_serializer.dump(model, jax_old, metadata=machine.to_dict())
    # NEW: the same machine with other thresholds, and a second machine
    model.aggregate_threshold_ = 0.5 * float(model.aggregate_threshold_)
    model.feature_thresholds_ = 0.5 * model.feature_thresholds_
    for name in (MACHINE, SECOND):
        metadata = {**machine.to_dict(), "name": name}
        jax_serializer.dump(model, roots["jax"] / NEW / name, metadata=metadata)
    for revision, names in ((OLD, [MACHINE]), (NEW, [MACHINE, SECOND])):
        for name in names:
            _port_copy(roots["jax"] / revision / name, roots["port"] / revision / name)
    for root in roots.values():
        shutil.copytree(root / OLD, root / ".staging")
        os.symlink(NEW, root / "latest")
        (root / "notes.txt").write_text("not a revision")
    return roots


@pytest.fixture(scope="module")
def clients(roots):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MODEL_COLLECTION_DIR", str(roots["jax"] / OLD))
        mp.delenv("EXPECTED_MODELS", raising=False)
        jax_server_utils.clear_caches()
        yield (
            WsgiClient(jax_build_app()),
            WsgiClient(build_app(str(roots["port"] / OLD), device="cpu")),
        )
    jax_server_utils.clear_caches()


def _body(n_rows, seed):
    rng = np.random.default_rng(seed)
    index = pd.date_range("2019-06-01", periods=n_rows, freq="10min", tz="UTC")
    frame = pd.DataFrame(rng.normal(size=(n_rows, len(TAGS))), columns=TAGS, index=index)
    data = jax_server_utils.dataframe_to_dict(frame)
    return {"X": data, "y": data}


def _request(client, method, path, query, header, body=None):
    headers = {"revision": header} if header is not None else {}
    reply = client.open(
        path, method=method, query_string=query, headers=headers,
        json=body if method == "POST" else None,
    )
    return reply


def _assert_same(got, want, path="body"):
    if isinstance(want, dict):
        assert isinstance(got, dict), path
        assert set(got) == set(want), f"{path}: {sorted(set(got) ^ set(want))}"
        for key in want:
            _assert_same(got[key], want[key], f"{path}/{key}")
    elif isinstance(want, float):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=path)
    else:
        assert got == want, path


SELECTIONS = {
    "served": (None, None),
    "query-new": ({"revision": NEW}, None),
    "header-new": (None, NEW),
    "query-old": ({"revision": OLD}, None),
    "query-over-header": ({"revision": NEW}, OLD),
    "empty-query-then-header": ({"revision": ""}, NEW),
}


@pytest.mark.parametrize("selection", list(SELECTIONS))
@pytest.mark.parametrize(
    "method,route",
    [
        ("GET", "models"),
        ("GET", f"{MACHINE}/metadata"),
        ("POST", f"{MACHINE}/prediction"),
        ("POST", f"{MACHINE}/anomaly/prediction"),
    ],
)
def test_revision_selection_matches_jax(clients, selection, method, route):
    query, header = SELECTIONS[selection]
    body = _body(40, seed=1) if method == "POST" else None
    path = f"/gordo/v0/{PROJECT}/{route}"
    replies = [_request(c, method, path, query, header, body) for c in clients]
    want, got = (json.loads(r.get_data()) for r in replies)
    assert replies[1].status_code == replies[0].status_code == 200
    expected = (query or {}).get("revision") or header or OLD
    assert got["revision"] == want["revision"] == expected
    assert replies[1].headers["revision"] == replies[0].headers["revision"] == expected
    if route.endswith("metadata"):
        # `env` names each server's own collection directory
        assert got["metadata"] == want["metadata"]
        assert set(got) == set(want)
    else:
        # wall times differ
        assert ("time-seconds" in got) == ("time-seconds" in want)
        got.pop("time-seconds", None), want.pop("time-seconds", None)
        _assert_same(got, want)
    if route == "models":
        assert got["models"] == ([MACHINE, SECOND] if expected == NEW else [MACHINE])


def test_selected_revision_is_served_not_stamped(clients):
    """The two revisions' thresholds differ, so their anomaly frames do."""
    _, port = clients
    path = f"/gordo/v0/{PROJECT}/{MACHINE}/anomaly/prediction"
    old, new = (
        json.loads(_request(port, "POST", path, query, None, _body(40, seed=2)).get_data())
        for query in (None, {"revision": NEW})
    )
    assert old["data"]["total-anomaly-confidence"] != new["data"]["total-anomaly-confidence"]
    assert old["data"]["total-anomaly-scaled"] == new["data"]["total-anomaly-scaled"]


@pytest.mark.parametrize("name", [".staging", "latest", "notes.txt", "missing", "../" + NEW,
                                  "a\\b", ".."])
@pytest.mark.parametrize("how", ["query", "header"])
@pytest.mark.parametrize("route", ["models", f"{MACHINE}/metadata", "revisions"])
def test_refused_revision_answers_410_as_jax(clients, name, how, route):
    query, header = ({"revision": name}, None) if how == "query" else (None, name)
    path = f"/gordo/v0/{PROJECT}/{route}"
    want, got = (_request(c, "GET", path, query, header) for c in clients)
    assert got.status_code == want.status_code == 410
    assert json.loads(got.get_data()) == json.loads(want.get_data()) == {
        "error": f"Revision '{name}' not found."
    }
    assert "revision" not in got.headers and "revision" not in want.headers


@pytest.mark.parametrize("selection", ["served", "query-new", "header-new"])
def test_revisions_route_matches_jax(clients, selection):
    query, header = SELECTIONS[selection]
    path = f"/gordo/v0/{PROJECT}/revisions"
    want, got = (json.loads(_request(c, "GET", path, query, header).get_data()) for c in clients)
    assert sorted(want["available-revisions"]) == got["available-revisions"] == [OLD, NEW]
    assert got["latest"] == want["latest"] == OLD
    assert got["revision"] == want["revision"]


@pytest.mark.parametrize("expected", [None, ["lstm-a", "pump-9"], []])
def test_expected_models_matches_jax(clients, expected, monkeypatch):
    if expected is None:
        monkeypatch.delenv("EXPECTED_MODELS", raising=False)
    else:
        monkeypatch.setenv("EXPECTED_MODELS", json.dumps(expected))
    path = f"/gordo/v0/{PROJECT}/expected-models"
    want, got = (json.loads(c.get(path).get_data()) for c in clients)
    assert got == want == {"expected-models": expected or [], "revision": OLD}


@pytest.mark.parametrize("selection", ["served", "query-new"])
def test_download_model_predicts_as_served(clients, roots, selection):
    query, header = SELECTIONS[selection]
    path = f"/gordo/v0/{PROJECT}/{MACHINE}/download-model"
    want, got = (_request(c, "GET", path, query, header) for c in clients)
    assert got.status_code == want.status_code == 200
    for key in ("Content-Disposition", "revision"):
        assert got.headers[key] == want.headers[key]
    assert got.headers["Content-Type"] == "application/octet-stream"
    model = serializer.loads(got.get_data(), device="cpu")
    revision = (query or {}).get("revision", OLD)
    served = serializer.load(roots["port"] / revision / MACHINE, device="cpu")
    X = _body(30, seed=3)
    frame = pd.DataFrame(X["X"]).to_numpy(np.float32)
    np.testing.assert_array_equal(model.predict(frame), served.predict(frame))
    np.testing.assert_array_equal(model.aggregate_threshold_, served.aggregate_threshold_)
    missing = f"/gordo/v0/{PROJECT}/nope/download-model"
    assert [c.get(missing).status_code for c in clients] == [404, 404]


@pytest.fixture(scope="module")
def port_http(roots):
    """The port's server over HTTP on the CPU, in a thread: its base URL
    parts (host, port)."""
    server = make_http_server(build_app(str(roots["port"] / OLD), device="cpu"), "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield "127.0.0.1", server.server_port
    server.shutdown()
    server.server_close()
    thread.join()


@pytest.mark.parametrize("revision", [None, NEW])
def test_jax_client_predicts_through_the_port(clients, port_http, revision):
    """The reference client asks /revisions, lists the models, reads each
    machine's metadata and posts its data to /anomaly/prediction; the
    frames it assembles from the port's server equal those it assembles
    from the JAX server on the same data."""
    host, port = port_http
    start, end = isoparse("2019-02-01T00:00:00+00:00"), isoparse("2019-02-01T12:00:00+00:00")
    common = dict(project=PROJECT, scheme="http", data_provider=RandomDataProvider(),
                  parallelism=1)
    via_port = JaxClient(host=host, port=port, **common)
    via_jax = JaxClient(
        host="localhost", port=8888, session=loopback_session(clients[0].application), **common
    )
    assert via_port.get_revisions()["latest"] == OLD
    got = via_port.predict(start, end, revision=revision)
    want = via_jax.predict(start, end, revision=revision)
    assert [r[0] for r in got] == [r[0] for r in want] == (
        [MACHINE, SECOND] if revision == NEW else [MACHINE]
    )
    for (name, frame, errors), (_, want_frame, want_errors) in zip(got, want):
        assert errors == want_errors == []
        assert list(frame.columns) == list(want_frame.columns)
        assert len(frame) > 0 and frame.index.equals(want_frame.index)
        stamps = [c for c in want_frame.columns if c[0] in ("start", "end")]
        assert stamps and frame[stamps].equals(want_frame[stamps])
        numbers = [c for c in want_frame.columns if c not in stamps]
        np.testing.assert_allclose(
            frame[numbers].to_numpy(np.float64), want_frame[numbers].to_numpy(np.float64),
            rtol=RTOL, atol=ATOL,
        )
    assert all(r.revision == (revision or OLD) for r in got)
    downloaded = via_port.session.get(
        f"http://{host}:{port}/gordo/v0/{PROJECT}/{MACHINE}/download-model"
    )
    assert downloaded.status_code == 200
    assert serializer.loads(downloaded.content, device="cpu").base_estimator.lookback_window == (
        LOOKBACK
    )
