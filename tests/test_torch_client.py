"""
The port's client (``gordo_tpu_torch.client``) against the JAX client on
a collection built by the JAX ``local_build`` and converted
(``tests/torch_client_helpers.py``: a flash Transformer detector, a
feedforward detector and a bare AutoEncoder).

- On the port's server over loopback HTTP, the two clients with the same
  ``RandomDataProvider(seed)``, span, ``batch_size`` (several chunks a
  machine) and ``parallelism=2`` give EQUAL frames, labels and values:
  ``predict``, ``predict_fleet``, a pinned revision, ``get_metadata``,
  ``get_revisions`` and ``get_machine_names``; the bare AutoEncoder goes
  through the 422 fallback in both; a quarantined machine's 409 gives
  both the same error messages. ``download_model`` gives models that
  predict as the served ones.
- The whole slice: the JAX client on the JAX server (Pallas in interpret
  mode) against the port's client on the port's server, rtol 1e-4 /
  atol 1e-5 (the server JSON tolerance, ``PERF.md`` §2).
- A 503 with ``Retry-After`` (a stub WSGI app in front of the port's app,
  no fault injection) is retried after the advertised wait, and every
  attempt of the chunk carries one ``traceparent``; the server's
  ``server.request`` span is the child of the client's ``client.request``.

Every test clears or sets ``GORDO_TPU_TRACE_LOG`` itself.
"""

import json
import os
from datetime import datetime

import numpy as np
import pytest

from gordo_tpu.client import Client as JaxClient
from gordo_tpu.data.providers.random_provider import RandomDataProvider as JaxRandomDataProvider
from gordo_tpu.server import build_app as jax_build_app
from gordo_tpu.server import utils as jax_server_utils
from gordo_tpu_torch import serializer
from gordo_tpu_torch.client import Client
from gordo_tpu_torch.data.providers import RandomDataProvider
from gordo_tpu_torch.observability import registry, tracing
from gordo_tpu_torch.server.app import build_app
from tests import torch_client_helpers as helpers
from tests.utils import loopback_session

START, END = datetime.fromisoformat(helpers.START), datetime.fromisoformat(helpers.END)
SEED = 3
CASUALTY_REVISION = "1700000000001"


@pytest.fixture(scope="module")
def collections(tmp_path_factory):
    jax_dir, port_dir = helpers.build_collections(tmp_path_factory.mktemp("client"))
    for directory in (jax_dir, port_dir):
        helpers.add_casualty_revision(directory, CASUALTY_REVISION, helpers.FF)
    return jax_dir, port_dir


@pytest.fixture(scope="module")
def port_http(collections):
    with pytest.MonkeyPatch.context() as mp:
        for var in ("GORDO_BATCH_WAIT_MS", tracing.TRACE_LOG_ENV_VAR, "ENABLE_PROMETHEUS"):
            mp.delenv(var, raising=False)
        server = helpers.ServerProcess(collections[1])
        yield server
        server.close()


def _clients(port, **kwargs):
    common = dict(host="127.0.0.1", port=port, scheme="http", batch_size=20, parallelism=2,
                  n_retries=1, **kwargs)
    return (Client(helpers.PROJECT, data_provider=RandomDataProvider(seed=SEED), **common),
            JaxClient(helpers.PROJECT, data_provider=JaxRandomDataProvider(seed=SEED), **common))


@pytest.fixture
def quiet(monkeypatch):
    monkeypatch.delenv(tracing.TRACE_LOG_ENV_VAR, raising=False)


@pytest.mark.parametrize("how", ["predict", "predict_fleet"])
@pytest.mark.parametrize("revision", [None, helpers.REVISION])
def test_port_client_equals_jax_client_on_the_port_server(port_http, how, revision, quiet):
    port_client, jax_client = _clients(port_http.port)
    kwargs = {"group_size": 4} if how == "predict_fleet" else {}
    got = getattr(port_client, how)(START, END, revision=revision, **kwargs)
    want = getattr(jax_client, how)(START, END, revision=revision, **kwargs)
    helpers.assert_results_match(got, want)
    assert [r.name for r in got] == helpers.MACHINES
    # three chunks a machine; the windowed model's raw rows start
    # model_offset rows earlier, and each of its chunks lacks its first
    # model_offset rows, as the JAX client's do
    frames = {r.name: r.predictions for r in got}
    offset = helpers.LOOKBACK - 1
    assert len(frames[helpers.TF].index) == len(frames[helpers.FF].index) + offset - 3 * offset
    assert port_client._fallback_machines == jax_client._fallback_machines == {helpers.RAW}
    assert list(frames[helpers.RAW].blocks) == ["start", "end", "model-input", "model-output"]


def test_targets_metadata_revisions_and_names_equal_jax(port_http, quiet):
    port_client, jax_client = _clients(port_http.port)
    assert port_client.get_revisions() == jax_client.get_revisions()
    assert port_client.get_machine_names() == jax_client.get_machine_names() == helpers.MACHINES
    assert (port_client.get_machine_names(revision=CASUALTY_REVISION)
            == jax_client.get_machine_names(revision=CASUALTY_REVISION))
    got = port_client.get_metadata()
    want = jax_client.get_metadata()
    assert set(got) == set(want)
    for name in want:
        assert json.dumps(got[name].to_dict(), sort_keys=True, default=str) == json.dumps(
            want[name].to_dict(), sort_keys=True, default=str)
    got = port_client.predict(START, END, targets=[helpers.TF])
    want = jax_client.predict(START, END, targets=[helpers.TF])
    helpers.assert_results_match(got, want)


def test_downloaded_models_predict_as_the_served_ones(port_http, collections, quiet):
    port_client, _ = _clients(port_http.port)
    models = port_client.download_model(targets=[helpers.TF, helpers.FF], device="cpu")
    X = np.random.default_rng(0).normal(size=(30, 4)).astype(np.float32)
    for name, width in ((helpers.TF, 3), (helpers.FF, 4)):
        served = serializer.load(collections[1] / name, device="cpu")
        np.testing.assert_array_equal(models[name].predict(X[:, :width]),
                                      served.predict(X[:, :width]))
    assert set(port_client.download_archives()) == set(helpers.MACHINES)


@pytest.mark.parametrize("how", ["predict", "predict_fleet"])
def test_a_quarantined_machine_is_reported_as_the_jax_client_reports_it(port_http, how, quiet):
    port_client, jax_client = _clients(port_http.port)
    kwargs = dict(revision=CASUALTY_REVISION, targets=[helpers.FF, helpers.TF])
    if how == "predict_fleet":
        kwargs["group_size"] = 4
    got = getattr(port_client, how)(START, END, **kwargs)
    want = getattr(jax_client, how)(START, END, **kwargs)
    assert [(r.name, r.error_messages, r.revision) for r in got] == [
        (r.name, r.error_messages, r.revision) for r in want]
    by_name = {r.name: r for r in got}
    assert by_name[helpers.FF].error_messages and not by_name[helpers.TF].error_messages
    assert "quarantined" in by_name[helpers.FF].error_messages[0]
    helpers.assert_frame_matches(by_name[helpers.TF].predictions,
                                 {r.name: r for r in want}[helpers.TF].predictions)


@pytest.mark.parametrize("how", ["predict", "predict_fleet"])
def test_the_slice_matches_the_jax_client_on_the_jax_server(port_http, collections, how,
                                                             monkeypatch):
    monkeypatch.delenv(tracing.TRACE_LOG_ENV_VAR, raising=False)
    monkeypatch.delenv("GORDO_BATCH_WAIT_MS", raising=False)
    monkeypatch.setenv("MODEL_COLLECTION_DIR", str(collections[0]))
    jax_server_utils.clear_caches()
    port_client, _ = _clients(port_http.port)
    jax_client = JaxClient(helpers.PROJECT, host="localhost", port=8888, scheme="http",
                           data_provider=JaxRandomDataProvider(seed=SEED), batch_size=20,
                           parallelism=2, session=loopback_session(jax_build_app()))
    kwargs = {"group_size": 4} if how == "predict_fleet" else {}
    got = getattr(port_client, how)(START, END, **kwargs)
    want = getattr(jax_client, how)(START, END, **kwargs)
    helpers.assert_results_match(got, want, rtol=helpers.RTOL, atol=helpers.ATOL)
    jax_server_utils.clear_caches()


class _SheddingOnce:
    """A WSGI app in front of the port's app that answers the first
    prediction POST with a 503 and ``Retry-After: 0``, and records each
    prediction POST's ``traceparent``."""

    def __init__(self, app):
        self.app = app
        self.shed = 0
        self.traceparents = []

    def __call__(self, environ, start_response):
        if environ["REQUEST_METHOD"] == "POST" and "prediction" in environ["PATH_INFO"]:
            self.traceparents.append(environ.get("HTTP_TRACEPARENT"))
            if not self.shed:
                self.shed += 1
                length = int(environ.get("CONTENT_LENGTH") or 0)
                environ["wsgi.input"].read(length)
                body = b'{"error": "shed", "retry_after_s": 0}'
                start_response("503 SERVICE UNAVAILABLE", [
                    ("Content-Type", "application/json"), ("Content-Length", str(len(body))),
                    ("Retry-After", "0")])
                return [body]
        return self.app(environ, start_response)


def test_a_shed_chunk_is_retried_after_retry_after_under_one_trace(collections, tmp_path,
                                                                   monkeypatch):
    spans = tmp_path / "spans.jsonl"
    monkeypatch.setenv(tracing.TRACE_LOG_ENV_VAR, str(spans))
    monkeypatch.delenv("GORDO_BATCH_WAIT_MS", raising=False)
    stub = _SheddingOnce(build_app(str(collections[1]), device="cpu"))
    server = helpers.HttpServer(stub)
    try:
        port_client = Client(helpers.PROJECT, host="127.0.0.1", port=server.port, scheme="http",
                             data_provider=RandomDataProvider(seed=SEED), batch_size=1000,
                             parallelism=1, n_retries=2)
        snapshot = registry.get_registry().snapshot()
        retries = {tuple(s["labels"].items()): s["value"]
                   for s in snapshot.get("gordo_client_retries_total", {}).get("series", [])}
        (result,) = port_client.predict(START, END, targets=[helpers.FF])
    finally:
        server.close()
    assert result.error_messages == [] and len(result.predictions.index) > 0
    assert stub.shed == 1 and len(stub.traceparents) == 2
    assert stub.traceparents[0] == stub.traceparents[1] is not None
    after = registry.get_registry().snapshot()["gordo_client_retries_total"]["series"]
    assert {tuple(s["labels"].items()): s["value"] for s in after}[(("path", "single"),)] == (
        retries.get((("path", "single"),), 0.0) + 1)
    records = tracing.read_spans(str(spans))
    (request,) = [r for r in records if r["name"] == "client.request"]
    trace = [r for r in records if r["trace_id"] == request["trace_id"]]
    names = sorted(r["name"] for r in trace)
    # the shed attempt never reached the app: one server.request, under
    # the chunk's one client.request, in the run's one trace
    assert names.count("server.request") == 1 and names.count("client.request") == 1
    assert {"client.predict", "client.predict_machine"} <= set(names)
    (served,) = [r for r in trace if r["name"] == "server.request"]
    assert served["parent_span_id"] == request["span_id"]
    assert stub.traceparents[0].split("-")[1:3] == [request["trace_id"], request["span_id"]]
    by_name = {r["name"]: r for r in trace}
    assert by_name["client.predict_machine"]["parent_span_id"] == (
        by_name["client.predict"]["span_id"])
    assert request["parent_span_id"] == by_name["client.predict_machine"]["span_id"]
    assert os.environ[tracing.TRACE_LOG_ENV_VAR] == str(spans)
