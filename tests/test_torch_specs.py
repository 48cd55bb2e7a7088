"""
``GET /gordo/v0/specs.json`` and ``GET /server-version`` of the port's
server against the JAX server's: the OpenAPI documents agree path for
path on every route the port serves (operation ids, summaries, path
parameters, responses), the port lists no route the JAX server lacks,
and the JAX routes the port leaves out are the ones ROADMAP.md names.
"""

import json

import pytest
from werkzeug.test import Client

from gordo_tpu.server import build_app as jax_build_app
from gordo_tpu.server import utils as jax_server_utils
from gordo_tpu_torch import __version__
from gordo_tpu_torch.server.app import build_app

#: the JAX routes the port does not serve yet (ROADMAP.md queue 1 item 9)
NOT_PORTED = {"/metrics", "/telemetry/snapshot"}


@pytest.fixture(scope="module")
def documents(tmp_path_factory):
    collection = tmp_path_factory.mktemp("specs") / "rev-1"
    collection.mkdir()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MODEL_COLLECTION_DIR", str(collection))
        jax_server_utils.clear_caches()
        jax_client = Client(jax_build_app())
        want = jax_client.get("/gordo/v0/specs.json")
        jax_version = jax_client.get("/server-version")
    jax_server_utils.clear_caches()
    app = build_app(str(collection), device="cpu")
    got = app.dispatch("GET", "/gordo/v0/specs.json", lambda: b"")
    version = app.dispatch("GET", "/server-version", lambda: b"")
    return (json.loads(want.get_data()), want, json.loads(got.body), got,
            json.loads(jax_version.get_data()), json.loads(version.body))


def test_every_port_path_equals_jax(documents):
    want, _, got, reply, _, _ = documents
    assert reply.status == 200 and reply.mimetype == "application/json"
    assert got["openapi"] == want["openapi"] == "3.0.3"
    assert got["info"] == want["info"]
    for path, operations in got["paths"].items():
        assert operations == want["paths"][path], path


def test_the_port_lists_every_jax_route_but_the_unported(documents):
    want, _, got, _, _, _ = documents
    assert set(got["paths"]) <= set(want["paths"])
    assert set(want["paths"]) - set(got["paths"]) == NOT_PORTED


def test_shared_views_get_numbered_operation_ids(documents):
    _, _, got, _, _, _ = documents
    ids = [op["operationId"] for ops in got["paths"].values() for op in ops.values()]
    assert len(ids) == len(set(ids))
    assert got["paths"]["/gordo/v0/{gordo_project}/{gordo_name}/healthcheck"]["get"][
        "operationId"] == "metadata_2"
    update = got["paths"]["/gordo/v0/{gordo_project}/stream/{stream_id}/update"]["post"]
    assert [p["name"] for p in update["parameters"]] == ["gordo_project", "stream_id"]


def test_the_document_keeps_its_schema(documents):
    """No revision key in the document's body (it rides the header), as
    in JAX."""
    want, jax_reply, got, reply, _, _ = documents
    assert "revision" not in got and "revision" not in want
    assert reply.headers["revision"] == jax_reply.headers["revision"] == "rev-1"


def test_server_version(documents):
    _, _, _, _, jax_version, version = documents
    assert version == jax_version == {"version": __version__, "revision": "rev-1"}
