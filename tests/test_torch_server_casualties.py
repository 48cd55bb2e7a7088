"""
Casualties of a fleet build on the port's server against the JAX
server's: a ``build-fleet`` collection of ``examples/machines_fleet.yaml``
where one machine's fetch failed (``--on-error skip``) and one went
non-finite in its final fit (quarantined: its artifact holds its last
finite weights). Both servers read the same ``build_report.json``: the
same ``/models`` body (casualties under ``unavailable``), and the same 409
body on ``/prediction``, ``/anomaly/prediction`` and both fleet routes;
the healthy machines still answer 200 on the port's server.
"""

import json

import numpy as np
import pytest
from werkzeug.test import Client

from gordo_tpu.server import build_app as jax_build_app
from gordo_tpu.server import utils as jax_server_utils
from gordo_tpu_torch.builder.fleet_build import FleetModelBuilder
from gordo_tpu_torch.cli import cli
from gordo_tpu_torch.server.app import build_app
from tests.test_torch_fleet_env import clear_fleet_env

PROJECT = "example-fleet"
FAILED, QUARANTINED = "example-pump-1", "example-compressor-1"
HEALTHY = ["example-compressor-0", "example-pump-0"]


def _casualty_fetch(original):
    def fetch(self, machine):
        if machine.name == FAILED:
            raise ConnectionError("simulated outage")
        item = original(self, machine)
        if machine.name == QUARANTINED:
            X = np.asarray(item["X"], dtype=np.float64).copy()
            X[3, 0] = np.nan  # every loss of this machine is NaN
            item["X"], item["y"] = X, X
        return item
    return fetch


@pytest.fixture(scope="module")
def casualty_clients(tmp_path_factory):
    revision = tmp_path_factory.mktemp("casualties") / "1700000000000"
    with pytest.MonkeyPatch.context() as mp:
        clear_fleet_env(mp)
        mp.setattr(FleetModelBuilder, "_fetch_one", _casualty_fetch(FleetModelBuilder._fetch_one))
        code = cli.main(["build-fleet", open("examples/machines_fleet.yaml").read(),
                         str(revision), "--device", "cpu", "--on-error", "skip",
                         "--fetch-retries", "0"])
    assert code == 0
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MODEL_COLLECTION_DIR", str(revision))
        jax_server_utils.clear_caches()
        yield revision, Client(jax_build_app()), Client(build_app(str(revision), device="cpu"))
    jax_server_utils.clear_caches()


def _reply(client, method, path, body=None):
    reply = client.open(path, method=method, json=body)
    return reply.status_code, json.loads(reply.get_data())


def _rows(n=12):
    return np.random.default_rng(3).normal(size=(n, 3)).tolist()


def test_report_records_both_casualties(casualty_clients):
    revision, _, _ = casualty_clients
    report = json.loads((revision / "build_report.json").read_text())
    assert [r["machine"] for r in report["failed"]] == [FAILED]
    assert [r["machine"] for r in report["quarantined"]] == [QUARANTINED]
    assert (revision / QUARANTINED).is_dir() and not (revision / FAILED).exists()


def test_models_lists_casualties_as_unavailable_as_jax_does(casualty_clients):
    _, jax_client, port_client = casualty_clients
    path = f"/gordo/v0/{PROJECT}/models"
    got, want = _reply(port_client, "GET", path), _reply(jax_client, "GET", path)
    assert got == want
    assert got[1]["models"] == HEALTHY
    assert got[1]["unavailable"][QUARANTINED]["reason"] == "quarantined"
    assert got[1]["unavailable"][FAILED]["reason"] == "fetch_failed"


@pytest.mark.parametrize("machine", [FAILED, QUARANTINED])
@pytest.mark.parametrize("route", ["prediction", "anomaly/prediction"])
def test_single_machine_routes_answer_409_as_jax_does(casualty_clients, machine, route):
    _, jax_client, port_client = casualty_clients
    path = f"/gordo/v0/{PROJECT}/{machine}/{route}"
    body = {"X": _rows(), "y": _rows()}
    got, want = _reply(port_client, "POST", path, body), _reply(jax_client, "POST", path, body)
    assert got == want
    assert got[0] == 409 and set(got[1]["unavailable"]) == {machine}


@pytest.mark.parametrize("route", ["prediction/fleet", "anomaly/prediction/fleet"])
def test_fleet_routes_answer_409_as_jax_does(casualty_clients, route):
    _, jax_client, port_client = casualty_clients
    path = f"/gordo/v0/{PROJECT}/{route}"
    names = HEALTHY + [QUARANTINED, FAILED]
    if route.startswith("anomaly"):
        body = {"machines": {n: {"X": _rows(), "y": _rows()} for n in names}}
    else:
        body = {"machines": {n: _rows() for n in names}}
    got, want = _reply(port_client, "POST", path, body), _reply(jax_client, "POST", path, body)
    assert got == want
    assert got[0] == 409 and set(got[1]["unavailable"]) == {QUARANTINED, FAILED}


def test_healthy_machines_still_serve(casualty_clients):
    _, _, port_client = casualty_clients
    status, reply = _reply(port_client, "POST", f"/gordo/v0/{PROJECT}/prediction/fleet",
                           {"machines": {n: _rows() for n in HEALTHY}})
    assert status == 200 and set(reply["data"]) == set(HEALTHY)
    for name in HEALTHY:
        status, _ = _reply(port_client, "POST", f"/gordo/v0/{PROJECT}/{name}/prediction",
                           {"X": _rows()})
        assert status == 200
