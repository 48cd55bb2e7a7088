"""
The port's sharded serving, replica side, on the CPU: the consistent-hash
ring (``gordo_tpu_torch.router.ring``), the shard manifest and
``ShardSpec`` (``server/catalog.py``), and a sharded replica of the
port's server against a sharded replica of the JAX server over the same
collection (a JAX artifact and its port copy for each machine):

- ring owners and preference lists equal JAX's ``HashRing`` for 1000
  names over 1-5 replicas at several vnode counts, and the ring's
  stability when a replica leaves or joins;
- the manifest file and the specs parsed from it equal JAX's;
- ``/models`` of each replica lists its shard, the 421 for a machine of
  another shard names the owner (single, fleet and stream routes), and the
  adopt header serves it; status codes and JSON keys as JAX's replicas';
- a replica's fleet scorer stacks its shard's machines only;
- the serving state needs a card unless asked for the CPU, and the
  router's view of a collection needs none.
"""

import json

import numpy as np
import pytest
import torch
from werkzeug.test import Client

from gordo_tpu.router.ring import HashRing as JaxHashRing
from gordo_tpu.server import build_app as jax_build_app
from gordo_tpu.server import utils as jax_server_utils
from gordo_tpu.server.catalog import ShardSpec as JaxShardSpec
from gordo_tpu.server.catalog import write_shard_manifest as jax_write_shard_manifest
from gordo_tpu_torch.device import resolve_device
from gordo_tpu_torch.router.ring import DEFAULT_VNODES, HashRing
from gordo_tpu_torch.server.app import build_app
from gordo_tpu_torch.server.catalog import (
    ADOPT_HEADER,
    CollectionView,
    ServingCatalog,
    ShardSpec,
    write_shard_manifest,
)
from gordo_tpu_torch.streaming import session as stream_session
from tests.test_torch_fleet_serving import (
    FF_TAGS,
    PROJECT,
    REVISION,
    TF_TAGS,
    fleet_body,
    frame_dict,
    jax_feedforward,
    jax_transformers,
    write_pair,
)

torch.set_num_threads(1)
TURBINES = [f"turbine-tf-{i}" for i in range(3)]
PUMPS = [f"pump-ff-{i}" for i in range(3)]
MACHINES = sorted(TURBINES + PUMPS)
REPLICAS = ["r0", "r1", "r2"]


def _names(n):
    return [f"machine-{i:03d}" for i in range(n)]


# -- the ring ----------------------------------------------------------------


@pytest.mark.parametrize("vnodes", [1, 8, DEFAULT_VNODES, 200])
@pytest.mark.parametrize("n_replicas", [1, 2, 3, 4, 5])
def test_ring_owners_and_preferences_equal_jax(n_replicas, vnodes):
    replicas = [f"replica-{i}" for i in range(n_replicas)][::-1]
    ours, theirs = HashRing(replicas, vnodes), JaxHashRing(replicas, vnodes)
    names = _names(1000)
    assert [ours.owner(n) for n in names] == [theirs.owner(n) for n in names]
    assert [ours.preference(n) for n in names[:200]] == [theirs.preference(n)
                                                         for n in names[:200]]
    assert ours.partition(names) == theirs.partition(names)
    assert ours.replicas == theirs.replicas == tuple(sorted(replicas))


def test_ring_stability_on_remove_and_add():
    names = _names(400)
    before = HashRing(["r0", "r1", "r2", "r3"])
    owners = {n: before.owner(n) for n in names}
    removed = HashRing(["r0", "r1", "r3"])
    for name in names:
        if owners[name] != "r2":
            assert removed.owner(name) == owners[name]  # survivors keep theirs
        else:
            assert removed.owner(name) != "r2"
    grown = HashRing(["r0", "r1", "r2", "r3", "r4"])
    moved = [n for n in names if grown.owner(n) != owners[n]]
    assert all(grown.owner(n) == "r4" for n in moved)
    assert len(moved) / len(names) <= 1 / 5 + 0.10


def test_ring_preference_is_owner_then_distinct_successors():
    ring = HashRing(["a", "b", "c", "d"])
    for name in _names(20):
        preference = ring.preference(name)
        assert preference[0] == ring.owner(name) and sorted(preference) == ["a", "b", "c", "d"]


def test_ring_rejects_degenerate_input():
    for args in (([],), (["a", "a"],), (["a"], 0)):
        with pytest.raises(ValueError):
            HashRing(*args)


# -- manifests ---------------------------------------------------------------


def test_manifest_and_spec_equal_jax(tmp_path):
    ours = write_shard_manifest(str(tmp_path / "port.json"), REPLICAS, vnodes=16)
    theirs = jax_write_shard_manifest(str(tmp_path / "jax.json"), REPLICAS, vnodes=16)
    assert open(ours).read() == open(theirs).read()
    spec, jax_spec = ShardSpec.load(ours, "r1"), JaxShardSpec.load(theirs, "r1")
    assert spec.to_dict() == jax_spec.to_dict()
    assert [spec.owns(n) for n in _names(100)] == [jax_spec.owns(n) for n in _names(100)]
    with_id = write_shard_manifest(str(tmp_path / "id.json"), REPLICAS, replica_id="r2")
    assert ShardSpec.load(with_id).replica_id == "r2"
    assert ShardSpec.load(with_id, "r0").replica_id == "r0"  # the flag wins
    with pytest.raises(ValueError, match="names no replica_id"):
        ShardSpec.load(ours)
    with pytest.raises(ValueError, match="not in the replica set"):
        ShardSpec.load(ours, "r9")


# -- sharded replicas against JAX's ------------------------------------------


def write_collections(root):
    """(JAX revision dir, port revision dir) of ``MACHINES``: three flash
    Transformer detectors and three feedforward AutoEncoders."""
    from gordo_tpu.models.anomaly import DiffBasedAnomalyDetector as JaxDetector
    import pandas as pd

    jax_dir, port_dir = root / "jax" / REVISION, root / "port" / REVISION
    rng = np.random.default_rng(31)
    for name, est in jax_transformers(3).items():
        X = rng.normal(size=(60, len(TF_TAGS))).astype("float32")
        detector = JaxDetector(base_estimator=est)
        detector.scaler.fit(X)
        detector.aggregate_threshold_ = 1.25 + 0.1 * int(name[-1])
        detector.feature_thresholds_ = pd.Series([0.7, 0.9, 1.1], name="fold-2")
        write_pair(jax_dir, port_dir, f"turbine-{name}", detector, TF_TAGS)
    for name, est in jax_feedforward(3).items():
        write_pair(jax_dir, port_dir, f"pump-{name}", est, FF_TAGS)
    return jax_dir, port_dir


@pytest.fixture(scope="module")
def collections(tmp_path_factory):
    return write_collections(tmp_path_factory.mktemp("shard-collections"))


@pytest.fixture(scope="module")
def replicas(collections, tmp_path_factory):
    """{rid: (JAX replica client, port replica app)} over one manifest."""
    jax_dir, port_dir = collections
    manifest = write_shard_manifest(str(tmp_path_factory.mktemp("manifest") / "m.json"), REPLICAS)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MODEL_COLLECTION_DIR", str(jax_dir))
        mp.delenv("GORDO_BATCH_WAIT_MS", raising=False)
        jax_server_utils.clear_caches()
        yield {rid: (Client(jax_build_app({"SHARD_MANIFEST": manifest, "REPLICA_ID": rid})),
                     build_app(str(port_dir), device="cpu", shard_manifest=manifest,
                               replica_id=rid))
               for rid in REPLICAS}
    jax_server_utils.clear_caches()


def port_call(app, method, path, body=None, headers=None):
    """(status, JSON body) of the port app."""
    headers = headers or {}
    reply = app.dispatch(method, path, lambda: json.dumps(body).encode() if body else b"",
                         content_type="application/json", adopt=ADOPT_HEADER in headers)
    return reply.status, json.loads(reply.body or b"null")


def jax_call(client, method, path, body=None, headers=None):
    reply = client.open(path, method=method, json=body, headers=headers or {})
    return reply.status_code, json.loads(reply.get_data() or b"null")


def keys_of(payload):
    """The JSON's key structure, values left out (machine names kept)."""
    if isinstance(payload, dict):
        return {key: keys_of(value) for key, value in payload.items()}
    return None


RING = HashRing(REPLICAS)


def test_models_list_each_replicas_shard(replicas):
    seen = []
    for rid, (jax_client, app) in replicas.items():
        want_status, want = jax_call(jax_client, "GET", f"/gordo/v0/{PROJECT}/models")
        status, got = port_call(app, "GET", f"/gordo/v0/{PROJECT}/models")
        assert status == want_status == 200
        assert got == want
        assert got["shard"] == {"replica_id": rid, "replicas": REPLICAS, "vnodes": 64}
        seen += got["models"]
    assert sorted(seen) == MACHINES  # a disjoint cover


def _wrong(machine):
    owner = RING.owner(machine)
    return owner, next(r for r in REPLICAS if r != owner)


@pytest.mark.parametrize("machine", [TURBINES[0], PUMPS[0]])
def test_single_machine_not_mine_421_and_adoption(replicas, machine):
    owner, wrong = _wrong(machine)
    jax_client, app = replicas[wrong]
    tags = TF_TAGS if machine in TURBINES else FF_TAGS
    frame = frame_dict(20, tags, 3)
    for route, body in (("prediction", {"X": frame}), ("anomaly/prediction",
                                                        {"X": frame, "y": frame})):
        path = f"/gordo/v0/{PROJECT}/{machine}/{route}"
        want_status, want = jax_call(jax_client, "POST", path, body)
        status, got = port_call(app, "POST", path, body)
        assert status == want_status == 421
        assert got == want
        assert got["wrong_shard"] == {machine: {"owner": owner}} and got["replica_id"] == wrong
        adopt = {ADOPT_HEADER: "failover"}
        want_status, want = jax_call(jax_client, "POST", path, body, adopt)
        status, got = port_call(app, "POST", path, body, adopt)
        if machine in PUMPS and route.startswith("anomaly"):
            assert status == want_status == 422  # not a detector: served, refused as such
        else:
            assert status == want_status == 200
        assert keys_of(got).keys() == keys_of(want).keys()


@pytest.mark.parametrize("route", ["prediction/fleet", "anomaly/prediction/fleet", "stream/open"])
def test_fleet_and_stream_routes_refuse_other_shards(replicas, route):
    names = TURBINES  # r2 owns them all but r0/r1 none
    jax_client, app = replicas["r0"]
    if route == "stream/open":
        body = {"machines": names}
    else:
        body = fleet_body(names, anomaly=route.startswith("anomaly"))
    path = f"/gordo/v0/{PROJECT}/{route}"
    want_status, want = jax_call(jax_client, "POST", path, body)
    status, got = port_call(app, "POST", path, body)
    assert status == want_status == 421
    assert got == want
    assert set(got["wrong_shard"]) == set(names)
    status, got = port_call(app, "POST", path, body, {ADOPT_HEADER: "failover"})
    assert status == (201 if route == "stream/open" else 200)


def test_a_replicas_scorer_stacks_its_shard_only(replicas):
    rid = RING.owner(TURBINES[0])
    _, app = replicas[rid]
    mine = sorted(RING.shard(MACHINES, rid))
    status, got = port_call(app, "POST", f"/gordo/v0/{PROJECT}/anomaly/prediction/fleet",
                            fleet_body(TURBINES[:1], anomaly=True))
    assert status == 200 and sorted(got["data"]) == TURBINES[:1]
    keys = [key[1] for key in app.catalog._fleet_scorers]
    assert tuple(mine) in keys and all(set(k) <= set(mine) for k in keys)


# -- the device of the serving state -----------------------------------------


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_serving_state_without_a_device_needs_the_card():
    with pytest.raises(RuntimeError) as want:
        resolve_device(None)
    for make in (ServingCatalog, stream_session.SessionManager, stream_session.device_headroom):
        with pytest.raises(RuntimeError) as err:
            make()
        assert str(err.value) == str(want.value)
    assert ServingCatalog(device="cpu").streams.device.type == "cpu"
    # the collection's view (what the router uses) holds no device
    view = CollectionView()
    assert view.list_machines("/nonexistent") == [] and view.unavailable_machines("/x") == {}


def test_run_server_passes_its_options_to_the_runner(monkeypatch, tmp_path):
    """``run-server --collection-dir ... --shard-manifest ... --replica-id``
    reaches the runner whole (the command's parser used to refuse an
    option as its first argument)."""
    from gordo_tpu_torch.cli import cli
    from gordo_tpu_torch.server import runner

    seen = []
    monkeypatch.setattr(runner, "main", seen.append)
    args = ["--collection-dir", str(tmp_path), "--device", "cpu", "--shard-manifest",
            str(tmp_path / "m.json"), "--replica-id", "r0"]
    assert cli.main(["run-server", *args]) == 0
    assert seen == [args]
