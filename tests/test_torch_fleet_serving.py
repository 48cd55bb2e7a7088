"""
Fleet serving: the port's ``FleetScorer`` (``gordo_tpu_torch.server.
fleet_serving``) and its two fleet routes against the JAX package's on the
same weights (JAX estimators fitted, carried over with
``gordo_tpu_torch.convert``) and the same numpy-seeded inputs.

Tolerances: scorer outputs rtol 1e-5 / atol 1e-6 (float32 nets in
another summation order); route JSON rtol 1e-4 / atol 1e-5, as
tests/test_torch_serving.py holds the single-machine routes; error
bodies exactly, apart from the bad-width message, whose column list the
JAX server writes as a pandas Index (status and prefix compared there).
The Transformers serve with ``attention_impl: flash``: JAX's kernel in
interpret mode, the port's plain version.
"""

import copy
import html
import json

import numpy as np
import pandas as pd
import pytest
import torch
from werkzeug.test import Client

from gordo_tpu import serializer as jax_serializer
from gordo_tpu.builder.fleet_build import _find_jax_estimator
from gordo_tpu.models import AutoEncoder as JaxAutoEncoder
from gordo_tpu.models import TransformerAutoEncoder as JaxTransformerAutoEncoder
from gordo_tpu.models.anomaly import DiffBasedAnomalyDetector as JaxDetector
from gordo_tpu.serializer import into_definition
from gordo_tpu.server import build_app as jax_build_app
from gordo_tpu.server import utils as jax_server_utils
from gordo_tpu.server.fleet_serving import FleetScorer as JaxFleetScorer
from gordo_tpu.server.fleet_serving import fleet_scorer_from_models as jax_scorer_from_models
from gordo_tpu_torch import convert
from gordo_tpu_torch.models import AutoEncoder
from gordo_tpu_torch.server.app import build_app
from gordo_tpu_torch.server.catalog import ServingCatalog
from gordo_tpu_torch.server.fleet_serving import (
    FleetScorer,
    fleet_scorer_from_models,
    group_key,
    pow2_bucket,
)

torch.set_num_threads(1)

PROJECT = "plant-fleet"
REVISION = "1700000000000"
RTOL, ATOL = 1e-5, 1e-6
ROUTE_RTOL, ROUTE_ATOL = 1e-4, 1e-5
LOOKBACK = 8
FF_TAGS = ["GRA-PUMP-FLOW 1", "GRA-PUMP-TEMP 2", "GRA-PUMP-PRES 3", "GRA-PUMP-VIB 4"]
TF_TAGS = ["GRA-TURB-SPEED 1", "GRA-TURB-TEMP 2", "GRA-TURB-LOAD 3"]
TRANSFORMER = dict(kind="transformer_model", lookback_window=LOOKBACK, d_model=16, n_heads=2,
                   n_layers=1, epochs=1, batch_size=64)


def with_flash(est):
    """A copy of a fitted JAX Transformer estimator that serves with the
    flash kernel (trained dense: the parameter tree is the same)."""
    flash = copy.copy(est)
    flash.kwargs = dict(est.kwargs, attention_impl="flash")
    flash.spec_ = flash._build_spec()
    flash._apply_fn = None
    return flash


def jax_feedforward(n, n_features=4, rows=60, seed=5):
    """n fitted JAX AutoEncoders, machine i of seed i."""
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(n):
        X = rng.random((rows, n_features)).astype("float32")
        out[f"ff-{i}"] = JaxAutoEncoder(kind="feedforward_hourglass", epochs=1, seed=i).fit(X, X)
    return out


def jax_transformers(n, rows=48, seed=7):
    """n fitted JAX TransformerAutoEncoders (1 layer, d_model 16, 2 heads
    of 8, lookback 8), serving with flash."""
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(n):
        X = rng.normal(size=(rows, len(TF_TAGS))).astype("float32")
        est = JaxTransformerAutoEncoder(**TRANSFORMER, seed=i, attention_impl="dense").fit(X, X)
        out[f"tf-{i}"] = with_flash(est)
    return out


def to_port(jax_estimators, device="cpu"):
    """The port's estimators of the same definitions and weights."""
    return {
        name: convert.model_from_flax(est.params_, into_definition(est), device=device)
        for name, est in jax_estimators.items()
    }


def ragged_inputs(estimators, seed, base_rows=20):
    """Inputs of ragged lengths, one per machine, from a numpy seed."""
    rng = np.random.default_rng(seed)
    return {
        name: rng.normal(size=(base_rows + 5 * i, est.n_features_)).astype("float32")
        for i, (name, est) in enumerate(estimators.items())
    }


def assert_outputs_close(got, want):
    assert set(got) == set(want)
    for name in want:
        assert got[name].dtype == np.float32
        np.testing.assert_allclose(got[name], np.asarray(want[name]), rtol=RTOL, atol=ATOL,
                                   err_msg=name)


@pytest.fixture(scope="module")
def feedforward_pair():
    jax_ests = jax_feedforward(3)
    return jax_ests, to_port(jax_ests)


@pytest.fixture(scope="module")
def transformer_pair():
    jax_ests = jax_transformers(3)
    return jax_ests, to_port(jax_ests)


# -- FleetScorer ---------------------------------------------------------------


@pytest.mark.parametrize("family", ["feedforward", "transformer"])
def test_fleet_scorer_matches_jax(family, feedforward_pair, transformer_pair):
    jax_ests, port_ests = feedforward_pair if family == "feedforward" else transformer_pair
    jax_scorer, port_scorer = JaxFleetScorer(jax_ests), FleetScorer(port_ests)
    assert port_scorer.n_groups == jax_scorer.n_groups == 1
    assert port_scorer.names == jax_scorer.names
    inputs = ragged_inputs(port_ests, seed=11)
    assert_outputs_close(port_scorer.predict(inputs), jax_scorer.predict(inputs))


def test_mixed_architectures_group_as_jax_does(feedforward_pair, transformer_pair):
    jax_ests = {**feedforward_pair[0], **transformer_pair[0], **jax_feedforward(2, n_features=3,
                                                                               seed=9)}
    jax_ests["ff-wide"] = jax_feedforward(1, n_features=6, seed=10)["ff-0"]
    port_ests = to_port(jax_ests)
    jax_scorer, port_scorer = JaxFleetScorer(jax_ests), FleetScorer(port_ests)
    assert port_scorer.n_groups == jax_scorer.n_groups == 4
    assert sorted(port_scorer.names) == sorted(jax_scorer.names)
    for name in port_ests:
        assert port_scorer.machine_geometry(name) == jax_scorer.machine_geometry(name)
    inputs = ragged_inputs(port_ests, seed=12)
    assert_outputs_close(port_scorer.predict(inputs), jax_scorer.predict(inputs))


def test_group_key_splits_on_what_changes_the_forward():
    """Machines of one definition and width share a key whatever their
    seeds; a flag that the module's repr would not show (causal) splits
    them, and so does a precision other than float32."""
    from gordo_tpu_torch.models import TransformerAutoEncoder

    X = np.random.default_rng(0).normal(size=(30, 3)).astype("float32")
    base = dict(TRANSFORMER, attention_impl="flash")
    a = TransformerAutoEncoder(**base, seed=0).fit(X, X, device="cpu")
    b = TransformerAutoEncoder(**base, seed=1).fit(X, X, device="cpu")
    c = TransformerAutoEncoder(**base, causal=False, seed=0).fit(X, X, device="cpu")
    assert group_key(a) == group_key(b) != group_key(c)
    b.precision_ = "bf16"
    assert group_key(b) != group_key(a)
    a.precision_ = "float32"
    assert not any(str(part).startswith("precision=") for part in group_key(a))


@pytest.mark.parametrize("family", ["feedforward", "transformer"])
def test_subset_and_duplicate_entries_match_jax(family, feedforward_pair, transformer_pair):
    """A four-machine group: a 3-of-4 subset (scattered into the resident
    stack), a 1-of-4 subset (a gathered stack, machine axis floored at 2)
    and coalesced requests that name one machine twice (gathered), each
    against the JAX scorer and against the full-group request."""
    if family == "feedforward":
        jax_ests = jax_feedforward(4)
    else:
        jax_ests = dict(transformer_pair[0], **{"tf-3": jax_transformers(1, seed=8)["tf-0"]})
    port_ests = to_port(jax_ests)
    jax_scorer, port_scorer = JaxFleetScorer(jax_ests), FleetScorer(port_ests)
    names = list(port_ests)
    inputs = ragged_inputs(port_ests, seed=13)
    full = port_scorer.predict(inputs)
    requests = [
        {n: inputs[n] for n in names[:3]},
        {names[2]: inputs[names[2]]},
        {names[0]: inputs[names[0]], names[1]: inputs[names[1]]},
        {names[0]: inputs[names[0]]},
    ]
    got = port_scorer.predict_requests(requests)
    want = jax_scorer.predict_requests(requests)
    for g, w, request in zip(got, want, requests):
        assert_outputs_close(g, w)
        for name in request:
            np.testing.assert_allclose(g[name], full[name], rtol=RTOL, atol=ATOL)
    before = port_scorer.dispatch_counts()
    for request in requests[:2]:
        assert_outputs_close(port_scorer.predict(request), jax_scorer.predict(request))
    after = port_scorer.dispatch_counts()
    assert {k: after[k] - before[k] for k in after} == {"resident": 1, "gathered": 1}


def test_unknown_and_unfitted_machines_raise(feedforward_pair):
    _, port_ests = feedforward_pair
    scorer = FleetScorer(port_ests)
    with pytest.raises(KeyError):
        scorer.predict_requests([{"ff-0": np.zeros((4, 4), "float32")},
                                 {"nope": np.zeros((4, 4), "float32")}])
    with pytest.raises(KeyError):
        scorer.machine_geometry("nope")
    with pytest.raises(ValueError, match="not fitted"):
        FleetScorer({"x": AutoEncoder("feedforward_hourglass")})
    with pytest.raises(ValueError, match="expects 4 feature"):
        scorer.predict({"ff-0": np.zeros((4, 3), "float32")})


def test_short_windowed_input_raises_as_jax(transformer_pair):
    jax_ests, port_ests = transformer_pair
    short = {"tf-0": np.zeros((LOOKBACK - 1, 3), "float32")}
    with pytest.raises(ValueError, match="Not enough timesteps") as port_err:
        FleetScorer(port_ests).predict(short)
    with pytest.raises(ValueError) as jax_err:
        JaxFleetScorer(jax_ests).predict(short)
    assert str(port_err.value) == str(jax_err.value)


def test_pow2_bucket():
    assert [pow2_bucket(n) for n in (1, 2, 3, 4, 5, 144, 8255)] == [1, 2, 4, 4, 8, 256, 16384]


def test_scorer_from_models_applies_pipeline_prefixes():
    """A Pipeline(MinMaxScaler, AutoEncoder) joins the bare machines'
    group with its scaler as a host prefix; a model with no estimator
    goes to the fallback; outputs after the prefixes match JAX's."""
    from gordo_tpu_torch import serializer as port_serializer

    rng = np.random.default_rng(21)
    X = rng.random((50, 4)).astype("float32") * 10
    definition = {"sklearn.pipeline.Pipeline": {"steps": [
        "sklearn.preprocessing.MinMaxScaler",
        {"gordo_tpu.models.AutoEncoder": {"kind": "feedforward_hourglass", "epochs": 1}},
    ]}}
    jax_pipe = jax_serializer.from_definition(definition).fit(X, X)
    scaler = jax_pipe.steps[0][1]
    steps = [{attr: getattr(scaler, attr)
              for attr in ("data_min_", "data_max_", "data_range_", "scale_", "min_")}]
    est = _find_jax_estimator(jax_pipe)
    port_pipe = convert.model_from_flax(est.params_, into_definition(jax_pipe),
                                        pipeline_steps=steps, device="cpu")
    jax_models = dict(jax_feedforward(2), pipe=jax_pipe,
                      scaler=jax_serializer.from_definition("sklearn.preprocessing.MinMaxScaler"))
    port_models = dict(to_port(jax_feedforward(2)), pipe=port_pipe,
                       scaler=port_serializer.from_definition("sklearn.preprocessing.MinMaxScaler"))
    jax_scorer, jax_prefixes, jax_fallback = jax_scorer_from_models(jax_models)
    scorer, prefixes, fallback = fleet_scorer_from_models(port_models)
    assert set(fallback) == set(jax_fallback) == {"scaler"}
    assert {n: len(p) for n, p in prefixes.items()} == {
        n: len(p) for n, p in jax_prefixes.items()} == {"ff-0": 0, "ff-1": 0, "pipe": 1}
    assert scorer.n_groups == jax_scorer.n_groups == 1
    raw = ragged_inputs({n: port_models[n] for n in ("ff-0", "ff-1")}, seed=22)
    raw["pipe"] = rng.random((30, 4)).astype("float32") * 10

    def transformed(prefix_map):
        out = {}
        for name, x in raw.items():
            for step in prefix_map[name]:
                x = step.transform(x)
            out[name] = np.asarray(x, dtype="float32")
        return out

    assert_outputs_close(scorer.predict(transformed(prefixes)),
                         jax_scorer.predict(transformed(jax_prefixes)))


def test_scorer_from_no_estimators_is_none():
    from gordo_tpu_torch import serializer as port_serializer

    scorer, prefixes, fallback = fleet_scorer_from_models(
        {"s": port_serializer.from_definition("sklearn.preprocessing.MinMaxScaler")})
    assert scorer is None and prefixes == {} and set(fallback) == {"s"}


# -- the fleet routes against the JAX server ----------------------------------


def _index(n, start="2019-06-01"):
    return pd.date_range(start, periods=n, freq="10min", tz="UTC")


def _metadata(name, tags, definition):
    return {
        "name": name,
        "dataset": {"tag_list": tags, "target_tag_list": tags, "resolution": "10T",
                    "train_start_date": "2019-01-01T00:00:00+00:00",
                    "train_end_date": "2019-06-01T00:00:00+00:00"},
        "model": definition,
        "metadata": {"build_metadata": {"model": {"model_offset": 0}}},
        "project_name": PROJECT,
    }


def write_pair(jax_dir, port_dir, name, model, tags):
    """``model`` (a JAX detector or bare estimator) dumped as a JAX artifact
    and carried into a port artifact."""
    definition = into_definition(model)
    jax_serializer.dump(model, jax_dir / name, metadata=_metadata(name, tags, definition))
    loaded = jax_serializer.load(jax_dir / name)
    kwargs = {}
    if isinstance(loaded, JaxDetector):
        kwargs = dict(
            scaler_center=loaded.scaler.center_, scaler_scale=loaded.scaler.scale_,
            thresholds={"aggregate_threshold_": loaded.aggregate_threshold_,
                        "feature_thresholds_": np.asarray(loaded.feature_thresholds_)},
        )
    convert.write_artifact(port_dir / name, params=_find_jax_estimator(loaded).params_,
                           definition=into_definition(loaded),
                           metadata=jax_serializer.load_metadata(jax_dir / name), **kwargs)


def fleet_collections(root):
    """(JAX revision dir, port revision dir): two Transformer detectors
    (flash) and two feedforward AutoEncoders."""
    jax_dir, port_dir = root / "jax" / REVISION, root / "port" / REVISION
    rng = np.random.default_rng(31)
    for name, est in jax_transformers(2).items():
        X = rng.normal(size=(60, len(TF_TAGS))).astype("float32")
        # a detector around the fitted estimator: its scaler and thresholds by hand
        detector = JaxDetector(base_estimator=est)
        detector.scaler.fit(X)
        detector.aggregate_threshold_ = 1.25 + 0.1 * int(name[-1])
        detector.feature_thresholds_ = pd.Series([0.7, 0.9, 1.1], name="fold-2")
        write_pair(jax_dir, port_dir, f"turbine-{name}", detector, TF_TAGS)
    for name, est in jax_feedforward(2).items():
        write_pair(jax_dir, port_dir, f"pump-{name}", est, FF_TAGS)
    return jax_dir, port_dir


@pytest.fixture(scope="module")
def fleet_clients(tmp_path_factory):
    jax_dir, port_dir = fleet_collections(tmp_path_factory.mktemp("fleet-serving"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MODEL_COLLECTION_DIR", str(jax_dir))
        mp.delenv("GORDO_BATCH_WAIT_MS", raising=False)
        jax_server_utils.clear_caches()
        yield Client(jax_build_app()), Client(build_app(str(port_dir), device="cpu"))
    jax_server_utils.clear_caches()


def frame_dict(n_rows, tags, seed):
    rng = np.random.default_rng(seed)
    frame = pd.DataFrame(rng.normal(size=(n_rows, len(tags))), columns=tags, index=_index(n_rows))
    return jax_server_utils.dataframe_to_dict(frame)


def fleet_body(names, anomaly, seed=41, n_rows=40):
    machines = {}
    for i, name in enumerate(names):
        tags = TF_TAGS if name.startswith("turbine") else FF_TAGS
        frame = frame_dict(n_rows + 3 * i, tags, seed + i)
        machines[name] = {"X": frame, "y": frame} if anomaly else frame
    return {"machines": machines}


def post(client, route, body, **kwargs):
    reply = client.post(f"/gordo/v0/{PROJECT}/{route}", json=body, **kwargs)
    return reply.status_code, json.loads(reply.get_data())


def assert_same(got, want, path="body"):
    if isinstance(want, dict):
        assert isinstance(got, dict), path
        assert set(got) == set(want), f"{path}: {sorted(set(got) ^ set(want))}"
        for key in want:
            assert_same(got[key], want[key], f"{path}/{key}")
    elif isinstance(want, float):
        np.testing.assert_allclose(got, want, rtol=ROUTE_RTOL, atol=ROUTE_ATOL, err_msg=path)
    else:
        assert got == want, path


TURBINES = ["turbine-tf-0", "turbine-tf-1"]
PUMPS = ["pump-ff-0", "pump-ff-1"]


@pytest.mark.parametrize("route,names", [
    ("prediction/fleet", TURBINES + PUMPS),
    ("prediction/fleet", PUMPS[:1]),
    ("anomaly/prediction/fleet", TURBINES),
    ("anomaly/prediction/fleet", TURBINES[1:]),
])
def test_fleet_routes_answer_as_the_jax_server(fleet_clients, route, names):
    jax_client, port_client = fleet_clients
    body = fleet_body(names, anomaly=route.startswith("anomaly"))
    want_status, want = post(jax_client, route, body)
    got_status, got = post(port_client, route, body)
    assert got_status == want_status == 200, got
    assert set(got) == set(want) == {"data", "time-seconds", "revision"}
    assert got["revision"] == want["revision"] == REVISION
    assert set(got["data"]) == set(names)
    assert_same(got["data"], want["data"])


def test_every_fleet_request_of_a_revision_selects_from_one_scorer(fleet_clients):
    """One scorer a revision, over its servable machines, whatever subset
    a request names: each group of two is stacked once, so a one-machine
    request rounds up to its group and scatters into the resident stack."""
    _, port_client = fleet_clients
    catalog = port_client.application.catalog
    assert post(port_client, "prediction/fleet", fleet_body(PUMPS, anomaly=False))[0] == 200
    ((scorer, _, _),) = catalog._fleet_scorers.values()
    before = scorer.dispatch_counts()
    for route, names in (("prediction/fleet", TURBINES + PUMPS),
                         ("prediction/fleet", PUMPS[:1]),
                         ("anomaly/prediction/fleet", TURBINES[1:])):
        body = fleet_body(names, anomaly=route.startswith("anomaly"))
        assert post(port_client, route, body)[0] == 200
    after = scorer.dispatch_counts()
    assert len(catalog._fleet_scorers) == 1
    assert sorted(scorer.names) == sorted(TURBINES + PUMPS)
    assert {k: after[k] - before[k] for k in after} == {"resident": 4, "gathered": 0}


def test_catalog_scorer_leaves_out_a_machine_that_does_not_load(feedforward_pair, tmp_path,
                                                                caplog):
    _, port_ests = feedforward_pair

    def load(name):
        if name == "broken":
            raise FileNotFoundError(name)
        return port_ests[name]

    scorer, _, fallback = ServingCatalog(device="cpu").fleet_scorer(str(tmp_path), ("broken", *port_ests),
                                                        load)
    assert sorted(scorer.names) == sorted(port_ests) and fallback == {}
    assert "leaving out broken" in caplog.text


def test_fleet_reply_matches_the_single_machine_routes(fleet_clients):
    _, port_client = fleet_clients
    body = fleet_body(TURBINES, anomaly=True)
    _, fleet = post(port_client, "anomaly/prediction/fleet", body)
    for name in TURBINES:
        _, solo = post(port_client, f"{name}/anomaly/prediction", body["machines"][name])
        assert_same(fleet["data"][name], solo["data"])


@pytest.mark.parametrize("case", ["empty", "no-machines", "unknown", "non-anomaly", "no-y",
                                  "no-x"])
def test_fleet_error_bodies_match_jax(fleet_clients, case):
    jax_client, port_client = fleet_clients
    route = "anomaly/prediction/fleet"
    if case == "empty":
        body = {}
    elif case == "no-machines":
        body, route = {"machines": {}}, "prediction/fleet"
    elif case == "unknown":
        body = fleet_body(TURBINES[:1] + ["turbine-missing"], anomaly=True)
    elif case == "non-anomaly":
        body = fleet_body(TURBINES[:1] + PUMPS[:1], anomaly=True)
    elif case == "no-y":
        body = fleet_body(TURBINES, anomaly=True)
        del body["machines"][TURBINES[1]]["y"]
    else:
        body = fleet_body(TURBINES, anomaly=True)
        body["machines"][TURBINES[0]] = [[1.0, 2.0, 3.0]]
    got = post(port_client, route, body)
    if case == "unknown":
        # the JAX server's 404 is werkzeug's HTML page around the same text
        reply = jax_client.post(f"/gordo/v0/{PROJECT}/{route}", json=body)
        assert got[0] == reply.status_code == 404
        assert got[1]["error"] in html.unescape(reply.get_data(as_text=True))
        return
    want = post(jax_client, route, body)
    assert want[0] in (400, 422)
    assert got[0] == want[0]
    assert got[1] == want[1]


@pytest.mark.parametrize("frame", ["short-rows", "wrong-columns"])
def test_fleet_bad_width_is_a_400_naming_the_machine(fleet_clients, frame):
    jax_client, port_client = fleet_clients
    body = fleet_body(PUMPS, anomaly=False)
    body["machines"][PUMPS[1]] = (
        [[1.0, 2.0]] * 5 if frame == "short-rows" else {"a": {"0": 1.0}}
    )
    want = post(jax_client, "prediction/fleet", body)
    got = post(port_client, "prediction/fleet", body)
    assert got[0] == want[0] == 400
    prefix = f"Bad input for machine '{PUMPS[1]}': "
    assert got[1]["error"].startswith(prefix) and want[1]["error"].startswith(prefix)
    assert "Unexpected features" in got[1]["error"]


def test_fleet_multipart_body_is_refused(fleet_clients):
    _, port_client = fleet_clients
    reply = port_client.post(f"/gordo/v0/{PROJECT}/prediction/fleet",
                             data={PUMPS[0]: (__import__("io").BytesIO(b"PAR1"), "x.parquet")},
                             content_type="multipart/form-data")
    assert reply.status_code == 400
    assert "Multipart (parquet) fleet bodies are not supported" in json.loads(
        reply.get_data())["error"]
