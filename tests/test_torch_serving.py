"""
The slice as a whole: a JAX DiffBasedAnomalyDetector(TransformerAutoEncoder)
is fitted, dumped as a JAX artifact, carried over with
gordo_tpu_torch.convert, and the same JSON body is posted to the JAX
server and to the port's server (both in-process). The two answers must
agree key for key, values within rtol 1e-4 / atol 1e-5 (float32 model
arithmetic in another summation order), error bodies exactly.

The JAX model trains with ``attention_impl: dense`` (training through the
interpret-mode flash backward is slow-marked in tests/test_seq_models.py;
the parameter tree is the same for both impls) and is served by the port
with ``flash``, its serving configuration.
"""

import copy
import json

import numpy as np
import pandas as pd
import pytest
import torch
from werkzeug.test import Client

from gordo_tpu import serializer as jax_serializer
from gordo_tpu.models import TransformerAutoEncoder as JaxTransformerAutoEncoder
from gordo_tpu.models.anomaly import DiffBasedAnomalyDetector as JaxDetector
from gordo_tpu.serializer import into_definition
from gordo_tpu.server import build_app as jax_build_app
from gordo_tpu.server import utils as jax_server_utils
from gordo_tpu_torch import convert
from gordo_tpu_torch import serializer
from gordo_tpu_torch.models.anomaly.diff import rolling_median
from gordo_tpu_torch.models.utils import Frame
from gordo_tpu_torch.server import utils as server_utils
from gordo_tpu_torch.server.app import build_app

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

PROJECT = "plant-a-anomaly"
MACHINE = "turbine-t"
REVISION = "1700000000000"
TAGS = ["GRA-TURB-SPEED 1", "GRA-TURB-TEMP 2", "GRA-TURB-LOAD 3"]
LOOKBACK = 8
RTOL, ATOL = 1e-4, 1e-5


def _index(n, start="2019-06-01"):
    return pd.date_range(start, periods=n, freq="10min", tz="UTC")


def _thresholds(detector):
    return {
        "aggregate_threshold_": detector.aggregate_threshold_,
        "feature_thresholds_": np.asarray(detector.feature_thresholds_),
        "smooth_aggregate_threshold_": getattr(detector, "smooth_aggregate_threshold_", None),
        "smooth_feature_thresholds_": (
            None
            if getattr(detector, "smooth_feature_thresholds_", None) is None
            else np.asarray(detector.smooth_feature_thresholds_)
        ),
    }


@pytest.fixture(scope="module")
def collections(tmp_path_factory):
    """(JAX collection dir, port collection dir) holding the same machine."""
    rng = np.random.default_rng(11)
    X = rng.normal(size=(300, len(TAGS))).astype(np.float32)
    base = JaxTransformerAutoEncoder(
        kind="transformer_model", lookback_window=LOOKBACK, d_model=16, n_heads=2,
        n_layers=2, epochs=1, batch_size=64, attention_impl="dense",
    )
    detector = JaxDetector(base_estimator=base).fit(X, X)
    # thresholds by hand, in the fitted detector's own types
    detector.aggregate_threshold_ = 1.25
    detector.feature_thresholds_ = pd.Series([0.7, 0.9, 1.1], name="fold-2")
    definition = into_definition(detector)
    metadata = {
        "name": MACHINE,
        "dataset": {
            "tag_list": TAGS,
            "target_tag_list": TAGS,
            "resolution": "10T",
            "train_start_date": "2019-01-01T00:00:00+00:00",
            "train_end_date": "2019-06-01T00:00:00+00:00",
        },
        "model": definition,
        "metadata": {"build_metadata": {"model": {"model_offset": LOOKBACK - 1}}},
        "project_name": PROJECT,
    }
    root = tmp_path_factory.mktemp("serving")
    jax_dir = root / "jax" / REVISION
    port_dir = root / "port" / REVISION
    jax_serializer.dump(detector, jax_dir / MACHINE, metadata=metadata)

    # carry the artifact's contents over, as a deployment would
    loaded = jax_serializer.load(jax_dir / MACHINE)
    convert.write_artifact(
        port_dir / MACHINE,
        params=loaded.base_estimator.params_,
        definition=into_definition(loaded),
        scaler_center=loaded.scaler.center_,
        scaler_scale=loaded.scaler.scale_,
        thresholds=_thresholds(loaded),
        metadata=jax_serializer.load_metadata(jax_dir / MACHINE),
    )
    # serve with the flash kernel: the served configuration of the slice
    definition_file = port_dir / MACHINE / serializer.DEFINITION_FILENAME
    port_definition = json.loads(definition_file.read_text())
    (port_base,) = next(iter(port_definition.values()))["base_estimator"].values()
    port_base["attention_impl"] = "flash"
    definition_file.write_text(json.dumps(port_definition))
    return jax_dir, port_dir


@pytest.fixture(scope="module")
def clients(collections):
    jax_dir, port_dir = collections
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MODEL_COLLECTION_DIR", str(jax_dir))
        jax_server_utils.clear_caches()
        jax_client = Client(jax_build_app())
        port_client = Client(build_app(str(port_dir), device="cpu"))
        yield jax_client, port_client
    jax_server_utils.clear_caches()


def _body(n_rows, seed, with_y=True):
    rng = np.random.default_rng(seed)
    frame = pd.DataFrame(rng.normal(size=(n_rows, len(TAGS))), columns=TAGS, index=_index(n_rows))
    body = {"X": jax_server_utils.dataframe_to_dict(frame)}
    if with_y:
        body["y"] = body["X"]
    return body


def _post(client, route, body):
    reply = client.post(f"/gordo/v0/{PROJECT}/{MACHINE}/{route}", json=body)
    return reply.status_code, json.loads(reply.get_data())


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


@pytest.mark.parametrize("route", ["prediction", "anomaly/prediction"])
def test_port_server_answers_as_the_jax_server(clients, route):
    jax_client, port_client = clients
    body = _body(144, seed=1)
    want_status, want = _post(jax_client, route, body)
    got_status, got = _post(port_client, route, body)
    assert got_status == want_status == 200
    assert set(got) == set(want) == {"data", "time-seconds", "revision"}
    assert got["revision"] == want["revision"] == REVISION
    _assert_same(got["data"], want["data"])
    assert len(got["data"]["model-output"][TAGS[0]]) == 144 - LOOKBACK + 1


@pytest.mark.parametrize(
    "route,body",
    [
        ("prediction", {"y": {"a": {"0": 1.0}}}),
        ("anomaly/prediction", {}),
        ("prediction", "too-few-rows"),
        ("anomaly/prediction", "too-few-rows"),
        ("anomaly/prediction", "no-y"),
    ],
)
def test_port_server_error_bodies_match(clients, route, body):
    jax_client, port_client = clients
    if body == "too-few-rows":
        body = _body(LOOKBACK - 3, seed=2)
    elif body == "no-y":
        body = _body(20, seed=3, with_y=False)
    want = _post(jax_client, route, body)
    got = _post(port_client, route, body)
    assert want[0] == 400
    assert got == want


def test_port_server_lists_models_and_metadata(clients):
    jax_client, port_client = clients
    for path in (f"/gordo/v0/{PROJECT}/models",):
        assert json.loads(port_client.get(path).get_data()) == json.loads(
            jax_client.get(path).get_data()
        )
    path = f"/gordo/v0/{PROJECT}/{MACHINE}/metadata"
    got, want = (json.loads(c.get(path).get_data()) for c in (port_client, jax_client))
    assert set(got) == set(want)
    assert got["metadata"] == want["metadata"]
    assert port_client.get("/healthcheck").status_code == 200
    assert port_client.get(f"/gordo/v0/{PROJECT}/nope/metadata").status_code == 404


def test_artifact_roundtrip(collections, tmp_path):
    _, port_dir = collections
    model = serializer.load(port_dir / MACHINE, device="cpu")
    X = np.random.default_rng(4).normal(size=(40, len(TAGS))).astype(np.float32)
    serializer.dump(model, tmp_path / "copy", serializer.load_metadata(port_dir / MACHINE))
    serializer.dump(model, tmp_path / "copy", {"replaced": True})  # whole-artifact replace
    again = serializer.load(tmp_path / "copy", device="cpu")
    np.testing.assert_array_equal(again.predict(X), model.predict(X))
    assert serializer.load_metadata(tmp_path / "copy") == {"replaced": True}
    assert sorted(p.name for p in tmp_path.iterdir()) == ["copy"]


def test_smoothed_anomaly_frame_matches_jax(collections):
    """The window path (rolling medians, smoothed thresholds and NaN
    warm-up rows), detector to detector on the same model output."""
    jax_dir, port_dir = collections
    jax_det = jax_serializer.load(jax_dir / MACHINE)
    jax_det.window = 6
    jax_det.smooth_aggregate_threshold_ = 2.0
    jax_det.smooth_feature_thresholds_ = pd.Series([0.5, 0.6, 0.8])
    port_det = serializer.load(port_dir / MACHINE, device="cpu")
    port_det.window = 6
    port_det.smooth_aggregate_threshold_ = 2.0
    port_det.smooth_feature_thresholds_ = np.array([0.5, 0.6, 0.8])

    rng = np.random.default_rng(5)
    frame = pd.DataFrame(rng.normal(size=(50, 3)), columns=TAGS, index=_index(50))
    output = port_det.predict(frame.to_numpy(np.float32))
    freq = pd.tseries.frequencies.to_offset("10min")
    want = jax_server_utils.dataframe_to_dict(
        jax_det.anomaly(frame, frame, frequency=freq, model_output=output)
    )
    port_frame = Frame(frame.to_numpy(), TAGS, list(frame.index.to_pydatetime()))
    got = server_utils.dataframe_to_dict(
        port_det.anomaly(port_frame, port_frame, frequency=freq, model_output=output)
    )
    assert list(got) == list(want)
    for top in want:
        for label in want[top]:
            a = np.asarray(list(got[top][label].values()), dtype=object)
            b = np.asarray(list(want[top][label].values()), dtype=object)
            assert list(got[top][label]) == list(want[top][label])
            if top in ("start", "end"):
                assert a.tolist() == b.tolist()
            else:
                np.testing.assert_allclose(a.astype(float), b.astype(float), rtol=1e-12, atol=0)


def test_rolling_median_matches_pandas():
    values = np.random.default_rng(6).normal(size=(30, 4))
    for window in (1, 4, 7, 40):
        want = pd.DataFrame(values).rolling(window).median().to_numpy()
        np.testing.assert_allclose(rolling_median(values, window), want, equal_nan=True)


@pytest.mark.parametrize(
    "data",
    [
        {"a": {"2019-01-01T00:10:00+00:00": 1.0, "2019-01-01T00:00:00+00:00": 2.0},
         "b": {"2019-01-01T00:10:00+00:00": 3.0, "2019-01-01T00:00:00+00:00": 4.0}},
        {"a": {"1": 1.0, "0": 2.0}, "b": {"1": 3.0, "0": 4.0}},
        {"a": [1.0, 2.0, 3.0], "b": [4.0, 5.0, 6.0]},
        [[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]],
    ],
)
def test_dataframe_from_dict_matches_jax(data):
    want = jax_server_utils.dataframe_from_dict(copy.deepcopy(data))
    got = server_utils.dataframe_from_dict(copy.deepcopy(data))
    np.testing.assert_array_equal(got.values, want.to_numpy())
    assert got.columns == list(want.columns)
    want_index = (
        list(want.index.to_pydatetime())
        if isinstance(want.index, pd.DatetimeIndex)
        else list(want.index)
    )
    assert got.index == want_index


def test_multi_level_frames_are_refused_like_jax():
    data = {"top": {"a": {"0": 1.0}}}
    with pytest.raises(server_utils.ApiError, match="multi-level"):
        server_utils.verify_dataframe(server_utils.dataframe_from_dict(data), ["a"])
    with pytest.raises(jax_server_utils.ApiError, match="multi-level"):
        jax_server_utils.verify_dataframe(jax_server_utils.dataframe_from_dict(data), ["a"])


@pytest.mark.parametrize("alias", ["10T", "10min", "2T", "8H", "1h", "30S", "1D"])
def test_resolution_matches_pandas_offsets(alias):
    from gordo_tpu.utils.compat import normalize_frequency

    stamp = pd.Timestamp("2020-01-01", tz="UTC")
    want = stamp + pd.tseries.frequencies.to_offset(normalize_frequency(alias))
    got = stamp.to_pydatetime() + server_utils.resolution_to_timedelta(alias)
    assert got == want.to_pydatetime()
