"""
A model with no ``predict`` (a scaler, or a pipeline that ends in one)
against the JAX package's: ``get_model_output`` falls back to
``transform`` as ``gordo_tpu.server.model_io``'s does, the port's
``Pipeline`` fits a final step whose ``fit`` takes no device, and a
transformer-only machine's ``/prediction`` reply equals the JAX server's
on the same artifact inputs. The scalers compute the same float64
operations as scikit-learn's, so the rows are compared exactly; the
served JSON at the server tolerance (rtol 1e-4, atol 1e-5).
"""

import json

import numpy as np
import pytest
from sklearn.pipeline import Pipeline as SkPipeline
from sklearn.preprocessing import MinMaxScaler as SkMinMaxScaler
from werkzeug.test import Client

from gordo_tpu import serializer as jax_serializer
from gordo_tpu.server import build_app as jax_build_app
from gordo_tpu.server import utils as jax_server_utils
from gordo_tpu.server.model_io import get_model_output as jax_get_model_output
from gordo_tpu_torch import serializer
from gordo_tpu_torch.models import MinMaxScaler, Pipeline
from gordo_tpu_torch.server.app import build_app
from gordo_tpu_torch.server.model_io import get_model_output

TAGS = ["GRA-PUMP-TEMP 1", "GRA-PUMP-PRES 2", "GRA-PUMP-FLOW 3"]


def _rows(n=40, seed=5):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, len(TAGS))) * [1.0, 50.0, 1e-2] + [3.0, -20.0, 0.5]


def _pairs():
    return [
        ("bare", MinMaxScaler(), SkMinMaxScaler()),
        ("pipeline", Pipeline([("scale", MinMaxScaler())]),
         SkPipeline([("scale", SkMinMaxScaler())])),
    ]


@pytest.mark.parametrize("label, port_model, jax_model", _pairs(),
                         ids=[p[0] for p in _pairs()])
def test_scaler_only_models_fit_and_give_jax_rows(label, port_model, jax_model):
    X = _rows()
    port_model.fit(X, X)
    jax_model.fit(X, X)
    got = get_model_output(port_model, X[:7])
    want = jax_get_model_output(jax_model, X[:7])
    np.testing.assert_array_equal(got, want)


def test_get_model_output_predict_and_transform_fallback():
    """The JAX test of the same name, against the port."""

    class PredictOnly:
        def predict(self, X):
            return np.asarray(X) * 2

    class TransformOnly:
        def transform(self, X):
            return np.asarray(X) + 1

    X = np.ones((3, 2))
    np.testing.assert_array_equal(get_model_output(PredictOnly(), X), X * 2)
    np.testing.assert_array_equal(get_model_output(TransformOnly(), X), X + 1)
    for model in (PredictOnly(), TransformOnly()):
        np.testing.assert_array_equal(get_model_output(model, X),
                                      jax_get_model_output(model, X))


def _metadata(name):
    return {"name": name, "project_name": "scale-proj",
            "dataset": {"tag_list": list(TAGS), "target_tag_list": list(TAGS)}}


@pytest.fixture(scope="module")
def scaler_servers(tmp_path_factory):
    """A revision with a bare scaler and a one-step pipeline, written by
    each package from scalers fitted on the same rows."""
    X = _rows()
    port_dir = tmp_path_factory.mktemp("port") / "1700000000000"
    jax_dir = tmp_path_factory.mktemp("jax") / "1700000000000"
    for label, port_model, jax_model in _pairs():
        port_model.fit(X, X)
        jax_model.fit(X, X)
        serializer.dump(port_model, port_dir / label, metadata=_metadata(label))
        jax_serializer.dump(jax_model, jax_dir / label, metadata=_metadata(label))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MODEL_COLLECTION_DIR", str(jax_dir))
        jax_server_utils.clear_caches()
        yield Client(jax_build_app()), Client(build_app(str(port_dir), device="cpu"))
    jax_server_utils.clear_caches()


@pytest.mark.parametrize("label", ["bare", "pipeline"])
def test_transformer_only_machine_prediction_is_the_jax_servers(scaler_servers, label):
    jax_client, port_client = scaler_servers
    rows = _rows(12, seed=9)
    body = {"X": {tag: {str(i): float(v) for i, v in enumerate(rows[:, j])}
                  for j, tag in enumerate(TAGS)}}
    path = f"/gordo/v0/scale-proj/{label}/prediction"
    jax_reply = jax_client.post(path, json=body)
    port_reply = port_client.post(path, json=body)
    assert (port_reply.status_code, jax_reply.status_code) == (200, 200), port_reply.get_data()
    got, want = json.loads(port_reply.get_data()), json.loads(jax_reply.get_data())
    assert sorted(got["data"]) == sorted(want["data"])
    for block, columns in want["data"].items():
        assert sorted(got["data"][block]) == sorted(columns)
        for column, values in columns.items():
            mine = got["data"][block][column]
            assert sorted(mine) == sorted(values)
            # start/end are null without a time index, in both servers
            assert [mine[k] is None for k in sorted(values)] == [
                values[k] is None for k in sorted(values)]
            numbers = [k for k in sorted(values) if values[k] is not None]
            np.testing.assert_allclose([mine[k] for k in numbers],
                                       [values[k] for k in numbers], rtol=1e-4, atol=1e-5)
