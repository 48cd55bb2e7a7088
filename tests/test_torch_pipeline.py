"""
The default pipeline, ``DiffBasedAnomalyDetector(Pipeline(MinMaxScaler,
AutoEncoder(feedforward_hourglass)))``, against the JAX package's, whose
pipeline and scaler are scikit-learn's.

Tolerances: the MinMaxScaler bit for bit against scikit-learn's (the
same float64 operations in the same order); pipeline predictions from
one converted machine at 1e-6 (float32 nets); cross-validation from the
JAX init of the same seed, with the same batches (no shuffle), to rtol
1e-4 for the thresholds (float32 training in another summation order,
through a rolling min/max of the fold errors) and for the fold scores,
which also get atol 1e-6: two-epoch nets score near 0, where a relative
tolerance means nothing.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from sklearn.preprocessing import MinMaxScaler as SkMinMaxScaler
from sklearn.preprocessing import RobustScaler

from gordo_tpu.builder.build_model import ModelBuilder as JaxModelBuilder
from gordo_tpu.models import AutoEncoder as JaxAutoEncoder
from gordo_tpu.models.core import solo_init_key
from gordo_tpu.serializer import from_definition as jax_from_definition
from gordo_tpu.serializer import into_definition
from gordo_tpu_torch import serializer
from gordo_tpu_torch.builder import ModelBuilder
from gordo_tpu_torch.convert import feedforward_state_dict, model_from_flax
from gordo_tpu_torch.models import AutoEncoder, MinMaxScaler, Pipeline
from gordo_tpu_torch.models.anomaly.diff import DiffBasedAnomalyDetector
from gordo_tpu_torch.models.preprocessing import RobustScaler as RobustScaling

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_num_threads(1)

TAGS = ["GRA-PUMP-TEMP 1", "GRA-PUMP-PRES 2", "GRA-PUMP-FLOW 3"]
SCALER_ATTRS = ("data_min_", "data_max_", "data_range_", "scale_", "min_")


def default_model(**estimator_kwargs):
    """The default pipeline's definition, as examples/config.yaml's globals
    write it."""
    return {
        "gordo_tpu.models.anomaly.DiffBasedAnomalyDetector": {
            "base_estimator": {
                "sklearn.pipeline.Pipeline": {
                    "steps": [
                        "sklearn.preprocessing.MinMaxScaler",
                        {"gordo_tpu.models.AutoEncoder": {
                            "kind": "feedforward_hourglass", **estimator_kwargs}},
                    ]
                }
            }
        }
    }


def _rows(n_rows, seed):
    """Sensor rows in engineering units (float64, as the data layer gives)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_rows)[:, None]
    level = np.array([60.0, 4.0, 900.0])
    amplitude = np.array([5.0, 0.5, 80.0])
    wave = np.sin(2 * np.pi * t / 144 + np.arange(3))
    return level + amplitude * (wave + 0.1 * rng.normal(size=(n_rows, 3)))


# -- MinMaxScaler ------------------------------------------------------------


def _scaler_cases():
    rng = np.random.default_rng(0)
    wide = rng.normal(size=(50, 4)) * [1.0, 100.0, 1e-3, 5.0]
    constant = np.column_stack([rng.normal(size=20), np.full(20, 3.5)])
    with_nan = wide.copy()
    with_nan[[3, 9], [0, 2]] = np.nan
    return {
        "float64": (wide, {}),
        "float32": (wide.astype(np.float32), {}),
        "constant-column": (constant, {}),
        "feature-range": (wide, {"feature_range": (-1, 2)}),
        "clip": (wide, {"clip": True}),
        "nan": (with_nan, {}),
    }


@pytest.mark.parametrize("case", list(_scaler_cases()))
def test_minmax_scaler_matches_sklearn(case):
    X, kwargs = _scaler_cases()[case]
    ours, theirs = MinMaxScaler(**kwargs).fit(X), SkMinMaxScaler(**kwargs).fit(X)
    for attr in SCALER_ATTRS:
        got, want = getattr(ours, attr), getattr(theirs, attr)
        assert got.dtype == want.dtype, attr
        np.testing.assert_array_equal(got, want, err_msg=attr)
    beyond = np.concatenate([X, 2 * X[:5] + 1]).astype(X.dtype)
    got, want = ours.transform(beyond), theirs.transform(beyond)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_minmax_scaler_refuses_an_empty_range_like_sklearn():
    with pytest.raises(ValueError, match="smaller than maximum"):
        MinMaxScaler(feature_range=(1, 1)).fit(np.ones((3, 2)))


# -- definitions and artifacts -------------------------------------------------


@pytest.mark.parametrize(
    "steps",
    [
        ["sklearn.preprocessing.MinMaxScaler",
         {"gordo_tpu.models.AutoEncoder": {"kind": "feedforward_hourglass"}}],
        [{"sklearn.preprocessing.MinMaxScaler": {"feature_range": [-1, 1]}},
         {"gordo.machine.model.models.KerasAutoEncoder": {"kind": "feedforward_hourglass"}}],
    ],
)
def test_pipeline_definitions_build_like_jax(steps):
    definition = {"sklearn.pipeline.Pipeline": {"steps": steps}}
    pipeline = serializer.from_definition(definition)
    want = jax_from_definition(copy.deepcopy(definition))
    assert isinstance(pipeline, Pipeline)
    assert [name for name, _ in pipeline.steps] == [name for name, _ in want.steps]
    assert [name for name, _ in pipeline.steps] == ["step_MinMaxScaler", "step_AutoEncoder"]
    assert isinstance(pipeline.steps[1][1], AutoEncoder)
    assert pipeline.steps[0][1].feature_range == tuple(want.steps[0][1].feature_range)


def test_pipeline_artifact_round_trips(tmp_path):
    X = _rows(400, seed=1)
    detector = serializer.from_definition(default_model(epochs=1, seed=2))
    detector.cross_validate(X=X, y=X, device="cpu")
    detector.fit(X, X, device="cpu")
    serializer.dump(detector, tmp_path / "m", {"name": "m"})
    with np.load(tmp_path / "m" / serializer.PARAMS_FILENAME) as npz:
        keys = set(npz.files)
    assert {f"base_estimator.steps.0.{attr}" for attr in SCALER_ATTRS} <= keys
    assert {"base_estimator.steps.1.layers.0.weight", "base_estimator.steps.1.layers.6.bias",
            "scaler.center_", "aggregate_threshold_", "feature_thresholds_"} <= keys
    loaded = serializer.load(tmp_path / "m", device="cpu")
    np.testing.assert_array_equal(loaded.predict(X), detector.predict(X))
    assert loaded.aggregate_threshold_ == detector.aggregate_threshold_
    clone = detector.base_estimator.clone()
    assert [type(step) for _, step in clone.steps] == [MinMaxScaler, AutoEncoder]
    assert not hasattr(clone.steps[0][1], "scale_")


# -- against the JAX pipeline --------------------------------------------------


def _jax_initial_state(self, spec, seed):
    """The JAX init a solo JAX fit of these kwargs and seed starts from."""
    module = JaxAutoEncoder(self.kind, **self.kwargs)._build_spec().module
    params = module.init(solo_init_key(seed), jnp.zeros((1, self.kwargs["n_features"])))
    return {k: torch.tensor(v) for k, v in feedforward_state_dict(params).items()}


def jax_parts(detector):
    """What a JAX default-pipeline detector carries, as plain data for
    ``gordo_tpu_torch.convert``."""
    scaler, estimator = (step for _, step in detector.base_estimator.steps)
    thresholds = {
        attr: getattr(detector, attr, None)
        for attr in ("aggregate_threshold_", "feature_thresholds_")
    }
    return dict(
        params=estimator.params_,
        definition=into_definition(detector),
        scaler_center=detector.scaler.center_,
        scaler_scale=detector.scaler.scale_,
        thresholds={k: None if v is None else np.asarray(v) for k, v in thresholds.items()},
        pipeline_steps=[{attr: getattr(scaler, attr) for attr in SCALER_ATTRS}],
    )


def test_pipeline_predict_matches_jax():
    X = pd.DataFrame(_rows(500, seed=3), columns=TAGS)
    jax_detector = jax_from_definition(default_model(epochs=2, seed=1))
    jax_detector.fit(X, X)
    port = model_from_flax(**jax_parts(jax_detector), device="cpu")
    assert isinstance(port.base_estimator, Pipeline)
    rows = _rows(700, seed=4)
    frame = pd.DataFrame(rows, columns=TAGS)
    np.testing.assert_allclose(port.predict(rows), jax_detector.predict(frame), atol=1e-6)
    np.testing.assert_allclose(
        port.base_estimator.transform(rows), jax_detector.base_estimator.transform(frame),
        atol=1e-6,
    )
    np.testing.assert_allclose(
        port.base_estimator.score(rows, rows), jax_detector.base_estimator.score(frame, frame),
        rtol=1e-5,
    )


@pytest.fixture(scope="module")
def cv_pair():
    """(JAX detector, port detector, JAX cv output, port cv output): the
    default pipeline cross-validated with the builder's scorers from one
    init, then fitted on all rows."""
    X = _rows(600, seed=5)
    frame = pd.DataFrame(X, columns=TAGS)
    definition = default_model(epochs=2, seed=3, shuffle=False)
    jax_detector = jax_from_definition(copy.deepcopy(definition))
    jax_scorers = JaxModelBuilder.build_metrics_dict(
        JaxModelBuilder.metrics_from_list(None), frame, scaler=RobustScaler()
    )
    jax_cv = jax_detector.cross_validate(X=frame, y=frame, scoring=jax_scorers)
    jax_detector.fit(frame, frame)

    port_detector = serializer.from_definition(definition)
    assert isinstance(port_detector, DiffBasedAnomalyDetector)
    port_scorers = ModelBuilder.build_metrics_dict(
        ModelBuilder.metrics_from_list(None), TAGS, X, RobustScaling()
    )
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(AutoEncoder, "_initial_state", _jax_initial_state)
        port_cv = port_detector.cross_validate(X=X, y=X, scoring=port_scorers, device="cpu")
        port_detector.fit(X, X, device="cpu")
    assert set(port_scorers) == set(jax_scorers)
    return jax_detector, port_detector, jax_cv, port_cv


def test_cross_validate_thresholds_match_jax(cv_pair):
    jax_detector, port_detector, _, _ = cv_pair
    assert jax_detector.cv_fast_path_ is False  # the sequential path, as the port's
    got = port_detector.aggregate_thresholds_per_fold_
    want = jax_detector.aggregate_thresholds_per_fold_
    assert list(got) == list(want) == ["fold-0", "fold-1", "fold-2"]
    np.testing.assert_allclose(list(got.values()), list(want.values()), rtol=1e-4)
    got = np.stack(list(port_detector.feature_thresholds_per_fold_.values()))
    np.testing.assert_allclose(got, jax_detector.feature_thresholds_per_fold_.to_numpy(), rtol=1e-4)
    np.testing.assert_allclose(
        port_detector.aggregate_threshold_, jax_detector.aggregate_threshold_, rtol=1e-4
    )
    np.testing.assert_allclose(
        port_detector.feature_thresholds_, jax_detector.feature_thresholds_.to_numpy(), rtol=1e-4
    )


def test_cross_validate_scores_match_jax(cv_pair):
    _, _, jax_cv, port_cv = cv_pair
    names = [key for key in jax_cv if key.startswith("test_")]
    assert sorted(names) == sorted(key for key in port_cv if key.startswith("test_"))
    for name in names:
        np.testing.assert_allclose(port_cv[name], jax_cv[name], rtol=1e-4, atol=1e-6, err_msg=name)


def test_fitted_pipeline_matches_jax(cv_pair):
    jax_detector, port_detector, _, _ = cv_pair
    jax_scaler, jax_estimator = (step for _, step in jax_detector.base_estimator.steps)
    port_scaler, port_estimator = (step for _, step in port_detector.base_estimator.steps)
    for attr in SCALER_ATTRS:
        np.testing.assert_array_equal(getattr(port_scaler, attr), getattr(jax_scaler, attr))
    np.testing.assert_allclose(
        port_estimator.history_["loss"], jax_estimator.history_["loss"], rtol=1e-4
    )
    metadata = port_detector.get_metadata()
    assert set(metadata) >= {"scaler", "base_estimator", "history", "aggregate-threshold"}
