"""
The evaluation options of a machine config, the port's against the JAX
package's and scikit-learn's: the splitters (``KFold``, ``ShuffleSplit``,
``TimeSeriesSplit``), the four scalers, the ten metrics, whole builds of
the conftest machine with a configured ``cv``, ``scoring_scaler``,
``metrics`` and detector ``scaler``, and a detector with a
``StandardScaler`` converted from JAX.

Tolerances: split indices exactly; scalers and metrics rtol 1e-12 (both
compute in float64 from the same inputs); builds rtol 1e-4 (float32
training in another summation order, from the same JAX init, shuffle
off); anomaly frames rtol 1e-4 / atol 1e-5, the server's.
"""

import copy

import numpy as np
import pandas as pd
import pytest
import torch
import yaml
from sklearn import metrics as sk_metrics
from sklearn import model_selection as sk_model_selection
from sklearn import preprocessing as sk_preprocessing

from gordo_tpu import serializer as jax_serializer
from gordo_tpu.builder.build_model import ModelBuilder as JaxModelBuilder
from gordo_tpu.machine import Machine as JaxMachine
from gordo_tpu_torch import serializer
from gordo_tpu_torch.builder import ModelBuilder
from gordo_tpu_torch.convert import model_from_flax, scaler_arrays_from_sklearn
from gordo_tpu_torch.models import AutoEncoder
from gordo_tpu_torch.models.anomaly.diff import DiffBasedAnomalyDetector
from gordo_tpu_torch.models.preprocessing import (
    MaxAbsScaler,
    MinMaxScaler,
    RobustScaler,
    StandardScaler,
    scaler_from_definition,
)
from gordo_tpu_torch.models.utils import (
    METRICS,
    Frame,
    KFold,
    ShuffleSplit,
    TimeSeriesSplit,
    splitter_from_definition,
)
from tests.conftest import CONFIG_STR, GORDO_PROJECT, GORDO_SINGLE_TARGET, SENSORS
from tests.test_torch_pipeline import _jax_initial_state

torch.set_num_threads(1)

# -- splitters ----------------------------------------------------------------

SPLITS = {
    "kfold-3": (KFold, dict(n_splits=3), 100),
    "kfold-5-uneven": (KFold, dict(n_splits=5), 103),
    "kfold-shuffle": (KFold, dict(n_splits=3, shuffle=True, random_state=0), 101),
    "kfold-shuffle-seed-7": (KFold, dict(n_splits=4, shuffle=True, random_state=7), 57),
    "shuffle-split": (ShuffleSplit, dict(n_splits=4, test_size=0.2, random_state=1), 90),
    "shuffle-split-default": (ShuffleSplit, dict(random_state=3), 41),
    "shuffle-split-sizes": (
        ShuffleSplit, dict(n_splits=3, train_size=0.5, test_size=0.25, random_state=2), 77),
    "shuffle-split-counts": (
        ShuffleSplit, dict(n_splits=2, train_size=30, test_size=11, random_state=5), 60),
    "time-series-gap": (TimeSeriesSplit, dict(n_splits=4, gap=3, test_size=9), 80),
    "time-series-test-size": (TimeSeriesSplit, dict(n_splits=3, test_size=20), 100),
}


@pytest.mark.parametrize("case", sorted(SPLITS))
def test_split_indices_equal_sklearn(case):
    cls, kwargs, n_rows = SPLITS[case]
    want = list(getattr(sk_model_selection, cls.__name__)(**kwargs).split(np.zeros(n_rows)))
    got = list(cls(**kwargs).split(np.zeros(n_rows)))
    assert len(got) == len(want)
    for (train, test), (want_train, want_test) in zip(got, want):
        np.testing.assert_array_equal(train, want_train)
        np.testing.assert_array_equal(test, want_test)


def test_splitters_refuse_what_sklearn_refuses():
    with pytest.raises(ValueError, match="random_state has no effect"):
        KFold(3, random_state=0)
    with pytest.raises(ValueError, match="greater than the number of samples"):
        list(KFold(5).split(np.zeros(3)))
    with pytest.raises(ValueError, match="train set will be empty"):
        list(ShuffleSplit(test_size=0.99).split(np.zeros(10)))


def test_splitter_definitions_resolve_and_unported_ones_raise():
    splitter = splitter_from_definition(
        {"sklearn.model_selection.KFold": {"n_splits": 4, "shuffle": True, "random_state": 2}}
    )
    assert isinstance(splitter, KFold) and splitter.n_splits == 4
    assert isinstance(splitter_from_definition("sklearn.model_selection.ShuffleSplit"),
                      ShuffleSplit)
    with pytest.raises(NotImplementedError, match="GroupKFold.*KFold.*ShuffleSplit"):
        splitter_from_definition("sklearn.model_selection.GroupKFold")


# -- scalers ------------------------------------------------------------------

SCALERS = {
    "robust": (RobustScaler, {}),
    "robust-options": (RobustScaler, dict(quantile_range=(10.0, 90.0), unit_variance=True)),
    "robust-no-centering": (RobustScaler, dict(with_centering=False)),
    "robust-no-scaling": (RobustScaler, dict(with_scaling=False)),
    "standard": (StandardScaler, {}),
    "standard-no-mean": (StandardScaler, dict(with_mean=False)),
    "standard-no-std": (StandardScaler, dict(with_std=False)),
    "minmax": (MinMaxScaler, {}),
    "minmax-range-clip": (MinMaxScaler, dict(feature_range=(-2, 3), clip=True)),
    "maxabs": (MaxAbsScaler, {}),
}


def _scaler_data(dtype, with_nan):
    rng = np.random.default_rng(11)
    X = (rng.standard_t(df=3, size=(257, 5)) * [1, 10, 0.1, 3, 1] + [0, 5, -2, 0, 1]).astype(dtype)
    X[:, 3] = 4.0  # a constant column: its scale becomes 1
    if with_nan:
        X[rng.random(X.shape) < 0.05] = np.nan
    return X


@pytest.mark.parametrize("dtype,with_nan", [(np.float64, False), (np.float64, True),
                                            (np.float32, False)])
@pytest.mark.parametrize("case", sorted(SCALERS))
def test_scaler_matches_sklearn(case, dtype, with_nan):
    cls, kwargs = SCALERS[case]
    X = _scaler_data(dtype, with_nan)
    new = _scaler_data(dtype, with_nan)[::-1] * 1.5
    ours = cls(**kwargs).fit(X)
    theirs = getattr(sk_preprocessing, cls.__name__)(**kwargs).fit(X)
    for name in cls.ARRAYS:
        want = getattr(theirs, name, None)
        if want is None:
            assert getattr(ours, name, None) is None, name
        else:
            np.testing.assert_allclose(getattr(ours, name), want, rtol=1e-12, err_msg=name)
    rtol = 1e-12 if dtype == np.float64 else 1e-6
    for method in ("transform", "inverse_transform"):
        got, want = getattr(ours, method)(new), getattr(theirs, method)(new)
        assert got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol, err_msg=method)
    assert repr(ours) == repr(theirs)


def test_scalers_round_trip_their_definitions_and_arrays():
    X = _scaler_data(np.float64, False)
    for cls, kwargs in SCALERS.values():
        fitted = cls(**kwargs).fit(X)
        again = scaler_from_definition(fitted.into_definition())
        assert type(again) is cls and again.get_params() == fitted.get_params()
        again.load_state_arrays(fitted.state_arrays())
        np.testing.assert_array_equal(again.transform(X), fitted.transform(X))
    with pytest.raises(NotImplementedError, match="QuantileTransformer"):
        scaler_from_definition("sklearn.preprocessing.QuantileTransformer")


# -- metrics ------------------------------------------------------------------


def _targets():
    rng = np.random.default_rng(5)
    y_true = rng.random((64, 3)) * [1, 5, 0.5] + 0.05
    y_pred = y_true + rng.normal(scale=0.1, size=y_true.shape)
    return y_true, np.abs(y_pred)


@pytest.mark.parametrize("name", sorted(METRICS))
def test_metric_matches_sklearn_per_tag_and_aggregate(name):
    y_true, y_pred = _targets()
    want_fn = getattr(sk_metrics, name)
    scorers = ModelBuilder.build_metrics_dict(
        ModelBuilder.metrics_from_list([f"sklearn.metrics.{name}"]), ["a", "b c", "d"], y_true
    )
    metric = name.replace("_", "-")
    assert set(scorers) == {metric, f"{metric}-a", f"{metric}-b-c", f"{metric}-d"}
    for j, tag in enumerate(["a", "b-c", "d"]):
        np.testing.assert_allclose(
            scorers[f"{metric}-{tag}"](y_true, y_pred),
            want_fn(y_true[:, j], y_pred[:, j]), rtol=1e-12,
        )
    if name == "max_error":
        with pytest.raises(ValueError, match="Multioutput not supported") as want_err:
            want_fn(y_true, y_pred)
        with pytest.raises(type(want_err.value), match="Multioutput not supported"):
            scorers[metric](y_true, y_pred)
    else:
        np.testing.assert_allclose(scorers[metric](y_true, y_pred), want_fn(y_true, y_pred),
                                   rtol=1e-12)


def test_log_metrics_refuse_targets_at_or_below_minus_one():
    y_true, y_pred = _targets()
    y_true[3, 1] = -1.0
    for name in ("mean_squared_log_error", "root_mean_squared_log_error"):
        with pytest.raises(ValueError, match="less than or equal to -1"):
            getattr(sk_metrics, name)(y_true, y_pred)
        with pytest.raises(ValueError, match="less than or equal to -1"):
            METRICS[name](y_true, y_pred)
    with pytest.raises(NotImplementedError, match="not ported"):
        ModelBuilder.metrics_from_list(["sklearn.metrics.d2_tweedie_score"])


# -- whole builds -------------------------------------------------------------

SIX_METRICS = [
    "explained_variance_score", "median_absolute_error", "max_error",
    "mean_absolute_percentage_error", "root_mean_squared_error", "mean_squared_log_error",
]
#: (evaluation, the detector's scaler definition or None for the default)
BUILD_OPTIONS = {
    "kfold-shuffle-standard": (
        {"cv": {"sklearn.model_selection.KFold": {"n_splits": 3, "shuffle": True,
                                                  "random_state": 0}},
         "scoring_scaler": "sklearn.preprocessing.StandardScaler", "metrics": SIX_METRICS},
        None,
    ),
    "shuffle-split-minmax": (
        {"cv": {"sklearn.model_selection.ShuffleSplit": {"n_splits": 3, "test_size": 0.25,
                                                         "random_state": 4}},
         "scoring_scaler": {"sklearn.preprocessing.MinMaxScaler": {"feature_range": [-1, 1]}},
         "metrics": ["r2_score", "root_mean_squared_log_error", "max_error"]},
        "sklearn.preprocessing.StandardScaler",
    ),
    "kfold-maxabs": (
        {"cv": {"sklearn.model_selection.KFold": {"n_splits": 3}},
         "scoring_scaler": "sklearn.preprocessing.MaxAbsScaler",
         "metrics": ["mean_absolute_error", "mean_squared_error"]},
        {"sklearn.preprocessing.RobustScaler": {"quantile_range": [10, 90],
                                                "unit_variance": True}},
    ),
}


def _conftest_machine(evaluation, scaler):
    """The conftest detector machine, shuffle off, with ``evaluation`` and
    the detector's ``scaler``."""
    config = yaml.safe_load(CONFIG_STR)
    machine = copy.deepcopy(next(m for m in config["machines"]
                                 if m["name"] == GORDO_SINGLE_TARGET))
    (detector,) = machine["model"].values()
    detector["base_estimator"]["sklearn.pipeline.Pipeline"]["steps"][1][
        "gordo_tpu.models.AutoEncoder"]["shuffle"] = False
    if scaler is not None:
        detector["scaler"] = scaler
    machine["evaluation"] = evaluation
    machine["project_name"] = GORDO_PROJECT
    return machine


@pytest.fixture(scope="module", params=sorted(BUILD_OPTIONS))
def option_builds(request):
    """(port model, port build metadata, JAX model, JAX build metadata)."""
    machine = _conftest_machine(*copy.deepcopy(BUILD_OPTIONS[request.param]))
    jax_model, jax_machine = JaxModelBuilder(
        JaxMachine.from_config(copy.deepcopy(machine), project_name=GORDO_PROJECT)
    ).build()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(AutoEncoder, "_initial_state", _jax_initial_state)
        model, port_machine = ModelBuilder(machine).build(device="cpu")
    return (model, port_machine.to_dict()["metadata"]["build_metadata"],
            jax_model, jax_machine.to_dict()["metadata"]["build_metadata"])


def test_option_build_cv_scores_match_jax(option_builds):
    _, got, _, want = option_builds
    got, want = (meta["model"]["cross_validation"] for meta in (got, want))
    assert set(got["scores"]) == set(want["scores"]) and got["scores"]
    for name, stats in want["scores"].items():
        assert set(got["scores"][name]) == set(stats), name
        for stat, value in stats.items():
            # a scorer that raises scores NaN on both sides (max_error of
            # several outputs; a log metric of scaled targets below -1)
            np.testing.assert_allclose(got["scores"][name][stat], value, rtol=1e-4,
                                       atol=1e-7, err_msg=f"{name} {stat}")
    got_splits, want_splits = (
        {k: v if isinstance(v, int) else str(v) for k, v in splits.items()}
        for splits in (got["splits"], want["splits"])
    )
    assert got_splits == want_splits


def test_option_build_thresholds_match_jax(option_builds):
    model, _, jax_model, _ = option_builds
    assert type(model.scaler).__name__ == type(jax_model.scaler).__name__
    assert model.scaler.get_params() == {
        k: list(v) if isinstance(v, tuple) else v
        for k, v in jax_model.scaler.get_params().items()
    }
    np.testing.assert_allclose(model.aggregate_threshold_, jax_model.aggregate_threshold_,
                               rtol=1e-4)
    np.testing.assert_allclose(model.feature_thresholds_,
                               jax_model.feature_thresholds_.to_numpy(), rtol=1e-4)
    np.testing.assert_allclose(
        list(model.aggregate_thresholds_per_fold_.values()),
        list(jax_model.aggregate_thresholds_per_fold_.values()), rtol=1e-4,
    )


# -- the detector's scaler, converted from JAX --------------------------------


def _rows(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n)[:, None]
    return (np.sin(2 * np.pi * t / 60 + np.arange(4)) * [1, 3, 0.5, 2]
            + 0.1 * rng.normal(size=(n, 4))).astype(np.float32)


@pytest.fixture(scope="module")
def converted_detector(tmp_path_factory):
    """(JAX detector, port detector converted from it, port detector after
    a save and a load): a feedforward detector with a StandardScaler,
    cross-validated (thresholds) and fitted."""
    definition = {
        "gordo_tpu.models.anomaly.diff.DiffBasedAnomalyDetector": {
            "base_estimator": {"gordo_tpu.models.AutoEncoder": {
                "kind": "feedforward_hourglass", "epochs": 2, "seed": 2}},
            "scaler": "sklearn.preprocessing.StandardScaler",
            "window": 6,
        }
    }
    X = pd.DataFrame(_rows(400, seed=1), columns=SENSORS)
    jax_detector = jax_serializer.from_definition(definition)
    jax_detector.cross_validate(X=X, y=X)
    jax_detector.fit(X, X)
    thresholds = {
        attr: None if getattr(jax_detector, attr, None) is None
        else np.asarray(getattr(jax_detector, attr))
        for attr in ("aggregate_threshold_", "feature_thresholds_",
                     "smooth_aggregate_threshold_", "smooth_feature_thresholds_")
    }
    port = model_from_flax(
        jax_detector.base_estimator.params_, jax_serializer.into_definition(jax_detector),
        thresholds=thresholds, scaler_arrays=scaler_arrays_from_sklearn(jax_detector.scaler),
        device="cpu",
    )
    path = tmp_path_factory.mktemp("artifact") / "machine"
    serializer.dump(port, path, {})
    return jax_detector, port, serializer.load(path, device="cpu")


def test_converted_detector_keeps_the_standard_scaler(converted_detector):
    jax_detector, port, loaded = converted_detector
    for model in (port, loaded):
        assert isinstance(model, DiffBasedAnomalyDetector)
        assert isinstance(model.scaler, StandardScaler)
        for name in ("mean_", "var_", "scale_"):
            np.testing.assert_array_equal(getattr(model.scaler, name),
                                          getattr(jax_detector.scaler, name))


@pytest.mark.parametrize("which", ["converted", "loaded"])
def test_converted_detector_anomaly_frame_matches_jax(converted_detector, which):
    jax_detector, port, loaded = converted_detector
    model = port if which == "converted" else loaded
    rows = _rows(90, seed=9)
    index = pd.date_range("2020-01-01", periods=len(rows), freq="10min", tz="UTC")
    frame = pd.DataFrame(rows, columns=SENSORS, index=index)
    want = jax_detector.anomaly(frame, frame)
    port_frame = Frame(rows, list(SENSORS), list(index.to_pydatetime()))
    got = model.anomaly(port_frame, port_frame)
    tops = list(dict.fromkeys(want.columns.get_level_values(0)))
    assert list(got.blocks) == tops
    for top in tops:
        if top in ("start", "end"):
            continue
        np.testing.assert_allclose(got[top], want[top].to_numpy().reshape(len(got), -1),
                                   rtol=1e-4, atol=1e-5, err_msg=top)
