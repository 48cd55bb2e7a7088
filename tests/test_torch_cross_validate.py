"""
The port's evaluation path against the JAX package's and scikit-learn's:
the building blocks (``TimeSeriesSplit``, the RobustScaler fit, the four
default metrics), ``DiffBasedAnomalyDetector.cross_validate`` and its
thresholds, and the port's ``ModelBuilder`` from arrays to a served
artifact.

The builder's fallback for a model with no ``cross_validate`` of its own
(a bare ``AutoEncoder`` or ``TransformerAutoEncoder``): the port's numpy
``cross_validate`` against scikit-learn's over the JAX estimator, and
whole builds of ``examples/machines_fleet.yaml``'s ``example-pump-0`` and
the conftest ``gordo-base-model`` against the JAX builder's. Their fits
shuffle with different generators (threefry against Philox), so the
parity builds turn ``shuffle`` off; the CLI builds in
``tests/test_torch_cli.py`` run the configs as they are.

``cross_validate`` parity: both detectors train every fold from the JAX
init of the same seed (``solo_init_key``; the port gets it through
``_initial_state``) with dropout 0 and no shuffle, so the folds see the
same batches. Both take their fold-parallel path (the folds as one fleet
fit, ``cv-fast-path`` true), as a bare estimator's do.
Thresholds rtol 1e-3: float32 training in another summation order,
through a rolling min/max of the fold errors.
"""

import copy
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
import yaml
from sklearn import metrics as sk_metrics
from sklearn.model_selection import TimeSeriesSplit as SkTimeSeriesSplit
from sklearn.model_selection import cross_validate as sk_cross_validate
from sklearn.preprocessing import MinMaxScaler as SkMinMaxScaler
from sklearn.preprocessing import RobustScaler
from werkzeug.test import Client

from gordo_tpu.builder.build_model import ModelBuilder as JaxModelBuilder
from gordo_tpu.machine import Machine
from gordo_tpu.machine.metadata import CrossValidationMetaData, ModelBuildMetadata
from gordo_tpu.models import AutoEncoder as JaxAutoEncoder
from gordo_tpu.models import TransformerAutoEncoder as JaxTransformerAutoEncoder
from gordo_tpu.models.anomaly import DiffBasedAnomalyDetector as JaxDetector
from gordo_tpu.models.core import solo_init_key
from gordo_tpu.workflow.config_elements.normalized_config import NormalizedConfig
from gordo_tpu.workflow.workflow_generator import get_dict_from_yaml
from gordo_tpu_torch import serializer
from gordo_tpu_torch.builder import ModelBuilder
from gordo_tpu_torch.convert import transformer_state_dict
from gordo_tpu_torch.models import AutoEncoder, TransformerAutoEncoder
from gordo_tpu_torch.models.anomaly.diff import DiffBasedAnomalyDetector
from gordo_tpu_torch.models.preprocessing import RobustScaler as RobustScaling
from gordo_tpu_torch.models.pipeline import MinMaxScaler
from gordo_tpu_torch.models.utils import METRICS, TimeSeriesSplit, cross_validate, metric_wrapper
from gordo_tpu_torch.server.app import build_app
from tests.conftest import CONFIG_STR, GORDO_BASE_TARGETS, GORDO_PROJECT
from tests.test_torch_pipeline import _jax_initial_state as _feedforward_initial_state

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# the models here are tiny: one thread runs them as fast as many, and
# leaves the cores to the other test workers
torch.set_num_threads(1)

TAGS = ["GRA-TURB-SPEED 1", "GRA-TURB-TEMP 2", "GRA-TURB-LOAD 3"]
LOOKBACK = 8
BASE = dict(
    kind="transformer_model", lookback_window=LOOKBACK, d_model=16, n_heads=2, n_layers=1,
    epochs=2, batch_size=32, dropout=0.0, seed=7,
)


def _series(n_rows, seed):
    """Daily-cycle sensor rows with noise, (n_rows, 3) float32."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_rows)[:, None]
    wave = np.sin(2 * np.pi * t / 144 + np.arange(len(TAGS)))
    return (wave + 0.1 * rng.normal(size=(n_rows, len(TAGS)))).astype(np.float32)


# -- building blocks against scikit-learn -----------------------------------


@pytest.mark.parametrize(
    "n_rows,kwargs",
    [
        (100, {"n_splits": 3}),
        (101, {"n_splits": 5, "test_size": 7, "gap": 2}),
        (50, {"n_splits": 4, "max_train_size": 10}),
        (21744, {"n_splits": 3}),
    ],
)
def test_time_series_split_matches_sklearn(n_rows, kwargs):
    got = list(TimeSeriesSplit(**kwargs).split(np.zeros(n_rows)))
    want = list(SkTimeSeriesSplit(**kwargs).split(np.zeros(n_rows)))
    assert len(got) == len(want) == kwargs["n_splits"]
    for (train, test), (want_train, want_test) in zip(got, want):
        np.testing.assert_array_equal(train, want_train)
        np.testing.assert_array_equal(test, want_test)


def test_time_series_split_refuses_too_many_splits():
    with pytest.raises(ValueError, match="folds"):
        list(TimeSeriesSplit(n_splits=5).split(np.zeros(4)))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_robust_scaling_matches_sklearn(dtype):
    rng = np.random.default_rng(3)
    X = rng.standard_t(df=2, size=(301, 4)).astype(dtype)
    X[:, 2] = 5.0  # a constant column: scale 0 becomes 1
    X[::7, 0] *= 40.0  # outliers
    ours = RobustScaling().fit(X)
    theirs = RobustScaler().fit(X)
    np.testing.assert_allclose(ours.center_, theirs.center_, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ours.scale_, theirs.scale_, rtol=1e-6, atol=1e-6)
    new = rng.normal(size=(20, 4)).astype(dtype)
    got, want = ours.transform(new), theirs.transform(new)
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _metric_cases():
    rng = np.random.default_rng(4)
    y_true = rng.normal(size=(60, 3))
    y_pred = y_true + 0.3 * rng.normal(size=(60, 3))
    constant = y_true.copy()
    constant[:, 1] = 2.0  # a constant target column: scikit-learn's force_finite
    exact = y_true.copy()
    exact[:, 1] = 2.0
    return {
        "multi": (y_true, y_pred),
        "one-column": (y_true[:, 0], y_pred[:, 0]),
        "constant-column": (constant, y_pred),
        "constant-exact": (constant, exact),
    }


@pytest.mark.parametrize("case", list(_metric_cases()))
@pytest.mark.parametrize("name", sorted(METRICS))
def test_metrics_match_sklearn(name, case):
    y_true, y_pred = _metric_cases()[case]
    try:
        want = getattr(sk_metrics, name)(y_true, y_pred)
    except ValueError as err:
        # max_error of several outputs, a log metric of targets at or
        # below -1: the port refuses them as scikit-learn does
        with pytest.raises(ValueError, match=str(err).split(" when ")[0]):
            METRICS[name](y_true, y_pred)
        return
    np.testing.assert_allclose(METRICS[name](y_true, y_pred), want, rtol=1e-6, atol=1e-6)


def test_metric_wrapper_aligns_and_scales_like_jax():
    from gordo_tpu.models.utils import metric_wrapper as jax_metric_wrapper

    rng = np.random.default_rng(5)
    y_true, y_pred = rng.normal(size=(40, 3)), rng.normal(size=(33, 3))
    fitted = RobustScaling().fit(y_true)
    want = jax_metric_wrapper(sk_metrics.r2_score, RobustScaler().fit(y_true))(y_true, y_pred)
    got = metric_wrapper(METRICS["r2_score"], fitted)(y_true, y_pred)
    np.testing.assert_allclose(got, want, rtol=1e-6)


# -- cross_validate against the JAX detector --------------------------------


def _jax_initial_state(self, spec, seed):
    """The JAX init a solo JAX fit of these kwargs and seed starts from."""
    kwargs = {k: v for k, v in self.kwargs.items() if k != "attention_impl"}
    module = JaxTransformerAutoEncoder(self.kind, **kwargs)._build_spec().module
    params = module.init(solo_init_key(seed), jnp.zeros((1, LOOKBACK, kwargs["n_features"])))
    return {name: torch.tensor(value) for name, value in transformer_state_dict(params).items()}


def _jsonable(value):
    return json.loads(json.dumps(value, default=float))


@pytest.fixture(scope="module")
def cv_pair():
    """(JAX detector, port detector, JAX cv output, port cv output), both
    cross-validated on the same rows with the builder's scorers, then
    fitted on all of them."""
    X = _series(360, seed=6)
    frame = pd.DataFrame(X, columns=TAGS)
    jax_detector = JaxDetector(
        base_estimator=JaxTransformerAutoEncoder(attention_impl="dense", **BASE), window=12
    )
    jax_scorers = JaxModelBuilder.build_metrics_dict(
        JaxModelBuilder.metrics_from_list(None), frame, scaler=RobustScaler()
    )
    jax_cv = jax_detector.cross_validate(X=frame, y=frame, scoring=jax_scorers)
    jax_detector.fit(frame, frame)

    port_detector = DiffBasedAnomalyDetector(
        TransformerAutoEncoder(attention_impl="flash", **BASE), window=12
    )
    port_scorers = ModelBuilder.build_metrics_dict(
        ModelBuilder.metrics_from_list(None), TAGS, X, RobustScaling()
    )
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TransformerAutoEncoder, "_initial_state", _jax_initial_state)
        port_cv = port_detector.cross_validate(X=X, y=X, scoring=port_scorers, device="cpu")
        port_detector.fit(X, X, device="cpu")
    assert set(port_scorers) == set(jax_scorers)
    return jax_detector, port_detector, jax_cv, port_cv


def test_cross_validate_thresholds_match_jax(cv_pair):
    jax_detector, port_detector, _, _ = cv_pair
    assert port_detector.cv_fast_path_ is True
    assert jax_detector.cv_fast_path_ is True
    for attr in ("aggregate_thresholds_per_fold_", "smooth_aggregate_thresholds_per_fold_"):
        got, want = getattr(port_detector, attr), getattr(jax_detector, attr)
        assert list(got) == list(want) == ["fold-0", "fold-1", "fold-2"]
        np.testing.assert_allclose(list(got.values()), list(want.values()), rtol=1e-3, err_msg=attr)
    for attr in ("feature_thresholds_per_fold_", "smooth_feature_thresholds_per_fold_"):
        got, want = getattr(port_detector, attr), getattr(jax_detector, attr)
        assert list(got) == list(want.index)
        np.testing.assert_allclose(
            np.stack(list(got.values())), want.to_numpy(), rtol=1e-3, err_msg=attr
        )
    for attr in (
        "aggregate_threshold_",
        "feature_thresholds_",
        "smooth_aggregate_threshold_",
        "smooth_feature_thresholds_",
    ):
        got, want = getattr(port_detector, attr), np.asarray(getattr(jax_detector, attr))
        assert np.all(np.asarray(got) > 0)
        np.testing.assert_allclose(got, want, rtol=1e-3, err_msg=attr)


def test_cross_validate_scores_match_jax(cv_pair):
    _, _, jax_cv, port_cv = cv_pair
    names = [key for key in jax_cv if key.startswith("test_")]
    assert sorted(names) == sorted(key for key in port_cv if key.startswith("test_"))
    for name in names:
        np.testing.assert_allclose(port_cv[name], jax_cv[name], rtol=1e-3, atol=1e-4, err_msg=name)
    assert len(port_cv["estimator"]) == len(port_cv["fit_time"]) == 3


def test_detector_metadata_matches_jax(cv_pair):
    jax_detector, port_detector, _, _ = cv_pair
    got, want = _jsonable(port_detector.get_metadata()), _jsonable(jax_detector.get_metadata())
    assert set(got) == set(want)
    assert got["cv-fast-path"] is want["cv-fast-path"] is True
    for key in ("aggregate-thresholds-per-fold", "smooth-aggregate-thresholds-per-fold",
                "feature-thresholds-per-fold", "smooth-feature-thresholds-per-fold"):
        assert set(got[key]) == set(want[key]), key
        for sub in want[key]:
            if isinstance(want[key][sub], dict):
                assert set(got[key][sub]) == set(want[key][sub]), key
    np.testing.assert_allclose(got["aggregate-threshold"], want["aggregate-threshold"], rtol=1e-3)
    assert got["window"] == want["window"] == 12
    assert got["forecast_steps"] == want["forecast_steps"] == 0
    assert set(got["history"]) == set(want["history"])


# -- the builder, from arrays to a served artifact --------------------------


PROJECT, MACHINE = "plant-a-anomaly", "turbine-t"


def _machine():
    return {
        "name": MACHINE,
        "project_name": PROJECT,
        "dataset": {
            "tags": TAGS,
            "train_start_date": "2019-01-01T00:00:00+00:00",
            "train_end_date": "2019-01-03T12:00:00+00:00",
            "resolution": "10T",
        },
        "model": {
            "gordo_tpu.models.anomaly.DiffBasedAnomalyDetector": {
                "base_estimator": {
                    "gordo_tpu.models.TransformerAutoEncoder": {
                        **{k: v for k, v in BASE.items() if k != "seed"},
                        "attention_impl": "flash",
                    }
                }
            }
        },
        "evaluation": {"seed": 5},
    }


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    X = _series(360, seed=8)
    index = pd.date_range("2019-01-01", periods=len(X), freq="10min", tz="UTC")
    collection = tmp_path_factory.mktemp("build") / "1700000000000"
    model, machine = ModelBuilder(_machine()).build(
        X, X, index=list(index), output_dir=collection / MACHINE, device="cpu"
    )
    return X, index, collection, model, machine


def test_builder_metadata_has_the_jax_keys(built):
    X, index, _, model, machine = built
    build_metadata = machine.to_dict()["metadata"]["build_metadata"]
    assert set(build_metadata["model"]) == set(ModelBuildMetadata().to_dict())
    cv = build_metadata["model"]["cross_validation"]
    assert set(cv) == set(CrossValidationMetaData().to_dict())
    frame = pd.DataFrame(X, columns=TAGS, index=index)
    want_scores = JaxModelBuilder.build_metrics_dict(JaxModelBuilder.metrics_from_list(None), frame)
    assert set(cv["scores"]) == set(want_scores)
    assert all(np.isfinite(list(stats.values())).all() for stats in cv["scores"].values())
    want_splits = JaxModelBuilder.build_split_dict(frame, SkTimeSeriesSplit(n_splits=3))
    assert cv["splits"] == want_splits
    assert build_metadata["model"]["model_offset"] == LOOKBACK - 1
    assert model.base_estimator.kwargs["seed"] == 5  # the evaluation seed, injected
    meta = build_metadata["model"]["model_meta"]
    assert meta["cv-fast-path"] is True  # a bare estimator's folds train as one fleet fit
    assert len(meta["aggregate-thresholds-per-fold"]) == 3
    assert set(machine.to_dict()) == {
        "name", "project_name", "dataset", "model", "evaluation", "metadata", "runtime"
    }


def test_built_artifact_is_served_with_confidences(built):
    X, index, collection, model, _ = built
    loaded = serializer.load(collection / MACHINE, device="cpu")
    np.testing.assert_allclose(loaded.predict(X), model.predict(X), atol=1e-6)
    stored = serializer.load_metadata(collection / MACHINE)
    assert "aggregate-thresholds-per-fold" in stored["metadata"]["build_metadata"]["model"]["model_meta"]

    rows = X[:144]
    stamps = [stamp.isoformat() for stamp in index[:144]]
    frame = {tag: dict(zip(stamps, rows[:, j].tolist())) for j, tag in enumerate(TAGS)}
    client = Client(build_app(str(collection), device="cpu"))
    reply = client.post(
        f"/gordo/v0/{PROJECT}/{MACHINE}/anomaly/prediction", json={"X": frame, "y": frame}
    )
    assert reply.status_code == 200
    data = json.loads(reply.get_data())["data"]
    assert "total-anomaly-confidence" in data and "anomaly-confidence" in data
    (confidence,) = data["total-anomaly-confidence"].values()
    confidence = np.asarray(list(confidence.values()), dtype=float)
    assert len(confidence) == 144 - LOOKBACK + 1 and np.isfinite(confidence).all()


# -- bare models: the builder's cross_validate fallback ----------------------


REPO_ROOT = Path(__file__).resolve().parent.parent


def _workflow_json(config, project):
    """{name: machine as the workflow passes it to ``build`` (JSON)}."""
    machines = NormalizedConfig(config, project_name=project).machines
    return {m.name: json.loads(json.dumps(m.to_dict(), default=str)) for m in machines}


def bare_machines():
    """``examples/machines_fleet.yaml``'s ``example-pump-0`` and the conftest
    ``gordo-base-model``: bare feedforward AutoEncoders, as ``build`` gets them."""
    fleet = get_dict_from_yaml(str(REPO_ROOT / "examples" / "machines_fleet.yaml"))
    pump = next(m for m in fleet if m["name"] == "example-pump-0")
    machines = _workflow_json({"machines": [pump]}, pump["project_name"])
    base = _workflow_json(yaml.safe_load(CONFIG_STR), GORDO_PROJECT)[GORDO_BASE_TARGETS[0]]
    machines[GORDO_BASE_TARGETS[0]] = base
    return machines


# (port class, JAX class, JAX init, kwargs, score rtol): the transformer's
# scores take the detector tests' 1e-3 (float32 attention training in
# another summation order)
BARE_ESTIMATORS = {
    "feedforward": (
        AutoEncoder, JaxAutoEncoder, _feedforward_initial_state,
        dict(kind="feedforward_hourglass", epochs=2, batch_size=16, shuffle=False, seed=3), 1e-4,
    ),
    "transformer": (
        TransformerAutoEncoder, JaxTransformerAutoEncoder, _jax_initial_state, BASE, 1e-3,
    ),
}


@pytest.mark.parametrize("family", sorted(BARE_ESTIMATORS))
def test_cross_validate_matches_scikit_learn(family):
    """The port's ``cross_validate`` on a bare estimator against
    scikit-learn's over the JAX estimator with the JAX builder's scorers:
    three folds, the same keys, and the same scores (the transformer's
    windowed prediction aligned to the last test rows by ``metric_wrapper``
    on both sides)."""
    port_cls, jax_cls, initial_state, kwargs, rtol = BARE_ESTIMATORS[family]
    X = _series(300, seed=10)
    frame = pd.DataFrame(X, columns=TAGS)
    jax_kwargs = dict(kwargs, attention_impl="dense") if family == "transformer" else kwargs
    want = sk_cross_validate(
        jax_cls(**jax_kwargs), frame, frame, cv=SkTimeSeriesSplit(n_splits=3),
        scoring=JaxModelBuilder.build_metrics_dict(
            JaxModelBuilder.metrics_from_list(None), frame, scaler=RobustScaler()
        ),
        return_estimator=True,
    )
    splits = []

    class RecordingSplit(TimeSeriesSplit):
        def split(self, X, y=None):
            for train, test in super().split(X, y):
                splits.append((train, test))
                yield train, test

    estimator = port_cls(**(dict(kwargs, attention_impl="flash") if family == "transformer"
                            else kwargs))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_cls, "_initial_state", initial_state)
        got = cross_validate(
            estimator, X, X, cv=RecordingSplit(n_splits=3),
            scoring=ModelBuilder.build_metrics_dict(
                ModelBuilder.metrics_from_list(None), TAGS, X, RobustScaling()
            ),
            device="cpu",
        )
    assert set(got) == set(want)
    for key in ("fit_time", "score_time"):
        assert isinstance(got[key], np.ndarray) and got[key].shape == want[key].shape == (3,)
    assert len(got["estimator"]) == 3 and estimator not in got["estimator"]
    assert not hasattr(estimator, "spec_")  # each fold fits a clone
    for (train, test), (want_train, want_test) in zip(
        splits, SkTimeSeriesSplit(n_splits=3).split(X)
    ):
        np.testing.assert_array_equal(train, want_train)
        np.testing.assert_array_equal(test, want_test)
    for name in (key for key in want if key.startswith("test_")):
        np.testing.assert_allclose(got[name], want[name], rtol=rtol, atol=rtol / 10, err_msg=name)


@pytest.fixture(scope="module", params=sorted(bare_machines()))
def bare_builds(request):
    """(port build metadata, JAX build metadata) of one bare-model machine,
    both fold fits and the final fit from the JAX init, shuffle off."""
    machine = copy.deepcopy(bare_machines()[request.param])
    (estimator,) = machine["model"].values()
    estimator["shuffle"] = False
    _, jax_machine = JaxModelBuilder(
        Machine.from_config(machine, project_name=machine["project_name"])
    ).build()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(AutoEncoder, "_initial_state", _feedforward_initial_state)
        _, port_machine = ModelBuilder(machine).build(device="cpu")
    return (port_machine.to_dict()["metadata"]["build_metadata"],
            jax_machine.to_dict()["metadata"]["build_metadata"])


def test_bare_model_build_cv_scores_match_jax(bare_builds):
    got, want = (meta["model"]["cross_validation"] for meta in bare_builds)
    assert set(got["scores"]) == set(want["scores"]) and got["scores"]
    for name, stats in want["scores"].items():
        assert set(got["scores"][name]) == set(stats)
        assert {f"fold-{i}" for i in (1, 2, 3)} <= set(stats)
        for stat, value in stats.items():
            np.testing.assert_allclose(
                got["scores"][name][stat], value, rtol=1e-4, err_msg=f"{name} {stat}"
            )
    got_splits, want_splits = (
        {k: v if isinstance(v, int) else str(v) for k, v in splits.items()}
        for splits in (got["splits"], want["splits"])
    )
    assert got_splits == want_splits and len(got_splits) == 3 * 6
    assert got["cv_duration_sec"] > 0


def test_model_without_predict_gets_empty_cv_metadata():
    machine = bare_machines()[GORDO_BASE_TARGETS[0]]
    X = _series(60, seed=11)
    frame = pd.DataFrame(X, columns=TAGS)
    want = JaxModelBuilder(
        Machine.from_config(machine, project_name=machine["project_name"])
    )._run_cross_validation(SkMinMaxScaler(), frame, frame).to_dict()
    got = ModelBuilder(machine)._run_cross_validation(
        MinMaxScaler(), X, X, list(range(len(X))), "cpu"
    ).to_dict()
    assert got == want == {"scores": {}, "cv_duration_sec": None, "splits": {}}
