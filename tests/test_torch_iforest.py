"""
The port's isolation forest (``gordo_tpu_torch.data.iforest``) against
scikit-learn's ``IsolationForest`` in the configuration the JAX period
filter fits (300 trees, ``max_samples=min(1000, n)``, ``max_features=1.0``,
no bootstrap, ``random_state=42``): every tree's arrays exactly equal
(a draw out of order would change them), ``score_samples`` within 1e-12,
``offset_`` within 1e-12 and ``predict`` equal; the row draws, the
average path length and pandas' ``ewm(halflife=6).mean()`` exactly; and
``filter_method: iforest | all`` (smoothed or not) against the JAX
``FilterPeriods`` and the JAX dataset, drop periods equal.
"""

import numpy as np
import pandas as pd
import pytest
from sklearn.ensemble import IsolationForest as SkIsolationForest
from sklearn.ensemble._iforest import _average_path_length
from sklearn.utils.random import sample_without_replacement as sk_sample

from gordo_tpu.data import _get_dataset as jax_get_dataset
from gordo_tpu.data.filter_periods import FilterPeriods as JaxFilterPeriods
from gordo_tpu_torch.data import _get_dataset
from gordo_tpu_torch.data.filter_periods import FilterPeriods
from gordo_tpu_torch.data.iforest import (
    IsolationForest,
    average_path_length,
    ewm_mean,
    sample_without_replacement,
)
from tests.test_torch_data import CONFTEST_DATASET, _ns
from tests.test_torch_data_options import _noisy_frame

TREE_ARRAYS = ("feature", "threshold", "children_left", "children_right", "n_node_samples")


def _rows(n, constant):
    X = np.random.default_rng(n).normal(size=(n, 3))
    X[: n // 50, 0] += 6.0  # a few outliers
    if constant:
        X[:, 1] = 2.5
    return X


@pytest.mark.parametrize("constant", [False, True], ids=["varying", "constant-column"])
@pytest.mark.parametrize("n", [50, 999, 1000, 5000])
def test_trees_scores_and_predictions_equal_sklearn(n, constant):
    X = _rows(n, constant)
    settings = dict(n_estimators=300, max_samples=min(1000, n), contamination=0.03,
                    random_state=42)
    want = SkIsolationForest(max_features=1.0, bootstrap=False, n_jobs=-1, **settings).fit(X)
    got = IsolationForest(**settings).fit(X)
    assert got.max_samples_ == want.max_samples_
    assert len(got.estimators_) == len(want.estimators_) == 300
    for i, (mine, theirs) in enumerate(zip(got.estimators_, want.estimators_)):
        for name in TREE_ARRAYS:
            np.testing.assert_array_equal(getattr(mine, name), getattr(theirs.tree_, name),
                                          err_msg=f"tree {i} {name}")
    np.testing.assert_allclose(got.score_samples(X), want.score_samples(X), rtol=0, atol=1e-12)
    assert got.offset_ == pytest.approx(want.offset_, abs=1e-12)
    np.testing.assert_array_equal(got.predict(X), want.predict(X))
    # rows the forest never saw
    fresh = np.random.default_rng(n + 1).normal(size=(64, 3)) * 3
    np.testing.assert_allclose(got.decision_function(fresh), want.decision_function(fresh),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("population,samples", [(20, 20), (5000, 1000), (1010, 1000),
                                                (200_000, 1000), (7, 0)])
def test_row_draws_equal_sklearn(population, samples):
    """The ``auto`` method's three samplers (reservoir, permutation,
    tracking selection) and the draws they leave behind."""
    mine, theirs = np.random.RandomState(3), np.random.RandomState(3)
    np.testing.assert_array_equal(sample_without_replacement(population, samples, mine),
                                  sk_sample(population, samples, random_state=theirs))
    assert mine.randint(1 << 30) == theirs.randint(1 << 30)


def test_average_path_length_equals_sklearn():
    n = np.array([0, 1, 2, 3, 4, 17, 256, 1000])
    np.testing.assert_array_equal(average_path_length(n), _average_path_length(n))


def test_ewm_mean_equals_pandas():
    values = np.random.default_rng(0).normal(size=(400, 3))
    values[50:70, 1] = 1.5  # a constant run
    want = pd.DataFrame(values).ewm(halflife=6).mean().to_numpy()
    np.testing.assert_array_equal(ewm_mean(values, halflife=6), want)


@pytest.mark.parametrize("method,smooth,contamination",
                         [("iforest", True, 0.03), ("all", True, 0.05), ("iforest", False, 0.1)])
def test_filter_periods_equal_jax(method, smooth, contamination):
    frame = _noisy_frame()
    options = dict(granularity="10T", filter_method=method, iforest_smooth=smooth,
                   contamination=contamination)
    want_data, want_periods, want_pred = JaxFilterPeriods(**options).filter_data(frame)
    keep, periods, flags = FilterPeriods(**options).filter_data(frame.to_numpy(),
                                                                _ns(frame.index))
    np.testing.assert_array_equal(flags["iforest"], want_pred["iforest"]["pred"].to_numpy() == -1)
    assert periods == want_periods and periods["iforest"]
    np.testing.assert_array_equal(_ns(frame.index[keep]), _ns(want_data.index))


def test_dataset_forest_filter_metadata_equals_jax():
    config = dict(CONFTEST_DATASET, filter_periods={"filter_method": "all", "window": 12,
                                                    "n_iqr": 1, "iforest_smooth": True})
    port = _get_dataset(config)
    X, y, index = port.get_data()
    jax = jax_get_dataset(config)
    want_X, _ = jax.get_data()
    got, want = port.get_metadata()["filtered_periods"], jax.get_metadata()["filtered_periods"]
    assert got == want and set(got) == {"median", "iforest"} and got["iforest"]
    np.testing.assert_array_equal(index.astype(np.int64), _ns(want_X.index))
    np.testing.assert_allclose(X, want_X.to_numpy(), rtol=1e-12, atol=1e-12)
