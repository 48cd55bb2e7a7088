"""
DiffBasedAnomalyDetector (the port of ``gordo_tpu.models.anomaly.diff``):
``fit``, ``cross_validate`` (which derives the thresholds), ``anomaly()``
and the confidence columns, in numpy around the base estimator.

The JAX detector's RobustScaler becomes :class:`RobustScaling`, its two
arrays ``center_`` and ``scale_`` fitted with scikit-learn's defaults.

Cross-validation over a bare port estimator whose folds train on
contiguous rows (``TimeSeriesSplit`` gives them) trains every fold at
once, as one :class:`~gordo_tpu_torch.parallel.fleet.FleetTrainer` fit
with the fold axis as the machine axis (``_fold_parallel_cv``, JAX's
fast path): every fold starts from the solo seed's initial weights and
gets its own scaler fitted on its training targets, and ``cv-fast-path``
is true, as in JAX. Anything else (a ``Pipeline`` base, a callback with
no fleet counterpart) trains the folds one after another, as JAX's
sequential path does. Unlike JAX, a failing fold-parallel fit raises: it
does not fall back to the sequential path, so a fault in the fleet
trainer or its kernels cannot hide behind a slower build.
"""

import time
from datetime import timedelta
from typing import Callable, Dict, Optional

import numpy as np

from gordo_tpu_torch.device import DeviceLike
from gordo_tpu_torch.models.core import DEFAULT_SEED, BaseTorchEstimator, as_2d
from gordo_tpu_torch.models.utils import (
    BlockFrame,
    Frame,
    TimeSeriesSplit,
    make_base_dataframe,
)

#: fitted thresholds an artifact may carry (None where absent)
THRESHOLD_ATTRS = (
    "aggregate_threshold_",
    "feature_thresholds_",
    "smooth_aggregate_threshold_",
    "smooth_feature_thresholds_",
)


class RobustScaling:
    """``sklearn.preprocessing.RobustScaler`` with its defaults: the median
    and the 25-75 interquartile range per column."""

    def __init__(self, center: Optional[np.ndarray] = None, scale: Optional[np.ndarray] = None):
        self.center_ = None if center is None else np.asarray(center)
        self.scale_ = None if scale is None else np.asarray(scale)

    def fit(self, X) -> "RobustScaling":
        """Median and IQR of each column of X (NaNs ignored); a scale
        within ten machine epsilons of 0 becomes 1."""
        X = np.asarray(X)
        X = X.astype(X.dtype if X.dtype in (np.float32, np.float64) else np.float64)
        self.center_ = np.nanmedian(X, axis=0)
        q25, q75 = np.nanpercentile(X, (25.0, 75.0), axis=0)
        scale = q75 - q25
        scale[scale < 10 * np.finfo(scale.dtype).eps] = 1.0
        self.scale_ = scale
        return self

    def __repr__(self):
        return "RobustScaler()"

    def transform(self, X) -> np.ndarray:
        """``(X - center_) / scale_`` in X's float type, as sklearn does it
        (in place on a copy, so a float32 X stays float32)."""
        X = np.asarray(X)
        X = X.astype(X.dtype if X.dtype in (np.float32, np.float64) else np.float64)
        X -= self.center_
        X /= self.scale_
        return X


def rolling_median(values: np.ndarray, window: int) -> np.ndarray:
    """
    Column-wise rolling median over ``window`` rows, NaN for the first
    ``window - 1`` rows (pandas' ``rolling(window).median()``).
    """
    values = np.asarray(values, dtype=np.float64)
    out = np.full(values.shape, np.nan)
    if len(values) >= window:
        windows = np.lib.stride_tricks.sliding_window_view(values, window, axis=0)
        out[window - 1 :] = np.median(windows, axis=-1)
    return out


def rolled_threshold(errors: np.ndarray, window: int):
    """
    The threshold statistic: the largest rolling-window minimum of an
    error series (pandas' ``rolling(window).min().max()``), per column of
    a 2-D ``errors``; NaN when the series is shorter than ``window``.
    """
    errors = np.asarray(errors, dtype=np.float64)
    if len(errors) < window:
        return np.full(errors.shape[1:], np.nan) if errors.ndim > 1 else float("nan")
    windows = np.lib.stride_tricks.sliding_window_view(errors, window, axis=0)
    peak = windows.min(axis=-1).max(axis=0)
    return peak if errors.ndim > 1 else float(peak)


def _per_fold_frame(by_fold: Dict[str, np.ndarray]) -> Dict[int, Dict[str, float]]:
    """Per-fold per-tag thresholds in the layout of the JAX detector's
    ``DataFrame.to_dict()``: {tag index: {fold label: value}}."""
    if not by_fold:
        return {}
    n_tags = len(next(iter(by_fold.values())))
    return {
        j: {label: float(values[j]) for label, values in by_fold.items()}
        for j in range(n_tags)
    }


class DiffBasedAnomalyDetector:
    def __init__(
        self,
        base_estimator: BaseTorchEstimator,
        require_thresholds: bool = True,
        window: Optional[int] = None,
    ):
        self.base_estimator = base_estimator
        self.require_thresholds = require_thresholds
        self.window = window
        self.scaler: Optional[RobustScaling] = None
        for attr in THRESHOLD_ATTRS:
            setattr(self, attr, None)

    def clone(self) -> "DiffBasedAnomalyDetector":
        """An unfitted detector of the same definition (sklearn's clone)."""
        return DiffBasedAnomalyDetector(
            self.base_estimator.clone(), self.require_thresholds, self.window
        )

    # -- fit and thresholds -------------------------------------------------
    def fit(self, X, y, *, device: DeviceLike = None) -> "DiffBasedAnomalyDetector":
        """Fit the base estimator, then the scaler on the targets (used
        purely for error scaling)."""
        self.base_estimator.fit(X, y, device=device)
        self.scaler = RobustScaling().fit(as_2d(y, dtype=None))
        return self

    def _fold_errors(self, y_pred: np.ndarray, y_test: np.ndarray):
        """Per-timestep test errors of one fitted fold: the aggregate
        scaled-MSE series and the per-tag absolute errors."""
        y_true = y_test[-len(y_pred):]
        scale = self.scaler.transform
        scaled_sq = (scale(y_pred) - scale(y_true)) ** 2
        return scaled_sq.mean(axis=1), np.abs(y_pred - y_true)

    def _sequential_cv(self, X, y, cv, device):
        """(fitted fold detector, fit seconds, test rows) of each fold, the
        folds trained one after another, each a clone of this detector."""
        for train_idx, test_idx in cv.split(X, y):
            start = time.perf_counter()
            detector = self.clone().fit(X[train_idx], y[train_idx], device=device)
            yield detector, time.perf_counter() - start, test_idx

    def _folds_batchable(self, X, y, cv) -> bool:
        """Whether training the folds as one fleet fit keeps their
        semantics: a bare port estimator, fit arguments the fleet trainer
        takes exactly, and every fold's training rows one contiguous run
        (windows need it)."""
        from gordo_tpu_torch.models.callbacks import fleet_fit_kwargs

        if not isinstance(self.base_estimator, BaseTorchEstimator):
            return False
        fit_args = self.base_estimator.extract_supported_fit_args(self.base_estimator.kwargs)
        if fleet_fit_kwargs(fit_args) is None:
            return False
        try:
            folds = list(cv.split(X, y))
        except Exception:
            return False
        return all(
            len(tr) > 0 and np.array_equal(tr, np.arange(tr[0], tr[-1] + 1)) for tr, _ in folds
        )

    def _fold_parallel_cv(self, X, y, cv, device):
        """
        (fitted fold detector, fit seconds, test rows) of each fold, every
        fold trained at once: one :class:`FleetTrainer` fit with the fold
        axis as the machine axis (ragged fold lengths as row weights),
        each fold from the solo seed's initial weights (``_initial_state``)
        and with its own scaler fitted on its training targets. The fit's
        seconds are shared out evenly, as in JAX.
        """
        from gordo_tpu_torch.device import resolve_device
        from gordo_tpu_torch.models.callbacks import fleet_fit_kwargs
        from gordo_tpu_torch.parallel.fleet import FleetTrainer, StackedData

        device = resolve_device(device)
        folds = list(cv.split(X, y))
        Xn, yn = np.asarray(X, dtype=np.float32), np.asarray(y, dtype=np.float32)
        template = self.base_estimator.clone()
        template.kwargs.update({"n_features": Xn.shape[1], "n_features_out": yn.shape[1]})
        fit_args = template.extract_supported_fit_args(template.kwargs)
        spec = template._build_spec()
        seed = int(template.kwargs.get("seed", DEFAULT_SEED))
        trainer = FleetTrainer(
            spec, lookahead=template.lookahead if spec.windowed else 0, device=device, seed=seed
        )
        data = StackedData.from_ragged(
            [Xn[tr] for tr, _ in folds], [yn[tr] for tr, _ in folds], device=device
        )
        params = trainer.stack_params([template._initial_state(spec, seed)] * len(folds))
        start = time.perf_counter()
        params, _ = trainer.fit(
            data,
            params=params,
            epochs=int(fit_args.get("epochs", 1)),
            batch_size=int(fit_args.get("batch_size", 32)),
            shuffle=fit_args.get("shuffle"),
            **fleet_fit_kwargs(fit_args),
        )
        fit_time = (time.perf_counter() - start) / len(folds)
        for i, ((train_idx, test_idx), state) in enumerate(
            zip(folds, trainer.unstack_all(params, len(folds)))
        ):
            estimator = self.base_estimator.clone()
            estimator.kwargs.update(template.kwargs)
            estimator._set_fitted(
                estimator._build_spec(), state, device, Xn.shape[1], yn.shape[1],
                history=dict(trainer.history_[i]),
            )
            detector = DiffBasedAnomalyDetector(estimator, self.require_thresholds, self.window)
            detector.scaler = RobustScaling().fit(yn[train_idx])
            yield detector, fit_time, test_idx

    def cross_validate(
        self,
        *,
        X,
        y,
        cv=None,
        scoring: Optional[Dict[str, Callable]] = None,
        device: DeviceLike = None,
    ) -> dict:
        """
        Cross-validate and derive the anomaly thresholds from the fold
        models' test errors. Folds (``TimeSeriesSplit(3)`` by default)
        train at once as one fleet fit when ``_folds_batchable`` allows it
        (``cv_fast_path_``), else one after another, each a clone of this
        detector. Each
        fold's test predictions are computed once; every ``scoring``
        metric (``metric(y_true, y_pred)``) scores them, and the
        thresholds come from them: per fold, aggregate =
        ``rolled_threshold(scaled MSE, 6)`` and per tag =
        ``rolled_threshold(MAE, 6)``, plus the same over ``window`` when
        it is set; the final thresholds are the last fold's. Returns the
        scikit-learn-shaped dict (``estimator``, ``fit_time``,
        ``score_time``, ``test_<name>``).
        """
        X, y = as_2d(X, dtype=None), as_2d(y, dtype=None)
        cv = cv if cv is not None else TimeSeriesSplit(n_splits=3)
        scoring = scoring or {}
        self.cv_fast_path_ = self._folds_batchable(X, y, cv)
        if self.cv_fast_path_:
            folds = self._fold_parallel_cv(X, y, cv, device)
        else:
            folds = self._sequential_cv(X, y, cv, device)
        output: dict = {"estimator": [], "fit_time": [], "score_time": []}
        output.update({f"test_{name}": [] for name in scoring})
        agg_by_fold: Dict[str, float] = {}
        tag_by_fold: Dict[str, np.ndarray] = {}
        smooth_agg_by_fold: Dict[str, float] = {}
        smooth_tag_by_fold: Dict[str, np.ndarray] = {}

        for fold, (detector, fit_time, test_idx) in enumerate(folds):
            output["fit_time"].append(fit_time)
            start = time.perf_counter()
            y_pred = detector.predict(X[test_idx])
            y_test = y[test_idx]
            for name, metric in scoring.items():
                output[f"test_{name}"].append(metric(y_test, y_pred))
            output["score_time"].append(time.perf_counter() - start)
            output["estimator"].append(detector)

            label = f"fold-{fold}"
            scaled_mse, mae = detector._fold_errors(y_pred, y_test)
            agg_by_fold[label] = rolled_threshold(scaled_mse, 6)
            tag_by_fold[label] = rolled_threshold(mae, 6)
            if self.window is not None:
                smooth_agg_by_fold[label] = rolled_threshold(scaled_mse, self.window)
                smooth_tag_by_fold[label] = rolled_threshold(mae, self.window)

        self.aggregate_thresholds_per_fold_ = agg_by_fold
        self.feature_thresholds_per_fold_ = tag_by_fold
        self.smooth_aggregate_thresholds_per_fold_ = smooth_agg_by_fold
        self.smooth_feature_thresholds_per_fold_ = smooth_tag_by_fold

        def last(by_fold):
            return list(by_fold.values())[-1] if by_fold else None

        self.aggregate_threshold_ = last(agg_by_fold)
        self.feature_thresholds_ = last(tag_by_fold)
        self.smooth_aggregate_threshold_ = last(smooth_agg_by_fold)
        self.smooth_feature_thresholds_ = last(smooth_tag_by_fold)
        return {
            key: value if key == "estimator" else np.asarray(value)
            for key, value in output.items()
        }

    def get_metadata(self) -> dict:
        """The JAX detector's metadata keys: thresholds (final and per
        fold, smoothed when ``window`` is set), ``window``,
        ``cv-fast-path`` (or ``cv-fleet-masks`` from a fleet build), and
        the base estimator's metadata."""
        metadata: dict = {}
        if self.feature_thresholds_ is not None:
            metadata["feature-thresholds"] = np.asarray(self.feature_thresholds_).tolist()
        if self.aggregate_threshold_ is not None:
            metadata["aggregate-threshold"] = float(self.aggregate_threshold_)
        if hasattr(self, "feature_thresholds_per_fold_"):
            metadata["feature-thresholds-per-fold"] = _per_fold_frame(
                self.feature_thresholds_per_fold_
            )
        if hasattr(self, "aggregate_thresholds_per_fold_"):
            metadata["aggregate-thresholds-per-fold"] = dict(self.aggregate_thresholds_per_fold_)
        if self.window is not None:
            metadata["window"] = self.window
        if hasattr(self, "cv_fast_path_"):
            metadata["cv-fast-path"] = bool(self.cv_fast_path_)
        if hasattr(self, "cv_fleet_masks_"):
            # thresholds from a fleet build's fold masks
            metadata["cv-fleet-masks"] = bool(self.cv_fleet_masks_)
        if self.smooth_feature_thresholds_ is not None:
            metadata["smooth-feature-thresholds"] = np.asarray(
                self.smooth_feature_thresholds_
            ).tolist()
        if self.smooth_aggregate_threshold_ is not None:
            metadata["smooth-aggregate-threshold"] = float(self.smooth_aggregate_threshold_)
        if hasattr(self, "smooth_feature_thresholds_per_fold_"):
            metadata["smooth-feature-thresholds-per-fold"] = _per_fold_frame(
                self.smooth_feature_thresholds_per_fold_
            )
        if hasattr(self, "smooth_aggregate_thresholds_per_fold_"):
            metadata["smooth-aggregate-thresholds-per-fold"] = dict(
                self.smooth_aggregate_thresholds_per_fold_
            )
        if not isinstance(self.base_estimator, BaseTorchEstimator):
            # the JAX detector's description of a scikit-learn base
            metadata.update(scaler=str(self.scaler), base_estimator=str(self.base_estimator))
        metadata.update(self.base_estimator.get_metadata())
        return metadata

    # -- definition / weights ---------------------------------------------
    def into_definition(self) -> dict:
        return {
            f"{type(self).__module__}.{type(self).__name__}": {
                "base_estimator": self.base_estimator.into_definition(),
                "require_thresholds": self.require_thresholds,
                "window": self.window,
            }
        }

    def state_arrays(self) -> Dict[str, np.ndarray]:
        arrays = {
            f"base_estimator.{name}": value
            for name, value in self.base_estimator.state_arrays().items()
        }
        arrays["scaler.center_"] = self.scaler.center_
        arrays["scaler.scale_"] = self.scaler.scale_
        for attr in THRESHOLD_ATTRS:
            if getattr(self, attr) is not None:
                arrays[attr] = np.asarray(getattr(self, attr))
        return arrays

    def load_state_arrays(
        self, arrays: Dict[str, np.ndarray], device: DeviceLike = None
    ) -> "DiffBasedAnomalyDetector":
        prefix = "base_estimator."
        self.base_estimator.load_state_arrays(
            {k[len(prefix) :]: v for k, v in arrays.items() if k.startswith(prefix)},
            device,
        )
        self.scaler = RobustScaling(arrays["scaler.center_"], arrays["scaler.scale_"])
        for attr in THRESHOLD_ATTRS:
            if attr in arrays:
                value = np.asarray(arrays[attr])
                setattr(self, attr, float(value) if value.ndim == 0 else value)
        return self

    # -- scoring ----------------------------------------------------------
    def predict(self, X) -> np.ndarray:
        return self.base_estimator.predict(X)

    def anomaly(
        self,
        X: Frame,
        y: Frame,
        frequency: Optional[timedelta] = None,
        model_output: Optional[np.ndarray] = None,
    ) -> BlockFrame:
        """
        The anomaly frame for (X, y): model input/output, per-tag and
        total anomalies (scaled and unscaled), their rolling-median
        smoothing when ``window`` is set, and confidence = anomaly /
        threshold.
        """
        if model_output is None:
            model_output = self.predict(X)
        data = make_base_dataframe(
            tags=X.columns,
            model_input=X.values,
            model_output=model_output,
            target_tag_list=y.columns,
            index=X.index,
            frequency=frequency,
        )
        output = data["model-output"]
        n = len(data)
        y_values = np.asarray(y.values)
        # windowed models emit fewer rows than they consume: y aligns to tail
        y_tail = y_values[-n:, :]

        scale = self.scaler.transform
        data.add(
            "tag-anomaly-scaled",
            y.columns,
            np.abs(scale(output) - scale(y_values)[-n:, :]),
        )
        data.add("tag-anomaly-unscaled", y.columns, np.abs(output - y_tail))
        for flavor in ("scaled", "unscaled"):
            data.add_column(
                f"total-anomaly-{flavor}",
                np.square(data[f"tag-anomaly-{flavor}"]).mean(axis=1),
            )

        if self.window is not None:
            for flavor in ("scaled", "unscaled"):
                data.add(
                    f"smooth-tag-anomaly-{flavor}",
                    y.columns,
                    rolling_median(data[f"tag-anomaly-{flavor}"], self.window),
                )
                data.add_column(
                    f"smooth-total-anomaly-{flavor}",
                    rolling_median(data[f"total-anomaly-{flavor}"], self.window),
                )

        self._join_confidences(data)

        if self.require_thresholds and (
            self.feature_thresholds_ is None and self.aggregate_threshold_ is None
        ):
            raise AttributeError(
                f"`require_thresholds={self.require_thresholds}` however "
                "`.cross_validate` needs to be called in order to calculate "
                "these thresholds before calling `.anomaly`"
            )
        return data

    def _join_confidences(self, data: BlockFrame) -> None:
        """confidence = anomaly / threshold, preferring the smoothed pair
        when a window was configured and smoothed thresholds exist."""
        if self.smooth_feature_thresholds_ is not None:
            per_tag = data["smooth-tag-anomaly-scaled"] / self.smooth_feature_thresholds_
        elif self.feature_thresholds_ is not None:
            per_tag = data["tag-anomaly-scaled"] / self.feature_thresholds_
        else:
            per_tag = None
        if per_tag is not None:
            data.add("anomaly-confidence", data.labels("model-output"), per_tag)

        if self.smooth_aggregate_threshold_ is not None:
            data.add_column(
                "total-anomaly-confidence",
                data["smooth-total-anomaly-scaled"] / self.smooth_aggregate_threshold_,
            )
        elif self.aggregate_threshold_ is not None:
            data.add_column(
                "total-anomaly-confidence",
                data["total-anomaly-scaled"] / self.aggregate_threshold_,
            )
