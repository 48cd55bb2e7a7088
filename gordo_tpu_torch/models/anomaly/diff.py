"""
DiffBasedAnomalyDetector, scoring half (the port of
``gordo_tpu.models.anomaly.diff``): ``anomaly()`` and the confidence
columns, in numpy.

The fitted RobustScaler of the JAX detector becomes its two arrays,
``(x - center_) / scale_``. Thresholds come with the artifact;
``cross_validate`` (which derives them) arrives with the training slice.
"""

from datetime import timedelta
from typing import Dict, Optional

import numpy as np

from gordo_tpu_torch.device import DeviceLike
from gordo_tpu_torch.models.core import BaseTorchEstimator
from gordo_tpu_torch.models.utils import BlockFrame, Frame, make_base_dataframe

#: fitted thresholds an artifact may carry (None where absent)
THRESHOLD_ATTRS = (
    "aggregate_threshold_",
    "feature_thresholds_",
    "smooth_aggregate_threshold_",
    "smooth_feature_thresholds_",
)


class RobustScaling:
    """A fitted ``sklearn.preprocessing.RobustScaler``'s transform."""

    def __init__(self, center: np.ndarray, scale: np.ndarray):
        self.center_ = np.asarray(center)
        self.scale_ = np.asarray(scale)

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
