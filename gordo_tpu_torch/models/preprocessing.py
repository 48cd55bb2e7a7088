"""
scikit-learn's four scalers (``sklearn.preprocessing``) in numpy, as
port code (the card's machine has no scikit-learn): ``RobustScaler``,
``StandardScaler``, ``MinMaxScaler`` and ``MaxAbsScaler``, with their
arguments, ``fit``/``transform``/``inverse_transform`` and the fitted
arrays scikit-learn keeps.

They compute as scikit-learn 1.x does on dense input: float32 and
float64 keep their type (anything else becomes float64), NaNs are
ignored when fitting, a scale within ten machine epsilons of 0 (for
``StandardScaler``, a feature whose variance is indistinguishable from
0) becomes 1, and ``transform`` works in place on a copy. A fitted
scaler is plain arrays (``state_arrays``), so an artifact holds no
pickle. The same classes serve as pipeline steps, as the anomaly
detector's error scaler and as the builder's scoring scaler.
"""

import inspect
from statistics import NormalDist
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np

from gordo_tpu_torch.device import DeviceLike
from gordo_tpu_torch.models.core import as_2d


def _handle_zeros_in_scale(scale: np.ndarray, constant_mask: Optional[np.ndarray] = None):
    """A copy of ``scale`` with 1 where it is within ten machine epsilons
    of 0 (or where ``constant_mask`` says)."""
    if constant_mask is None:
        constant_mask = scale < 10 * np.finfo(scale.dtype).eps
    scale = np.array(scale, copy=True)
    scale[constant_mask] = 1.0
    return scale


class _Scaler:
    """The shared surface: definition, clone, fitted arrays."""

    #: the constructor's arguments, in order
    PARAMS: Tuple[str, ...] = ()
    #: the fitted arrays (an attribute left None is not stored)
    ARRAYS: Tuple[str, ...] = ()

    def get_params(self) -> Dict[str, Any]:
        params = {name: getattr(self, name) for name in self.PARAMS}
        for name, value in params.items():
            if isinstance(value, tuple):
                params[name] = list(value)
        return params

    def clone(self):
        """An unfitted scaler with the same arguments (sklearn's clone)."""
        return type(self)(**self.get_params())

    def fit_transform(self, X, y=None) -> np.ndarray:
        return self.fit(X, y).transform(X)

    def into_definition(self) -> dict:
        return {f"{type(self).__module__}.{type(self).__name__}": self.get_params()}

    def state_arrays(self) -> Dict[str, np.ndarray]:
        return {
            name: np.asarray(getattr(self, name))
            for name in self.ARRAYS
            if getattr(self, name, None) is not None
        }

    def load_state_arrays(self, arrays: Dict[str, np.ndarray], device: DeviceLike = None):
        for name in self.ARRAYS:
            setattr(self, name, np.asarray(arrays[name]) if name in arrays else None)
        return self

    @staticmethod
    def _copy(X) -> np.ndarray:
        """X as a 2-D float32/float64 array that the caller may change."""
        return np.array(as_2d(X, dtype=None), copy=True)

    def __repr__(self):
        """scikit-learn's: the arguments changed from their defaults, by name."""
        defaults = inspect.signature(type(self)).parameters
        changed = ", ".join(
            f"{name}={getattr(self, name)!r}"
            for name in sorted(self.PARAMS)
            if getattr(self, name) != defaults[name].default
        )
        return f"{type(self).__name__}({changed})"


class RobustScaler(_Scaler):
    """Centre on the median and scale by the ``quantile_range``
    interquantile range of each column (``unit_variance`` divides the
    range by the standard normal's over the same quantiles, so normal
    data comes out with variance 1)."""

    PARAMS = ("with_centering", "with_scaling", "quantile_range", "copy", "unit_variance")
    ARRAYS = ("center_", "scale_")

    def __init__(
        self,
        *,
        with_centering: bool = True,
        with_scaling: bool = True,
        quantile_range: Sequence[float] = (25.0, 75.0),
        copy: bool = True,
        unit_variance: bool = False,
    ):
        self.with_centering = with_centering
        self.with_scaling = with_scaling
        self.quantile_range = tuple(quantile_range)
        self.copy = copy
        self.unit_variance = unit_variance
        self.center_: Optional[np.ndarray] = None
        self.scale_: Optional[np.ndarray] = None

    def fit(self, X, y=None) -> "RobustScaler":
        X = as_2d(X, dtype=None)
        q_min, q_max = self.quantile_range
        if not 0 <= q_min <= q_max <= 100:
            raise ValueError(f"Invalid quantile range: {self.quantile_range}")
        self.center_ = np.nanmedian(X, axis=0) if self.with_centering else None
        self.scale_ = None
        if self.with_scaling:
            quantiles = np.transpose(
                [np.nanpercentile(X[:, j], self.quantile_range) for j in range(X.shape[1])]
            )
            scale = _handle_zeros_in_scale(quantiles[1] - quantiles[0])
            if self.unit_variance:
                normal = NormalDist()
                scale = scale / (normal.inv_cdf(q_max / 100.0) - normal.inv_cdf(q_min / 100.0))
            self.scale_ = scale
        return self

    def transform(self, X) -> np.ndarray:
        X = self._copy(X)
        if self.with_centering:
            X -= self.center_
        if self.with_scaling:
            X /= self.scale_
        return X

    def inverse_transform(self, X) -> np.ndarray:
        X = self._copy(X)
        if self.with_scaling:
            X *= self.scale_
        if self.with_centering:
            X += self.center_
        return X


class StandardScaler(_Scaler):
    """Centre on the mean and scale by the standard deviation (``ddof``
    0) of each column, from scikit-learn's corrected two-pass sums in
    float64; a feature whose variance is indistinguishable from 0 scales
    by 1."""

    PARAMS = ("copy", "with_mean", "with_std")
    ARRAYS = ("mean_", "var_", "scale_", "n_samples_seen_")

    def __init__(self, *, copy: bool = True, with_mean: bool = True, with_std: bool = True):
        self.copy = copy
        self.with_mean = with_mean
        self.with_std = with_std
        self.mean_: Optional[np.ndarray] = None
        self.var_: Optional[np.ndarray] = None
        self.scale_: Optional[np.ndarray] = None
        self.n_samples_seen_: Optional[np.ndarray] = None

    def fit(self, X, y=None) -> "StandardScaler":
        X = as_2d(X, dtype=None)
        missing = np.isnan(X)
        total = np.nansum if missing.any() else np.sum
        count = X.shape[0] - total(missing.astype(X.dtype), axis=0, dtype=np.float64)
        self.mean_ = self.var_ = self.scale_ = None
        if self.with_mean or self.with_std:
            col_sum = total(X, axis=0, dtype=np.float64)
            self.mean_ = col_sum / count
            if self.with_std:
                temp = X - col_sum / count
                correction = total(temp, axis=0, dtype=np.float64)
                temp **= 2
                self.var_ = (total(temp, axis=0, dtype=np.float64) - correction**2 / count) / count
        counts = count.astype(np.int64)
        self.n_samples_seen_ = counts[0] if counts.max() == counts.min() else counts
        if self.with_std:
            eps = np.finfo(np.float64).eps
            n = self.n_samples_seen_
            constant = self.var_ <= n * eps * self.var_ + (n * self.mean_ * eps) ** 2
            self.scale_ = _handle_zeros_in_scale(np.sqrt(self.var_), constant)
        return self

    def transform(self, X) -> np.ndarray:
        X = self._copy(X)
        if self.with_mean:
            X -= self.mean_.astype(X.dtype)
        if self.with_std:
            X /= self.scale_.astype(X.dtype)
        return X

    def inverse_transform(self, X) -> np.ndarray:
        X = self._copy(X)
        if self.with_std:
            X *= self.scale_.astype(X.dtype)
        if self.with_mean:
            X += self.mean_.astype(X.dtype)
        return X


class MinMaxScaler(_Scaler):
    """Map each column linearly from its fitted [min, max] onto
    ``feature_range``; a column whose range is under ten machine
    epsilons gets scale 1. ``clip`` clips transformed values to the
    range."""

    PARAMS = ("feature_range", "copy", "clip")
    ARRAYS = ("data_min_", "data_max_", "data_range_", "scale_", "min_")

    def __init__(
        self, feature_range: Sequence[float] = (0, 1), *, copy: bool = True, clip: bool = False
    ):
        self.feature_range = tuple(feature_range)
        self.copy = copy
        self.clip = clip

    def fit(self, X, y=None) -> "MinMaxScaler":
        low, high = self.feature_range
        if low >= high:
            raise ValueError(
                f"Minimum of desired feature range must be smaller than maximum. "
                f"Got {self.feature_range}."
            )
        X = as_2d(X, dtype=None)
        data_min = np.nanmin(X, axis=0)
        data_max = np.nanmax(X, axis=0)
        data_range = data_max - data_min
        self.scale_ = (high - low) / _handle_zeros_in_scale(data_range)
        self.min_ = low - data_min * self.scale_
        self.data_min_, self.data_max_, self.data_range_ = data_min, data_max, data_range
        return self

    def transform(self, X) -> np.ndarray:
        X = self._copy(X)
        X *= self.scale_
        X += self.min_
        if self.clip:
            np.clip(X, self.feature_range[0], self.feature_range[1], out=X)
        return X

    def inverse_transform(self, X) -> np.ndarray:
        X = self._copy(X)
        X -= self.min_
        X /= self.scale_
        return X


class MaxAbsScaler(_Scaler):
    """Scale each column by its largest absolute value."""

    PARAMS = ("copy",)
    ARRAYS = ("max_abs_", "scale_")

    def __init__(self, *, copy: bool = True):
        self.copy = copy

    def fit(self, X, y=None) -> "MaxAbsScaler":
        X = as_2d(X, dtype=None)
        self.max_abs_ = np.nanmax(np.abs(X), axis=0)
        self.scale_ = _handle_zeros_in_scale(self.max_abs_)
        return self

    def transform(self, X) -> np.ndarray:
        X = self._copy(X)
        X /= self.scale_
        return X

    def inverse_transform(self, X) -> np.ndarray:
        X = self._copy(X)
        X *= self.scale_
        return X


#: the scalers a definition may name, by class name
SCALERS = {cls.__name__: cls for cls in (RobustScaler, StandardScaler, MinMaxScaler, MaxAbsScaler)}


def scaler_from_definition(definition: Union[str, Dict[str, Any], _Scaler]) -> _Scaler:
    """``"sklearn.preprocessing.StandardScaler"`` or ``{path: kwargs}``
    (any package's path; the class name decides) -> an unfitted port
    scaler; a scaler passes through. Any other class raises
    ``NotImplementedError`` naming the scalers the port has."""
    if isinstance(definition, _Scaler):
        return definition
    if isinstance(definition, str):
        definition = {definition: {}}
    if not isinstance(definition, dict) or len(definition) != 1:
        raise ValueError(f"A scaler definition has exactly one class path key: {definition!r}")
    (path, kwargs), = definition.items()
    name = str(path).rsplit(".", 1)[-1]
    if name not in SCALERS:
        raise NotImplementedError(
            f"scaler {path!r} is not ported; the port has {sorted(SCALERS)}"
        )
    return SCALERS[name](**dict(kwargs or {}))
