"""
InfImputer (the port of ``gordo_tpu.models.transformers.imputer``), in
numpy: a pipeline step that replaces +inf and -inf values.
"""

from typing import Dict, Optional

import numpy as np

from gordo_tpu_torch.device import DeviceLike

_FILL_ATTRS = ("_posinf_fill_values", "_neginf_fill_values")


class InfImputer:
    """
    +inf becomes ``inf_fill_value`` if given, else the column's fitted fill
    value; -inf likewise. ``strategy="minmax"`` fits each column's finite
    max + ``delta`` and min - ``delta`` (0 ± delta for a column with no
    finite value); ``"extremes"`` the dtype's largest and smallest values.
    ``transform`` returns float64.
    """

    def __init__(
        self,
        inf_fill_value: Optional[float] = None,
        neg_inf_fill_value: Optional[float] = None,
        strategy: str = "minmax",
        delta: float = 2.0,
    ):
        self.inf_fill_value = inf_fill_value
        self.neg_inf_fill_value = neg_inf_fill_value
        self.strategy = strategy
        self.delta = delta

    def _params(self) -> dict:
        return {
            "inf_fill_value": self.inf_fill_value,
            "neg_inf_fill_value": self.neg_inf_fill_value,
            "strategy": self.strategy,
            "delta": self.delta,
        }

    def clone(self) -> "InfImputer":
        return InfImputer(**self._params())

    def fit(self, X, y=None) -> "InfImputer":
        X = np.asarray(getattr(X, "values", X))
        if self.strategy == "extremes":
            info = np.finfo(X.dtype) if np.issubdtype(X.dtype, np.floating) else np.iinfo(X.dtype)
            self._posinf_fill_values = np.repeat(info.max, X.shape[1])
            self._neginf_fill_values = np.repeat(info.min, X.shape[1])
        elif self.strategy == "minmax":
            masked = np.ma.masked_invalid(X)
            self._posinf_fill_values = masked.max(axis=0).filled(0) + self.delta
            self._neginf_fill_values = masked.min(axis=0).filled(0) - self.delta
        else:
            raise ValueError(f"Unknown strategy: {self.strategy}")
        return self

    def transform(self, X) -> np.ndarray:
        X = np.asarray(getattr(X, "values", X)).astype(np.float64)  # a copy
        if self.inf_fill_value is not None:
            X[np.isposinf(X)] = self.inf_fill_value
        if self.neg_inf_fill_value is not None:
            X[np.isneginf(X)] = self.neg_inf_fill_value
        for i in range(X.shape[1]):
            col = X[:, i]
            col[np.isposinf(col)] = self._posinf_fill_values[i]
            col[np.isneginf(col)] = self._neginf_fill_values[i]
        return X

    def fit_transform(self, X, y=None) -> np.ndarray:
        return self.fit(X, y).transform(X)

    def into_definition(self) -> dict:
        return {f"{type(self).__module__}.{type(self).__name__}": self._params()}

    def state_arrays(self) -> Dict[str, np.ndarray]:
        return {attr.lstrip("_"): np.asarray(getattr(self, attr)) for attr in _FILL_ATTRS}

    def load_state_arrays(
        self, arrays: Dict[str, np.ndarray], device: DeviceLike = None
    ) -> "InfImputer":
        for attr in _FILL_ATTRS:
            setattr(self, attr, np.asarray(arrays[attr.lstrip("_")]))
        return self

    def __repr__(self):
        return f"InfImputer({', '.join(f'{k}={v!r}' for k, v in self._params().items())})"
