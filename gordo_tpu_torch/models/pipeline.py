"""
The scikit-learn pieces of the pipelines, as port code (the card's
machine has no scikit-learn): :class:`Pipeline`, which chains
transformers before a final estimator, and :class:`FunctionTransformer`;
the scalers a pipeline may hold are ``gordo_tpu_torch.models.
preprocessing``'s.

They are what ``gordo_tpu.serializer.from_definition`` builds from a
config's ``sklearn.pipeline.Pipeline``, ``sklearn.preprocessing.*Scaler``
and ``sklearn.preprocessing.FunctionTransformer``. A scaler computes in
numpy on the host, in float64 for float64 input as scikit-learn does;
the estimator after it runs on the device it is fitted on. Fitted state
is plain arrays (``state_arrays``), so an artifact holds no pickle.
"""

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from gordo_tpu_torch.device import DeviceLike
from gordo_tpu_torch.models.preprocessing import MinMaxScaler  # noqa: F401 (re-exported)
from gordo_tpu_torch.models.transformer_funcs import resolve_function

class FunctionTransformer:
    """
    ``sklearn.preprocessing.FunctionTransformer`` with ``validate`` off:
    ``transform(X)`` is ``func(X, **kw_args)`` (the identity without a
    ``func``). ``func`` and ``inverse_func`` are paths, resolved only
    against the functions the port has
    (:data:`~gordo_tpu_torch.models.transformer_funcs.FUNCTIONS`); any
    other path raises ``ValueError``. ``inverse_func`` and the other
    scikit-learn arguments are kept for the definition only: nothing in
    a build or a request inverts a step. It fits nothing, so it has no
    state arrays.
    """

    def __init__(
        self,
        func: Optional[str] = None,
        inverse_func: Optional[str] = None,
        validate: bool = False,
        accept_sparse: bool = False,
        check_inverse: bool = True,
        feature_names_out=None,
        kw_args: Optional[dict] = None,
        inv_kw_args: Optional[dict] = None,
    ):
        if validate:
            raise NotImplementedError("FunctionTransformer(validate=True) is not ported")
        self.func, self.inverse_func = func, inverse_func
        self.kw_args, self.inv_kw_args = kw_args, inv_kw_args
        self._func = resolve_function(func) if func is not None else None
        if inverse_func is not None:
            resolve_function(inverse_func)  # the same refusal of unported paths

    def clone(self) -> "FunctionTransformer":
        return FunctionTransformer(
            self.func, self.inverse_func, kw_args=self.kw_args, inv_kw_args=self.inv_kw_args
        )

    def fit(self, X, y=None) -> "FunctionTransformer":
        return self

    def transform(self, X):
        X = getattr(X, "values", X)
        return X if self._func is None else self._func(X, **(self.kw_args or {}))

    def fit_transform(self, X, y=None):
        return self.fit(X, y).transform(X)

    def into_definition(self) -> dict:
        return {
            f"{type(self).__module__}.{type(self).__name__}": {
                "func": self.func,
                "inverse_func": self.inverse_func,
                "kw_args": self.kw_args,
                "inv_kw_args": self.inv_kw_args,
            }
        }

    def state_arrays(self) -> Dict[str, np.ndarray]:
        return {}

    def load_state_arrays(
        self, arrays: Dict[str, np.ndarray], device: DeviceLike = None
    ) -> "FunctionTransformer":
        return self

    def __repr__(self):
        return f"FunctionTransformer(func={self.func!r}, kw_args={self.kw_args!r})"


class Pipeline:
    """
    ``sklearn.pipeline.Pipeline``: ``steps`` is a list of (name,
    transformer) pairs ending in the estimator. ``fit`` fits each
    transformer on the output of the ones before it, then the estimator
    on ``device``; ``predict``, ``transform`` and ``score`` pass X through
    the fitted transformers first.
    """

    def __init__(self, steps: List[Tuple[str, Any]]):
        self.steps = [tuple(step) for step in steps]

    @property
    def _final(self):
        return self.steps[-1][1]

    def _transform(self, X):
        for _, step in self.steps[:-1]:
            X = step.transform(X)
        return X

    def clone(self) -> "Pipeline":
        return Pipeline([(name, step.clone()) for name, step in self.steps])

    def fit(self, X, y, *, device: DeviceLike = None) -> "Pipeline":
        for _, step in self.steps[:-1]:
            X = step.fit_transform(X, y)
        self._final.fit(X, y, device=device)
        return self

    def predict(self, X) -> np.ndarray:
        return self._final.predict(self._transform(X))

    def transform(self, X) -> np.ndarray:
        return self._final.transform(self._transform(X))

    def score(self, X, y, sample_weight=None) -> float:
        return self._final.score(self._transform(X), y)

    def get_metadata(self) -> dict:
        """The estimator's metadata, as the JAX builder harvests it from a
        pipeline's last step."""
        return self._final.get_metadata()

    def into_definition(self) -> dict:
        return {
            f"{type(self).__module__}.{type(self).__name__}": {
                "steps": [step.into_definition() for _, step in self.steps]
            }
        }

    def state_arrays(self) -> Dict[str, np.ndarray]:
        return {
            f"steps.{i}.{name}": value
            for i, (_, step) in enumerate(self.steps)
            for name, value in step.state_arrays().items()
        }

    def load_state_arrays(
        self, arrays: Dict[str, np.ndarray], device: DeviceLike = None
    ) -> "Pipeline":
        for i, (_, step) in enumerate(self.steps):
            prefix = f"steps.{i}."
            step.load_state_arrays(
                {k[len(prefix) :]: v for k, v in arrays.items() if k.startswith(prefix)},
                device,
            )
        return self

    def __repr__(self):
        return f"Pipeline(steps={self.steps!r})"
