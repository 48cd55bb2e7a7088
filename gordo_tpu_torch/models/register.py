"""
Factory registry (the port of ``gordo_tpu.models.register``): a decorator
registering model-architecture builders under a model type, so an
estimator's ``kind`` resolves to a factory. The port keeps its own
registry; it shares nothing with the JAX package's.
"""

import inspect
from typing import Any, Callable, Dict


class register_model_builder:
    """
    Decorator::

        @register_model_builder(type="TransformerAutoEncoder")
        def my_architecture(n_features: int, **kwargs) -> ModelSpec: ...
    """

    factories: Dict[str, Dict[str, Callable[..., Any]]] = dict()

    def __init__(self, type: str):
        self.type = type

    def __call__(self, build_fn: Callable[..., Any]):
        self._validate_func(build_fn)
        self.factories.setdefault(self.type, dict())[build_fn.__name__] = build_fn
        return build_fn

    @staticmethod
    def _validate_func(func):
        if "n_features" not in inspect.signature(func).parameters:
            raise ValueError(
                f"Build function: {func.__name__} does not have "
                "'n_features' as an argument; it should."
            )
