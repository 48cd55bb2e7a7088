"""
Model layer: torch modules behind the JAX package's estimator API.
"""

from .core import BaseTorchEstimator
from .models import TransformerAutoEncoder, TransformerForecast, WindowedEstimator
from .register import register_model_builder
from .specs import ModelSpec

__all__ = [
    "BaseTorchEstimator",
    "WindowedEstimator",
    "TransformerAutoEncoder",
    "TransformerForecast",
    "register_model_builder",
    "ModelSpec",
]
