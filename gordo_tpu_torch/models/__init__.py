"""
Model layer: torch modules behind the JAX package's estimator API, and
the Pipeline and MinMaxScaler that take scikit-learn's place.
"""

from .core import BaseTorchEstimator
from .models import (
    AutoEncoder,
    GRUAutoEncoder,
    GRUForecast,
    KerasAutoEncoder,
    KerasLSTMAutoEncoder,
    KerasLSTMBaseEstimator,
    KerasLSTMForecast,
    LSTMAutoEncoder,
    LSTMForecast,
    TransformerAutoEncoder,
    TransformerForecast,
    WindowedEstimator,
)
from .pipeline import MinMaxScaler, Pipeline
from .register import register_model_builder
from .specs import ModelSpec

__all__ = [
    "BaseTorchEstimator",
    "AutoEncoder",
    "MinMaxScaler",
    "Pipeline",
    "WindowedEstimator",
    "TransformerAutoEncoder",
    "TransformerForecast",
    "LSTMAutoEncoder",
    "LSTMForecast",
    "GRUAutoEncoder",
    "GRUForecast",
    "KerasAutoEncoder",
    "KerasLSTMBaseEstimator",
    "KerasLSTMAutoEncoder",
    "KerasLSTMForecast",
    "register_model_builder",
    "ModelSpec",
]
