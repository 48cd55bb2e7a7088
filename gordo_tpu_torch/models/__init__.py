"""
Model layer: torch modules behind the JAX package's estimator API, and
the Pipeline, the four scalers and FunctionTransformer that take
scikit-learn's place.
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
    KerasRawModelRegressor,
    LSTMAutoEncoder,
    LSTMForecast,
    RawModelRegressor,
    TCNAutoEncoder,
    TCNForecast,
    TransformerAutoEncoder,
    TransformerForecast,
    WindowedEstimator,
)
from .pipeline import FunctionTransformer, Pipeline
from .preprocessing import MaxAbsScaler, MinMaxScaler, RobustScaler, StandardScaler
from .register import register_model_builder
from .specs import ModelSpec

__all__ = [
    "BaseTorchEstimator",
    "AutoEncoder",
    "MinMaxScaler",
    "MaxAbsScaler",
    "RobustScaler",
    "StandardScaler",
    "FunctionTransformer",
    "Pipeline",
    "WindowedEstimator",
    "TransformerAutoEncoder",
    "TransformerForecast",
    "TCNAutoEncoder",
    "TCNForecast",
    "RawModelRegressor",
    "KerasRawModelRegressor",
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
