"""
Model architecture factories, registered by kind under each model type.
"""

from .feedforward import (  # noqa: F401
    feedforward_hourglass,
    feedforward_model,
    feedforward_symmetric,
)
from .gru import gru_hourglass, gru_model, gru_symmetric  # noqa: F401
from .lstm import lstm_hourglass, lstm_model, lstm_symmetric  # noqa: F401
from .tcn import tcn_model  # noqa: F401
from .transformer import transformer_model  # noqa: F401
