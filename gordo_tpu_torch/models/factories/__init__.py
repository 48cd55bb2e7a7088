"""
Model architecture factories, registered by kind under each model type.
"""

from .feedforward import (  # noqa: F401
    feedforward_hourglass,
    feedforward_model,
    feedforward_symmetric,
)
from .transformer import transformer_model  # noqa: F401
