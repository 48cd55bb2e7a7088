"""
Model architecture factories, registered by kind under each model type.
"""

from .transformer import transformer_model  # noqa: F401
