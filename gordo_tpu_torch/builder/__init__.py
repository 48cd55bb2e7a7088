"""Builds one machine's model from its config: cross-validation, fit, artifact."""

from .build_model import ModelBuilder  # noqa: F401
