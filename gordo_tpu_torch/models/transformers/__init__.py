"""Pipeline transformers of the port's own (the port of
``gordo_tpu.models.transformers``)."""

from .imputer import InfImputer

__all__ = ["InfImputer"]
