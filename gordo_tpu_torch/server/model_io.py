"""
A served model's output (the port of ``gordo_tpu.server.model_io``):
``predict``, or ``transform`` for a model that has none (a scaler, or a
pipeline that ends in one).
"""

import logging
from typing import Any

import numpy as np

logger = logging.getLogger(__name__)


def get_model_output(model: Any, X) -> np.ndarray:
    """``model.predict(X)``, falling back to ``model.transform(X)`` when
    the model has no ``predict`` (an ``AttributeError``)."""
    try:
        return np.asarray(model.predict(X))
    except AttributeError:
        logger.debug("Model has no predict method; trying transform")
        return np.asarray(model.transform(X))
