"""
Warm-start refit and shadow scoring (the port of
``gordo_tpu.lifecycle.refit``).

The refit itself is a :class:`~gordo_tpu_torch.builder.fleet_build.FleetModelBuilder`
run over the drifted machines with ``initial_params`` set to the served
revision's weights and ``fault_sites=("train", "refit")``; its CV folds
and final fit are fleet fits, so on the card they launch the flash
forward, dq and dk/dv kernels. This module holds the pieces around it:
the warm weights taken from served models, and the shadow gate that
decides promotion.
"""

import dataclasses
import logging
import os
from typing import Any, Dict, Iterable, Mapping, Union

import numpy as np
import torch

from gordo_tpu_torch import serializer
from gordo_tpu_torch.builder.fleet_build import _find_torch_estimator
from gordo_tpu_torch.device import DeviceLike

logger = logging.getLogger(__name__)

#: a candidate may not regress the live model's holdout error by more
#: than this fraction by default
DEFAULT_SHADOW_TOLERANCE = 0.10


def estimator_params(est) -> Dict[str, np.ndarray]:
    """A fitted port estimator's weights by the module's parameter names,
    as host arrays (what the fleet trainer stacks)."""
    module = est._fitted_module()
    return {name: p.detach().cpu().numpy().copy() for name, p in module.named_parameters()}


def load_estimator_params(est, params: Mapping[str, Any]) -> None:
    """Copy ``params`` (by parameter name) into a fitted estimator's
    module in place, on its device."""
    module = est._fitted_module()
    with torch.no_grad():
        for name, p in module.named_parameters():
            p.copy_(torch.as_tensor(np.asarray(params[name]), dtype=p.dtype))
    est.__dict__.pop("_bf16_weights", None)


def warm_params_from_models(models: Mapping[str, Any]) -> Dict[str, Dict[str, np.ndarray]]:
    """
    Machine name -> its weights, from already-loaded models: the
    ``initial_params`` a refit starts from (a tick holds the drifted
    machines' live models from its scan). A machine with no fitted port
    estimator is skipped (logged) and refits cold.
    """
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for name, model in models.items():
        est = _find_torch_estimator(model)
        if est is None or not hasattr(est, "spec_"):
            logger.warning("Warm start: artifact for %s holds no fitted port estimator; it "
                           "will refit cold", name)
            continue
        out[name] = estimator_params(est)
    return out


def warm_params_from_artifacts(
    collection_dir: Union[str, os.PathLike],
    names: Iterable[str],
    device: DeviceLike = None,
) -> Dict[str, Dict[str, np.ndarray]]:
    """:func:`warm_params_from_models` over the named artifacts under
    ``collection_dir`` (loaded onto ``device``, the card unless
    ``"cpu"``); an artifact that does not load is skipped (logged)."""
    models: Dict[str, Any] = {}
    for name in names:
        try:
            models[name] = serializer.load(os.path.join(str(collection_dir), name), device)
        except Exception as exc:  # noqa: BLE001 - per-machine tolerance
            logger.warning("Warm start: artifact for %s does not load (%s)", name, exc)
    return warm_params_from_models(models)


def shadow_score(model: Any, X, y) -> float:
    """
    One model's holdout error: the mean absolute error between its output
    on ``X`` and ``y``, aligned by the model's output offset (a windowed
    model's output is ``lookback - 1 + lookahead`` rows shorter than its
    input). Candidate and live model are scored by this one function on
    the same rows.
    """
    X = getattr(X, "values", X)
    out = np.asarray(model.predict(X) if hasattr(model, "predict") else model.transform(X))
    y_arr = np.asarray(getattr(y, "values", y), dtype=np.float64)
    offset = len(y_arr) - len(out)
    if offset < 0:
        raise ValueError(
            f"Model output ({len(out)} rows) is longer than the holdout targets "
            f"({len(y_arr)} rows)"
        )
    if offset:
        y_arr = y_arr[offset:]
    return float(np.mean(np.abs(np.asarray(out, dtype=np.float64) - y_arr)))


def shadow_gate(live_score: float, candidate_score: float,
                tolerance: float = DEFAULT_SHADOW_TOLERANCE) -> bool:
    """
    True when the candidate may replace the live model: its holdout error
    is within ``(1 + tolerance)`` of the live model's. A non-finite
    candidate score always fails; a non-finite live score always passes
    (the incumbent is already broken on this window).
    """
    if not np.isfinite(candidate_score):
        return False
    if not np.isfinite(live_score):
        return True
    return candidate_score <= live_score * (1.0 + float(tolerance))


@dataclasses.dataclass
class ShadowVerdict:
    """One candidate's shadow-scoring outcome (``promotion_report.json``)."""

    machine: str
    live_score: float
    candidate_score: float
    tolerance: float
    promote: bool

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def degrade_params(params: Mapping[str, Any], scale: float) -> Dict[str, np.ndarray]:
    """The ``refit:degrade`` seam's payload: every weight of the
    candidate multiplied by ``scale``, a deterministic, clearly worse
    candidate the shadow gate must reject."""
    return {name: np.asarray(value) * float(scale) for name, value in params.items()}
