"""
Per-machine inference precision (the port of
``gordo_tpu.parallel.precision``).

``--precision bf16`` or ``auto`` builds may serve a machine with its
weights in bfloat16:

* **Calibrated, per machine.** After a bucket's final fit, each machine's
  bf16 predictions are compared with its float32 predictions on its
  training rows; under ``auto`` a machine whose relative
  reconstruction-MAE delta exceeds the tolerance stays float32. The
  decision (``est.precision_``) travels in the artifact, lands in
  ``build_report.json`` and splits serving groups: a bf16 machine and a
  float32 machine never share one stacked forward.
* **Training is always float32.** bf16 is a cast of the finished weights.
* **What bf16 changes.** The weights are stored in bfloat16 and the
  input is rounded to bfloat16; each layer then computes in its own
  compute type (a float32 model's ``Dense`` layers cast both back to
  float32, as the JAX model's ``nn.Dense(dtype=float32)`` promotes them),
  and the output is float32, so replies keep their types.
* **float32 is silent.** Serving group keys grow a precision entry only
  when it is not float32, and a default build runs no calibration.
"""

from typing import Dict, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "PRECISIONS",
    "DEFAULT_PRECISION_TOLERANCE",
    "resolve_precision",
    "cast_params",
    "mae",
    "mae_parity",
]

#: the --precision vocabulary
PRECISIONS = ("float32", "bf16", "auto")

#: relative reconstruction-MAE tolerance of the bf16 calibration
DEFAULT_PRECISION_TOLERANCE = 0.25


def resolve_precision(value: Optional[str]) -> str:
    """A ``--precision`` value checked against :data:`PRECISIONS`; None
    is the float32 default."""
    if value is None:
        return "float32"
    mode = str(value).strip().lower()
    if mode not in PRECISIONS:
        raise ValueError(f"unknown precision {value!r}; expected one of {PRECISIONS}")
    return mode


def cast_params(params: Dict[str, torch.Tensor], dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """A state dict (or a stacked ``(M, ...)`` one) with its floating
    tensors in ``dtype``; integer tensors (counters and the like) are
    returned as they are."""
    return {
        name: value.to(dtype) if value.is_floating_point() else value
        for name, value in params.items()
    }


def mae(preds: np.ndarray, y: np.ndarray) -> float:
    """Mean absolute reconstruction error, in float64 on the host."""
    p = np.asarray(preds, dtype=np.float64)
    t = np.asarray(y, dtype=np.float64)
    if p.size == 0:
        return 0.0
    return float(np.mean(np.abs(p - t)))


def mae_parity(mae32: float, mae16: float, tolerance: float) -> Tuple[float, bool]:
    """(relative MAE delta of bf16 against float32, whether it is within
    ``tolerance``); the float32 MAE is floored at 1e-12."""
    base = max(abs(float(mae32)), 1e-12)
    delta = abs(float(mae16) - float(mae32)) / base
    return delta, delta <= float(tolerance)
