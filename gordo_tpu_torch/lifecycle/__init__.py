"""
Continuous fleet operation (the port of ``gordo_tpu.lifecycle``): the
loop that closes serving back into building, keeping a served collection
fresh without ever serving a bad revision.

- :mod:`.drift`: :class:`DriftMonitor` takes the per-machine anomaly
  statistics (the anomaly frame and the detector's calibrated
  thresholds, or the stream's ``stream_observation`` events) and keeps
  EWMA and threshold-exceedance state across ticks.
- :mod:`.refit`: the warm weights a refit starts from, and the shadow
  gate that holds each candidate against its live model on a holdout.
- :mod:`.promote`: blue/green revision assembly (a staged sibling
  published by one rename; promoted, retained by hard link, or
  quarantined machines) and the ``latest`` flip.
- :mod:`.manager`: :class:`LifecycleManager` ties one ``tick`` together
  (drift scan, refit of the drifted machines, shadow gate, promotion),
  driven by ``python -m gordo_tpu_torch.cli lifecycle tick|watch|report``.

No module here is imported by the server, builder or streaming paths.
"""

from gordo_tpu_torch.lifecycle.drift import (
    DriftAssessment,
    DriftMonitor,
    total_anomaly_series,
)
from gordo_tpu_torch.lifecycle.manager import (
    LifecycleConfig,
    LifecycleManager,
    TickResult,
)
from gordo_tpu_torch.lifecycle.promote import (
    PROMOTION_REPORT_FILENAME,
    TornPromotion,
    assemble_revision,
    read_promotion_report,
    repoint_latest,
)
from gordo_tpu_torch.lifecycle.refit import (
    ShadowVerdict,
    shadow_gate,
    shadow_score,
    warm_params_from_artifacts,
    warm_params_from_models,
)

__all__ = [
    "DriftAssessment",
    "DriftMonitor",
    "LifecycleConfig",
    "LifecycleManager",
    "PROMOTION_REPORT_FILENAME",
    "ShadowVerdict",
    "TickResult",
    "TornPromotion",
    "assemble_revision",
    "read_promotion_report",
    "repoint_latest",
    "shadow_gate",
    "shadow_score",
    "total_anomaly_series",
    "warm_params_from_artifacts",
    "warm_params_from_models",
]
