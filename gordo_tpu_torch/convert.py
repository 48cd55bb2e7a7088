"""
Carries a JAX-built Transformer anomaly machine into a port artifact.

Input is what a ``gordo_tpu`` artifact holds, as plain data: the Flax
parameter tree as numpy arrays, the model definition dict, the fitted
RobustScaler's ``center_``/``scale_``, the thresholds, and the metadata.
(Reading those out of a JAX artifact unpickles ``gordo_tpu`` objects and
so needs JAX; that step belongs to the caller.)

Weight mapping, Flax -> torch:

- ``Dense.kernel`` is (in, out); ``nn.Linear.weight`` is (out, in), so
  kernels are transposed;
- ``LayerNorm.scale`` is torch's ``.weight`` (the port's LayerNorm uses
  Flax's eps of 1e-6);
- the tree ``{"params": {"embed", "TransformerBlock_<i>": {"LayerNorm_0",
  "MultiHeadSelfAttention_0": {"query", "key", "value", "out"},
  "LayerNorm_1", "Dense_0", "Dense_1"}, "LayerNorm_0", "head"}}`` maps
  onto ``TransformerNet``'s ``embed``, ``blocks.<i>.{norm1, attn.*,
  norm2, ff1, ff2}``, ``norm`` and ``head``.
"""

import copy
from pathlib import Path
from typing import Any, Dict, Mapping, Optional

import numpy as np

from gordo_tpu_torch import serializer
from gordo_tpu_torch.device import DeviceLike
from gordo_tpu_torch.models.anomaly.diff import THRESHOLD_ATTRS, DiffBasedAnomalyDetector

_BLOCK_LAYERS = {
    "LayerNorm_0": "norm1",
    "LayerNorm_1": "norm2",
    "Dense_0": "ff1",
    "Dense_1": "ff2",
}
_TOP_LAYERS = {"embed": "embed", "LayerNorm_0": "norm", "head": "head"}


def _layer(leaves: Mapping[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    """One Dense or LayerNorm's leaves -> torch state entries."""
    out = {}
    for name, value in leaves.items():
        value = np.asarray(value, dtype=np.float32)
        if name == "kernel":
            out[f"{prefix}.weight"] = np.ascontiguousarray(value.T)
        elif name == "scale":
            out[f"{prefix}.weight"] = value
        elif name == "bias":
            out[f"{prefix}.bias"] = value
        else:
            raise ValueError(f"Unexpected Flax leaf {prefix}/{name}")
    return out


def transformer_state_dict(params: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """A ``TransformerNet`` Flax parameter tree -> the port's state dict."""
    tree = params.get("params", params)
    state: Dict[str, np.ndarray] = {}
    for name, leaves in tree.items():
        if name in _TOP_LAYERS:
            state.update(_layer(leaves, _TOP_LAYERS[name]))
        elif name.startswith("TransformerBlock_"):
            block = f"blocks.{int(name.rsplit('_', 1)[1])}"
            for sub, sub_leaves in leaves.items():
                if sub == "MultiHeadSelfAttention_0":
                    for proj, proj_leaves in sub_leaves.items():
                        state.update(_layer(proj_leaves, f"{block}.attn.{proj}"))
                elif sub in _BLOCK_LAYERS:
                    state.update(_layer(sub_leaves, f"{block}.{_BLOCK_LAYERS[sub]}"))
                else:
                    raise ValueError(f"Unexpected Flax module {name}/{sub}")
        else:
            raise ValueError(f"Unexpected Flax module {name}")
    return state


def _unwrap(definition: Mapping[str, Any]) -> tuple:
    (path, kwargs), = definition.items()
    return path.rsplit(".", 1)[-1], dict(kwargs or {})


def port_definition(
    definition: Mapping[str, Any], state: Mapping[str, np.ndarray]
) -> Dict[str, Any]:
    """
    A JAX ``DiffBasedAnomalyDetector(<Transformer estimator>)`` definition
    (class paths of either package) -> the port's definition, with the
    input and output widths read off the weights where it lacks them.
    The JAX scaler definition is dropped: the port carries the fitted
    scaler as arrays.
    """
    name, detector_kwargs = _unwrap(definition)
    if name != "DiffBasedAnomalyDetector":
        raise ValueError(f"Expected a DiffBasedAnomalyDetector definition, got {name}")
    base_name, base_kwargs = _unwrap(detector_kwargs["base_estimator"])
    base_kwargs = copy.deepcopy(base_kwargs)
    base_kwargs.setdefault("n_features", int(state["embed.weight"].shape[1]))
    base_kwargs.setdefault("n_features_out", int(state["head.weight"].shape[0]))
    return {
        "gordo_tpu_torch.models.anomaly.DiffBasedAnomalyDetector": {
            "base_estimator": {f"gordo_tpu_torch.models.{base_name}": base_kwargs},
            "require_thresholds": detector_kwargs.get("require_thresholds", True),
            "window": detector_kwargs.get("window"),
        }
    }


def detector_from_flax(
    params: Mapping[str, Any],
    definition: Mapping[str, Any],
    scaler_center: np.ndarray,
    scaler_scale: np.ndarray,
    thresholds: Mapping[str, Optional[Any]],
    device: DeviceLike = None,
) -> DiffBasedAnomalyDetector:
    """
    Assemble a port detector from a JAX machine's parts. ``thresholds``
    maps the detector's threshold attribute names
    (``aggregate_threshold_``, ``feature_thresholds_`` and the smoothed
    pair) to values; absent or None ones stay unset.
    """
    state = transformer_state_dict(params)
    detector = serializer.from_definition(port_definition(definition, state))
    arrays = {f"base_estimator.{k}": v for k, v in state.items()}
    arrays["scaler.center_"] = np.asarray(scaler_center)
    arrays["scaler.scale_"] = np.asarray(scaler_scale)
    for attr in THRESHOLD_ATTRS:
        if thresholds.get(attr) is not None:
            arrays[attr] = np.asarray(thresholds[attr], dtype=np.float64)
    return detector.load_state_arrays(arrays, device)


def write_artifact(
    dest_dir,
    params: Mapping[str, Any],
    definition: Mapping[str, Any],
    scaler_center: np.ndarray,
    scaler_scale: np.ndarray,
    thresholds: Mapping[str, Optional[Any]],
    metadata: Dict[str, Any],
) -> Path:
    """:func:`detector_from_flax`, written as a port artifact at
    ``dest_dir`` (assembled on the CPU: only arrays are written)."""
    detector = detector_from_flax(
        params, definition, scaler_center, scaler_scale, thresholds, device="cpu"
    )
    return serializer.dump(detector, dest_dir, metadata)
