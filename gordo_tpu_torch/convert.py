"""
Carries a JAX-built machine into a port artifact: a
``DiffBasedAnomalyDetector`` around a Transformer, LSTM or GRU estimator
or around the default pipeline (``Pipeline(MinMaxScaler, AutoEncoder)``),
or a bare estimator.

Input is what a ``gordo_tpu`` artifact holds, as plain data: the Flax
parameter tree as numpy arrays, the model definition dict, the fitted
scalers' arrays (the detector's RobustScaler ``center_``/``scale_``, each
pipeline MinMaxScaler's ``data_min_``, ``data_max_``, ``data_range_``,
``scale_`` and ``min_``), the thresholds, and the metadata. (Reading those
out of a JAX artifact unpickles ``gordo_tpu`` objects and so needs JAX;
that step belongs to the caller.)

Weight mapping, Flax -> torch:

- ``Dense.kernel`` is (in, out); ``nn.Linear.weight`` is (out, in), so
  kernels are transposed;
- ``LayerNorm.scale`` is torch's ``.weight`` (the port's LayerNorm uses
  Flax's eps of 1e-6);
- a Transformer's tree ``{"params": {"embed", "TransformerBlock_<i>":
  {"LayerNorm_0", "MultiHeadSelfAttention_0": {"query", "key", "value",
  "out"}, "LayerNorm_1", "Dense_0", "Dense_1"}, "LayerNorm_0", "head"}}``
  maps onto ``TransformerNet``'s ``embed``, ``blocks.<i>.{norm1, attn.*,
  norm2, ff1, ff2}``, ``norm`` and ``head``;
- a feedforward tree ``{"params": {"Dense_<i>"}}`` maps onto
  ``FeedForwardNet``'s ``layers.<i>``;
- a recurrent tree (``LSTMNet``, LSTM or GRU) maps its head ``Dense_0``
  onto ``head`` and its layers onto ``layers.<i>``:
  ``OptimizedLSTMCell_<i>``/``GRUCell_<i>``'s gate Denses (``ii``,
  ``hf``, ``in``, ...) onto ``gates.<gate>``, ``FusedLSTMLayer_<i>``/
  ``FusedGRULayer_<i>``'s ``input_proj`` onto ``input_proj`` and its
  ``recurrent_*`` arrays as they are (the port keeps those in Flax's
  (in, out) layout); the stacked schedule's ``input_proj_0`` and
  ``input_kernel_<l>``, ``recurrent_kernel_<l>``, ... go under
  ``stack.``, the arrays again as they are.
"""

import copy
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np

from gordo_tpu_torch import serializer
from gordo_tpu_torch.device import DeviceLike
from gordo_tpu_torch.models.anomaly.diff import THRESHOLD_ATTRS, DiffBasedAnomalyDetector
from gordo_tpu_torch.models.pipeline import Pipeline

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


def feedforward_state_dict(params: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """A ``FeedForwardNet`` Flax parameter tree -> the port's state dict."""
    tree = params.get("params", params)
    state: Dict[str, np.ndarray] = {}
    for name, leaves in tree.items():
        if not name.startswith("Dense_"):
            raise ValueError(f"Unexpected Flax module {name}")
        state.update(_layer(leaves, f"layers.{int(name.rsplit('_', 1)[1])}"))
    return state


_UNFUSED_LAYERS = ("OptimizedLSTMCell_", "GRUCell_")
_RECURRENT_LAYERS = _UNFUSED_LAYERS + ("FusedLSTMLayer_", "FusedGRULayer_")


def recurrent_state_dict(params: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """An ``LSTMNet`` Flax parameter tree (any of its six layouts) -> the
    port's state dict."""
    tree = params.get("params", params)
    state: Dict[str, np.ndarray] = {}
    for name, leaves in tree.items():
        if name == "Dense_0":
            state.update(_layer(leaves, "head"))
        elif name.startswith(_RECURRENT_LAYERS):
            prefix = f"layers.{int(name.rsplit('_', 1)[1])}"
            for sub, value in leaves.items():
                if name.startswith(_UNFUSED_LAYERS):
                    state.update(_layer(value, f"{prefix}.gates.{sub}"))
                elif sub == "input_proj":
                    state.update(_layer(value, f"{prefix}.input_proj"))
                else:
                    state[f"{prefix}.{sub}"] = np.asarray(value, dtype=np.float32)
        elif name == "input_proj_0":
            state.update(_layer(leaves, "stack.input_proj_0"))
        elif name.startswith(("input_kernel_", "input_bias_", "recurrent_")):
            state[f"stack.{name}"] = np.asarray(leaves, dtype=np.float32)
        else:
            raise ValueError(f"Unexpected Flax module {name}")
    return state


def _unwrap(definition) -> tuple:
    """``"a.b.Name"`` or ``{"a.b.Name": kwargs}`` -> (Name, kwargs)."""
    if isinstance(definition, str):
        return definition.rsplit(".", 1)[-1], {}
    (path, kwargs), = definition.items()
    return path.rsplit(".", 1)[-1], dict(kwargs or {})


_TRANSFORMERS = ("TransformerAutoEncoder", "TransformerForecast")
_FEEDFORWARD = ("AutoEncoder", "KerasAutoEncoder")
#: the recurrent estimators by any of their names -> the port's class name
_RECURRENT = {
    **{name: name for name in ("LSTMAutoEncoder", "LSTMForecast", "GRUAutoEncoder",
                               "GRUForecast")},
    "KerasLSTMAutoEncoder": "LSTMAutoEncoder",
    "KerasLSTMForecast": "LSTMForecast",
}
#: where a recurrent net's first layer keeps its (out, in) input weight
_RECURRENT_INPUTS = ("layers.0.input_proj.weight", "layers.0.gates.ii.weight",
                     "layers.0.gates.ir.weight", "stack.input_proj_0.weight")


def _port_estimator(name: str, kwargs: dict, state: Mapping[str, np.ndarray]) -> dict:
    """An estimator's definition with its widths read off the weights
    where it lacks them."""
    kwargs = copy.deepcopy(kwargs)
    if name in _TRANSFORMERS:
        first, last = state["embed.weight"], state["head.weight"]
    elif name in _FEEDFORWARD:
        name = "AutoEncoder"
        n_layers = len({key.split(".")[1] for key in state})
        first, last = state["layers.0.weight"], state[f"layers.{n_layers - 1}.weight"]
    elif name in _RECURRENT:
        name = _RECURRENT[name]
        first = next(state[key] for key in _RECURRENT_INPUTS if key in state)
        last = state["head.weight"]
    else:
        raise ValueError(f"No weight mapping for a {name}")
    kwargs.setdefault("n_features", int(first.shape[1]))
    kwargs.setdefault("n_features_out", int(last.shape[0]))
    return {f"gordo_tpu_torch.models.{name}": kwargs}


def port_definition(definition, state: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    """
    A JAX definition (class paths of either package) -> the port's. A
    detector keeps ``require_thresholds`` and ``window`` and drops its
    scaler's definition (the port carries the fitted scaler as arrays);
    a pipeline keeps its steps and drops scikit-learn's ``memory``,
    ``verbose`` and ``transform_input``; a MinMaxScaler keeps
    ``feature_range`` and ``clip``.
    """
    name, kwargs = _unwrap(definition)
    if name == "DiffBasedAnomalyDetector":
        return {
            "gordo_tpu_torch.models.anomaly.DiffBasedAnomalyDetector": {
                "base_estimator": port_definition(kwargs["base_estimator"], state),
                "require_thresholds": kwargs.get("require_thresholds", True),
                "window": kwargs.get("window"),
            }
        }
    if name == "Pipeline":
        steps = [step[1] if isinstance(step, (list, tuple)) else step for step in kwargs["steps"]]
        return {
            "gordo_tpu_torch.models.Pipeline": {
                "steps": [port_definition(step, state) for step in steps]
            }
        }
    if name == "MinMaxScaler":
        return {
            "gordo_tpu_torch.models.MinMaxScaler": {
                key: kwargs[key] for key in ("feature_range", "clip") if key in kwargs
            }
        }
    return _port_estimator(name, kwargs, state)


def state_dict_from_flax(params: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """A Flax tree of any ported family -> the port's state dict."""
    tree = params.get("params", params)
    if all(name.startswith("Dense_") for name in tree):
        return feedforward_state_dict(params)
    if "embed" in tree:
        return transformer_state_dict(params)
    return recurrent_state_dict(params)


def _model_arrays(model, state, pipeline_scalers: Sequence[Mapping[str, Any]]) -> dict:
    """The arrays ``model.load_state_arrays`` takes, by the model's
    structure: the net's state dict under the estimator's prefix, each
    pipeline scaler's arrays under its step's."""
    if isinstance(model, DiffBasedAnomalyDetector):
        inner = _model_arrays(model.base_estimator, state, pipeline_scalers)
        return {f"base_estimator.{k}": v for k, v in inner.items()}
    if isinstance(model, Pipeline):
        if len(pipeline_scalers) != len(model.steps) - 1:
            raise ValueError(
                f"{len(pipeline_scalers)} scalers given for a pipeline of "
                f"{len(model.steps)} steps"
            )
        arrays = {
            f"steps.{i}.{k}": np.asarray(v)
            for i, scaler in enumerate(pipeline_scalers)
            for k, v in scaler.items()
        }
        arrays.update({f"steps.{len(model.steps) - 1}.{k}": v for k, v in state.items()})
        return arrays
    return dict(state)


def model_from_flax(
    params: Mapping[str, Any],
    definition,
    scaler_center: Optional[np.ndarray] = None,
    scaler_scale: Optional[np.ndarray] = None,
    thresholds: Optional[Mapping[str, Optional[Any]]] = None,
    pipeline_scalers: Sequence[Mapping[str, Any]] = (),
    device: DeviceLike = None,
):
    """
    Assemble a port model from a JAX machine's parts. A detector needs its
    scaler's ``center_``/``scale_``; ``thresholds`` maps the detector's
    threshold attribute names (``aggregate_threshold_``,
    ``feature_thresholds_`` and the smoothed pair) to values, absent or
    None ones staying unset. ``pipeline_scalers`` holds each MinMaxScaler
    step's fitted arrays, in step order.
    """
    state = state_dict_from_flax(params)
    model = serializer.from_definition(port_definition(definition, state))
    arrays = _model_arrays(model, state, pipeline_scalers)
    if isinstance(model, DiffBasedAnomalyDetector):
        arrays["scaler.center_"] = np.asarray(scaler_center)
        arrays["scaler.scale_"] = np.asarray(scaler_scale)
        for attr in THRESHOLD_ATTRS:
            if (thresholds or {}).get(attr) is not None:
                arrays[attr] = np.asarray(thresholds[attr], dtype=np.float64)
    return model.load_state_arrays(arrays, device)


def write_artifact(
    dest_dir,
    params: Mapping[str, Any],
    definition,
    scaler_center: Optional[np.ndarray] = None,
    scaler_scale: Optional[np.ndarray] = None,
    thresholds: Optional[Mapping[str, Optional[Any]]] = None,
    metadata: Optional[Dict[str, Any]] = None,
    pipeline_scalers: Sequence[Mapping[str, Any]] = (),
) -> Path:
    """:func:`model_from_flax`, written as a port artifact at
    ``dest_dir`` (assembled on the CPU: only arrays are written)."""
    model = model_from_flax(
        params, definition, scaler_center, scaler_scale, thresholds,
        pipeline_scalers, device="cpu",
    )
    return serializer.dump(model, dest_dir, metadata or {})
