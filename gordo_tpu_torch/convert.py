"""
Carries a JAX-built machine into a port artifact: a
``DiffBasedAnomalyDetector`` around a Transformer, TCN, LSTM or GRU
estimator or around a pipeline (``InfImputer``, ``FunctionTransformer``
and ``MinMaxScaler`` steps before an ``AutoEncoder`` or a
``RawModelRegressor``), or a bare estimator.

Input is what a ``gordo_tpu`` artifact holds, as plain data: the Flax
parameter tree as numpy arrays, the model definition dict, the fitted
arrays of the scalers and steps (the detector's scaler's, by the port
scaler's names: a RobustScaler's ``center_``/``scale_``, a
StandardScaler's ``mean_``, ``var_``, ``scale_``, ``n_samples_seen_``;
each pipeline step's arrays as the port's step
names them in ``state_arrays``: a MinMaxScaler's ``data_min_``,
``data_max_``, ``data_range_``, ``scale_`` and ``min_``, an InfImputer's
``posinf_fill_values`` and ``neginf_fill_values``, nothing for a
FunctionTransformer), the thresholds, and the metadata. (Reading those
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
  ``stack.``, the arrays again as they are;
- a TCN tree ``{"params": {"TCNBlock_<i>": {"conv0", "conv1",
  "residual_proj"}, "head"}}`` maps onto ``TCNNet``'s ``blocks.<i>.*``
  and ``head``; Flax's ``Conv.kernel`` is (k, in, out) and torch's
  weight (out, in, k);
- a ``SequentialNet`` tree maps its ``Dense_<k>`` onto ``dense.<k>`` and
  its ``OptimizedLSTMCell_<k>`` gate Denses onto ``lstm.<k>.gates.*``.
"""

import copy
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np

from gordo_tpu_torch import serializer
from gordo_tpu_torch.device import DeviceLike
from gordo_tpu_torch.models.anomaly.diff import THRESHOLD_ATTRS, DiffBasedAnomalyDetector
from gordo_tpu_torch.models.pipeline import Pipeline
from gordo_tpu_torch.models.preprocessing import SCALERS, scaler_from_definition

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


def tcn_state_dict(params: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """A ``TCNNet`` Flax parameter tree -> the port's state dict."""
    tree = params.get("params", params)
    state: Dict[str, np.ndarray] = {}
    for name, leaves in tree.items():
        if name == "head":
            state.update(_layer(leaves, "head"))
        elif name.startswith("TCNBlock_"):
            block = f"blocks.{int(name.rsplit('_', 1)[1])}"
            for conv, conv_leaves in leaves.items():
                kernel = np.asarray(conv_leaves["kernel"], dtype=np.float32)
                state[f"{block}.{conv}.weight"] = np.ascontiguousarray(kernel.transpose(2, 1, 0))
                state[f"{block}.{conv}.bias"] = np.asarray(conv_leaves["bias"], dtype=np.float32)
        else:
            raise ValueError(f"Unexpected Flax module {name}")
    return state


def sequential_state_dict(params: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """A ``SequentialNet`` Flax parameter tree -> the port's state dict."""
    tree = params.get("params", params)
    state: Dict[str, np.ndarray] = {}
    for name, leaves in tree.items():
        index = int(name.rsplit("_", 1)[1])
        if name.startswith("Dense_"):
            state.update(_layer(leaves, f"dense.{index}"))
        elif name.startswith("OptimizedLSTMCell_"):
            for gate, gate_leaves in leaves.items():
                state.update(_layer(gate_leaves, f"lstm.{index}.gates.{gate}"))
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
_TCNS = ("TCNAutoEncoder", "TCNForecast")
_FEEDFORWARD = ("AutoEncoder", "KerasAutoEncoder")
_RAW = ("RawModelRegressor", "KerasRawModelRegressor")
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
    elif name in _TCNS:
        first, last = state["blocks.0.conv0.weight"], state["head.weight"]
    elif name in _RAW:
        name = "RawModelRegressor"
        denses = sorted(int(key.split(".")[1]) for key in state if key.startswith("dense."))
        first = state.get("dense.0.weight", state.get("lstm.0.gates.ii.weight"))
        last = state[f"dense.{denses[-1]}.weight"]
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
    detector keeps its ``scaler`` definition (any of the four ported
    scalers, with its arguments), ``require_thresholds`` and ``window``;
    a pipeline keeps its steps and drops scikit-learn's ``memory``,
    ``verbose`` and ``transform_input``; a MinMaxScaler keeps
    ``feature_range`` and ``clip``, an InfImputer its four arguments and
    a FunctionTransformer its functions and their keyword arguments.
    """
    name, kwargs = _unwrap(definition)
    if name == "DiffBasedAnomalyDetector":
        scaler = kwargs.get("scaler")
        return {
            "gordo_tpu_torch.models.anomaly.DiffBasedAnomalyDetector": {
                "base_estimator": port_definition(kwargs["base_estimator"], state),
                "scaler": None if scaler is None else scaler_from_definition(
                    scaler).into_definition(),
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
    if name in _STEPS:
        path, keys = _STEPS[name]
        return {path: {key: kwargs[key] for key in keys if key in kwargs}}
    return _port_estimator(name, kwargs, state)


# pipeline steps before the estimator: the port's path and the arguments kept
_STEPS = {
    "MinMaxScaler": ("gordo_tpu_torch.models.MinMaxScaler", ("feature_range", "clip")),
    "InfImputer": (
        "gordo_tpu_torch.models.transformers.InfImputer",
        ("inf_fill_value", "neg_inf_fill_value", "strategy", "delta"),
    ),
    "FunctionTransformer": (
        "gordo_tpu_torch.models.FunctionTransformer",
        ("func", "inverse_func", "kw_args", "inv_kw_args"),
    ),
}


def _estimator_name(definition) -> str:
    """The class name of the estimator inside a definition."""
    name, kwargs = _unwrap(definition)
    if name == "DiffBasedAnomalyDetector":
        return _estimator_name(kwargs["base_estimator"])
    if name == "Pipeline":
        last = kwargs["steps"][-1]
        return _estimator_name(last[1] if isinstance(last, (list, tuple)) else last)
    return name


def state_dict_from_flax(params: Mapping[str, Any], estimator: str) -> Dict[str, np.ndarray]:
    """The Flax tree of an ``estimator`` (its class name) -> the port's
    state dict."""
    if estimator in _TRANSFORMERS:
        return transformer_state_dict(params)
    if estimator in _TCNS:
        return tcn_state_dict(params)
    if estimator in _RAW:
        return sequential_state_dict(params)
    if estimator in _FEEDFORWARD:
        return feedforward_state_dict(params)
    if estimator in _RECURRENT:
        return recurrent_state_dict(params)
    raise ValueError(f"No weight mapping for a {estimator}")


def _model_arrays(model, state, pipeline_steps: Sequence[Mapping[str, Any]]) -> dict:
    """The arrays ``model.load_state_arrays`` takes, by the model's
    structure: the net's state dict under the estimator's prefix, each
    pipeline step's arrays under its step's."""
    if isinstance(model, DiffBasedAnomalyDetector):
        inner = _model_arrays(model.base_estimator, state, pipeline_steps)
        return {f"base_estimator.{k}": v for k, v in inner.items()}
    if isinstance(model, Pipeline):
        if len(pipeline_steps) != len(model.steps) - 1:
            raise ValueError(
                f"{len(pipeline_steps)} steps' arrays given for a pipeline of "
                f"{len(model.steps)} steps"
            )
        arrays = {
            f"steps.{i}.{k}": np.asarray(v)
            for i, step in enumerate(pipeline_steps)
            for k, v in step.items()
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
    pipeline_steps: Sequence[Mapping[str, Any]] = (),
    device: DeviceLike = None,
    scaler_arrays: Optional[Mapping[str, np.ndarray]] = None,
):
    """
    Assemble a port model from a JAX machine's parts. A detector needs its
    scaler's fitted arrays: ``scaler_arrays`` by the port scaler's names
    (:func:`scaler_arrays_from_sklearn` reads them off a fitted
    scikit-learn scaler), or for the default RobustScaler its
    ``center_``/``scale_``; ``thresholds`` maps the detector's
    threshold attribute names (``aggregate_threshold_``,
    ``feature_thresholds_`` and the smoothed pair) to values, absent or
    None ones staying unset. ``pipeline_steps`` holds each step's fitted
    arrays before the estimator, in step order (the module docstring
    names them).
    """
    state = state_dict_from_flax(params, _estimator_name(definition))
    model = serializer.from_definition(port_definition(definition, state))
    arrays = _model_arrays(model, state, pipeline_steps)
    if isinstance(model, DiffBasedAnomalyDetector):
        if scaler_arrays is None:
            scaler_arrays = {"center_": scaler_center, "scale_": scaler_scale}
        arrays.update({f"scaler.{k}": np.asarray(v) for k, v in scaler_arrays.items()
                       if v is not None})
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
    pipeline_steps: Sequence[Mapping[str, Any]] = (),
    scaler_arrays: Optional[Mapping[str, np.ndarray]] = None,
) -> Path:
    """:func:`model_from_flax`, written as a port artifact at
    ``dest_dir`` (assembled on the CPU: only arrays are written)."""
    model = model_from_flax(
        params, definition, scaler_center, scaler_scale, thresholds,
        pipeline_steps, device="cpu", scaler_arrays=scaler_arrays,
    )
    return serializer.dump(model, dest_dir, metadata or {})


def scaler_arrays_from_sklearn(scaler) -> Dict[str, np.ndarray]:
    """The fitted arrays of a scikit-learn scaler (a JAX detector's
    ``scaler``) by the names the port scaler of its class stores."""
    port = SCALERS[type(scaler).__name__]
    return {name: np.asarray(getattr(scaler, name)) for name in port.ARRAYS
            if getattr(scaler, name, None) is not None}
