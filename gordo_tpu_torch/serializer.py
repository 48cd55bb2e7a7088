"""
The port's artifact format (the counterpart of
``gordo_tpu.serializer.serializer``, which pickles ``gordo_tpu`` objects).

An artifact is a directory of three files:

- ``definition.json``: the model definition, ``{"<class path>": kwargs}``
  with the base estimator and a pipeline's steps nested the same way, as
  the JAX package's ``into_definition`` writes it (class paths name the
  port's classes);
- ``params.npz``: every array the model needs, flat, by dotted name:
  ``base_estimator.<state-dict key>`` for a detector's weights (a
  pipeline's under ``base_estimator.steps.<i>.``, its scaler's fitted
  ``scale_``, ``min_``, ... beside its estimator's state dict), the
  detector's error scaler's fitted arrays under ``scaler.`` (a
  RobustScaler's ``center_`` and ``scale_``, a StandardScaler's
  ``mean_``, ``var_``, ``scale_`` and ``n_samples_seen_``, ...), and the
  fitted thresholds under their attribute names; a bare estimator's
  state dict keys unprefixed;
- ``metadata.json``: the build metadata, with the JAX artifact's keys.

Nothing is pickled, so loading an artifact runs no code from it. The
three files are written into a sibling temporary directory which is
then renamed into place, so a reader sees the whole artifact or none.
:func:`dumps` packs an artifact's three files into one gzipped tar (what
the server's ``download-model`` route sends) and :func:`loads` reads a
model back from those bytes.
"""

import io
import json
import math
import os
import shutil
import tarfile
from pathlib import Path
from typing import Any, Dict, Tuple, Union

import numpy as np

from gordo_tpu_torch.device import DeviceLike
from gordo_tpu_torch.models.callbacks import Callback, EarlyStopping, TerminateOnNaN
from gordo_tpu_torch.models.anomaly.diff import DiffBasedAnomalyDetector
from gordo_tpu_torch.models.models import (
    AutoEncoder,
    GRUAutoEncoder,
    GRUForecast,
    LSTMAutoEncoder,
    LSTMForecast,
    RawModelRegressor,
    TCNAutoEncoder,
    TCNForecast,
    TransformerAutoEncoder,
    TransformerForecast,
)
from gordo_tpu_torch.models.pipeline import FunctionTransformer, Pipeline
from gordo_tpu_torch.models.preprocessing import SCALERS
from gordo_tpu_torch.models.transformers import InfImputer
from gordo_tpu_torch.utils.atomic import atomic_publish_dir

DEFINITION_FILENAME = "definition.json"
PARAMS_FILENAME = "params.npz"
METADATA_FILENAME = "metadata.json"
ARTIFACT_FILES = (DEFINITION_FILENAME, PARAMS_FILENAME, METADATA_FILENAME)

#: the classes a definition may name, by the last part of its class path
#: (``sklearn.pipeline.Pipeline``, ``gordo_tpu.models.AutoEncoder`` and the
#: port's own paths alike)
MODEL_CLASSES = {
    cls.__name__: cls
    for cls in (
        DiffBasedAnomalyDetector,
        TransformerAutoEncoder,
        TransformerForecast,
        TCNAutoEncoder,
        TCNForecast,
        LSTMAutoEncoder,
        LSTMForecast,
        GRUAutoEncoder,
        GRUForecast,
        AutoEncoder,
        RawModelRegressor,
        Pipeline,
        InfImputer,
        FunctionTransformer,
    )
}
MODEL_CLASSES.update(SCALERS)
# the reference's names of the feedforward, LSTM and raw estimators (an
# alias is the same class, so it needs its own key)
MODEL_CLASSES.update(
    KerasAutoEncoder=AutoEncoder,
    KerasLSTMAutoEncoder=LSTMAutoEncoder,
    KerasLSTMForecast=LSTMForecast,
    KerasRawModelRegressor=RawModelRegressor,
)

#: the training callbacks a model's ``callbacks`` fit argument may name,
#: under any of these class path prefixes (the Keras ones of reference
#: configs, the JAX package's and the port's)
CALLBACK_CLASSES = {cls.__name__: cls for cls in (Callback, EarlyStopping, TerminateOnNaN)}
CALLBACK_PREFIXES = (
    "tensorflow.keras.callbacks.",
    "keras.callbacks.",
    "gordo_tpu.models.callbacks.",
    "gordo_tpu_torch.models.callbacks.",
)

PathLike = Union[str, os.PathLike]


def callback_from_definition(definition: Union[str, Dict[str, Any]]) -> Callback:
    """``"<class path>"`` or ``{"<class path>": kwargs}`` of a training
    callback -> the port's callback; ValueError for one it does not
    have (e.g. ``ReduceLROnPlateau``)."""
    if isinstance(definition, str):
        definition = {definition: {}}
    if not isinstance(definition, dict) or len(definition) != 1:
        raise ValueError(f"A definition has exactly one class path key: {definition!r}")
    path, kwargs = next(iter(definition.items()))
    prefix, _, name = str(path).rpartition(".")
    if prefix + "." not in CALLBACK_PREFIXES or name not in CALLBACK_CLASSES:
        raise ValueError(f"{path!r} is not a training callback the port has")
    return CALLBACK_CLASSES[name](**dict(kwargs or {}))


def callback_into_definition(callback: Callback) -> Dict[str, Any]:
    """The definition :func:`callback_from_definition` reads back."""
    cls = type(callback)
    return {f"{cls.__module__}.{cls.__name__}": callback.get_params()}


def _pipeline_step(step) -> Tuple[str, Any]:
    """A step definition, or a (name, definition) pair, -> (name, object);
    an unnamed step is named ``step_<class name>``, as the JAX package
    names it."""
    if isinstance(step, (list, tuple)) and len(step) == 2:
        name, definition = step
        return name, from_definition(definition)
    obj = from_definition(step)
    return f"step_{type(obj).__name__}", obj


def from_definition(definition: Union[str, Dict[str, Any]]):
    """
    ``"<class path>"`` or ``{"<class path>": kwargs}`` -> an unfitted
    model; a nested ``base_estimator`` definition and a pipeline's
    ``steps`` are built the same way.
    """
    if isinstance(definition, str):
        definition = {definition: {}}
    if not isinstance(definition, dict) or len(definition) != 1:
        raise ValueError(f"A definition has exactly one class path key: {definition!r}")
    path, kwargs = next(iter(definition.items()))
    name = path.rsplit(".", 1)[-1]
    try:
        cls = MODEL_CLASSES[name]
    except KeyError:
        raise ValueError(
            f"{path!r} is not a model the port serves; known: {sorted(MODEL_CLASSES)}"
        ) from None
    kwargs = dict(kwargs or {})
    if isinstance(kwargs.get("base_estimator"), (dict, str)):
        kwargs["base_estimator"] = from_definition(kwargs["base_estimator"])
    if "steps" in kwargs:
        kwargs["steps"] = [_pipeline_step(step) for step in kwargs["steps"]]
    if hasattr(cls, "from_definition"):
        return cls.from_definition(kwargs)
    return cls(**kwargs)


def _sanitize_nan(obj: Any) -> Any:
    """NaN/Infinity floats -> None, so the JSON stays valid."""
    if isinstance(obj, float):
        return None if (math.isnan(obj) or math.isinf(obj)) else obj
    if isinstance(obj, dict):
        return {key: _sanitize_nan(value) for key, value in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_sanitize_nan(value) for value in obj]
    return obj


def dump(model, dest_dir: PathLike, metadata: Dict[str, Any]) -> Path:
    """Write ``model`` and ``metadata`` as an artifact at ``dest_dir``,
    replacing any artifact there as a whole."""
    dest_dir = Path(dest_dir)
    dest_dir.parent.mkdir(parents=True, exist_ok=True)
    tmp_dir = dest_dir.parent / f".{dest_dir.name}.tmp-{os.getpid()}"
    if tmp_dir.exists():
        shutil.rmtree(tmp_dir)
    tmp_dir.mkdir()
    try:
        with open(tmp_dir / DEFINITION_FILENAME, "w") as fh:
            json.dump(model.into_definition(), fh, indent=1)
        np.savez(tmp_dir / PARAMS_FILENAME, **model.state_arrays())
        with open(tmp_dir / METADATA_FILENAME, "w") as fh:
            json.dump(_sanitize_nan(metadata), fh, default=str)
        atomic_publish_dir(tmp_dir, dest_dir)
    except BaseException:
        shutil.rmtree(tmp_dir, ignore_errors=True)
        raise
    return dest_dir


def _model(definition: Dict[str, Any], params_file, device: DeviceLike):
    model = from_definition(definition)
    with np.load(params_file, allow_pickle=False) as npz:
        arrays = {name: npz[name] for name in npz.files}
    return model.load_state_arrays(arrays, device)


def load(source_dir: PathLike, device: DeviceLike = None):
    """The model stored at ``source_dir``, its weights on ``device`` (the
    card unless ``"cpu"`` is asked for)."""
    source_dir = Path(source_dir)
    definition_file = source_dir / DEFINITION_FILENAME
    if not definition_file.is_file():
        raise FileNotFoundError(f"No {DEFINITION_FILENAME} found in {source_dir}")
    with open(definition_file) as fh:
        definition = json.load(fh)
    return _model(definition, source_dir / PARAMS_FILENAME, device)


def dumps(source_dir: PathLike) -> bytes:
    """The artifact at ``source_dir`` as the bytes of one gzipped tar of
    its three files. Not a pickle: :func:`loads` reads it back."""
    source_dir = Path(source_dir)
    buffer = io.BytesIO()
    with tarfile.open(fileobj=buffer, mode="w:gz") as tar:
        for name in ARTIFACT_FILES:
            if not (source_dir / name).is_file():
                raise FileNotFoundError(f"No {name} found in {source_dir}")
            tar.add(source_dir / name, arcname=name)
    return buffer.getvalue()


def loads(data: bytes, device: DeviceLike = None):
    """The model in an archive from :func:`dumps`, its weights on
    ``device`` (the card unless ``"cpu"`` is asked for). Only the
    artifact's three files are read; nothing is extracted to disk."""
    files = {}
    with tarfile.open(fileobj=io.BytesIO(data), mode="r:gz") as tar:
        for member in tar.getmembers():
            if member.name in ARTIFACT_FILES and member.isfile():
                files[member.name] = tar.extractfile(member).read()
    missing = [name for name in ARTIFACT_FILES if name not in files]
    if missing:
        raise ValueError(f"Not a model archive: {missing} missing")
    return _model(json.loads(files[DEFINITION_FILENAME]), io.BytesIO(files[PARAMS_FILENAME]),
                  device)


def unpack(data: bytes, dest_dir: PathLike) -> Path:
    """Write an archive from :func:`dumps` as the artifact at
    ``dest_dir`` (its three files only, published whole)."""
    dest_dir = Path(dest_dir)
    files = {}
    with tarfile.open(fileobj=io.BytesIO(data), mode="r:gz") as tar:
        for member in tar.getmembers():
            if member.name in ARTIFACT_FILES and member.isfile():
                files[member.name] = tar.extractfile(member).read()
    missing = [name for name in ARTIFACT_FILES if name not in files]
    if missing:
        raise ValueError(f"Not a model archive: {missing} missing")
    dest_dir.parent.mkdir(parents=True, exist_ok=True)
    tmp_dir = dest_dir.parent / f".{dest_dir.name}.tmp-{os.getpid()}"
    shutil.rmtree(tmp_dir, ignore_errors=True)
    tmp_dir.mkdir()
    try:
        for name, content in files.items():
            (tmp_dir / name).write_bytes(content)
        atomic_publish_dir(tmp_dir, dest_dir)
    except BaseException:
        shutil.rmtree(tmp_dir, ignore_errors=True)
        raise
    return dest_dir


def load_metadata(source_dir: PathLike) -> Dict[str, Any]:
    """The artifact's metadata dict."""
    path = Path(source_dir) / METADATA_FILENAME
    if not path.is_file():
        raise FileNotFoundError(f"No {METADATA_FILENAME} found in {source_dir}")
    with open(path) as fh:
        return json.load(fh)
