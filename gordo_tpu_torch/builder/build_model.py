"""
ModelBuilder: the train-one-machine pipeline (the port of
``gordo_tpu.builder.build_model``).

``build`` fetches the machine's dataset through the port's data layer
(``_get_dataset(machine["dataset"]).get_data()``), as the JAX builder
does, or takes X, y and their time index as arrays. From there it does
what the JAX builder does: inject the evaluation seed into every
estimator, cross-validate with per-tag and aggregate scorers (the
anomaly detector derives its thresholds on the way), record the fold
scores and splits, fit on all the data, measure the model's output
offset, assemble the build metadata with the JAX keys (the fetch's
``query_duration_sec`` and ``dataset_meta`` among them), and write the
port's artifact, which the port's server serves.

A machine is a plain dict with the JAX ``Machine``'s keys (``name``,
``project_name``, ``model``, ``dataset``, ``evaluation``, ``metadata``,
``runtime``). Evaluation keys a machine leaves out take the defaults a
JAX project config gives them: ``cv_mode: full_build``, a RobustScaler as
``scoring_scaler`` and the four default metrics; ``cv`` defaults to
``TimeSeriesSplit(n_splits=3)``.
"""

import copy
import functools
import logging
import time
from datetime import datetime, timezone
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from gordo_tpu_torch import __version__, serializer
from gordo_tpu_torch.data import _get_dataset
from gordo_tpu_torch.data.base import to_datetimes
from gordo_tpu_torch.data.sensor_tag import tag_names
from gordo_tpu_torch.device import DeviceLike, resolve_device
from gordo_tpu_torch.models.anomaly.diff import RobustScaling
from gordo_tpu_torch.models.core import BaseTorchEstimator, as_2d
from gordo_tpu_torch.models.pipeline import Pipeline
from gordo_tpu_torch.models.utils import METRICS, TimeSeriesSplit, cross_validate, metric_wrapper

logger = logging.getLogger(__name__)

DEFAULT_CV = {"sklearn.model_selection.TimeSeriesSplit": {"n_splits": 3}}
DEFAULT_EVALUATION = {
    "cv_mode": "full_build",
    "scoring_scaler": "sklearn.preprocessing.RobustScaler",
    "metrics": list(METRICS),
}
_CV_MODES = ("full_build", "cross_val_only", "build_only")
# the cross-validation metadata of a build that did not cross-validate
_EMPTY_CV: Dict[str, Any] = {"scores": {}, "cv_duration_sec": None, "splits": {}}


def _class_name(definition) -> Tuple[str, dict]:
    """``"a.b.Name"`` or ``{"a.b.Name": kwargs}`` -> (Name, kwargs)."""
    if isinstance(definition, str):
        return definition.rsplit(".", 1)[-1], {}
    (path, kwargs), = definition.items()
    return path.rsplit(".", 1)[-1], dict(kwargs or {})


def _splitter(definition) -> TimeSeriesSplit:
    name, kwargs = _class_name(definition)
    if name != "TimeSeriesSplit":
        raise NotImplementedError(f"cv splitter {name!r} is not ported (ROADMAP.md queue 1)")
    return TimeSeriesSplit(**kwargs)


def _scoring_scaler(definition) -> Optional[RobustScaling]:
    if not definition:
        return None
    name, kwargs = _class_name(definition)
    if name != "RobustScaler" or kwargs:
        raise NotImplementedError(
            f"scoring_scaler {definition!r} is not ported; the port has the "
            "default RobustScaler (ROADMAP.md queue 1)"
        )
    return RobustScaling()


def _inject_seed(model, seed: int) -> None:
    """Give every estimator in the model tree the evaluation seed, unless
    its config already pins one."""
    if isinstance(model, BaseTorchEstimator):
        model.kwargs.setdefault("seed", seed)
    for _, step in getattr(model, "steps", ()):
        _inject_seed(step, seed)
    base = getattr(model, "base_estimator", None)
    if base is not None:
        _inject_seed(base, seed)


def fitted_estimator(model) -> BaseTorchEstimator:
    """The torch estimator inside a model tree (detector, pipeline)."""
    while not isinstance(model, BaseTorchEstimator):
        model = model.steps[-1][1] if isinstance(model, Pipeline) else model.base_estimator
    return model


class ModelBuilder:
    def __init__(self, machine: Mapping[str, Any]):
        machine = copy.deepcopy(dict(machine))
        for key in ("name", "project_name", "model", "dataset"):
            if key not in machine:
                raise ValueError(f"A machine needs {key!r}")
        dataset = machine["dataset"]
        if "tag_list" not in dataset:
            dataset["tag_list"] = dataset.pop("tags")
        if not dataset.get("target_tag_list"):
            dataset["target_tag_list"] = list(dataset["tag_list"])
        dataset.setdefault("resolution", "10T")
        machine["evaluation"] = {**DEFAULT_EVALUATION, **(machine.get("evaluation") or {})}
        machine.setdefault("runtime", {})
        machine["metadata"] = {"user_defined": {}, **(machine.get("metadata") or {})}
        self.machine = machine

    def build(
        self,
        X=None,
        y=None,
        index: Optional[Sequence] = None,
        output_dir=None,
        device: DeviceLike = None,
    ) -> Tuple[Any, Dict[str, Any]]:
        """
        (model, machine dict with ``metadata.build_metadata``), training
        on ``device`` (the card unless ``"cpu"``). With no X the data is
        fetched through the machine's dataset; otherwise X, y are the data
        and ``index`` their row labels (timestamps; row numbers when
        None). With ``output_dir`` the artifact is written there, as
        ``<collection>/<machine name>``.
        """
        device = resolve_device(device)  # no card, no work
        dataset_meta: Dict[str, Any] = {}
        fetch_secs = None
        if X is None:
            dataset = _get_dataset(self.machine["dataset"])
            start = time.perf_counter()
            X, y, stamps = dataset.get_data()
            fetch_secs = time.perf_counter() - start
            dataset_meta = dataset.get_metadata()
            index = to_datetimes(stamps.astype(np.int64))
            logger.info("Fetched %d rows in %.3f s", len(X), fetch_secs)
        X, y = as_2d(X, dtype=None), as_2d(y, dtype=None)
        index = list(range(len(X))) if index is None else list(index)
        dataset_build = {"query_duration_sec": fetch_secs, "dataset_meta": dataset_meta}
        evaluation = self.machine["evaluation"]
        cv_mode = str(evaluation["cv_mode"]).lower()
        if cv_mode not in _CV_MODES:
            raise ValueError(f"cv_mode {cv_mode!r} is not one of {_CV_MODES}")

        model = serializer.from_definition(self.machine["model"])
        _inject_seed(model, int(evaluation.get("seed", 0)))
        machine = copy.deepcopy(self.machine)

        cv_meta = copy.deepcopy(_EMPTY_CV)
        if cv_mode != "build_only":
            cv_meta = self._run_cross_validation(model, X, y, index, device)
        if cv_mode == "cross_val_only":
            machine["metadata"]["build_metadata"] = _build_metadata(cv_meta, dataset_build)
            return model, machine

        start = time.perf_counter()
        model.fit(X, y, device=device)
        fit_secs = time.perf_counter() - start
        module = fitted_estimator(model).spec_.module
        logger.info(
            "Fitted in %.3f s; model parameters on %s",
            fit_secs,
            next(module.parameters()).device,
        )
        machine["metadata"]["build_metadata"] = _build_metadata(
            cv_meta,
            dataset_build,
            model_offset=len(X) - len(model.predict(X)),
            model_creation_date=str(datetime.now(timezone.utc).astimezone()),
            model_training_duration_sec=fit_secs,
            model_meta=model.get_metadata(),
        )
        if output_dir is not None:
            serializer.dump(model, output_dir, machine)
        return model, machine

    def _run_cross_validation(self, model, X, y, index, device) -> Dict[str, Any]:
        """Cross-validate with per-tag and aggregate scorers and package the
        fold scores and splits: through the model's own ``cross_validate``
        (the anomaly detector derives its thresholds on the way), else
        :func:`~gordo_tpu_torch.models.utils.cross_validate`. A model with no
        ``predict`` cannot be scored: its CV metadata stays empty, as in
        the JAX builder."""
        if not hasattr(model, "predict"):
            logger.debug("Unable to score model; it has no 'predict' attribute")
            return copy.deepcopy(_EMPTY_CV)
        evaluation = self.machine["evaluation"]
        dataset = self.machine["dataset"]
        scorers = self.build_metrics_dict(
            self.metrics_from_list(evaluation.get("metrics")),
            tag_names(dataset["target_tag_list"]),
            y,
            _scoring_scaler(evaluation.get("scoring_scaler")),
        )
        splitter = _splitter(evaluation.get("cv", DEFAULT_CV))
        run = getattr(model, "cross_validate", None) or functools.partial(cross_validate, model)
        start = time.perf_counter()
        cv = run(X=X, y=y, cv=splitter, scoring=scorers, device=device)
        cv_secs = time.perf_counter() - start
        logger.info(
            "Cross-validated in %.3f s; fold fits %s s",
            cv_secs,
            ", ".join(f"{secs:.3f}" for secs in cv["fit_time"]),
        )
        return {
            "scores": {name: _fold_stats(cv[f"test_{name}"]) for name in scorers},
            "cv_duration_sec": cv_secs,
            "splits": self.build_split_dict(index, splitter),
        }

    @staticmethod
    def metrics_from_list(metric_list: Optional[List[str]] = None) -> List[Callable]:
        """Metric functions by name (a dotted path's last part, as in
        ``sklearn.metrics.r2_score``); the four defaults when None."""
        funcs = []
        for path in metric_list or DEFAULT_EVALUATION["metrics"]:
            name = path.rsplit(".", 1)[-1]
            if name not in METRICS:
                raise NotImplementedError(
                    f"metric {path!r} is not ported; available: {sorted(METRICS)}"
                )
            funcs.append(METRICS[name])
        return funcs

    @staticmethod
    def build_metrics_dict(
        metrics_list: List[Callable],
        tags: Sequence[str],
        y: np.ndarray,
        scaler: Optional[RobustScaling] = None,
    ) -> Dict[str, Callable]:
        """Per-tag (``{metric}-{tag}``) and aggregate (``{metric}``) scorers
        ``scorer(y_true, y_pred)``, each scaling both sides with ``scaler``
        fitted on all of y."""
        if scaler is not None:
            scaler.fit(y)

        def per_tag(metric, col):
            return lambda y_true, y_pred: metric(y_true[:, col], y_pred[:, col])

        scorers = {}
        for metric in metrics_list:
            metric_str = metric.__name__.replace("_", "-")
            for col, tag in enumerate(tags):
                scorers[f"{metric_str}-{str(tag).replace(' ', '-')}"] = metric_wrapper(
                    per_tag(metric, col), scaler=scaler
                )
            scorers[metric_str] = metric_wrapper(metric, scaler=scaler)
        return scorers

    @staticmethod
    def build_split_dict(index: Sequence, splitter: TimeSeriesSplit) -> Dict[str, Any]:
        """Each fold's train/test start and end labels and sizes."""
        splits: Dict[str, Any] = {}
        for i, (train, test) in enumerate(splitter.split(index), 1):
            splits.update(
                {
                    f"fold-{i}-train-start": index[train[0]],
                    f"fold-{i}-train-end": index[train[-1]],
                    f"fold-{i}-test-start": index[test[0]],
                    f"fold-{i}-test-end": index[test[-1]],
                    f"fold-{i}-n-train": len(train),
                    f"fold-{i}-n-test": len(test),
                }
            )
        return splits


def _fold_stats(fold_values: np.ndarray) -> Dict[str, float]:
    """Summary stats plus each fold's value for one scorer."""
    values = np.asarray(fold_values, dtype=np.float64)
    summary = {
        "fold-mean": float(values.mean()),
        "fold-std": float(values.std()),
        "fold-max": float(values.max()),
        "fold-min": float(values.min()),
    }
    summary.update({f"fold-{n}": float(v) for n, v in enumerate(values, 1)})
    return summary


def _build_metadata(
    cross_validation: Dict[str, Any],
    dataset: Dict[str, Any],
    model_offset: int = 0,
    model_creation_date: Optional[str] = None,
    model_training_duration_sec: Optional[float] = None,
    model_meta: Optional[dict] = None,
) -> Dict[str, Any]:
    """The JAX ``BuildMetadata.to_dict()`` layout. ``dataset`` holds the
    fetch's ``query_duration_sec`` and ``dataset_meta`` (None and empty
    when the caller handed the arrays in)."""
    return {
        "model": {
            "model_offset": model_offset,
            "model_creation_date": model_creation_date,
            "model_builder_version": __version__,
            "cross_validation": cross_validation,
            "model_training_duration_sec": model_training_duration_sec,
            "model_meta": model_meta or {},
        },
        "dataset": dataset,
    }
