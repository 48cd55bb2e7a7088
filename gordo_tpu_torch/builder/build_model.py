"""
ModelBuilder: the train-one-machine pipeline (the port of
``gordo_tpu.builder.build_model``).

A machine is a :class:`~gordo_tpu_torch.machine.Machine`, or a dict that
``Machine.from_dict`` turns into one. Its evaluation is read as the JAX
builder reads it: ``scoring_scaler`` (None: unscaled scores),
``metrics`` (None: the four defaults), ``cv`` (default
``TimeSeriesSplit(n_splits=3)``) and ``seed`` (0); the builder merges no
defaults of its own, so a machine built without project globals scores
as the JAX ``build`` scores it.

The evaluation takes what the JAX builder takes from the ported
scikit-learn pieces: ``cv`` any of ``TimeSeriesSplit``, ``KFold`` and
``ShuffleSplit`` with their arguments; ``scoring_scaler`` any of the four
scalers of :mod:`gordo_tpu_torch.models.preprocessing`, with its
arguments; ``metrics`` any of the ten of
:data:`gordo_tpu_torch.models.utils.METRICS`. Anything else raises
``NotImplementedError`` naming what is ported. A scorer that raises on a
fold (``max_error`` on several outputs) scores NaN there, as
scikit-learn's ``cross_validate`` records it for the JAX builder.

``build`` fetches the machine's dataset through the port's data layer,
as the JAX builder does, or takes X, y and their time index as arrays.
From there it does what the JAX builder does: seed numpy's and Python's
global generators with the evaluation seed (a shuffling splitter with no
``random_state`` draws from numpy's), inject that seed into every
estimator, cross-validate with per-tag and aggregate scorers (the
anomaly detector derives its thresholds on the way), record the fold
scores and splits, fit on all the data, measure the model's output
offset, assemble the build metadata, and write the port's artifact with
``Machine.to_dict()`` as its metadata, which the port's server serves.

With ``model_register_dir`` the build is cached as the JAX builder
caches it (:mod:`gordo_tpu_torch.utils.disk_registry`): the key is the
sha3-512 of the machine's name, model, dataset and evaluation and the
port's own package name and version (``cache_key``), so a register shared
with JAX builds never hands one package the other's artifact. A hit loads
the stored artifact and its metadata, with this request's user metadata
and runtime, and trains nothing.
"""

import functools
import hashlib
import json
import logging
import random
import time
from datetime import datetime, timezone
from pathlib import Path
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

from gordo_tpu_torch import __version__, serializer
from gordo_tpu_torch.data import _get_dataset
from gordo_tpu_torch.data.base import to_datetimes
from gordo_tpu_torch.device import DeviceLike, resolve_device
from gordo_tpu_torch.machine import Machine
from gordo_tpu_torch.machine.metadata import (
    BuildMetadata,
    CrossValidationMetaData,
    DatasetBuildMetadata,
    ModelBuildMetadata,
)
from gordo_tpu_torch.models.core import BaseTorchEstimator, as_2d
from gordo_tpu_torch.models.pipeline import Pipeline
from gordo_tpu_torch.models.preprocessing import scaler_from_definition
from gordo_tpu_torch.models.utils import (
    DEFAULT_METRICS,
    METRICS,
    cross_validate,
    metric_wrapper,
    splitter_from_definition,
)
from gordo_tpu_torch.utils import disk_registry

logger = logging.getLogger(__name__)

DEFAULT_CV = {"sklearn.model_selection.TimeSeriesSplit": {"n_splits": 3}}
_CV_MODES = ("full_build", "cross_val_only", "build_only")


#: the port's name in the cache key's version fields, where the JAX
#: builder writes ``gordo-tpu``
_CACHE_PACKAGE = "gordo-tpu-torch"


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
    def __init__(self, machine: Union[Machine, Mapping[str, Any]]):
        if not isinstance(machine, Machine):
            machine = Machine.from_dict(dict(machine))
        # a copy, so the caller's machine never changes
        self.machine = Machine.unvalidated(**machine.to_dict())

    def build(
        self,
        X=None,
        y=None,
        index: Optional[Sequence] = None,
        output_dir=None,
        device: DeviceLike = None,
        model_register_dir=None,
        replace_cache: bool = False,
    ) -> Tuple[Any, Machine]:
        """
        (model, a copy of the machine with ``metadata.build_metadata``),
        training on ``device`` (the card unless ``"cpu"``). With no X the
        data is fetched through the machine's dataset; otherwise X, y are
        the data and ``index`` their row labels (timestamps; row numbers
        when None). With ``output_dir`` the artifact is written there, as
        ``<collection>/<machine name>``. With ``model_register_dir`` (only
        for a build that fetches its own data) the build goes through the
        cache (module docstring); ``replace_cache`` drops this machine's
        entry first.
        """
        device = resolve_device(device)  # no card, no work
        self.cached_model_path, cached = None, None
        if model_register_dir:
            if X is not None:
                raise ValueError(
                    "model_register_dir caches builds of the machine's own dataset; "
                    "a build given X and y cannot be keyed"
                )
            if replace_cache:
                logger.info("replace_cache=True, deleting any existing cache entry")
                disk_registry.delete_value(model_register_dir, self.cache_key)
            else:
                self.cached_model_path = self.check_cache(model_register_dir)
                cached = self._restore_cached(model_register_dir, device)
        model, machine = cached or self._build(X, y, index, device)
        # a cross_val_only model is unfitted: never written, never cached
        cv_only = str(self.machine.evaluation.get("cv_mode", "")).lower() == "cross_val_only"
        if output_dir is not None and not cv_only and str(self.cached_model_path) != str(
                output_dir):
            serializer.dump(model, output_dir, machine.to_dict())
            if model_register_dir and cached is None:
                logger.info("Built model, deposited at %s", output_dir)
                disk_registry.write_key(model_register_dir, self.cache_key, str(output_dir))
            self.cached_model_path = str(output_dir)
        return model, machine

    def _restore_cached(self, model_register_dir, device) -> Optional[Tuple[Any, Machine]]:
        """(model, machine) from a cache hit, with this request's user
        metadata and runtime grafted onto the stored build metadata; a hit
        whose artifact has no metadata is dropped from the cache."""
        if not self.cached_model_path:
            return None
        stored = serializer.load_metadata(self.cached_model_path)
        if "metadata" not in stored:
            logger.warning("Cached artifact at %s has no metadata; rebuilding",
                           self.cached_model_path)
            disk_registry.delete_value(model_register_dir, self.cache_key)
            self.cached_model_path = None
            return None
        stored["metadata"]["user_defined"] = self.machine.metadata.user_defined
        stored["runtime"] = self.machine.runtime
        logger.info("Cache hit: %s", self.cached_model_path)
        return serializer.load(self.cached_model_path, device), Machine.unvalidated(**stored)

    @property
    def cache_key(self) -> str:
        return self.calculate_cache_key(self.machine)

    @staticmethod
    def calculate_cache_key(machine: Machine) -> str:
        """The content hash of "the same build": the JAX builder's
        fingerprint fields, with the port's package name in the version
        fields; runtime and metadata do not change the model, so they are
        left out."""
        major, minor = (int(part) for part in __version__.split(".")[:2])
        fingerprint = {
            "name": machine.name,
            "model_config": machine.model,
            "data_config": machine.dataset.to_dict(),
            "evaluation_config": machine.evaluation,
            f"{_CACHE_PACKAGE}-major-version": major,
            f"{_CACHE_PACKAGE}-minor-version": minor,
        }
        payload = json.dumps(fingerprint, sort_keys=True, default=str)
        return hashlib.sha3_512(payload.encode("ascii")).hexdigest()

    def check_cache(self, model_register_dir) -> Optional[str]:
        """The cached artifact's path for this build, if there is one."""
        existing = disk_registry.get_value(model_register_dir, self.cache_key)
        if existing and Path(existing).exists():
            logger.debug("Found existing model at %s", existing)
            return existing
        if existing:
            logger.warning("Registry entry %s points at a missing path %s",
                           self.cache_key, existing)
        return None

    def _build(self, X, y, index, device) -> Tuple[Any, Machine]:
        seed = int(self.machine.evaluation.get("seed", 0))
        np.random.seed(seed)
        random.seed(seed)
        dataset_build = DatasetBuildMetadata()
        targets = [tag.name for tag in self.machine.dataset.target_tag_list]
        if X is None:
            dataset = _get_dataset(self.machine.dataset.to_dict())
            start = time.perf_counter()
            X, y, stamps = dataset.get_data()
            # one column a tag and aggregation method: the JAX frame's names
            targets = dataset.target_columns
            dataset_build.query_duration_sec = time.perf_counter() - start
            dataset_build.dataset_meta = dataset.get_metadata()
            index = to_datetimes(stamps.astype(np.int64))
            logger.info("Fetched %d rows in %.3f s", len(X), dataset_build.query_duration_sec)
        X, y = as_2d(X, dtype=None), as_2d(y, dtype=None)
        index = list(range(len(X))) if index is None else list(index)
        evaluation = self.machine.evaluation
        cv_mode = str(evaluation.get("cv_mode", "full_build")).lower()
        if cv_mode not in _CV_MODES:
            raise ValueError(f"cv_mode {cv_mode!r} is not one of {_CV_MODES}")

        model = serializer.from_definition(self.machine.model)
        _inject_seed(model, seed)
        machine = Machine.unvalidated(**self.machine.to_dict())

        cv_meta = CrossValidationMetaData()
        if cv_mode != "build_only":
            cv_meta = self._run_cross_validation(model, X, y, index, device, targets)
        if cv_mode == "cross_val_only":
            machine.metadata.build_metadata = BuildMetadata(
                model=ModelBuildMetadata(cross_validation=cv_meta), dataset=dataset_build
            )
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
        machine.metadata.build_metadata = BuildMetadata(
            model=ModelBuildMetadata(
                model_offset=len(X) - len(model.predict(X)),
                model_creation_date=str(datetime.now(timezone.utc).astimezone()),
                model_builder_version=__version__,
                cross_validation=cv_meta,
                model_training_duration_sec=fit_secs,
                model_meta=model.get_metadata(),
            ),
            dataset=dataset_build,
        )
        return model, machine

    def _run_cross_validation(
        self, model, X, y, index, device, targets: Optional[Sequence[str]] = None
    ) -> CrossValidationMetaData:
        """Cross-validate with per-tag and aggregate scorers and package the
        fold scores and splits: through the model's own ``cross_validate``
        (the anomaly detector derives its thresholds on the way), else
        :func:`~gordo_tpu_torch.models.utils.cross_validate`. ``targets``
        names y's columns (default: the target tags). A model with no
        ``predict`` cannot be scored: its CV metadata stays empty, as in
        the JAX builder."""
        if not hasattr(model, "predict"):
            logger.debug("Unable to score model; it has no 'predict' attribute")
            return CrossValidationMetaData()
        evaluation = self.machine.evaluation
        scorers = self.build_metrics_dict(
            self.metrics_from_list(evaluation.get("metrics")),
            targets or [tag.name for tag in self.machine.dataset.target_tag_list],
            y,
            evaluation.get("scoring_scaler"),
        )
        splitter = splitter_from_definition(evaluation.get("cv", DEFAULT_CV))
        run = getattr(model, "cross_validate", None) or functools.partial(cross_validate, model)
        start = time.perf_counter()
        cv = run(X=X, y=y, cv=splitter, scoring=scorers, device=device)
        cv_secs = time.perf_counter() - start
        logger.info(
            "Cross-validated in %.3f s; fold fits %s s",
            cv_secs,
            ", ".join(f"{secs:.3f}" for secs in cv["fit_time"]),
        )
        return CrossValidationMetaData(
            scores={name: _fold_stats(cv[f"test_{name}"]) for name in scorers},
            cv_duration_sec=cv_secs,
            splits=self.build_split_dict(index, splitter),
        )

    @staticmethod
    def metrics_from_list(metric_list: Optional[List[str]] = None) -> List[Callable]:
        """Metric functions by name (a dotted path's last part, as in
        ``sklearn.metrics.r2_score``); the four defaults when None."""
        funcs = []
        for path in metric_list or DEFAULT_METRICS:
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
        scaler=None,
    ) -> Dict[str, Callable]:
        """Per-tag (``{metric}-{tag}``) and aggregate (``{metric}``) scorers
        ``scorer(y_true, y_pred)``, each scaling both sides with ``scaler``
        (a scaler or its definition) fitted on all of y."""
        if scaler:
            scaler = scaler_from_definition(scaler)
            scaler.fit(np.asarray(y))

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
    def build_split_dict(index: Sequence, splitter) -> Dict[str, Any]:
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
