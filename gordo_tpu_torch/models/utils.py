"""
Model-layer helpers (the port of ``gordo_tpu.models.utils``), without
pandas or scikit-learn: a flat :class:`Frame` for request data and a
:class:`BlockFrame` for the output frame, whose top-level blocks are the
JAX package's two-level column groups (``start``, ``model-input``, ...);
``metric_wrapper``; and, in numpy, the scikit-learn pieces the builder's
evaluation uses: ten regression metrics (scikit-learn 1.9's, each with
its ``multioutput="uniform_average"`` default), the splitters
``TimeSeriesSplit``, ``KFold`` and ``ShuffleSplit`` (their shuffles drawn
from ``np.random.RandomState`` as scikit-learn draws them, so the index
arrays are scikit-learn's) and ``cross_validate``.
"""

import dataclasses
import functools
import logging
import math
import numbers
import time
from datetime import datetime, timedelta
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class Frame:
    """A flat table: (rows, columns) values, column names, row labels."""

    values: np.ndarray
    columns: List[str]
    index: list


class BlockFrame:
    """
    Row-aligned blocks under top-level names, in insertion order; each
    block is (sub-column labels, (rows, labels) array). A single column
    (``start``, ``total-anomaly-scaled``) is a block whose one label is
    its own name, as the JAX server's JSON shows it.
    """

    def __init__(self, index: Sequence):
        self.index = list(index)
        self.blocks: Dict[str, Tuple[List[str], np.ndarray]] = {}

    def __len__(self) -> int:
        return len(self.index)

    def __getitem__(self, top: str) -> np.ndarray:
        return self.blocks[top][1]

    def labels(self, top: str) -> List[str]:
        return self.blocks[top][0]

    def add(self, top: str, labels: Iterable[str], values: np.ndarray) -> None:
        labels = list(labels)
        values = np.asarray(values)
        if values.ndim == 1:
            values = values[:, None]
        if values.shape != (len(self.index), len(labels)):
            raise ValueError(
                f"block {top!r} has shape {values.shape}, expected "
                f"({len(self.index)}, {len(labels)})"
            )
        self.blocks[top] = (labels, values)

    def add_column(self, top: str, values: np.ndarray) -> None:
        self.add(top, [top], values)


def make_base_dataframe(
    tags: Sequence[str],
    model_input: np.ndarray,
    model_output: np.ndarray,
    target_tag_list: Optional[Sequence[str]] = None,
    index: Optional[Sequence] = None,
    frequency: Optional[timedelta] = None,
) -> BlockFrame:
    """
    The canonical output frame with top-level blocks ``start``/``end``/
    ``model-input``/``model-output``, input and index aligned to the
    (possibly shorter, offset) model output.
    """
    out = np.asarray(getattr(model_output, "values", model_output))
    n_rows = len(out)
    inp = np.asarray(getattr(model_input, "values", model_input))[-n_rows:, :]
    idx = list(index)[-n_rows:] if index is not None else list(range(n_rows))

    # start/end timestamp columns: ISO strings on a datetime index, else None
    starts = np.full(n_rows, None, dtype=object)
    ends = np.full(n_rows, None, dtype=object)
    if n_rows and all(isinstance(stamp, datetime) for stamp in idx):
        starts[:] = [stamp.isoformat() for stamp in idx]
        if frequency is not None:
            ends[:] = [(stamp + frequency).isoformat() for stamp in idx]

    frame = BlockFrame(idx)
    frame.add_column("start", starts)
    frame.add_column("end", ends)
    owners = target_tag_list if target_tag_list is not None else tags
    for top_level, values, names in (
        ("model-input", inp, tags),
        ("model-output", out, owners),
    ):
        frame.add(top_level, _second_level_labels(names, values.shape[1]), values)
    return frame


def _second_level_labels(tags: Sequence[str], width: int) -> List[str]:
    """Tag names when the block width matches the tag list, else ordinals."""
    if width == len(tags):
        return [str(tag) for tag in tags]
    return [str(i) for i in range(width)]


def metric_wrapper(metric: Callable, scaler=None) -> Callable:
    """
    Adapt a metric to models whose output is shorter than the target
    (window offset), optionally scaling y and the prediction first with a
    fitted scaler's ``transform``.
    """

    @functools.wraps(metric)
    def _wrapper(y_true, y_pred, *args, **kwargs):
        if scaler:
            y_true = scaler.transform(np.asarray(y_true))
            y_pred = scaler.transform(np.asarray(y_pred))
        return metric(y_true[-len(y_pred):], y_pred, *args, **kwargs)

    return _wrapper


def _columns(y_true, y_pred) -> Tuple[np.ndarray, np.ndarray]:
    """Both as (rows, outputs) float64 arrays of one shape."""
    y_true = np.asarray(y_true, dtype=np.float64)
    y_pred = np.asarray(y_pred, dtype=np.float64)
    if y_true.ndim == 1:
        y_true = y_true.reshape(-1, 1)
    if y_pred.ndim == 1:
        y_pred = y_pred.reshape(-1, 1)
    if y_true.shape != y_pred.shape:
        raise ValueError(f"y_true {y_true.shape} and y_pred {y_pred.shape} differ")
    return y_true, y_pred


def _finite_ratio_score(numerator: np.ndarray, denominator: np.ndarray) -> float:
    """``1 - numerator / denominator`` per output, 1 where both are 0 and 0
    where only the denominator is (scikit-learn's ``force_finite``),
    averaged over the outputs."""
    scores = np.ones(len(numerator))
    valid = (numerator != 0) & (denominator != 0)
    scores[valid] = 1.0 - numerator[valid] / denominator[valid]
    scores[(numerator != 0) & (denominator == 0)] = 0.0
    return float(np.mean(scores))


def explained_variance_score(y_true, y_pred) -> float:
    y_true, y_pred = _columns(y_true, y_pred)
    diff = y_true - y_pred
    numerator = np.mean((diff - diff.mean(axis=0)) ** 2, axis=0)
    denominator = np.mean((y_true - y_true.mean(axis=0)) ** 2, axis=0)
    return _finite_ratio_score(numerator, denominator)


def r2_score(y_true, y_pred) -> float:
    y_true, y_pred = _columns(y_true, y_pred)
    numerator = np.sum((y_true - y_pred) ** 2, axis=0)
    denominator = np.sum((y_true - y_true.mean(axis=0)) ** 2, axis=0)
    return _finite_ratio_score(numerator, denominator)


def mean_squared_error(y_true, y_pred) -> float:
    y_true, y_pred = _columns(y_true, y_pred)
    return float(np.mean(np.mean((y_true - y_pred) ** 2, axis=0)))


def mean_absolute_error(y_true, y_pred) -> float:
    y_true, y_pred = _columns(y_true, y_pred)
    return float(np.mean(np.mean(np.abs(y_pred - y_true), axis=0)))


def median_absolute_error(y_true, y_pred) -> float:
    y_true, y_pred = _columns(y_true, y_pred)
    return float(np.mean(np.median(np.abs(y_pred - y_true), axis=0)))


def max_error(y_true, y_pred) -> float:
    """The largest absolute error; like scikit-learn's, it refuses more
    than one output."""
    y_true, y_pred = _columns(y_true, y_pred)
    if y_true.shape[1] > 1:
        raise ValueError("Multioutput not supported in max_error")
    return float(np.max(np.abs(y_true - y_pred)))


def mean_absolute_percentage_error(y_true, y_pred) -> float:
    y_true, y_pred = _columns(y_true, y_pred)
    mape = np.abs(y_pred - y_true) / np.maximum(np.abs(y_true), np.finfo(np.float64).eps)
    return float(np.mean(np.mean(mape, axis=0)))


def root_mean_squared_error(y_true, y_pred) -> float:
    y_true, y_pred = _columns(y_true, y_pred)
    return float(np.mean(np.sqrt(np.mean((y_true - y_pred) ** 2, axis=0))))


def _log1p_columns(y_true, y_pred, name: str) -> Tuple[np.ndarray, np.ndarray]:
    y_true, y_pred = _columns(y_true, y_pred)
    if np.any(y_true <= -1) or np.any(y_pred <= -1):
        raise ValueError(
            f"{name} cannot be used when targets contain values less than or equal to -1."
        )
    return np.log1p(y_true), np.log1p(y_pred)


def mean_squared_log_error(y_true, y_pred) -> float:
    return mean_squared_error(
        *_log1p_columns(y_true, y_pred, "Mean Squared Logarithmic Error")
    )


def root_mean_squared_log_error(y_true, y_pred) -> float:
    return root_mean_squared_error(
        *_log1p_columns(y_true, y_pred, "Root Mean Squared Logarithmic Error")
    )


#: the metrics an evaluation config may name (scikit-learn's names)
METRICS = {
    fn.__name__: fn
    for fn in (
        explained_variance_score,
        r2_score,
        mean_squared_error,
        mean_absolute_error,
        median_absolute_error,
        max_error,
        mean_absolute_percentage_error,
        mean_squared_log_error,
        root_mean_squared_error,
        root_mean_squared_log_error,
    )
}
#: the four a machine without ``metrics`` is scored with
DEFAULT_METRICS = ("explained_variance_score", "r2_score", "mean_squared_error",
                   "mean_absolute_error")


def _random_state(seed) -> np.random.RandomState:
    """scikit-learn's ``check_random_state``: None is numpy's global
    RandomState, an int seeds a new one, a RandomState passes through."""
    if seed is None:
        return np.random.mtrand._rand
    if isinstance(seed, numbers.Integral):
        return np.random.RandomState(seed)
    if isinstance(seed, np.random.RandomState):
        return seed
    raise ValueError(f"{seed!r} cannot be used to seed a numpy.random.RandomState instance")


class TimeSeriesSplit:
    """
    scikit-learn's ``TimeSeriesSplit``: ``n_splits`` folds whose test sets
    are consecutive blocks of ``test_size`` rows (default
    ``n_samples // (n_splits + 1)``) at the end, each trained on
    everything before it (less ``gap`` rows, at most ``max_train_size``).
    """

    def __init__(
        self,
        n_splits: int = 5,
        *,
        max_train_size: Optional[int] = None,
        test_size: Optional[int] = None,
        gap: int = 0,
    ):
        self.n_splits = n_splits
        self.max_train_size = max_train_size
        self.test_size = test_size
        self.gap = gap

    def split(self, X, y=None) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        n_samples = len(X)
        n_folds = self.n_splits + 1
        test_size = self.test_size if self.test_size is not None else n_samples // n_folds
        if n_folds > n_samples:
            raise ValueError(
                f"Cannot have number of folds={n_folds} greater than the "
                f"number of samples={n_samples}."
            )
        if n_samples - self.gap - test_size * self.n_splits <= 0:
            raise ValueError(
                f"Too many splits={self.n_splits} for number of samples="
                f"{n_samples} with test_size={test_size} and gap={self.gap}."
            )
        indices = np.arange(n_samples)
        for test_start in range(n_samples - self.n_splits * test_size, n_samples, test_size):
            train_end = test_start - self.gap
            train_start = 0
            if self.max_train_size and self.max_train_size < train_end:
                train_start = train_end - self.max_train_size
            yield (
                indices[train_start:train_end],
                indices[test_start : test_start + test_size],
            )


class KFold:
    """
    scikit-learn's ``KFold``: ``n_splits`` consecutive test folds (the
    first ``n_samples % n_splits`` one row larger), each trained on every
    other row; with ``shuffle`` the rows are first shuffled by
    ``RandomState(random_state).shuffle``. Train and test indices come
    out sorted, as scikit-learn's do.
    """

    def __init__(self, n_splits: int = 5, *, shuffle: bool = False, random_state=None):
        if not isinstance(n_splits, numbers.Integral) or n_splits <= 1:
            raise ValueError(
                "k-fold cross-validation requires at least one train/test split by "
                f"setting n_splits=2 or more, got n_splits={n_splits}."
            )
        if not shuffle and random_state is not None:
            raise ValueError(
                "Setting a random_state has no effect since shuffle is False. You should "
                "leave random_state to its default (None), or set shuffle=True."
            )
        self.n_splits = int(n_splits)
        self.shuffle = bool(shuffle)
        self.random_state = random_state

    def split(self, X, y=None) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        n_samples = len(X)
        if self.n_splits > n_samples:
            raise ValueError(
                f"Cannot have number of splits n_splits={self.n_splits} greater than the "
                f"number of samples: n_samples={n_samples}."
            )
        indices = np.arange(n_samples)
        order = indices.copy()
        if self.shuffle:
            _random_state(self.random_state).shuffle(order)
        fold_sizes = np.full(self.n_splits, n_samples // self.n_splits, dtype=int)
        fold_sizes[: n_samples % self.n_splits] += 1
        current = 0
        for fold_size in fold_sizes:
            test_mask = np.zeros(n_samples, dtype=bool)
            test_mask[order[current : current + fold_size]] = True
            current += fold_size
            yield indices[~test_mask], indices[test_mask]


class ShuffleSplit:
    """
    scikit-learn's ``ShuffleSplit``: ``n_splits`` random splits, each the
    first ``n_test`` rows of ``RandomState(random_state).permutation``
    for testing and the next ``n_train`` for training, in permutation
    order (``test_size``/``train_size`` as fractions or counts; a test
    fraction of 0.1 when neither is given).
    """

    def __init__(self, n_splits: int = 10, *, test_size=None, train_size=None, random_state=None):
        self.n_splits = int(n_splits)
        self.test_size = test_size
        self.train_size = train_size
        self.random_state = random_state

    def _sizes(self, n_samples: int) -> Tuple[int, int]:
        """scikit-learn's ``_validate_shuffle_split``."""
        test_size, train_size = self.test_size, self.train_size
        if test_size is None and train_size is None:
            test_size = 0.1
        kinds = [np.asarray(v).dtype.kind for v in (test_size, train_size)]
        for name, value, kind in (("test_size", test_size, kinds[0]),
                                  ("train_size", train_size, kinds[1])):
            if (kind == "i" and (value >= n_samples or value <= 0)) or (
                kind == "f" and (value <= 0 or value >= 1)
            ):
                raise ValueError(
                    f"{name}={value} should be either positive and smaller than the number "
                    f"of samples {n_samples} or a float in the (0, 1) range"
                )
        if train_size is not None and kinds[1] not in ("i", "f"):
            raise ValueError(f"Invalid value for train_size: {train_size}")
        if kinds == ["f", "f"] and train_size + test_size > 1:
            raise ValueError(
                f"The sum of test_size and train_size = {train_size + test_size}, should be in "
                "the (0, 1) range. Reduce test_size and/or train_size."
            )
        n_test = n_train = None
        if kinds[0] == "f":
            n_test = math.ceil(test_size * n_samples)
        elif kinds[0] == "i":
            n_test = float(test_size)
        if kinds[1] == "f":
            n_train = math.floor(train_size * n_samples)
        elif kinds[1] == "i":
            n_train = float(train_size)
        if train_size is None:
            n_train = n_samples - n_test
        elif test_size is None:
            n_test = n_samples - n_train
        if n_train + n_test > n_samples:
            raise ValueError(
                f"The sum of train_size and test_size = {n_train + n_test}, should be smaller "
                f"than the number of samples {n_samples}. Reduce test_size and/or train_size."
            )
        n_train, n_test = int(n_train), int(n_test)
        if n_train == 0:
            raise ValueError(
                f"With n_samples={n_samples}, test_size={test_size} and train_size="
                f"{train_size}, the resulting train set will be empty. Adjust any of the "
                "aforementioned parameters."
            )
        return n_train, n_test

    def split(self, X, y=None) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        n_samples = len(X)
        n_train, n_test = self._sizes(n_samples)
        rng = _random_state(self.random_state)
        for _ in range(self.n_splits):
            permutation = rng.permutation(n_samples)
            yield permutation[n_test : n_test + n_train], permutation[:n_test]


#: the splitters an evaluation's ``cv`` may name, by class name
SPLITTERS = {cls.__name__: cls for cls in (TimeSeriesSplit, KFold, ShuffleSplit)}


def splitter_from_definition(definition):
    """``"sklearn.model_selection.KFold"`` or ``{path: kwargs}`` -> the
    port's splitter (the class name decides); any other class raises
    ``NotImplementedError`` naming the ported ones."""
    if isinstance(definition, str):
        definition = {definition: {}}
    (path, kwargs), = definition.items()
    name = str(path).rsplit(".", 1)[-1]
    if name not in SPLITTERS:
        raise NotImplementedError(
            f"cv splitter {path!r} is not ported; the port has {sorted(SPLITTERS)}"
        )
    return SPLITTERS[name](**dict(kwargs or {}))


def score_or_nan(metric: Callable, y_true, y_pred) -> float:
    """``metric(y_true, y_pred)``, or NaN with a warning when it raises:
    scikit-learn's ``cross_validate`` (``error_score=np.nan``) records a
    failing scorer so, where the JAX builder runs it."""
    try:
        return metric(y_true, y_pred)
    except Exception as exc:  # noqa: BLE001 (any scorer failure, as scikit-learn)
        logger.warning("Scoring failed; the score on this fold is set to nan: %r", exc)
        return float("nan")


def cross_validate(
    estimator,
    X,
    y,
    cv=None,
    scoring: Optional[Dict[str, Callable]] = None,
    device: Any = None,
) -> dict:
    """
    scikit-learn's ``cross_validate(estimator, X, y, cv=cv, scoring=scoring,
    return_estimator=True)`` as the JAX builder calls it for a model with no
    ``cross_validate`` of its own. For each (train, test) split of ``cv``
    (``TimeSeriesSplit(3)`` by default) an unfitted clone of ``estimator``
    is fitted on the training rows on ``device``, predicts the test rows
    once, and every ``scoring`` metric (``metric(y_true, y_pred)``) scores
    that prediction; a windowed estimator predicts fewer rows, which
    :func:`metric_wrapper` aligns to the last test rows, as scikit-learn's
    scorers over the same wrapper do. Returns ``fit_time``, ``score_time``
    and ``test_<name>`` arrays (one entry a fold) and the fitted clones
    under ``estimator``.
    """
    X, y = np.asarray(X), np.asarray(y)
    cv = cv if cv is not None else TimeSeriesSplit(n_splits=3)
    scoring = scoring or {}
    output: Dict[str, list] = {"estimator": [], "fit_time": [], "score_time": []}
    output.update({f"test_{name}": [] for name in scoring})
    for train_idx, test_idx in cv.split(X, y):
        start = time.perf_counter()
        fitted = estimator.clone().fit(X[train_idx], y[train_idx], device=device)
        output["fit_time"].append(time.perf_counter() - start)
        start = time.perf_counter()
        y_pred = fitted.predict(X[test_idx])
        for name, metric in scoring.items():
            output[f"test_{name}"].append(score_or_nan(metric, y[test_idx], y_pred))
        output["score_time"].append(time.perf_counter() - start)
        output["estimator"].append(fitted)
    return {
        name: values if name == "estimator" else np.asarray(values, dtype=np.float64)
        for name, values in output.items()
    }
