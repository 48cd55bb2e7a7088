"""
Noisy-period filters (the port of ``gordo_tpu.data.filter_periods``), in
numpy.

``filter_method: "median"`` flags a row when any tag leaves the band of
its centred rolling median plus or minus ``n_iqr`` rolling
interquartile ranges over ``window`` rows (pandas' ``rolling(window,
center=True)``: no flag where the window does not fit). Flagged
timestamps are grouped into drop periods, a gap of more than the
dataset's resolution starting a new one, and every row inside a period
is dropped; the periods are written to the dataset's metadata as the
JAX dataset writes them (``{"median": [{"drop_start", "drop_end"}]}``,
timestamps as ``str`` of an aware UTC datetime).

``filter_method: "iforest"`` fits an isolation forest (``data/iforest.py``,
scikit-learn's forest drawn exactly: 300 trees, ``max_samples`` the
smaller of 1000 and the rows, ``contamination``, ``random_state`` 42)
on the rows, or on their exponentially weighted means
(``iforest_smooth``: pandas' ``ewm(halflife=6).mean()``), and flags the
rows it predicts as outliers; each row's score, the negated decision
function min-max scaled to [0, 1], goes with the flags. ``"all"`` runs
both filters, and a row inside any method's period is dropped.
"""

import logging
import time
from typing import Dict, List, Tuple

import numpy as np

from gordo_tpu_torch.data.base import to_datetimes
from gordo_tpu_torch.data.iforest import IsolationForest, ewm_mean
from gordo_tpu_torch.models.preprocessing import MinMaxScaler
from gordo_tpu_torch.utils.compat import frequency_to_ns

logger = logging.getLogger(__name__)


class WrongFilterMethodType(TypeError):
    pass


def _stamp(ns: int) -> str:
    """``str`` of a pandas UTC Timestamp at int nanoseconds."""
    return str(to_datetimes(np.array([ns]))[0])


def centred_rolling(values: np.ndarray, window: int, fn) -> np.ndarray:
    """``fn`` over each centred window of ``window`` rows, column by
    column (rows i - window//2 .. i + (window-1)//2); NaN where the window
    does not fit, as pandas' ``rolling(window, center=True)``."""
    values = np.asarray(values, dtype=np.float64)
    out = np.full(values.shape, np.nan)
    n = len(values)
    if n >= window:
        windows = np.lib.stride_tricks.sliding_window_view(values, window, axis=0)
        first = window // 2
        out[first : first + n - window + 1] = fn(windows)
    return out


class FilterPeriods:
    def __init__(
        self,
        granularity: str,
        filter_method: str = "median",
        window: int = 144,
        n_iqr: int = 5,
        iforest_smooth: bool = False,
        contamination: float = 0.03,
    ):
        if filter_method not in ("median", "iforest", "all"):
            raise WrongFilterMethodType(
                f"filter_method must be 'median', 'iforest' or 'all', got {filter_method!r}"
            )
        self.granularity_ns = frequency_to_ns(granularity)
        self.filter_method = filter_method
        self._window = int(window)
        self._n_iqr = n_iqr
        self._iforest_smooth = iforest_smooth
        self._contamination = contamination

    def _rolling_median(self, values: np.ndarray) -> np.ndarray:
        """Each row's outlier flag."""
        median = centred_rolling(values, self._window, lambda w: np.median(w, axis=-1))
        q75 = centred_rolling(values, self._window, lambda w: np.quantile(w, 0.75, axis=-1))
        q25 = centred_rolling(values, self._window, lambda w: np.quantile(w, 0.25, axis=-1))
        iqr = q75 - q25
        high = median + self._n_iqr * iqr
        low = median - self._n_iqr * iqr
        with np.errstate(invalid="ignore"):
            return ((values < low) | (values > high)).any(axis=1)

    def _train(self, values: np.ndarray) -> None:
        t0 = time.perf_counter()
        fit_data = ewm_mean(values, halflife=6) if self._iforest_smooth else values
        self.isolationforest = IsolationForest(
            n_estimators=300,
            max_samples=min(1000, len(fit_data)),
            contamination=self._contamination,
            random_state=42,
        )
        self.model = self.isolationforest.fit(fit_data)
        self.fit_seconds_ = time.perf_counter() - t0

    def _predict(self, values: np.ndarray) -> np.ndarray:
        """Each row's outlier flag; the rows' scaled scores are kept as
        ``iforest_scores_``."""
        t0 = time.perf_counter()
        score = -self.model.decision_function(values)
        self.iforest_scores_ = MinMaxScaler().fit(score.reshape(-1, 1)).transform(
            score.reshape(-1, 1)).squeeze()
        flags = self.model.predict(values) == -1
        self.score_seconds_ = time.perf_counter() - t0
        logger.info("Isolation forest: fit %.3f s (%d samples of %d rows), scored %d rows "
                    "in %.3f s", self.fit_seconds_, self.model.max_samples_, len(values),
                    len(values), self.score_seconds_)
        return flags

    def filter_data(
        self, values: np.ndarray, index: np.ndarray
    ) -> Tuple[np.ndarray, Dict[str, List[dict]], Dict[str, np.ndarray]]:
        """(rows kept, drop periods by method, each method's flags) for a
        (rows, tags) table whose rows are at int64 UTC ns ``index``."""
        index = np.asarray(index, dtype=np.int64)
        flags = {}
        if self.filter_method in ("median", "all"):
            flags["median"] = self._rolling_median(values)
        if self.filter_method in ("iforest", "all"):
            self._train(values)
            flags["iforest"] = self._predict(values)
        bounds = {method: _period_bounds(index[flag], self.granularity_ns)
                  for method, flag in flags.items()}
        periods = {
            method: [{"drop_start": _stamp(lo), "drop_end": _stamp(hi)} for lo, hi in runs]
            for method, runs in bounds.items()
        }
        keep = np.ones(len(index), dtype=bool)
        for runs in bounds.values():
            for lo, hi in runs:
                keep &= ~((index >= lo) & (index <= hi))
        if keep.all():
            logger.info("No rows dropped")
        else:
            logger.info("Dropped %d rows", int((~keep).sum()))
        return keep, periods, flags


def _period_bounds(flagged: np.ndarray, gap_ns: int) -> List[Tuple[int, int]]:
    """The (first, last) ns of each drop period: flagged timestamps (sorted)
    grouped into runs, a gap of more than ``gap_ns`` starting a new one."""
    if not len(flagged):
        return []
    breaks = np.flatnonzero(np.diff(flagged) > gap_ns)
    starts = np.concatenate([[0], breaks + 1])
    ends = np.concatenate([breaks, [len(flagged) - 1]])
    return [(int(flagged[s]), int(flagged[e])) for s, e in zip(starts, ends)]
