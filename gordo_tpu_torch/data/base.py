"""
The dataset base and the resample/join engine (the port of
``gordo_tpu.data.base``) in numpy, reproducing what pandas does there.

A tag's raw data is a :class:`TagSeries`: int64 UTC nanosecond
timestamps and float64 values. Resampling one tag:

1. **Span pinning.** A NaN sentinel goes at the exact span start and end
   when the data starts later or ends earlier, so every tag's grid spans
   the same buckets (data outside the span is a provider fault).
2. **Buckets.** pandas' ``resample(res, label="left")``: bins closed on
   the left, counted from midnight (UTC) of the first timestamp's day
   (``origin="start_day"``), the last bin the one holding the last
   timestamp; each labelled by its left edge.
3. **Aggregation.** pandas' resample aggregations, skipping NaN:
   ``mean``, ``max``, ``min``, ``median``, ``std`` (``ddof`` 1), ``first``
   and ``last`` give NaN for an empty bucket (``std`` for a bucket of one
   value too), ``sum`` and ``count`` give 0. A list of methods widens the
   tag into one column a method, in the list's order, named as the JAX
   frame's flattened ``(tag, method)`` columns (``"('tag', 'max')"``);
   a single method keeps the tag's name. A callable raises: it waits in
   ROADMAP.md queue 1 item 7.
4. **Gap filling.** pandas' ``interpolate(limit=N)`` (linear over
   positions) or ``ffill(limit=N)``, forward, column by column: the first
   N NaNs of each run are filled (an interior run's on the line across
   the whole gap, a trailing run's with the last value) and leading NaNs
   stay NaN.
5. Buckets with a NaN left in any column are dropped.

Tags are then inner-joined on their common buckets.
"""

import abc
import dataclasses
import functools
from datetime import datetime, timedelta, timezone
from typing import Any, Dict, Iterable, List, Optional, Sequence, Union

import numpy as np

from gordo_tpu_torch.models.utils import Frame
from gordo_tpu_torch.utils.compat import frequency_to_ns

NS_PER_DAY = 86400 * 1_000_000_000
_EPOCH = datetime(1970, 1, 1, tzinfo=timezone.utc)


class InsufficientDataError(ValueError):
    pass


@dataclasses.dataclass
class TagSeries:
    """One tag's raw data: sorted int64 UTC nanosecond timestamps and
    float64 values; after a multi-method resample, (rows, methods) values
    named by ``columns``."""

    name: str
    index: np.ndarray
    values: np.ndarray
    columns: Optional[List[str]] = None

    def __len__(self) -> int:
        return len(self.index)


def to_ns(stamp: datetime) -> int:
    """An aware datetime as int UTC nanoseconds (microsecond precision)."""
    delta = stamp - _EPOCH
    return (delta.days * 86400 + delta.seconds) * 1_000_000_000 + delta.microseconds * 1000


def to_datetimes(index: np.ndarray) -> List[datetime]:
    """int64 UTC nanoseconds -> aware UTC datetimes (whole microseconds)."""
    return [_EPOCH + timedelta(microseconds=int(ns) // 1000) for ns in index]


def _span_aligned(series: TagSeries, start: int, end: int) -> TagSeries:
    """Plant NaN sentinels at the exact span ends the data falls short of;
    data outside the span raises."""
    if series.index[0] < start:
        raise RuntimeError(
            f"For {series.name}, first timestamp {series.index[0]} is before "
            f"the resampling start point {start}"
        )
    if series.index[-1] > end:
        raise RuntimeError(
            f"For {series.name}, last timestamp {series.index[-1]} is later "
            f"than the resampling end point {end}"
        )
    index, values = [series.index], [np.asarray(series.values, dtype=np.float64)]
    if series.index[0] > start:
        index.insert(0, np.array([start], dtype=np.int64))
        values.insert(0, np.array([np.nan]))
    if series.index[-1] < end:
        index.append(np.array([end], dtype=np.int64))
        values.append(np.array([np.nan]))
    return TagSeries(series.name, np.concatenate(index), np.concatenate(values))


#: the ported aggregation methods
AGGREGATIONS = ("mean", "max", "min", "median", "sum", "count", "std", "first", "last")


def _aggregate(method: str, bins: np.ndarray, values: np.ndarray, n_bins: int) -> np.ndarray:
    """One aggregation of each bin's values (NaN already dropped; bins
    non-decreasing, values in time order within a bin)."""
    counts = np.bincount(bins, minlength=n_bins)
    if method == "count":
        return counts.astype(np.float64)
    sums = np.bincount(bins, weights=values, minlength=n_bins)
    if method == "sum":
        return sums
    out = np.full(n_bins, np.nan)
    filled = counts > 0
    with np.errstate(invalid="ignore", divide="ignore"):
        if method == "mean":
            return np.where(filled, sums / counts, np.nan)
        if method == "std":
            mean = sums / np.maximum(counts, 1)
            ssq = np.bincount(bins, weights=(values - mean[bins]) ** 2, minlength=n_bins)
            many = counts > 1
            out[many] = np.sqrt(ssq[many] / (counts[many] - 1))
            return out
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])[filled]
    ends = starts + counts[filled]
    if method in ("max", "min"):
        reduce = np.maximum if method == "max" else np.minimum
        out[filled] = reduce.reduceat(values, starts) if len(values) else []
    elif method == "first":
        out[filled] = values[starts]
    elif method == "last":
        out[filled] = values[ends - 1]
    elif method == "median":
        ordered = values[np.lexsort((values, bins))]
        c = counts[filled]
        out[filled] = (ordered[starts + (c - 1) // 2] + ordered[starts + c // 2]) / 2
    return out


def checked_methods(aggregation_methods) -> List[str]:
    """The methods asked for, checked against the ported ones."""
    if callable(aggregation_methods):
        raise NotImplementedError(
            "A callable aggregation is not ported (ROADMAP.md queue 1 item 7); the port "
            f"takes {list(AGGREGATIONS)} or a list of them"
        )
    methods = [aggregation_methods] if isinstance(aggregation_methods, str) else list(
        aggregation_methods)
    for method in methods:
        if callable(method) or method not in AGGREGATIONS:
            raise NotImplementedError(
                f"Aggregation {method!r} is not ported (ROADMAP.md queue 1 item 7); the port "
                f"takes {list(AGGREGATIONS)} or a list of them"
            )
    return methods


def _bucketize(series: TagSeries, resolution_ns: int, methods: Sequence[str] = ("mean",)):
    """(bucket labels, (buckets, methods) aggregates): left-closed,
    left-labelled buckets of ``resolution_ns`` counted from midnight UTC
    of the first timestamp's day."""
    order = np.argsort(series.index, kind="stable")
    index, values = series.index[order], series.values[order]
    first, last = int(index[0]), int(index[-1])
    origin = first - first % NS_PER_DAY
    start = first - (first - origin) % resolution_ns
    last_offset = (last - origin) % resolution_ns
    stop = last + (resolution_ns - last_offset if last_offset else resolution_ns)
    n_bins = (stop - start) // resolution_ns
    bins = (index - start) // resolution_ns
    valid = ~np.isnan(values)
    aggregates = np.stack(
        [_aggregate(method, bins[valid], values[valid], n_bins) for method in methods], axis=1
    )
    labels = start + resolution_ns * np.arange(n_bins, dtype=np.int64)
    return labels, aggregates


def _fill_gaps(values: np.ndarray, method: str, limit: Optional[int]) -> np.ndarray:
    """pandas' ``interpolate(limit=limit)`` (linear over positions) or
    ``ffill(limit=limit)``, limit direction forward."""
    missing = np.isnan(values)
    if missing.all() or not missing.any():
        return values.copy()
    positions = np.arange(len(values))
    last_valid = np.maximum.accumulate(np.where(missing, -1, positions))
    filled = values.copy()
    if method == "linear_interpolation":
        filled[missing] = np.interp(positions[missing], positions[~missing], values[~missing])
    else:
        filled[missing] = values[last_valid[missing]]
    keep_missing = last_valid < 0  # leading NaNs
    if limit is not None:
        keep_missing |= missing & (positions - last_valid > limit)
    filled[keep_missing] = np.nan
    return filled


def _gap_fill_steps(interpolation_limit: Optional[str], resolution_ns: int) -> Optional[int]:
    """The interpolation limit in whole resolution steps (None: no limit)."""
    if interpolation_limit is None:
        return None
    steps = int(frequency_to_ns(interpolation_limit) / resolution_ns)
    if steps <= 0:
        raise ValueError("Interpolation limit must be larger than resolution")
    return steps


class GordoBaseDataset(abc.ABC):
    _metadata: Dict[Any, Any]
    #: the constructor's arguments (``capture_args``)
    _params: Dict[str, Any]

    @abc.abstractmethod
    def get_data(self):
        """(X, y, index) given the current state."""

    def to_dict(self) -> dict:
        """Every constructor argument, defaults included, and ``type``;
        an argument with a ``to_dict`` (the provider) as its dict. As the
        JAX dataset's ``to_dict``, so :meth:`from_dict` builds it again."""
        params = dict(self._params)
        params["type"] = type(self).__name__
        for key, value in params.items():
            if hasattr(value, "to_dict"):
                params[key] = value.to_dict()
        return params

    @classmethod
    def from_dict(cls, config: Dict[str, Any]) -> "GordoBaseDataset":
        from gordo_tpu_torch.data import _get_dataset

        return _get_dataset(config)

    @abc.abstractmethod
    def get_metadata(self) -> dict:
        """Metadata about the current state of the dataset."""

    def join_timeseries(
        self,
        series_iterable: Iterable[TagSeries],
        resampling_startpoint: datetime,
        resampling_endpoint: datetime,
        resolution: str,
        aggregation_methods: Union[str, List[str]] = "mean",
        interpolation_method: str = "linear_interpolation",
        interpolation_limit: Optional[str] = "8H",
    ) -> Frame:
        """
        Resample each series onto the common grid and inner-join them into
        one NaN-free :class:`Frame` (index: int64 UTC nanoseconds), with
        ``tag_loading_metadata`` recorded as the JAX dataset records it.
        """
        tag_meta: Dict[Any, Any] = {}
        self._metadata["tag_loading_metadata"] = tag_meta
        resampled: List[TagSeries] = []
        empty_tags: List[str] = []
        for series in series_iterable:
            tag_meta[series.name] = dict(original_length=len(series))
            if len(series) == 0:
                empty_tags.append(series.name)
                continue
            one = self._resample(
                series,
                resampling_startpoint=resampling_startpoint,
                resampling_endpoint=resampling_endpoint,
                resolution=resolution,
                aggregation_methods=aggregation_methods,
                interpolation_method=interpolation_method,
                interpolation_limit=interpolation_limit,
            )
            resampled.append(one)
            tag_meta[series.name]["resampled_length"] = len(one)
        if empty_tags:
            raise InsufficientDataError(
                f"The following features are missing data: {empty_tags}"
            )
        index = functools.reduce(np.intersect1d, (s.index for s in resampled))
        blocks = [
            s.values[np.searchsorted(s.index, index)].reshape(len(index), len(s.columns or [0]))
            for s in resampled
        ]
        values = np.concatenate(blocks, axis=1) if blocks else np.zeros((len(index), 0))
        columns = [name for s in resampled for name in (s.columns or [s.name])]
        tag_meta["aggregate_metadata"] = dict(
            joined_length=len(index), dropped_na_length=len(index)
        )
        return Frame(values, columns, index)

    @staticmethod
    def _resample(
        series: TagSeries,
        resampling_startpoint: datetime,
        resampling_endpoint: datetime,
        resolution: str,
        aggregation_methods: Union[str, List[str]] = "mean",
        interpolation_method: str = "linear_interpolation",
        interpolation_limit: Optional[str] = "8H",
    ) -> TagSeries:
        """One tag: span pinning, buckets, aggregation, bounded gap fill,
        then the buckets still NaN dropped."""
        if len(series) == 0:
            raise IndexError("Cannot resample an empty series")
        if interpolation_method not in ("linear_interpolation", "ffill"):
            raise ValueError(
                "Interpolation method should be either linear_interpolation or ffill"
            )
        methods = checked_methods(aggregation_methods)
        resolution_ns = frequency_to_ns(resolution)
        limit = _gap_fill_steps(interpolation_limit, resolution_ns)
        pinned = _span_aligned(
            series, to_ns(resampling_startpoint), to_ns(resampling_endpoint)
        )
        labels, aggregates = _bucketize(pinned, resolution_ns, methods)
        filled = np.stack(
            [_fill_gaps(column, interpolation_method, limit) for column in aggregates.T], axis=1
        )
        keep = ~np.isnan(filled).any(axis=1)
        if isinstance(aggregation_methods, str):
            return TagSeries(series.name, labels[keep], filled[keep, 0])
        return TagSeries(series.name, labels[keep], filled[keep],
                         [str((series.name, method)) for method in methods])
