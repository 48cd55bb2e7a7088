"""
Datasets (the port of ``gordo_tpu.data.datasets``).

``TimeSeriesDataset``: fetch the tags, resample and join them onto one
grid (with no ``resolution``, inner-join them on their raw timestamps, as
the JAX dataset's ``pd.concat(join="inner")`` does), then the configured
filters in the JAX dataset's order: the ``row_filter`` with its buffer
(``filter_rows``), the global bounds (rows strictly inside them) and the
noisy-period filter (``filter_periods``, its drop periods recorded as
``filtered_periods``); each must leave more than ``n_samples_threshold``
rows. X and y are then split by the tag lists, each tag's columns (one a
method under a multi-method aggregation) in the list's order, recording
the JAX dataset's metadata on the way, keyed by the columns' flattened
names (``target_columns`` names y's).
``RandomDataset`` always reads from the random provider.

``get_data`` returns ``(X, y, index)``: float64 arrays and the rows'
``datetime64[ns]`` UTC timestamps, where the JAX dataset returns frames.
"""

import json
from datetime import datetime
from functools import wraps
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from gordo_tpu_torch.data.base import (
    GordoBaseDataset,
    InsufficientDataError,
    TagSeries,
    checked_methods,
    to_datetimes,
)
from gordo_tpu_torch.data.filter_periods import FilterPeriods
from gordo_tpu_torch.data.filter_rows import filter_rows_mask
from gordo_tpu_torch.data.providers import (
    DataLakeProvider,
    GordoBaseDataProvider,
    RandomDataProvider,
)
from gordo_tpu_torch.data.sensor_tag import SensorTag, TagSpec, normalize_sensor_tags
from gordo_tpu_torch.machine.validators import ValidDatetime
from gordo_tpu_torch.models.utils import Frame
from gordo_tpu_torch.utils.utils import capture_args


class InsufficientDataAfterRowFilteringError(InsufficientDataError):
    pass


class InsufficientDataAfterGlobalFilteringError(InsufficientDataError):
    pass


# pre-1.0 config spellings still found in deployed configs
_LEGACY_KEYS = {"from_ts": "train_start_date", "to_ts": "train_end_date", "tags": "tag_list"}


def compat(init):
    """Translate legacy kwarg spellings onto their current names."""

    @wraps(init)
    def renamed(*args, **kwargs):
        return init(*args, **{_LEGACY_KEYS.get(k, k): v for k, v in kwargs.items()})

    return renamed


def _as_aware_datetime(value: Union[str, datetime]) -> datetime:
    stamp = datetime.fromisoformat(value) if isinstance(value, str) else value
    if stamp.tzinfo is None:
        raise ValueError(
            f"timezone-naive timestamp {value!r}: training windows must carry "
            "explicit timezone information"
        )
    return stamp


def _describe(column: np.ndarray) -> Dict[str, float]:
    """``pd.Series.describe()`` of a float column, as its ``to_dict()``."""
    with np.errstate(invalid="ignore", divide="ignore"):
        std = float(np.std(column, ddof=1)) if len(column) > 1 else float("nan")
    q25, q50, q75 = np.percentile(column, (25, 50, 75))
    return {
        "count": float(len(column)),
        "mean": float(np.mean(column)),
        "std": std,
        "min": float(np.min(column)),
        "25%": float(q25),
        "50%": float(q50),
        "75%": float(q75),
        "max": float(np.max(column)),
    }


class TimeSeriesDataset(GordoBaseDataset):
    train_start_date = ValidDatetime()
    train_end_date = ValidDatetime()

    @compat
    @capture_args
    def __init__(
        self,
        train_start_date: Union[datetime, str],
        train_end_date: Union[datetime, str],
        tag_list: Sequence[TagSpec],
        target_tag_list: Optional[Sequence[TagSpec]] = None,
        data_provider: Union[GordoBaseDataProvider, dict, None] = None,
        resolution: Optional[str] = "10T",
        row_filter: str = "",
        aggregation_methods: Union[str, List[str]] = "mean",
        row_filter_buffer_size: int = 0,
        asset: Optional[str] = None,
        default_asset: Optional[str] = None,
        n_samples_threshold: int = 0,
        low_threshold=-1000,
        high_threshold=50000,
        interpolation_method: str = "linear_interpolation",
        interpolation_limit: str = "8H",
        filter_periods={},
    ):
        self._metadata: dict = {}
        start, end = (_as_aware_datetime(v) for v in (train_start_date, train_end_date))
        if start >= end:
            raise ValueError(
                f"empty training window: start {start} is not before end {end}"
            )
        self.train_start_date, self.train_end_date = start, end
        self.tag_list = normalize_sensor_tags(list(tag_list), asset, default_asset)
        self.target_tag_list = (
            normalize_sensor_tags(list(target_tag_list), asset, default_asset)
            if target_tag_list
            else list(self.tag_list)
        )
        if data_provider is None:
            data_provider = DataLakeProvider()
        elif isinstance(data_provider, dict):
            data_provider = GordoBaseDataProvider.from_dict(data_provider)
        self.data_provider = data_provider
        self.resolution = resolution
        self.row_filter = row_filter
        self.row_filter_buffer_size = row_filter_buffer_size
        if resolution:
            checked_methods(aggregation_methods)  # an unported one raises here, as configs load
        self.aggregation_methods = aggregation_methods
        self.n_samples_threshold = n_samples_threshold
        self.low_threshold = low_threshold
        self.high_threshold = high_threshold
        self.interpolation_method = interpolation_method
        self.interpolation_limit = interpolation_limit
        self.filter_periods = (
            FilterPeriods(granularity=resolution, **filter_periods) if filter_periods else None
        )
        self.target_columns: List[str] = []

    def to_dict(self) -> dict:
        params = super().to_dict()
        for key in ("train_start_date", "train_end_date"):
            value = params.get(key)
            params[key] = value.isoformat() if hasattr(value, "isoformat") else str(value)
        return params

    def _fetch_joined(self) -> Frame:
        """Every needed tag, on one common grid."""
        wanted = list(dict.fromkeys(self.tag_list + self.target_tag_list))
        series = self.data_provider.load_series(
            train_start_date=self.train_start_date,
            train_end_date=self.train_end_date,
            tag_list=wanted,
        )
        if not self.resolution:
            return _join_raw(list(series))
        return self.join_timeseries(
            series,
            self.train_start_date,
            self.train_end_date,
            self.resolution,
            aggregation_methods=self.aggregation_methods,
            interpolation_method=self.interpolation_method,
            interpolation_limit=self.interpolation_limit,
        )

    def _apply_row_filter(self, data: Frame) -> Frame:
        keep = filter_rows_mask(data.values, data.columns, self.row_filter,
                                buffer_size=self.row_filter_buffer_size)
        return Frame(data.values[keep], data.columns, data.index[keep])

    def _apply_global_bounds(self, data: Frame) -> Frame:
        inside = ((data.values > self.low_threshold) & (data.values < self.high_threshold)).all(
            axis=1
        )
        return Frame(data.values[inside], data.columns, data.index[inside])

    def _apply_period_filter(self, data: Frame) -> Frame:
        keep, dropped, _ = self.filter_periods.filter_data(data.values, data.index)
        self._metadata["filtered_periods"] = dropped
        return Frame(data.values[keep], data.columns, data.index[keep])

    def _enabled_filters(self):
        """(stage, filter, error class) of each configured filter, in the
        JAX dataset's order."""
        if self.row_filter:
            yield "row filtering", self._apply_row_filter, InsufficientDataAfterRowFilteringError
        if self.low_threshold is not None and self.high_threshold is not None:
            yield ("global min/max filtering", self._apply_global_bounds,
                   InsufficientDataAfterGlobalFilteringError)
        if self.filter_periods:
            yield "noisy-period filtering", self._apply_period_filter, InsufficientDataError

    def _columns_of(self, tag: SensorTag) -> List[str]:
        """The joined frame's columns of one tag."""
        if not self.resolution or isinstance(self.aggregation_methods, str):
            return [tag.name]
        return [str((tag.name, method)) for method in checked_methods(self.aggregation_methods)]

    def _require_rows(self, data: Frame, error_cls: type, stage: str) -> None:
        """Every stage must leave more than ``n_samples_threshold`` rows."""
        if len(data.index) <= self.n_samples_threshold:
            raise error_cls(
                f"{len(data.index)} rows remain after {stage}; need more than "
                f"the configured threshold ({self.n_samples_threshold})."
            )

    def get_data(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        data = self._fetch_joined()
        self._require_rows(data, InsufficientDataError, "resampling/joining")
        for stage, apply, error_cls in self._enabled_filters():
            data = apply(data)
            self._require_rows(data, error_cls, stage)

        def columns(tags: List[SensorTag]) -> List[str]:
            return [name for tag in tags for name in self._columns_of(tag)]

        names = columns(self.tag_list)
        self.target_columns = columns(self.target_tag_list)
        X = data.values[:, [data.columns.index(name) for name in names]]
        y = data.values[:, [data.columns.index(name) for name in self.target_columns]]
        stamps = to_datetimes(data.index[[0, -1]])
        self._metadata["train_start_date_actual"] = stamps[0]
        self._metadata["train_end_date_actual"] = stamps[-1]
        self._metadata["summary_statistics"] = {
            name: _describe(X[:, j]) for j, name in enumerate(names)
        }
        self._metadata["x_hist"] = self._histograms(X, names)
        return X, y, data.index.astype("datetime64[ns]")

    @staticmethod
    def _histograms(X: np.ndarray, names: List[str], bins: int = 100) -> Dict[str, str]:
        """Per-tag histograms as JSON strings."""
        hists: Dict[str, str] = {}
        for j, tag in enumerate(names):
            col = X[:, j].astype(np.float64)
            finite = col[np.isfinite(col)]
            if len(finite) == 0 or float(finite.max() - finite.min()) < 1e-6:
                hists[str(tag)] = "{}"
                continue
            counts, edges = np.histogram(finite, bins=bins)
            hists[str(tag)] = json.dumps(
                {
                    f"({edges[i]:.6f}, {edges[i + 1]:.6f}]": int(counts[i])
                    for i in range(len(counts))
                }
            )
        return hists

    def get_metadata(self) -> dict:
        return self._metadata.copy()


def _join_raw(series: List[TagSeries]) -> Frame:
    """Tags inner-joined on their raw timestamps, with no resampling (a
    lone tag keeps its rows as they are, repeats too, as pandas' concat
    of one series does)."""
    if len(series) == 1:
        only = series[0]
        return Frame(np.asarray(only.values, dtype=np.float64)[:, None], [only.name],
                     np.asarray(only.index, dtype=np.int64))
    if any(len(np.unique(s.index)) != len(s.index) for s in series):
        raise ValueError("Reindexing only valid with uniquely valued Index objects")
    index = series[0].index
    for other in series[1:]:
        index = index[np.isin(index, other.index)]
    values = np.stack([_at(s, index) for s in series], axis=1)
    return Frame(values.reshape(len(index), len(series)), [s.name for s in series],
                 np.asarray(index, dtype=np.int64))


def _at(series: TagSeries, index: np.ndarray) -> np.ndarray:
    """The series' values at timestamps it holds once each."""
    order = np.argsort(series.index, kind="stable")
    positions = order[np.searchsorted(series.index[order], index)]
    return np.asarray(series.values, dtype=np.float64)[positions]


class RandomDataset(TimeSeriesDataset):
    """A TimeSeriesDataset that always reads from the random provider."""

    @compat
    @capture_args
    def __init__(self, train_start_date, train_end_date, tag_list: list, **kwargs):
        kwargs.pop("data_provider", None)
        super().__init__(
            train_start_date,
            train_end_date,
            tag_list,
            data_provider=RandomDataProvider(),
            **kwargs,
        )
