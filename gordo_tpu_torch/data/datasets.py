"""
Datasets (the port of ``gordo_tpu.data.datasets``).

``TimeSeriesDataset``: fetch the tags, resample and join them onto one
grid, keep the rows strictly inside the global bounds, and split X and y
by the tag lists, recording the JAX dataset's metadata on the way.
``RandomDataset`` always reads from the random provider.

``get_data`` returns ``(X, y, index)``: float64 arrays and the rows'
``datetime64[ns]`` UTC timestamps, where the JAX dataset returns frames.
"""

import json
from datetime import datetime
from functools import wraps
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from gordo_tpu_torch.data.base import GordoBaseDataset, InsufficientDataError, to_datetimes
from gordo_tpu_torch.data.filter_periods import check_filter_periods
from gordo_tpu_torch.data.filter_rows import check_row_filter
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
        if not resolution:
            raise NotImplementedError(
                "A dataset without a resolution (a join on raw timestamps) is "
                "not ported yet (ROADMAP.md queue 1)"
            )
        check_row_filter(row_filter)
        check_filter_periods(filter_periods)
        self.resolution = resolution
        self.aggregation_methods = aggregation_methods
        self.n_samples_threshold = n_samples_threshold
        self.low_threshold = low_threshold
        self.high_threshold = high_threshold
        self.interpolation_method = interpolation_method
        self.interpolation_limit = interpolation_limit

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
        return self.join_timeseries(
            series,
            self.train_start_date,
            self.train_end_date,
            self.resolution,
            aggregation_methods=self.aggregation_methods,
            interpolation_method=self.interpolation_method,
            interpolation_limit=self.interpolation_limit,
        )

    def _apply_global_bounds(self, data: Frame) -> Frame:
        inside = ((data.values > self.low_threshold) & (data.values < self.high_threshold)).all(
            axis=1
        )
        return Frame(data.values[inside], data.columns, data.index[inside])

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
        if self.low_threshold is not None and self.high_threshold is not None:
            data = self._apply_global_bounds(data)
            self._require_rows(
                data, InsufficientDataAfterGlobalFilteringError, "global min/max filtering"
            )

        def columns(tags: List[SensorTag]) -> np.ndarray:
            return data.values[:, [data.columns.index(tag.name) for tag in tags]]

        X, y = columns(self.tag_list), columns(self.target_tag_list)
        stamps = to_datetimes(data.index[[0, -1]])
        self._metadata["train_start_date_actual"] = stamps[0]
        self._metadata["train_end_date_actual"] = stamps[-1]
        names = [tag.name for tag in self.tag_list]
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
