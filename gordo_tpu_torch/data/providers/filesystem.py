"""
The file-system provider (the port of
``gordo_tpu.data.providers.filesystem``) for CSV files: one file per tag
and year, or one per tag, under a lake directory::

    <base_dir>/<asset>/<tag>/<tag>_<year>.csv
    <base_dir>/<asset>/<tag>.csv

(or the same directly under ``base_dir``). A file has the columns
``Time,Value[,Status]`` (any case; otherwise its first two columns are
time and value), read with ``csv`` and numpy as pandas reads them: times
ISO 8601 (naive ones are UTC), values as pandas' C parser reads them
(values that are not numbers dropped with their rows), rows whose
``Status`` is not a good code (0 or 192; or, with ``remove_status_codes``,
rows whose status is listed) dropped. A tag's files are joined in year
order, sorted stably by time, a repeated timestamp keeps its last row,
and the rows in [start, end) are returned. Tags are read in a thread pool of ``threads``.

The JAX provider prefers a ``.parquet`` file over a ``.csv`` one; the
card's machine has no parquet reader (pyarrow), so a parquet file where
the JAX provider would read one raises ``NotImplementedError`` saying so,
never skipped in favour of a CSV beside it.
"""

import csv
import logging
import math
from concurrent.futures import ThreadPoolExecutor
from datetime import datetime, timezone
from pathlib import Path
from typing import Iterable, List, Optional

import numpy as np

from gordo_tpu_torch.data.base import TagSeries, to_ns
from gordo_tpu_torch.data.providers.base import GordoBaseDataProvider
from gordo_tpu_torch.data.sensor_tag import SensorTag
from gordo_tpu_torch.utils.utils import capture_args

logger = logging.getLogger(__name__)

#: status codes of good measurements
GOOD_STATUS_CODES = frozenset([0, 192])
#: file suffixes in the JAX provider's order of preference
_SUFFIXES = (".parquet", ".csv")


def _parse_time(text: str) -> int:
    """An ISO 8601 time as int UTC nanoseconds (a naive one is UTC)."""
    stamp = datetime.fromisoformat(text.strip())
    if stamp.tzinfo is None:
        stamp = stamp.replace(tzinfo=timezone.utc)
    return to_ns(stamp)


#: 10**i as the C literals ``1e0`` .. ``1e308``
_POWERS_OF_TEN = [float(f"1e{i}") for i in range(309)]


def _xstrtod(text: str) -> Optional[float]:
    """pandas' C parser's default float reading (``precise_xstrtod``):
    up to 17 significant digits accumulated in float64, the rest counted
    into the exponent, then one multiplication or division by a power of
    ten. Not always the nearest float64 (``float`` is), so a CSV value
    reads as pandas reads it. None for text it does not take."""
    s = text.strip()
    i, n = 0, len(s)
    negative = False
    if i < n and s[i] in "+-":
        negative = s[i] == "-"
        i += 1
    number, exponent, n_digits = 0.0, 0, 0
    while i < n and "0" <= s[i] <= "9":
        if n_digits < 17:
            number = number * 10.0 + (ord(s[i]) - 48)
            n_digits += 1
        else:
            exponent += 1
        i += 1
    if i < n and s[i] == ".":
        i += 1
        n_decimals = 0
        while n_digits < 17 and i < n and "0" <= s[i] <= "9":
            number = number * 10.0 + (ord(s[i]) - 48)
            n_digits += 1
            n_decimals += 1
            i += 1
        while i < n and "0" <= s[i] <= "9":
            i += 1
        exponent -= n_decimals
    if n_digits == 0:
        return None
    if negative:
        number = -number
    if i < n and s[i] in "eE":
        j, exp_negative, power, exp_digits = i + 1, False, 0, 0
        if j < n and s[j] in "+-":
            exp_negative = s[j] == "-"
            j += 1
        while exp_digits < 17 and j < n and "0" <= s[j] <= "9":
            power = power * 10 + ord(s[j]) - 48
            exp_digits += 1
            j += 1
        if exp_digits:
            exponent += -power if exp_negative else power
            i = j
    if i != n:
        return None
    if exponent > 308:
        return -math.inf if negative else math.inf
    if exponent > 0:
        return number * _POWERS_OF_TEN[exponent]
    if exponent < -308:
        if exponent < -616:
            return 0.0
        return number / _POWERS_OF_TEN[-308 - exponent] / _POWERS_OF_TEN[308]
    return number / _POWERS_OF_TEN[-exponent]


def _number(text: str) -> float:
    """One cell as pandas' ``read_csv`` and ``to_numeric(errors="coerce")``
    read it: its float parser's value, else what Python reads (``inf``,
    ``nan``), else NaN."""
    value = _xstrtod(text)
    if value is not None:
        return value
    try:
        return float(text)
    except (TypeError, ValueError):
        return math.nan


class FileSystemProvider(GordoBaseDataProvider):
    WIRE_MODULE = "filesystem"

    @capture_args
    def __init__(
        self,
        base_dir: str,
        threads: int = 10,
        remove_status_codes: Optional[list] = None,
        dry_run: bool = False,
        **kwargs,
    ):
        self.base_dir = Path(base_dir)
        self.threads = threads
        self.remove_status_codes = remove_status_codes
        self.dry_run = dry_run

    def can_handle_tag(self, tag: SensorTag) -> bool:
        return self._tag_dir(tag) is not None

    def _tag_dir(self, tag: SensorTag) -> Optional[Path]:
        """The directory holding the tag's directory or file, or None."""
        roots = ([self.base_dir / tag.asset] if tag.asset else []) + [self.base_dir]
        for root in roots:
            if (root / tag.name).is_dir() or any(
                (root / (tag.name + suffix)).is_file() for suffix in _SUFFIXES
            ):
                return root
        return None

    def _tag_files(self, tag: SensorTag, years: Iterable[int]) -> List[Path]:
        root = self._tag_dir(tag)
        if root is None:
            raise FileNotFoundError(f"No files found for tag {tag.name} under {self.base_dir}")
        stems = ([f"{tag.name}_{year}" for year in years] if (root / tag.name).is_dir()
                 else [tag.name])
        folder = root / tag.name if (root / tag.name).is_dir() else root
        files = []
        for stem in stems:
            for suffix in _SUFFIXES:
                candidate = folder / (stem + suffix)
                if candidate.is_file():
                    files.append(candidate)
                    break
        return files

    def _read_file(self, path: Path):
        """(int ns times, float values) of one file's good rows, sorted by
        time (stably)."""
        if path.suffix == ".parquet":
            raise NotImplementedError(
                f"{path} is parquet, which the JAX provider reads before a CSV; the port "
                "reads CSV only: the card's machine has no parquet reader (pyarrow)"
            )
        with open(path, newline="") as fh:
            rows = list(csv.reader(fh))
        if not rows:
            raise ValueError(f"File {path} is empty")
        header, body = rows[0], [row for row in rows[1:] if row]
        lower = {name.lower(): j for j, name in enumerate(header)}
        time_col = lower.get("time", 0)
        value_col = lower.get("value", 1 if len(header) > 1 else None)
        if value_col is None:
            raise ValueError(f"File {path} has no value column")
        status_col = lower.get("status")
        if status_col is not None:
            statuses = [_number(row[status_col]) for row in body]
            if self.remove_status_codes is not None:
                bad = set(float(code) for code in self.remove_status_codes)
                body = [row for row, status in zip(body, statuses) if status not in bad]
            else:
                body = [row for row, status in zip(body, statuses)
                        if status in GOOD_STATUS_CODES]
        times, values = [], []
        for row in body:
            value = _number(row[value_col])
            if row[time_col].strip() and not math.isnan(value):
                times.append(_parse_time(row[time_col]))
                values.append(value)
        times = np.asarray(times, dtype=np.int64)
        values = np.asarray(values, dtype=np.float64)
        order = np.argsort(times, kind="stable")
        return times[order], values[order]

    def _read_tag(self, tag: SensorTag, train_start_date: datetime,
                  train_end_date: datetime) -> TagSeries:
        years = range(train_start_date.year, train_end_date.year + 1)
        parts = [self._read_file(path) for path in self._tag_files(tag, years)]
        if not parts:
            return TagSeries(tag.name, np.zeros(0, dtype=np.int64), np.zeros(0))
        times = np.concatenate([t for t, _ in parts])
        values = np.concatenate([v for _, v in parts])
        order = np.argsort(times, kind="stable")
        times, values = times[order], values[order]
        # a repeated timestamp keeps its last row
        last = np.append(times[1:] != times[:-1], True)[: len(times)]
        times, values = times[last], values[last]
        inside = (times >= to_ns(train_start_date)) & (times < to_ns(train_end_date))
        return TagSeries(tag.name, times[inside], values[inside])

    def load_series(
        self,
        train_start_date: datetime,
        train_end_date: datetime,
        tag_list: List[SensorTag],
        dry_run: Optional[bool] = False,
    ) -> Iterable[TagSeries]:
        if train_start_date >= train_end_date:
            raise ValueError(
                f"start date {train_start_date} is not before end {train_end_date}"
            )
        with ThreadPoolExecutor(max_workers=self.threads) as executor:
            fetched = executor.map(
                lambda tag: self._read_tag(tag, train_start_date, train_end_date), tag_list
            )
            for series in fetched:
                if dry_run:
                    logger.info("Dry run: %s (%d rows)", series.name, len(series))
                yield series
