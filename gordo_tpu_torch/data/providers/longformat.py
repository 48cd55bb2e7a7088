"""
The long-format (melted) file reader (the port of
``gordo_tpu.data.providers.longformat``): files hold many tags as
``(tag, time, value)`` rows, in date directories or not::

    <base_dir>/[<asset>/]<YYYY>/<MM>/<DD>/*.csv
    <base_dir>/[<asset>/]*.csv          (unpartitioned)

and one series is returned a requested tag. As in the JAX provider:

- a tag's root is ``<base_dir>/<asset>`` when that directory exists,
  else ``base_dir``; a tag is handled when its root holds a data file
  (``*.csv`` or ``*.parquet``, at the top or three levels down);
- the day directories from the day before ``start`` to the day after
  ``end`` are read (timezone slop), or the root itself when none exists;
  the files of a directory in name order, in a thread pool of
  ``threads``;
- the ``tag``, ``time`` and ``value`` columns are found whatever their
  case (other columns are ignored); values are read as pandas' C parser
  reads them, and a value that is not a number drops its row (pandas' ``to_numeric(errors="coerce")`` then ``dropna``);
  rows outside [start, end) and of other tags go;
- a tag's rows are sorted stably by time and a repeated timestamp keeps
  its last row, later files winning;
- a tag with no rows logs a warning and yields an empty series; no data
  file under any root raises ``FileNotFoundError``, while files that all
  fall outside the window only warn.

Times are read with ``datetime.fromisoformat``, which gives what
``pd.to_datetime(..., utc=True)`` gives for ISO 8601 text (pandas'
``to_csv`` of aware or naive timestamps, a ``T`` or a space, ``Z`` or an
offset; a naive time is UTC); any other text raises ``ValueError``
naming it, never a guess. A ``.parquet`` file raises
``NotImplementedError``: the card's machine has no parquet reader
(pyarrow). Several roots (tags of different assets) are read in sorted
order, where the JAX provider walks a set.
"""

import csv
import logging
import math
from concurrent.futures import ThreadPoolExecutor
from datetime import datetime, timedelta, timezone
from pathlib import Path
from typing import AbstractSet, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from gordo_tpu_torch.data.base import TagSeries, to_ns
from gordo_tpu_torch.data.providers.base import GordoBaseDataProvider
from gordo_tpu_torch.data.providers.filesystem import _number
from gordo_tpu_torch.data.sensor_tag import SensorTag
from gordo_tpu_torch.utils.utils import capture_args

logger = logging.getLogger(__name__)

_DATA_SUFFIXES = (".parquet", ".csv")
_DATA_PATTERNS = ("*.parquet", "*.csv", "*/*/*/*.parquet", "*/*/*/*.csv")


def parse_time(text: str) -> int:
    """ISO 8601 text as int UTC nanoseconds (a naive time is UTC)."""
    try:
        stamp = datetime.fromisoformat(text.strip())
    except ValueError:
        raise ValueError(f"Unreadable time {text!r}: the port reads ISO 8601 times only") from None
    if stamp.tzinfo is None:
        stamp = stamp.replace(tzinfo=timezone.utc)
    return to_ns(stamp)


class LongFormatProvider(GordoBaseDataProvider):
    WIRE_MODULE = "longformat"

    @capture_args
    def __init__(self, base_dir: str, threads: int = 10, dry_run: bool = False, **kwargs):
        self.base_dir = Path(base_dir)
        self.threads = threads
        self.dry_run = dry_run

    def can_handle_tag(self, tag: SensorTag) -> bool:
        root = self._asset_dir(tag)
        return root is not None and self._has_data_files(root)

    def _asset_dir(self, tag: SensorTag) -> Optional[Path]:
        if tag.asset and (self.base_dir / tag.asset).is_dir():
            return self.base_dir / tag.asset
        if self.base_dir.is_dir():
            return self.base_dir
        return None

    @staticmethod
    def _has_data_files(root: Path) -> bool:
        return any(next(root.glob(pattern), None) is not None for pattern in _DATA_PATTERNS)

    @staticmethod
    def _day_dirs(root: Path, start: datetime, end: datetime) -> Iterator[Path]:
        """The date directories of [start - 1 day, end + 1 day], or the
        root when there is none."""
        day = (start - timedelta(days=1)).date()
        stop = (end + timedelta(days=1)).date()
        found_any = False
        while day <= stop:
            candidate = root / f"{day.year:04d}" / f"{day.month:02d}" / f"{day.day:02d}"
            if candidate.is_dir():
                found_any = True
                yield candidate
            day += timedelta(days=1)
        if not found_any:
            yield root

    @staticmethod
    def _read_long_file(path: Path, wanted: AbstractSet[str], start: int,
                        end: int) -> Tuple[List[str], np.ndarray, np.ndarray]:
        """(tags, int ns times, values) of one file's rows of the wanted
        tags inside [start, end), in file order."""
        if path.suffix == ".parquet":
            raise NotImplementedError(
                f"{path} is parquet; the port reads CSV only: the card's machine has no "
                "parquet reader (pyarrow)"
            )
        with open(path, newline="") as fh:
            rows = list(csv.reader(fh))
        if not rows:
            raise ValueError(f"File {path} is empty")
        header, body = rows[0], [row for row in rows[1:] if row]
        cols = {name.lower(): j for j, name in enumerate(header)}
        missing = [c for c in ("tag", "time", "value") if c not in cols]
        if missing:
            raise ValueError(f"File {path} lacks long-format columns {missing}")
        tag_col, time_col, value_col = cols["tag"], cols["time"], cols["value"]
        tags, times, values = [], [], []
        for row in body:
            if not row[time_col].strip():
                continue
            stamp = parse_time(row[time_col])  # any unreadable time raises, as pandas does
            value = _number(row[value_col])
            if math.isnan(value) or row[tag_col] not in wanted:
                continue
            if start <= stamp < end:
                tags.append(row[tag_col])
                times.append(stamp)
                values.append(value)
        return tags, np.asarray(times, dtype=np.int64), np.asarray(values, dtype=np.float64)

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
        if not tag_list:
            return
        wanted = {tag.name for tag in tag_list}
        roots = sorted({self._asset_dir(tag) for tag in tag_list} - {None})
        files: List[Path] = []
        for root in roots:
            for day_dir in self._day_dirs(root, train_start_date, train_end_date):
                files.extend(p for p in sorted(day_dir.iterdir()) if p.suffix in _DATA_SUFFIXES)
        start, end = to_ns(train_start_date), to_ns(train_end_date)
        if files:
            with ThreadPoolExecutor(max_workers=self.threads) as executor:
                parts = list(executor.map(
                    lambda p: self._read_long_file(p, wanted, start, end), files))
        else:
            if not any(self._has_data_files(root) for root in roots):
                raise FileNotFoundError(
                    f"No long-format files under {sorted(map(str, roots))}"
                )
            logger.warning(
                "No long-format files under %s for window [%s, %s)",
                sorted(map(str, roots)), train_start_date, train_end_date,
            )
            parts = []
        tags = np.asarray([t for part in parts for t in part[0]], dtype=object)
        times = np.concatenate([p[1] for p in parts]) if parts else np.zeros(0, np.int64)
        values = np.concatenate([p[2] for p in parts]) if parts else np.zeros(0)
        for tag in tag_list:
            mine = tags == tag.name
            if not mine.any():
                logger.warning("No data found for tag %s", tag.name)
                series = TagSeries(tag.name, np.zeros(0, dtype=np.int64), np.zeros(0))
            else:
                t, v = times[mine], values[mine]
                order = np.argsort(t, kind="stable")
                t, v = t[order], v[order]
                last = np.append(t[1:] != t[:-1], True)
                series = TagSeries(tag.name, t[last], v[last])
            if dry_run or self.dry_run:
                logger.info("Dry run: %s (%d rows)", tag.name, len(series))
            yield series
