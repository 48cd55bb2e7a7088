"""
Deterministic random data provider (the port of
``gordo_tpu.data.providers.random_provider``): the same samples as the
JAX provider for the same seed, tag and span.

Each tag's generator is seeded from the sha256 of ``"{seed}|{tag}|
{start.isoformat()}|{end.isoformat()}"``; it draws the sample count, then
that many whole-second timestamps in [start, end), then the values.
Timestamps are sorted and duplicates kept.
"""

import hashlib
from datetime import datetime
from typing import Iterable, List, Optional

import numpy as np

from gordo_tpu_torch.data.base import TagSeries, to_ns
from gordo_tpu_torch.data.providers.base import GordoBaseDataProvider
from gordo_tpu_torch.data.sensor_tag import SensorTag
from gordo_tpu_torch.utils.utils import capture_args

_NS_PER_S = 1_000_000_000


class RandomDataProvider(GordoBaseDataProvider):
    """Random series for any tag; the same inputs give the same outputs."""

    WIRE_MODULE = "random_provider"

    @capture_args
    def __init__(self, min_size: int = 100, max_size: int = 300, seed: int = 0, **kwargs):
        self.min_size = min_size
        self.max_size = max_size
        self.seed = seed

    def can_handle_tag(self, tag: SensorTag) -> bool:
        return True

    def _rng_for(self, tag_name: str, start: datetime, end: datetime) -> np.random.Generator:
        digest = hashlib.sha256(
            f"{self.seed}|{tag_name}|{start.isoformat()}|{end.isoformat()}".encode()
        ).digest()
        return np.random.default_rng(int.from_bytes(digest[:8], "little"))

    def load_series(
        self,
        train_start_date: datetime,
        train_end_date: datetime,
        tag_list: List[SensorTag],
        dry_run: Optional[bool] = False,
    ) -> Iterable[TagSeries]:
        if dry_run:
            raise NotImplementedError("Dry run for RandomDataProvider is not implemented")
        start_s = to_ns(train_start_date) // _NS_PER_S
        end_s = to_ns(train_end_date) // _NS_PER_S
        for tag in tag_list:
            rng = self._rng_for(tag.name, train_start_date, train_end_date)
            n = int(rng.integers(self.min_size, self.max_size + 1))
            index = np.sort(rng.integers(start_s, end_s, n)) * _NS_PER_S
            yield TagSeries(tag.name, index, rng.random(size=len(index)))
