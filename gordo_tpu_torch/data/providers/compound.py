"""
Provider resolution for configs (the port of
``gordo_tpu.data.providers.compound``).

A dataset whose ``data_provider`` is null reads through a
``DataLakeProvider``, as in the JAX package: with a lake directory
(``GORDO_TPU_LAKE_DIR`` or ``base_dir``) through the file-system provider
(CSV files; a tag no file holds raises ``NoSuitableDataProviderError``),
and with none from random data, with the JAX package's warning: this is
the reference's own data semantics for a machine with no lake, not a
change of device.
"""

import logging
import os
from datetime import datetime
from typing import Iterable, List, Optional

from gordo_tpu_torch.data.base import TagSeries
from gordo_tpu_torch.data.providers.base import GordoBaseDataProvider
from gordo_tpu_torch.data.providers.filesystem import FileSystemProvider
from gordo_tpu_torch.data.providers.random_provider import RandomDataProvider
from gordo_tpu_torch.data.sensor_tag import SensorTag

logger = logging.getLogger(__name__)

LAKE_DIR_ENV_VAR = "GORDO_TPU_LAKE_DIR"


class NoSuitableDataProviderError(ValueError):
    """No configured provider can handle a requested tag."""


class DataLakeProvider(GordoBaseDataProvider):
    """The legacy lake provider name; ``storename``, ``interactive`` and
    the other reference kwargs are accepted and ignored."""

    WIRE_MODULE = "compound"

    def __init__(self, base_dir: Optional[str] = None, threads: int = 10, **kwargs):
        base_dir = base_dir or os.environ.get(LAKE_DIR_ENV_VAR)
        if base_dir:
            self.provider: GordoBaseDataProvider = FileSystemProvider(
                base_dir=base_dir, threads=threads
            )
        else:
            logger.warning(
                "DataLakeProvider: no lake directory configured (set %s or "
                "base_dir); falling back to RandomDataProvider",
                LAKE_DIR_ENV_VAR,
            )
            self.provider = RandomDataProvider()
        # the arguments as given, for to_dict
        self._params = {"base_dir": base_dir, "threads": threads, **kwargs}

    def can_handle_tag(self, tag: SensorTag) -> bool:
        return self.provider.can_handle_tag(tag)

    def load_series(
        self,
        train_start_date: datetime,
        train_end_date: datetime,
        tag_list: List[SensorTag],
        dry_run: Optional[bool] = False,
    ) -> Iterable[TagSeries]:
        for tag in tag_list:
            if not self.provider.can_handle_tag(tag):
                raise NoSuitableDataProviderError(f"No provider can handle tag {tag}")
        yield from self.provider.load_series(
            train_start_date, train_end_date, tag_list, dry_run=dry_run
        )
