"""
Multi-provider dispatch (the port of ``gordo_tpu.data.providers.compound``):
the first sub-provider whose ``can_handle_tag`` claims a tag reads it.

``CompoundProvider(providers=[...])`` builds its sub-providers from their
dicts (or takes providers as they are) and yields their series group by
group, in the order each provider first claimed a tag, as the JAX
provider does. A tag that no sub-provider claims raises
``NoSuitableDataProviderError``.

A dataset whose ``data_provider`` is null reads through a
``DataLakeProvider``: a compound provider over the file-system provider
of the lake directory (``GORDO_TPU_LAKE_DIR`` or ``base_dir``), and with
no lake directory over random data, with the JAX package's warning: this
is the reference's own data semantics for a machine with no lake, not a
change of device.
"""

import logging
import os
from datetime import datetime
from typing import Dict, Iterable, List, Optional

from gordo_tpu_torch.data.base import TagSeries
from gordo_tpu_torch.data.providers.base import GordoBaseDataProvider
from gordo_tpu_torch.data.providers.filesystem import FileSystemProvider
from gordo_tpu_torch.data.providers.random_provider import RandomDataProvider
from gordo_tpu_torch.data.sensor_tag import SensorTag
from gordo_tpu_torch.utils.utils import capture_args

logger = logging.getLogger(__name__)

LAKE_DIR_ENV_VAR = "GORDO_TPU_LAKE_DIR"


class NoSuitableDataProviderError(ValueError):
    """No configured provider can handle a requested tag."""


def providers_for_tags(
    providers: List[GordoBaseDataProvider], tag_list: List[SensorTag]
) -> Dict[GordoBaseDataProvider, List[SensorTag]]:
    """Each tag assigned to the first provider that can handle it."""
    assignment: Dict[GordoBaseDataProvider, List[SensorTag]] = {}
    for tag in tag_list:
        for provider in providers:
            if provider.can_handle_tag(tag):
                assignment.setdefault(provider, []).append(tag)
                break
        else:
            raise NoSuitableDataProviderError(f"No provider can handle tag {tag}")
    return assignment


class CompoundProvider(GordoBaseDataProvider):
    """Sub-providers dispatched tag by tag (module docstring)."""

    WIRE_MODULE = "compound"

    @capture_args
    def __init__(self, providers: Optional[List] = None, **kwargs):
        self.providers = [
            p if isinstance(p, GordoBaseDataProvider) else GordoBaseDataProvider.from_dict(p)
            for p in (providers or [])
        ]

    def can_handle_tag(self, tag: SensorTag) -> bool:
        return any(p.can_handle_tag(tag) for p in self.providers)

    def load_series(
        self,
        train_start_date: datetime,
        train_end_date: datetime,
        tag_list: List[SensorTag],
        dry_run: Optional[bool] = False,
    ) -> Iterable[TagSeries]:
        for provider, tags in providers_for_tags(self.providers, tag_list).items():
            yield from provider.load_series(train_start_date, train_end_date, tags,
                                            dry_run=dry_run)


class DataLakeProvider(CompoundProvider):
    """The legacy lake provider name; ``storename``, ``interactive`` and
    the other reference kwargs are accepted and ignored."""

    def __init__(self, base_dir: Optional[str] = None, threads: int = 10, **kwargs):
        base_dir = base_dir or os.environ.get(LAKE_DIR_ENV_VAR)
        if base_dir:
            sub: GordoBaseDataProvider = FileSystemProvider(base_dir=base_dir, threads=threads)
        else:
            logger.warning(
                "DataLakeProvider: no lake directory configured (set %s or "
                "base_dir); falling back to RandomDataProvider",
                LAKE_DIR_ENV_VAR,
            )
            sub = RandomDataProvider()
        super().__init__(providers=[sub])
        # the arguments as given, for to_dict
        self._params = {"base_dir": base_dir, "threads": threads, **kwargs}
