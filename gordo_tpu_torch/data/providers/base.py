"""
Data provider base (the port of ``gordo_tpu.data.providers.base``): a
source of raw tag series, and ``from_dict`` for a config's
``data_provider`` entry.
"""

import abc
import copy
from datetime import datetime
from typing import Iterable, List

from gordo_tpu_torch.data.base import TagSeries
from gordo_tpu_torch.data.sensor_tag import SensorTag

#: providers of the JAX package the port does not have, and why
NOT_PORTED = {
    "ObjectStoreProvider": "it needs fsspec, which the card's machine lacks",
    "InfluxDataProvider": "it needs influxdb, which the card's machine lacks",
}


class GordoBaseDataProvider(abc.ABC):
    #: the JAX package's module of the provider class (``to_dict``)
    WIRE_MODULE: str
    _params: dict

    @abc.abstractmethod
    def load_series(
        self,
        train_start_date: datetime,
        train_end_date: datetime,
        tag_list: List[SensorTag],
        dry_run: bool = False,
    ) -> Iterable[TagSeries]:
        """One time-indexed series per tag covering [start, end)."""

    @abc.abstractmethod
    def can_handle_tag(self, tag: SensorTag) -> bool:
        """Whether this provider can serve data for ``tag``."""

    def to_dict(self) -> dict:
        """The constructor arguments (``capture_args``) and ``type``, the
        JAX package's class path: the machine dicts of both packages
        carry that name, and :meth:`from_dict` reads it by its last part."""
        params = dict(self._params)
        params["type"] = f"gordo_tpu.data.providers.{self.WIRE_MODULE}.{type(self).__name__}"
        return params

    @classmethod
    def from_dict(cls, config: dict) -> "GordoBaseDataProvider":
        """A provider from ``{"type": <class name or path>, **kwargs}``."""
        from gordo_tpu_torch.data.providers import PROVIDERS

        config = copy.copy(config)
        type_path = config.pop("type", "RandomDataProvider")
        name = type_path.rsplit(".", 1)[-1]
        if name in NOT_PORTED:
            raise NotImplementedError(f"Data provider {name!r} is not ported: {NOT_PORTED[name]}")
        try:
            provider = PROVIDERS[name]
        except KeyError:
            raise TypeError(f"No data provider of type '{type_path}'") from None
        return provider(**config)
