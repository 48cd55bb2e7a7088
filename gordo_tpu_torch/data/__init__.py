"""
Data layer (the port of ``gordo_tpu.data``) in numpy: datasets,
providers and the resample/join engine.
"""

import copy

from .base import GordoBaseDataset, InsufficientDataError, TagSeries
from .datasets import (
    InsufficientDataAfterGlobalFilteringError,
    InsufficientDataAfterRowFilteringError,
    RandomDataset,
    TimeSeriesDataset,
)
from .sensor_tag import SensorTag, SensorTagNormalizationError, normalize_sensor_tags

#: the dataset types a config may name
DATASETS = {cls.__name__: cls for cls in (TimeSeriesDataset, RandomDataset)}


def _get_dataset(config: dict) -> GordoBaseDataset:
    """A dataset from a machine's dataset dict (``type``, ``tag_list`` or
    ``tags``, and the rest as keyword arguments)."""
    config = copy.copy(dict(config))
    type_name = config.pop("type", "TimeSeriesDataset")
    try:
        dataset_cls = DATASETS[type_name.rsplit(".", 1)[-1]]
    except KeyError:
        raise TypeError(f"No dataset of type '{type_name}'") from None
    if "tags" in config:
        config["tag_list"] = config.pop("tags")
    if "tag_list" not in config:
        raise ValueError(
            "Dataset config requires a 'tags' (or 'tag_list') key naming the "
            "sensor tags to load"
        )
    config.setdefault("target_tag_list", config["tag_list"])
    return dataset_cls(**config)


__all__ = [
    "GordoBaseDataset",
    "InsufficientDataError",
    "InsufficientDataAfterRowFilteringError",
    "InsufficientDataAfterGlobalFilteringError",
    "TimeSeriesDataset",
    "RandomDataset",
    "SensorTag",
    "SensorTagNormalizationError",
    "TagSeries",
    "normalize_sensor_tags",
    "_get_dataset",
]
