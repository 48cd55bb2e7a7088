"""
Sensor tags (the port of ``gordo_tpu.data.sensor_tag``).

Tags arrive from configs as plain strings, ``{name, asset}`` dicts,
``[name, asset]`` pairs or ``SensorTag`` tuples and are normalized to
``SensorTag(name, asset)``; a bare name's asset is deduced from its
prefix through the same pattern table as the JAX package's.
"""

import re
from typing import Dict, List, NamedTuple, Optional, Union


class SensorTag(NamedTuple):
    name: str
    asset: Optional[str] = None


class SensorTagNormalizationError(ValueError):
    """A tag spec could not be turned into a ``SensorTag``."""


# tag-name prefix pattern -> asset code
_ASSET_PATTERNS = [
    (r"^ninenine.+::.+", "ninenine"),
    (r"^uon_ef.+::.+", "uon_ef"),
    (r"^gfa\.", "1110-gfa"),
    (r"^gfb\.", "1111-gfb"),
    (r"^gfc\.", "1112-gfc"),
    (r"^1125.", "1125-kvb"),
    (r"^tra.", "1130-troa"),
    (r"^asgb.", "1191-asgb"),
    (r"^kri.", "1175-kri"),
    (r"^1138.", "1138-val"),
    (r"^hd.", "1170-hd"),
    (r"^nor.", "1180-nor"),
    (r"^asga.", "1190-asga"),
    (r"^1218.", "1218-gkr"),
    (r"^1219.", "1219-aha"),
    (r"^vis.", "1230-vis"),
    (r"^per-pa.", "1294-pera"),
    (r"^per-pb.", "1298-perb"),
    (r"^per.", "1299-perf"),
    (r"^gra.", "1755-gra"),
    (r"^hea.", "1760-hea"),
    (r"^osc.", "1765-OSC"),
    (r"^oss.", "1766-OSS"),
    (r"^ose.", "1767-OSE"),
    (r"^trb.", "1775-trob"),
    (r"^trc.", "1776-troc"),
    (r"^1900.", "1900-jsv"),
    (r"^1901.", "1901-jsv"),
    (r"^1902.", "1902-jsv"),
    (r"^1903.", "1903-jsv"),
    (r"^1904.", "1904-jsv"),
]
TAG_TO_ASSET = [(re.compile(p, re.IGNORECASE), a) for p, a in _ASSET_PATTERNS]

TagSpec = Union[Dict, List, str, SensorTag]


def _asset_from_tag_name(tag_name: str, default_asset: Optional[str] = None) -> str:
    for regexp, asset_name in TAG_TO_ASSET:
        if regexp.match(tag_name):
            return asset_name
    if default_asset:
        return default_asset
    raise SensorTagNormalizationError(f"Unable to find asset for tag with name {tag_name}")


def _normalize_one(
    sensor: TagSpec, asset: Optional[str] = None, default_asset: Optional[str] = None
) -> SensorTag:
    if isinstance(sensor, SensorTag):
        return sensor
    if isinstance(sensor, dict):
        return SensorTag(sensor["name"], sensor["asset"])
    if isinstance(sensor, str):
        if asset is not None:
            return SensorTag(sensor, asset)
        return SensorTag(sensor, _asset_from_tag_name(sensor, default_asset))
    if isinstance(sensor, (list, tuple)):
        return SensorTag(sensor[0], sensor[1])
    raise SensorTagNormalizationError(
        f"Sensor {sensor!r} of type {type(sensor)} cannot be converted to SensorTag"
    )


def normalize_sensor_tags(
    sensors: List[TagSpec],
    asset: Optional[str] = None,
    default_asset: Optional[str] = None,
) -> List[SensorTag]:
    """A list of tag specs as ``SensorTag`` tuples."""
    return [_normalize_one(s, asset, default_asset) for s in sensors]


def tag_names(tag_list: List[TagSpec]) -> List[str]:
    """The names in a list of tag specs, without resolving assets."""
    names = []
    for tag in tag_list:
        if isinstance(tag, dict):
            names.append(tag["name"])
        elif isinstance(tag, (list, tuple)):
            names.append(tag[0])
        else:
            names.append(str(tag))
    return names


def to_list_of_strings(sensor_tag_list: List[SensorTag]) -> List[str]:
    return [tag.name for tag in sensor_tag_list]
