"""
Frequency aliases (the port of ``gordo_tpu.utils.compat``, with its own
copy of the alias table).

Configs written for the reference use pandas' legacy aliases ("10T",
"8H", "1S"); modern pandas spells them "10min", "8h", "1s".
:func:`normalize_frequency` maps the legacy spellings onto the modern
ones, and :func:`frequency_to_ns` turns a fixed frequency into a number
of nanoseconds, which the port's resampler works in (it has no pandas).
"""

import re

# legacy single/upper-case alias -> modern lower-case alias
_LEGACY_ALIASES = {
    "T": "min",
    "MIN": "min",
    "H": "h",
    "S": "s",
    "L": "ms",
    "U": "us",
    "N": "ns",
}
_MODERN = ("ms", "us", "ns", "min", "h", "s")

_NS_PER_UNIT = {
    "ns": 1,
    "us": 1_000,
    "ms": 1_000_000,
    "s": 1_000_000_000,
    "min": 60 * 1_000_000_000,
    "h": 3600 * 1_000_000_000,
    "D": 86400 * 1_000_000_000,
    "d": 86400 * 1_000_000_000,
    "W": 7 * 86400 * 1_000_000_000,
}

_FREQ_RE = re.compile(r"^\s*(\d*\.?\d*)\s*([a-zA-Z]+)\s*$")


def normalize_frequency(freq: str) -> str:
    """
    "10T" -> "10min", "8H" -> "8h"; modern spellings, and strings that
    are not ``<number><alias>``, are returned unchanged.
    """
    if not isinstance(freq, str):
        return freq
    match = _FREQ_RE.match(freq)
    if not match:
        return freq
    num, alias = match.groups()
    if alias in _MODERN:
        return freq
    replacement = _LEGACY_ALIASES.get(alias.upper())
    if replacement is None:
        return freq
    return f"{num}{replacement}"


def frequency_to_ns(freq: str) -> int:
    """
    A fixed frequency ("10T", "2T", "8H", "10min", "1h", "1D") as a whole
    number of nanoseconds, as ``pd.Timedelta(normalize_frequency(freq))``
    gives it. Raises ``ValueError`` for anything else.
    """
    match = _FREQ_RE.match(normalize_frequency(freq) if isinstance(freq, str) else "")
    if not match:
        raise ValueError(f"Unsupported frequency {freq!r}")
    num, alias = match.groups()
    if alias not in _NS_PER_UNIT:
        raise ValueError(f"Unsupported frequency {freq!r}")
    return round(float(num or 1) * _NS_PER_UNIT[alias])
