"""
The Prometheus text exposition format 0.0.4, written with the standard
library (the JAX server writes it with ``prometheus_client``, which the
card's machine lacks).

:func:`registry_text` writes a :class:`~.registry.MetricsRegistry`
snapshot as ``prometheus_client``'s ``generate_latest`` writes the JAX
package's bridge of the same registry (``observability/prom_bridge.py``):
a counter's family is named without its ``_total`` suffix and its
samples with it, a histogram's buckets are its cumulative ``le`` counts
followed by ``_count`` and ``_sum``, labels are sorted by name, and
numbers are spelled as Go spells them. :func:`family_text` takes a
``created`` map for series that carry a creation time, which
``prometheus_client`` writes as a ``<name>_created`` gauge family after
the family it belongs to.
"""

import math
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

#: the ``Content-Type`` of a scrape (``prometheus_client.CONTENT_TYPE_LATEST``)
CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def format_value(value) -> str:
    """A number as Go's ``strconv.FormatFloat`` spells it (the
    exposition's convention): ``+Inf``, ``NaN``, ``1.0``, ``1e+07``."""
    value = float(value)
    if value == math.inf:
        return "+Inf"
    if value == -math.inf:
        return "-Inf"
    if math.isnan(value):
        return "NaN"
    text = repr(value)
    dot = text.find(".")
    if value > 0 and dot > 6:
        mantissa = f"{text[0]}.{text[1:dot]}{text[dot + 1:]}".rstrip("0.")
        return f"{mantissa}e+0{dot - 1}"
    return text


def _escape(value: str) -> str:
    return str(value).replace("\\", r"\\").replace("\n", r"\n").replace('"', r"\"")


def _sample(name: str, labels: Mapping[str, str], value) -> str:
    if labels:
        inner = ",".join(f'{key}="{_escape(labels[key])}"' for key in sorted(labels))
        return f"{name}{{{inner}}} {format_value(value)}\n"
    return f"{name} {format_value(value)}\n"


def _header(name: str, description: str, kind: str) -> List[str]:
    help_text = description.replace("\\", r"\\").replace("\n", r"\n")
    return [f"# HELP {name} {help_text}\n", f"# TYPE {name} {kind}\n"]


def _label_key(labels: Mapping[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted(labels.items()))


def family_text(
    name: str,
    snap: dict,
    created: Optional[Mapping[Tuple[Tuple[str, str], ...], float]] = None,
) -> str:
    """One metric of a registry snapshot (``{"type", "description",
    "series"}``) as its exposition family; ``created`` maps a series'
    sorted label items to its creation time (seconds since the epoch)."""
    kind = snap["type"]
    description = snap.get("description") or name
    lines: List[str] = []
    base = name
    if kind == "counter":
        base = name[: -len("_total")] if name.endswith("_total") else name
        lines += _header(base + "_total", description, "counter")
        for series in snap["series"]:
            lines.append(_sample(base + "_total", series["labels"], series["value"]))
    elif kind == "gauge":
        lines += _header(name, description, "gauge")
        for series in snap["series"]:
            lines.append(_sample(name, series["labels"], series["value"]))
    elif kind == "histogram":
        lines += _header(name, description, "histogram")
        for series in snap["series"]:
            labels = series["labels"]
            buckets = list(series["buckets"].items())
            for bound, count in buckets:
                lines.append(_sample(name + "_bucket", {**labels, "le": bound}, count))
            lines.append(_sample(name + "_count", labels, buckets[-1][1] if buckets else 0))
            lines.append(_sample(name + "_sum", labels, series["sum"]))
    else:
        raise ValueError(f"Metric {name!r} has an unknown type {kind!r}")
    if created:
        lines += _header(base + "_created", description, "gauge")
        for series in snap["series"]:
            stamp = created.get(_label_key(series["labels"]))
            if stamp is not None:
                lines.append(_sample(base + "_created", series["labels"], stamp))
    return "".join(lines)


def registry_text(snapshot: Mapping[str, dict]) -> str:
    """Every metric of a registry snapshot, in registration order."""
    return "".join(family_text(name, snap) for name, snap in snapshot.items())


def info_text(name: str, description: str, labels: Mapping[str, str]) -> str:
    """An info metric (``prometheus_client.Info``): a gauge named
    ``<name>_info`` with the value 1 and the info as its labels."""
    full = name + "_info"
    return "".join(_header(full, description, "gauge")) + _sample(full, labels, 1.0)


def parse_samples(text: str) -> Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float]:
    """``{(sample name, sorted label items): value}`` of exposition text
    this module wrote (label values without ``,`` or ``"``): the reader
    ``chip_smoke.py`` and the tests use where ``prometheus_client`` is
    missing."""
    out: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float] = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        head, _, value = line.rpartition(" ")
        labels: Iterable[Tuple[str, str]] = ()
        if "{" in head:
            head, _, inner = head.partition("{")
            inner = inner.rstrip("}")
            labels = [
                (key, raw.strip('"'))
                for key, _, raw in (part.partition("=") for part in inner.split(",") if part)
            ]
        out[(head, tuple(sorted(labels)))] = float(value)
    return out
