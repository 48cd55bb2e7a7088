"""
The in-process metrics registry (the port of
``gordo_tpu.observability.registry``): ``Counter``, ``Gauge`` and
``Histogram`` with labels, thread-safe, snapshot to plain dicts.

Standard library only. The server writes a registry in the Prometheus
text format with :mod:`gordo_tpu_torch.observability.prom_text` (the
card's machine has no ``prometheus_client``). Names carry the
``gordo_`` prefix and counters end in ``_total``; label values are
low-cardinality (phase, endpoint, outcome), never raw paths. Names,
labels, default buckets and snapshot shape are the JAX registry's, so
the two packages' snapshots of the same observations are equal.
"""

import math
import re
import threading
import typing

_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*$")

#: Default histogram buckets: latency-flavored seconds, wide enough for
#: both sub-ms serving dispatches and multi-minute fleet fits.
DEFAULT_BUCKETS = (
    0.001, 0.005, 0.025, 0.1, 0.25, 1.0, 5.0, 30.0, 120.0, 600.0,
)


class _Metric:
    """Shared label plumbing for the three metric kinds."""

    kind = "untyped"

    def __init__(
        self,
        name: str,
        description: str,
        labelnames: typing.Tuple[str, ...],
        lock: threading.RLock,
    ):
        self.name = name
        self.description = description
        self.labelnames = labelnames
        self._lock = lock
        self._series: typing.Dict[typing.Tuple[str, ...], typing.Any] = {}

    def _key(self, labels: typing.Dict[str, typing.Any]) -> typing.Tuple[str, ...]:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"Metric {self.name!r} takes labels {self.labelnames}, "
                f"got {tuple(sorted(labels))}"
            )
        return tuple(str(labels[ln]) for ln in self.labelnames)

    def _label_dicts(
        self, key: typing.Tuple[str, ...]
    ) -> typing.Dict[str, str]:
        return dict(zip(self.labelnames, key))

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "type": self.kind,
                "description": self.description,
                "labelnames": list(self.labelnames),
                "series": [
                    {"labels": self._label_dicts(key), **self._series_value(value)}
                    for key, value in self._series.items()
                ],
            }

    def _series_value(self, value) -> dict:
        return {"value": value}

    def remove(self, **labels) -> None:
        """Drop one labeled series outright — for label values that
        leave the world entirely (a decommissioned replica id), where
        continuing to export the last value would report a ghost."""
        with self._lock:
            self._series.pop(self._key(labels), None)


class Counter(_Metric):
    """Monotonically increasing count."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"Counter {self.name!r} cannot decrease")
        key = self._key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + float(amount)

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._series.get(self._key(labels), 0.0))


class Gauge(_Metric):
    """A value that can go up and down (or be set outright)."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + float(amount)

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)

    def set_max(self, value: float, **labels) -> None:
        """Keep the running maximum — the watermark operation."""
        key = self._key(labels)
        with self._lock:
            current = self._series.get(key)
            if current is None or float(value) > current:
                self._series[key] = float(value)

    def value(self, **labels) -> typing.Optional[float]:
        with self._lock:
            got = self._series.get(self._key(labels))
            return None if got is None else float(got)


class Histogram(_Metric):
    """Cumulative-bucket histogram (Prometheus semantics)."""

    kind = "histogram"

    def __init__(self, name, description, labelnames, lock, buckets=None):
        super().__init__(name, description, labelnames, lock)
        bounds = tuple(sorted(float(b) for b in (buckets or DEFAULT_BUCKETS)))
        if not bounds:
            raise ValueError(f"Histogram {self.name!r} needs at least one bucket")
        self.buckets = bounds + (math.inf,)

    def observe(self, value: float, **labels) -> None:
        key = self._key(labels)
        value = float(value)
        with self._lock:
            state = self._series.get(key)
            if state is None:
                state = {"count": 0, "sum": 0.0, "buckets": [0] * len(self.buckets)}
                self._series[key] = state
            state["count"] += 1
            state["sum"] += value
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    state["buckets"][i] += 1

    def _series_value(self, state) -> dict:
        return {
            "count": state["count"],
            "sum": state["sum"],
            "buckets": {
                ("+Inf" if math.isinf(b) else repr(b)): state["buckets"][i]
                for i, b in enumerate(self.buckets)
            },
        }


class MetricsRegistry:
    """
    Get-or-create home for metrics. ``counter``/``gauge``/``histogram``
    are idempotent on (name, kind, labelnames): hot paths can call them
    per use without bookkeeping, and re-registration with a different
    shape fails loudly.
    """

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: typing.Dict[str, _Metric] = {}

    def _get_or_create(self, cls, name, description, labelnames, **kwargs):
        if not _NAME_RE.match(name):
            raise ValueError(f"Invalid metric name {name!r}")
        labelnames = tuple(labelnames)
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if not isinstance(existing, cls) or existing.labelnames != labelnames:
                    raise ValueError(
                        f"Metric {name!r} already registered as "
                        f"{existing.kind} with labels {existing.labelnames}"
                    )
                return existing
            metric = cls(name, description, labelnames, self._lock, **kwargs)
            self._metrics[name] = metric
            return metric

    def counter(
        self, name: str, description: str = "", labelnames: typing.Sequence[str] = ()
    ) -> Counter:
        return self._get_or_create(Counter, name, description, labelnames)

    def gauge(
        self, name: str, description: str = "", labelnames: typing.Sequence[str] = ()
    ) -> Gauge:
        return self._get_or_create(Gauge, name, description, labelnames)

    def histogram(
        self,
        name: str,
        description: str = "",
        labelnames: typing.Sequence[str] = (),
        buckets: typing.Optional[typing.Sequence[float]] = None,
    ) -> Histogram:
        return self._get_or_create(
            Histogram, name, description, labelnames, buckets=buckets
        )

    def snapshot(self) -> typing.Dict[str, dict]:
        """Every metric's current state as plain (JSON-able) dicts."""
        with self._lock:
            metrics = list(self._metrics.items())
        return {name: metric.snapshot() for name, metric in metrics}

    def reset(self) -> None:
        """Drop all metrics (test isolation)."""
        with self._lock:
            self._metrics.clear()

    def __contains__(self, name: str) -> bool:
        with self._lock:
            return name in self._metrics


#: The process-wide default registry every layer records into.
_DEFAULT_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide default registry."""
    return _DEFAULT_REGISTRY


# --------------------------------------------------------------------------
# shared histogram snapshot math
#
# The ONE home for deriving statistics from (and merging) the
# ``{count, sum, buckets}`` snapshot state above, so every reader of a
# snapshot (the rollup's merge among them) derives quantiles and merges
# the same way.
# --------------------------------------------------------------------------


class HistogramMergeError(ValueError):
    """Two histogram states disagree on bucket boundaries.

    Raised instead of guessing: summing counts across mismatched bucket
    layouts silently corrupts every quantile derived downstream."""


def _parse_bound(raw_bound) -> float:
    if str(raw_bound) in ("+Inf", "inf", "Infinity"):
        return math.inf
    return float(raw_bound)


def histogram_state(value) -> typing.Optional[dict]:
    """The ``{count, sum, buckets}`` dict inside ``value``, or None.

    Accepts a bare state, a snapshot wrapper (``{"type": "histogram",
    "series": [...]}`` as :meth:`_Metric.snapshot` emits, or the older
    ``"kind"`` spelling some persisted reports carry) whose first series
    either nests the state under ``"value"`` or inlines it, and nothing
    else.
    """
    if not isinstance(value, dict):
        return None
    if value.get("kind") == "histogram" or value.get("type") == "histogram":
        series = value.get("series") or []
        entry = series[0] if series else None
        if not isinstance(entry, dict):
            return None
        nested = entry.get("value")
        value = nested if isinstance(nested, dict) else entry
        if not isinstance(value, dict):
            return None
    if not {"count", "sum", "buckets"} <= set(value):
        return None
    return value


def histogram_quantile(state: dict, q: float) -> typing.Optional[float]:
    """The ``q`` quantile (0 < q <= 1) of a ``{count, sum, buckets}``
    state: the smallest bucket bound whose cumulative count covers
    ``q * count``. When that bound is +Inf — everything past the largest
    finite bucket — the mean is the honest (if coarse) stand-in."""
    count = state.get("count") or 0
    if not count:
        return None
    buckets = state.get("buckets")
    if not isinstance(buckets, dict) or not buckets:
        return None
    bounds = [
        (_parse_bound(raw_bound), float(cum))
        for raw_bound, cum in buckets.items()
    ]
    bounds.sort(key=lambda pair: pair[0])
    target = q * count
    for bound, cum in bounds:
        if cum >= target:
            if math.isinf(bound):
                return float(state["sum"]) / count
            return bound
    return None


def histogram_stat(state: dict, stat: str) -> typing.Optional[float]:
    """A named statistic of a ``{count, sum, buckets}`` state:
    ``"mean"``, ``"count"``, ``"sum"``, or any ``"pNN"`` quantile
    (``"p99"``, ``"p50"``, ``"p99.9"``)."""
    count = state.get("count") or 0
    if not count:
        return None
    if stat == "mean":
        return float(state["sum"]) / count
    if stat == "count":
        return float(count)
    if stat == "sum":
        return float(state["sum"])
    if stat.startswith("p"):
        try:
            q = float(stat[1:]) / 100.0
        except ValueError:
            return None
        if not 0.0 < q <= 1.0:
            return None
        return histogram_quantile(state, q)
    return None


def merge_histogram_states(a: dict, b: dict) -> dict:
    """Bucket-wise sum of two ``{count, sum, buckets}`` states.

    Refuses loudly (:class:`HistogramMergeError`) when the bucket
    boundaries differ — e.g. two replicas running different builds with
    different bucket layouts — rather than silently mis-merging.
    """
    bounds_a = sorted(_parse_bound(k) for k in a.get("buckets", {}))
    bounds_b = sorted(_parse_bound(k) for k in b.get("buckets", {}))
    if bounds_a != bounds_b:
        raise HistogramMergeError(
            f"Histogram bucket boundaries differ: {bounds_a} vs {bounds_b}"
        )
    order = sorted(a["buckets"], key=_parse_bound)
    by_bound_b = {_parse_bound(k): v for k, v in b["buckets"].items()}
    return {
        "count": int(a.get("count") or 0) + int(b.get("count") or 0),
        "sum": float(a.get("sum") or 0.0) + float(b.get("sum") or 0.0),
        "buckets": {
            key: int(a["buckets"][key]) + int(by_bound_b[_parse_bound(key)])
            for key in order
        },
    }
