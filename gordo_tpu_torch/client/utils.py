"""
Client support (the port of ``gordo_tpu.client.utils``): the per-machine
result record, small thread-safe caches, the retry delays (the JAX
module's ``random`` draws, so a seeded schedule is the same in both
packages) and the Influx URI parser. Writing to Influx needs the
``influxdb`` package, which the card's machine lacks:
:func:`influx_client_from_uri` raises, naming it.
"""

import random
import threading
import time
from collections import OrderedDict
from functools import wraps
from typing import Optional, Tuple


class PredictionResult(tuple):
    """
    A machine's prediction outcome: a 3-tuple that unpacks, indexes and
    compares as ``(name, predictions, error_messages)``, with
    ``revision`` beside the tuple: the revision the server stamped on the
    replies that made the frame, or None when no reply carried one or
    chunks were served by different revisions.
    """

    def __new__(cls, name, predictions, error_messages, revision=None):
        self = super().__new__(cls, (name, predictions, error_messages))
        self.revision = revision
        return self

    def __reduce__(self):
        # tuple's default pickling would pass the whole 3-tuple as ONE
        # __new__ argument (and drop .revision); rebuild from the four
        # real fields so pickle/copy round-trip like the namedtuple did
        return (self.__class__, (*self, self.revision))

    @property
    def name(self):
        return self[0]

    @property
    def predictions(self):
        return self[1]

    @property
    def error_messages(self):
        return self[2]

    def __repr__(self):
        return (
            f"PredictionResult(name={self[0]!r}, predictions={self[1]!r}, "
            f"error_messages={self[2]!r}, revision={self.revision!r})"
        )


class _BoundedCache:
    """LRU cache with optional per-entry TTL, guarded by a lock."""

    def __init__(self, maxsize: int, ttl: Optional[float] = None):
        self.maxsize = maxsize
        self.ttl = ttl
        self._data: "OrderedDict" = OrderedDict()
        self._lock = threading.Lock()

    def get(self, key, default=None):
        with self._lock:
            if key not in self._data:
                return default
            value, stamp = self._data[key]
            if self.ttl is not None and time.monotonic() - stamp > self.ttl:
                del self._data[key]
                return default
            self._data.move_to_end(key)
            return value

    def put(self, key, value):
        with self._lock:
            self._data[key] = (value, time.monotonic())
            self._data.move_to_end(key)
            while len(self._data) > self.maxsize:
                self._data.popitem(last=False)

    def clear(self):
        with self._lock:
            self._data.clear()


_CACHE_MISS = object()


#: Default jitter fraction for retrying call sites (client POST loops):
#: each delay lands uniformly in [base*(1-0.25), base], so a fleet of
#: clients kicked loose by one flapped server desynchronizes instead of
#: re-arriving as a thundering herd on the exact 8/16/32s marks.
DEFAULT_RETRY_JITTER = 0.25

#: Process-wide jitter stream; reseed with :func:`seed_backoff_jitter`
#: for deterministic schedules (tests, reproducible chaos runs).
_jitter_rng = random.Random()


def seed_backoff_jitter(seed: Optional[int]) -> None:
    """Reseed the shared backoff-jitter stream (None = OS entropy)."""
    global _jitter_rng
    _jitter_rng = random.Random(seed)


def backoff_seconds(
    attempt: int,
    cap: int = 300,
    jitter: float = 0.0,
    rng: Optional[random.Random] = None,
) -> float:
    """
    Shared retry policy: exponential backoff starting at 8s, capped.

    ``jitter`` (fraction in [0, 1]) spreads the delay uniformly over
    ``[base*(1-jitter), base]`` — retrying herds decorrelate while the
    cap is still honored. The stream is the module's seedable RNG
    (:func:`seed_backoff_jitter`) unless ``rng`` overrides it, so tests
    get deterministic schedules.

    >>> [backoff_seconds(n) for n in (1, 2, 3, 7)]
    [8, 16, 32, 300]
    >>> seed_backoff_jitter(42)
    >>> a = backoff_seconds(1, jitter=0.25)
    >>> seed_backoff_jitter(42)
    >>> a == backoff_seconds(1, jitter=0.25) and 6.0 <= a <= 8.0
    True
    """
    base = min(2 ** (attempt + 2), cap)
    if not jitter:
        return base
    source = rng if rng is not None else _jitter_rng
    return base * (1.0 - jitter * source.random())


def retry_after_seconds(
    retry_after: float,
    jitter: float = 0.0,
    rng: Optional[random.Random] = None,
) -> float:
    """
    Server-directed backoff: a shedding server's ``Retry-After`` is the
    FLOOR — ``jitter``
    (fraction in [0, 1]) spreads the delay uniformly over
    ``[base, base*(1+jitter)]``, i.e. ABOVE the advertised window, so a
    shed herd does not re-arrive in lockstep the moment it closes. Same
    seedable stream as :func:`backoff_seconds`.

    >>> retry_after_seconds(2)
    2.0
    >>> seed_backoff_jitter(7)
    >>> a = retry_after_seconds(2, jitter=0.25)
    >>> seed_backoff_jitter(7)
    >>> a == retry_after_seconds(2, jitter=0.25) and 2.0 <= a <= 2.5
    True
    """
    base = max(0.0, float(retry_after))
    if not jitter:
        return base
    source = rng if rng is not None else _jitter_rng
    return base * (1.0 + jitter * source.random())


def cached_method(maxsize: int = 128, ttl: Optional[float] = None):
    """
    Decorator: per-instance memoization of a method on its positional and
    keyword arguments (the client's revision and model listings with a
    TTL, its machine metadata by LRU).
    """

    def decorator(fn):
        attr = f"_cache_{fn.__name__}"
        creation_lock = threading.Lock()

        @wraps(fn)
        def wrapper(self, *args, **kwargs):
            cache = getattr(self, attr, None)
            if cache is None:
                # Atomic creation: concurrent first calls (the client fans
                # metadata fetches over a thread pool) must share one cache.
                with creation_lock:
                    cache = getattr(self, attr, None)
                    if cache is None:
                        cache = _BoundedCache(maxsize=maxsize, ttl=ttl)
                        setattr(self, attr, cache)
            key = (args, tuple(sorted(kwargs.items())))
            value = cache.get(key, _CACHE_MISS)
            if value is _CACHE_MISS:
                value = fn(self, *args, **kwargs)
                cache.put(key, value)
            return value

        return wrapper

    return decorator


def parse_influx_uri(uri: str) -> Tuple[str, str, str, str, str, str]:
    """
    ``<username>:<password>@<host>:<port>/<optional-path>/<db_name>`` →
    (username, password, host, port, path, db_name).

    Examples
    --------
    >>> parse_influx_uri("admin:pw@localhost:8086/gordo")
    ('admin', 'pw', 'localhost', '8086', '', 'gordo')
    >>> parse_influx_uri("u:p@h:80/api/v1/db")
    ('u', 'p', 'h', '80', 'api/v1', 'db')
    """
    username, password, host, port, *path, db_name = (
        uri.replace("/", ":").replace("@", ":").split(":")
    )
    return username, password, host, port, "/".join(path), db_name


def influx_client_from_uri(uri: str, *args, **kwargs):
    """Refused: an Influx client needs the ``influxdb`` package, which
    the port does not use (ROADMAP.md queue 3 item 1 (j))."""
    raise ImportError(
        "Forwarding to Influx needs the 'influxdb' package, which this port "
        "does not use; forward predictions with another PredictionForwarder"
    )
