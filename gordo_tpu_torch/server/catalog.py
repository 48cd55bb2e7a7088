"""
The serving catalog (the port of ``gordo_tpu.server.catalog``): per-
process serving state for any number of revision directories, shared by
every request thread.

- :class:`CollectionView`, which holds no model and needs no card (the
  router uses it alone): ``build_report.json`` of a revision, cached by
  its mtime, the machines it records as casualties
  (:meth:`CollectionView.unavailable_machines`), the revision's machines,
  and the replica's shard (:class:`ShardSpec`): the machines it owns and
  the structured 421 for those it does not (:meth:`CollectionView.refuse_wrong_shard`);
- the fleet scorers, an LRU keyed by (real revision directory, machine
  names) and bounded by ``scorer_cache_size``; the server asks for one
  over a revision's servable machines, whatever subset a request names,
  so each group's weights are stacked once;
- the request batchers, one for each scorer key, rebuilt when the key's
  scorer changed and stopped when evicted, or when the ``latest`` symlink
  rolled to another revision (:meth:`ServingCatalog.stop_stale_batchers`);
- the stream sessions (``streaming/session.py``), expired on such a roll
  (:meth:`ServingCatalog.expire_stale_streams`).

A shard manifest (:func:`write_shard_manifest`) is three JSON keys,
``replicas``, ``vnodes`` and optionally ``replica_id``: every process
given the same one computes the same machine-to-replica map
(``gordo_tpu_torch.router.ring``).

Locks are held for dictionary reads and writes only, never while a scorer
is built. Left out: AOT program stores (ROADMAP.md queue 1 item 9).
"""

import json
import logging
import os
import threading
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from gordo_tpu_torch.device import DeviceLike
from gordo_tpu_torch.router.ring import DEFAULT_VNODES, HashRing
from gordo_tpu_torch.server import batching
from gordo_tpu_torch.server.utils import ApiError
from gordo_tpu_torch.streaming import session as stream_session
from gordo_tpu_torch.utils.atomic import atomic_write_json

logger = logging.getLogger(__name__)

#: the casualty record the fleet builder writes next to the artifacts
BUILD_REPORT_FILENAME = "build_report.json"
#: the request header by which the router tells a sharded replica to serve
#: machines outside its shard (failover, hedging): deliberate adoption
ADOPT_HEADER = "X-Gordo-Shard-Adopt"


class ShardSpec:
    """This replica's place on the ring: ``(replica_id, replicas,
    vnodes)``."""

    def __init__(self, replica_id: str, replicas: Sequence[str], vnodes: int = DEFAULT_VNODES):
        if replica_id not in replicas:
            raise ValueError(
                f"replica_id {replica_id!r} is not in the replica set {sorted(replicas)}"
            )
        self.replica_id = replica_id
        self.ring = HashRing(replicas, vnodes)

    @classmethod
    def load(cls, path: str, replica_id: Optional[str] = None) -> "ShardSpec":
        """A shard manifest's spec; ``replica_id`` (``--replica-id``,
        ``GORDO_REPLICA_ID``) overrides the manifest's own, so one shared
        manifest serves every replica."""
        with open(path) as fh:
            manifest = json.load(fh)
        rid = replica_id or manifest.get("replica_id")
        if not rid:
            raise ValueError(
                f"Shard manifest {path} names no replica_id and none was given "
                "(--replica-id / GORDO_REPLICA_ID)"
            )
        replicas = manifest.get("replicas")
        if not replicas or not isinstance(replicas, list):
            raise ValueError(f"Shard manifest {path} must carry a non-empty 'replicas' list")
        return cls(str(rid), [str(r) for r in replicas],
                   int(manifest.get("vnodes") or DEFAULT_VNODES))

    def owner(self, machine_name: str) -> str:
        return self.ring.owner(machine_name)

    def owns(self, machine_name: str) -> bool:
        return self.ring.owner(machine_name) == self.replica_id

    def to_dict(self) -> dict:
        return {"replica_id": self.replica_id, "replicas": list(self.ring.replicas),
                "vnodes": self.ring.vnodes}


def write_shard_manifest(path: str, replicas: Sequence[str], vnodes: int = DEFAULT_VNODES,
                         replica_id: Optional[str] = None) -> str:
    """Write a shard manifest at ``path`` (atomically: every replica reads
    it at startup)."""
    manifest: Dict[str, Any] = {"replicas": list(replicas), "vnodes": int(vnodes)}
    if replica_id is not None:
        manifest["replica_id"] = replica_id
    atomic_write_json(path, manifest, indent=2, sort_keys=True)
    return path


def _evict_lru(cache: Dict, size: int, on_evict: Optional[Callable] = None) -> None:
    """Drop the oldest entries of an insertion-ordered dict down to ``size``."""
    while len(cache) > max(1, size):
        key = next(iter(cache))
        value = cache.pop(key)
        if on_evict is not None:
            on_evict(value)


class CollectionView:
    """What a process knows of a collection from its directory alone: the
    build report's casualties, the machines, and this replica's shard
    (None: the whole collection). It holds no model and no device."""

    def __init__(self, shard: Optional[ShardSpec] = None):
        self.shard = shard
        # realpath(report) -> (mtime, report)
        self._build_reports: Dict[str, tuple] = {}
        self._build_reports_lock = threading.Lock()

    def owned_machines(self, collection_dir: str) -> Optional[List[str]]:
        """The machines this replica's shard owns, or None unsharded."""
        if self.shard is None:
            return None
        return [name for name in self.list_machines(collection_dir) if self.shard.owns(name)]

    def refuse_wrong_shard(self, names: Iterable[str], adopt: bool) -> None:
        """421 (Misdirected Request) naming each machine's owner when a
        sharded replica is asked for machines the ring gives another,
        unless ``adopt`` (the router's ``ADOPT_HEADER``) says it routed
        them here on purpose."""
        if self.shard is None or adopt:
            return
        not_mine = {name: {"owner": self.shard.owner(name)} for name in names
                    if not self.shard.owns(name)}
        if not_mine:
            raise ApiError(
                {
                    "error": "Machine(s) not in this replica's shard: "
                    + ", ".join(f"{name} (owner {info['owner']})"
                                for name, info in sorted(not_mine.items())),
                    "wrong_shard": not_mine,
                    "replica_id": self.shard.replica_id,
                },
                421,
            )

    # -- casualties ----------------------------------------------------------
    def build_report(self, collection_dir: str) -> dict:
        """The revision's ``build_report.json`` ({} when there is none),
        parsed again only when its mtime changes."""
        path = os.path.join(collection_dir, BUILD_REPORT_FILENAME)
        try:
            mtime = os.path.getmtime(path)
        except OSError:
            return {}
        key = os.path.realpath(path)
        with self._build_reports_lock:
            cached = self._build_reports.get(key)
        if cached is not None and cached[0] == mtime:
            return cached[1]
        try:
            with open(path) as fh:
                report = json.load(fh)
        except (OSError, ValueError):
            logger.warning("Unreadable build report at %s; ignoring", path)
            report = {}
        with self._build_reports_lock:
            self._build_reports[key] = (mtime, report)
        return report

    def unavailable_machines(self, collection_dir: str) -> Dict[str, dict]:
        """The machines the build recorded as casualties: failed in a
        phase (no usable artifact) or quarantined (an artifact of frozen
        last finite weights), with their reasons."""
        report = self.build_report(collection_dir)
        out: Dict[str, dict] = {}
        for record in report.get("failed") or []:
            name = record.get("machine")
            if name:
                out[name] = {
                    "reason": f"{record.get('phase', 'build')}_failed",
                    "error": record.get("error"),
                    "attempts": record.get("attempts"),
                }
        for record in report.get("quarantined") or []:
            name = record.get("machine")
            if name:
                out[name] = {"reason": "quarantined", "epoch": record.get("epoch")}
        return out

    @staticmethod
    def list_machines(collection_dir: str) -> List[str]:
        """The revision's artifact directories (dot entries and loose
        files are not machines)."""
        try:
            return sorted(
                name
                for name in os.listdir(collection_dir)
                if not name.startswith(".") and os.path.isdir(os.path.join(collection_dir, name))
            )
        except FileNotFoundError:
            return []

    def servable_machines(self, collection_dir: str) -> Tuple[str, ...]:
        """The revision's machines (a sharded replica's: its shard's) less
        its build's casualties."""
        unavailable = self.unavailable_machines(collection_dir)
        owned = self.owned_machines(collection_dir)
        machines = self.list_machines(collection_dir) if owned is None else owned
        return tuple(n for n in machines if n not in unavailable)


class ServingCatalog(CollectionView):
    """The collection view with the device's serving state: fleet
    scorers, batchers and stream sessions (module note), on ``device``
    (the card unless ``"cpu"`` is asked for)."""

    def __init__(self, scorer_cache_size: int = 16, batch_wait_s: float = 0.0,
                 batch_queue_limit: int = 64,
                 stream_max_sessions: int = stream_session.DEFAULT_MAX_SESSIONS,
                 stream_max_backlog: int = stream_session.DEFAULT_MAX_BACKLOG,
                 stream_idle_after_s: float = stream_session.DEFAULT_IDLE_AFTER_S,
                 device: DeviceLike = None, shard: Optional[ShardSpec] = None):
        super().__init__(shard)
        self.scorer_cache_size = int(scorer_cache_size)
        self.batch_wait_s = float(batch_wait_s)
        self.batch_queue_limit = int(batch_queue_limit)
        # stream windows live on the serving device, whose free memory
        # governs how many sessions the table keeps
        self.streams = stream_session.SessionManager(
            max_sessions=stream_max_sessions, max_backlog=stream_max_backlog,
            idle_after_s=stream_idle_after_s, device=device,
        )
        # (realpath(revision dir), names) -> (scorer, prefixes, fallback)
        self._fleet_scorers: Dict[tuple, tuple] = {}
        self._fleet_scorers_lock = threading.Lock()
        self._batchers: Dict[tuple, batching.RequestBatcher] = {}
        self._batchers_lock = threading.Lock()

    # -- fleet scorers -------------------------------------------------------
    def fleet_scorer(
        self,
        collection_dir: str,
        names: Tuple[str, ...],
        load_model: Callable[[str], Any],
    ) -> tuple:
        """(scorer, prefixes, fallback) over ``names`` in this revision,
        built on a miss from ``load_model`` of each name; a machine that
        does not load is left out with a warning (a request naming it
        meets its own error). Two first requests for one key may both
        build; the last insert stays."""
        from gordo_tpu_torch.server.fleet_serving import fleet_scorer_from_models

        key = (os.path.realpath(collection_dir), tuple(names))
        with self._fleet_scorers_lock:
            cached = self._fleet_scorers.pop(key, None)
            if cached is not None:
                self._fleet_scorers[key] = cached  # most recently used
                return cached
        models = {}
        for name in names:
            try:
                models[name] = load_model(name)
            except Exception as err:
                logger.warning("Fleet scorer of %s: leaving out %s (%s)", collection_dir, name, err)
        built = fleet_scorer_from_models(models)
        with self._fleet_scorers_lock:
            self._fleet_scorers.pop(key, None)
            self._fleet_scorers[key] = built
            _evict_lru(self._fleet_scorers, self.scorer_cache_size)
        return built

    # -- batchers ------------------------------------------------------------
    def batcher(self, key: tuple, scorer) -> batching.RequestBatcher:
        """The live batcher of ``key``, rebuilt when the key's scorer
        changed; as many as scorers are kept, an evicted one stopped."""
        with self._batchers_lock:
            existing = self._batchers.pop(key, None)
            if existing is not None and existing.scorer is scorer and not existing.stopped:
                self._batchers[key] = existing
                return existing
            if existing is not None:
                existing.stop()
            batcher = batching.RequestBatcher(scorer, self.batch_wait_s, self.batch_queue_limit)
            self._batchers[key] = batcher
            _evict_lru(self._batchers, self.scorer_cache_size, on_evict=lambda b: b.stop())
            return batcher

    def batcher_stats(self) -> List[dict]:
        with self._batchers_lock:
            batchers = list(self._batchers.values())
        return [b.stats() for b in batchers]

    def stop_stale_batchers(self, keep_collection_dir: str) -> int:
        """Stop and drop every batcher of another revision than
        ``keep_collection_dir`` (a real path): the ``latest`` symlink
        rolled. How many were stopped."""
        with self._batchers_lock:
            stale = [self._batchers.pop(key) for key in list(self._batchers)
                     if key[0] != keep_collection_dir]
        for batcher in stale:
            batcher.stop()
        return len(stale)

    # -- stream sessions -----------------------------------------------------
    def stream_stats(self) -> List[dict]:
        return self.streams.stats()

    def expire_stale_streams(self, keep_collection_dir: str) -> int:
        """Expire every stream session of another revision: its next
        update answers the resume contract, and the client opens a new
        session on the revision now served."""
        return self.streams.expire_stale(keep_collection_dir)

    def stop(self) -> None:
        """Stop every batcher (the app is shutting down)."""
        with self._batchers_lock:
            batchers = list(self._batchers.values())
            self._batchers.clear()
        for b in batchers:
            b.stop(join=True)
