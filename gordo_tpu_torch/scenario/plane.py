"""
The game-day plane (the port of ``gordo_tpu.scenario.plane``): one
in-process copy of the serving stack, sharded replicas behind the
router, a lifecycle manager over the same revision tree and a rollup
poller whose signals the scenario's SLO budget is judged by.

Everything is in one process: the replicas are the port's WSGI apps
mounted by host on a :class:`~gordo_tpu_torch.utils.http.WsgiTransport`,
which the router calls them through (its ``TRANSPORT``), and the client
reaches the router through another. The real router, the real stream
publisher and the real lifecycle promotion run against each other with
no socket and no subprocess. Killing a replica is one entry in the
transport's ``dead`` set (the router sees a refused connection, as from
a killed process); restarting it mounts a fresh app (a new catalog and
cache, the same artifacts). The replicas' models live on the plane's
device (the card unless ``device="cpu"``).

Telemetry: the members share one process registry, so the poller takes
it once (member ``process``), adds status-only replica members (alive
unless killed) and, for scenarios that tick the lifecycle, its
``last_tick.json``: the windowing of a deployment's rollup with nothing
counted twice.

The collection is JAX's feedforward-hourglass fleet of four machines,
built by the port's ``FleetModelBuilder``. It has no AOT program
manifest: the port has no program store (ROADMAP.md queue 1 item 9), so
``bump_jaxlib_manifest`` has nothing to edit and is refused.
"""

import logging
import os
import shutil
import threading
import time
from datetime import datetime, timedelta, timezone
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from gordo_tpu_torch.device import DeviceLike, resolve_device
from gordo_tpu_torch.observability import rollup as rollup_mod
from gordo_tpu_torch.utils.http import WsgiTransport

logger = logging.getLogger(__name__)

#: the fleet the game-day collection trains (small: a game day measures
#: the plane's behaviour, not the models' quality)
GAMEDAY_TAGS = [f"gd-tag-{i}" for i in range(3)]
GAMEDAY_MACHINES = [f"gd-m-{i}" for i in range(4)]
GAMEDAY_BASE_REVISION = "1700000000000"
GAMEDAY_PROJECT = "gameday"

_WINDOW_START = "2019-01-01T00:00:00+00:00"
_WINDOW_END = "2019-01-02T00:00:00+00:00"
#: the router's host on the client's transport
_ROUTER_HOST = "plane.test:80"
_ROWS_START = datetime(2019, 1, 1, tzinfo=timezone.utc)


class _EmptyRegistry:
    """The registry of a status-only member: every in-process member
    shares the process registry, which the ``process`` member already
    contributes."""

    def snapshot(self) -> dict:
        return {}


_EMPTY_REGISTRY = _EmptyRegistry()


def gameday_machine_configs(machines: Optional[Sequence[str]] = None) -> List[dict]:
    """The collection's machine configs (JAX's, by the JAX class paths,
    which the port's config layer reads)."""
    return [
        {
            "name": name,
            "project_name": GAMEDAY_PROJECT,
            "model": {
                "gordo_tpu.models.anomaly.DiffBasedAnomalyDetector": {
                    "base_estimator": {
                        "sklearn.pipeline.Pipeline": {
                            "steps": [
                                "sklearn.preprocessing.MinMaxScaler",
                                {
                                    "gordo_tpu.models.AutoEncoder": {
                                        "kind": "feedforward_hourglass",
                                        "epochs": 2,
                                        "batch_size": 16,
                                    }
                                },
                            ]
                        }
                    }
                }
            },
            "dataset": {
                "type": "RandomDataset",
                "train_start_date": _WINDOW_START,
                "train_end_date": _WINDOW_END,
                "tags": list(GAMEDAY_TAGS),
                "target_tag_list": list(GAMEDAY_TAGS),
                "asset": "gra",
            },
        }
        for name in (machines or GAMEDAY_MACHINES)
    ]


def build_gameday_collection(root: Union[str, os.PathLike],
                             machines: Optional[Sequence[str]] = None,
                             device: DeviceLike = None) -> str:
    """Train the game-day fleet once under ``root/models`` (the revision
    tree: ``<revision>/`` and a ``latest`` symlink); the ``models``
    directory."""
    from gordo_tpu_torch.builder.fleet_build import FleetModelBuilder
    from gordo_tpu_torch.cli.cli import load_fleet_machines

    specs = load_fleet_machines(gameday_machine_configs(machines))
    models = os.path.join(os.fspath(root), "models")
    revision_dir = os.path.join(models, GAMEDAY_BASE_REVISION)
    FleetModelBuilder(specs, fetch_backoff=lambda attempt: 0.0,
                      device=resolve_device(device)).build(output_dir_base=revision_dir)
    os.symlink(GAMEDAY_BASE_REVISION, os.path.join(models, "latest"))
    return models


def _frame_dict(rows: np.ndarray) -> dict:
    """Rows as the fleet route's ``{tag: {time: value}}`` frame, 10 minutes
    apart from 2019-01-01 UTC."""
    from gordo_tpu_torch.client.frames import frame_to_dict
    from gordo_tpu_torch.models.utils import Frame

    rows = np.asarray(rows, dtype="float64")
    index = [_ROWS_START + timedelta(minutes=10 * i) for i in range(len(rows))]
    return frame_to_dict(Frame(rows, list(GAMEDAY_TAGS), index))


class ScenarioPlane:
    """One scenario's plane over a shared trained collection, which it
    copies into ``workdir`` (promotions change the tree, and no scenario
    may see another's revisions)."""

    def __init__(self, collection_models: Union[str, os.PathLike],
                 workdir: Union[str, os.PathLike], replicas: int = 2,
                 device: DeviceLike = None):
        self.workdir = os.fspath(workdir)
        self.models = os.path.join(self.workdir, "models")
        shutil.copytree(os.fspath(collection_models), self.models, symlinks=True)
        self.pointer = os.path.join(self.models, "latest")
        self.fault_file = os.path.join(self.workdir, "faults.spec")
        self.rids = [f"r{i}" for i in range(int(replicas))]
        self.device = resolve_device(device)
        self.transport = WsgiTransport()
        self.apps: Dict[str, object] = {}
        self.router = None
        self._manager = None
        self._saved_env: Dict[str, Optional[str]] = {}
        self._lifecycle_member = False
        self.poller: Optional[rollup_mod.RollupPoller] = None

    # -- the plane's own lifecycle -------------------------------------------
    def start(self) -> None:
        from gordo_tpu_torch.robustness import faults
        from gordo_tpu_torch.router.app import RouterApp
        from gordo_tpu_torch.server.catalog import write_shard_manifest

        for var, value in (("MODEL_COLLECTION_DIR", self.pointer),
                           (faults.FAULT_INJECT_FILE_ENV_VAR, self.fault_file)):
            self._saved_env[var] = os.environ.get(var)
            os.environ[var] = value
        faults.reset()
        self.manifest = write_shard_manifest(
            os.path.join(self.workdir, "shard_manifest.json"), self.rids)
        for rid in self.rids:
            self._mount(rid)
        self.router = RouterApp({
            "REPLICAS": {rid: f"http://{rid}.test" for rid in self.rids},
            "TRANSPORT": self.transport,
            "COLLECTION_DIR": self.pointer,
            "PROBE_INTERVAL_S": 0,  # the window's end re-admits: no prober thread
            "BACKOFF_SCALE": 0.002,
            "EJECT_AFTER": 1,
        })
        local_members = {"process": self._process_member}
        for rid in self.rids:
            local_members[rid] = lambda rid=rid: self._replica_member(rid)
        self.poller = rollup_mod.RollupPoller(members=lambda: {}, interval_s=0.0,
                                              local_members=local_members, name="gameday")

    def _mount(self, rid: str) -> None:
        """A fresh replica process image: a new app, catalog and caches
        over the same artifacts."""
        from gordo_tpu_torch.server.app import build_app

        self.apps[rid] = build_app(self.pointer, device=self.device,
                                   shard_manifest=self.manifest, replica_id=rid)
        self.transport.mount(f"{rid}.test", self.apps[rid])

    def close(self) -> None:
        from gordo_tpu_torch.robustness import faults

        if self.router is not None:
            self.router.close()
            self.router = None
        for app in self.apps.values():
            app.catalog.stop()
        for var, value in self._saved_env.items():
            if value is None:
                os.environ.pop(var, None)
            else:
                os.environ[var] = value
        self._saved_env.clear()
        faults.reset()

    # -- telemetry members -----------------------------------------------------
    def _process_member(self) -> dict:
        return rollup_mod.snapshot_payload(role="router", replica_id="process",
                                           revision=self.revision())

    def _replica_member(self, rid: str) -> dict:
        alive = f"{rid}.test" not in self.transport.dead
        return rollup_mod.snapshot_payload(role="replica", replica_id=rid,
                                           revision=self.revision(),
                                           status={"status": "ok" if alive else "down"},
                                           registry=_EMPTY_REGISTRY)

    def _lifecycle_member_snapshot(self) -> dict:
        import json

        with open(os.path.join(self.models, ".lifecycle", "last_tick.json")) as fh:
            return json.load(fh)

    def enable_lifecycle_member(self) -> None:
        """Add the lifecycle's member (scenarios that tick); before the
        first tick writes ``last_tick.json`` it reads as a poll error."""
        if not self._lifecycle_member and self.poller is not None:
            self.poller.local_members["lifecycle"] = self._lifecycle_member_snapshot
            self._lifecycle_member = True

    def poll(self, now: Optional[float] = None) -> dict:
        """One rollup poll: the merged snapshot with its windowed
        ``signals`` (what ``slo.evaluate`` reads)."""
        return self.poller.poll_once(now=now)

    # -- state -------------------------------------------------------------------
    def revision(self) -> str:
        return os.path.basename(os.path.realpath(self.pointer))

    def machine_names(self) -> List[str]:
        current = os.path.realpath(self.pointer)
        return sorted(name for name in os.listdir(current)
                      if not name.startswith(".") and os.path.isdir(os.path.join(current, name)))

    # -- timeline actions --------------------------------------------------------
    def kill_replica(self, rid: str) -> None:
        if rid not in self.rids:
            raise ValueError(f"Unknown replica {rid!r}; have {self.rids}")
        self.transport.dead.add(f"{rid}.test")

    def restart_replica(self, rid: str) -> None:
        """A fresh process for one replica (its old app's batchers stop)."""
        if rid not in self.rids:
            raise ValueError(f"Unknown replica {rid!r}; have {self.rids}")
        old = self.apps.get(rid)
        self._mount(rid)
        if old is not None:
            old.catalog.stop()
        self.transport.dead.discard(f"{rid}.test")

    def lifecycle_manager(self):
        from gordo_tpu_torch.lifecycle import LifecycleConfig, LifecycleManager

        if self._manager is None:
            self._manager = LifecycleManager(self.pointer, config=LifecycleConfig(),
                                             device=self.device)
        return self._manager

    # -- clients -------------------------------------------------------------------
    def client(self, n_retries: int = 4):
        """The port's client, on its own in-process transport to the router."""
        from gordo_tpu_torch.client.client import Client

        transport = WsgiTransport()
        transport.mount(_ROUTER_HOST, self.router)
        host, port = _ROUTER_HOST.split(":")
        return Client(project=GAMEDAY_PROJECT, host=host, port=int(port), scheme="http",
                      transport=transport, n_retries=n_retries)

    def _fleet_post(self, machine: str, rows: np.ndarray):
        import json

        body = json.dumps({"machines": {machine: _frame_dict(rows)}}).encode()
        return self.router.dispatch("POST", f"/gordo/v0/{GAMEDAY_PROJECT}/prediction/fleet",
                                    body, headers={"Content-Type": "application/json"})

    def one_shot(self, machine: str, rows: np.ndarray) -> np.ndarray:
        """The bit-identity reference: one fleet POST of the whole
        window through the router; its ``model-output`` as float32."""
        import json

        from gordo_tpu_torch.client.frames import frame_from_reply

        response = self._fleet_post(machine, rows)
        if response.status != 200:
            raise RuntimeError(
                f"one-shot reference failed ({response.status}): {response.body[:300]!r}")
        payload = json.loads(response.body)["data"][machine]
        return np.asarray(frame_from_reply(payload)["model-output"], dtype="float32")

    def fleet_post(self, machine: str, rows: np.ndarray) -> int:
        """One client's one-shot request; its HTTP status (200 and 503 are
        structured outcomes)."""
        return self._fleet_post(machine, rows).status


_GAMEDAY_COLLECTION_CACHE: Dict[str, str] = {}
_GAMEDAY_COLLECTION_LOCK = threading.Lock()


def shared_gameday_collection(root: Union[str, os.PathLike], device: DeviceLike = None) -> str:
    """Build (once a ``root``) the ``models`` tree the scenarios' planes
    copy from: a run of five scenarios trains once."""
    key = os.fspath(root)
    with _GAMEDAY_COLLECTION_LOCK:
        cached = _GAMEDAY_COLLECTION_CACHE.get(key)
    if cached and os.path.isdir(cached):
        return cached
    started = time.time()
    logger.info("Building gameday collection under %s", key)
    models = build_gameday_collection(key, device=device)
    logger.info("Gameday collection ready in %.1fs", time.time() - started)
    with _GAMEDAY_COLLECTION_LOCK:
        _GAMEDAY_COLLECTION_CACHE[key] = models
    return models
