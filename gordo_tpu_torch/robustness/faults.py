"""
Env-driven fault injection (the port of ``gordo_tpu.robustness.faults``):
the chaos harness the lifecycle's tests and ``chip_smoke.py`` drive.

``GORDO_FAULT_INJECT`` holds a ``;``-separated list of fault specs::

    GORDO_FAULT_INJECT="fetch:raise:machine-3;refit:nan:machine-7@epoch:0;promote:torn"

One spec is ``site:mode[:target][@key:value ...]``, the JAX grammar:

- ``site``: where the seam lives. The port wires ``fetch`` (a machine's
  dataset fetch in the fleet builder), ``train`` (the fleet trainer's
  epoch loss), ``ckpt`` (a fleet checkpoint's write), ``serve`` (the
  server's prediction routes: an injected fault answers 503), ``batch``
  (the batcher's drainer: the request naming the machine fails alone,
  its batch-mates are scored), the lifecycle's ``drift`` (the drift
  scan's fetched window), ``refit`` (the warm-start refit) and
  ``promote`` (revision assembly), the multi-worker ledger's ``worker``
  (``worker:die:<stage>``: the worker process exits on the spot at
  ``fetch``, ``train`` or ``commit``, scoped by ``@worker:<id>`` against
  ``GORDO_WORKER_ID``) and ``lease`` (``lease:stall:<worker-id>``: the
  worker stops heartbeating without dying, so its lease is stolen while
  it builds), ``precision`` (``precision:degrade:<machine>``: the
  machine's bf16 calibration is forced to fail, so it stays float32),
  ``replica`` (the router's call to a replica, :func:`replica_fault_action`)
  and ``stream`` (the top of a stream update, :func:`stream_fault_action`).
  The JAX grammar's ``program`` site (the AOT executable store) stays out
  of the port with ``programs/``: a spec naming it raises ``ValueError``
  when it is parsed (ROADMAP.md queue 1 item 9), so a chaos run never
  injects nothing in silence.
- ``mode``: ``raise`` (the seam raises :class:`InjectedFault`), ``nan``
  (train/refit: the named machine's epoch loss goes NaN at
  ``@epoch:<e>``, which drives the trainer's quarantine guard),
  ``shift`` (drift: the named machine's fetched inputs and targets are
  offset by ``@scale:<s>``, default 5.0), ``degrade`` (refit: the
  candidate's weights are multiplied by ``@scale:<s>``, default 10.0,
  before shadow scoring; precision: the calibration fails), ``torn``
  (promote: revision assembly dies mid-copy and leaves its dot-prefixed
  staging directory; ckpt: the largest file of the checkpoint just
  written is cut to half its size), ``die`` (worker, replica),
  ``stall`` (lease, stream), ``slow`` and ``flap`` (replica), ``drop``
  and ``burst`` (stream).
- ``target``: a machine name (or a bare fleet index when the seam has no
  names); omitted means any machine at that site.
- ``@key:value``: ``@epoch:E``, ``@scale:S``, ``@ms:M`` (replica
  ``slow``, stream ``stall``), ``@burst:K`` (replica ``flap``),
  ``@rate:R`` (stream ``burst``), and ``@attempts:N`` (fail only the
  first N firings, then pass: the retry path).

Every firing emits a ``fault_injected`` event
(:mod:`gordo_tpu_torch.observability.events`) and adds one to the
registry's ``gordo_fault_fired_total{site}``.

``GORDO_FAULT_INJECT_FILE`` names a file whose content is the same spec
string, re-read whenever its (mtime, size) changes, so a running process
can be armed and disarmed (:func:`arm_file`, :func:`disarm_file`);
``GORDO_FAULT_INJECT`` wins when both are set. With neither set, every
seam is two ``os.environ.get`` calls and nothing else: no parsing, no
state, no file-system access. Parsed registries are cached per spec
string and hold the fire counts; :func:`reset` drops them, so
``@attempts`` budgets start afresh.
"""

import dataclasses
import logging
import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from gordo_tpu_torch.observability.events import emit_event
from gordo_tpu_torch.observability.registry import get_registry

logger = logging.getLogger(__name__)

FAULT_INJECT_ENV_VAR = "GORDO_FAULT_INJECT"
#: a path whose content is the spec string, re-checked by mtime and size
FAULT_INJECT_FILE_ENV_VAR = "GORDO_FAULT_INJECT_FILE"

#: the worker identity the ``worker`` and ``lease`` seams match
#: ``@worker`` against: the multi-worker ledger sets it, and the workers
#: an orchestrator spawns inherit it
WORKER_ID_ENV_VAR = "GORDO_WORKER_ID"

#: the sites whose seams the port has
WIRED_SITES = frozenset(
    {"fetch", "train", "ckpt", "serve", "batch", "drift", "refit", "promote", "worker",
     "lease", "precision", "replica", "stream"}
)
#: the JAX grammar's other site: parsed only to be refused (the AOT
#: executable store stays out of the port with ``programs/``)
UNWIRED_SITES = frozenset({"program"})


class InjectedFault(RuntimeError):
    """Raised by a seam when a matching ``raise``-mode fault fires."""


@dataclasses.dataclass
class FaultSpec:
    """One parsed entry of a ``GORDO_FAULT_INJECT`` string."""

    site: str
    mode: str
    target: Optional[str] = None
    params: Dict[str, str] = dataclasses.field(default_factory=dict)
    #: times this spec has fired (under the registry's lock)
    fires: int = 0

    def param_int(self, key: str, default: int = 0) -> int:
        try:
            return int(self.params.get(key, default))
        except (TypeError, ValueError):
            raise ValueError(
                f"Fault spec parameter @{key} must be an integer, got {self.params.get(key)!r}"
            )

    def matches_target(self, name: Optional[str]) -> bool:
        """No target: any machine; else the exact name (or index)."""
        if self.target is None:
            return True
        return name is not None and str(name) == self.target

    def exhausted(self) -> bool:
        """An ``@attempts:N`` spec that has fired N times."""
        attempts = self.param_int("attempts", 0)
        return bool(attempts) and self.fires >= attempts


def parse_spec(spec_string: str) -> List[FaultSpec]:
    """
    Parse the ``GORDO_FAULT_INJECT`` grammar. An unknown site raises, and
    so does a site of the JAX grammar that the port does not wire yet.
    """
    specs: List[FaultSpec] = []
    for raw in spec_string.split(";"):
        raw = raw.strip()
        if not raw:
            continue
        head, *param_parts = raw.split("@")
        fields = head.strip().split(":")
        if len(fields) < 2 or len(fields) > 3:
            raise ValueError(f"Bad fault spec {raw!r}: expected site:mode[:target]")
        site, mode = fields[0].strip(), fields[1].strip()
        if site in UNWIRED_SITES:
            raise ValueError(
                f"Bad fault spec {raw!r}: site {site!r} has no seam in gordo_tpu_torch: the "
                "AOT program store (programs/) stays out of the port (ROADMAP.md queue 1 "
                f"item 9); the port wires {sorted(WIRED_SITES)}"
            )
        if site not in WIRED_SITES:
            raise ValueError(
                f"Bad fault spec {raw!r}: unknown site {site!r} "
                f"(known: {sorted(WIRED_SITES | UNWIRED_SITES)})"
            )
        target = fields[2].strip() if len(fields) == 3 else None
        params: Dict[str, str] = {}
        for part in param_parts:
            key, sep, value = part.strip().partition(":")
            if not sep:
                raise ValueError(f"Bad fault spec {raw!r}: parameter {part!r} is not key:value")
            params[key.strip()] = value.strip()
        specs.append(FaultSpec(site=site, mode=mode, target=target, params=params))
    return specs


class FaultRegistry:
    """The parsed specs of one spec string."""

    def __init__(self, specs: List[FaultSpec]):
        self.specs = specs
        self._lock = threading.Lock()

    def find(self, site: str, name: Optional[str] = None,
             mode: Optional[str] = None) -> Optional[FaultSpec]:
        """The first spec of ``site`` (and ``mode``, when given) matching
        ``name``."""
        for spec in self.specs:
            if (spec.site == site and (mode is None or spec.mode == mode)
                    and spec.matches_target(name)):
                return spec
        return None

    def fire(self, spec: FaultSpec, **fields) -> int:
        """Count one firing and emit its ``fault_injected`` event; returns
        the 1-based firing number."""
        with self._lock:
            spec.fires += 1
            count = spec.fires
        _count_fired(spec.site)
        emit_event("fault_injected", site=spec.site, mode=spec.mode, target=spec.target,
                   fire_count=count, **fields)
        return count


def _count_fired(site: str) -> None:
    """One more ``gordo_fault_fired_total{site}``: the event's twin in the
    registry, which a game day reads as deltas."""
    get_registry().counter(
        "gordo_fault_fired_total", "Chaos fault firings by injection site", ("site",),
    ).inc(site=site)


#: spec string -> registry (the fire counts live on its specs)
_registries: Dict[str, FaultRegistry] = {}
#: fault file path -> (mtime_ns, size, registry or None)
_file_registries: Dict[str, Tuple[int, int, Optional[FaultRegistry]]] = {}
_registries_lock = threading.Lock()


def reset() -> None:
    """Drop every cached registry and its fire counts: the boundary
    between two scenarios that reuse one spec string in one process."""
    with _registries_lock:
        _registries.clear()
        _file_registries.clear()


def _file_registry(path: str) -> Optional[FaultRegistry]:
    """The registry of the fault file's current content; a missing or
    empty file is disarmed (None)."""
    try:
        stat = os.stat(path)
        fingerprint = (stat.st_mtime_ns, stat.st_size)
    except OSError:
        fingerprint = (-1, -1)
    with _registries_lock:
        cached = _file_registries.get(path)
        if cached is not None and (cached[0], cached[1]) == fingerprint:
            return cached[2]
        registry = None
        if fingerprint != (-1, -1):
            try:
                with open(path) as fh:
                    value = fh.read().strip()
            except OSError:
                value = ""
            if value:
                registry = FaultRegistry(parse_spec(value))
        _file_registries[path] = (*fingerprint, registry)
    return registry


def arm_file(path: Union[str, os.PathLike], spec_string: str) -> None:
    """Arm (or re-arm) the fault file at ``path`` with ``spec_string``,
    parsed first so that a bad spec fails here; written by rename, so a
    seam reads the old spec or the new one. Re-arming restarts the
    ``@attempts`` budgets."""
    parse_spec(spec_string)
    path = os.fspath(path)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as fh:
        fh.write(spec_string)
    os.replace(tmp, path)
    # a rewrite within one mtime tick would keep the old fingerprint
    with _registries_lock:
        _file_registries.pop(path, None)


def disarm_file(path: Union[str, os.PathLike]) -> None:
    """Disarm every spec of the fault file (empty it)."""
    arm_file(path, "")


def active_registry() -> Optional[FaultRegistry]:
    """The registry of the current settings, or None when neither
    variable is set: the check every seam starts with."""
    value = os.environ.get(FAULT_INJECT_ENV_VAR)
    if value:
        with _registries_lock:
            registry = _registries.get(value)
            if registry is None:
                registry = _registries[value] = FaultRegistry(parse_spec(value))
        return registry
    path = os.environ.get(FAULT_INJECT_FILE_ENV_VAR)
    if not path:
        return None
    return _file_registry(path)


# -- seams ---------------------------------------------------------------------


def inject(site: str, name: Optional[str] = None, **fields) -> None:
    """The ``raise``-mode seam: raise :class:`InjectedFault` when a
    matching spec fires (``@attempts:N``: its first N firings only)."""
    registry = active_registry()
    if registry is None:
        return
    spec = registry.find(site, name)
    if spec is None or spec.mode != "raise" or spec.exhausted():
        return
    count = registry.fire(spec, machine=name, **fields)
    raise InjectedFault(
        f"Injected fault at site {site!r}"
        + (f" for machine {name!r}" if name else "")
        + f" (firing {count})"
    )


def train_nan_injection(
    machine_names: Optional[Sequence[str]],
    n_machines: int,
    sites: Tuple[str, ...] = ("train",),
) -> Optional[Tuple[np.ndarray, int]]:
    """
    The training seam, resolved once a fit: the ``nan`` specs of
    ``sites`` as an (M,) machine mask and the epoch at which those
    machines' losses go NaN (``@epoch``, default 0), or None. Targets are
    machine names, or fleet indices when there are no names. Ordinary
    fits listen to ``train``; lifecycle refits to ``("train", "refit")``.
    """
    registry = active_registry()
    if registry is None:
        return None
    specs = [s for s in registry.specs if s.site in sites and s.mode == "nan"]
    if not specs:
        return None
    mask = np.zeros(n_machines, dtype=bool)
    epoch = 0
    matched = None
    for spec in specs:
        if spec.target is None:
            mask[:] = True
        elif machine_names is not None:
            hits = [i for i, n in enumerate(machine_names) if str(n) == spec.target]
            if not hits:
                continue
            mask[hits] = True
        else:
            try:
                index = int(spec.target)
            except ValueError:
                continue
            if not 0 <= index < n_machines:
                continue
            mask[index] = True
        epoch = spec.param_int("epoch", 0)
        matched = spec
    if matched is None or not mask.any():
        return None
    registry.fire(matched, n_machines_poisoned=int(mask.sum()), epoch=epoch)
    return mask, epoch


def _scale_for(site: str, mode: str, name: Optional[str], default: float) -> Optional[float]:
    """The ``@scale`` of the matching spec (fired), or None."""
    registry = active_registry()
    if registry is None:
        return None
    spec = registry.find(site, name, mode)
    if spec is None:
        return None
    try:
        scale = float(spec.params.get("scale", default))
    except (TypeError, ValueError):
        raise ValueError(
            f"Fault spec parameter @scale must be a number, got {spec.params.get('scale')!r}"
        )
    registry.fire(spec, machine=name, scale=scale)
    return scale


def drift_shift_scale(name: Optional[str]) -> Optional[float]:
    """The drift-scan seam: the offset (``drift:shift``, default 5.0) added
    to the named machine's fetched inputs and targets before scoring, or
    None."""
    return _scale_for("drift", "shift", name, 5.0)


def refit_degrade_scale(name: Optional[str]) -> Optional[float]:
    """The shadow-gate seam: the factor (``refit:degrade``, default 10.0)
    on the named machine's candidate weights before shadow scoring, or
    None."""
    return _scale_for("refit", "degrade", name, 10.0)


def inject_promotion_tear(n_assembled: int) -> None:
    """The revision-assembly seam: a ``promote:torn`` spec makes the
    promoter die mid-copy (:class:`InjectedFault`), leaving its staging
    directory; ``@attempts:N`` tears the first N promotions only."""
    registry = active_registry()
    if registry is None:
        return
    spec = registry.find("promote", None, "torn")
    if spec is None or spec.exhausted():
        return
    count = registry.fire(spec, n_assembled=n_assembled)
    raise InjectedFault(
        f"Injected fault at site 'promote': revision assembly torn after {n_assembled} "
        f"machine(s) (firing {count})"
    )


def precision_degrade(name: Optional[str]) -> bool:
    """The bf16 calibration seam: True when a ``precision:degrade`` spec
    matching the machine fires, and the builder then keeps it float32
    whatever its measured MAE delta; ``@attempts:N`` forces only the first
    N calibrations."""
    registry = active_registry()
    if registry is None:
        return False
    spec = registry.find("precision", name, "degrade")
    if spec is None or spec.exhausted():
        return False
    registry.fire(spec, machine=name)
    return True


def worker_die(stage: str) -> None:
    """
    The worker-death seam: a ``worker:die[:<stage>]`` spec matching
    ``stage`` (``fetch``: the unit leased, nothing fetched; ``train``: CV
    done, the final fit not started; ``commit``: the artifacts written,
    the done record not) ends this process with ``os._exit(137)``: no
    clean-up, as a killed process dies, which the ledger's lease steal
    must absorb. ``@worker:<id>`` limits it to the worker whose
    ``GORDO_WORKER_ID`` is ``<id>``; ``@attempts:N`` to the first N
    firings of this process. The ``fault_injected`` event is written
    before the exit.
    """
    registry = active_registry()
    if registry is None:
        return
    spec = registry.find("worker", stage, "die")
    if spec is None:
        return
    worker_id = os.environ.get(WORKER_ID_ENV_VAR)
    want = spec.params.get("worker")
    if want is not None and want != (worker_id or ""):
        return
    if spec.exhausted():
        return
    registry.fire(spec, stage=stage, worker=worker_id)
    logger.warning("Fault injection: worker %s dying at stage %r (os._exit)", worker_id, stage)
    os._exit(137)


def lease_stall(worker_id: Union[str, int]) -> bool:
    """The heartbeat seam: True while a ``lease:stall[:<worker-id>]`` spec
    targets this worker, whose heartbeats are then skipped (it builds on,
    but its lease expires and is stolen). Fires once, at the first
    skipped beat."""
    registry = active_registry()
    if registry is None:
        return False
    spec = registry.find("lease", str(worker_id), "stall")
    if spec is None:
        return False
    if spec.fires == 0:
        registry.fire(spec, worker=str(worker_id))
    return True


def _param_float(spec: FaultSpec, key: str, default: float) -> float:
    try:
        return float(spec.params.get(key, default))
    except (TypeError, ValueError):
        raise ValueError(
            f"Fault spec parameter @{key} must be a number, got {spec.params.get(key)!r}"
        )


def replica_fault_action(replica_id: str) -> Optional[Tuple[str, float]]:
    """
    The routing seam (site ``replica``), asked by the router just before
    each call to a replica (and each ``/healthz`` probe). What the call
    suffers, or None:

    - ``replica:die:<id>``: ``("die", 0)``, a refused connection as the
      router sees a killed process; ``@attempts:N`` bounds it to the first
      N calls (then the replica is back).
    - ``replica:slow:<id>@ms:<m>``: ``("slow", seconds)``, the router
      sleeps that long before the send (default 1000 ms); ``@attempts:N``
      bounds it.
    - ``replica:flap:<id>[@burst:<k>]``: ``("die", 0)`` for ``k``
      consecutive calls, then None for ``k``, over and over (default 3,
      the ejection threshold): ejection and recovery again and again.

    Each suffered call fires a ``fault_injected`` event (a flap's failing
    calls only; every call advances its cadence).
    """
    registry = active_registry()
    if registry is None:
        return None
    for mode in ("die", "slow", "flap"):
        spec = registry.find("replica", str(replica_id), mode)
        if spec is None:
            continue
        if mode == "flap":
            burst = max(1, spec.param_int("burst", 3))
            with registry._lock:
                spec.fires += 1
                count = spec.fires
            if ((count - 1) // burst) % 2 == 1:
                return None
            _count_fired("replica")
            emit_event("fault_injected", site="replica", mode="flap", target=spec.target,
                       fire_count=count, replica=replica_id)
            return ("die", 0.0)
        if spec.exhausted():
            continue
        if mode == "slow":
            ms = _param_float(spec, "ms", 1000.0)
            registry.fire(spec, replica=replica_id, ms=ms)
            return ("slow", ms / 1000.0)
        registry.fire(spec, replica=replica_id)
        return ("die", 0.0)
    return None


def stream_fault_action(machine_names) -> Optional[Tuple[str, float]]:
    """
    The streaming seam (site ``stream``), asked by the server at the top
    of each stream update, matched against the session's machines (a spec
    with no target matches every session). What the update suffers, or
    None:

    - ``stream:drop:<machine>``: ``("drop", 0)``, the server forgets the
      session first, so the update answers the resume 409 and the client
      replays its window tail; ``@attempts:N`` bounds it.
    - ``stream:stall:<machine>@ms:<m>``: ``("stall", seconds)``, the
      update sleeps that long before it is scored (default 250 ms).
    - ``stream:burst:<machine>@rate:<r>``: ``("burst", r)``, the update
      counts as ``r`` arrivals against the session's backlog bound
      (default 8), which drives the shed (503 with ``Retry-After``).

    Each suffered update fires a ``fault_injected`` event.
    """
    registry = active_registry()
    if registry is None:
        return None
    names = list(machine_names)
    for mode, default in (("drop", 0.0), ("stall", 250.0), ("burst", 8.0)):
        spec = next((s for s in registry.specs
                     if s.site == "stream" and s.mode == mode
                     and (s.target is None or s.target in names)), None)
        if spec is None or spec.exhausted():
            continue
        if mode == "stall":
            value = _param_float(spec, "ms", default) / 1000.0
            registry.fire(spec, machines=names, ms=value * 1000.0)
        elif mode == "burst":
            value = _param_float(spec, "rate", default)
            registry.fire(spec, machines=names, rate=value)
        else:
            value = 0.0
            registry.fire(spec, machines=names)
        return (mode, value)
    return None


def tear_checkpoint_files(step_dir: Union[str, os.PathLike]) -> bool:
    """The checkpoint-write seam: a ``ckpt:torn`` spec cuts the largest
    file of the checkpoint just written (its manifest already stamped) to
    half its size, as a crash mid-flush would. True when it tore;
    ``@attempts:N`` tears the first N saves only."""
    registry = active_registry()
    if registry is None:
        return False
    spec = registry.find("ckpt")
    if spec is None or spec.mode != "torn" or spec.exhausted():
        return False
    victim: Optional[str] = None
    victim_size = -1
    for root, _, files in os.walk(step_dir):
        for fname in files:
            path = os.path.join(root, fname)
            size = os.path.getsize(path)
            if size > victim_size:
                victim, victim_size = path, size
    if victim is None:
        return False
    registry.fire(spec, path=victim, original_size=victim_size)
    with open(victim, "r+b") as fh:
        fh.truncate(victim_size // 2)
    logger.warning("Fault injection: tore checkpoint file %s (%d -> %d bytes)",
                   victim, victim_size, victim_size // 2)
    return True
