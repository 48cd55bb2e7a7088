"""
Env-driven fault injection (the port of ``gordo_tpu.robustness.faults``):
the chaos harness the lifecycle's tests and ``chip_smoke.py`` drive.

``GORDO_FAULT_INJECT`` holds a ``;``-separated list of fault specs::

    GORDO_FAULT_INJECT="fetch:raise:machine-3;refit:nan:machine-7@epoch:0;promote:torn"

One spec is ``site:mode[:target][@key:value ...]``, the JAX grammar:

- ``site``: where the seam lives. The port wires ``fetch`` (a machine's
  dataset fetch in the fleet builder), ``train`` (the fleet trainer's
  epoch loss), and the lifecycle's ``drift`` (the drift scan's fetched
  window), ``refit`` (the warm-start refit) and ``promote`` (revision
  assembly). The JAX package's other sites (``ckpt``, ``serve``,
  ``batch``, ``worker``, ``lease``, ``program``, ``precision``,
  ``replica``, ``stream``) have no seam in the port yet: a spec naming
  one raises ``ValueError`` when it is parsed (ROADMAP.md queue 1 item
  9), so a chaos run never injects nothing in silence.
- ``mode``: ``raise`` (the seam raises :class:`InjectedFault`), ``nan``
  (train/refit: the named machine's epoch loss goes NaN at
  ``@epoch:<e>``, which drives the trainer's quarantine guard),
  ``shift`` (drift: the named machine's fetched inputs and targets are
  offset by ``@scale:<s>``, default 5.0), ``degrade`` (refit: the
  candidate's weights are multiplied by ``@scale:<s>``, default 10.0,
  before shadow scoring) and ``torn`` (promote: revision assembly dies
  mid-copy and leaves its dot-prefixed staging directory).
- ``target``: a machine name (or a bare fleet index when the seam has no
  names); omitted means any machine at that site.
- ``@key:value``: ``@epoch:E``, ``@scale:S``, and ``@attempts:N`` (fail
  only the first N firings, then pass: the retry path).

Every firing emits a ``fault_injected`` event
(:mod:`gordo_tpu_torch.observability.events`). The JAX package's
``gordo_fault_fired_total`` counter waits for the metrics registry of
ROADMAP.md queue 1 item 9.

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

logger = logging.getLogger(__name__)

FAULT_INJECT_ENV_VAR = "GORDO_FAULT_INJECT"
#: a path whose content is the spec string, re-checked by mtime and size
FAULT_INJECT_FILE_ENV_VAR = "GORDO_FAULT_INJECT_FILE"

#: the sites whose seams the port has
WIRED_SITES = frozenset({"fetch", "train", "drift", "refit", "promote"})
#: the JAX grammar's other sites: parsed only to be refused
UNWIRED_SITES = frozenset(
    {"ckpt", "serve", "batch", "worker", "lease", "program", "precision", "replica", "stream"}
)


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
                f"Bad fault spec {raw!r}: site {site!r} has no seam in gordo_tpu_torch yet "
                "(ROADMAP.md queue 1 item 9); the port wires "
                f"{sorted(WIRED_SITES)}"
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
        emit_event("fault_injected", site=spec.site, mode=spec.mode, target=spec.target,
                   fire_count=count, **fields)
        return count


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
