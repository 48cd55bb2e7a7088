"""
Game-day scripts (the port of ``gordo_tpu.scenario.timeline``).

A scenario is a YAML or JSON document: a plane shape, a synthetic
workload, a timeline of faults and operations, an SLO budget and the
expectations checked after the run::

    name: region-loss
    plane:
      replicas: 3
    workload:
      streams: 6
      stream_interval_s: 400ms
      requests_per_s: 3
    duration_s: 10s
    timeline:
    - at: 3s
      action: kill_replica
      replica: r0
    slo:
      objectives:
      - signal: unstructured_error_rate
        threshold: 0.0
        budget: 0.001
    expect:
      min_stream_resumes: 1
      bit_identity: true

Parsing is strict, as JAX's: an unknown key at any level, an unknown
timeline action or action key, a missing required key and a malformed
duration raise :class:`ScenarioError`; ``arm_faults`` specs go through
the port's ``faults.parse_spec`` (an unknown site, or ``program``, which
the port does not wire, is refused) and the ``slo`` block through
``slo.parse_slo_spec`` (an unknown signal is refused), so a scenario with
a typo fails before it sends a request. Files are read as JSON, else by
the port's YAML reader. ``bump_jaxlib_manifest`` parses as in JAX, but
it edits the AOT program store, which the port lacks: a scenario that
uses it is not run (:data:`UNPORTED_ACTIONS`).
"""

import dataclasses
import json
import os
import re
from typing import Any, Dict, Iterable, Mapping, Optional, Tuple, Union

from gordo_tpu_torch.observability import slo as slo_mod
from gordo_tpu_torch.robustness import faults

#: the timeline's actions, with their required and optional keys
ACTIONS: Dict[str, Dict[str, Tuple[str, ...]]] = {
    "kill_replica": {"required": ("replica",), "optional": ()},
    "restart_replica": {"required": ("replica",), "optional": ()},
    "arm_faults": {"required": ("spec",), "optional": ()},
    "disarm_faults": {"required": (), "optional": ()},
    "lifecycle_tick": {"required": (), "optional": ()},
    "bump_jaxlib_manifest": {"required": (), "optional": ()},
}
#: actions of the grammar that the port parses but cannot run, and why
UNPORTED_ACTIONS: Dict[str, str] = {
    "bump_jaxlib_manifest": (
        "it re-stamps the AOT program store's manifest, and programs/ stays out of "
        "gordo_tpu_torch (ROADMAP.md queue 1 item 9)"
    ),
}

_DURATION_RE = re.compile(r"^\s*(\d+(?:\.\d+)?)\s*(ms|s|m|h)?\s*$")
_DURATION_SCALE = {"ms": 0.001, "s": 1.0, "m": 60.0, "h": 3600.0, None: 1.0}


class ScenarioError(ValueError):
    """A scenario document that cannot be run."""


def parse_duration(value: Union[int, float, str]) -> float:
    """``30``, ``"30s"``, ``"450ms"``, ``"1.5m"``, ``"2h"``: seconds."""
    if isinstance(value, bool):
        raise ScenarioError(f"Bad duration {value!r}")
    if isinstance(value, (int, float)):
        seconds = float(value)
    else:
        match = _DURATION_RE.match(str(value))
        if not match:
            raise ScenarioError(f"Bad duration {value!r} (want e.g. '30s')")
        seconds = float(match.group(1)) * _DURATION_SCALE[match.group(2)]
    if seconds < 0:
        raise ScenarioError(f"Negative duration {value!r}")
    return seconds


def _check_keys(block: dict, allowed: Iterable[str], where: str) -> None:
    unknown = sorted(set(block) - set(allowed))
    if unknown:
        raise ScenarioError(f"Unknown {where} key(s) {unknown}; allowed: {sorted(allowed)}")


@dataclasses.dataclass(frozen=True)
class TimelineEvent:
    at_s: float
    action: str
    params: Mapping[str, Any]

    def to_dict(self) -> dict:
        return {"at_s": self.at_s, "action": self.action, **self.params}


@dataclasses.dataclass(frozen=True)
class PlaneSpec:
    replicas: int = 2


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    streams: int = 4
    stream_interval_s: float = 0.4
    rows_per_update: int = 4
    requests_per_s: float = 2.0


@dataclasses.dataclass(frozen=True)
class ExpectSpec:
    """The checks after the run, beside the SLO budget. ``bit_identity``
    belongs only to scenarios that promote nothing: a promoted revision
    scores differently by design."""

    fault_sites: Tuple[str, ...] = ()
    min_stream_resumes: int = 0
    min_sheds_honored: int = 0
    promotions: Optional[int] = None
    bit_identity: bool = False


@dataclasses.dataclass(frozen=True)
class Scenario:
    name: str
    description: str
    plane: PlaneSpec
    workload: WorkloadSpec
    duration_s: float
    timeline: Tuple[TimelineEvent, ...]
    slo: slo_mod.SloSpec
    expect: ExpectSpec

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "description": self.description,
            "plane": dataclasses.asdict(self.plane),
            "workload": dataclasses.asdict(self.workload),
            "duration_s": self.duration_s,
            "timeline": [e.to_dict() for e in self.timeline],
            "slo": self.slo.to_dict(),
            "expect": dataclasses.asdict(self.expect),
        }

    def unported(self) -> Optional[str]:
        """Why the port cannot run this scenario, or None."""
        for event in self.timeline:
            if event.action in UNPORTED_ACTIONS:
                return f"timeline action {event.action!r}: {UNPORTED_ACTIONS[event.action]}"
        return None


def _parse_event(raw: dict, index: int) -> TimelineEvent:
    if not isinstance(raw, dict):
        raise ScenarioError(f"Timeline entry {index} must be a mapping")
    if "at" not in raw:
        raise ScenarioError(f"Timeline entry {index} needs an 'at' time")
    action = raw.get("action")
    if action not in ACTIONS:
        raise ScenarioError(
            f"Unknown timeline action {action!r} at entry {index}; known: {sorted(ACTIONS)}"
        )
    shape = ACTIONS[action]
    params = {k: v for k, v in raw.items() if k not in ("at", "action")}
    _check_keys(params, set(shape["required"]) | set(shape["optional"]),
                f"'{action}' parameter")
    missing = [k for k in shape["required"] if k not in params]
    if missing:
        raise ScenarioError(f"Timeline action {action!r} at entry {index} missing {missing}")
    if action == "arm_faults":
        # an unknown (or unwired) site fails here, not mid-run
        try:
            faults.parse_spec(str(params["spec"]))
        except ValueError as exc:
            raise ScenarioError(f"Timeline entry {index}: {exc}")
        params["spec"] = str(params["spec"])
    else:
        params = {k: str(v) for k, v in params.items()}
    return TimelineEvent(at_s=parse_duration(raw["at"]), action=action, params=params)


def parse_scenario(document: dict, name: str = "scenario") -> Scenario:
    """A validated :class:`Scenario` from its document."""
    if not isinstance(document, dict):
        raise ScenarioError("Scenario must be a mapping")
    _check_keys(document, ("name", "description", "plane", "workload", "duration_s",
                           "timeline", "slo", "expect"), "scenario")

    plane_raw = document.get("plane") or {}
    _check_keys(plane_raw, ("replicas",), "plane")
    plane = PlaneSpec(replicas=int(plane_raw.get("replicas", 2)))
    if plane.replicas < 1:
        raise ScenarioError("plane.replicas must be >= 1")

    workload_raw = document.get("workload") or {}
    _check_keys(workload_raw, ("streams", "stream_interval_s", "rows_per_update",
                               "requests_per_s"), "workload")
    workload = WorkloadSpec(
        streams=int(workload_raw.get("streams", 4)),
        stream_interval_s=parse_duration(workload_raw.get("stream_interval_s", 0.4)),
        rows_per_update=int(workload_raw.get("rows_per_update", 4)),
        requests_per_s=float(workload_raw.get("requests_per_s", 2.0)),
    )

    duration_s = parse_duration(document.get("duration_s", 10))
    if duration_s <= 0:
        raise ScenarioError("duration_s must be > 0")

    raw_timeline = document.get("timeline") or []
    if not isinstance(raw_timeline, list):
        raise ScenarioError("timeline must be a list")
    timeline = tuple(sorted((_parse_event(raw, i) for i, raw in enumerate(raw_timeline)),
                            key=lambda e: e.at_s))
    for event in timeline:
        if event.at_s > duration_s:
            raise ScenarioError(
                f"Timeline event '{event.action}' at {event.at_s}s is past the scenario "
                f"duration ({duration_s}s)"
            )

    slo_raw = document.get("slo")
    if not slo_raw:
        raise ScenarioError("Scenario needs an 'slo' block (the budget)")
    try:
        slo_spec = slo_mod.parse_slo_spec(slo_raw, name=name)
    except slo_mod.SloSpecError as exc:
        raise ScenarioError(f"Bad slo block: {exc}")

    expect_raw = document.get("expect") or {}
    _check_keys(expect_raw, ("fault_sites", "min_stream_resumes", "min_sheds_honored",
                             "promotions", "bit_identity"), "expect")
    fault_sites = tuple(str(s) for s in expect_raw.get("fault_sites") or ())
    unknown_sites = sorted(set(fault_sites) - (faults.WIRED_SITES | faults.UNWIRED_SITES))
    if unknown_sites:
        raise ScenarioError(f"expect.fault_sites names unknown site(s) {unknown_sites}")
    promotions = expect_raw.get("promotions")
    expect = ExpectSpec(
        fault_sites=fault_sites,
        min_stream_resumes=int(expect_raw.get("min_stream_resumes", 0)),
        min_sheds_honored=int(expect_raw.get("min_sheds_honored", 0)),
        promotions=None if promotions is None else int(promotions),
        bit_identity=bool(expect_raw.get("bit_identity", False)),
    )

    return Scenario(
        name=str(document.get("name") or name),
        description=str(document.get("description") or ""),
        plane=plane,
        workload=workload,
        duration_s=duration_s,
        timeline=timeline,
        slo=slo_spec,
        expect=expect,
    )


def load_scenario(path: str) -> Scenario:
    """A scenario from a JSON or YAML file (the port's YAML reader)."""
    from gordo_tpu_torch.workflow.yaml_reader import safe_load

    with open(path) as fh:
        text = fh.read()
    try:
        document = json.loads(text)
    except ValueError:
        try:
            document = safe_load(text)
        except ValueError as exc:
            raise ScenarioError(f"Unparseable scenario {path}: {exc}")
    return parse_scenario(document, name=os.path.splitext(os.path.basename(path))[0])
