"""
Game days (the port of ``gordo_tpu.scenario``): YAML fault timelines run
against an in-process copy of the serving plane, judged by SLO budgets
over the plane's rollup.

- :mod:`~gordo_tpu_torch.scenario.timeline`: the grammar (strict: an
  unknown action, fault site or SLO signal fails before anything runs)
- :mod:`~gordo_tpu_torch.scenario.plane`: the plane (router, sharded
  replicas, lifecycle and rollup poller in one process)
- :mod:`~gordo_tpu_torch.scenario.runner`: the event-loop run and the
  composed verdict
- :mod:`~gordo_tpu_torch.scenario.library`: the shipped scenarios
  (mirrored as YAML in ``examples/scenarios/``)
- :mod:`~gordo_tpu_torch.scenario.synthetic`: thread-free synthetic
  clients on a heap-scheduled event loop

Entry point: ``python -m gordo_tpu_torch.cli gameday list|run``.
"""

from gordo_tpu_torch.scenario.library import (
    builtin_scenarios,
    get_scenario,
    scenario_documents,
)
from gordo_tpu_torch.scenario.plane import (
    ScenarioPlane,
    build_gameday_collection,
    shared_gameday_collection,
)
from gordo_tpu_torch.scenario.runner import run_scenario
from gordo_tpu_torch.scenario.synthetic import EventLoop, StubPlane, SyntheticStream
from gordo_tpu_torch.scenario.timeline import (
    Scenario,
    ScenarioError,
    load_scenario,
    parse_duration,
    parse_scenario,
)

__all__ = [
    "EventLoop",
    "Scenario",
    "ScenarioError",
    "ScenarioPlane",
    "StubPlane",
    "SyntheticStream",
    "build_gameday_collection",
    "builtin_scenarios",
    "get_scenario",
    "load_scenario",
    "parse_duration",
    "parse_scenario",
    "run_scenario",
    "scenario_documents",
    "shared_gameday_collection",
]
