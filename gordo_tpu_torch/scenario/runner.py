"""
Running a game day (the port of ``gordo_tpu.scenario.runner``): one
parsed :class:`~gordo_tpu_torch.scenario.timeline.Scenario` against a
private :class:`~gordo_tpu_torch.scenario.plane.ScenarioPlane`, and the
verdict.

A real-time :class:`~gordo_tpu_torch.scenario.synthetic.EventLoop`
interleaves four kinds of event on one thread: the streams (the port's
``StreamPublisher`` sessions through the router, one a synthetic
stream), one-shot fleet requests, the timeline's actions (kill and
restart replicas, arm and disarm faults through the
``GORDO_FAULT_INJECT_FILE`` channel, lifecycle ticks) and rollup polls.
A lifecycle tick refits drifted machines, so one worker thread runs the
ticks off the loop while traffic flows (a promotion under load), and is
joined before the verdict.

The verdict composes the checks, each reported: the SLO budget over the
polled snapshots (``slo.evaluate``); no unstructured client error (a shed
honoured through ``Retry-After`` or a structured resume is fine, a 500
or a broken stream is not); the ``expect`` block (fault sites that fired,
read from ``gordo_fault_fired_total`` deltas, stream resumes, sheds
honoured, promotions); and, where promised, each stream's scores bitwise
equal to one fleet request of its rows through the same plane.
"""

import logging
import os
import queue
import threading
import time
from typing import Dict, List, Optional, Union

import numpy as np

from gordo_tpu_torch.device import DeviceLike
from gordo_tpu_torch.observability import slo as slo_mod
from gordo_tpu_torch.observability.registry import get_registry
from gordo_tpu_torch.robustness import faults
from gordo_tpu_torch.scenario.plane import GAMEDAY_TAGS, ScenarioPlane
from gordo_tpu_torch.scenario.synthetic import EventLoop
from gordo_tpu_torch.scenario.timeline import Scenario, ScenarioError

logger = logging.getLogger(__name__)

#: the statuses a game-day client takes as structured: 200 served, 503
#: shed with Retry-After, 409 the resume contract or a casualty
STRUCTURED_STATUSES = frozenset((200, 503, 409))

DEFAULT_POLL_INTERVAL_S = 1.0


def fault_fired_counts() -> Dict[str, float]:
    """``gordo_fault_fired_total`` by site, now."""
    dump = get_registry().snapshot().get("gordo_fault_fired_total") or {}
    out: Dict[str, float] = {}
    for series in dump.get("series") or []:
        site = (series.get("labels") or {}).get("site")
        if site:
            out[site] = float(series.get("value") or 0.0)
    return out


class _StreamState:
    """One synthetic stream: its publisher and the rows it pushed (the
    bit-identity ledger)."""

    def __init__(self, index: int, machine: str, publisher):
        self.index = index
        self.machine = machine
        self.publisher = publisher
        self.rng = np.random.default_rng(1000 + index)
        self.rows: List[np.ndarray] = []
        self.scores: List[np.ndarray] = []
        self.updates = 0
        self.broken: Optional[str] = None


class _TickWorker:
    """One worker thread running the ticks in order, off the loop.
    ``TornPromotion`` is an expected, structured outcome; any other
    error is charged to the scenario."""

    def __init__(self, plane: ScenarioPlane):
        self.plane = plane
        self.results: List[dict] = []
        self.errors: List[str] = []
        self._queue: "queue.Queue" = queue.Queue()
        self._thread = threading.Thread(target=self._run, name="gameday-lifecycle",
                                        daemon=True)
        self._thread.start()

    def request_tick(self) -> None:
        self._queue.put("tick")

    def _run(self) -> None:
        from gordo_tpu_torch.lifecycle import TornPromotion

        while True:
            item = self._queue.get()
            if item is None:
                return
            started = time.monotonic()
            try:
                result = self.plane.lifecycle_manager().tick()
                self.results.append({
                    "revision": result.revision,
                    "drifted": list(result.drifted),
                    "promoted": list(result.promoted),
                    "quarantined": list(result.quarantined),
                    "noop": result.noop,
                    "wall_time_s": round(time.monotonic() - started, 3),
                })
            except TornPromotion as exc:
                self.results.append({"torn": str(exc), "revision": None})
            except Exception as exc:  # noqa: BLE001 - charged to the run
                logger.exception("Game-day lifecycle tick failed")
                self.errors.append(f"lifecycle: {exc!r}")

    def stop(self, timeout: float = 120.0) -> None:
        self._queue.put(None)
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            self.errors.append("lifecycle: tick worker failed to drain")


def judge(scenario: Scenario, snapshots: List[dict], unstructured: List[str],
          fired: Dict[str, float], reconnects: int, sheds_honored: int,
          promotions: int, mismatches: Optional[List[str]] = None,
          checked_streams: int = 0) -> dict:
    """The composed verdict on a run's evidence: ``ok``, the SLO report,
    the ``expect`` failures and the bit-identity block (None when the
    scenario promises none; ``mismatches`` are its streams' failures)."""
    slo_report = slo_mod.evaluate(scenario.slo, snapshots)
    expect = scenario.expect
    failures: List[str] = []
    for site in expect.fault_sites:
        if fired.get(site, 0.0) <= 0:
            failures.append(f"expected fault site {site!r} to fire; it never did")
    if reconnects < expect.min_stream_resumes:
        failures.append(
            f"expected >= {expect.min_stream_resumes} stream resumes, saw {reconnects}")
    if sheds_honored < expect.min_sheds_honored:
        failures.append(
            f"expected >= {expect.min_sheds_honored} honored sheds, saw {sheds_honored}")
    if expect.promotions is not None and promotions != expect.promotions:
        failures.append(f"expected {expect.promotions} promotion(s), saw {promotions}")
    bit_identity = None
    if expect.bit_identity:
        mismatches = list(mismatches or [])
        bit_identity = {"checked_streams": checked_streams,
                        "ok": checked_streams > 0 and not mismatches,
                        "mismatches": mismatches}
        if not bit_identity["ok"]:
            failures.append("bit identity broken: "
                            + (", ".join(mismatches) or "no stream completed"))
    return {
        "ok": slo_report.ok and not unstructured and not failures,
        "slo": slo_report,
        "expect_failures": failures,
        "bit_identity": bit_identity,
    }


def run_scenario(scenario: Scenario, collection_models: Union[str, os.PathLike],
                 workdir: Union[str, os.PathLike],
                 poll_interval_s: float = DEFAULT_POLL_INTERVAL_S,
                 device: DeviceLike = None) -> dict:
    """Run one scenario; the report (``report["ok"]`` is the verdict, the
    rest its evidence). A scenario the port cannot run raises
    :class:`ScenarioError`, naming why."""
    from gordo_tpu_torch.client.streaming import StreamBroken

    why = scenario.unported()
    if why:
        raise ScenarioError(f"Scenario {scenario.name!r} cannot run in gordo_tpu_torch: {why}")
    plane = ScenarioPlane(collection_models, os.path.join(os.fspath(workdir), scenario.name),
                          replicas=scenario.plane.replicas, device=device)
    wall_started = time.monotonic()
    plane.start()
    ticker: Optional[_TickWorker] = None
    streams: List[_StreamState] = []
    snapshots: List[dict] = []
    executed: List[dict] = []
    unstructured: List[str] = []
    request_outcomes: Dict[int, int] = {}
    try:
        if any(e.action == "lifecycle_tick" for e in scenario.timeline):
            plane.enable_lifecycle_member()
            ticker = _TickWorker(plane)

        fired_before = fault_fired_counts()
        machines = plane.machine_names()
        client = plane.client()
        workload = scenario.workload
        for i in range(workload.streams):
            machine = machines[i % len(machines)]
            publisher = client.stream_machine(machine, backoff_scale=0.002)
            publisher.open()
            streams.append(_StreamState(i, machine, publisher))

        loop = EventLoop(real_time=True)
        epoch = loop.now

        def stream_update(state: _StreamState) -> None:
            if state.broken:
                return
            rows = state.rng.random((workload.rows_per_update, len(GAMEDAY_TAGS)))
            try:
                scores = state.publisher.send(rows)
            except StreamBroken as exc:
                state.broken = str(exc)
                unstructured.append(f"stream[{state.index}/{state.machine}]: {exc}")
                return
            except Exception as exc:  # noqa: BLE001 - evidence for the verdict
                state.broken = repr(exc)
                unstructured.append(f"stream[{state.index}/{state.machine}]: {exc!r}")
                return
            state.rows.append(rows)
            if len(scores):
                state.scores.append(np.asarray(scores, dtype="float32"))
            state.updates += 1
            loop.call_later(workload.stream_interval_s, stream_update, state)

        request_rng = np.random.default_rng(97)
        request_count = [0]

        def one_request() -> None:
            machine = machines[request_count[0] % len(machines)]
            request_count[0] += 1
            rows = request_rng.random((4, len(GAMEDAY_TAGS)))
            try:
                status = plane.fleet_post(machine, rows)
            except Exception as exc:  # noqa: BLE001 - evidence for the verdict
                unstructured.append(f"request[{machine}]: {exc!r}")
                status = -1
            request_outcomes[status] = request_outcomes.get(status, 0) + 1
            if status not in STRUCTURED_STATUSES and status != -1:
                unstructured.append(f"request[{machine}]: HTTP {status}")
            loop.call_later(1.0 / workload.requests_per_s, one_request)

        def poll() -> None:
            snapshots.append(plane.poll())
            loop.call_later(poll_interval_s, poll)

        def run_event(event) -> None:
            executed.append({"at_s": event.at_s, "action": event.action, **dict(event.params),
                             "t_actual_s": round(loop.now - epoch, 3)})
            if event.action == "kill_replica":
                plane.kill_replica(event.params["replica"])
            elif event.action == "restart_replica":
                plane.restart_replica(event.params["replica"])
            elif event.action == "arm_faults":
                faults.arm_file(plane.fault_file, event.params["spec"])
            elif event.action == "disarm_faults":
                faults.disarm_file(plane.fault_file)
            elif event.action == "lifecycle_tick":
                ticker.request_tick()

        # a first poll, so that the recorded ones are windowed against the
        # scenario's start, not the process's (scenarios share a registry)
        plane.poll()
        for i, state in enumerate(streams):
            loop.call_at(epoch + (i + 1) * workload.stream_interval_s / max(1, workload.streams),
                         stream_update, state)
        if workload.requests_per_s > 0:
            loop.call_at(epoch + 0.5 / workload.requests_per_s, one_request)
        loop.call_at(epoch + poll_interval_s, poll)
        for event in scenario.timeline:
            loop.call_at(epoch + event.at_s, run_event, event)

        loop.run_until(epoch + scenario.duration_s)
        if ticker is not None:
            ticker.stop()
        snapshots.append(plane.poll())

        for state in streams:
            try:
                state.publisher.close()
            except Exception:  # noqa: BLE001 - close is best effort
                pass
        if ticker is not None:
            unstructured.extend(ticker.errors)

        fired_after = fault_fired_counts()
        fault_sites_fired = {
            site: fired_after.get(site, 0.0) - fired_before.get(site, 0.0)
            for site in sorted(set(fired_before) | set(fired_after))
            if fired_after.get(site, 0.0) > fired_before.get(site, 0.0)
        }
        reconnects = sum(s.publisher.reconnects for s in streams)
        sheds_honored = sum(s.publisher.sheds_honored for s in streams)
        promotions = sum(1 for r in ticker.results if r.get("revision")) if ticker else 0
        torn = sum(1 for r in ticker.results if "torn" in r) if ticker else 0

        mismatches: List[str] = []
        checked = 0
        if scenario.expect.bit_identity:
            for state in streams:
                if not state.rows or state.broken:
                    continue
                checked += 1
                reference = plane.one_shot(state.machine, np.concatenate(state.rows))
                got = (np.concatenate(state.scores) if state.scores
                       else np.empty(0, dtype="float32"))
                if reference.shape != got.shape or not np.array_equal(reference, got):
                    mismatches.append(f"stream[{state.index}/{state.machine}]: {got.shape} "
                                      f"vs reference {reference.shape}")
        verdict = judge(scenario, snapshots, unstructured, fault_sites_fired, reconnects,
                        sheds_honored, promotions, mismatches, checked)
        return {
            "scenario": scenario.name,
            "description": scenario.description,
            "ok": verdict["ok"],
            "duration_s": scenario.duration_s,
            "wall_time_s": round(time.monotonic() - wall_started, 3),
            "slo": verdict["slo"].to_dict(),
            "unstructured_errors": list(unstructured),
            "expect_failures": verdict["expect_failures"],
            "request_outcomes": {str(k): v for k, v in sorted(request_outcomes.items())},
            "streams": {
                "n": len(streams),
                "updates": sum(s.updates for s in streams),
                "reconnects": reconnects,
                "sheds_honored": sheds_honored,
                "broken": sum(1 for s in streams if s.broken),
            },
            "fault_sites_fired": fault_sites_fired,
            "lifecycle": {"ticks": list(ticker.results) if ticker else [],
                          "promotions": promotions, "torn": torn},
            "bit_identity": verdict["bit_identity"],
            "timeline_executed": executed,
            "n_snapshots": len(snapshots),
            "final_signals": snapshots[-1].get("signals") if snapshots else None,
        }
    finally:
        for state in streams:
            try:
                state.publisher.close()
            except Exception:  # noqa: BLE001
                pass
        if ticker is not None and ticker._thread.is_alive():
            ticker.stop(timeout=5.0)
        plane.close()
