"""
The lifecycle cycle (the port of ``gordo_tpu.lifecycle.manager``): one
``tick`` closes the loop serving -> drift -> warm-start refit -> shadow
gate -> blue/green promotion.

A tick over a healthy fleet changes nothing: every machine's anomaly
statistics sit under their thresholds, the
:class:`~gordo_tpu_torch.lifecycle.drift.DriftMonitor` reports nothing
and no revision is written. When drift is detected, only the drifted
machines refit, warm-started from their served weights, each machine its
own fault domain (the fleet builder's casualty records); each candidate
is shadow-scored against its live model on the holdout tail of the
window, and a new sibling revision is published by one rename with every
decision in ``promotion_report.json``.

On the card the drift scan and the shadow gate run the models' forward
passes (the flash forward kernel for a Transformer machine) and the
refit's CV folds and fit run the forward, dq and dk/dv kernels. The
manager's entry points run on the card unless ``device="cpu"`` is given.

Its events (``machine_drifted``, ``refit_rejected``,
``revision_promoted``, ``lifecycle_tick_finished``) are written to the
event log, and its spans as the JAX tick's: ``lifecycle.tick`` over
``lifecycle.drift``, ``lifecycle.refit``, ``lifecycle.shadow`` and
``lifecycle.promote``. The registry carries
``gordo_lifecycle_tick_seconds``, ``gordo_lifecycle_machines_total
{outcome}`` (each drifted machine's decision) and
``gordo_lifecycle_drifted_machines``; ``.lifecycle/last_tick.json`` is
the tick's ``/telemetry/snapshot`` with the process registry in its
``metrics`` block.
"""

import dataclasses
import json
import logging
import os
import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeoutError
from datetime import datetime, timedelta, timezone
from typing import Any, Dict, Iterator, List, Optional, Set, Tuple, Union

import numpy as np

from gordo_tpu_torch import serializer
from gordo_tpu_torch.builder.fleet_build import _find_torch_estimator
from gordo_tpu_torch.data import _get_dataset
from gordo_tpu_torch.device import DeviceLike, resolve_device
from gordo_tpu_torch.lifecycle import promote as promote_mod
from gordo_tpu_torch.lifecycle.drift import DriftAssessment, DriftMonitor
from gordo_tpu_torch.lifecycle.refit import (
    DEFAULT_SHADOW_TOLERANCE,
    ShadowVerdict,
    degrade_params,
    estimator_params,
    load_estimator_params,
    shadow_gate,
    shadow_score,
    warm_params_from_models,
)
from gordo_tpu_torch.machine import Machine
from gordo_tpu_torch.models.anomaly.diff import DiffBasedAnomalyDetector
from gordo_tpu_torch.models.utils import Frame
from gordo_tpu_torch.observability import emit_event, get_registry, tracing
from gordo_tpu_torch.observability.events import EVENT_LOG_ENV_VAR
from gordo_tpu_torch.robustness import faults
from gordo_tpu_torch.server.utils import resolution_to_timedelta
from gordo_tpu_torch.utils.atomic import atomic_write_json

logger = logging.getLogger(__name__)

#: lifecycle state lives in a dot directory beside the revisions, never
#: listed or selected as one
STATE_DIRNAME = ".lifecycle"


def parse_timestamp(text: str) -> datetime:
    """An ISO datetime as ``pd.Timestamp`` reads it (a trailing ``Z`` is
    UTC), at microsecond resolution."""
    text = str(text).strip()
    if text.endswith("Z"):
        text = text[:-1] + "+00:00"
    return datetime.fromisoformat(text)


def _utc_datetime64(stamp: datetime) -> np.datetime64:
    """An aware (UTC by conversion) or naive datetime as the data layer's
    UTC ``datetime64[ns]``."""
    if stamp.tzinfo is not None:
        stamp = stamp.astimezone(timezone.utc).replace(tzinfo=None)
    return np.datetime64(stamp, "ns")


@dataclasses.dataclass
class LifecycleConfig:
    """The knobs of one lifecycle cycle (the CLI's flags, one to one)."""

    #: the drift and refit window (ISO datetimes); None: each machine's
    #: own training window from its build metadata
    window_start: Optional[str] = None
    window_end: Optional[str] = None
    #: the window's last fraction, held out of the refit and scored by
    #: the shadow gate (candidate and live model on the same rows)
    holdout_fraction: float = 0.25
    #: a candidate may not regress the live holdout error by more
    shadow_tolerance: float = DEFAULT_SHADOW_TOLERANCE
    ewma_alpha: float = 0.3
    ratio_threshold: float = 1.0
    exceedance_threshold: float = 0.5
    min_observations: int = 1
    #: the refit's ``epoch_chunk``, as build-fleet's
    epoch_chunk: int = 1
    fetch_retries: int = 1
    #: seconds a machine's scan window fetch and its refit fetch may take
    #: (None: no cap); a hung source is recorded on its machine
    fetch_timeout: Optional[float] = None
    #: the JSONL event log whose ``stream_observation`` events assess the
    #: streamed machines without a window fetch; None: the
    #: ``GORDO_TPU_EVENT_LOG`` variable at tick time
    stream_observations: Optional[str] = None
    #: publish the new revision; False stops after the shadow verdicts
    promote: bool = True
    #: re-point the ``latest`` symlink at the new revision
    repoint: bool = True

    def __post_init__(self):
        if not 0.0 < float(self.holdout_fraction) < 1.0:
            raise ValueError(f"holdout_fraction must be in (0, 1), got {self.holdout_fraction}")
        if self.window_start is not None and self.window_end is not None:
            # an empty global window is an operator error; a machine's bad
            # metadata fails that machine only (drift_scan_failed)
            if parse_timestamp(self.window_end) <= parse_timestamp(self.window_start):
                raise ValueError(
                    f"Empty lifecycle window: {self.window_start} -> {self.window_end}"
                )


@dataclasses.dataclass
class TickResult:
    """What one cycle did (the CLI prints it as JSON)."""

    base_revision: str
    revision: Optional[str]
    revision_dir: Optional[str]
    n_machines: int
    monitored: List[str]
    drifted: List[str]
    promoted: List[str]
    rejected: List[str]
    quarantined: List[str]
    report: dict
    report_path: Optional[str]
    wall_time_s: float

    @property
    def noop(self) -> bool:
        return self.revision is None

    def to_dict(self) -> dict:
        out = dataclasses.asdict(self)
        out["noop"] = self.noop
        return out


class LifecycleManager:
    """
    Parameters
    ----------
    collection_dir
        The served revision: the revision directory itself or the
        ``latest`` symlink the server serves (a promotion flips the
        symlink; a plain directory is promoted into a sibling selectable
        by ``?revision=``).
    config
        :class:`LifecycleConfig`; None: the defaults.
    monitor
        A :class:`DriftMonitor`; None builds one persisting under
        ``<revisions' parent>/.lifecycle/drift_state.json``.
    device
        Where models score and refit: the card unless ``"cpu"``.
    """

    def __init__(
        self,
        collection_dir: Union[str, os.PathLike],
        config: Optional[LifecycleConfig] = None,
        monitor: Optional[DriftMonitor] = None,
        device: DeviceLike = None,
    ):
        self.pointer = str(collection_dir)
        self.config = config or LifecycleConfig()
        self.device = resolve_device(device)
        live_dir = os.path.realpath(self.pointer)
        self.state_dir = os.path.join(os.path.dirname(live_dir), STATE_DIRNAME)
        self.monitor = monitor or DriftMonitor(
            state_path=os.path.join(self.state_dir, "drift_state.json"),
            ewma_alpha=self.config.ewma_alpha,
            ratio_threshold=self.config.ratio_threshold,
            exceedance_threshold=self.config.exceedance_threshold,
            min_observations=self.config.min_observations,
        )
        self._pending_stream_cursor: Optional[Tuple[str, dict]] = None

    # -- the cycle -----------------------------------------------------------
    def tick(self) -> TickResult:
        """One whole cycle (the module docstring)."""
        with tracing.start_span("lifecycle.tick", pointer=self.pointer):
            result = self._tick()
        self._persist_last_tick(result)
        return result

    def _persist_last_tick(self, result: TickResult) -> None:
        """``.lifecycle/last_tick.json``, the tick's snapshot in the JAX
        plane's ``/telemetry/snapshot`` shape (``drift_scan_staleness_s``
        is read from it); a failed write never fails the tick."""
        from gordo_tpu_torch.observability import rollup

        payload = rollup.snapshot_payload(
            role="lifecycle",
            revision=result.revision or result.base_revision,
            status={
                "last_tick_unix_ms": int(time.time() * 1000),
                "base_revision": result.base_revision,
                "revision": result.revision,
                "n_machines": result.n_machines,
                "n_monitored": len(result.monitored),
                "n_drifted": len(result.drifted),
                "n_promoted": len(result.promoted),
                "n_quarantined": len(result.quarantined),
                "wall_time_s": round(result.wall_time_s, 4),
            },
        )
        try:
            atomic_write_json(os.path.join(self.state_dir, "last_tick.json"), payload,
                              default=str, trailing_newline=False)
        except OSError as exc:
            logger.warning("Lifecycle last-tick snapshot not written: %s", exc)

    def _tick(self) -> TickResult:
        start = time.perf_counter()
        live_dir = os.path.realpath(self.pointer)
        base_revision = os.path.basename(live_dir)
        carried = self._base_casualties(live_dir)
        names = sorted(
            name for name in os.listdir(live_dir)
            if not name.startswith(".") and os.path.isdir(os.path.join(live_dir, name))
            and name not in carried
        )
        decisions: Dict[str, dict] = {
            name: {"decision": "carried", "reason": reason} for name, reason in carried.items()
        }
        live_models: Dict[str, Any] = {}
        machines_meta: Dict[str, dict] = {}
        monitored: List[str] = []
        fetched: Dict[str, tuple] = {}

        # the stream feed first: a machine whose stream_observation events
        # cover this revision is assessed from them and skips the scan
        streamed_stats = self._consume_stream_observations(base_revision)
        streamed: Set[str] = set()
        with tracing.start_span("lifecycle.drift", n_machines=len(names)):
            for name in sorted(streamed_stats):
                if name not in names:
                    continue
                stats = streamed_stats[name]
                try:
                    assessment = self.monitor.observe_stats(
                        name, ratio=stats["ratio"], exceedance=stats["exceedance"],
                        revision=base_revision,
                    )
                except ValueError as exc:
                    logger.warning("Lifecycle: stream observations for %s unusable (%s); machine "
                                   "falls back to the scan", name, exc)
                    continue
                streamed.add(name)
                monitored.append(name)
                decisions[name] = {"decision": "retained", "reason": "no_drift", "source": "stream",
                                   "drift": assessment.to_dict()}

            # metadata first (local, cheap), then the windows fetched in pooled
            # chunks, each machine scored as its window lands: a model and its
            # frames stay resident only while the machine is drifted. One
            # machine's failure is recorded on it and the scan goes on.
            scan_windows: Dict[str, dict] = {}
            scan_failures: Dict[str, str] = {}
            for name in names:
                if name in streamed:
                    continue
                meta = self._load_metadata(live_dir, name)
                # loaded and dropped: a second local load is cheaper than the
                # window fetch of a machine that cannot be monitored
                if meta is None or self._load_monitorable(live_dir, name) is None:
                    decisions[name] = {"decision": "retained", "reason": "not_monitored"}
                    continue
                machines_meta[name] = meta
                try:
                    scan_windows[name] = self._machine_window(meta)
                except Exception as exc:  # noqa: BLE001 - fault domain
                    scan_failures[name] = str(exc)
            for name, data in self._iter_windows(scan_windows, machines_meta, scan_failures):
                model = self._load_monitorable(live_dir, name)
                if model is None:
                    scan_failures[name] = "artifact became unloadable during the scan"
                    continue
                try:
                    assessment = self._score_one(name, model, data, base_revision,
                                                 machines_meta[name])
                except Exception as exc:  # noqa: BLE001 - fault domain
                    scan_failures[name] = str(exc)
                    continue
                monitored.append(name)
                decisions[name] = {"decision": "retained", "reason": "no_drift",
                                   "drift": assessment.to_dict()}
                if assessment.drifted:
                    live_models[name] = model
                    fetched[name] = data
            for name in sorted(scan_failures):
                logger.warning("Lifecycle: drift scan failed for %s (%s); machine retained "
                               "this tick", name, scan_failures[name])
                decisions[name] = {"decision": "retained", "reason": "drift_scan_failed",
                                   "error": scan_failures[name]}
        monitored.sort()
        self.monitor.save()
        self._commit_stream_cursor()
        drifted = [n for n in monitored if self.monitor.state(n).drifted]
        get_registry().gauge(
            "gordo_lifecycle_drifted_machines",
            "Machines currently past a drift criterion (last tick)",
        ).set(len(drifted))

        if not drifted:
            return self._finish(start, base_revision, names, monitored, drifted,
                                decisions=decisions, promoted=[], rejected=[], quarantined=[],
                                revision_dir=None)
        logger.info("Drift detected on %d/%d machines: %s", len(drifted), len(monitored), drifted)

        # a streamed machine drifted without a fetch; its refit and shadow
        # need the live model and a window, fetched now for the drifted
        # streamed machines only
        stream_failures: Dict[str, str] = {}
        to_fetch: Dict[str, dict] = {}
        for name in [n for n in drifted if n in streamed]:
            meta = machines_meta.get(name) or self._load_metadata(live_dir, name)
            model = self._load_monitorable(live_dir, name)
            if meta is None or model is None:
                stream_failures[name] = "model or metadata not loadable"
                continue
            machines_meta[name] = meta
            try:
                scan_windows[name] = self._machine_window(meta)
            except Exception as exc:  # noqa: BLE001 - fault domain
                stream_failures[name] = str(exc)
                continue
            to_fetch[name] = scan_windows[name]
            live_models[name] = model
        for name, data in self._iter_windows(to_fetch, machines_meta, stream_failures):
            fetched[name] = data
        for name in sorted(stream_failures):
            logger.warning("Lifecycle: refit window for streamed machine %s unavailable (%s); "
                           "machine retained this tick", name, stream_failures[name])
            decisions[name].update(decision="retained", reason="refit_data_unavailable",
                                   error=stream_failures[name])
            drifted.remove(name)
            live_models.pop(name, None)
        if not drifted:
            return self._finish(start, base_revision, names, monitored, drifted,
                                decisions=decisions, promoted=[], rejected=[], quarantined=[],
                                revision_dir=None)

        window = {name: scan_windows[name] for name in drifted}
        with tracing.start_span("lifecycle.refit", n_machines=len(drifted)):
            candidates, quarantine_records, refit_failures = self._refit(
                drifted, machines_meta, window, live_models)

        promoted: List[str] = []
        rejected: List[str] = []
        quarantined: List[str] = []
        with tracing.start_span("lifecycle.shadow", n_machines=len(drifted)):
            for name in drifted:
                record = decisions[name]
                record["drift"] = record.get("drift") or {}
                if name in quarantine_records:
                    quarantined.append(name)
                    record.update(decision="quarantined", reason="refit_nonfinite",
                                  quarantine=quarantine_records[name])
                    continue
                if name not in candidates:
                    record.update(decision="retained", reason="refit_failed",
                                  error=refit_failures.get(name))
                    continue
                verdict = self._shadow_one(name, live_models[name], candidates[name][0],
                                           fetched[name], window[name])
                record["shadow"] = verdict.to_dict()
                if verdict.promote:
                    promoted.append(name)
                    record.update(decision="promoted", reason="drifted_passed_shadow")
                else:
                    rejected.append(name)
                    record.update(decision="retained", reason="shadow_rejected")
                    emit_event("refit_rejected", machine=name, live_score=verdict.live_score,
                               candidate_score=verdict.candidate_score, tolerance=verdict.tolerance)

        revision_dir: Optional[str] = None
        if self.config.promote and (promoted or quarantined):
            with tracing.start_span("lifecycle.promote", n_promoted=len(promoted),
                                    n_quarantined=len(quarantined)):
                revision_dir = str(self._promote(live_dir, base_revision, decisions,
                                                 candidates, quarantine_records))
                if self.config.repoint and os.path.islink(self.pointer):
                    promote_mod.repoint_latest(self.pointer, revision_dir)
                # the new revision gives every machine a fresh baseline
                self.monitor.reset()
                self.monitor.save()

        return self._finish(start, base_revision, names, monitored, drifted,
                            decisions=decisions, promoted=promoted, rejected=rejected,
                            quarantined=quarantined, revision_dir=revision_dir)

    # -- phases --------------------------------------------------------------
    @staticmethod
    def _load_metadata(live_dir: str, name: str) -> Optional[dict]:
        """The machine's build metadata, or None when it does not load."""
        try:
            return serializer.load_metadata(os.path.join(live_dir, name))
        except Exception as exc:  # noqa: BLE001 - per-machine tolerance
            logger.warning("Lifecycle: metadata for %s does not load (%s)", name, exc)
            return None

    def _load_monitorable(self, live_dir: str, name: str) -> Optional[Any]:
        """The machine's model when its artifact loads and is an anomaly
        detector with a calibrated aggregate threshold, else None."""
        try:
            model = serializer.load(os.path.join(live_dir, name), self.device)
        except Exception as exc:  # noqa: BLE001 - per-machine tolerance
            logger.warning("Lifecycle: artifact %s does not load (%s)", name, exc)
            return None
        threshold = getattr(model, "aggregate_threshold_", None)
        if not isinstance(model, DiffBasedAnomalyDetector) or not threshold:
            logger.debug("Lifecycle: %s is not an anomaly detector with calibrated thresholds; "
                         "not drift-monitored", name)
            return None
        return model

    def _iter_windows(
        self,
        scan_windows: Dict[str, dict],
        machines_meta: Dict[str, dict],
        scan_failures: Dict[str, str],
    ) -> Iterator[Tuple[str, tuple]]:
        """
        ``(name, (X, y))`` of each machine's window, fetched concurrently
        in chunks of the pool's width and yielded in name order; the
        consumer scores each before the next chunk is submitted, so the
        frames held stay bounded by the chunk. A fetch that raises or
        exceeds ``fetch_timeout`` lands in ``scan_failures`` instead.
        """
        if not scan_windows:
            return
        ordered = sorted(scan_windows)
        width = min(8, len(ordered))
        pool = ThreadPoolExecutor(max_workers=width)
        hung = False
        try:
            for i in range(0, len(ordered), width):
                futures = {
                    name: pool.submit(self._fetch_window, machines_meta[name],
                                      scan_windows[name]["start"], scan_windows[name]["end"])
                    for name in ordered[i: i + width]
                }
                for name, future in futures.items():
                    try:
                        yield name, future.result(timeout=self.config.fetch_timeout)
                    except FutureTimeoutError:
                        hung = True  # the thread cannot be interrupted
                        future.cancel()
                        scan_failures[name] = (
                            f"window fetch exceeded {self.config.fetch_timeout}s")
                    except Exception as exc:  # noqa: BLE001 - fault domain
                        scan_failures[name] = str(exc)
        finally:
            # a hung fetch thread must not wedge the tick at teardown
            pool.shutdown(wait=not hung, cancel_futures=True)

    def _score_one(self, name: str, model: Any, data: tuple, base_revision: str,
                   meta: dict) -> DriftAssessment:
        """Anomaly-score one machine's window and feed the monitor."""
        X, y = data
        shift = faults.drift_shift_scale(name)
        if shift is not None:
            # the chaos harness's sensor drift: inputs and targets move
            # together, as a drifting sensor's would
            X = Frame(X.values + shift, X.columns, X.index)
            y = Frame(y.values + shift, y.columns, y.index)
        resolution = meta["dataset"].get("resolution") or "10min"
        frame = model.anomaly(X, y, frequency=resolution_to_timedelta(resolution))
        return self.monitor.observe(name, frame, threshold=float(model.aggregate_threshold_),
                                    revision=base_revision)

    def _refit(
        self,
        drifted: List[str],
        machines_meta: Dict[str, dict],
        window: Dict[str, dict],
        live_models: Dict[str, Any],
    ) -> Tuple[Dict[str, tuple], Dict[str, dict], Dict[str, str]]:
        """
        The warm-start refit of the drifted machines, in memory (the
        promotion writes the winners), from the live models the scan
        holds: ``(candidates, quarantine records, refit failures)``.
        """
        from gordo_tpu_torch.builder.fleet_build import FleetModelBuilder

        refit_machines = []
        for name in drifted:
            spec = json.loads(json.dumps(machines_meta[name], default=str))
            # train on the window's head: the holdout tail is the gate's
            spec["dataset"]["train_start_date"] = window[name]["start"]
            spec["dataset"]["train_end_date"] = window[name]["split"]
            refit_machines.append(Machine.unvalidated(**spec))

        builder = FleetModelBuilder(
            refit_machines,
            epoch_chunk=self.config.epoch_chunk,
            on_error="skip",  # one poisoned machine must not end the cycle
            fetch_retries=self.config.fetch_retries,
            fetch_timeout=self.config.fetch_timeout,
            device=self.device,
            initial_params=warm_params_from_models(live_models),
            fault_sites=("train", "refit"),
        )
        built = builder.build()
        candidates = {machine.name: (model, machine) for model, machine in built}
        quarantine_records = {rec["machine"]: dict(rec) for rec in builder.quarantined_}
        refit_failures = {
            rec["machine"]: f"{rec.get('phase', 'build')}: {rec.get('error')}"
            for rec in builder.build_failures_
        }
        # a quarantined machine's candidate holds rolled-back weights: it
        # never reaches the shadow gate
        for name in quarantine_records:
            candidates.pop(name, None)
        return candidates, quarantine_records, refit_failures

    def _shadow_one(self, name: str, live_model: Any, candidate_model: Any, data: tuple,
                    window: dict) -> ShadowVerdict:
        """Candidate against live model on the window's holdout tail, cut
        from the frames the scan fetched (no second fetch)."""
        degrade = faults.refit_degrade_scale(name)
        if degrade is not None:
            est = _find_torch_estimator(candidate_model)
            if est is not None and hasattr(est, "spec_"):
                load_estimator_params(est, degrade_params(estimator_params(est), degrade))
        X, y = data
        split = _utc_datetime64(parse_timestamp(window["split"]))
        X_hold = np.asarray(X.values)[np.asarray(X.index) >= split]
        y_hold = np.asarray(y.values)[np.asarray(y.index) >= split]
        live_score = shadow_score(live_model, X_hold, y_hold)
        candidate_score = shadow_score(candidate_model, X_hold, y_hold)
        return ShadowVerdict(
            machine=name,
            live_score=live_score,
            candidate_score=candidate_score,
            tolerance=self.config.shadow_tolerance,
            promote=shadow_gate(live_score, candidate_score, self.config.shadow_tolerance),
        )

    def _promote(self, live_dir: str, base_revision: str, decisions: Dict[str, dict],
                 candidates: Dict[str, tuple], quarantine_records: Dict[str, dict]):
        base_report = self._read_build_report(live_dir)
        build_report = {
            "kind": "lifecycle_promotion",
            "base_revision": base_revision,
            "on_error": "skip",
            "failed": list(base_report.get("failed") or []),
            "quarantined": list(base_report.get("quarantined") or []) + [
                {"machine": name, "epoch": rec.get("epoch"), "phase": "refit"}
                for name, rec in sorted(quarantine_records.items())
            ],
        }
        build_report["n_failed"] = len(build_report["failed"])
        build_report["n_quarantined"] = len(build_report["quarantined"])
        promotion_report = {
            "kind": "lifecycle_promotion",
            "base_revision": base_revision,
            "window": {
                "start": self.config.window_start,
                "end": self.config.window_end,
                "holdout_fraction": self.config.holdout_fraction,
            },
            "shadow_tolerance": self.config.shadow_tolerance,
            "decisions": decisions,
            "counts": _decision_counts(decisions),
        }
        return promote_mod.assemble_revision(live_dir, decisions, candidates, build_report,
                                             promotion_report)

    # -- bookkeeping ---------------------------------------------------------
    def _finish(
        self,
        start: float,
        base_revision: str,
        names: List[str],
        monitored: List[str],
        drifted: List[str],
        decisions: Dict[str, dict],
        promoted: List[str],
        rejected: List[str],
        quarantined: List[str],
        revision_dir: Optional[str],
    ) -> TickResult:
        wall = time.perf_counter() - start
        revision = os.path.basename(revision_dir) if revision_dir is not None else None
        reg = get_registry()
        reg.histogram("gordo_lifecycle_tick_seconds", "One whole lifecycle cycle").observe(wall)
        counter = reg.counter("gordo_lifecycle_machines_total", "Lifecycle decisions by outcome",
                              ("outcome",))
        for name in drifted:
            outcome = ("promoted" if name in promoted else "quarantined" if name in quarantined
                       else "rejected" if name in rejected else "retained")
            counter.inc(outcome=outcome)
        report = {
            "base_revision": base_revision,
            "revision": revision,
            "decisions": decisions,
            "counts": _decision_counts(decisions),
        }
        report_path = (os.path.join(revision_dir, promote_mod.PROMOTION_REPORT_FILENAME)
                       if revision_dir is not None else None)
        if revision is not None:
            emit_event("revision_promoted", revision=revision, base_revision=base_revision,
                       n_promoted=len(promoted), n_rejected=len(rejected),
                       n_quarantined=len(quarantined))
        emit_event(
            "lifecycle_tick_finished",
            base_revision=base_revision,
            revision=revision,
            n_machines=len(names),
            n_monitored=len(monitored),
            n_drifted=len(drifted),
            n_promoted=len(promoted),
            n_rejected=len(rejected),
            n_quarantined=len(quarantined),
            wall_time_s=round(wall, 4),
        )
        return TickResult(
            base_revision=base_revision,
            revision=revision,
            revision_dir=revision_dir,
            n_machines=len(names),
            monitored=monitored,
            drifted=drifted,
            promoted=promoted,
            rejected=rejected,
            quarantined=quarantined,
            report=report,
            report_path=report_path,
            wall_time_s=wall,
        )

    def _consume_stream_observations(self, base_revision: str) -> Dict[str, dict]:
        """
        Drain the ``stream_observation`` events of the event log (config
        ``stream_observations``, else ``GORDO_TPU_EVENT_LOG``) and
        aggregate them per machine, weighted by rows: the statistic one
        scan window over the same rows gives. A byte cursor under
        ``.lifecycle/`` makes it incremental across ticks; a log that
        shrank (rotated or truncated) starts over, a torn last line is
        left for the next tick, and an observation of another revision
        than ``base_revision`` is dropped (counted in the log).
        """
        self._pending_stream_cursor = None
        path = self.config.stream_observations or os.environ.get(EVENT_LOG_ENV_VAR, "")
        if not path or not os.path.isfile(path):
            return {}
        path = os.path.abspath(path)
        cursor_path = os.path.join(self.state_dir, "stream_cursor.json")
        offset = 0
        try:
            with open(cursor_path) as fh:
                cursor = json.load(fh)
            if cursor.get("path") == path:
                offset = int(cursor.get("offset", 0))
        except (OSError, ValueError, TypeError, AttributeError):
            offset = 0
        try:
            if os.path.getsize(path) < offset:
                offset = 0
        except OSError:
            return {}
        totals: Dict[str, List[float]] = {}
        consumed = offset
        dropped_revisions = 0
        try:
            with open(path, "rb") as fh:
                fh.seek(offset)
                for raw in fh:
                    if not raw.endswith(b"\n"):
                        break  # a torn last line: the next tick's
                    consumed += len(raw)
                    try:
                        record = json.loads(raw)
                    except ValueError:
                        continue
                    if not isinstance(record, dict) or record.get("event") != "stream_observation":
                        continue
                    machine = record.get("machine")
                    try:
                        n = int(record.get("n") or 0)
                        ratio = float(record.get("ratio_mean"))
                        exceedance = float(record.get("exceedance"))
                    except (TypeError, ValueError):
                        continue
                    if not machine or n <= 0:
                        continue
                    if record.get("revision") != base_revision:
                        dropped_revisions += 1
                        continue
                    bucket = totals.setdefault(machine, [0.0, 0.0, 0.0])
                    bucket[0] += n
                    bucket[1] += n * ratio
                    bucket[2] += n * exceedance
        except OSError as exc:
            logger.warning("Lifecycle: stream observation log %s unreadable (%s); falling back "
                           "to the scan", path, exc)
            return {}
        if consumed != offset:
            # committed only after monitor.save(): a tick that dies in
            # between drains the same bytes again
            self._pending_stream_cursor = (cursor_path, {"path": path, "offset": consumed})
        if dropped_revisions:
            logger.info("Lifecycle: dropped %d stream observation(s) stamped by other revisions "
                        "than %s", dropped_revisions, base_revision)
        return {
            machine: {"n": int(n), "ratio": ratio_sum / n, "exceedance": exceedance_sum / n}
            for machine, (n, ratio_sum, exceedance_sum) in totals.items()
        }

    def _commit_stream_cursor(self) -> None:
        """Persist the advanced stream cursor, after ``monitor.save()``."""
        pending = self._pending_stream_cursor
        if pending:
            atomic_write_json(*pending)
            self._pending_stream_cursor = None

    def _machine_window(self, meta: dict) -> dict:
        """The machine's drift and refit window and its holdout split, as
        the ISO strings ``pd.Timestamp.isoformat`` gives: the config's
        window or the machine's own training window."""
        dataset = meta["dataset"]
        start = parse_timestamp(self.config.window_start or dataset["train_start_date"])
        end = parse_timestamp(self.config.window_end or dataset["train_end_date"])
        if end <= start:
            raise ValueError(f"Empty lifecycle window: {start.isoformat()} -> {end.isoformat()}")
        # in whole microseconds, truncated, as pandas multiplies a Timedelta
        delta = end - start
        delta_us = (delta.days * 86400 + delta.seconds) * 1_000_000 + delta.microseconds
        split = start + timedelta(microseconds=int(delta_us * (1.0 - self.config.holdout_fraction)))
        return {"start": start.isoformat(), "split": split.isoformat(), "end": end.isoformat()}

    @staticmethod
    def _fetch_window(meta: dict, start: str, end: str) -> Tuple[Frame, Frame]:
        """(X, y) frames of one machine over [start, end], through its own
        dataset config; the rows are labelled with their UTC
        ``datetime64[ns]`` stamps."""
        config = json.loads(json.dumps(meta["dataset"], default=str))
        config["train_start_date"] = start
        config["train_end_date"] = end
        dataset = _get_dataset(config)
        X, y, index = dataset.get_data()
        columns = _x_columns(dataset, X.shape[1])
        X_frame = Frame(np.asarray(X), columns, index)
        if y is None:
            return X_frame, X_frame
        y_columns = list(getattr(dataset, "target_columns", None) or range(y.shape[1]))
        return X_frame, Frame(np.asarray(y), y_columns, index)

    @staticmethod
    def _base_casualties(live_dir: str) -> Dict[str, str]:
        """Machine -> reason, for the live revision's recorded casualties:
        they answer 409, cannot be scored, and carry their records into
        a promoted revision."""
        report = LifecycleManager._read_build_report(live_dir)
        out: Dict[str, str] = {}
        for record in report.get("failed") or []:
            if record.get("machine"):
                out[record["machine"]] = f"{record.get('phase', 'build')}_failed"
        for record in report.get("quarantined") or []:
            if record.get("machine"):
                out[record["machine"]] = "quarantined"
        return out

    @staticmethod
    def _read_build_report(live_dir: str) -> dict:
        path = os.path.join(live_dir, promote_mod.BUILD_REPORT_FILENAME)
        try:
            with open(path) as fh:
                return json.load(fh)
        except FileNotFoundError:
            return {}
        except (OSError, ValueError):
            logger.warning("Unreadable build report at %s; ignoring", path)
            return {}


def _x_columns(dataset, width: int) -> List[str]:
    """The input columns' names of a fetched dataset (its tags' joined
    columns), or ordinals when it does not name them."""
    tags = getattr(dataset, "tag_list", None)
    columns_of = getattr(dataset, "_columns_of", None)
    if tags is not None and columns_of is not None:
        names = [name for tag in tags for name in columns_of(tag)]
        if len(names) == width:
            return names
    return [str(i) for i in range(width)]


def _decision_counts(decisions: Dict[str, dict]) -> dict:
    counts: Dict[str, int] = {}
    for record in decisions.values():
        counts[record["decision"]] = counts.get(record["decision"], 0) + 1
    return counts
