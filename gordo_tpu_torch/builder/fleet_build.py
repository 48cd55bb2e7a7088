"""
FleetModelBuilder: build many machines in one process, a bucket at a time
(the port of ``gordo_tpu.builder.fleet_build``).

Machines are grouped into buckets by their model definition and widths
(``gordo_tpu_torch.parallel.bucketing``); each bucket's data is fetched
(per machine, with retries), passed through each machine's own prefix
transformers on the host, stacked on one zero-padded grid, and trained as
one :class:`~gordo_tpu_torch.parallel.fleet.FleetTrainer` fit: first the
three ``TimeSeriesSplit`` folds, each a fleet fit with per-machine fold
masks, which give every machine its CV scores and, for an anomaly
detector, its thresholds; then the final fit on all rows. Each machine
then gets its own estimator and artifact (``definition.json``,
``params.npz``, ``metadata.json`` with the JAX fleet build's metadata
keys), and the build writes ``build_report.json`` with the JAX build's
keys for its casualties.

Supported model shapes, as in JAX: a bare port estimator, a ``Pipeline``
of prefix transformers ending in one, and a ``DiffBasedAnomalyDetector``
over either. A bucket with no port estimator falls back to the
per-machine :class:`~gordo_tpu_torch.builder.ModelBuilder`.

``on_error="raise"`` aborts on the first machine whose fetch or build
fails (with the original exception, so the CLI's exit code names its
kind); ``"skip"`` records the casualty in ``build_failures_`` and builds
the others. A machine that the non-finite guard quarantines in its final
fit keeps its last finite weights and is named in ``quarantined_``.

``prefetch_depth`` above 0 pipelines each bucket's host-to-device
transfers (``gordo_tpu_torch.parallel.transfer``): the stacked data as
sliced, staged copies and the trainer's next epoch chunk's vector; the
artifacts are the same bits at every depth, and ``telemetry_report.json``
counts the build's transfers by plane and mode.

``build(resume=True)`` reuses each machine whose artifact under the
output directory loads and was built from its current model and dataset
config, and builds the rest (:meth:`FleetModelBuilder._scan_resumable`);
a machine the previous run's ``build_report.json`` names as a casualty
is always rebuilt. ``n_resumed`` in the report counts the reused ones.

Left out, because the TPU-era builder does them for XLA: the program
and compile caches, AOT export of serving programs, the device mesh and
fleet padding to it, and the multi-worker ledger, warm starts and fault
injection (ROADMAP.md queue 1 item 9).
``precision="bf16"``/``"auto"`` calibrates each bucket after its final
fit (:meth:`FleetModelBuilder._calibrate_precision`).
"""

import json
import logging
import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeoutError
from datetime import datetime, timezone
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

from gordo_tpu_torch import __version__, serializer
from gordo_tpu_torch.builder.build_model import ModelBuilder, _inject_seed
from gordo_tpu_torch.data import InsufficientDataError, _get_dataset
from gordo_tpu_torch.device import DeviceLike, resolve_device
from gordo_tpu_torch.machine import Machine
from gordo_tpu_torch.machine.metadata import (
    BuildMetadata,
    CrossValidationMetaData,
    DatasetBuildMetadata,
    ModelBuildMetadata,
)
from gordo_tpu_torch.models.anomaly.diff import DiffBasedAnomalyDetector, rolled_threshold
from gordo_tpu_torch.models.callbacks import EarlyStopping
from gordo_tpu_torch.models.core import BaseTorchEstimator, _materialize_callbacks, as_2d
from gordo_tpu_torch.models.pipeline import Pipeline
from gordo_tpu_torch.models.utils import DEFAULT_METRICS, METRICS, TimeSeriesSplit
from gordo_tpu_torch.parallel.bucketing import get_policy, timestep_bucket
from gordo_tpu_torch.parallel import transfer
from gordo_tpu_torch.parallel.fleet import FleetTrainer, StackedData
from gordo_tpu_torch.parallel.precision import (
    DEFAULT_PRECISION_TOLERANCE,
    mae,
    mae_parity,
    resolve_precision,
)
from gordo_tpu_torch.utils import atomic
from gordo_tpu_torch.utils.utils import backoff_seconds

logger = logging.getLogger(__name__)

#: the casualty record written next to the artifacts
BUILD_REPORT_FILENAME = "build_report.json"
#: the build's timings, by bucket
TELEMETRY_REPORT_FILENAME = "telemetry_report.json"


class MachineFetchError(RuntimeError):
    """One machine's data fetch failed after its retries."""

    def __init__(self, machine_name: str, attempts: int, cause: BaseException):
        super().__init__(
            f"Data fetch for machine {machine_name!r} failed after {attempts} attempt(s): "
            f"{cause!r}"
        )
        self.machine_name = machine_name
        self.attempts = attempts
        self.cause = cause


def _find_torch_estimator(model) -> Optional[BaseTorchEstimator]:
    """The port estimator at the end of a (nested) model, or None."""
    if isinstance(model, BaseTorchEstimator):
        return model
    if isinstance(model, DiffBasedAnomalyDetector):
        return _find_torch_estimator(model.base_estimator)
    if isinstance(model, Pipeline):
        return _find_torch_estimator(model.steps[-1][1])
    return None


def _prefix_transformers(model) -> list:
    """The host steps applied before the estimator, in order (a nested
    pipeline's too)."""
    if isinstance(model, DiffBasedAnomalyDetector):
        return _prefix_transformers(model.base_estimator)
    if isinstance(model, Pipeline):
        return [step for _, step in model.steps[:-1]] + _prefix_transformers(model.steps[-1][1])
    return []


class FleetModelBuilder:
    """
    Parameters
    ----------
    machines
        The machines to build (any mix; they are bucketed).
    data_threads
        Threads of the data-fetch phase.
    epoch_chunk
        Default ``FleetTrainer(epoch_chunk=...)``; a machine's ``epoch_chunk``
        fit argument overrides it for its bucket. Scheduling only.
    on_error
        ``"raise"`` or ``"skip"`` (see the module note).
    fetch_retries
        Retries of a machine's fetch, with :func:`backoff_seconds` between.
    fetch_timeout
        Seconds a machine's fetch (all attempts) may run; None waits.
    bucket_policy
        ``"exact"`` (default) or ``"padded"``
        (``gordo_tpu_torch.parallel.bucketing``).
    device
        Where the buckets train: the card unless ``"cpu"``.
    precision
        Inference precision: ``"float32"`` (default: no calibration),
        ``"auto"`` (each machine serves bf16 when its bf16 predictions'
        relative MAE delta is within ``precision_tolerance``, else
        float32) or ``"bf16"`` (every machine serves bf16; a breach is
        logged). Training is float32 in every mode
        (``gordo_tpu_torch.parallel.precision``).
    precision_tolerance
        The calibration's relative MAE tolerance.
    prefetch_depth
        Host-to-device transfer pipelining depth (module note); 0, the
        default, copies as the builder always did.
    """

    def __init__(
        self,
        machines: List[Machine],
        data_threads: int = 8,
        epoch_chunk: int = 1,
        on_error: str = "raise",
        fetch_retries: int = 2,
        fetch_timeout: Optional[float] = None,
        bucket_policy: Any = "exact",
        device: DeviceLike = None,
        precision: str = "float32",
        precision_tolerance: float = DEFAULT_PRECISION_TOLERANCE,
        prefetch_depth: int = 0,
    ):
        if on_error not in ("raise", "skip"):
            raise ValueError(f"on_error must be 'raise' or 'skip', got {on_error!r}")
        self.machines = machines
        self.data_threads = data_threads
        self.epoch_chunk = max(1, int(epoch_chunk))
        self.on_error = on_error
        self.fetch_retries = max(0, int(fetch_retries))
        self.fetch_timeout = fetch_timeout
        self._policy = get_policy(bucket_policy)
        self.bucket_policy = self._policy.name
        self.device = resolve_device(device)
        self.precision = resolve_precision(precision)
        self.precision_tolerance = float(precision_tolerance)
        self.prefetch_depth = transfer.clip_depth(prefetch_depth)
        #: per machine: {"precision", "mae_delta", "forced"}; empty for float32
        self.precision_decisions_: Dict[str, dict] = {}
        self.plan_ = None
        self.transfers_: Dict[str, int] = {}
        self.build_failures_: List[dict] = []
        self.quarantined_: List[dict] = []
        self.bucket_reports_: List[dict] = []
        self.build_report_: Optional[dict] = None
        self.telemetry_report_: Optional[dict] = None
        self.n_resumed_ = 0

    # -- data ------------------------------------------------------------
    def _fetch_one(self, machine: Machine) -> dict:
        dataset = _get_dataset(machine.dataset.to_dict())
        start = time.perf_counter()
        X, y, _ = dataset.get_data()
        return {
            "machine": machine,
            "dataset": dataset,
            "X": X,
            "y": y if y is not None else X,
            "query_duration": time.perf_counter() - start,
        }

    def _fetch_with_retries(self, machine: Machine) -> dict:
        attempts = self.fetch_retries + 1
        for attempt in range(1, attempts + 1):
            try:
                return self._fetch_one(machine)
            except Exception as exc:
                if attempt >= attempts:
                    raise MachineFetchError(machine.name, attempt, exc) from exc
                delay = backoff_seconds(attempt)
                logger.warning(
                    "Data fetch for machine %s failed (attempt %d of %d): %r; retrying in %.1fs",
                    machine.name, attempt, attempts, exc, delay,
                )
                time.sleep(delay)

    def fetch_data(self, machines: List[Machine]) -> Tuple[List[dict], List[dict]]:
        """
        Every machine's data, fetched concurrently, each machine its own
        fault domain: (fetched in input order, casualty records). Under
        ``on_error="raise"`` the first casualty raises its original cause.
        A machine's ``fetch_timeout`` counts from when its fetch started.
        """
        fetched: List[dict] = []
        failures: List[dict] = []
        pool = ThreadPoolExecutor(max_workers=self.data_threads)
        hung = False

        def task(machine, started):
            started["t"] = time.monotonic()
            try:
                return self._fetch_with_retries(machine)
            finally:
                started["end"] = time.monotonic()

        try:
            futures = []
            for machine in machines:
                started: dict = {"t": None}
                futures.append((machine, pool.submit(task, machine, started), started))
            # when any machine last resolved: a queued machine whose pool is
            # wedged by hung fetches times out too
            progress = {"t": time.monotonic()}
            for machine, future, started in futures:
                try:
                    fetched.append(self._await_fetch(future, started, progress))
                except FutureTimeoutError:
                    hung = True
                    future.cancel()
                    if self.on_error == "raise":
                        raise TimeoutError(
                            f"Data fetch for machine {machine.name!r} exceeded "
                            f"{self.fetch_timeout}s"
                        )
                    failures.append(self._record_failure(
                        machine.name, "fetch",
                        f"TimeoutError: fetch exceeded {self.fetch_timeout}s", None,
                    ))
                except MachineFetchError as exc:
                    if self.on_error == "raise":
                        raise exc.cause
                    failures.append(
                        self._record_failure(machine.name, "fetch", repr(exc.cause), exc.attempts)
                    )
                finally:
                    progress["t"] = time.monotonic()
            return fetched, failures
        finally:
            pool.shutdown(wait=not hung, cancel_futures=True)

    def _await_fetch(self, future, started: dict, progress: dict) -> dict:
        """One machine's fetch, its ``fetch_timeout`` counted from when it
        started running: a fetch still running at its deadline, or one
        that ended after it, is a timeout; one that ended in time is its
        result, however long the caller took to ask (JAX's builder also
        times out a fetch that ended in time when it is asked late). A
        machine still queued times out once nothing has resolved for a
        whole ``fetch_timeout`` (hung fetches hold every thread)."""
        if self.fetch_timeout is None:
            return future.result()
        while started["t"] is None:  # still queued: its clock has not started
            if time.monotonic() - progress["t"] > self.fetch_timeout:
                raise FutureTimeoutError()
            try:
                future.exception(timeout=0.2)
            except FutureTimeoutError:
                continue
        deadline = started["t"] + self.fetch_timeout
        try:
            future.exception(timeout=max(0.0, deadline - time.monotonic()))
        except FutureTimeoutError:
            raise
        if started.get("end", deadline) > deadline:
            raise FutureTimeoutError()
        return future.result()

    def _record_failure(
        self, machine_name: str, phase: str, error: str, attempts: Optional[int]
    ) -> dict:
        record = {"machine": machine_name, "phase": phase, "error": error, "attempts": attempts}
        self.build_failures_.append(record)
        logger.error(
            "Machine %s failed in %s phase (on_error=skip; recorded): %s",
            machine_name, phase, error,
        )
        return record

    # -- build -----------------------------------------------------------
    def build(
        self, output_dir_base: Optional[Union[str, Path]] = None, resume: bool = False
    ) -> List[Tuple[Any, Machine]]:
        """
        (model, machine) of every machine that built, in the input order;
        with ``output_dir_base`` each artifact is written to
        ``<output_dir_base>/<machine name>`` as its bucket completes, then
        ``build_report.json`` and ``telemetry_report.json`` beside them.
        ``resume`` (which needs ``output_dir_base``) reuses the machines
        whose artifacts there are current and builds only the rest.
        """
        if resume and output_dir_base is None:
            raise ValueError("resume=True requires output_dir_base")
        base = Path(output_dir_base) if output_dir_base is not None else None
        build_start = time.perf_counter()
        started = str(datetime.now(timezone.utc).astimezone())
        self.build_failures_, self.quarantined_, self.bucket_reports_ = [], [], []
        self.precision_decisions_ = {}
        results: Dict[str, Tuple[Any, Machine]] = {}
        to_build = list(self.machines)
        if resume:
            reused, to_build = self._scan_resumable(to_build, base)
            results.update(reused)
            if reused:
                logger.info("Resume: %d/%d machines already built under %s",
                            len(reused), len(self.machines), base)
        self.n_resumed_ = len(results)
        self.plan_ = plans = self._policy.plan(to_build) if to_build else []
        transfers_before = dict(transfer.transfer_counts)
        logger.info(
            "Fleet build: %d machines in %d buckets (policy=%s)",
            len(to_build), len(plans), self.bucket_policy,
        )
        for plan in plans:
            results.update(self._build_bucket_entry(plan.machines, base))
        self.transfers_ = {
            f"{plane}/{mode}": n - transfers_before.get((plane, mode), 0)
            for (plane, mode), n in sorted(transfer.transfer_counts.items())
            if n != transfers_before.get((plane, mode), 0)
        }
        self._finish(base, started, time.perf_counter() - build_start,
                     len(results) - self.n_resumed_, len(plans))
        return [results[m.name] for m in self.machines if m.name in results]

    @staticmethod
    def _prior_casualties(base: Path) -> Dict[str, str]:
        """Machine -> status from an earlier run's ``build_report.json``
        under ``base`` ({} when it is missing or unreadable)."""
        try:
            report = json.loads((base / BUILD_REPORT_FILENAME).read_text())
        except (OSError, ValueError):
            return {}
        out: Dict[str, str] = {}
        for record in report.get("failed") or []:
            if record.get("machine"):
                out[record["machine"]] = f"{record.get('phase', 'build')}-failed"
        for record in report.get("quarantined") or []:
            if record.get("machine"):
                out[record["machine"]] = "quarantined"
        return out

    def _scan_resumable(
        self, machines: List[Machine], base: Path
    ) -> Tuple[Dict[str, Tuple[Any, Machine]], List[Machine]]:
        """(reused (model, machine) by name, machines to build): a machine
        is reused when its artifact under ``base`` loads and its stored
        model and dataset configs equal its current ones. A casualty of
        the previous run is rebuilt, never reused: a quarantined machine's
        artifact holds frozen weights, and reusing it while this run
        rewrites the report would serve them as healthy."""
        prior = self._prior_casualties(base)
        reused: Dict[str, Tuple[Any, Machine]] = {}
        remaining: List[Machine] = []
        for machine in machines:
            art_dir = base / machine.name
            if machine.name in prior:
                logger.info("Resume: rebuilding %s (recorded as %s by the previous run)",
                            machine.name, prior[machine.name])
                remaining.append(machine)
                continue
            if not (art_dir / serializer.METADATA_FILENAME).is_file():
                remaining.append(machine)
                continue
            try:
                model = serializer.load(art_dir, self.device)
                stored = serializer.load_metadata(art_dir)
                current = machine.to_dict()
                if (stored.get("model") != current.get("model")
                        or stored.get("dataset") != current.get("dataset")):
                    logger.warning("Artifact at %s was built from a different model/dataset "
                                   "config; rebuilding %s", art_dir, machine.name)
                    remaining.append(machine)
                    continue
                # the current request's user metadata and runtime on the
                # stored build metadata
                stored["metadata"]["user_defined"] = machine.metadata.user_defined
                stored["runtime"] = machine.runtime
                restored = Machine.unvalidated(**stored)
            except Exception:  # a partial or damaged artifact: rebuild
                logger.warning("Artifact at %s exists but does not load; rebuilding %s",
                               art_dir, machine.name)
                remaining.append(machine)
                continue
            reused[machine.name] = (model, restored)
            est = _find_torch_estimator(model)
            if self.precision != "float32" and est is not None:
                # a reused artifact's decision rides its weights file
                self.precision_decisions_[machine.name] = {
                    "precision": getattr(est, "precision_", "float32"),
                    "mae_delta": getattr(est, "precision_mae_delta_", None),
                    "forced": False,
                    "resumed": True,
                }
        return reused, remaining

    def _finish(self, base, started: str, wall: float, n_built: int, n_buckets: int) -> None:
        finished = str(datetime.now(timezone.utc).astimezone())
        self.build_report_ = {
            "version": 1,
            "kind": "fleet_build_report",
            "started": started,
            "finished": finished,
            "on_error": self.on_error,
            "n_machines": len(self.machines),
            "n_built": n_built,
            "n_resumed": self.n_resumed_,
            "n_failed": len(self.build_failures_),
            "n_quarantined": len(self.quarantined_),
            "failed": list(self.build_failures_),
            "quarantined": list(self.quarantined_),
            "precision": {
                "mode": self.precision,
                "tolerance": self.precision_tolerance,
                "machines": {name: dict(rec) for name, rec in self.precision_decisions_.items()},
            },
        }
        self.telemetry_report_ = {
            "kind": "fleet_build",
            "started": started,
            "finished": finished,
            "wall_time_s": wall,
            "n_machines": len(self.machines),
            "n_built": n_built,
            "n_resumed": self.n_resumed_,
            "n_buckets": n_buckets,
            "bucket_policy": self.bucket_policy,
            "precision": self.precision,
            "prefetch_depth": self.prefetch_depth,
            "transfers": dict(self.transfers_),
            "models_per_hour": n_built / wall * 3600 if wall > 0 else None,
            "buckets": self.bucket_reports_,
            "on_error": self.on_error,
            "machines_failed": list(self.build_failures_),
            "machines_quarantined": list(self.quarantined_),
        }
        if base is not None:
            for name, report in ((BUILD_REPORT_FILENAME, self.build_report_),
                                 (TELEMETRY_REPORT_FILENAME, self.telemetry_report_)):
                atomic.atomic_write_json(base / name, report, indent=2, sort_keys=True,
                                         default=str, trailing_newline=False)

    def _flush(self, pairs, base: Optional[Path]) -> None:
        if base is None:
            return
        for model, machine in pairs:
            serializer.dump(model, base / machine.name, machine.to_dict())

    def _build_bucket_entry(
        self, bucket: List[Machine], base: Optional[Path]
    ) -> Dict[str, Tuple[Any, Machine]]:
        """One bucket end to end: the fleet path when it has a port
        estimator, the per-machine builder otherwise; artifacts written as
        they complete, casualties recorded under ``on_error="skip"``."""
        results: Dict[str, Tuple[Any, Machine]] = {}
        if _find_torch_estimator(serializer.from_definition(bucket[0].model)) is None:
            logger.info(
                "Bucket of %d machine(s) has no port estimator; falling back to "
                "per-machine builds", len(bucket),
            )
            for machine in bucket:
                try:
                    results[machine.name] = ModelBuilder(machine).build(device=self.device)
                except Exception as exc:
                    if self.on_error == "raise":
                        raise
                    self._record_failure(machine.name, "build", repr(exc), None)
                    continue
                self._flush([results[machine.name]], base)
            return results
        try:
            built = self._build_bucket(bucket)
        except Exception as exc:
            if self.on_error == "raise":
                raise
            already = {f["machine"] for f in self.build_failures_}
            for machine in bucket:
                if machine.name not in already:
                    self._record_failure(machine.name, "build", repr(exc), None)
            return results
        self._flush(built.values(), base)
        return built

    def _build_bucket(self, bucket: List[Machine]) -> Dict[str, Tuple[Any, Machine]]:
        bucket_start = time.perf_counter()
        fetched, failures = self.fetch_data(bucket)
        if failures:
            bucket = [item["machine"] for item in fetched]
            if not bucket:
                return {}

        # per machine on the host: the model, its seed, its fitted prefix
        # transformers and transformed X
        models = [serializer.from_definition(item["machine"].model) for item in fetched]
        seeds = [int(item["machine"].evaluation.get("seed", 0)) for item in fetched]
        for model, seed in zip(models, seeds):
            _inject_seed(model, seed)
        estimators = [_find_torch_estimator(model) for model in models]
        Xs: List[np.ndarray] = []
        ys: List[np.ndarray] = []
        for model, item in zip(models, fetched):
            X = np.asarray(item["X"], dtype=np.float32)
            for transformer in _prefix_transformers(model):
                X = np.asarray(transformer.fit_transform(X), dtype=np.float32)
            Xs.append(X)
            ys.append(as_2d(item["y"]))

        in_widths = [X.shape[1] for X in Xs]
        out_widths = [y.shape[1] for y in ys]
        f_prog, f_out_prog = self._policy.program_dims(in_widths, out_widths)
        for est in estimators:
            est.kwargs.update({"n_features": f_prog, "n_features_out": f_out_prog})
        proto = estimators[0]
        spec = proto._build_spec()
        lookahead = proto.lookahead if spec.windowed else 0

        # a machine that cannot fill one window fails before training
        if spec.windowed:
            min_rows = spec.lookback_window + lookahead
            short = [i for i, X in enumerate(Xs) if len(X) < min_rows]
            if short:
                message = (
                    "{name}: {rows} rows after transforms; this windowed model needs at least "
                    f"{min_rows} (lookback {spec.lookback_window} + lookahead {lookahead})"
                )
                if self.on_error == "raise":
                    i = short[0]
                    raise InsufficientDataError(
                        "Machine " + message.format(name=fetched[i]["machine"].name, rows=len(Xs[i]))
                    )
                for i in short:
                    name = fetched[i]["machine"].name
                    self._record_failure(
                        name, "build",
                        "InsufficientDataError: " + message.format(name=name, rows=len(Xs[i])),
                        None,
                    )
                keep = [i for i in range(len(fetched)) if i not in set(short)]
                fetched, models, estimators, seeds, Xs, ys = (
                    [seq[i] for i in keep] for seq in (fetched, models, estimators, seeds, Xs, ys)
                )
                bucket = [item["machine"] for item in fetched]
                if not bucket:
                    return {}

        n_grid = timestep_bucket(max(len(X) for X in Xs))
        data = StackedData.from_ragged(
            Xs, ys, n_timesteps=n_grid, n_features=f_prog, n_features_out=f_out_prog,
            device=self.device, prefetch_depth=self.prefetch_depth,
        )
        fit_args = proto.extract_supported_fit_args(proto.kwargs)
        epochs = int(fit_args.get("epochs", 1))
        batch_size = int(fit_args.get("batch_size", 32))
        es_kwargs = self._early_stopping_kwargs(fit_args)
        config_chunk = fit_args.get("epoch_chunk")
        epoch_chunk = max(1, int(self.epoch_chunk if config_chunk is None else config_chunk))
        trainer = FleetTrainer(
            spec, lookahead=lookahead, epoch_chunk=epoch_chunk, device=self.device,
            seed=seeds[0], prefetch_depth=self.prefetch_depth,
        )
        # each machine starts from its own solo init: the same weights
        # whichever builder trains it
        init = trainer.stack_params([
            {name: value.detach().clone() for name, value in est._initial_state(spec, seed).items()}
            for est, seed in zip(estimators, seeds)
        ])
        names = [item["machine"].name for item in fetched]

        start = time.perf_counter()
        folds = self._run_cv_folds(
            trainer, data, init, Xs, ys, models, epochs=epochs, batch_size=batch_size,
            es_kwargs=es_kwargs, machine_names=names,
        )
        cv_duration = time.perf_counter() - start
        cv_telemetry = trainer.fit_telemetry_

        start = time.perf_counter()
        params, losses = trainer.fit(
            data, params=init, epochs=epochs, batch_size=batch_size, machine_names=names,
            **es_kwargs,
        )
        fit_duration = time.perf_counter() - start

        n_quarantined = 0
        for i in np.flatnonzero(~trainer.healthy_[: len(fetched)]):
            n_quarantined += 1
            epoch = int(trainer.quarantine_epoch_[i])
            self.quarantined_.append({"machine": names[i], "epoch": epoch})
            logger.warning(
                "Machine %s was quarantined at epoch %d; its artifact holds the last "
                "finite params", names[i], epoch,
            )

        precision_records: Dict[str, dict] = {}
        if self.precision != "float32":
            precision_records = self._calibrate_precision(
                trainer, params, data, Xs, ys, estimators, names, out_widths, spec, lookahead
            )

        host_params = trainer.unstack_all(params, len(fetched))
        offset = None
        out: Dict[str, Tuple[Any, Machine]] = {}
        for i, (model, est, item) in enumerate(zip(models, estimators, fetched)):
            history = {
                "loss": list(trainer.history_[i]["loss"]),
                "params": {
                    "epochs": epochs,
                    "batch_size": batch_size,
                    "samples": int(len(Xs[i])),
                    "metrics": ["loss"] + (["val_loss"] if "val_loss" in trainer.history_[i]
                                           else []),
                    "fleet_size": len(bucket),
                },
            }
            if "val_loss" in trainer.history_[i]:
                history["val_loss"] = list(trainer.history_[i]["val_loss"])
            est._set_fitted(est._build_spec(), host_params[i], self.device, f_prog, f_out_prog,
                            history)
            if in_widths[i] != f_prog or out_widths[i] != f_out_prog:
                est.n_active_features_ = in_widths[i]
                est.n_active_features_out_ = out_widths[i]
            if isinstance(model, DiffBasedAnomalyDetector):
                model.scaler.fit(as_2d(item["y"], dtype=None))
                self._apply_thresholds(model, folds, i)
            if offset is None:
                # window arithmetic, the same for the whole bucket: the
                # prefix transformers keep every row
                offset = len(item["X"]) - len(model.predict(np.asarray(item["X"])))
            machine_out = Machine.unvalidated(**item["machine"].to_dict())
            machine_out.metadata.build_metadata = BuildMetadata(
                model=ModelBuildMetadata(
                    model_offset=offset,
                    model_creation_date=str(datetime.now(timezone.utc).astimezone()),
                    model_builder_version=__version__,
                    model_training_duration_sec=fit_duration,
                    cross_validation=CrossValidationMetaData(
                        cv_duration_sec=cv_duration,
                        scores=folds["scores"][i],
                        splits=folds["splits"][i],
                    ),
                    model_meta=model.get_metadata(),
                ),
                dataset=DatasetBuildMetadata(
                    query_duration_sec=item["query_duration"],
                    dataset_meta=item["dataset"].get_metadata(),
                ),
            )
            out[item["machine"].name] = (model, machine_out)

        bucket_wall = time.perf_counter() - bucket_start
        self.bucket_reports_.append({
            "machines": names,
            "n_machines": len(bucket),
            "n_timesteps_grid": int(n_grid),
            "n_features": int(f_prog),
            "n_features_out": int(f_out_prog),
            "bucket_policy": self.bucket_policy,
            "epochs": epochs,
            "batch_size": batch_size,
            "cv_duration_s": cv_duration,
            "fit_duration_s": fit_duration,
            "bucket_wall_s": bucket_wall,
            "n_machines_quarantined": n_quarantined,
            "models_per_hour": len(bucket) / bucket_wall * 3600 if bucket_wall > 0 else None,
            "cv_fit": cv_telemetry,
            "fit": trainer.fit_telemetry_,
            "device": str(self.device),
            "precision": self.precision,
            **({"precision_decisions": precision_records} if precision_records else {}),
        })
        logger.info(
            "Bucket of %d machine(s) built in %.3f s (CV %.3f s, fit %.3f s, %d steps an epoch)",
            len(bucket), bucket_wall, cv_duration, fit_duration,
            trainer.fit_telemetry_["steps_per_epoch"],
        )
        return out

    def _calibrate_precision(
        self,
        trainer: FleetTrainer,
        params: dict,
        data: StackedData,
        Xs: List[np.ndarray],
        ys: List[np.ndarray],
        estimators: List[BaseTorchEstimator],
        names: List[str],
        out_widths: List[int],
        spec: Any,
        lookahead: int,
    ) -> Dict[str, dict]:
        """
        The bf16 calibration (JAX ``FleetModelBuilder._calibrate_precision``):
        the bucket predicted once in float32 and once with weights and
        inputs cast to bfloat16, each machine's MAE compared over its real
        rows and active output columns, and the decision stamped on its
        estimator (``precision_``, ``precision_mae_delta_``). ``auto``
        serves bf16 within the tolerance and float32 beyond it; ``bf16``
        serves bf16 and logs a breach.
        """
        preds32 = trainer.predict(params, data.X)
        preds16 = trainer.predict(params, data.X, precision="bf16")
        offset = spec.lookback_window - 1 + lookahead if spec.windowed else 0
        records: Dict[str, dict] = {}
        for i, name in enumerate(names):
            n_out = max(0, len(Xs[i]) - offset)
            cols = int(out_widths[i])
            y_true = np.asarray(ys[i], dtype=np.float32)[offset: offset + n_out, :cols]
            delta, within = mae_parity(mae(preds32[i, :n_out, :cols], y_true),
                                       mae(preds16[i, :n_out, :cols], y_true),
                                       self.precision_tolerance)
            if self.precision == "bf16":
                decided = "bf16"
                if not within:
                    logger.warning(
                        "Machine %s: bf16 MAE delta %.4f exceeds tolerance %.4f but "
                        "--precision bf16 overrides the fallback",
                        name, delta, self.precision_tolerance,
                    )
            else:
                decided = "bf16" if within else "float32"
            estimators[i].precision_ = decided
            estimators[i].precision_mae_delta_ = float(delta)
            records[name] = {"precision": decided, "mae_delta": float(delta), "forced": False}
        self.precision_decisions_.update(records)
        n_bf16 = sum(rec["precision"] == "bf16" for rec in records.values())
        logger.info(
            "Precision calibration (%s, tolerance %s): %d of %d machine(s) serve bf16",
            self.precision, self.precision_tolerance, n_bf16, len(records),
        )
        return records

    @staticmethod
    def _early_stopping_kwargs(fit_args: dict) -> dict:
        """
        A bucket's fit configuration as the fleet trainer's arguments:
        ``validation_split`` as the per-machine holdout, and an
        EarlyStopping on a loss monitor as the per-machine gate (on the
        validation loss when the solo callback would monitor it). A
        callback with no fleet counterpart is ignored with a warning, and
        a non-loss monitor trains the full epoch budget, as in JAX.
        """
        out: dict = {}
        split = float(fit_args.get("validation_split") or 0.0)
        if split > 0.0:
            out["validation_split"] = split
        for cb in _materialize_callbacks(fit_args.get("callbacks")):
            if not isinstance(cb, EarlyStopping):
                logger.warning(
                    "Fleet build: callback %s does not translate to the fleet path and is "
                    "ignored there", type(cb).__name__,
                )
                continue
            if "loss" not in cb.monitor or cb.mode == "max":
                logger.warning(
                    "Fleet build: EarlyStopping(monitor=%r, mode=%r) does not translate to "
                    "the fleet path (loss-family metrics only); training the full epoch "
                    "budget", cb.monitor, cb.mode,
                )
                return out
            out.update(
                early_stopping_patience=int(cb.patience),
                early_stopping_min_delta=abs(float(cb.min_delta)),
                early_stopping_start_from_epoch=int(cb.start_from_epoch),
                restore_best_weights=bool(cb.restore_best_weights),
                early_stopping_on_val="val" in cb.monitor and split > 0.0,
            )
            return out
        return out

    def _run_cv_folds(
        self,
        trainer: FleetTrainer,
        data: StackedData,
        init: dict,
        Xs: List[np.ndarray],
        ys: List[np.ndarray],
        models: list,
        epochs: int,
        batch_size: int,
        n_splits: int = 3,
        es_kwargs: Optional[dict] = None,
        machine_names: Optional[List[str]] = None,
    ) -> dict:
        """
        ``TimeSeriesSplit`` folds of each machine's rows, each fold one
        fleet fit with per-machine train masks and the final fit's early
        stopping; per machine: the four default metrics on the test rows
        (unscaled), the splits' sizes, and for a detector its per-fold
        and final thresholds (a scaler fitted on the fold's training
        targets, ``rolled_threshold`` over 6 rows).
        """
        m, n_grid = data.sample_weight.shape
        lb = trainer.spec.lookback_window if trainer.spec.windowed else 1
        offset = lb - 1 + trainer.lookahead
        splitter = TimeSeriesSplit(n_splits=n_splits)
        machine_folds = [list(splitter.split(np.zeros((len(X), 1)))) for X in Xs]
        n = len(Xs)
        metrics = {name.replace("_", "-"): METRICS[name] for name in DEFAULT_METRICS}
        raw = [{name: [] for name in metrics} for _ in range(n)]
        splits: List[dict] = [{} for _ in range(n)]
        tag_thr: List[Optional[np.ndarray]] = [None] * n
        agg_thr: List[Optional[float]] = [None] * n
        tag_per_fold: List[dict] = [{} for _ in range(n)]
        agg_per_fold: List[dict] = [{} for _ in range(n)]
        for fold in range(n_splits):
            mask = np.zeros((m, n_grid), dtype=np.float32)
            for i in range(n):
                train_idx, test_idx = machine_folds[i][fold]
                mask[i, train_idx] = 1.0
                splits[i].update({
                    f"fold-{fold + 1}-n-train": int(len(train_idx)),
                    f"fold-{fold + 1}-n-test": int(len(test_idx)),
                })
            fold_params, _ = trainer.fit(
                data, params=init, epochs=epochs, batch_size=batch_size, extra_weight=mask,
                machine_names=machine_names, **(es_kwargs or {}),
            )
            preds = trainer.predict(fold_params, data.X)  # (M, n_out, f_out)
            for i, model in enumerate(models):
                train_idx, test_idx = machine_folds[i][fold]
                # output row j predicts input row j + offset
                rows_out = test_idx - offset
                valid = rows_out >= 0
                y_pred = preds[i][rows_out[valid]][:, : ys[i].shape[1]]
                y_true = ys[i][test_idx[valid]]
                for name, metric in metrics.items():
                    raw[i][name].append(float(metric(y_true, y_pred)))
                if isinstance(model, DiffBasedAnomalyDetector):
                    scaler = model.scaler.clone().fit(ys[i][train_idx])
                    scaled_mse = ((scaler.transform(y_pred) - scaler.transform(y_true)) ** 2).mean(
                        axis=1
                    )
                    agg = rolled_threshold(scaled_mse, 6)
                    tags = rolled_threshold(np.abs(y_pred - y_true), 6)
                    agg_per_fold[i][f"fold-{fold}"] = float(agg) if np.isfinite(agg) else None
                    tag_per_fold[i][f"fold-{fold}"] = tags
                    tag_thr[i], agg_thr[i] = tags, agg
        scores = []
        for i in range(n):
            machine_scores = {}
            for name, values in raw[i].items():
                arr = np.asarray(values)
                entry = {"fold-mean": float(arr.mean()), "fold-std": float(arr.std()),
                         "fold-max": float(arr.max()), "fold-min": float(arr.min())}
                entry.update({f"fold-{k + 1}": float(v) for k, v in enumerate(values)})
                machine_scores[name] = entry
            scores.append(machine_scores)
        return {
            "scores": scores,
            "splits": splits,
            "tag_thresholds": tag_thr,
            "agg_thresholds": agg_thr,
            "tag_thr_per_fold": tag_per_fold,
            "agg_thr_per_fold": agg_per_fold,
        }

    @staticmethod
    def _apply_thresholds(model: DiffBasedAnomalyDetector, folds: dict, i: int) -> None:
        """A detector's thresholds from the bucket's fold fits (no smoothed
        ones, as in JAX's fleet build)."""
        model.cv_fleet_masks_ = True
        model.feature_thresholds_ = folds["tag_thresholds"][i]
        agg = folds["agg_thresholds"][i]
        model.aggregate_threshold_ = float(agg) if agg is not None else None
        model.feature_thresholds_per_fold_ = dict(folds["tag_thr_per_fold"][i])
        model.aggregate_thresholds_per_fold_ = dict(folds["agg_thr_per_fold"][i])
        model.smooth_aggregate_threshold_ = None
        model.smooth_feature_thresholds_ = None
