"""
The port's command line (the counterpart of ``gordo_tpu.cli``'s
``build``, ``build-fleet`` and ``run-server``), on argparse::

    python -m gordo_tpu_torch.cli build [MACHINE] [OUTPUT_DIR] [--device cpu]
        [--model-register-dir DIR] [--model-parameter KEY,VALUE ...]
        [--print-cv-scores] [--exceptions-reporter-file FILE]
        [--exceptions-report-level EXIT_CODE|TYPE|MESSAGE|TRACEBACK]
    python -m gordo_tpu_torch.cli build-fleet [MACHINES] [OUTPUT_DIR] [--device cpu]
        [--machines-from FILE] [--epoch-chunk K] [--on-error raise|skip]
        [--bucket-policy exact|padded] [--fetch-retries N] [--fetch-timeout S]
        [--prefetch-depth N] [--model-parameter KEY,VALUE ...]
        [--print-cv-scores] [--exceptions-reporter-file FILE]
        [--exceptions-report-level EXIT_CODE|TYPE|MESSAGE|TRACEBACK]
        [--resume | --no-resume] [--workers N|auto] [--worker-id ID]
        [--lease-ttl S] [--max-attempts N]
    python -m gordo_tpu_torch.cli build-fleet --ledger-status OUTPUT_DIR
    python -m gordo_tpu_torch.cli buckets plan [MACHINES] [--machines-from FILE] ...
    python -m gordo_tpu_torch.cli telemetry summarize DIRECTORY [--as-json]
    python -m gordo_tpu_torch.cli sweep [MACHINE] --param NAME=V1,V2,... [--param ...]
        [--epochs N] [--batch-size N] [--epoch-chunk K] [--device cpu]
        [--exceptions-reporter-file FILE] [--exceptions-report-level ...]
    python -m gordo_tpu_torch.cli run-server [--collection-dir DIR] [--device cpu]
        [--shard-manifest FILE --replica-id ID] ...
    python -m gordo_tpu_torch.cli run-router --collection-dir DIR --replica ID=URL ...
    python -m gordo_tpu_torch.cli lifecycle tick --model-collection-dir DIR [--device cpu]
        [--window-start ISO --window-end ISO] [--holdout-fraction F]
        [--shadow-tolerance F] [--ewma-alpha A] [--ratio-threshold R]
        [--exceedance-threshold E] [--min-observations N] [--epoch-chunk K]
        [--fetch-retries N] [--fetch-timeout S] [--stream-observations LOG]
        [--promote | --no-promote] [--repoint | --no-repoint]
    python -m gordo_tpu_torch.cli lifecycle watch ... [--interval-s S] [--max-cycles N]
    python -m gordo_tpu_torch.cli lifecycle report REVISION_DIR
    python -m gordo_tpu_torch.cli client [...] predict|metadata|download-model ...
    python -m gordo_tpu_torch.cli trace summarize|export PATH ...
    python -m gordo_tpu_torch.cli tune plan|fit|calibrate ...
    python -m gordo_tpu_torch.cli slo check SPEC SNAPSHOT_OR_URL [--as-json]
    python -m gordo_tpu_torch.cli top STATUS_URL [--interval S] [--once] [--as-json]
    python -m gordo_tpu_torch.cli rollup --member ID=URL ... [--once] ...
    python -m gordo_tpu_torch.cli gameday list|run [NAMES...] ... [--device cpu]
    python -m gordo_tpu_torch.cli profile report|flame PATH ...

``build`` builds one machine (fetch and resample its dataset,
cross-validate and derive the thresholds, fit) and writes the port's
artifact to OUTPUT_DIR. MACHINE is the machine's config as YAML (JSON
is YAML too), read by the port's YAML reader and taken as the JAX
command takes it: ``Machine.from_config(machine, project_name=
machine["project_name"])``, with no project globals of its own. Both
fall back to the ``MACHINE`` and ``OUTPUT_DIR`` environment variables,
and OUTPUT_DIR to ``/data``. Training runs on the card unless ``--device cpu`` is
given. ``--model-register-dir`` (``MODEL_REGISTER_DIR``) caches the build
(``ModelBuilder``'s cache). A model config given as a string is a
template: ``--model-parameter key,value`` fills its ``{{ key }}``
variables first (:func:`expand_model`). A failed build exits with the
JAX command's code for the kind of failure (``EXIT_CODES``) and, with
``--exceptions-reporter-file``, leaves the report of
``--exceptions-report-level`` there (``cli.exceptions_reporter``;
``MESSAGE``, ``{"type", "message"}``, by default).

``build-fleet`` builds a YAML list of machines in one process with
``gordo_tpu_torch.builder.fleet_build.FleetModelBuilder`` (bucketed, each
bucket's CV folds and final fit one fleet fit) into
``OUTPUT_DIR/<machine>``, with ``build_report.json`` beside them. The
list comes from the argument, ``MACHINES`` or ``--machines-from``, and
OUTPUT_DIR from the argument or ``OUTPUT_DIR``. Exit codes and the
``FAILED <machine> (<phase>): ...`` and ``QUARANTINED <machine> at epoch
<e> ...`` lines are the JAX command's. ``--prefetch-depth``
(``GORDO_PREFETCH_DEPTH``, 0-8) pipelines each bucket's host-to-device
transfers. ``--resume`` (``GORDO_FLEET_RESUME``) reuses the machines
whose artifacts in OUTPUT_DIR are current and builds the rest.
``--workers N`` (``GORDO_BUILD_WORKERS``; ``auto``: half the cores, at
most 4) spawns N worker processes, each ``build-fleet --worker-id i``
(``GORDO_WORKER_ID``), that share the buckets through the crash-tolerant
work ledger under ``OUTPUT_DIR/.ledger`` (``builder/ledger.py``): a
worker killed mid-build costs one unit of rework once its lease has gone
``--lease-ttl`` seconds (``GORDO_LEASE_TTL``, 60) without a heartbeat,
and a unit whose workers died ``--max-attempts`` times
(``GORDO_MAX_ATTEMPTS``, 3) becomes a casualty. The workers get the
command's options, ``--device`` among them, and the FAILED and
QUARANTINED lines come from the merged report. ``--ledger-status DIR``
prints the ledger's units and workers and exits. Its options that the
port does not have (``UNPORTED_FLEET_OPTIONS``) are usage errors naming
their ROADMAP.md item or reason: none is ignored. The tunable options
(``FLEET_TUNED_OPTIONS``: ``--epoch-chunk``, ``--bucket-policy``,
``--workers``, ``--lease-ttl``, ``--precision``, ``--prefetch-depth``)
take the flag, else the environment variable, else OUTPUT_DIR's
``tuning_profile.json`` (``tuning/profile.py``; one
``tuning_profile_loaded`` event names what it applied), else the
default. An orchestrator resolves them once and hands its workers
explicit flags; a profile that recommends a knob the port lacks is a
usage error naming it.

``buckets plan`` (``cli/buckets.py``) prints how ``--bucket-policy``
groups a machines list, as ``build-fleet`` and its ledger would;
``telemetry summarize DIRECTORY`` aggregates every
``telemetry_report*.json`` and JSONL event log under DIRECTORY
(``observability/report.py``), as text or, with ``--as-json``, as the
JAX command's versioned payload.

``sweep`` trains the optimizer-hyperparameter grid of ``--param`` entries
on MACHINE's data as one fleet (``gordo_tpu_torch.parallel.sweep``),
after fitting its prefix transformers, with the epochs and batch size
its build would use, and prints each trial's final loss in Katib's
``key=value`` form, best first, then the best hyperparameters. Started
by torchrun on more than one rank, it starts the process group
(``parallel.distributed.initialize``) and shards the variants over the
ranks (``parallel.mesh.auto_device_mesh``); in one process nothing
changes.

``run-router`` fronts ``run-server`` replicas that each serve a shard of
one collection (``gordo_tpu_torch.router``); it needs no card. With
``--rollup-interval S`` (``GORDO_ROLLUP_INTERVAL_S``) it polls its
replicas' snapshots every S seconds into its ``/status`` and
``/metrics``, and with ``--rollup-persist FILE`` (``GORDO_ROLLUP_PERSIST``)
appends each merge to FILE, keeping ``--rollup-retention``
(``GORDO_ROLLUP_RETENTION``, 500) lines.

``lifecycle`` is the JAX command group of that name
(``gordo_tpu_torch.lifecycle``), with its flags and its JSON: ``tick``
runs one drift scan, warm-start refit of the drifted machines, shadow
gate and promotion over the collection ``--model-collection-dir``
(``MODEL_COLLECTION_DIR``) names, usually its ``latest`` symlink, and
prints the tick's summary; ``watch`` runs ticks every ``--interval-s``
(one JSON line a cycle; a failed cycle is logged and the loop goes on)
and stops after ``--max-cycles``, or when a promoted revision was not
adopted (a plain directory or ``--no-repoint``); ``report`` renders a
promoted revision's decisions and exits 1 for a revision that has none.
Scoring and refits run on the card unless ``--device cpu`` is given.

``client`` (``cli/client.py``) predicts, reads metadata and downloads
models from a server or router with the port's client; ``trace``
(``cli/trace.py``) summarizes and exports span logs; ``slo``, ``top`` and
``rollup`` (``cli/plane.py``) read a serving plane's merged telemetry;
``tune`` (``cli/tune.py``) fits a collection's tuning profile from its
telemetry and measures a corpus with ``tune calibrate``; ``gameday``
(``cli/gameday.py``) runs fault timelines against an in-process plane;
``profile`` (``cli/profile.py``) renders a wall-profiler dump
(``GORDO_PROFILE_HZ``). They parse their own options; only ``tune
calibrate`` and ``gameday run`` touch the card.
"""

import argparse
import json
import logging
import os
import re
import sys
import time
import traceback
from typing import List, Optional

from gordo_tpu_torch import serializer
from gordo_tpu_torch.builder import ModelBuilder
from gordo_tpu_torch.builder import ledger as fleet_ledger
from gordo_tpu_torch.cli.exceptions_reporter import ExceptionsReporter, ReportLevel
from gordo_tpu_torch.data import InsufficientDataError, SensorTagNormalizationError
from gordo_tpu_torch.data.datasets import InsufficientDataAfterRowFilteringError
from gordo_tpu_torch.data.providers import NoSuitableDataProviderError
from gordo_tpu_torch.machine import Machine, ReporterException
from gordo_tpu_torch.parallel import transfer
from gordo_tpu_torch.robustness.faults import WORKER_ID_ENV_VAR
from gordo_tpu_torch.tuning.profile import TunedOption, UnportedKnobError, resolve_tuned_options
from gordo_tpu_torch.workflow.yaml_reader import safe_load

logger = logging.getLogger(__name__)

#: exception class -> exit code, the most derived registered class of a
#: raised exception deciding (the JAX command's table)
EXIT_CODES = {
    Exception: 1,
    PermissionError: 20,
    FileNotFoundError: 30,
    SensorTagNormalizationError: 60,
    NoSuitableDataProviderError: 70,
    InsufficientDataError: 80,
    InsufficientDataAfterRowFilteringError: 81,
    ReporterException: 90,
}
_exceptions_reporter = ExceptionsReporter(EXIT_CODES.items())
#: the termination message's budget (a 2024-byte message, less room for
#: the JSON around it)
MAX_MESSAGE_LEN = 2024 - 500
#: a ``{{ name }}`` variable of a model template
_TEMPLATE_VARIABLE = re.compile(r"\{\{\s*([A-Za-z_][A-Za-z0-9_]*)\s*\}\}")


def exit_code(exc_type: type) -> int:
    return _exceptions_reporter.exception_exit_code(exc_type)


def _report_failure(args) -> int:
    """The current exception's traceback on stderr, its report at
    ``--exceptions-report-level`` in ``--exceptions-reporter-file`` (if
    given), and its exit code."""
    traceback.print_exc()
    exc_type, exc_value, exc_traceback = sys.exc_info()
    if args.exceptions_reporter_file:
        _exceptions_reporter.safe_report(
            ReportLevel.get_by_name(args.exceptions_report_level, ReportLevel.EXIT_CODE),
            exc_type, exc_value, exc_traceback, args.exceptions_reporter_file,
            max_message_len=MAX_MESSAGE_LEN,
        )
    return exit_code(exc_type)


def expand_model(model_config: str, model_parameters: dict):
    """
    A model config template with its ``{{ name }}`` variables filled from
    ``model_parameters``, read as YAML (the JAX command renders it with
    jinja2, which the card's machine lacks; variables are the part of
    jinja2 a template needs). An undefined name raises the JAX command's
    ``ValueError("Model parameter missing value!")``; any other jinja2
    syntax (statements, comments, filters, expressions) raises
    ``ValueError`` saying it is not rendered.
    """
    missing = [name for name in _TEMPLATE_VARIABLE.findall(model_config)
               if name not in model_parameters]
    if missing:
        raise ValueError("Model parameter missing value!") from KeyError(missing[0])
    rendered = _TEMPLATE_VARIABLE.sub(lambda m: str(model_parameters[m.group(1)]), model_config)
    for opener in ("{{", "{%", "{#"):
        if opener in rendered:
            raise ValueError(
                f"The model template uses jinja2 syntax beyond {{{{ name }}}} variables "
                f"({opener!r} ...), which the port does not render"
            )
    logger.info("Expanded model config: %s", rendered)
    return safe_load(rendered)


def _expand(config: dict, model_parameter) -> None:
    """Fill a string model config's variables in place, as the JAX command
    does before it reads the machine."""
    if model_parameter and isinstance(config.get("model"), str):
        config["model"] = expand_model(config["model"], dict(model_parameter))


def _key_value(text: str):
    """``key,value`` -> (key, value); a missing comma is a usage error."""
    if "," not in text:
        raise argparse.ArgumentTypeError(
            f"Expected 'key,value' (comma-separated), got {text!r}"
        )
    return tuple(text.split(",", 1))


def score_strings(machine: Machine) -> List[str]:
    """CV scores as ``metric_fold=value`` lines (Katib's format)."""
    scores = machine.metadata.build_metadata.model.cross_validation.scores
    return [
        f"{metric.replace(' ', '-')}_{name.replace(' ', '-')}={value}"
        for metric, by_name in scores.items()
        for name, value in by_name.items()
    ]


def build(args) -> int:
    try:
        _expand(args.machine, args.model_parameter)
        machine = Machine.from_config(args.machine, project_name=args.machine["project_name"])
        logger.info("Building, output will be at: %s", args.output_dir)
        _, machine = ModelBuilder(machine).build(
            output_dir=args.output_dir, device=args.device,
            model_register_dir=args.model_register_dir,
        )
        machine.report()
        if args.print_cv_scores:
            for line in score_strings(machine):
                print(line)
    except Exception:
        return _report_failure(args)
    return 0


#: build-fleet options of the JAX command that the port does not have:
#: (flag, environment variable, value that asks for nothing the port
#: lacks, where the work stands). Any other value is a usage error.
UNPORTED_FLEET_OPTIONS = (
    ("--aot-cache", "GORDO_AOT_CACHE", None,
     "ROADMAP.md queue 1 item 9: programs/ stays out of the port"),
    # the flag only: a build pod's MODEL_REGISTER_DIR is meant for `build`
    ("--model-register-dir", None, None,
     "ROADMAP.md queue 1 item 7: the JAX fleet builder takes it and caches nothing, "
     "so the port refuses it rather than ignore it"),
)


BUCKET_POLICIES = ("exact", "padded")
PRECISIONS = ("float32", "bf16", "auto")


#: build-fleet's options a tuning profile may default (the JAX command's
#: tunable builder and ledger knobs): knob, attribute, variable, type,
#: built-in default
FLEET_TUNED_OPTIONS = (
    TunedOption("epoch_chunk", "epoch_chunk", "GORDO_EPOCH_CHUNK", int, 1),
    TunedOption("bucket_policy", "bucket_policy", "GORDO_BUCKET_POLICY", str, "exact"),
    TunedOption("build_workers", "workers", fleet_ledger.WORKERS_ENV_VAR, str, "1"),
    TunedOption("lease_ttl", "lease_ttl", fleet_ledger.LEASE_TTL_ENV_VAR, float,
                fleet_ledger.DEFAULT_LEASE_TTL_S),
    TunedOption("precision", "precision", "GORDO_PRECISION", str, "float32"),
    TunedOption("prefetch_depth", "prefetch_depth", "GORDO_PREFETCH_DEPTH", int, 0),
)


#: the environment variables build-fleet reads for the ledger's options
#: (``--workers``, ``--worker-id``, ``--lease-ttl``, ``--max-attempts``)
LEDGER_ENV_VARS = (fleet_ledger.WORKERS_ENV_VAR, WORKER_ID_ENV_VAR,
                   fleet_ledger.LEASE_TTL_ENV_VAR, fleet_ledger.MAX_ATTEMPTS_ENV_VAR)
#: every environment variable build-fleet reads for the ledger and for the
#: refused options: a value one of them holds changes what a bare
#: ``build-fleet`` does (a set ``GORDO_WORKER_ID`` makes it a ledger worker)
FLEET_ENV_VARS = LEDGER_ENV_VARS + tuple(
    env for _, env, _, _ in UNPORTED_FLEET_OPTIONS if env is not None)


def _dest(flag: str) -> str:
    return "unported_" + flag.lstrip("-").replace("-", "_")


def _refuse_unported(parser: argparse.ArgumentParser, args) -> None:
    """A usage error for the first unported build-fleet option given (on
    the command line or in its environment variable) with a value other
    than the one that asks for nothing the port lacks."""
    for flag, env, allowed, item in UNPORTED_FLEET_OPTIONS:
        value = getattr(args, _dest(flag))
        if value is None and env is not None:
            value = os.environ.get(env)
        if value is None or (allowed is not None and str(value).strip().lower() == allowed):
            continue
        parser.error(f"build-fleet {flag} is not ported yet ({item})")


def _print_casualties(report: dict) -> None:
    """The JAX command's FAILED and QUARANTINED lines, from a build report
    (a ledger build's merged one: a worker's own records cover its units
    only)."""
    for record in report.get("failed") or []:
        print(f"FAILED {record.get('machine')} ({record.get('phase')}): {record.get('error')}")
    for record in report.get("quarantined") or []:
        print(
            f"QUARANTINED {record.get('machine')} at epoch {record.get('epoch')} "
            "(artifact holds last finite params)"
        )


def print_ledger_status(output_dir: str, lease_ttl: float, max_attempts: int) -> None:
    """The JAX command's ``--ledger-status`` text: each unit's state,
    attempt and lease age, each worker's last heartbeat (a stalled worker
    shows before its lease expires)."""
    probe = fleet_ledger.Ledger(output_dir, worker_id="status", lease_ttl=lease_ttl,
                                max_attempts=max_attempts)
    try:
        status = probe.status()
    except FileNotFoundError:
        print(f"No ledger under {output_dir} (single-worker builds keep none)")
        return
    counts = status["counts"]
    print(
        f"Ledger {status['ledger_dir']}: "
        f"{counts['done']} done / {counts['leased']} leased / "
        f"{counts['pending']} pending / {counts['casualty']} poisoned "
        f"(lease TTL {status['lease_ttl_s']}s, max attempts {status['max_attempts']})"
    )
    for unit in status["units"]:
        state = unit["state"]
        line = f"  {unit['unit']}  {state:<8} ({unit['n_machines']} machines)"
        if state == "leased":
            age = unit.get("heartbeat_age_s")
            line += (f"  worker {unit.get('worker')}  attempt {unit.get('attempt')}  "
                     f"heartbeat {age if age is not None else '?'}s ago")
            if unit.get("expired"):
                line += "  ** EXPIRED: steal imminent **"
        elif state == "done":
            line += f"  worker {unit.get('worker')}  attempt {unit.get('attempt')}"
        elif state == "casualty":
            line += f"  poisoned after {unit.get('attempts')} attempt(s)"
        print(line)
    if status["workers"]:
        print("Workers:")
        for wid, info in status["workers"].items():
            line = f"  {wid}  pid {info.get('pid')}  last heartbeat {info['last_heartbeat_age_s']}s ago"
            if info.get("stalled"):
                line += f"  ** STALLED (> TTL {info.get('lease_ttl_s', status['lease_ttl_s'])}s) **"
            print(line)
    if status.get("aborted"):
        print(f"ABORTED: {status['aborted']}")
    if status.get("finalized"):
        print("Finalized: build_report.json written")


def load_fleet_machines(configs: list, model_parameter=()) -> List[Machine]:
    """The machines of a build-fleet config list as the JAX command
    normalizes them: model templates filled, then each definition read
    and written back with its defaults."""
    machines = []
    for config in configs:
        _expand(config, model_parameter)
        machine = Machine.from_config(config, project_name=config["project_name"])
        machine.model = serializer.from_definition(machine.model).into_definition()
        machines.append(machine)
    return machines


def _worker_args(args, n_workers: int) -> List[str]:
    """The options an orchestrator hands each worker it spawns (the JAX
    command's list, and ``--device``); the machines travel as the
    ledger's ``machines.json`` and OUTPUT_DIR in the environment."""
    out = [
        "--workers", str(n_workers),
        "--lease-ttl", str(args.lease_ttl),
        "--max-attempts", str(args.max_attempts),
        "--epoch-chunk", str(args.epoch_chunk),
        "--on-error", args.on_error,
        "--fetch-retries", str(args.fetch_retries),
        "--bucket-policy", args.bucket_policy,
        "--precision", args.precision,
        "--precision-tolerance", str(args.precision_tolerance),
        "--prefetch-depth", str(args.prefetch_depth),
    ]
    if args.fetch_timeout is not None:
        out += ["--fetch-timeout", str(args.fetch_timeout)]
    if args.device is not None:
        out += ["--device", str(args.device)]
    if args.resume:
        out += ["--resume"]
    if args.print_cv_scores:
        out += ["--print-cv-scores"]
    for key, value in args.model_parameter:
        out += ["--model-parameter", f"{key},{value}"]
    return out


def build_fleet(args) -> int:
    from gordo_tpu_torch.builder.fleet_build import FleetModelBuilder

    try:
        if args.worker_id is None and args.n_workers > 1:
            # the orchestrator: its workers read and normalize the config
            logger.info("Fleet-building %d machines with %d ledger workers, output at: %s",
                        len(args.machines_config), args.n_workers, args.output_dir)
            report = fleet_ledger.orchestrate(
                args.n_workers, args.machines_config, str(args.output_dir),
                _worker_args(args, args.n_workers), resume=args.resume, on_error=args.on_error,
            )
            _print_casualties(report)
            return 0
        machines = load_fleet_machines(args.machines_config, args.model_parameter)
        builder = FleetModelBuilder(
            machines,
            epoch_chunk=args.epoch_chunk,
            on_error=args.on_error,
            fetch_retries=args.fetch_retries,
            fetch_timeout=args.fetch_timeout,
            bucket_policy=args.bucket_policy,
            device=args.device,
            precision=args.precision,
            precision_tolerance=args.precision_tolerance,
            prefetch_depth=args.prefetch_depth,
        )

        def report_machines(pairs) -> None:
            for _, machine_out in pairs:
                machine_out.report()
                if args.print_cv_scores:
                    for line in score_strings(machine_out):
                        print(f"{machine_out.name}: {line}")

        if args.worker_id is not None:
            logger.info("Fleet worker %s joining the ledger under %s (%d machines total)",
                        args.worker_id, args.output_dir, len(machines))
            report = fleet_ledger.run_worker(
                builder, args.output_dir, args.worker_id, lease_ttl=args.lease_ttl,
                max_attempts=args.max_attempts, resume=args.resume,
                on_unit_built=lambda built: report_machines(built.values()),
            )
            _print_casualties(report)
            return 0
        logger.info("Fleet-building %d machines, output at: %s", len(machines), args.output_dir)
        report_machines(builder.build(output_dir_base=args.output_dir, resume=args.resume))
        _print_casualties({"failed": builder.build_failures_, "quarantined": builder.quarantined_})
    except Exception:
        return _report_failure(args)
    return 0


def _env_number(name: str, default, cast):
    value = os.environ.get(name)
    return default if value in (None, "") else cast(value)


def _env_flag(name: str) -> bool:
    """A boolean environment variable as click reads one (unset: False)."""
    return os.environ.get(name, "").strip().lower() in ("1", "true", "t", "yes", "y", "on")


def parse_grid(entries: List[str]) -> dict:
    """``name=v1,v2,...`` entries -> {name: [floats]}, every list as long
    (the JAX command's rules; a bad entry is a ``ValueError``)."""
    grid: dict = {}
    length = None
    for entry in entries:
        name, _, values = entry.partition("=")
        if not values:
            raise ValueError(f"--param needs name=v1,v2,... got {entry!r}")
        try:
            parsed = [float(v) for v in values.split(",")]
        except ValueError:
            raise ValueError(f"--param values must be numbers, got {entry!r}") from None
        if length is not None and len(parsed) != length:
            raise ValueError("--param entries must list the same number of values "
                             f"({length} vs {len(parsed)} in {entry!r})")
        length = len(parsed)
        grid[name.strip()] = parsed
    return grid


def sweep(args) -> int:
    """The ``sweep`` command (module note)."""
    import numpy as np

    from gordo_tpu_torch.builder.fleet_build import _find_torch_estimator, _prefix_transformers
    from gordo_tpu_torch.data import _get_dataset
    from gordo_tpu_torch.parallel import distributed
    from gordo_tpu_torch.parallel.mesh import auto_device_mesh
    from gordo_tpu_torch.parallel.sweep import HyperparamSweep

    try:
        distributed.initialize(device=args.device)
        machine = Machine.from_config(
            args.machine, project_name=args.machine.get("project_name", "sweep"))
        model = serializer.from_definition(machine.model)
        estimator = _find_torch_estimator(model)
        if estimator is None:
            raise ValueError("Sweeps need a port estimator in the model config")
        X, y, _ = _get_dataset(machine.dataset.to_dict()).get_data()
        X_t = np.asarray(X, dtype="float32")
        for transformer in _prefix_transformers(model):
            X_t = np.asarray(transformer.fit_transform(X_t), dtype="float32")
        y_t = np.asarray(y, dtype="float32") if y is not None else X_t
        estimator.kwargs.update({"n_features": X_t.shape[1], "n_features_out": y_t.shape[1]})
        spec = estimator._build_spec()
        kwargs = estimator.kwargs
        result = HyperparamSweep(
            spec, args.grid, lookahead=estimator.lookahead if spec.windowed else 0,
            epoch_chunk=args.epoch_chunk or int(kwargs.get("epoch_chunk", 1)),
            device=args.device, mesh=auto_device_mesh(),
        ).fit(
            X_t, y_t,
            epochs=args.epochs if args.epochs is not None else int(kwargs.get("epochs", 1)),
            batch_size=(args.batch_size if args.batch_size is not None
                        else int(kwargs.get("batch_size", 32))),
        )
    except Exception:
        return _report_failure(args)
    for trial, (hyperparams, loss) in enumerate(result.ranking()):
        hp = " ".join(f"{k}={v:g}" for k, v in hyperparams.items())
        print(f"trial-{trial}: {hp} loss={loss}")
    print("best: " + " ".join(f"{k}={v:g}" for k, v in result.best_hyperparams.items()))
    return 0


def run_router(parser: argparse.ArgumentParser, args) -> int:
    """The ``run-router`` command: a usage error without replicas or a
    collection, else serve until interrupted."""
    from gordo_tpu_torch.router.app import parse_replica_entries, run_router as serve

    if args.rollup_interval < 0 or args.rollup_retention < 1:
        parser.error("--rollup-interval must be >= 0 and --rollup-retention >= 1")
    try:
        replicas = parse_replica_entries(args.replica or [os.environ.get("GORDO_ROUTER_REPLICAS", "")])
    except ValueError as err:
        parser.error(str(err))
    if not replicas:
        parser.error("At least one --replica id=url is required (or GORDO_ROUTER_REPLICAS)")
    if not args.collection_dir:
        parser.error("--collection-dir is required (or MODEL_COLLECTION_DIR): the router "
                     "resolves every request's revision against it")
    serve(args.host, args.port, {
        "REPLICAS": replicas, "COLLECTION_DIR": args.collection_dir, "VNODES": args.vnodes,
        "EJECT_AFTER": args.eject_after, "BACKOFF_SCALE": args.backoff_scale,
        "PROBE_INTERVAL_S": args.probe_interval, "HEDGE_MS": args.hedge_ms,
        "REPLICA_TIMEOUT_S": args.replica_timeout, "MAX_INFLIGHT": args.max_inflight,
        "ROLLUP_INTERVAL_S": args.rollup_interval, "ROLLUP_RETENTION": args.rollup_retention,
        "ROLLUP_PERSIST_PATH": args.rollup_persist,
    })
    return 0


def _lifecycle_config(args):
    from gordo_tpu_torch.lifecycle import LifecycleConfig

    return LifecycleConfig(
        window_start=args.window_start,
        window_end=args.window_end,
        holdout_fraction=args.holdout_fraction,
        shadow_tolerance=args.shadow_tolerance,
        ewma_alpha=args.ewma_alpha,
        ratio_threshold=args.ratio_threshold,
        exceedance_threshold=args.exceedance_threshold,
        min_observations=args.min_observations,
        epoch_chunk=args.epoch_chunk,
        fetch_retries=args.fetch_retries,
        fetch_timeout=args.fetch_timeout,
        stream_observations=args.stream_observations,
        promote=args.promote,
        repoint=args.repoint,
    )


def lifecycle_tick(args) -> int:
    """One cycle; its summary as JSON."""
    from gordo_tpu_torch.lifecycle import LifecycleManager

    manager = LifecycleManager(args.model_collection_dir, config=_lifecycle_config(args),
                               device=args.device)
    result = manager.tick()
    print(json.dumps(result.to_dict(), indent=2, sort_keys=True, default=str))
    return 0


def lifecycle_watch(args) -> int:
    """Cycles on a schedule; a failed cycle is logged and the loop goes
    on, and a promoted revision that the pointer does not adopt stops it
    (the next cycle would start from the same stale base)."""
    from gordo_tpu_torch.lifecycle import LifecycleManager

    manager = LifecycleManager(args.model_collection_dir, config=_lifecycle_config(args),
                               device=args.device)
    cycle = 0
    while True:
        cycle += 1
        started = time.monotonic()
        try:
            result = manager.tick()
            print(json.dumps({"cycle": cycle, **result.to_dict()}, sort_keys=True, default=str),
                  flush=True)
            if result.revision is not None and os.path.realpath(
                    args.model_collection_dir) != os.path.realpath(result.revision_dir):
                logger.warning(
                    "Revision %s was published but the collection pointer still serves %s "
                    "(plain directory or --no-repoint); stopping watch: adopt the revision "
                    "(re-deploy or flip the symlink) and restart",
                    result.revision, result.base_revision,
                )
                return 0
        except Exception:
            logger.exception("Lifecycle cycle %d failed; continuing", cycle)
        if args.max_cycles and cycle >= args.max_cycles:
            return 0
        delay = args.interval_s - (time.monotonic() - started)
        if delay > 0:
            time.sleep(delay)


def lifecycle_report(args) -> int:
    """A promoted revision's decisions, one machine a line."""
    from gordo_tpu_torch.lifecycle import read_promotion_report

    payload = read_promotion_report(args.revision_dir)
    if payload is None:
        print(f"No promotion_report.json under {args.revision_dir} — not a "
              "lifecycle-promoted revision.", file=sys.stderr)
        return 1
    print(f"revision {payload.get('revision')} (from {payload.get('base_revision')})")
    counts = payload.get("counts") or {}
    print("  " + ", ".join(f"{k}: {v}" for k, v in sorted(counts.items())))
    decisions = payload.get("decisions") or {}
    width = max((len(n) for n in decisions), default=0)
    for name in sorted(decisions):
        record = decisions[name]
        line = f"  {name:<{width}}  {record.get('decision'):<12}"
        if record.get("reason"):
            line += f" {record['reason']}"
        shadow = record.get("shadow")
        if shadow:
            line += (f"  (live {shadow['live_score']:.5f} vs "
                     f"candidate {shadow['candidate_score']:.5f})")
        print(line)
    return 0


def _add_lifecycle_parser(commands) -> None:
    lifecycle = commands.add_parser(
        "lifecycle", help="drift detection, warm-start refit and blue/green promotion")
    actions = lifecycle.add_subparsers(dest="lifecycle_command", required=True)
    tick = actions.add_parser("tick", help="run one lifecycle cycle and print it as JSON")
    watch = actions.add_parser("watch", help="run lifecycle cycles on a schedule")
    for command in (tick, watch):
        command.add_argument(
            "--model-collection-dir", default=os.environ.get("MODEL_COLLECTION_DIR"),
            help="the served revision directory, or the latest symlink a promotion re-points "
                 "(default: $MODEL_COLLECTION_DIR)")
        command.add_argument("--window-start", default=None,
                             help="drift/refit window start (ISO); default: each machine's "
                                  "own training window")
        command.add_argument("--window-end", default=None, help="window end (ISO)")
        command.add_argument("--holdout-fraction", type=float, default=0.25,
                             help="window tail held out of the refit for shadow scoring")
        command.add_argument("--shadow-tolerance", type=float, default=0.10,
                             help="largest fractional holdout-error regression a candidate "
                                  "may ship with")
        command.add_argument("--ewma-alpha", type=float, default=0.3,
                             help="newest observation's weight in the drift EWMAs")
        command.add_argument("--ratio-threshold", type=float, default=1.0,
                             help="drift when the EWMA of mean(anomaly/threshold) exceeds this")
        command.add_argument("--exceedance-threshold", type=float, default=0.5,
                             help="drift when the EWMA fraction of timesteps over threshold "
                                  "exceeds this")
        command.add_argument("--min-observations", type=int, default=1,
                             help="observations before a machine may be declared drifted")
        command.add_argument("--epoch-chunk", type=int,
                             default=_env_number("GORDO_EPOCH_CHUNK", 1, int),
                             help="the refit's epoch chunk")
        command.add_argument("--fetch-retries", type=int,
                             default=_env_number("GORDO_FETCH_RETRIES", 1, int),
                             help="retries of a machine's refit data fetch")
        command.add_argument("--fetch-timeout", type=float,
                             default=_env_number("GORDO_FETCH_TIMEOUT", None, float),
                             help="seconds a machine's scan or refit fetch may take "
                                  "(default: no cap)")
        command.add_argument("--stream-observations",
                             default=os.environ.get("GORDO_TPU_EVENT_LOG"),
                             help="JSONL event log whose stream_observation events assess "
                                  "streamed machines without a window fetch (default: "
                                  "$GORDO_TPU_EVENT_LOG)")
        command.add_argument("--promote", action=argparse.BooleanOptionalAction, default=True,
                             help="--no-promote stops after the shadow verdicts (a dry run)")
        command.add_argument("--repoint", action=argparse.BooleanOptionalAction, default=True,
                             help="re-point the latest symlink at the promoted revision")
        command.add_argument("--device", default=None, help="cuda (default) or cpu")
    watch.add_argument("--interval-s", type=float, default=300.0,
                       help="seconds between cycle starts")
    watch.add_argument("--max-cycles", type=int, default=0,
                       help="stop after this many cycles (0: run forever)")
    report = actions.add_parser("report", help="render a revision's promotion decisions")
    report.add_argument("revision_dir", help="the revision directory")


def _lifecycle_command(parser: argparse.ArgumentParser, args) -> int:
    if args.lifecycle_command == "report":
        if not os.path.exists(args.revision_dir):
            parser.error(f"REVISION_DIR {args.revision_dir!r} does not exist")
        return lifecycle_report(args)
    if args.model_collection_dir is None:
        parser.error("--model-collection-dir (or MODEL_COLLECTION_DIR) is required")
    if not os.path.exists(args.model_collection_dir):
        parser.error(f"--model-collection-dir {args.model_collection_dir!r} does not exist")
    if args.lifecycle_command == "tick":
        return lifecycle_tick(args)
    return lifecycle_watch(args)


def _add_report_options(command: argparse.ArgumentParser) -> None:
    """The options of both build commands' failure report and model
    template."""
    command.add_argument(
        "--model-parameter", type=_key_value, action="append", default=[],
        help="key,value filling the {{ key }} variables of a string model config; repeatable",
    )
    command.add_argument(
        "--exceptions-reporter-file", default=os.environ.get("EXCEPTIONS_REPORTER_FILE"),
        help="write a failure's report here as JSON",
    )
    command.add_argument(
        "--exceptions-report-level", type=str.upper, choices=ReportLevel.get_names(),
        default=os.environ.get("EXCEPTIONS_REPORT_LEVEL", ReportLevel.MESSAGE.name).upper(),
        help="detail of the failure report (default: MESSAGE)",
    )


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m gordo_tpu_torch.cli", description="gordo-tpu on PyTorch/CUDA"
    )
    commands = parser.add_subparsers(dest="command", required=True)
    build_cmd = commands.add_parser("build", help="build one machine into an artifact")
    build_cmd.add_argument(
        "machine", nargs="?", default=os.environ.get("MACHINE"),
        help="the machine's config as YAML or JSON (default: $MACHINE)",
    )
    build_cmd.add_argument(
        "output_dir", nargs="?", default=os.environ.get("OUTPUT_DIR", "/data"),
        help="where the artifact goes (default: $OUTPUT_DIR or /data)",
    )
    build_cmd.add_argument("--device", default=None, help="cuda (default) or cpu")
    build_cmd.add_argument(
        "--print-cv-scores", action="store_true",
        help="print the CV scores as metric_fold=value lines",
    )
    build_cmd.add_argument(
        "--model-register-dir", default=os.environ.get("MODEL_REGISTER_DIR"),
        help="the build cache's register: a build it holds is loaded, not trained again",
    )
    _add_report_options(build_cmd)
    fleet = commands.add_parser(
        "build-fleet", help="build a YAML list of machines, a bucket at a time",
        description="Build a YAML list of machines, a bucket at a time, in one process or in "
                    "--workers processes sharing a crash-tolerant work ledger. The tuned "
                    "options (--epoch-chunk, --bucket-policy, --workers, --lease-ttl, "
                    "--precision, --prefetch-depth) take the flag, else their environment "
                    "variable, else OUTPUT_DIR's tuning_profile.json, else the default.",
    )
    fleet.add_argument(
        "machines_config", nargs="?", default=os.environ.get("MACHINES"),
        help="the machines' configs as a YAML list (default: $MACHINES)",
    )
    fleet.add_argument(
        "output_dir", nargs="?", default=os.environ.get("OUTPUT_DIR", "/data"),
        help="where the artifacts go, one directory a machine (default: $OUTPUT_DIR or /data)",
    )
    fleet.add_argument("--machines-from", default=None,
                       help="read the machines' YAML list from this file")
    fleet.add_argument("--device", default=None, help="cuda (default) or cpu")
    # the tuned options parse to None when not given: the flag, then the
    # variable, then the collection's profile, then the default decide
    # (FLEET_TUNED_OPTIONS)
    fleet.add_argument("--epoch-chunk", type=int, default=None,
                       help="epochs between the host's reads of an early-stopping fit's losses "
                            "(default: $GORDO_EPOCH_CHUNK, the profile's, else 1)")
    fleet.add_argument("--on-error", choices=("raise", "skip"),
                       default=os.environ.get("GORDO_ON_ERROR", "raise"),
                       help="a failing machine aborts the build (raise) or is recorded (skip)")
    fleet.add_argument("--bucket-policy", choices=BUCKET_POLICIES, default=None,
                       help="how machines are grouped into buckets (default: "
                            "$GORDO_BUCKET_POLICY, the profile's, else exact)")
    fleet.add_argument("--fetch-retries", type=int,
                       default=_env_number("GORDO_FETCH_RETRIES", 2, int),
                       help="retries of a machine's data fetch")
    fleet.add_argument("--fetch-timeout", type=float,
                       default=_env_number("GORDO_FETCH_TIMEOUT", None, float),
                       help="seconds a machine's data fetch may take")
    fleet.add_argument("--precision", choices=PRECISIONS, default=None,
                       help="inference precision: float32 (no calibration), auto (bf16 where a "
                            "machine's MAE delta is within --precision-tolerance) or bf16 "
                            "(default: $GORDO_PRECISION, the profile's, else float32)")
    fleet.add_argument("--precision-tolerance", type=float,
                       default=_env_number("GORDO_PRECISION_TOLERANCE", 0.25, float),
                       help="relative MAE tolerance of the bf16 calibration")
    fleet.add_argument("--prefetch-depth", type=int, default=None,
                       help="host-to-device transfer pipelining depth, 0-8 (0: one plain copy; "
                            "default: $GORDO_PREFETCH_DEPTH, the profile's, else 0)")
    fleet.add_argument("--print-cv-scores", action="store_true",
                       help="print each machine's CV scores as '<machine>: metric_fold=value'")
    _add_report_options(fleet)
    for flag, _, _, item in UNPORTED_FLEET_OPTIONS:
        fleet.add_argument(flag, dest=_dest(flag), default=None, help=f"not ported ({item})")
    fleet.add_argument("--resume", action=argparse.BooleanOptionalAction,
                       default=_env_flag("GORDO_FLEET_RESUME"),
                       help="reuse the machines whose artifacts in OUTPUT_DIR are current and "
                            "build the rest")
    fleet.add_argument("--workers", default=None,
                       help="worker processes sharing the buckets through the work ledger "
                            "under OUTPUT_DIR ('auto': half the cores, at most 4; 1: one "
                            "process, no ledger; default: $GORDO_BUILD_WORKERS, the "
                            "profile's, else 1)")
    fleet.add_argument("--worker-id", type=int, default=os.environ.get(WORKER_ID_ENV_VAR),
                       help="run as one worker of a ledger build (set by the orchestrator; "
                            "set it yourself to run workers on hosts sharing OUTPUT_DIR)")
    fleet.add_argument("--lease-ttl", type=float, default=None,
                       help="seconds a unit's lease may go without a heartbeat before a live "
                            "worker steals it (default: $GORDO_LEASE_TTL, the profile's, "
                            "else 60)")
    fleet.add_argument("--max-attempts", type=int,
                       default=_env_number(fleet_ledger.MAX_ATTEMPTS_ENV_VAR,
                                           fleet_ledger.DEFAULT_MAX_ATTEMPTS, int),
                       help="worker deaths a unit survives before its machines become "
                            "casualties (default 3)")
    fleet.add_argument("--ledger-status", default=None, metavar="OUTPUT_DIR",
                       help="print the ledger's units and workers under this build output "
                            "directory and exit")
    # what the port does anyway: nothing to refuse
    fleet.add_argument("--no-aot-cache", action="store_true", help=argparse.SUPPRESS)
    sweep_cmd = commands.add_parser(
        "sweep", help="train an optimizer-hyperparameter grid as one fleet")
    sweep_cmd.add_argument("machine", nargs="?", default=os.environ.get("MACHINE"),
                           help="the machine's config as YAML or JSON (default: $MACHINE)")
    sweep_cmd.add_argument("--param", action="append", default=[], required=True,
                           help="name=v1,v2,... (repeatable, every list as long); optimizer "
                                "arguments, 'lr' and 'decay' standing for learning_rate and "
                                "weight_decay")
    sweep_cmd.add_argument("--epochs", type=int, default=None, help="override the epochs")
    sweep_cmd.add_argument("--batch-size", type=int, default=None,
                           help="override the batch size")
    sweep_cmd.add_argument("--epoch-chunk", type=int,
                           default=_env_number("GORDO_EPOCH_CHUNK", None, int),
                           help="epochs between the host's reads (default: the config's, else 1)")
    sweep_cmd.add_argument("--device", default=None, help="cuda (default) or cpu")
    sweep_cmd.add_argument(
        "--exceptions-reporter-file", default=os.environ.get("EXCEPTIONS_REPORTER_FILE"),
        help="write a failure's report here as JSON")
    sweep_cmd.add_argument(
        "--exceptions-report-level", type=str.upper, choices=ReportLevel.get_names(),
        default=os.environ.get("EXCEPTIONS_REPORT_LEVEL", ReportLevel.MESSAGE.name).upper(),
        help="detail of the failure report (default: MESSAGE)")
    server = commands.add_parser(
        "run-server", add_help=False, help="serve a collection (gordo_tpu_torch.server.runner)"
    )
    server.add_argument("server_args", nargs=argparse.REMAINDER)
    router = commands.add_parser(
        "run-router", help="front run-server shard replicas (gordo_tpu_torch.router)")
    router.add_argument("--host", default=os.environ.get("GORDO_ROUTER_HOST", "0.0.0.0"))
    router.add_argument("--port", type=int, default=_env_number("GORDO_ROUTER_PORT", 5556, int))
    router.add_argument("--replica", action="append", default=[], metavar="ID=URL",
                        help="one shard replica (repeatable; default: $GORDO_ROUTER_REPLICAS)")
    router.add_argument("--collection-dir", default=os.environ.get("MODEL_COLLECTION_DIR"),
                        help="the collection the replicas serve (default: $MODEL_COLLECTION_DIR)")
    for flag, env, cast, default, text in (
        ("--vnodes", "GORDO_ROUTER_VNODES", int, 64, "virtual nodes a replica on the ring"),
        ("--eject-after", "GORDO_ROUTER_EJECT_AFTER", int, 3,
         "consecutive failures that eject a replica"),
        ("--backoff-scale", "GORDO_ROUTER_BACKOFF_SCALE", float, 0.25,
         "scale on the 8/16/32 s ejection windows"),
        ("--probe-interval", "GORDO_ROUTER_PROBE_INTERVAL_S", float, 1.0,
         "seconds between /healthz probes of ejected replicas (0: none)"),
        ("--hedge-ms", "GORDO_ROUTER_HEDGE_MS", float, 0.0,
         "hedge a shard call silent this long (0: never)"),
        ("--replica-timeout", "GORDO_ROUTER_REPLICA_TIMEOUT_S", float, 30.0,
         "seconds a replica call may take"),
        ("--max-inflight", "GORDO_ROUTER_MAX_INFLIGHT", int, 64,
         "requests in flight before the router sheds with 503"),
        ("--rollup-interval", "GORDO_ROLLUP_INTERVAL_S", float, 0.0,
         "seconds between polls of every replica's /telemetry/snapshot, merged into the "
         "router's /status and /metrics (0: no poller thread; /status polls on demand)"),
        ("--rollup-retention", "GORDO_ROLLUP_RETENTION", int, 500,
         "merged snapshots kept in the persisted rollup JSONL (oldest trimmed)"),
    ):
        router.add_argument(flag, type=cast, default=_env_number(env, default, cast), help=text)
    router.add_argument("--rollup-persist", default=os.environ.get("GORDO_ROLLUP_PERSIST") or None,
                        help="JSONL path the merged snapshots persist to (`tune` reads them as "
                             "observations); unset: not persisted")
    _add_lifecycle_parser(commands)
    telemetry = commands.add_parser("telemetry",
                                    help="inspect fleet telemetry: build reports and event logs")
    telemetry_actions = telemetry.add_subparsers(dest="telemetry_command", required=True)
    summarize = telemetry_actions.add_parser(
        "summarize", help="aggregate the telemetry reports and event logs under a directory")
    summarize.add_argument("directory", help="a build output directory, or a root of many")
    summarize.add_argument("--as-json", action="store_true",
                           help="print the versioned JSON payload instead of the summary")
    for name, text in (("client", "predict, read metadata, download models (cli/client.py)"),
                       ("trace", "summarize or export span logs (cli/trace.py)"),
                       ("buckets", "preview a bucketing plan (cli/buckets.py)"),
                       ("tune", "fit measured knob defaults from telemetry (cli/tune.py)"),
                       ("slo", "check SLO specs against merged plane snapshots (cli/plane.py)"),
                       ("top", "live view of a plane's /status (cli/plane.py)"),
                       ("rollup", "poll, merge and serve plane members' snapshots "
                                  "(cli/plane.py)"),
                       ("gameday", "run fault timelines against an in-process plane "
                                   "(cli/gameday.py)"),
                       ("profile", "the cost-seam report of a wall-profiler dump "
                                   "(cli/profile.py)")):
        command = commands.add_parser(name, add_help=False, help=text)
        command.add_argument("command_args", nargs=argparse.REMAINDER)
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="[%(asctime)s] %(levelname)s [%(name)s.%(funcName)s:%(lineno)d] %(message)s",
    )
    if argv[:1] == ["run-server"]:
        # the runner parses its own options (argparse's REMAINDER would
        # refuse a first argument that is an option)
        from gordo_tpu_torch.server import runner

        runner.main(argv[1:])
        return 0
    if argv[:1] == ["client"]:
        from gordo_tpu_torch.cli import client

        return client.main(argv[1:])
    if argv[:1] == ["trace"]:
        from gordo_tpu_torch.cli import trace

        return trace.main(argv[1:])
    if argv[:1] == ["buckets"]:
        from gordo_tpu_torch.cli import buckets

        return buckets.main(argv[1:])
    if argv[:1] == ["tune"]:
        from gordo_tpu_torch.cli import tune

        return tune.main(argv[1:])
    if argv[:1] == ["gameday"]:
        from gordo_tpu_torch.cli import gameday

        return gameday.main(argv[1:])
    if argv[:1] == ["profile"]:
        from gordo_tpu_torch.cli import profile

        return profile.main(argv[1:])
    if argv[:1] in (["slo"], ["top"], ["rollup"]):
        from gordo_tpu_torch.cli import plane

        return plane.main(argv)
    parser = _parser()
    args = parser.parse_args(argv)
    if args.command == "build-fleet":
        return _build_fleet_command(parser, args)
    if args.command == "run-router":
        return run_router(parser, args)
    if args.command == "lifecycle":
        return _lifecycle_command(parser, args)
    if args.command == "telemetry":
        return telemetry_summarize(parser, args)
    if args.machine is None:
        parser.error(
            f"{args.command} needs MACHINE, as an argument or in the MACHINE environment "
            "variable"
        )
    try:
        args.machine = safe_load(args.machine)
    except ValueError as err:
        parser.error(f"MACHINE must be the machine's config as YAML; it did not parse: {err}")
    if not isinstance(args.machine, dict):
        parser.error(f"MACHINE must be a YAML mapping, got {type(args.machine).__name__}")
    if args.command == "sweep":
        try:
            args.grid = parse_grid(args.param)
        except ValueError as err:
            parser.error(str(err))
        if args.epoch_chunk is not None and args.epoch_chunk < 1:
            parser.error("--epoch-chunk must be >= 1")
        return sweep(args)
    return build(args)


def telemetry_summarize(parser: argparse.ArgumentParser, args) -> int:
    """``telemetry summarize``: the JAX command's text or JSON payload."""
    from gordo_tpu_torch.observability.report import summarize_directory, summary_payload

    if not os.path.isdir(args.directory):
        parser.error(f"DIRECTORY {args.directory!r} does not exist or is not a directory")
    if args.as_json:
        print(json.dumps(summary_payload(args.directory), indent=2, default=str))
    else:
        print(summarize_directory(args.directory))
    return 0


def _build_fleet_command(parser: argparse.ArgumentParser, args) -> int:
    _refuse_unported(parser, args)
    try:
        # the ledger's status reads no profile
        resolve_tuned_options(vars(args), None if args.ledger_status is not None
                              else args.output_dir, FLEET_TUNED_OPTIONS, subsystem="builder")
    except UnportedKnobError as err:
        parser.error(str(err))
    except ValueError as err:
        parser.error(f"a tuned build-fleet option did not parse: {err}")
    if args.bucket_policy not in BUCKET_POLICIES or args.precision not in PRECISIONS:
        parser.error(f"--bucket-policy must be one of {BUCKET_POLICIES} and --precision one "
                     f"of {PRECISIONS}, got {args.bucket_policy!r} and {args.precision!r}")
    if args.lease_ttl <= 0 or args.max_attempts < 1:
        parser.error("--lease-ttl must be > 0 and --max-attempts >= 1")
    if args.ledger_status is not None:
        print_ledger_status(args.ledger_status, args.lease_ttl, args.max_attempts)
        return 0
    try:
        args.n_workers = (1 if str(args.workers).strip().lower() == "1"
                          else fleet_ledger.resolve_workers(args.workers))
    except ValueError as err:
        parser.error(str(err))
    if args.epoch_chunk < 1 or args.fetch_retries < 0:
        parser.error("--epoch-chunk must be >= 1 and --fetch-retries >= 0")
    if args.fetch_timeout is not None and args.fetch_timeout <= 0:
        parser.error("--fetch-timeout must be > 0")
    if args.precision_tolerance < 0:
        parser.error("--precision-tolerance must be >= 0")
    if not 0 <= args.prefetch_depth <= transfer.MAX_PREFETCH_DEPTH:
        parser.error(f"--prefetch-depth must be in 0..{transfer.MAX_PREFETCH_DEPTH}")
    text = args.machines_config
    if args.machines_from is not None:
        with open(args.machines_from) as fh:
            text = fh.read()
    if text is None:
        parser.error("MACHINES-CONFIG is required (argument or MACHINES env var)")
    try:
        args.machines_config = safe_load(text)
    except ValueError as err:
        parser.error(f"MACHINES-CONFIG must be a YAML list of machines; it did not parse: {err}")
    if not isinstance(args.machines_config, list):
        parser.error(
            f"MACHINES-CONFIG must be a YAML list, got {type(args.machines_config).__name__}"
        )
    return build_fleet(args)


if __name__ == "__main__":
    sys.exit(main())
