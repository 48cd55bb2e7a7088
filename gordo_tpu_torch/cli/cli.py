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
        [--resume | --no-resume]
    python -m gordo_tpu_torch.cli sweep [MACHINE] --param NAME=V1,V2,... [--param ...]
        [--epochs N] [--batch-size N] [--epoch-chunk K] [--device cpu]
        [--exceptions-reporter-file FILE] [--exceptions-report-level ...]
    python -m gordo_tpu_torch.cli run-server [--collection-dir DIR] [--device cpu]
        [--shard-manifest FILE --replica-id ID] ...
    python -m gordo_tpu_torch.cli run-router --collection-dir DIR --replica ID=URL ...

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
whose artifacts in OUTPUT_DIR are current and builds the rest. Its
options that the port does not have (``UNPORTED_FLEET_OPTIONS``) are
usage errors naming their ROADMAP.md item or reason: none is ignored.

``sweep`` trains the optimizer-hyperparameter grid of ``--param`` entries
on MACHINE's data as one fleet (``gordo_tpu_torch.parallel.sweep``),
after fitting its prefix transformers, with the epochs and batch size
its build would use, and prints each trial's final loss in Katib's
``key=value`` form, best first, then the best hyperparameters.

``run-router`` fronts ``run-server`` replicas that each serve a shard of
one collection (``gordo_tpu_torch.router``); it needs no card.
"""

import argparse
import logging
import os
import re
import sys
import traceback
from typing import List, Optional

from gordo_tpu_torch import serializer
from gordo_tpu_torch.builder import ModelBuilder
from gordo_tpu_torch.cli.exceptions_reporter import ExceptionsReporter, ReportLevel
from gordo_tpu_torch.data import InsufficientDataError, SensorTagNormalizationError
from gordo_tpu_torch.data.datasets import InsufficientDataAfterRowFilteringError
from gordo_tpu_torch.data.providers import NoSuitableDataProviderError
from gordo_tpu_torch.machine import Machine, ReporterException
from gordo_tpu_torch.parallel import transfer
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
    ("--workers", "GORDO_BUILD_WORKERS", "1", "ROADMAP.md queue 1 item 9"),
    ("--worker-id", "GORDO_WORKER_ID", None, "ROADMAP.md queue 1 item 9"),
    ("--lease-ttl", "GORDO_LEASE_TTL", None, "ROADMAP.md queue 1 item 9"),
    ("--max-attempts", "GORDO_MAX_ATTEMPTS", None, "ROADMAP.md queue 1 item 9"),
    ("--ledger-status", None, None, "ROADMAP.md queue 1 item 9"),
    ("--aot-cache", "GORDO_AOT_CACHE", None,
     "ROADMAP.md queue 1 item 9: programs/ stays out of the port"),
    # the flag only: a build pod's MODEL_REGISTER_DIR is meant for `build`
    ("--model-register-dir", None, None,
     "ROADMAP.md queue 1 item 7: the JAX fleet builder takes it and caches nothing, "
     "so the port refuses it rather than ignore it"),
)


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


def _print_casualties(failed, quarantined) -> None:
    """The JAX command's FAILED and QUARANTINED lines."""
    for record in failed:
        print(f"FAILED {record.get('machine')} ({record.get('phase')}): {record.get('error')}")
    for record in quarantined:
        print(
            f"QUARANTINED {record.get('machine')} at epoch {record.get('epoch')} "
            "(artifact holds last finite params)"
        )


def build_fleet(args) -> int:
    from gordo_tpu_torch.builder.fleet_build import FleetModelBuilder

    try:
        machines = []
        for config in args.machines_config:
            _expand(config, args.model_parameter)
            machine = Machine.from_config(config, project_name=config["project_name"])
            # the definition with its defaults, as the JAX command stores it
            machine.model = serializer.from_definition(machine.model).into_definition()
            machines.append(machine)
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
        logger.info("Fleet-building %d machines, output at: %s", len(machines), args.output_dir)
        for _, machine_out in builder.build(output_dir_base=args.output_dir, resume=args.resume):
            machine_out.report()
            if args.print_cv_scores:
                for line in score_strings(machine_out):
                    print(f"{machine_out.name}: {line}")
        _print_casualties(builder.build_failures_, builder.quarantined_)
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
    from gordo_tpu_torch.parallel.sweep import HyperparamSweep

    try:
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
            device=args.device,
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


#: run-router options of the JAX command that wait for the port's
#: telemetry (flag, environment variable)
UNPORTED_ROUTER_OPTIONS = (
    ("--rollup-interval", "GORDO_ROLLUP_INTERVAL_S"),
    ("--rollup-retention", "GORDO_ROLLUP_RETENTION"),
    ("--rollup-persist", "GORDO_ROLLUP_PERSIST"),
)


def run_router(parser: argparse.ArgumentParser, args) -> int:
    """The ``run-router`` command: a usage error without replicas or a
    collection, else serve until interrupted."""
    from gordo_tpu_torch.router.app import parse_replica_entries, run_router as serve

    for flag, env in UNPORTED_ROUTER_OPTIONS:
        if getattr(args, _dest(flag)) is not None or os.environ.get(env):
            parser.error(f"run-router {flag} is not ported yet (ROADMAP.md queue 1 item 9)")
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
    })
    return 0


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
        "build-fleet", help="build a YAML list of machines, a bucket at a time"
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
    fleet.add_argument("--epoch-chunk", type=int,
                       default=_env_number("GORDO_EPOCH_CHUNK", 1, int),
                       help="epochs between the host's reads of an early-stopping fit's losses")
    fleet.add_argument("--on-error", choices=("raise", "skip"),
                       default=os.environ.get("GORDO_ON_ERROR", "raise"),
                       help="a failing machine aborts the build (raise) or is recorded (skip)")
    fleet.add_argument("--bucket-policy", choices=("exact", "padded"),
                       default=os.environ.get("GORDO_BUCKET_POLICY", "exact"),
                       help="how machines are grouped into buckets")
    fleet.add_argument("--fetch-retries", type=int,
                       default=_env_number("GORDO_FETCH_RETRIES", 2, int),
                       help="retries of a machine's data fetch")
    fleet.add_argument("--fetch-timeout", type=float,
                       default=_env_number("GORDO_FETCH_TIMEOUT", None, float),
                       help="seconds a machine's data fetch may take")
    fleet.add_argument("--precision", choices=("float32", "bf16", "auto"),
                       default=os.environ.get("GORDO_PRECISION", "float32"),
                       help="inference precision: float32 (no calibration), auto (bf16 where a "
                            "machine's MAE delta is within --precision-tolerance) or bf16")
    fleet.add_argument("--precision-tolerance", type=float,
                       default=_env_number("GORDO_PRECISION_TOLERANCE", 0.25, float),
                       help="relative MAE tolerance of the bf16 calibration")
    fleet.add_argument("--prefetch-depth", type=int,
                       default=_env_number("GORDO_PREFETCH_DEPTH", 0, int),
                       help="host-to-device transfer pipelining depth, 0-8 (0: one plain copy)")
    fleet.add_argument("--print-cv-scores", action="store_true",
                       help="print each machine's CV scores as '<machine>: metric_fold=value'")
    _add_report_options(fleet)
    for flag, _, _, item in UNPORTED_FLEET_OPTIONS:
        fleet.add_argument(flag, dest=_dest(flag), default=None, help=f"not ported ({item})")
    fleet.add_argument("--resume", action=argparse.BooleanOptionalAction,
                       default=_env_flag("GORDO_FLEET_RESUME"),
                       help="reuse the machines whose artifacts in OUTPUT_DIR are current and "
                            "build the rest")
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
    ):
        router.add_argument(flag, type=cast, default=_env_number(env, default, cast), help=text)
    for flag, _ in UNPORTED_ROUTER_OPTIONS:
        router.add_argument(flag, dest=_dest(flag), default=None,
                            help="not ported (ROADMAP.md queue 1 item 9)")
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
    parser = _parser()
    args = parser.parse_args(argv)
    if args.command == "build-fleet":
        return _build_fleet_command(parser, args)
    if args.command == "run-router":
        return run_router(parser, args)
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


def _build_fleet_command(parser: argparse.ArgumentParser, args) -> int:
    _refuse_unported(parser, args)
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
