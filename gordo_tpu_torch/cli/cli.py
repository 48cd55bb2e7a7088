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
    python -m gordo_tpu_torch.cli run-server [--collection-dir DIR] [--device cpu] ...

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
transfers. Its options that the port does not have
(``UNPORTED_FLEET_OPTIONS``) are usage errors naming their ROADMAP.md
item or reason: none is ignored.
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
    ("--resume", "GORDO_FLEET_RESUME", None, "ROADMAP.md queue 1 item 8"),
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
        for _, machine_out in builder.build(output_dir_base=args.output_dir):
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
    for flag in ("--no-resume", "--no-aot-cache"):
        # what the port does anyway: nothing to refuse
        fleet.add_argument(flag, action="store_true", help=argparse.SUPPRESS)
    server = commands.add_parser(
        "run-server", add_help=False, help="serve a collection (gordo_tpu_torch.server.runner)"
    )
    server.add_argument("server_args", nargs=argparse.REMAINDER)
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    parser = _parser()
    args = parser.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="[%(asctime)s] %(levelname)s [%(name)s.%(funcName)s:%(lineno)d] %(message)s",
    )
    if args.command == "run-server":
        from gordo_tpu_torch.server import runner

        runner.main(args.server_args)
        return 0
    if args.command == "build-fleet":
        return _build_fleet_command(parser, args)
    if args.machine is None:
        parser.error(
            "build needs MACHINE, as an argument or in the MACHINE environment variable"
        )
    try:
        args.machine = safe_load(args.machine)
    except ValueError as err:
        parser.error(f"MACHINE must be the machine's config as YAML; it did not parse: {err}")
    if not isinstance(args.machine, dict):
        parser.error(f"MACHINE must be a YAML mapping, got {type(args.machine).__name__}")
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
