"""
The port's command line (the counterpart of ``gordo_tpu.cli``'s
``build`` and ``run-server``), on argparse::

    python -m gordo_tpu_torch.cli build [MACHINE] [OUTPUT_DIR] [--device cpu]
        [--print-cv-scores] [--exceptions-reporter-file FILE]
    python -m gordo_tpu_torch.cli run-server [--collection-dir DIR] [--device cpu] ...

``build`` builds one machine (fetch and resample its dataset,
cross-validate and derive the thresholds, fit) and writes the port's
artifact to OUTPUT_DIR. MACHINE is the machine's config as YAML (JSON
is YAML too), read by the port's YAML reader and taken as the JAX
command takes it: ``Machine.from_config(machine, project_name=
machine["project_name"])``, with no project globals of its own. Both
fall back to the ``MACHINE`` and ``OUTPUT_DIR`` environment variables,
and OUTPUT_DIR to ``/data``. Training runs on the card unless ``--device cpu`` is
given. A failed build exits with the JAX command's code for the kind of
failure (``EXIT_CODES``) and, with ``--exceptions-reporter-file``, leaves
``{"type", "message"}`` JSON there.
"""

import argparse
import json
import logging
import os
import re
import sys
import traceback
from typing import List, Optional

from gordo_tpu_torch.builder import ModelBuilder
from gordo_tpu_torch.data import InsufficientDataError, SensorTagNormalizationError
from gordo_tpu_torch.data.datasets import InsufficientDataAfterRowFilteringError
from gordo_tpu_torch.data.providers import NoSuitableDataProviderError
from gordo_tpu_torch.machine import Machine, ReporterException
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
#: the termination message's budget (a 2024-byte message, less room for
#: the JSON around it)
MAX_MESSAGE_LEN = 2024 - 500


def exit_code(exc_type: type) -> int:
    for klass in exc_type.__mro__:
        if klass in EXIT_CODES:
            return EXIT_CODES[klass]
    return 1


def _write_report(path: str, exc: BaseException) -> None:
    """``{"type", "message"}`` of ``exc`` as ASCII JSON at ``path``; a
    failure to write is printed, never raised."""
    message = re.sub(r"[^\x00-\x7F]", "?", str(exc))
    if len(message) > MAX_MESSAGE_LEN:
        message = message[: MAX_MESSAGE_LEN - 3] + "..."
    try:
        with open(path, "w") as fh:
            json.dump({"type": type(exc).__name__, "message": message}, fh)
    except OSError:
        traceback.print_exc()


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
        machine = Machine.from_config(args.machine, project_name=args.machine["project_name"])
        logger.info("Building, output will be at: %s", args.output_dir)
        _, machine = ModelBuilder(machine).build(output_dir=args.output_dir, device=args.device)
        machine.report()
        if args.print_cv_scores:
            for line in score_strings(machine):
                print(line)
    except Exception as exc:
        traceback.print_exc()
        if args.exceptions_reporter_file:
            _write_report(args.exceptions_reporter_file, exc)
        return exit_code(type(exc))
    return 0


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
        "--exceptions-reporter-file", default=os.environ.get("EXCEPTIONS_REPORTER_FILE"),
        help="write a failure's type and message here as JSON",
    )
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


if __name__ == "__main__":
    sys.exit(main())
