"""
The ``tune`` command (the port of ``gordo_tpu.cli.tune``), on argparse::

    python -m gordo_tpu_torch.cli tune plan CORPUS... [--as-json] [--check]
    python -m gordo_tpu_torch.cli tune fit CORPUS... [--out PATH]
    python -m gordo_tpu_torch.cli tune calibrate OUTPUT_DIR [--epoch-chunks 1,4,8]
        [--machines N] [--rows N] [--epochs N] [--batch-size N]
        [--batch-wait-sweep MS,...] [--rps R] [--duration S] [--fit | --no-fit]
        [--device cpu]

``plan`` reads the telemetry corpus under CORPUS (collection directories
and files: telemetry reports, event logs, persisted rollups, sweep
results), fits the cost model and prints each recommendation with its
evidence and predicted change, writing nothing; ``--check`` instead
validates every ``tuning_profile.json`` under CORPUS against the knob
registry and exits with the problem count. ``fit`` writes the profile
(default: into the first CORPUS directory). ``calibrate`` measures a
corpus (``tuning/calibrate.py``) into ``OUTPUT_DIR/results_calibration.json``
and, unless ``--no-fit``, fits the profile there; it runs on the card
unless ``--device cpu`` is given. Tables, JSON and exit codes are the
JAX command's; a knob the port lacks is never recommended.
"""

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, List, Optional

from gordo_tpu_torch.tuning import (
    TUNING_PROFILE_FILENAME,
    TuningProfileError,
    fit_recommendations,
    get_knob,
    load_profile,
    read_corpus,
    validate_profile,
    write_profile,
)
from gordo_tpu_torch.tuning.corpus import Corpus
from gordo_tpu_torch.tuning.model import Recommendation


def _comma_list(cast, flag: str):
    kind = "integers" if cast is int else "numbers"

    def parse(raw: str) -> list:
        try:
            values = [cast(part) for part in raw.split(",") if part.strip()]
        except ValueError:
            raise argparse.ArgumentTypeError(
                f"{flag} must be comma-separated {kind}, got {raw!r}") from None
        if not values:
            raise argparse.ArgumentTypeError(f"{flag} lists no values")
        return values
    return parse


def plan_payload(corpus: Corpus, recommendations: Dict[str, Recommendation]) -> dict:
    return {"corpus": corpus.meta(),
            "recommendations": {name: rec.to_dict() for name, rec in recommendations.items()}}


def _fmt_value(value) -> str:
    return f"{value:g}" if isinstance(value, float) else str(value)


def render_plan(corpus: Corpus, recommendations: Dict[str, Recommendation]) -> List[str]:
    """The plan's lines (the JAX command's)."""
    lines = [f"Tuning plan: {len(corpus.observations)} observation(s) from "
             f"{corpus.n_files} corpus file(s)"]
    for note in corpus.files:
        if note.error:
            lines.append(f"  skipped {note.path}: {note.error}")
    if not recommendations:
        lines.append("No knob has enough evidence for a recommendation — defaults "
                     "stand. Record more telemetry, or run `gordo-tpu tune "
                     "calibrate`.")
        return lines
    for name, rec in sorted(recommendations.items()):
        knob = get_knob(name)
        lines.append(f"  {name} ({knob.flag or knob.env_var}): "
                     f"{_fmt_value(rec.default)} -> {_fmt_value(rec.value)}  "
                     f"[{rec.source}, by {rec.signal} ({rec.objective})]")
        if rec.improvement is not None:
            lines.append(f"    predicted {rec.signal}: {rec.predicted_default:g} (default) -> "
                         f"{rec.predicted:g} ({rec.improvement:+.1%})")
        for arm in rec.evidence:
            marker = " <- best" if arm.value == rec.value else ""
            lines.append(f"    arm {_fmt_value(arm.value)}: mean {arm.mean:g} (n={arm.n}){marker}")
    return lines


def check_profiles(root: Path) -> int:
    """Every ``tuning_profile.json`` under ``root`` (or ``root`` itself)
    loaded and validated: the problem count."""
    profiles = [root] if root.is_file() else sorted(root.rglob(TUNING_PROFILE_FILENAME))
    if not profiles:
        print(f"No {TUNING_PROFILE_FILENAME} under {root} — nothing to check")
        return 0
    n_problems = 0
    for path in profiles:
        try:
            profile = load_profile(path)
        except TuningProfileError as exc:
            print(f"{path}: FAIL: {exc}")
            n_problems += 1
            continue
        problems = validate_profile(profile)
        for problem in problems:
            print(f"{path}: FAIL: {problem}")
        n_problems += len(problems)
        if not problems:
            print(f"{path}: ok ({len(profile.get('recommendations') or {})} recommendation(s))")
    return n_problems


def _fit_and_write(corpus_paths, out) -> None:
    parsed = read_corpus(corpus_paths)
    recommendations = fit_recommendations(parsed)
    path = write_profile(out, recommendations, parsed.meta())
    for line in render_plan(parsed, recommendations):
        print(line)
    print(f"Profile written: {path}")


def _existing(text: str) -> str:
    if not Path(text).exists():
        raise argparse.ArgumentTypeError(f"Path '{text}' does not exist.")
    return text


def _at_least(minimum, cast):
    def parse(text: str):
        value = cast(text)
        if value < minimum:
            raise argparse.ArgumentTypeError(f"{value} is not in the range x>={minimum}.")
        return value
    return parse


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m gordo_tpu_torch.cli tune",
        description="The telemetry-driven autotuner: fit measured knob defaults from "
                    "recorded telemetry.")
    actions = parser.add_subparsers(dest="tune_command", required=True)
    plan = actions.add_parser("plan", help="dry-run the tuner over a corpus")
    plan.add_argument("corpus", nargs="*", type=_existing, metavar="CORPUS")
    plan.add_argument("--as-json", action="store_true",
                      help="Emit the plan as JSON instead of the human table.")
    plan.add_argument("--check", action="store_true",
                      help="Validate every tuning_profile.json under CORPUS against the knob "
                           "registry instead; the exit code is the problem count.")
    fit = actions.add_parser("fit", help="fit and write the collection's tuning profile")
    fit.add_argument("corpus", nargs="*", type=_existing, metavar="CORPUS")
    fit.add_argument("--out", default=None,
                     help="Where to write the profile (default: tuning_profile.json in the "
                          "FIRST corpus directory).")
    calibrate = actions.add_parser("calibrate", help="measure a corpus for a fleet with none")
    calibrate.add_argument("output_dir", metavar="OUTPUT_DIR")
    calibrate.add_argument("--epoch-chunks", type=_comma_list(int, "--epoch-chunks"),
                           default=[1, 4, 8],
                           help="epoch_chunk arms to sweep on the synthetic calibration "
                                "fleet. (default: 1,4,8)")
    calibrate.add_argument("--machines", type=_at_least(1, int), default=4,
                           help="Synthetic fleet size for the training sweep. (default: 4)")
    calibrate.add_argument("--rows", type=_at_least(16, int), default=256,
                           help="Sensor rows per synthetic machine. (default: 256)")
    calibrate.add_argument("--epochs", type=_at_least(2, int), default=8,
                           help="Training epochs per sweep arm. (default: 8)")
    calibrate.add_argument("--batch-size", type=_at_least(1, int), default=32,
                           help="Training batch size. (default: 32)")
    calibrate.add_argument("--batch-wait-sweep", type=_comma_list(float, "--batch-wait-sweep"),
                           default=None,
                           help="Optional --batch-wait-ms arms (comma-separated ms) to sweep "
                                "against an in-process server under open-loop load.")
    calibrate.add_argument("--rps", type=_at_least(0.1, float), default=20.0,
                           help="Offered Poisson arrival rate for the serving sweep. "
                                "(default: 20.0)")
    calibrate.add_argument("--duration", type=_at_least(1.0, float), default=5.0,
                           help="Seconds per serving-sweep arm. (default: 5.0)")
    calibrate.add_argument("--fit", dest="do_fit", action=argparse.BooleanOptionalAction,
                           default=True,
                           help="Fit + write OUTPUT_DIR/tuning_profile.json from the fresh "
                                "calibration corpus. (default: on)")
    calibrate.add_argument("--device", default=None, help="cuda (default) or cpu")
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    parser = _parser()
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    if args.tune_command == "calibrate":
        from gordo_tpu_torch.tuning.calibrate import run_calibration

        Path(args.output_dir).mkdir(parents=True, exist_ok=True)
        path, _ = run_calibration(
            args.output_dir, epoch_chunks=args.epoch_chunks, n_machines=args.machines,
            n_rows=args.rows, epochs=args.epochs, batch_size=args.batch_size,
            batch_wait_sweep=args.batch_wait_sweep, rps=args.rps, duration=args.duration,
            device=args.device)
        print(f"Calibration corpus written: {path}")
        if args.do_fit:
            _fit_and_write([args.output_dir], args.output_dir)
        return 0
    if not args.corpus:
        parser.error("CORPUS is required: one or more collection directories / telemetry files")
    if args.tune_command == "plan":
        if args.check:
            return min(sum(check_profiles(Path(root)) for root in args.corpus), 125)
        parsed = read_corpus(args.corpus)
        recommendations = fit_recommendations(parsed)
        if args.as_json:
            print(json.dumps(plan_payload(parsed, recommendations), indent=2, sort_keys=True))
        else:
            for line in render_plan(parsed, recommendations):
                print(line)
        return 0
    out = args.out
    if out is None:
        first_dir = next((Path(c) for c in args.corpus if Path(c).is_dir()), None)
        if first_dir is None:
            parser.error("--out is required when CORPUS lists no directory")
        out = str(first_dir)
    _fit_and_write(args.corpus, out)
    return 0
