"""
The ``profile`` command (the port of ``gordo_tpu.cli.profile``): the
cost-seam report, on argparse::

    python -m gordo_tpu_torch.cli profile report PATH [--top N]
    python -m gordo_tpu_torch.cli profile flame PATH [-o FILE]

PATH is the dump the sampling wall profiler flushes
(``GORDO_PROFILE_OUT``, default ``gordo_profile.json``): folded stacks,
per-phase and per-module sample counts, and the phase ledger's
``gordo_phase_seconds`` histograms embedded at flush.

- ``report``: where each plane's wall time went by phase (host against
  device), and inside the host phases which Python modules the samples
  landed in;
- ``flame``: the folded stacks in flamegraph.pl's input format (one
  ``stack count`` line a stack, hottest first).

Both print what the JAX command prints on the same dump; a file that is
no profile dump exits 1 with the JAX command's message.
"""

import argparse
import json
import os
import sys
import typing

from gordo_tpu_torch.observability.attribution import DEVICE_PHASES
from gordo_tpu_torch.observability.sampling import folded_lines


class ProfileError(Exception):
    """A PATH that is no profile dump."""


def _load_profile(path: str) -> dict:
    with open(path) as fh:
        payload = json.load(fh)
    if not isinstance(payload, dict) or "profile_version" not in payload:
        raise ProfileError(f"{path} is not a gordo profile dump (missing profile_version)")
    return payload


def _phase_rows(payload: dict) -> typing.List[typing.Tuple[str, str, int, float]]:
    """(plane, phase, count, sum_s) rows from the embedded ledger
    histograms, largest total first."""
    rows = []
    for key, state in (payload.get("phase_seconds") or {}).items():
        plane, _, phase = key.partition("/")
        rows.append((plane, phase, int(state.get("count") or 0), float(state.get("sum") or 0.0)))
    rows.sort(key=lambda r: -r[3])
    return rows


def render_report(payload: dict, top: int = 5) -> str:
    """The cost-seam report text: the ledger's phase table with the host
    and device split, then each host phase's modules by samples."""
    lines: typing.List[str] = []
    n = payload.get("n_samples") or 0
    dur = payload.get("duration_s")
    lines.append(f"profile: {n} samples @ {payload.get('hz')} Hz"
                 + (f" over {dur:.1f}s" if dur else ""))
    rows = _phase_rows(payload)
    total_s = sum(r[3] for r in rows)
    host_s = sum(r[3] for r in rows if r[1] not in DEVICE_PHASES)
    device_s = total_s - host_s
    lines.append("")
    lines.append("phase ledger (gordo_phase_seconds):")
    lines.append(f"  {'plane/phase':<24} {'side':<7} {'count':>8} {'total_s':>10} {'share':>7}")
    for plane, phase, count, sum_s in rows:
        side = "device" if phase in DEVICE_PHASES else "host"
        share = sum_s / total_s if total_s else 0.0
        lines.append(f"  {plane + '/' + phase:<24} {side:<7} {count:>8} "
                     f"{sum_s:>10.3f} {share:>6.1%}")
    if total_s:
        lines.append(f"  host {host_s:.3f}s ({host_s / total_s:.1%})  "
                     f"device {device_s:.3f}s ({device_s / total_s:.1%})")
    lines.append("")
    lines.append("sampled host cost by phase (top modules):")
    per_phase = payload.get("per_phase") or {}
    modules_by_phase = payload.get("modules_by_phase") or {}
    for key, count in sorted(per_phase.items(), key=lambda kv: -kv[1]):
        phase = key.rpartition("/")[2]
        if phase in DEVICE_PHASES:
            continue
        lines.append(f"  {key}: {count} samples")
        modules = modules_by_phase.get(key) or {}
        for mod, mod_count in sorted(modules.items(), key=lambda kv: -kv[1])[:top]:
            lines.append(f"    {mod}: {mod_count}")
    return "\n".join(lines)


def _existing_file(text: str) -> str:
    if not os.path.exists(text):
        raise argparse.ArgumentTypeError(f"File '{text}' does not exist.")
    if os.path.isdir(text):
        raise argparse.ArgumentTypeError(f"File '{text}' is a directory.")
    return text


def _at_least_one(text: str) -> int:
    value = int(text)
    if value < 1:
        raise argparse.ArgumentTypeError(f"{value} is not in the range x>=1.")
    return value


def main(argv: typing.Optional[typing.List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m gordo_tpu_torch.cli profile",
        description="The cost-seam report: phase ledger + wall-profiler samples.")
    commands = parser.add_subparsers(dest="profile_command", required=True)
    report = commands.add_parser(
        "report", help="Render the cost-seam report from the profile dump at PATH "
                       "(GORDO_PROFILE_OUT).")
    report.add_argument("path", type=_existing_file)
    report.add_argument("--top", type=_at_least_one, default=5,
                        help="Modules to list per sampled phase.  [default: 5]")
    flame = commands.add_parser(
        "flame", help="Emit the profile's folded stacks (flamegraph.pl input format).")
    flame.add_argument("path", type=_existing_file)
    flame.add_argument("--output", "-o", default=None,
                       help="Write folded stacks here (default: stdout).")
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    try:
        payload = _load_profile(args.path)
    except ProfileError as err:
        print(f"Error: {err}", file=sys.stderr)
        return 1
    if args.profile_command == "report":
        print(render_report(payload, top=args.top))
        return 0
    lines = folded_lines(payload)
    text = "\n".join(lines)
    if args.output:
        with open(args.output, "w") as fh:
            fh.write(text + ("\n" if text else ""))
        print(f"wrote {len(lines)} folded stacks to {args.output}")
    else:
        print(text)
    return 0
