"""
The serving plane's commands (the port of ``gordo_tpu.cli.plane``), on
argparse::

    python -m gordo_tpu_torch.cli slo check SPEC SNAPSHOT_OR_URL [--as-json]
    python -m gordo_tpu_torch.cli top STATUS_URL [--interval S] [--once] [--as-json]
    python -m gordo_tpu_torch.cli rollup --member ID=URL_OR_PATH ... [--interval S]
        [--persist FILE] [--retention N] [--host H] [--port P] [--once]

``slo check`` evaluates a spec (``observability/slo.py``) over merged
snapshots: a persisted rollup JSONL (each line a sample), one snapshot
file, or a live ``/status`` or ``/telemetry/snapshot`` URL; it exits 1
when an objective's budget is exhausted (one ``slo_budget_exhausted``
event each), 2 on a usage error. ``top`` redraws a plane's ``/status``
(a router's or ``rollup``'s) every ``--interval`` seconds; ``--once``
draws one frame and ``--as-json`` prints the body as it came. ``rollup``
polls members' ``/telemetry/snapshot`` (or snapshot files), merges them
and serves the merge at ``/metrics`` and ``/status`` on the port's HTTP
server; ``--once`` prints one merge as JSON instead. Flags, defaults,
text, JSON and exit codes are the JAX commands'. Calls go over
``utils/http.py``. Standard library only: none of these touches the
card.
"""

import argparse
import json
import sys
import time
from typing import List, Optional


def _load_snapshots(target: str) -> List[dict]:
    """The snapshots of TARGET: a URL (one), a JSONL history (one a
    line; a torn line is skipped) or one JSON file."""
    from gordo_tpu_torch.observability.rollup import fetch_json

    if target.startswith(("http://", "https://")):
        return [fetch_json(target)]
    snapshots: List[dict] = []
    if target.endswith(".jsonl"):
        with open(target) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    record = json.loads(line)
                except ValueError:
                    continue  # a torn last line: a writer that crashed
                if isinstance(record, dict):
                    snapshots.append(record)
    else:
        with open(target) as fh:
            snapshots.append(json.load(fh))
    return snapshots


def slo_check(parser: argparse.ArgumentParser, args) -> int:
    from gordo_tpu_torch.observability.events import emit_event
    from gordo_tpu_torch.observability.slo import (
        SloSpecError,
        evaluate,
        load_slo_spec,
        render_report,
    )

    try:
        spec = load_slo_spec(args.spec)
    except (OSError, SloSpecError) as exc:
        parser.error(f"Cannot load SLO spec {args.spec}: {exc}")
    try:
        snapshots = _load_snapshots(args.target)
    except (OSError, ValueError) as exc:
        parser.error(f"Cannot load snapshots from {args.target}: {exc}")
    if not snapshots:
        parser.error(f"No snapshots found in {args.target}")
    report = evaluate(spec, snapshots)
    if args.as_json:
        print(json.dumps(report.to_dict(), indent=2, default=str))
    else:
        print(render_report(report))
    if report.ok:
        return 0
    for result in report.results:
        if result.exhausted:
            emit_event("slo_budget_exhausted", spec=spec.name,
                       objective=result.objective.label(), signal=result.objective.signal,
                       burn_rate=result.burn_rate,
                       violating_fraction=result.violating_fraction)
    return 1


def render_top(status: dict) -> str:
    """One frame of ``top`` (the JAX command's text)."""
    signals = status.get("signals") or {}
    lines = [
        "gordo-tpu plane  {ts}  (snapshot v{v})".format(
            ts=status.get("ts", "?"), v=status.get("snapshot_version", "?")),
        "",
        "control signals:",
    ]
    # the four autoscaling signals first, then the rest
    ordered = ["shed_rate", "queue_depth", "stream_backlog", "replicas_healthy"]
    for key in ordered + sorted(k for k in signals if k not in ordered):
        value = signals.get(key)
        rendered = "n/a" if value is None else f"{value:.4g}"
        lines.append(f"  {key:<26} {rendered}")
    lines.append("")
    replicas = status.get("replicas") or {}
    lines.append(f"replicas ({len(replicas)}):")
    for rid in sorted(replicas):
        info = replicas[rid]
        health = info.get("health") or {}
        lines.append(
            "  {rid:<12} {status:<12} breaker={state:<10} "
            "queue={q} sheds={s} streams={st} backlog={b}".format(
                rid=rid, status=info.get("status") or "?", state=health.get("state", "?"),
                q=info.get("queue_depth", "?"), s=info.get("sheds_total", "?"),
                st=info.get("stream_sessions", "?"), b=info.get("stream_backlog", "?")))
    for mid, info in sorted((status.get("lifecycle") or {}).items()):
        tick = (info.get("status") or {}).get("last_tick_unix_ms")
        lines.append(f"lifecycle {mid}: last tick unix_ms={tick}")
    for err in status.get("merge_errors") or []:
        lines.append("MERGE REFUSED {m}: {e}".format(m=err.get("metric", "?"),
                                                     e=err.get("error", "?")))
    return "\n".join(lines)


def top(args) -> int:
    from gordo_tpu_torch.observability.rollup import fetch_json

    url = args.url
    if not url.rstrip("/").endswith("/status"):
        url = url.rstrip("/") + "/status"
    while True:
        status = fetch_json(url)
        if args.as_json:
            print(json.dumps(status, indent=2, default=str))
        else:
            if not args.once:
                print("\x1b[2J\x1b[H", end="")  # clear and home: a redraw without curses
            print(render_top(status))
        sys.stdout.flush()
        if args.once or args.as_json:
            return 0
        time.sleep(args.interval)


def rollup(parser: argparse.ArgumentParser, args) -> int:
    from gordo_tpu_torch.observability.rollup import RollupPoller, rollup_wsgi_app
    from gordo_tpu_torch.router.app import parse_replica_entries

    try:
        members = parse_replica_entries(args.member)
    except ValueError as exc:
        parser.error(str(exc))
    poller = RollupPoller(members=lambda: members, interval_s=0.0 if args.once else args.interval,
                          persist_path=args.persist, retention=args.retention)
    if args.once:
        print(json.dumps(poller.poll_once(), indent=2, default=str))
        return 0
    from gordo_tpu_torch.server.runner import make_http_server

    poller.start()
    server = make_http_server(rollup_wsgi_app(poller), args.host, args.port)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        poller.stop()
    return 0


def _at_least(minimum: float, cast=float):
    def parse(text: str):
        value = cast(text)
        if value < minimum:
            raise argparse.ArgumentTypeError(f"{value} is smaller than the minimum {minimum}")
        return value
    return parse


def main(argv: Optional[List[str]] = None) -> int:
    """``slo``, ``top`` or ``rollup``: ``argv[0]`` names the command."""
    argv = sys.argv[1:] if argv is None else list(argv)
    prog = "python -m gordo_tpu_torch.cli"
    command = argv[0] if argv else ""
    if command == "slo":
        parser = argparse.ArgumentParser(
            prog=f"{prog} slo", description="Error budgets: SLO specs evaluated against "
                                            "merged plane snapshots.")
        actions = parser.add_subparsers(dest="slo_command", required=True)
        check = actions.add_parser("check", help="evaluate a spec; exit 1 on an exhausted budget")
        check.add_argument("spec", metavar="SPEC")
        check.add_argument("target", metavar="SNAPSHOT_OR_URL")
        check.add_argument("--as-json", action="store_true",
                           help="Emit the full report object instead of the human table.")
        return slo_check(check, parser.parse_args(argv[1:]))
    if command == "top":
        parser = argparse.ArgumentParser(prog=f"{prog} top",
                                         description="Live view of a plane's /status.")
        parser.add_argument("url", metavar="STATUS_URL")
        parser.add_argument("--interval", type=_at_least(0.1), default=2.0,
                            help="Seconds between redraws. (default: 2.0)")
        parser.add_argument("--once", action="store_true", help="Render one frame and exit.")
        parser.add_argument("--as-json", action="store_true",
                            help="Emit the raw /status JSON instead of the rendered view.")
        return top(parser.parse_args(argv[1:]))
    if command == "rollup":
        parser = argparse.ArgumentParser(
            prog=f"{prog} rollup", description="The plane rollup for a plane with no router.")
        parser.add_argument("--member", action="append", required=True,
                            metavar="ID=URL_OR_PATH",
                            help="One member as id=base-url or id=path to a snapshot JSON "
                                 "file. Repeatable.")
        parser.add_argument("--interval", type=_at_least(0.1), default=10.0,
                            help="Seconds between polls. (default: 10.0)")
        parser.add_argument("--persist", default=None,
                            help="JSONL path merged snapshots persist to (corpus-ingestable).")
        parser.add_argument("--retention", type=_at_least(1, int), default=500,
                            help="Merged snapshots kept in the persisted JSONL. (default: 500)")
        parser.add_argument("--host", default="0.0.0.0",
                            help="Host to serve the merged /metrics + /status on.")
        parser.add_argument("--port", type=int, default=5557,
                            help="Port to serve the merged /metrics + /status on.")
        parser.add_argument("--once", action="store_true",
                            help="Poll every member once, print the merged snapshot as JSON, "
                                 "and exit (no server).")
        return rollup(parser, parser.parse_args(argv[1:]))
    raise SystemExit(f"unknown plane command {command!r}: slo, top or rollup")
