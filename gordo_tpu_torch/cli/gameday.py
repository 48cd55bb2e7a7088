"""
The ``gameday`` command (the port of ``gordo_tpu.cli.gameday``), on
argparse::

    python -m gordo_tpu_torch.cli gameday list [--as-json]
    python -m gordo_tpu_torch.cli gameday run [NAMES...] [--scenario-file F]...
        [--collection DIR] [--workdir DIR] [--output F] [--as-json] [--device cpu]

``list`` prints the shipped scenarios (plane, timeline, SLO objectives);
``--as-json`` prints their documents. ``run`` trains a throwaway
game-day fleet (unless ``--collection`` names a built ``models`` tree),
runs the named scenarios (by default every shipped one the port can run)
and the ``--scenario-file`` ones against an in-process plane on the card
(``--device cpu``: on the CPU), prints a verdict a scenario and exits
with the number of failures; ``--output`` writes the whole report.

``rolling-upgrade`` re-stamps the AOT program store, which the port
lacks (``programs/``, ROADMAP.md queue 1 item 9): ``list`` marks it, a
``run`` with no names reports it as skipped (not a failure), and naming
it, or a file that uses ``bump_jaxlib_manifest``, exits 2.
"""

import argparse
import json
import sys
import time
from typing import List, Optional


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="gameday",
        description="Declarative game days: fault timelines with SLO budgets run against an "
                    "in-process serving plane.")
    actions = parser.add_subparsers(dest="gameday_command", required=True)
    listing = actions.add_parser("list", help="the shipped scenario catalogue")
    listing.add_argument("--as-json", action="store_true",
                         help="emit the raw scenario documents instead of the table")
    run = actions.add_parser("run", help="run game-day scenarios; exit code = failures")
    run.add_argument("names", nargs="*", help="shipped scenarios (default: every runnable one)")
    run.add_argument("--scenario-file", dest="scenario_files", action="append", default=[],
                     help="a scenario YAML or JSON file (repeatable)")
    run.add_argument("--collection", default=None,
                     help="a built game-day 'models' tree; default: train a throwaway fleet")
    run.add_argument("--workdir", default=None,
                     help="working directory, kept after the run; default: a temporary one")
    run.add_argument("--output", default=None, help="write the whole report JSON here")
    run.add_argument("--as-json", action="store_true",
                     help="print the report JSON instead of the summary")
    run.add_argument("--device", default=None,
                     help="where the plane's models run: the card unless 'cpu'")
    return parser


def gameday_list(as_json: bool) -> int:
    from gordo_tpu_torch.scenario import builtin_scenarios, scenario_documents

    if as_json:
        print(json.dumps(scenario_documents(), indent=2))
        return 0
    for name, scenario in sorted(builtin_scenarios().items()):
        verbs = ", ".join(f"{e.at_s:g}s {e.action}" for e in scenario.timeline)
        objectives = ", ".join(o.label() for o in scenario.slo.objectives)
        print(name)
        print(f"  {scenario.description}")
        print(f"  plane: {scenario.plane.replicas} replicas · {scenario.workload.streams} "
              f"streams · {scenario.duration_s:g}s")
        print(f"  timeline: {verbs}")
        print(f"  slo: {objectives}")
        why = scenario.unported()
        if why:
            print(f"  not ported: {why}")
    return 0


def gameday_run(parser: argparse.ArgumentParser, args) -> int:
    import shutil
    import tempfile

    from gordo_tpu_torch.observability import emit_event
    from gordo_tpu_torch.scenario import (
        ScenarioError,
        builtin_scenarios,
        load_scenario,
        run_scenario,
        shared_gameday_collection,
    )

    shipped = builtin_scenarios()
    unknown = sorted(set(args.names) - set(shipped))
    if unknown:
        parser.error(f"Unknown scenario(s) {unknown}; shipped: {sorted(shipped)}")
    chosen = [shipped[n] for n in args.names]
    try:
        chosen += [load_scenario(path) for path in args.scenario_files]
    except (OSError, ScenarioError) as exc:
        parser.error(str(exc))
    refused = [f"{s.name}: {s.unported()}" for s in chosen if s.unported()]
    if refused:
        parser.error("cannot run in gordo_tpu_torch: " + "; ".join(refused))
    skipped = []
    if not args.names and not args.scenario_files:
        for name in sorted(shipped):
            if shipped[name].unported():
                skipped.append({"scenario": name, "reason": shipped[name].unported()})
            else:
                chosen.append(shipped[name])

    cleanup = args.workdir is None
    workdir = args.workdir or tempfile.mkdtemp(prefix="gordo-gameday-")
    started = time.time()
    reports = []
    try:
        collection = args.collection
        if collection is None:
            print("Training the gameday fleet (one-time) ...", flush=True)
            collection = shared_gameday_collection(workdir, device=args.device)
        for scenario in chosen:
            print(f"▸ {scenario.name} ...", end="", flush=True)
            report = run_scenario(scenario, collection, workdir, device=args.device)
            reports.append(report)
            verdict = "pass" if report["ok"] else "FAIL"
            print(f" {verdict} (slo burn {report['slo']['max_burn_rate']:.2f}x, "
                  f"{len(report['unstructured_errors'])} unstructured, "
                  f"{report['streams']['reconnects']} resumes, {report['wall_time_s']:.1f}s)",
                  flush=True)
            for line in report["expect_failures"]:
                print(f"    expect: {line}")
            for line in report["unstructured_errors"][:5]:
                print(f"    error: {line}")
        for item in skipped:
            print(f"▸ {item['scenario']} ... skipped ({item['reason']})")
    finally:
        if cleanup:
            shutil.rmtree(workdir, ignore_errors=True)

    failures = [r for r in reports if not r["ok"]]
    payload = {
        "bench": "gameday",
        "n_scenarios": len(reports),
        "n_failed": len(failures),
        "n_skipped": len(skipped),
        "ok": not failures,
        "wall_time_s": round(time.time() - started, 2),
        "scenarios": reports,
        "skipped": skipped,
    }
    if args.output:
        with open(args.output, "w") as fh:
            json.dump(payload, fh, indent=2, default=str)
        print(f"Report written to {args.output}")
    if args.as_json:
        print(json.dumps(payload, indent=2, default=str))
    if failures:
        emit_event("gameday_failed", scenarios=[r["scenario"] for r in failures])
        print(f"{len(failures)}/{len(reports)} scenario(s) failed: "
              + ", ".join(r["scenario"] for r in failures))
    else:
        print(f"All {len(reports)} scenario(s) passed"
              + (f", {len(skipped)} skipped." if skipped else "."))
    return len(failures)


def main(argv: Optional[List[str]] = None) -> int:
    parser = _parser()
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    if args.gameday_command == "list":
        return gameday_list(args.as_json)
    return gameday_run(parser, args)
