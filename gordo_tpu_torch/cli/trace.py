"""
The ``trace`` command (the port of ``gordo_tpu.cli.trace``): read span
logs (``GORDO_TPU_TRACE_LOG`` JSONL files), on argparse::

    python -m gordo_tpu_torch.cli trace summarize PATH [--top N]
    python -m gordo_tpu_torch.cli trace export PATH [-o FILE]

PATH is a span file or a directory whose ``*.jsonl`` files are read
(records that are no spans, an event log's, are left out). ``summarize``
prints the totals by span name and machine and the critical paths of the
slowest traces; ``export`` writes Chrome-trace JSON (Perfetto,
``chrome://tracing``) to FILE or standard output. The output is the JAX
command's on the same files.
"""

import argparse
import json
import os
import sys
from typing import List, Optional

from gordo_tpu_torch.observability.tracing import (
    read_spans,
    spans_to_chrome_trace,
    summarize_spans,
)


def collect_spans(path: str) -> List[dict]:
    """The spans of a JSONL file, or of every ``*.jsonl`` under a
    directory (sorted file names within each directory)."""
    if os.path.isdir(path):
        spans: List[dict] = []
        for root, _, files in os.walk(path):
            for name in sorted(files):
                if name.endswith(".jsonl"):
                    spans.extend(read_spans(os.path.join(root, name)))
        return spans
    return read_spans(path)


def _existing_path(text: str) -> str:
    if not os.path.exists(text):
        raise argparse.ArgumentTypeError(f"Path '{text}' does not exist")
    return text


def _positive(text: str) -> int:
    value = int(text)
    if value < 1:
        raise argparse.ArgumentTypeError("--top must be at least 1")
    return value


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="python -m gordo_tpu_torch.cli trace",
                                     description="Inspect span logs (GORDO_TPU_TRACE_LOG).")
    commands = parser.add_subparsers(dest="trace_command", required=True)
    summarize = commands.add_parser("summarize", help="totals and critical paths of a span log")
    summarize.add_argument("path", type=_existing_path)
    summarize.add_argument("--top", type=_positive, default=5,
                           help="How many slowest traces to show the critical path for.")
    export = commands.add_parser("export", help="Chrome-trace JSON of a span log")
    export.add_argument("path", type=_existing_path)
    export.add_argument("--output", "-o", default=None,
                        help="Write the Chrome-trace JSON here (default: stdout).")
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    spans = collect_spans(args.path)
    if args.trace_command == "summarize":
        print(summarize_spans(spans, top=args.top))
        return 0
    payload = spans_to_chrome_trace(spans)
    text = json.dumps(payload)
    if args.output:
        with open(args.output, "w") as fh:
            fh.write(text + "\n")
        print(f"wrote {len(payload['traceEvents'])} trace events to {args.output}")
    else:
        print(text)
    return 0
