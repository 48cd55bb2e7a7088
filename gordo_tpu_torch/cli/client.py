"""
The ``client`` command (the port of ``gordo_tpu.cli.client``), on
argparse::

    python -m gordo_tpu_torch.cli client [--project P] [--host H] [--port N]
        [--scheme http|https] [--batch-size N] [--parallelism N]
        [--metadata KEY,VALUE ...] [--session-config YAML]
        predict START END [--target M ...] [--data-provider YAML]
            [--output-dir DIR] [--forward-resampled-sensors] [--n-retries N]
            [--fleet | --no-fleet] [--fleet-group-size N]
    ... metadata [--output-file FILE] [--target M ...]
    ... download-model OUTPUT_DIR [--target M ...]

The JAX command's flags, defaults and output, but for what the card's
machine cannot do: the port sends JSON (``--parquet`` raises, naming
``pyarrow``; ``--no-parquet`` is the default), forwards to no Influx
(``--influx-uri`` raises, naming ``influxdb``), and ``--session-config``
takes ``headers`` only (it configured a ``requests.Session``), refusing
any other key by name (ROADMAP.md queue 3 item 1 (i)-(k)). ``predict``
prints the failures and exits 1 when any prediction failed;
``--output-dir`` gets ``<machine>.csv.gz``, written as pandas'
``DataFrame.to_csv`` writes the JAX client's two-level frame (two header
rows, the index as ``str`` of its timestamps, numbers as ``repr``, NaN
and None empty), so pandas reads both files back equal. ``metadata``
prints or writes (``--output-file``) each machine's metadata as JSON;
``download-model`` writes each machine's artifact (the
``/download-model`` archive, checked by loading it on the CPU) into
``OUTPUT_DIR/<machine>``.
"""

import argparse
import csv
import gzip
import json
import os
import sys
from datetime import datetime
from pprint import pprint
from typing import List, Optional

from gordo_tpu_torch.workflow.yaml_reader import safe_load

_UNSUPPORTED = {
    "parquet": "--parquet needs the 'pyarrow' package, which this port does not use; the "
               "client sends JSON (--no-parquet, the default)",
    "influx_uri": "--influx-uri needs the 'influxdb' package, which this port does not use",
}


def _iso_datetime(text: str) -> datetime:
    try:
        return datetime.fromisoformat(text)
    except ValueError:
        raise argparse.ArgumentTypeError(f"'{text}' is not an ISO-formatted datetime") from None


def _key_value(text: str):
    if "," not in text:
        raise argparse.ArgumentTypeError(f"Expected 'key,value' (comma-separated), got {text!r}")
    return tuple(text.split(",", 1))


def _session_config(text: str) -> dict:
    try:
        config = safe_load(text)
    except ValueError as err:
        raise argparse.ArgumentTypeError(f"--session-config did not parse: {err}") from None
    config = config or {}
    if not isinstance(config, dict):
        raise argparse.ArgumentTypeError("--session-config must be a mapping")
    other = sorted(set(config) - {"headers"})
    if other:
        raise argparse.ArgumentTypeError(
            f"--session-config takes 'headers' only (the port calls servers with http.client, "
            f"not a requests.Session); refused: {', '.join(other)}"
        )
    return config


def data_provider(text: str):
    """A data provider from inline YAML/JSON or a YAML/JSON file: a
    mapping with a ``type`` naming a provider of the port."""
    from gordo_tpu_torch.data import providers

    text = open(text).read() if os.path.isfile(text) else text
    spec = safe_load(text)
    if not isinstance(spec, dict) or "type" not in spec:
        raise argparse.ArgumentTypeError("a data-provider definition needs a 'type' key")
    spec = dict(spec)
    kind = spec.pop("type")
    provider_cls = getattr(providers, kind, None)
    if provider_cls is None:
        raise argparse.ArgumentTypeError(f"No DataProvider named '{kind}'")
    return provider_cls(**spec)


def _cell(value) -> str:
    if value is None or (isinstance(value, float) and value != value):
        return ""
    return repr(value) if isinstance(value, float) else str(value)


def write_csv_gz(frame, path: str) -> None:
    """``frame`` (a :class:`BlockFrame`) as pandas writes a two-level
    column frame with ``to_csv(path, compression="gzip")``."""
    with gzip.open(path, "wt", newline="") as fh:
        writer = csv.writer(fh, lineterminator="\n")
        if not frame.blocks:
            writer.writerow([""])  # pandas writes an empty frame as ""
            return
        tops = [top for top, (labels, _) in frame.blocks.items() for _ in labels]
        subs = [label for labels, _ in frame.blocks.values() for label in labels]
        writer.writerow(["", *tops])
        writer.writerow(["", *subs])
        columns = [values[:, j].tolist() for labels, values in frame.blocks.values()
                   for j in range(len(labels))]
        for i, label in enumerate(frame.index):
            writer.writerow([str(label), *(_cell(column[i]) for column in columns)])


def _client(args, **kwargs):
    from gordo_tpu_torch.client import Client

    headers = (args.session_config or {}).get("headers") or {}
    return Client(
        args.project, host=args.host, port=args.port, scheme=args.scheme,
        batch_size=args.batch_size, parallelism=args.parallelism,
        metadata=dict(args.metadata), headers={str(k): str(v) for k, v in headers.items()},
        **kwargs,
    )


def predict(args) -> int:
    client = _client(args, data_provider=args.data_provider,
                     forward_resampled_sensors=args.forward_resampled_sensors,
                     n_retries=args.n_retries)
    targets = list(args.target)
    if args.fleet:
        predictions = client.predict_fleet(args.start, args.end, targets=targets,
                                           group_size=args.fleet_group_size)
    else:
        predictions = client.predict(args.start, args.end, targets=targets)
    print(f"\n{'-' * 20} Summary of failed predictions (if any) {'-' * 20}")
    exit_code = 0
    for _name, _frame, error_messages in predictions:
        for message in error_messages:
            exit_code = 1
            print(message)
    if args.output_dir is not None:
        for name, frame, _ in predictions:
            write_csv_gz(frame, os.path.join(args.output_dir, f"{name}.csv.gz"))
    return exit_code


def metadata(args) -> int:
    fetched = _client(args).get_metadata(targets=list(args.target))
    meta = {name: record.to_dict() for name, record in fetched.items()}
    if args.output_file:
        with open(args.output_file, "w") as fh:
            json.dump(meta, fh)
        print(f"Saved metadata json to file: '{args.output_file}'")
    else:
        pprint(meta)
    return 0


def download_model(args) -> int:
    from gordo_tpu_torch import serializer

    archives = _client(args).download_archives(targets=list(args.target))
    for name, data in archives.items():
        serializer.loads(data, device="cpu")  # a whole, loadable artifact
        out_dir = os.path.join(args.output_dir, name)
        os.mkdir(out_dir)
        print(f"Writing model '{name}' to directory: '{out_dir}'...", end="")
        serializer.unpack(data, out_dir)
        print("done")
    print(f"Wrote all models to directory: {args.output_dir}")
    return 0


def _existing_dir(text: str) -> str:
    if not os.path.isdir(text):
        raise argparse.ArgumentTypeError(f"Directory '{text}' does not exist")
    return text


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m gordo_tpu_torch.cli client",
                                description="Client sub-commands (predict / metadata / "
                                            "download-model).")
    p.add_argument("--project", help="The project to target")
    p.add_argument("--host", default="localhost", help="The host the server is running on")
    p.add_argument("--port", type=int, default=443, help="Port the server is running on")
    p.add_argument("--scheme", default="https", help="http or https")
    p.add_argument("--batch-size", type=int, default=100000, help="How many samples to send")
    p.add_argument("--parallelism", type=int, default=10, help="Maximum concurrent jobs to run")
    p.add_argument("--metadata", type=_key_value, action="append", default=[],
                   help="key,value pair sent as metadata labels with forwarded predictions; "
                        "repeatable")
    p.add_argument("--session-config", type=_session_config, default={},
                   help="YAML/JSON with the headers sent with every call, e.g. "
                        "\"{'headers': {'API-KEY': 'foo'}}\"")
    commands = p.add_subparsers(dest="client_command", required=True)
    target = dict(action="append", default=[],
                  help="Machines to target; defaults to all machines in the project")
    pred = commands.add_parser("predict", help="run predictions for [START, END]")
    pred.add_argument("start", type=_iso_datetime)
    pred.add_argument("end", type=_iso_datetime)
    pred.add_argument("--target", **target)
    pred.add_argument("--data-provider", type=data_provider,
                      default=os.environ.get("DATA_PROVIDER"),
                      help="DataProvider JSON/YAML (requires a 'type' key)")
    pred.add_argument("--output-dir", type=_existing_dir,
                      help="Save output prediction frames in a directory")
    pred.add_argument("--influx-uri", default=None, help="not supported: needs influxdb")
    pred.add_argument("--influx-api-key", default=None, help="Key for the destination influx")
    pred.add_argument("--influx-recreate-db", action="store_true",
                      help="Recreate the destination DB before writing")
    pred.add_argument("--forward-resampled-sensors", action="store_true",
                      help="Forward the resampled sensor values")
    pred.add_argument("--n-retries", type=int, default=5,
                      help="Times the client should retry failed predictions")
    pred.add_argument("--parquet", action=argparse.BooleanOptionalAction, default=False,
                      help="not supported (needs pyarrow): the port sends JSON")
    pred.add_argument("--fleet", action=argparse.BooleanOptionalAction, default=False,
                      help="Batch groups of machines into single fleet-endpoint requests")
    pred.add_argument("--fleet-group-size", type=int, default=8,
                      help="Machines per fleet request when --fleet is given")
    meta = commands.add_parser("metadata", help="fetch machine metadata")
    meta.add_argument("--output-file", default=None,
                      help="Optional output file to save metadata")
    meta.add_argument("--target", **target)
    download = commands.add_parser("download-model", help="download models into directories")
    download.add_argument("output_dir", type=_existing_dir)
    download.add_argument("--target", **target)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    p = parser()
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    if args.client_command == "predict":
        for option, message in _UNSUPPORTED.items():
            if getattr(args, option):
                p.error(message)
        if isinstance(args.data_provider, str):
            args.data_provider = data_provider(args.data_provider)
        return predict(args)
    if args.client_command == "metadata":
        return metadata(args)
    return download_model(args)
