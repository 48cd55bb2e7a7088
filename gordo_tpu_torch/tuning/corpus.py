"""
The telemetry corpus reader (the port of ``gordo_tpu.tuning.corpus``):
everything a fleet records about itself, ``telemetry_report*.json``
builds, JSONL event logs and persisted rollups, ``results_*.json`` sweeps
and ``tune calibrate``'s output, read into one flat set of observations
for the cost model (``tuning/model.py``).

The reader tolerates every schema the JAX one does: rather than one
parser a schema, it walks each JSON document, and any object that states
a knob's value (under one of the knob's ``data_keys``, on itself or on an
ancestor, as context inherited downward) and carries one of that knob's
signal fields makes an :class:`Observation`. Missing fields make none,
never an error; an unreadable file becomes a note and is skipped.
Registry histograms (the ``{count, sum, buckets}`` shape, a persisted
rollup's batching series among them) are recognized by their metric
names and turned into scalar signals (mean, p99) first. The port's
``telemetry_report.json`` carries the JAX report's keys, so the two
give the same observations. Standard library only.
"""

import dataclasses
import json
import logging
import math
import typing
from pathlib import Path

from gordo_tpu_torch.observability import registry as registry_mod
from gordo_tpu_torch.tuning.knobs import KNOBS, Knob, Signal

logger = logging.getLogger(__name__)

#: file patterns a corpus directory is scanned for (recursive)
CORPUS_GLOBS: typing.Tuple[str, ...] = (
    "telemetry_report*.json",
    "results_*.json",
    "trajectory.json",
    "*calibration*.json",
    "*metrics*.json",
    "*.jsonl",
)

#: registry-histogram metric name -> derived scalar signal fields, each
#: (derived_field, statistic, scale). The scale turns the histogram's
#: native unit (seconds) into the signal's (ms).
HISTOGRAM_DERIVATIONS: typing.Dict[
    str, typing.Tuple[typing.Tuple[str, str, float], ...]
] = {
    "gordo_serve_batch_queue_wait_seconds": (
        ("queue_wait_mean_ms", "mean", 1000.0),
        ("queue_wait_p99_ms", "p99", 1000.0),
    ),
    "gordo_serve_batch_requests": (("mean_batch_size", "mean", 1.0),),
}


@dataclasses.dataclass(frozen=True)
class Observation:
    """One measured (knob arm, signal) point."""

    knob: str
    value: typing.Any  # the arm (knob setting the measurement ran under)
    metric: str  # canonical signal metric name
    metric_value: float
    source: str  # file the observation came from
    context: typing.Mapping[str, float] = dataclasses.field(
        default_factory=dict
    )


@dataclasses.dataclass
class FileNote:
    path: str
    kind: str  # "json" | "jsonl"
    n_observations: int = 0
    error: typing.Optional[str] = None


@dataclasses.dataclass
class Corpus:
    observations: typing.List[Observation] = dataclasses.field(
        default_factory=list
    )
    files: typing.List[FileNote] = dataclasses.field(default_factory=list)

    @property
    def n_files(self) -> int:
        return len(self.files)

    def for_knob(self, knob: str) -> typing.List[Observation]:
        return [o for o in self.observations if o.knob == knob]

    def meta(self) -> dict:
        """The corpus block a written profile carries."""
        return {
            "n_files": self.n_files,
            "n_observations": len(self.observations),
            "sources": sorted({f.path for f in self.files}),
            "skipped": [
                {"path": f.path, "error": f.error}
                for f in self.files
                if f.error
            ],
        }


# --------------------------------------------------------------------------
# the generic walker
# --------------------------------------------------------------------------


def _field_maps(
    knobs: typing.Sequence[Knob],
) -> typing.Tuple[
    typing.Dict[str, Knob],
    typing.Dict[str, typing.List[typing.Tuple[Knob, Signal]]],
]:
    """(knob-value field -> knob, signal field -> [(knob, signal)])."""
    value_fields: typing.Dict[str, Knob] = {}
    signal_fields: typing.Dict[
        str, typing.List[typing.Tuple[Knob, Signal]]
    ] = {}
    for knob in knobs:
        for key in knob.data_keys:
            value_fields[key] = knob
        for signal in knob.signals:
            for field in signal.fields:
                signal_fields.setdefault(field, []).append((knob, signal))
    return value_fields, signal_fields


def _is_scalar(value) -> bool:
    return (
        isinstance(value, (int, float))
        and not isinstance(value, bool)
        and math.isfinite(float(value))
    )


# Histogram-snapshot math lives in observability.registry so the corpus
# reader, the SLO engine, and the rollup merge share one implementation.
_histogram_state = registry_mod.histogram_state
_histogram_stat = registry_mod.histogram_stat


def _derived_fields(node: dict) -> typing.Dict[str, float]:
    """Scalar signal fields derived from any histogram-shaped values in
    ``node`` (see :data:`HISTOGRAM_DERIVATIONS`)."""
    derived: typing.Dict[str, float] = {}
    for key, value in node.items():
        rules = HISTOGRAM_DERIVATIONS.get(key)
        if not rules:
            continue
        state = _histogram_state(value)
        if state is None:
            continue
        for field, stat, scale in rules:
            stat_value = _histogram_stat(state, stat)
            if stat_value is not None:
                derived[field] = stat_value * scale
    return derived


def _normalize_knob_value(knob: Knob, value):
    """Round-tripping through JSON floats ints (and some emitters write
    1.0 for arm 1) — normalize to the knob's natural type."""
    if (
        isinstance(value, float)
        and not isinstance(value, bool)
        and value.is_integer()
        and knob.domain.contains(int(value))
        and not knob.domain.contains(value)
    ):
        return int(value)
    return value


def _walk(
    node,
    context: typing.Dict[str, typing.Any],
    value_fields: typing.Dict[str, Knob],
    signal_fields: typing.Dict[
        str, typing.List[typing.Tuple[Knob, Signal]]
    ],
    source: str,
    out: typing.List[Observation],
) -> None:
    if isinstance(node, list):
        for item in node:
            _walk(item, context, value_fields, signal_fields, source, out)
        return
    if not isinstance(node, dict):
        return
    # knob values stated on this object extend the inherited context
    local = context
    for field, knob in value_fields.items():
        if field in node and (
            _is_scalar(node[field]) or isinstance(node[field], str)
        ):
            if local is context:
                local = dict(context)
            local[knob.name] = _normalize_knob_value(knob, node[field])
    fields = dict(node)
    fields.update(_derived_fields(node))
    scalars = {k: float(v) for k, v in fields.items() if _is_scalar(v)}
    for field, pairs in signal_fields.items():
        if field not in scalars:
            continue
        for knob, signal in pairs:
            if knob.name not in local:
                continue
            ctx = {
                k: v
                for k, v in scalars.items()
                if k != field and k in _CONTEXT_FIELDS
            }
            out.append(
                Observation(
                    knob=knob.name,
                    value=local[knob.name],
                    metric=signal.metric,
                    metric_value=scalars[field],
                    source=source,
                    context=ctx,
                )
            )
    for value in node.values():
        if isinstance(value, (dict, list)):
            _walk(value, local, value_fields, signal_fields, source, out)


#: sibling scalar fields kept on each observation — the analytic
#: fallbacks (model.py) read these (e.g. per-dispatch overhead needs
#: n_dispatches next to dispatch_overhead_s)
_CONTEXT_FIELDS: typing.FrozenSet[str] = frozenset(
    {"n_dispatches", "epochs_run", "requests", "sheds", "mean_batch_size"}
) | {
    field
    for knob in KNOBS
    for signal in knob.signals
    for field in signal.fields
}


# --------------------------------------------------------------------------
# file ingestion
# --------------------------------------------------------------------------


def discover_files(
    paths: typing.Sequence[typing.Union[str, Path]]
) -> typing.List[Path]:
    out: typing.List[Path] = []
    seen: typing.Set[Path] = set()
    for raw in paths:
        path = Path(raw)
        candidates: typing.List[Path] = []
        if path.is_file():
            candidates = [path]
        elif path.is_dir():
            for pattern in CORPUS_GLOBS:
                candidates.extend(path.rglob(pattern))
        for candidate in sorted(candidates):
            resolved = candidate.resolve()
            if resolved not in seen:
                seen.add(resolved)
                out.append(candidate)
    return out


def read_corpus(
    paths: typing.Sequence[typing.Union[str, Path]],
    knobs: typing.Optional[typing.Sequence[Knob]] = None,
) -> Corpus:
    """
    Ingest every corpus file under ``paths`` (files and/or directories)
    into a :class:`Corpus`. Never raises on malformed content — a file
    that cannot be read or parsed becomes a :class:`FileNote` with an
    error, and objects missing knob/signal fields simply contribute
    nothing (an older report lacks fields, and reads all the same).
    """
    value_fields, signal_fields = _field_maps(knobs or KNOBS)
    corpus = Corpus()
    for path in discover_files(paths):
        note = FileNote(path=str(path), kind="json")
        before = len(corpus.observations)
        try:
            if path.suffix == ".jsonl":
                note.kind = "jsonl"
                _ingest_jsonl(
                    path, value_fields, signal_fields, corpus.observations
                )
            else:
                document = json.loads(path.read_text())
                _walk(
                    document,
                    {},
                    value_fields,
                    signal_fields,
                    str(path),
                    corpus.observations,
                )
        except (OSError, ValueError) as exc:
            note.error = str(exc)
            logger.warning("Skipping unreadable corpus file %s: %s", path, exc)
        note.n_observations = len(corpus.observations) - before
        corpus.files.append(note)
    return corpus


def _ingest_jsonl(
    path: Path,
    value_fields,
    signal_fields,
    out: typing.List[Observation],
) -> None:
    """Event-log lines (span logs and other JSONL ride the same reader:
    records without knob+signal co-occurrence contribute nothing). A
    torn last line — a crashed writer — is skipped, not fatal."""
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                record = json.loads(line)
            except ValueError:
                continue
            if isinstance(record, dict):
                _walk(record, {}, value_fields, signal_fields, str(path), out)
