"""
Service-level objectives as error budgets (the port of
``gordo_tpu.observability.slo``).

A spec, YAML or JSON, names objectives over the rollup's control
signals (``rollup.compute_signals``)::

    name: serving
    objectives:
      - signal: predict_p99_ms
        threshold: 250          # violating when the signal is above it
        window_s: 3600          # samples older than this are ignored
        budget: 0.01            # the violating fraction allowed

:func:`evaluate` runs a spec over a time-ordered sequence of merged
snapshots (one a poll: the rollup's persisted JSONL) and gives each
objective its error budget: the violating fraction of the samples in
its window, the burn rate (that fraction over the budget) and whether
the budget is exhausted. ``slo check`` exits 1 when one is. A spec is
read as JSON, or else by the port's YAML reader
(``workflow/yaml_reader.py``; the card's machine has no PyYAML).
Standard library only: no torch.
"""

import dataclasses
import json
import os
from typing import List, Mapping, Optional, Sequence, Tuple

from gordo_tpu_torch.observability import rollup as rollup_mod

#: the signals a spec may name: the rollup's vocabulary
KNOWN_SIGNALS = (
    "predict_p99_ms",
    "shed_rate",
    "unstructured_error_rate",
    "stream_resume_rate",
    "drift_scan_staleness_s",
    "queue_depth",
    "stream_backlog",
    "program_cache_hit_rate",
    "host_fraction",
    "device_fraction",
)

DEFAULT_WINDOW_S = 3600.0
DEFAULT_BUDGET = 0.01


class SloSpecError(ValueError):
    """A spec that cannot be evaluated (an unknown signal, a bad shape)."""


@dataclasses.dataclass(frozen=True)
class SloObjective:
    """``signal`` stays at or below ``threshold`` in all but a
    ``budget`` fraction of the samples of the trailing window."""

    signal: str
    threshold: float
    window_s: float = DEFAULT_WINDOW_S
    budget: float = DEFAULT_BUDGET
    name: Optional[str] = None

    def label(self) -> str:
        return self.name or self.signal

    def to_dict(self) -> dict:
        return {"name": self.label(), "signal": self.signal, "threshold": self.threshold,
                "window_s": self.window_s, "budget": self.budget}


@dataclasses.dataclass(frozen=True)
class SloSpec:
    name: str
    objectives: Tuple[SloObjective, ...]

    def to_dict(self) -> dict:
        return {"name": self.name, "objectives": [o.to_dict() for o in self.objectives]}


@dataclasses.dataclass
class ObjectiveResult:
    """One objective's error budget."""

    objective: SloObjective
    n_samples: int
    n_violating: int
    last_value: Optional[float]
    violating_fraction: float
    burn_rate: float
    exhausted: bool

    def to_dict(self) -> dict:
        return {
            **self.objective.to_dict(),
            "n_samples": self.n_samples,
            "n_violating": self.n_violating,
            "last_value": self.last_value,
            "violating_fraction": self.violating_fraction,
            "burn_rate": self.burn_rate,
            "exhausted": self.exhausted,
        }


@dataclasses.dataclass
class SloReport:
    spec: SloSpec
    results: List[ObjectiveResult]

    @property
    def ok(self) -> bool:
        return not any(r.exhausted for r in self.results)

    @property
    def max_burn_rate(self) -> float:
        return max((r.burn_rate for r in self.results), default=0.0)

    def to_dict(self) -> dict:
        return {"spec": self.spec.name, "ok": self.ok, "max_burn_rate": self.max_burn_rate,
                "objectives": [r.to_dict() for r in self.results]}


def parse_slo_spec(document: dict, name: str = "slo") -> SloSpec:
    if not isinstance(document, dict):
        raise SloSpecError("SLO spec must be a mapping")
    raw_objectives = document.get("objectives")
    if not isinstance(raw_objectives, list) or not raw_objectives:
        raise SloSpecError("SLO spec needs a non-empty 'objectives' list")
    objectives = []
    for raw in raw_objectives:
        if not isinstance(raw, dict):
            raise SloSpecError(f"Objective must be a mapping, got {raw!r}")
        signal = raw.get("signal") or raw.get("objective")
        if signal not in KNOWN_SIGNALS:
            raise SloSpecError(f"Unknown SLO signal {signal!r}; known: {KNOWN_SIGNALS}")
        if "threshold" not in raw:
            raise SloSpecError(f"Objective {signal!r} needs a 'threshold'")
        objectives.append(SloObjective(
            signal=signal,
            threshold=float(raw["threshold"]),
            window_s=float(raw.get("window_s", DEFAULT_WINDOW_S)),
            budget=float(raw.get("budget", DEFAULT_BUDGET)),
            name=raw.get("name"),
        ))
    return SloSpec(name=str(document.get("name") or name), objectives=tuple(objectives))


def load_slo_spec(path: str) -> SloSpec:
    """A spec from a JSON or YAML file."""
    from gordo_tpu_torch.workflow.yaml_reader import safe_load

    with open(path) as fh:
        text = fh.read()
    try:
        document = json.loads(text)
    except ValueError:
        try:
            document = safe_load(text)
        except ValueError as exc:
            raise SloSpecError(f"Unparseable SLO spec {path}: {exc}")
    return parse_slo_spec(document, name=os.path.splitext(os.path.basename(path))[0])


def _snapshot_signals(snapshot: dict) -> Optional[dict]:
    """A snapshot's signals: its ``signals`` block when the rollup wrote
    one, else computed over its metrics' lifetime."""
    if not isinstance(snapshot, dict):
        return None
    signals = snapshot.get("signals")
    if isinstance(signals, dict):
        return signals
    if isinstance(snapshot.get("metrics"), dict):
        return rollup_mod.compute_signals(snapshot)
    return None


def evaluate(spec: SloSpec, snapshots: Sequence[dict], now: Optional[float] = None
             ) -> SloReport:
    """``spec`` over time-ordered merged snapshots: each gives each
    objective one sample (its signal at that poll). A snapshot older
    than the objective's window, by its ``unix_ms`` against the newest
    one (or ``now``), is left out, and so is one whose signal is None
    (no traffic is no violation)."""
    stamped = [s for s in snapshots if isinstance(s, dict)]
    if now is not None:
        now_ms = now * 1000.0
    else:
        stamps = [s.get("unix_ms") for s in stamped if s.get("unix_ms")]
        now_ms = max(stamps) if stamps else 0.0
    results = []
    for objective in spec.objectives:
        n_samples = n_violating = 0
        last_value: Optional[float] = None
        for snapshot in stamped:
            unix_ms = snapshot.get("unix_ms") or now_ms
            if now_ms and (now_ms - unix_ms) > objective.window_s * 1000.0:
                continue
            signals = _snapshot_signals(snapshot)
            if not signals:
                continue
            value = signals.get(objective.signal)
            if value is None:
                continue
            value = float(value)
            n_samples += 1
            last_value = value
            if value > objective.threshold:
                n_violating += 1
        fraction = (n_violating / n_samples) if n_samples else 0.0
        budget = max(objective.budget, 1e-12)
        results.append(ObjectiveResult(
            objective=objective,
            n_samples=n_samples,
            n_violating=n_violating,
            last_value=last_value,
            violating_fraction=fraction,
            burn_rate=fraction / budget,
            exhausted=bool(n_samples) and fraction >= budget,
        ))
    return SloReport(spec=spec, results=results)


def evaluate_values(spec: SloSpec, signals: Mapping[str, Optional[float]]) -> SloReport:
    """``spec`` against one signal dict (one run's numbers, one
    ``/status``): one sample an objective, so exhausted means above the
    threshold."""
    return evaluate(spec, [{"signals": dict(signals), "unix_ms": 0}], now=0.0)


def render_report(report: SloReport) -> str:
    """The report as ``slo check`` prints it."""
    lines = [f"SLO spec: {report.spec.name} — " + ("OK" if report.ok else "BUDGET EXHAUSTED")]
    for r in report.results:
        last = "n/a" if r.last_value is None else f"{r.last_value:.4g}"
        verdict = "EXHAUSTED" if r.exhausted else "ok"
        lines.append(
            f"  {r.objective.label():<28} <= {r.objective.threshold:<10g} "
            f"last={last:<10} samples={r.n_samples:<5} "
            f"violating={r.violating_fraction:6.1%} "
            f"burn={r.burn_rate:8.2f}x  {verdict}"
        )
    return "\n".join(lines)
