"""
The cost model of a fleet (the port of ``gordo_tpu.tuning.model``): each
tunable knob fitted against the corpus into a :class:`Recommendation`
with the evidence behind it.

- **Measured**: where a knob's first signal was measured at two or more
  arms, the arms are averaged and the best measured arm wins; a value
  between arms (the default, often) is predicted piecewise-linearly, and
  never past the measured range.
- **Analytic fallback**: with 0-1 arms, ``epoch_chunk`` models its
  per-epoch cost as ``steady + d/K`` from one arm's measured dispatch
  overhead ``d`` and recommends the knee of that curve (``source:
  analytic``).
- Otherwise no recommendation: the default stands.

A knob the port lacks (``Knob.unported``) is never recommended. For the
knobs it has, the recommendations are the JAX model's on the same
corpus. Standard library only.
"""

import dataclasses
import logging
import typing

from gordo_tpu_torch.tuning.corpus import Corpus, Observation
from gordo_tpu_torch.tuning.knobs import KNOBS, Knob

logger = logging.getLogger(__name__)

#: an analytic fallback stops raising the knob once the modeled
#: overhead it removes drops below this fraction of steady-state cost
DIMINISHING_RETURNS = 0.02


@dataclasses.dataclass(frozen=True)
class ArmEvidence:
    """One measured arm of a knob sweep, aggregated."""

    value: typing.Any
    mean: float
    n: int
    sources: typing.Tuple[str, ...]

    def to_dict(self) -> dict:
        return {
            "value": self.value,
            "mean": self.mean,
            "n": self.n,
            "sources": list(self.sources),
        }


@dataclasses.dataclass(frozen=True)
class Recommendation:
    knob: str
    value: typing.Any
    default: typing.Any
    source: str  # "measured" | "analytic"
    signal: str
    objective: str
    predicted: typing.Optional[float]
    predicted_default: typing.Optional[float]
    evidence: typing.Tuple[ArmEvidence, ...]

    @property
    def improvement(self) -> typing.Optional[float]:
        """Relative predicted improvement over the default (positive =
        better), None where the default's value cannot be predicted."""
        if self.predicted is None or self.predicted_default is None:
            return None
        if self.predicted_default == 0:
            return None
        delta = self.predicted_default - self.predicted
        if self.objective == "max":
            delta = -delta
        return delta / abs(self.predicted_default)

    def to_dict(self) -> dict:
        return {
            "value": self.value,
            "default": self.default,
            "source": self.source,
            "signal": self.signal,
            "objective": self.objective,
            "predicted": self.predicted,
            "predicted_default": self.predicted_default,
            "improvement": self.improvement,
            "evidence": [arm.to_dict() for arm in self.evidence],
        }


# --------------------------------------------------------------------------
# measured path
# --------------------------------------------------------------------------


def _arms(
    observations: typing.Sequence[Observation], metric: str
) -> typing.List[ArmEvidence]:
    grouped: typing.Dict[typing.Any, typing.List[Observation]] = {}
    for obs in observations:
        if obs.metric == metric:
            grouped.setdefault(obs.value, []).append(obs)
    out = []
    for value, group in grouped.items():
        out.append(
            ArmEvidence(
                value=value,
                mean=sum(o.metric_value for o in group) / len(group),
                n=len(group),
                sources=tuple(sorted({o.source for o in group})),
            )
        )
    # numeric arms sort by value for readable evidence + interpolation;
    # categorical arms (bucket_policy) sort by spelling
    return sorted(
        out,
        key=lambda arm: (
            (0, float(arm.value))
            if isinstance(arm.value, (int, float))
            and not isinstance(arm.value, bool)
            else (1, str(arm.value))
        ),
    )


def _interpolate(
    arms: typing.Sequence[ArmEvidence], at: typing.Any
) -> typing.Optional[float]:
    """Piecewise-linear prediction at ``at`` from numeric arms; clamps
    outside the measured range; exact arm (numeric or categorical)
    returns its mean."""
    for arm in arms:
        if arm.value == at:
            return arm.mean
    numeric = [
        a
        for a in arms
        if isinstance(a.value, (int, float)) and not isinstance(a.value, bool)
    ]
    if not isinstance(at, (int, float)) or isinstance(at, bool) or len(
        numeric
    ) < 2:
        return None
    at = float(at)
    if at <= float(numeric[0].value):
        return numeric[0].mean
    if at >= float(numeric[-1].value):
        return numeric[-1].mean
    for lo, hi in zip(numeric, numeric[1:]):
        x0, x1 = float(lo.value), float(hi.value)
        if x0 <= at <= x1:
            frac = (at - x0) / (x1 - x0) if x1 > x0 else 0.0
            return lo.mean + frac * (hi.mean - lo.mean)
    return None  # pragma: no cover - ranges above are exhaustive


def _fit_measured(
    knob: Knob, observations: typing.Sequence[Observation]
) -> typing.Optional[Recommendation]:
    for signal in knob.signals:
        arms = _arms(observations, signal.metric)
        in_domain = [a for a in arms if knob.domain.contains(a.value)]
        if len(in_domain) < 2:
            continue
        best = in_domain[0]
        for arm in in_domain[1:]:
            if signal.better(arm.mean, best.mean):
                best = arm
        return Recommendation(
            knob=knob.name,
            value=best.value,
            default=knob.default,
            source="measured",
            signal=signal.metric,
            objective=signal.objective,
            predicted=best.mean,
            predicted_default=_interpolate(in_domain, knob.default),
            evidence=tuple(arms),
        )
    return None


# --------------------------------------------------------------------------
# analytic fallbacks (thin corpus)
# --------------------------------------------------------------------------


def _epoch_chunk_analytic(
    knob: Knob, observations: typing.Sequence[Observation]
) -> typing.Optional[Recommendation]:
    """Monotonic fallback for ``epoch_chunk`` from ONE measured arm:
    per-epoch cost ``T(K) = steady + d/K`` where ``d`` is the measured
    per-dispatch host overhead — strictly improving in K with
    diminishing returns, so recommend the smallest power-of-two K whose
    remaining overhead share drops below :data:`DIMINISHING_RETURNS`."""
    for obs in observations:
        if obs.metric != "dispatch_overhead_s":
            continue
        steady = obs.context.get("steady_state_epoch_s")
        n_dispatches = obs.context.get("n_dispatches")
        if not steady or not n_dispatches or steady <= 0:
            continue
        # dispatch_overhead_s is the fit's TOTAL host-side dispatch
        # overhead, so d is the per-dispatch cost regardless of which
        # chunk size the arm ran at; at chunk K each dispatch covers K
        # epochs, so per-epoch overhead is d/K
        d = obs.metric_value / n_dispatches
        if d <= 0:
            return None
        k = 1
        while (
            d / k > DIMINISHING_RETURNS * steady
            and knob.domain.contains(k * 2)
            and k < 64
        ):
            k *= 2
        predicted = steady + d / k
        return Recommendation(
            knob=knob.name,
            value=k,
            default=knob.default,
            source="analytic",
            signal="steady_state_epoch_s",
            objective="min",
            predicted=predicted,
            predicted_default=steady + d / max(int(knob.default), 1),
            evidence=(
                ArmEvidence(
                    value=obs.value,
                    mean=obs.metric_value,
                    n=1,
                    sources=(obs.source,),
                ),
            ),
        )
    return None


_ANALYTIC_FALLBACKS: typing.Dict[
    str,
    typing.Callable[
        [Knob, typing.Sequence[Observation]], typing.Optional[Recommendation]
    ],
] = {
    "epoch_chunk": _epoch_chunk_analytic,
}


# --------------------------------------------------------------------------
# entry point
# --------------------------------------------------------------------------


def fit_recommendations(
    corpus: Corpus,
    knobs: typing.Optional[typing.Sequence[Knob]] = None,
) -> typing.Dict[str, Recommendation]:
    """One recommendation per tunable knob the corpus can actually
    judge; knobs with no usable evidence are absent (default stands), and
    so are the knobs the port lacks."""
    out: typing.Dict[str, Recommendation] = {}
    for knob in knobs if knobs is not None else KNOBS:
        if not knob.tunable or knob.unported is not None:
            continue
        observations = corpus.for_knob(knob.name)
        rec = _fit_measured(knob, observations)
        if rec is None:
            fallback = _ANALYTIC_FALLBACKS.get(knob.name)
            if fallback is not None and observations:
                rec = fallback(knob, observations)
        if rec is None:
            continue
        if not knob.domain.contains(rec.value):
            logger.warning(
                "Dropping %s recommendation %r: outside domain (%s)",
                knob.name,
                rec.value,
                knob.domain.describe(),
            )
            continue
        out[knob.name] = rec
    return out
