"""
Drift detection over served anomaly statistics (the port of
``gordo_tpu.lifecycle.drift``).

An anomaly frame measures what drift looks like: its
``total-anomaly-scaled`` column against the detector's calibrated
``aggregate_threshold_``. :class:`DriftMonitor` takes those per machine
and keeps two EWMAs across ticks, of the mean anomaly/threshold ratio and
of the fraction of timesteps over the threshold, so that one noisy window
does not trigger a refit and a sustained shift does.

The state persists as one JSON file beside the revision directories (a
dot path, never taken for a revision), so ``lifecycle tick`` can run as
independent scheduled invocations. Each machine's state is bound to the
revision that produced its observations: an observation from another
revision resets that machine's state instead of polluting it.
"""

import dataclasses
import json
import logging
import os
from datetime import datetime, timezone
from typing import Dict, List, Optional, Union

import numpy as np

from gordo_tpu_torch.models.utils import BlockFrame, Frame
from gordo_tpu_torch.observability import emit_event
from gordo_tpu_torch.utils import atomic

logger = logging.getLogger(__name__)

STATE_VERSION = 1


def total_anomaly_series(frame: Union[BlockFrame, Frame], flavor: str = "scaled") -> np.ndarray:
    """
    The ``total-anomaly-<flavor>`` column of an anomaly frame as a flat
    float64 array: from a :class:`BlockFrame` (what
    ``DiffBasedAnomalyDetector.anomaly`` returns) or a flat :class:`Frame`
    (a server reply parsed by ``server.utils.dataframe_from_dict``).
    """
    column = f"total-anomaly-{flavor}"
    if isinstance(frame, BlockFrame):
        if column not in frame.blocks:
            raise KeyError(
                f"Anomaly frame has no {column!r} column (columns: {list(frame.blocks)[:8]}...)"
            )
        return np.asarray(frame[column], dtype=np.float64)[:, 0]
    if column not in frame.columns:
        raise KeyError(
            f"Anomaly frame has no {column!r} column (columns: {list(frame.columns)[:8]}...)"
        )
    return np.asarray(frame.values, dtype=np.float64)[:, list(frame.columns).index(column)]


@dataclasses.dataclass
class MachineDriftState:
    """One machine's accumulated drift statistics."""

    revision: str = ""
    n_observations: int = 0
    ewma_ratio: float = 0.0
    ewma_exceedance: float = 0.0
    drifted: bool = False
    last_observed: str = ""

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class DriftAssessment:
    """What one observation did to a machine's drift state."""

    machine: str
    ratio: float
    exceedance: float
    ewma_ratio: float
    ewma_exceedance: float
    drifted: bool
    n_observations: int

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class DriftMonitor:
    """
    Parameters
    ----------
    state_path
        JSON file of the per-machine state across ticks; None keeps it in
        memory only.
    ewma_alpha
        Weight of the newest observation in both EWMAs (1.0: no memory).
    ratio_threshold
        Drift when the EWMA of mean(total anomaly / threshold) exceeds
        this (1.0: the average timestep now looks abnormal).
    exceedance_threshold
        Drift when the EWMA of the fraction of timesteps over the
        threshold exceeds this.
    min_observations
        Observations before a machine may be declared drifted.
    """

    def __init__(
        self,
        state_path: Optional[Union[str, os.PathLike]] = None,
        ewma_alpha: float = 0.3,
        ratio_threshold: float = 1.0,
        exceedance_threshold: float = 0.5,
        min_observations: int = 1,
    ):
        if not 0.0 < float(ewma_alpha) <= 1.0:
            raise ValueError(f"ewma_alpha must be in (0, 1], got {ewma_alpha}")
        self.state_path = str(state_path) if state_path is not None else None
        self.ewma_alpha = float(ewma_alpha)
        self.ratio_threshold = float(ratio_threshold)
        self.exceedance_threshold = float(exceedance_threshold)
        self.min_observations = max(1, int(min_observations))
        self._state: Dict[str, MachineDriftState] = {}
        if self.state_path is not None:
            self.load()

    # -- observations --------------------------------------------------------
    def observe(
        self,
        machine: str,
        anomaly_frame: Union[BlockFrame, Frame],
        threshold: Optional[float],
        revision: str = "",
    ) -> DriftAssessment:
        """Feed one anomaly frame and the detector's aggregate threshold;
        raises ``ValueError`` for an unusable threshold."""
        if threshold is None or not np.isfinite(threshold) or threshold <= 0:
            raise ValueError(
                f"Machine {machine!r} has no usable aggregate threshold ({threshold!r}); "
                "cannot assess drift"
            )
        total = total_anomaly_series(anomaly_frame)
        total = total[~np.isnan(total)]
        return self.observe_ratio(machine, total / float(threshold), revision)

    def observe_ratio(self, machine: str, ratio_series, revision: str = "") -> DriftAssessment:
        """The update from a per-timestep anomaly/threshold ratio series
        (above 1: that timestep looks abnormal)."""
        ratios = np.asarray(ratio_series, dtype=float)
        ratios = ratios[np.isfinite(ratios)]
        if ratios.size == 0:
            raise ValueError(f"Machine {machine!r}: no finite anomaly ratios to observe")
        return self.observe_stats(
            machine,
            ratio=float(ratios.mean()),
            exceedance=float((ratios > 1.0).mean()),
            revision=revision,
        )

    def observe_stats(
        self, machine: str, ratio: float, exceedance: float, revision: str = ""
    ) -> DriftAssessment:
        """The state update from one observation's statistics (mean
        ratio, exceedance fraction): how the ``stream_observation`` feed,
        aggregated per machine by a tick, reaches the monitor."""
        ratio = float(ratio)
        exceedance = float(exceedance)
        if not (np.isfinite(ratio) and np.isfinite(exceedance)):
            raise ValueError(
                f"Machine {machine!r}: non-finite drift statistics "
                f"(ratio={ratio}, exceedance={exceedance})"
            )
        state = self._state.get(machine)
        if state is None:
            state = self._state[machine] = MachineDriftState()
        if revision and state.revision and state.revision != revision:
            # another revision's statistics are not comparable: a fresh
            # baseline
            logger.info("Drift state for %s reset: revision %s -> %s",
                        machine, state.revision, revision)
            state = self._state[machine] = MachineDriftState()
        if revision:
            state.revision = revision

        alpha = self.ewma_alpha
        if state.n_observations == 0:
            state.ewma_ratio = ratio
            state.ewma_exceedance = exceedance
        else:
            state.ewma_ratio = alpha * ratio + (1 - alpha) * state.ewma_ratio
            state.ewma_exceedance = alpha * exceedance + (1 - alpha) * state.ewma_exceedance
        state.n_observations += 1
        state.last_observed = datetime.now(timezone.utc).isoformat()

        was_drifted = state.drifted
        state.drifted = state.n_observations >= self.min_observations and (
            state.ewma_ratio > self.ratio_threshold
            or state.ewma_exceedance > self.exceedance_threshold
        )
        if state.drifted and not was_drifted:
            emit_event(
                "machine_drifted",
                machine=machine,
                revision=state.revision or None,
                ewma_ratio=round(state.ewma_ratio, 6),
                ewma_exceedance=round(state.ewma_exceedance, 6),
                n_observations=state.n_observations,
            )
        return DriftAssessment(
            machine=machine,
            ratio=ratio,
            exceedance=exceedance,
            ewma_ratio=state.ewma_ratio,
            ewma_exceedance=state.ewma_exceedance,
            drifted=state.drifted,
            n_observations=state.n_observations,
        )

    # -- queries -------------------------------------------------------------
    def drifted(self) -> List[str]:
        """Machines currently past a drift criterion, sorted."""
        return sorted(m for m, s in self._state.items() if s.drifted)

    def state(self, machine: str) -> Optional[MachineDriftState]:
        return self._state.get(machine)

    def reset(self, machine: Optional[str] = None) -> None:
        """Forget one machine's state, or every machine's with None."""
        if machine is None:
            self._state.clear()
        else:
            self._state.pop(machine, None)

    # -- persistence ---------------------------------------------------------
    def save(self) -> Optional[str]:
        """Write the state to ``state_path`` by rename (None: no-op)."""
        if self.state_path is None:
            return None
        payload = {
            "version": STATE_VERSION,
            "machines": {m: s.to_dict() for m, s in self._state.items()},
        }
        atomic.atomic_write_json(self.state_path, payload, indent=2, sort_keys=True)
        return self.state_path

    def load(self) -> None:
        """Read the state from ``state_path``; a missing or corrupt file
        starts fresh (a lost state file costs one warm-up tick)."""
        self._state = {}
        if self.state_path is None:
            return
        try:
            with open(self.state_path) as fh:
                payload = json.load(fh)
        except FileNotFoundError:
            return
        except (OSError, ValueError):
            logger.warning("Unreadable drift state at %s; starting fresh", self.state_path)
            return
        if not isinstance(payload, dict):
            logger.warning("Unreadable drift state at %s; starting fresh", self.state_path)
            return
        fields = {f.name for f in dataclasses.fields(MachineDriftState)}
        for machine, record in (payload.get("machines") or {}).items():
            if not isinstance(record, dict):
                continue
            try:
                self._state[machine] = MachineDriftState(
                    **{k: v for k, v in record.items() if k in fields})
            except TypeError:
                logger.warning("Skipping malformed drift state for %s", machine)
