"""
Opt-in sampling wall profiler (the port of
``gordo_tpu.observability.sampling``): where the host's microseconds go.

The phase ledger (:mod:`.attribution`) says which phase of a request
burned the time; this module says which Python code inside that phase. A
background daemon thread wakes ``GORDO_PROFILE_HZ`` times a second,
snapshots every other thread's Python stack (``sys._current_frames``: no
interpreter hooks, nothing added to the profiled code's calls), and
folds each stack three ways:

- **folded stacks** (``module:func;module:func`` root first,
  flamegraph.pl's input format);
- **per-module** leaf counts (which import is hot);
- **per-(plane, phase)** counts: a sampled thread is matched against the
  ledger's live phase map, so the counts line up with the
  ``gordo_phase_seconds`` histograms, which the flushed dump embeds
  (``python -m gordo_tpu_torch.cli profile report``).

The dump (``GORDO_PROFILE_OUT``, default ``gordo_profile.json``, written
at process exit) has the JAX package's keys and ``profile_version`` 1, so
either package's ``profile`` command reads either's dump. A CUDA kernel
runs on the card, not in a Python frame: a thread waiting on the card
samples as the frame that waits (the ``device`` phase's sync).

With ``GORDO_PROFILE_HZ`` unset nothing here runs: no thread, no stack
walks, and the ledger's per-phase hook is one module-global read
(:data:`_ACTIVE`), pinned by call count in
``tests/test_torch_sampling.py``.
"""

import atexit
import json
import logging
import os
import sys
import threading
import time
import typing

logger = logging.getLogger(__name__)

PROFILE_HZ_ENV_VAR = "GORDO_PROFILE_HZ"
PROFILE_OUT_ENV_VAR = "GORDO_PROFILE_OUT"

#: schema stamp of the flushed sample-aggregate JSON
PROFILE_VERSION = 1

#: True only while a sampler is running. The phase ledger checks THIS
#: (one module-global read) before touching the phase map, so the
#: disabled path costs nothing — the strict-no-op pin.
_ACTIVE = False

#: thread ident -> (plane, phase) — written by the ledger's phase
#: brackets only while :data:`_ACTIVE`; read by the sampler thread.
#: Plain dict: single-key assignment/deletion is atomic under the GIL,
#: and the sampler tolerates racing reads (a sample landing on a phase
#: boundary attributes to either side, both of which are true).
_PHASES: typing.Dict[int, typing.Tuple[str, str]] = {}

#: the process-wide env-started sampler (maybe_start_from_env)
_SAMPLER: typing.Optional["WallSampler"] = None

#: phase attributed to sampled threads with no ledger bracket open
UNATTRIBUTED = "-/unattributed"


def profiler_active() -> bool:
    """One module-global read: is a sampler running right now?"""
    return _ACTIVE


def set_phase(plane: str, phase: str) -> None:
    """Mark the calling thread as inside ``plane``/``phase`` (ledger
    bracket enter). Only called while :data:`_ACTIVE` — the ledger
    guards, so the disabled path never reaches here."""
    _PHASES[threading.get_ident()] = (plane, phase)


def clear_phase(
    previous: typing.Optional[typing.Tuple[str, str]] = None
) -> None:
    """Ledger bracket exit: restore the enclosing bracket's phase (the
    nested-phase case) or drop the thread from the map."""
    ident = threading.get_ident()
    if previous is not None:
        _PHASES[ident] = previous
    else:
        _PHASES.pop(ident, None)


def current_phase() -> typing.Optional[typing.Tuple[str, str]]:
    """The calling thread's open (plane, phase) bracket, if any."""
    return _PHASES.get(threading.get_ident())


def _fold_stack(frame) -> typing.Tuple[str, str]:
    """(root-first folded stack string, leaf module) for one frame."""
    parts: typing.List[str] = []
    leaf_module = "?"
    while frame is not None:
        module = frame.f_globals.get("__name__", "?")
        parts.append(f"{module}:{frame.f_code.co_name}")
        if leaf_module == "?":
            leaf_module = module
        frame = frame.f_back
    parts.reverse()
    return ";".join(parts), leaf_module


class WallSampler:
    """The background wall-clock stack sampler.

    One daemon thread; each wakeup walks ``sys._current_frames()`` and
    folds every OTHER thread's stack into the aggregates. Aggregates are
    plain dicts guarded by one lock that is only ever held for dict
    arithmetic (never sleeps, never I/O — the blocking-under-lock lint
    discipline), so :meth:`report` can be called live.
    """

    def __init__(self, hz: float, out_path: typing.Optional[str] = None):
        self.hz = max(0.1, float(hz))
        self.out_path = out_path
        self.n_samples = 0
        self.started_at: typing.Optional[float] = None
        self.stopped_at: typing.Optional[float] = None
        self._lock = threading.Lock()
        self._folded: typing.Dict[str, int] = {}
        self._per_module: typing.Dict[str, int] = {}
        self._per_phase: typing.Dict[str, int] = {}
        self._modules_by_phase: typing.Dict[str, typing.Dict[str, int]] = {}
        self._stopping = threading.Event()
        self._thread: typing.Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        global _ACTIVE
        if self._thread is not None:
            return
        self.started_at = time.time()
        self._stopping.clear()
        self._thread = threading.Thread(
            target=self._loop, name="gordo-profile-sampler", daemon=True
        )
        _ACTIVE = True
        self._thread.start()
        logger.info("Wall profiler sampling at %.1f Hz", self.hz)

    def stop(self) -> None:
        """Stop sampling and join the thread. Idempotent."""
        global _ACTIVE
        _ACTIVE = False
        self._stopping.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=5.0)
            self.stopped_at = time.time()
        _PHASES.clear()

    def _loop(self) -> None:
        interval = 1.0 / self.hz
        while not self._stopping.wait(interval):
            try:
                self.sample_once()
            except Exception:  # noqa: BLE001 - the profiler must not crash
                logger.warning("Profiler sample failed", exc_info=True)

    # -- sampling ----------------------------------------------------------

    def sample_once(self) -> None:
        """One sampling pass over every live thread's Python stack."""
        own = threading.get_ident()
        frames = sys._current_frames()
        folded: typing.List[typing.Tuple[str, str, str]] = []
        for ident, frame in frames.items():
            if ident == own:
                continue
            stack, leaf = _fold_stack(frame)
            plane_phase = _PHASES.get(ident)
            phase_key = (
                f"{plane_phase[0]}/{plane_phase[1]}"
                if plane_phase
                else UNATTRIBUTED
            )
            folded.append((stack, leaf, phase_key))
        del frames  # drop frame references promptly
        with self._lock:
            self.n_samples += 1
            for stack, leaf, phase_key in folded:
                self._folded[stack] = self._folded.get(stack, 0) + 1
                self._per_module[leaf] = self._per_module.get(leaf, 0) + 1
                self._per_phase[phase_key] = (
                    self._per_phase.get(phase_key, 0) + 1
                )
                modules = self._modules_by_phase.setdefault(phase_key, {})
                modules[leaf] = modules.get(leaf, 0) + 1

    # -- output ------------------------------------------------------------

    def report(self) -> dict:
        """The sample aggregates plus an embedded snapshot of the ledger
        histograms — one self-contained file for ``profile report``."""
        from gordo_tpu_torch.observability.attribution import phase_totals

        with self._lock:
            folded = dict(self._folded)
            per_module = dict(self._per_module)
            per_phase = dict(self._per_phase)
            modules_by_phase = {
                k: dict(v) for k, v in self._modules_by_phase.items()
            }
            n_samples = self.n_samples
        end = self.stopped_at or time.time()
        return {
            "profile_version": PROFILE_VERSION,
            "hz": self.hz,
            "n_samples": n_samples,
            "duration_s": (
                round(end - self.started_at, 3) if self.started_at else None
            ),
            "per_phase": per_phase,
            "per_module": per_module,
            "modules_by_phase": modules_by_phase,
            "folded": folded,
            "phase_seconds": {
                f"{plane}/{phase}": state
                for (plane, phase), state in phase_totals().items()
            },
        }

    def flush(self, path: typing.Optional[str] = None) -> typing.Optional[str]:
        """Write the report JSON to ``path`` (default: the configured
        out path). Never raises — the profiler must not take down the
        process it observes."""
        path = path or self.out_path
        if not path:
            return None
        try:
            parent = os.path.dirname(os.path.abspath(path))
            os.makedirs(parent, exist_ok=True)
            with open(path, "w") as fh:
                json.dump(self.report(), fh, indent=2, sort_keys=True)
                fh.write("\n")
        except OSError:
            logger.warning("Could not flush profile to %s", path, exc_info=True)
            return None
        return path


def folded_lines(report: typing.Mapping) -> typing.List[str]:
    """flamegraph.pl input lines (``stack count``), hottest first."""
    folded = report.get("folded") or {}
    return [
        f"{stack} {count}"
        for stack, count in sorted(folded.items(), key=lambda kv: -kv[1])
    ]


def maybe_start_from_env() -> typing.Optional[WallSampler]:
    """Start the process-wide sampler iff ``GORDO_PROFILE_HZ`` parses as
    a positive rate (ONE env lookup when unset — the strict no-op).
    Flushes to ``GORDO_PROFILE_OUT`` (default ``gordo_profile.json``)
    at process exit. Idempotent: a second call returns the running
    sampler."""
    global _SAMPLER
    raw = os.environ.get(PROFILE_HZ_ENV_VAR)
    if not raw:
        return None
    if _SAMPLER is not None:
        return _SAMPLER
    try:
        hz = float(raw)
    except ValueError:
        logger.warning("Unparseable %s=%r; profiler off", PROFILE_HZ_ENV_VAR, raw)
        return None
    if hz <= 0:
        return None
    out = os.environ.get(PROFILE_OUT_ENV_VAR) or "gordo_profile.json"
    _SAMPLER = WallSampler(hz, out_path=out)
    _SAMPLER.start()
    atexit.register(_flush_at_exit)
    return _SAMPLER


def _flush_at_exit() -> None:
    sampler = _SAMPLER
    if sampler is not None:
        sampler.stop()
        sampler.flush()


def active_sampler() -> typing.Optional[WallSampler]:
    """The env-started process-wide sampler, if any."""
    return _SAMPLER
