"""
Device-resident sliding windows (the port of
``gordo_tpu.streaming.window``), the data plane of streaming sessions.

A one-shot windowed request sends a machine's whole lookback window on
every call; a monitoring stream would send the same tail again on every
update. Here each streamed machine keeps its window context, the last
``lookback + lookahead - 1`` rows (exactly the rows the next update's
windows reach back into), as a float32 tensor on the scorer's device
between updates, so a k-row update copies k rows to the device and
nothing else.

:class:`WindowUpdate` is what a stream hands the fleet scorer
(``FleetScorer._predict_entries`` takes it where a one-shot request has
a host array): its :meth:`~WindowUpdate.materialize` is the update's
one host-to-device copy, the k new rows, concatenated on the device to
the resident context. :meth:`~WindowUpdate.prefetch` issues that copy
early (pinned memory, a side stream and an event, through
``parallel/transfer.py``), before the update waits in the batcher. Every
copy of stream rows is counted in ``transfer.transfer_counts`` and
``transfer.transfer_rows`` under the ``stream`` plane.
"""

from typing import Optional, Tuple

import numpy as np
import torch

from gordo_tpu_torch.device import DeviceLike, resolve_device
from gordo_tpu_torch.parallel import transfer

__all__ = ["WindowUpdate", "MachineWindow", "SequenceGap"]


class SequenceGap(ValueError):
    """An update's ``seq`` skips rows the window never saw: they can never
    be scored, so the client must resume (replay its window tail)."""

    def __init__(self, machine: str, expected: int, got: int):
        super().__init__(
            f"Machine {machine!r}: update starts at row {got} but the "
            f"window has only consumed {expected} rows — sequence gap; "
            "resume with a window-tail replay"
        )
        self.machine = machine
        self.expected = expected
        self.got = got


def _stage_rows(rows: np.ndarray, device: torch.device, mode: str) -> transfer.Staged:
    """Issue the copy of a stream's host rows to ``device``, counted."""
    transfer.count_transfer("stream", mode, rows=len(rows))
    return transfer.stage(rows, device)


class WindowUpdate:
    """One machine's part of one streamed dispatch: the resident context
    (a device tensor or None) and the update's new rows (host float32,
    prefix transformers applied)."""

    __slots__ = ("context", "new_rows", "device", "_staged", "_device")

    def __init__(self, context: Optional[torch.Tensor], new_rows: np.ndarray,
                 device: DeviceLike = None):
        self.context = context
        self.new_rows = np.ascontiguousarray(new_rows, dtype=np.float32)
        self.device = resolve_device(device)
        self._staged: Optional[transfer.Staged] = None
        self._device: Optional[torch.Tensor] = None

    @property
    def width(self) -> int:
        return int(self.new_rows.shape[-1])

    @property
    def n_new(self) -> int:
        return int(len(self.new_rows))

    @property
    def n_context(self) -> int:
        return 0 if self.context is None else int(self.context.shape[0])

    def __len__(self) -> int:
        return self.n_context + self.n_new

    def prefetch(self) -> "WindowUpdate":
        """Issue the new rows' copy now rather than at dispatch."""
        if self._staged is None and self._device is None:
            self._staged = _stage_rows(self.new_rows, self.device, "prefetched")
        return self

    def materialize(self) -> torch.Tensor:
        """Context and new rows as one device tensor. The new rows are the
        only host-to-device copy; the concatenation runs on the device.
        Cached, so a batcher that scores a failed batch's requests again
        one by one reuses it (the same bits, no second copy)."""
        if self._device is None:
            staged = self._staged or _stage_rows(self.new_rows, self.device, "direct")
            new = staged.wait()
            self._staged = None
            self._device = new if self.context is None else torch.cat([self.context, new])
        return self._device


class MachineWindow:
    """One streamed machine's window across updates: ``seq`` counts the
    rows consumed since the stream began (the client's replay cursor),
    ``context`` holds the last ``lookback + lookahead - 1`` of them on the
    device. The owning session serializes its updates."""

    def __init__(self, lookback: int, lookahead: int, n_features: int,
                 device: DeviceLike = None):
        self.lookback = max(1, int(lookback))
        self.lookahead = max(0, int(lookahead))
        self.n_features = int(n_features)
        self.device = resolve_device(device)
        #: rows the next update's windows reach back into
        self.context_rows = self.lookback + self.lookahead - 1
        self.context: Optional[torch.Tensor] = None
        self.seq = 0
        self.n_scored = 0

    def begin(self, name: str, rows: np.ndarray,
              seq: int) -> Tuple[Optional[WindowUpdate], np.ndarray]:
        """(update, fresh rows) of one update at cursor ``seq``: rows this
        window consumed already (a retry after a lost reply) are trimmed,
        so an update is idempotent; the update is None when no row is new
        or the window cannot fill one window yet (warming: the rows are
        committed without a dispatch). :class:`SequenceGap` when ``seq``
        skips ahead."""
        rows = np.asarray(rows, dtype=np.float32)
        seq = int(seq)
        if seq > self.seq:
            raise SequenceGap(name, expected=self.seq, got=seq)
        already = self.seq - seq
        fresh = rows[already:] if already else rows
        if not len(fresh):
            return None, fresh
        update = WindowUpdate(self.context, fresh, self.device)
        if self.n_outputs(update) <= 0:
            return None, fresh
        return update, fresh

    def n_outputs(self, update: WindowUpdate) -> int:
        """Output rows of the update's dispatch: its new scorable rows only
        (the context is one row short of a window, so never re-scored)."""
        return len(update) - self.lookback + 1 - self.lookahead

    def commit(self, update: Optional[WindowUpdate], fresh: np.ndarray) -> None:
        """Advance the cursor and roll the resident context forward; only
        after a successful dispatch (or for an update that dispatched
        nothing), so a failed dispatch leaves the window as it was and the
        client's retry of the same ``seq`` is exact."""
        if not len(fresh):
            return
        if self.context_rows <= 0:
            self.context = None
        elif update is not None:
            self.context = update.materialize()[-self.context_rows:]
        else:
            # warming: the rows reach the device once, as the next context
            new = _stage_rows(np.ascontiguousarray(fresh, dtype=np.float32), self.device,
                              "direct").wait()
            merged = new if self.context is None else torch.cat([self.context, new])
            self.context = merged[-self.context_rows:]
        self.seq += len(fresh)

    def resume(self, rows: np.ndarray, seq: int) -> None:
        """Rebuild the context from a client's replayed window tail
        (prefix transformers applied): ``rows`` end the stream so far and
        ``seq`` is the first one's index. Replayed rows are context only:
        they were scored before, so they are never scored again."""
        rows = np.asarray(rows, dtype=np.float32)
        if self.context_rows > 0 and len(rows):
            tail = np.ascontiguousarray(rows[-self.context_rows:])
            self.context = _stage_rows(tail, self.device, "direct").wait()
        else:
            self.context = None
        self.seq = int(seq) + len(rows)

    def stats(self) -> dict:
        return {
            "seq": self.seq,
            "n_scored": self.n_scored,
            "resident_rows": 0 if self.context is None else int(self.context.shape[0]),
        }
