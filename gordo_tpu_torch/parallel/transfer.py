"""
Pipelined host-to-device transfer (the port of
``gordo_tpu.parallel.transfer``) for the fleet builder's stacked data,
the fleet trainer's per-chunk vectors and the rows of streamed updates
(``streaming/window.py``).

A transfer overlaps compute only if it is issued before the compute that
hides it. :func:`prefetch_iter` walks a sequence of host arrays keeping
up to ``depth`` transfers in flight ahead of the consumer, and
:func:`device_put_sliced` moves one large array as ``depth + 1`` slices
so the later ones stream while the first is already on the device.
``depth=0`` is exactly the single ``torch.from_numpy(a).to(device)``
the callers did before; slicing and concatenating move bytes, not
math, so every depth gives the same values.

On the card a staged put (:func:`stage`) copies the array into pinned
host memory (a copy from pageable memory would not be asynchronous) and
from there to the device with ``non_blocking=True`` on a side
``torch.cuda.Stream``, recording an event after the copy. The consumer
(:meth:`Staged.wait`) makes its own stream wait on that event before it
touches the tensor, and ``record_stream`` tells the caching allocator
that the consumer's stream uses the memory the side stream allocated.
On the CPU a put is the plain ``.to(device)``.

Transfers are counted by (plane, mode) in :data:`transfer_counts`
(``prefetched`` = issued ahead of the consuming work, ``direct`` = on the
critical path), and a stream's copied rows in :data:`transfer_rows`: the
counter the JAX package keeps in its metrics
registry; the port has no registry yet (ROADMAP.md queue 1 item 9), so
the fleet builder's telemetry report reads this one. The knob is
``--prefetch-depth`` / ``GORDO_PREFETCH_DEPTH``, at most
:data:`MAX_PREFETCH_DEPTH`.
"""

import collections
import os
from typing import Callable, Deque, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from gordo_tpu_torch.device import DeviceLike, resolve_device

#: the most transfers kept in flight: past a handful the queue only adds
#: memory pressure, never overlap
MAX_PREFETCH_DEPTH = 8

#: host-to-device transfers since the last reset, by (plane, mode)
transfer_counts: Dict[Tuple[str, str], int] = {}
#: rows those transfers carried, where the caller counts them (streams)
transfer_rows: Dict[Tuple[str, str], int] = {}

_side_streams: Dict[torch.device, "torch.cuda.Stream"] = {}


def env_prefetch_depth(default: int = 0) -> int:
    """``GORDO_PREFETCH_DEPTH``, clipped to [0, MAX_PREFETCH_DEPTH];
    ``default`` when it is unset or not an integer."""
    raw = os.environ.get("GORDO_PREFETCH_DEPTH")
    if raw is None or not str(raw).strip():
        return int(default)
    try:
        depth = int(str(raw).strip())
    except ValueError:
        return int(default)
    return clip_depth(depth)


def clip_depth(depth) -> int:
    return max(0, min(MAX_PREFETCH_DEPTH, int(depth)))


def count_transfer(plane: str, mode: str, n: int = 1, rows: int = 0) -> None:
    """Count ``n`` transfers of ``plane`` (build/train/stream) issued in
    ``mode`` (prefetched/direct), carrying ``rows`` rows; the overlap
    ratio prefetched / total judges the ``prefetch_depth`` knob."""
    if n > 0:
        transfer_counts[(plane, mode)] = transfer_counts.get((plane, mode), 0) + n
    if rows > 0:
        transfer_rows[(plane, mode)] = transfer_rows.get((plane, mode), 0) + rows


def reset_transfer_counts() -> None:
    transfer_counts.clear()
    transfer_rows.clear()


class Staged:
    """A transfer in flight: :meth:`wait` hands the tensor to the current
    stream once its copy has been ordered before the stream's next work."""

    def __init__(self, tensor: torch.Tensor, event=None):
        self._tensor = tensor
        self._event = event

    def wait(self) -> torch.Tensor:
        if self._event is not None:
            stream = torch.cuda.current_stream(self._tensor.device)
            stream.wait_event(self._event)
            self._tensor.record_stream(stream)
            self._event = None
        return self._tensor


def _side_stream(device: torch.device) -> "torch.cuda.Stream":
    if device not in _side_streams:
        _side_streams[device] = torch.cuda.Stream(device=device)
    return _side_streams[device]


def stage(array, device: DeviceLike = None) -> Staged:
    """Issue the copy of a host array to ``device`` (the card unless
    ``"cpu"``) and return at once; the copy runs on a side stream from
    pinned memory (module docstring)."""
    device = resolve_device(device)
    host = torch.from_numpy(np.ascontiguousarray(array))
    if device.type != "cuda":
        return Staged(host.to(device))
    host = host.pin_memory()
    stream = _side_stream(device)
    with torch.cuda.stream(stream):
        tensor = host.to(device, non_blocking=True)
        event = torch.cuda.Event()
        event.record(stream)
    return Staged(tensor, event)


def prefetch_iter(
    items: Iterable,
    depth: int = 1,
    plane: str = "train",
    put: Optional[Callable] = None,
    device: DeviceLike = None,
):
    """
    Yield ``put(item)`` for each item, keeping up to ``depth`` results in
    flight ahead of the consumer: transfer k+1 is issued before the
    consumer is done with k. ``depth=0`` is a plain map, every transfer
    on the critical path. ``put`` defaults to :func:`stage` onto
    ``device``, whose results are waited for as they are yielded.
    """
    depth = clip_depth(depth)
    if put is None:
        def put(item):
            return stage(item, device)

    def ready(value):
        return value.wait() if isinstance(value, Staged) else value

    if depth == 0:
        for item in items:
            count_transfer(plane, "direct")
            yield ready(put(item))
        return
    pending: Deque = collections.deque()
    it = iter(items)
    try:
        while len(pending) <= depth:
            pending.append(put(next(it)))
            count_transfer(plane, "prefetched")
    except StopIteration:
        it = None
    while pending:
        out = pending.popleft()
        if it is not None:
            try:
                pending.append(put(next(it)))
                count_transfer(plane, "prefetched")
            except StopIteration:
                it = None
        yield ready(out)


def device_put_sliced(array, depth: int, plane: str = "build",
                      device: DeviceLike = None) -> torch.Tensor:
    """
    One host array on ``device`` as ``depth + 1`` pipelined slices along
    axis 0, concatenated on the device; ``depth=0`` (or an array too
    short to slice) is exactly ``torch.from_numpy(array).to(device)``.
    """
    depth = clip_depth(depth)
    array = np.asarray(array)
    if depth == 0 or array.ndim < 1 or len(array) <= depth:
        count_transfer(plane, "direct")
        return torch.from_numpy(array).to(resolve_device(device))
    staged = [stage(part, device) for part in np.array_split(array, depth + 1, axis=0)]
    count_transfer(plane, "prefetched", n=len(staged))
    return torch.cat([part.wait() for part in staged], dim=0)
