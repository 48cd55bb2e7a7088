"""
Model-layer helpers (the port of ``gordo_tpu.models.utils``), without
pandas: a flat :class:`Frame` for request data and a :class:`BlockFrame`
for the output frame, whose top-level blocks are the JAX package's
two-level column groups (``start``, ``model-input``, ...).
"""

import dataclasses
from datetime import datetime, timedelta
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class Frame:
    """A flat table: (rows, columns) values, column names, row labels."""

    values: np.ndarray
    columns: List[str]
    index: list


class BlockFrame:
    """
    Row-aligned blocks under top-level names, in insertion order; each
    block is (sub-column labels, (rows, labels) array). A single column
    (``start``, ``total-anomaly-scaled``) is a block whose one label is
    its own name, as the JAX server's JSON shows it.
    """

    def __init__(self, index: Sequence):
        self.index = list(index)
        self.blocks: Dict[str, Tuple[List[str], np.ndarray]] = {}

    def __len__(self) -> int:
        return len(self.index)

    def __getitem__(self, top: str) -> np.ndarray:
        return self.blocks[top][1]

    def labels(self, top: str) -> List[str]:
        return self.blocks[top][0]

    def add(self, top: str, labels: Iterable[str], values: np.ndarray) -> None:
        labels = list(labels)
        values = np.asarray(values)
        if values.ndim == 1:
            values = values[:, None]
        if values.shape != (len(self.index), len(labels)):
            raise ValueError(
                f"block {top!r} has shape {values.shape}, expected "
                f"({len(self.index)}, {len(labels)})"
            )
        self.blocks[top] = (labels, values)

    def add_column(self, top: str, values: np.ndarray) -> None:
        self.add(top, [top], values)


def make_base_dataframe(
    tags: Sequence[str],
    model_input: np.ndarray,
    model_output: np.ndarray,
    target_tag_list: Optional[Sequence[str]] = None,
    index: Optional[Sequence] = None,
    frequency: Optional[timedelta] = None,
) -> BlockFrame:
    """
    The canonical output frame with top-level blocks ``start``/``end``/
    ``model-input``/``model-output``, input and index aligned to the
    (possibly shorter, offset) model output.
    """
    out = np.asarray(getattr(model_output, "values", model_output))
    n_rows = len(out)
    inp = np.asarray(getattr(model_input, "values", model_input))[-n_rows:, :]
    idx = list(index)[-n_rows:] if index is not None else list(range(n_rows))

    # start/end timestamp columns: ISO strings on a datetime index, else None
    starts = np.full(n_rows, None, dtype=object)
    ends = np.full(n_rows, None, dtype=object)
    if n_rows and all(isinstance(stamp, datetime) for stamp in idx):
        starts[:] = [stamp.isoformat() for stamp in idx]
        if frequency is not None:
            ends[:] = [(stamp + frequency).isoformat() for stamp in idx]

    frame = BlockFrame(idx)
    frame.add_column("start", starts)
    frame.add_column("end", ends)
    owners = target_tag_list if target_tag_list is not None else tags
    for top_level, values, names in (
        ("model-input", inp, tags),
        ("model-output", out, owners),
    ):
        frame.add(top_level, _second_level_labels(names, values.shape[1]), values)
    return frame


def _second_level_labels(tags: Sequence[str], width: int) -> List[str]:
    """Tag names when the block width matches the tag list, else ordinals."""
    if width == len(tags):
        return [str(tag) for tag in tags]
    return [str(i) for i in range(width)]
