"""
The client's frames: a machine's data as the JSON a server reads, a
reply's ``data`` read back into a :class:`BlockFrame`, and the chunks of
one machine joined in row order. The JAX client does these with pandas
(``server_utils.dataframe_to_dict``, ``dataframe_from_dict``,
``pd.concat(...).sort_index()``), which the card's machine lacks.
"""

from datetime import datetime
from typing import Any, Dict, List, Sequence

import numpy as np

from gordo_tpu_torch.models.utils import BlockFrame, Frame


def _key(label) -> Any:
    return label.isoformat() if isinstance(label, datetime) else label


def frame_to_dict(frame: Frame, rows: slice = slice(None)) -> Dict[str, Dict[Any, Any]]:
    """``{column: {row label: value}}`` of ``frame``'s ``rows``, the JSON
    ``DataFrame.to_dict()`` writes: ISO-8601 row labels on a datetime
    index, NaN as NaN."""
    keys = [_key(label) for label in frame.index[rows]]
    values = frame.values[rows]
    return {
        column: dict(zip(keys, values[:, j].tolist()))
        for j, column in enumerate(frame.columns)
    }


def _parse_labels(keys: List[Any]) -> list:
    """Row labels as datetimes when all parse as ISO-8601, else ints."""
    try:
        return [datetime.fromisoformat(str(key)) for key in keys]
    except ValueError:
        return [int(key) for key in keys]


def frame_from_reply(data: Dict[str, Any]) -> BlockFrame:
    """A reply's ``{top: {sub: {row label: value}}}`` (the server's
    ``dataframe_to_dict``) as a :class:`BlockFrame` in row order: the
    blocks in the reply's order, a row missing from a column NaN (None
    in a column of strings), as pandas joins the top-level frames."""
    keys: List[Any] = []
    seen = set()
    for block in data.values():
        for column in block.values():
            for key in column:
                if key not in seen:
                    seen.add(key)
                    keys.append(key)
    index = _parse_labels(keys)
    order = sorted(range(len(index)), key=index.__getitem__)
    position = {keys[i]: row for row, i in enumerate(order)}
    frame = BlockFrame([index[i] for i in order])
    for top, block in data.items():
        labels = list(block)
        cells = [value for column in block.values() for value in column.values()]
        numeric = all(value is None or isinstance(value, (int, float)) for value in cells)
        values = (np.full((len(keys), len(labels)), np.nan) if numeric
                  else np.full((len(keys), len(labels)), None, dtype=object))
        for j, column in enumerate(block.values()):
            for key, value in column.items():
                values[position[key], j] = np.nan if numeric and value is None else value
        frame.add(top, labels, values)
    return frame


def concat_frames(frames: Sequence[BlockFrame]) -> BlockFrame:
    """Chunks of one machine as one frame in row order (a stable sort of
    the joined rows; their blocks and labels are the first chunk's)."""
    if not frames:
        return BlockFrame([])
    index = [label for frame in frames for label in frame.index]
    order = sorted(range(len(index)), key=index.__getitem__)
    joined = BlockFrame([index[i] for i in order])
    for top, (labels, _) in frames[0].blocks.items():
        values = np.concatenate([frame[top] for frame in frames])
        joined.add(top, labels, values[order])
    return joined
