"""
Server request/response helpers (the port of ``gordo_tpu.server.utils``,
JSON only): frame <-> nested-dict bridges with the JAX server's wire
format, input verification, X/y extraction and resolution parsing.
"""

from datetime import datetime, timedelta
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from gordo_tpu_torch.models.utils import BlockFrame, Frame
from gordo_tpu_torch.utils.compat import frequency_to_ns


class ApiError(Exception):
    """An error that maps straight to a JSON error response."""

    def __init__(self, payload: dict, status: int = 400):
        super().__init__(str(payload))
        self.payload = payload
        self.status = status


def _index_key(label):
    return label.isoformat() if isinstance(label, datetime) else label


def dataframe_to_dict(frame: BlockFrame) -> Dict[str, Any]:
    """
    ``{top: {sub: {row label: value}}}``, row labels ISO-8601 strings on
    a datetime index: the JSON the JAX server writes for its two-level
    column frames.
    """
    keys = [_index_key(label) for label in frame.index]
    return {
        top: {
            label: dict(zip(keys, values[:, j].tolist()))
            for j, label in enumerate(labels)
        }
        for top, (labels, values) in frame.blocks.items()
    }


def _parse_index(keys: List[Any]) -> list:
    """Row labels back to datetimes when all parse as ISO-8601, else ints."""
    try:
        return [datetime.fromisoformat(str(key)) for key in keys]
    except ValueError:
        pass
    try:
        return [int(key) for key in keys]
    except ValueError:
        raise ApiError(
            {"message": "Row labels must be ISO-8601 timestamps or integers"}
        ) from None


def dataframe_from_dict(data: Any) -> Frame:
    """
    A posted frame -> :class:`Frame`, rows sorted by label. Accepts
    ``{column: {row label: value}}``, ``{column: [values]}`` and a list of
    rows; a two-level ``{top: {sub: {row: value}}}`` frame raises the JAX
    server's 400.
    """
    if isinstance(data, list):
        values = np.asarray(data, dtype=np.float64)
        if values.ndim == 1:
            values = values[:, None]
        return Frame(values, list(range(values.shape[1])), list(range(len(values))))
    if not isinstance(data, dict):
        raise ApiError({"message": f"Cannot read a frame from {type(data).__name__}"})
    columns = list(data)
    nested = [
        (top, sub)
        for top, col in data.items()
        if isinstance(col, dict)
        for sub, inner in col.items()
        if isinstance(inner, dict)
    ]
    if nested:
        raise ApiError(
            {
                "message": "Server does not support multi-level dataframes "
                f"at this time: {nested}"
            }
        )
    if all(isinstance(col, list) for col in data.values()):
        values = np.asarray([data[c] for c in columns], dtype=np.float64).T
        return Frame(values.reshape(-1, len(columns)), columns, list(range(len(values))))
    keys: List[Any] = []
    seen = set()
    for col in data.values():
        for key in col:
            if key not in seen:
                seen.add(key)
                keys.append(key)
    values = np.full((len(keys), len(columns)), np.nan)
    row_of = {key: i for i, key in enumerate(keys)}
    for j, col in enumerate(columns):
        for key, value in data[col].items():
            values[row_of[key], j] = np.nan if value is None else value
    index = _parse_index(keys)
    order = sorted(range(len(index)), key=index.__getitem__)
    return Frame(values[order], columns, [index[i] for i in order])


def verify_dataframe(frame: Frame, expected_columns: List[str]) -> Frame:
    """
    Column-verify client data against the model's tags: unlabeled frames
    of the right width get the expected names; labeled frames are
    re-ordered and pruned; mismatches raise a 400.
    """
    if not all(col in frame.columns for col in expected_columns):
        if len(frame.columns) != len(expected_columns):
            raise ApiError(
                {
                    "message": f"Unexpected features: "
                    f"was expecting {expected_columns} length of "
                    f"{len(expected_columns)}, but got {frame.columns} length of "
                    f"{len(frame.columns)}"
                }
            )
        return Frame(frame.values, list(expected_columns), frame.index)
    cols = [frame.columns.index(col) for col in expected_columns]
    return Frame(frame.values[:, cols], list(expected_columns), frame.index)


def extract_X_y(
    body: Optional[dict], tags: List[str], target_tags: List[str]
) -> Tuple[Frame, Optional[Frame]]:
    """``X`` (required) and ``y`` (optional) out of a JSON request body."""
    if not isinstance(body, dict) or "X" not in body:
        raise ApiError({"message": 'Cannot predict without "X"'})
    X = verify_dataframe(dataframe_from_dict(body["X"]), tags)
    y = body.get("y")
    if y is not None:
        y = verify_dataframe(dataframe_from_dict(y), target_tags)
    return X, y


def resolution_to_timedelta(freq: str) -> timedelta:
    """A fixed pandas frequency alias ("10T", "10min", "8H", "1D") -> timedelta."""
    return timedelta(microseconds=frequency_to_ns(freq) / 1000)
