"""
Streaming scoring (the port of ``gordo_tpu.streaming``): long-lived
sessions whose machines keep their window context on the device, each
update scored through the same stacked dispatch as one-shot requests.
"""

from .session import (
    DEFAULT_IDLE_AFTER_S,
    DEFAULT_MAX_BACKLOG,
    DEFAULT_MAX_SESSIONS,
    MachineStream,
    SessionManager,
    StreamGone,
    StreamSession,
    StreamShed,
)
from .window import MachineWindow, SequenceGap, WindowUpdate

__all__ = [
    "DEFAULT_IDLE_AFTER_S",
    "DEFAULT_MAX_BACKLOG",
    "DEFAULT_MAX_SESSIONS",
    "MachineStream",
    "MachineWindow",
    "SequenceGap",
    "SessionManager",
    "StreamGone",
    "StreamSession",
    "StreamShed",
    "WindowUpdate",
]
