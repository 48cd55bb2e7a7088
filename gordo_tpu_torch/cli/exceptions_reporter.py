"""
A failed build's exit code and report (the port of
``gordo_tpu.cli.exceptions_reporter``): the exit code is the one
registered for the most derived class of the raised exception, and the
report is a small JSON document, sized for a 2024-byte termination
message, whose fields depend on the :class:`ReportLevel`:

- ``EXIT_CODE``: ``{}``;
- ``TYPE``: ``{"type"}``;
- ``MESSAGE``: ``{"type", "message"}``, the message clipped to its budget
  with a trailing ``...``;
- ``TRACEBACK``: ``{"type", "traceback"}``, keeping the last lines that
  fit behind a leading ``...`` line.

Every text is ASCII, other characters becoming ``?``.
"""

import json
import re
import traceback
from enum import IntEnum
from types import TracebackType
from typing import IO, Dict, Iterable, List, Optional, Tuple, Type

DEFAULT_EXIT_CODE = 1
ELLIPSIS = "..."


class ReportLevel(IntEnum):
    """How much of the failure the report carries."""

    EXIT_CODE = 0
    TYPE = 1
    MESSAGE = 2
    TRACEBACK = 3

    @classmethod
    def get_by_name(cls, name: str, default: Optional["ReportLevel"] = None):
        return cls.__members__.get(name, default)

    @classmethod
    def get_names(cls) -> List[str]:
        return list(cls.__members__)


def _scrub(text: str) -> str:
    return re.sub(r"[^\x00-\x7F]", "?", text)


def _clip_message(message: str, budget: int) -> str:
    if len(message) <= budget:
        return message
    if budget <= len(ELLIPSIS):
        return ""
    return message[: budget - len(ELLIPSIS)] + ELLIPSIS


def _clip_traceback_lines(lines: List[str], budget: int) -> List[str]:
    """The trailing lines that fit (the raise site is the useful end),
    behind a ``...`` line when any were dropped."""
    if sum(map(len, lines)) <= budget:
        return lines
    marker = ELLIPSIS + "\n"
    room = budget - len(marker)
    tail: List[str] = []
    for line in reversed(lines):
        if room - len(line) < 0:
            break
        room -= len(line)
        tail.append(line)
    return [marker] + tail[::-1]


class ExceptionsReporter:
    """Exit codes by exception class (the most derived registered class of
    a raised exception decides; ``DEFAULT_EXIT_CODE`` for none), and the
    report at a level."""

    def __init__(self, exceptions: Iterable[Tuple[Type[BaseException], int]]):
        self._exit_codes: Dict[type, int] = dict(exceptions)

    def _resolve(self, exc_type: Type[BaseException]) -> Optional[type]:
        for klass in exc_type.__mro__:
            if klass in self._exit_codes:
                return klass
        return None

    def exception_exit_code(self, exc_type: Optional[Type[BaseException]]) -> int:
        """The exit code for ``exc_type`` (0 for none)."""
        if exc_type is None:
            return 0
        klass = self._resolve(exc_type)
        return DEFAULT_EXIT_CODE if klass is None else self._exit_codes[klass]

    def _describe(self, level, exc_type, exc_value, exc_traceback, max_message_len):
        fields: Dict[str, str] = {}
        if level >= ReportLevel.TYPE:
            fields["type"] = _scrub(exc_type.__name__)
        if level == ReportLevel.MESSAGE:
            message = _scrub(str(exc_value))
            if max_message_len is not None:
                message = _clip_message(message, max_message_len)
            fields["message"] = message
        if level == ReportLevel.TRACEBACK:
            lines = [
                _scrub(line)
                for line in traceback.format_exception(exc_type, exc_value, exc_traceback)
            ]
            if max_message_len is not None:
                lines = _clip_traceback_lines(lines, max_message_len)
            fields["traceback"] = "".join(lines)
        return fields

    def report(
        self,
        level: ReportLevel,
        exc_type: Optional[Type[BaseException]],
        exc_value: Optional[BaseException],
        exc_traceback: Optional[TracebackType],
        report_file: IO[str],
        max_message_len: Optional[int] = None,
    ) -> None:
        """Write the report; an exception of no registered class (or none)
        gives an empty document."""
        fields: Dict[str, str] = {}
        if (exc_type is not None and exc_value is not None and exc_traceback is not None
                and self._resolve(exc_type) is not None):
            fields = self._describe(level, exc_type, exc_value, exc_traceback, max_message_len)
        json.dump(fields, report_file)

    def safe_report(self, level, exc_type, exc_value, exc_traceback, report_file_path: str,
                    max_message_len: Optional[int] = None) -> None:
        """:meth:`report` into a file; a failure is printed, never raised."""
        try:
            with open(report_file_path, "w") as report_file:
                self.report(level, exc_type, exc_value, exc_traceback, report_file,
                            max_message_len)
        except Exception:  # noqa: BLE001 (the report must never mask the build's failure)
            traceback.print_exc()
