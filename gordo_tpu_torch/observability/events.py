"""
The structured JSONL event log (the port of
``gordo_tpu.observability.events``): one JSON object a line, one line an
event (a fault fired, a machine drifted, a stream update observed, a
lifecycle tick finished).

Pointing ``GORDO_TPU_EVENT_LOG`` at a file turns it on (or an explicit
path given to :class:`EventEmitter`); otherwise emitting is a cheap
no-op. Emission never raises: telemetry must not crash the work it
observes. Each record is written whole with one append (``O_APPEND``),
so threads and processes sharing the file interleave whole lines.
``GORDO_TPU_EVENT_LOG_MAX_MB`` caps the file: at the cap it is renamed
to ``<path>.1`` (one generation kept) and a fresh file starts; the
lifecycle's byte cursor starts over when the log shrinks.

A record carries ``ts``, ``unix_ms``, ``event``, ``pid`` and the
event's own fields; one emitted inside a recording span also carries the
span's ``trace_id`` and ``span_id`` (``tracing.trace_fields()``), so the
event log joins the span log on the trace id, as the JAX emitter's does.
Fields given explicitly win (a thread that hands a span to another
passes ``**trace_fields(span)`` itself).
"""

import json
import logging
import os
import threading
import time
from datetime import datetime, timezone
from typing import List, Optional

from gordo_tpu_torch.observability.tracing import trace_fields

logger = logging.getLogger(__name__)

EVENT_LOG_ENV_VAR = "GORDO_TPU_EVENT_LOG"
#: the rotation cap in MB; unset or 0 turns rotation off
EVENT_LOG_MAX_MB_ENV_VAR = "GORDO_TPU_EVENT_LOG_MAX_MB"


def _rotate_cap_bytes() -> int:
    raw = os.environ.get(EVENT_LOG_MAX_MB_ENV_VAR, "")
    if not raw:
        return 0
    try:
        return int(float(raw) * 1024 * 1024)
    except ValueError:
        return 0


class EventEmitter:
    """Emit events to a JSONL file. ``path=None`` reads
    ``GORDO_TPU_EVENT_LOG`` at each emit, so one process-wide emitter
    follows the environment as it changes."""

    def __init__(self, path: Optional[str] = None):
        self._path = path
        self._lock = threading.Lock()

    def target_path(self) -> str:
        """The active log path, or '' when logging is off."""
        return self._path or os.environ.get(EVENT_LOG_ENV_VAR, "")

    def emit(self, event: str, **fields) -> Optional[dict]:
        """Append one event line; the record written, or None when
        logging is off or the write failed (logged, never raised)."""
        path = self.target_path()
        if not path:
            return None
        record = {
            "ts": datetime.now(timezone.utc).isoformat(),
            "unix_ms": int(time.time() * 1000),
            "event": str(event),
            "pid": os.getpid(),
        }
        record.update(fields)
        for key, value in trace_fields().items():
            record.setdefault(key, value)
        try:
            line = json.dumps(record, default=str) + "\n"
        except Exception:
            logger.warning("Unserializable telemetry event %r dropped", event)
            return None
        try:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            with self._lock:
                cap = _rotate_cap_bytes()
                if cap > 0:
                    try:
                        if os.path.getsize(path) >= cap:
                            os.replace(path, path + ".1")
                    except OSError:
                        pass  # no file yet
                fd = os.open(path, os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644)
                try:
                    os.write(fd, line.encode())
                finally:
                    os.close(fd)
        except OSError:
            logger.warning("Could not write telemetry event to %s", path, exc_info=True)
            return None
        return record


#: the process-wide emitter (configured by the environment)
_DEFAULT_EMITTER = EventEmitter()


def emit_event(event: str, **fields) -> Optional[dict]:
    """Emit on the process-wide emitter."""
    return _DEFAULT_EMITTER.emit(event, **fields)


def read_events(path: str) -> List[dict]:
    """The records of a JSONL event file, skipping (and counting in the
    log) malformed lines: a crash mid-write may cut the last one."""
    records: List[dict] = []
    bad = 0
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except ValueError:
                bad += 1
    if bad:
        logger.warning("Skipped %d malformed event lines in %s", bad, path)
    return records
