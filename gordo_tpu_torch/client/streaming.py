"""
The client side of streaming scoring (the port of
``gordo_tpu.client.streaming``): :class:`StreamPublisher`, a context
manager that holds one stream session over a kept-alive connection,
pushes a machine's new sensor rows and returns each update's scores.

The wire contract, handled as the JAX publisher handles it:

- a 503 with ``Retry-After`` (the session table or a backlog shed, on
  open and on update) sleeps that long, jittered up
  (:func:`~gordo_tpu_torch.client.utils.retry_after_seconds`);
- a 409 with a ``stream_resume`` body (the session was closed or
  expired, its revision rolled, its replica died behind the router, a
  sequence gap) reconnects: the publisher opens again with each
  machine's retained window tail (``tail_rows`` raw rows, as the open
  reply said) and sends the unacknowledged rows again; the server trims
  the overlap by sequence number, so the scores go on unbroken;
- a transport error reconnects the same way after the jittered
  exponential backoff (:func:`~gordo_tpu_torch.client.utils.backoff_seconds`).

Calls go through ``utils/http.py``'s ``HttpTransport`` (the JAX publisher
uses a ``requests.Session``); each is a ``client.request`` span whose
``traceparent`` it carries, and each outcome is counted in
``gordo_client_stream_requests_total{outcome}``.
"""

import http.client
import json
import logging
import typing
from time import sleep
from urllib.parse import urlencode

import numpy as np

from gordo_tpu_torch.client.io import handle_response
from gordo_tpu_torch.client.utils import (
    DEFAULT_RETRY_JITTER,
    backoff_seconds,
    retry_after_seconds,
)
from gordo_tpu_torch.observability import tracing
from gordo_tpu_torch.observability.registry import get_registry
from gordo_tpu_torch.utils.http import HttpTransport, Reply

logger = logging.getLogger(__name__)

#: transport failures that reconnect
TRANSPORT_ERRORS = (OSError, http.client.HTTPException)


class StreamBroken(IOError):
    """The stream could not be (re-)established within the retry
    budget; per-machine context is in the message."""


def _count(outcome: str) -> None:
    get_registry().counter(
        "gordo_client_stream_requests_total",
        "Client stream open/update calls by outcome "
        "(ok/shed/resumed/io_error)",
        ("outcome",),
    ).inc(outcome=outcome)


class StreamPublisher:
    """
    One open stream session against a server (or router — the surface
    is identical). Use through :meth:`Client.stream_machine
    <gordo_tpu_torch.client.client.Client.stream_machine>`::

        with client.stream_machine("tag-farm-07") as stream:
            for rows in sensor_feed:
                scores = stream.send(rows)

    ``send`` accepts a bare ``(k, n_features)`` array (single-machine
    streams) or a ``{machine: rows}`` mapping, plus optional targets
    ``y`` in the same shape; it returns scores the same way. Scores for
    warming rows (a windowed model that cannot yet fill one window)
    arrive with later updates — ``send`` returns the rows scored NOW.
    """

    def __init__(
        self,
        transport: HttpTransport,
        server_endpoint: str,
        machines: typing.Sequence[str],
        revision: typing.Optional[str] = None,
        n_retries: int = 5,
        timeout: typing.Union[float, typing.Tuple, None] = (30.0, None),
        jitter: float = DEFAULT_RETRY_JITTER,
        backoff_scale: float = 1.0,
        headers: typing.Optional[typing.Dict[str, str]] = None,
    ):
        if not machines:
            raise ValueError("stream_machine needs at least one machine")
        self.transport = transport
        self.headers = dict(headers or {})
        self.base = f"{server_endpoint}/stream"
        self.machines = [str(m) for m in machines]
        self.revision = revision
        self.n_retries = max(0, int(n_retries))
        self.timeout = timeout
        self.jitter = jitter
        #: scale on the house 8/16/32s reconnect schedule (the router's
        #: --backoff-scale idiom): a monitoring deployment that would
        #: rather reconnect in ~1s than ~8s sets it < 1. Retry-After
        #: sleeps are NOT scaled — the server said when to come back.
        self.backoff_scale = max(0.0, float(backoff_scale))
        self.session_id: typing.Optional[str] = None
        #: raw-row replay tails per machine: (first_row_seq, rows list)
        self._tails: typing.Dict[str, typing.Tuple[int, list]] = {}
        self._tail_rows: typing.Dict[str, int] = {}
        #: rows acked by the server so far, per machine
        self.seq: typing.Dict[str, int] = {m: 0 for m in self.machines}
        self.reconnects = 0
        self.sheds_honored = 0

    # -- context manager ---------------------------------------------------

    def __enter__(self) -> "StreamPublisher":
        self.open()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    # -- wire --------------------------------------------------------------

    def _url(self, path: str) -> str:
        # a pinned revision must ride EVERY call, or the server would
        # resolve `latest` and answer the resume contract spuriously
        query = f"?{urlencode({'revision': self.revision})}" if self.revision else ""
        return f"{self.base}{path}{query}"

    def _post(self, path: str, body: dict) -> Reply:
        with tracing.start_span("client.request", path="stream") as span:
            headers = {**self.headers, **tracing.propagation_headers(span),
                       "Content-Type": "application/json"}
            return self.transport.request(
                "POST", self._url(path), body=json.dumps(body).encode(), headers=headers,
                timeout=self.timeout,
            )

    @staticmethod
    def _json(resp: Reply):
        try:
            return json.loads(resp.body)
        except ValueError:
            return None

    @classmethod
    def _resume_block(cls, resp: Reply) -> typing.Optional[dict]:
        """The ``stream_resume`` body of a 409, or None."""
        if resp.status != 409:
            return None
        body = cls._json(resp)
        return body.get("stream_resume") if isinstance(body, dict) else None

    def open(self, resume: bool = False) -> dict:
        """
        Open (or re-open) the session, honoring 503 + Retry-After like
        the POST path. With ``resume`` (or retained tails), the open
        body replays each machine's window tail so the server rebuilds
        the device-resident context without re-scoring anything.
        """
        body: typing.Dict[str, typing.Any] = {}
        if resume or self._tails:
            # every machine replays: rows are its retained tail (may be
            # empty for non-windowed machines — the seq cursor alone
            # re-anchors the server's replay position then)
            body["machines"] = {
                m: {
                    "resume": {
                        "rows": self._tails.get(m, (self.seq.get(m, 0), []))[1],
                        "seq": self._tails.get(m, (self.seq.get(m, 0), []))[0],
                    }
                }
                for m in self.machines
            }
        else:
            body["machines"] = list(self.machines)
        last_error: typing.Optional[Exception] = None
        for attempt in range(1, self.n_retries + 2):
            try:
                resp = self._post("/open", body)
            except TRANSPORT_ERRORS as exc:
                last_error = exc
                _count("io_error")
                if attempt <= self.n_retries:
                    sleep(self.backoff_scale * backoff_seconds(attempt, jitter=self.jitter))
                continue
            if resp.status == 503:
                # the shed contract: the server said when to come back
                retry_after = resp.headers.get("retry-after")
                last_error = IOError(
                    f"Stream open shed with 503 (Retry-After "
                    f"{retry_after}): {resp.body!r}"
                )
                _count("shed")
                self.sheds_honored += 1
                if attempt <= self.n_retries:
                    try:
                        base = float(retry_after)
                    except (TypeError, ValueError):
                        base = backoff_seconds(attempt)
                    sleep(retry_after_seconds(base, jitter=self.jitter))
                continue
            if resp.status == 409:
                refusal = self._json(resp)
                if not (
                    isinstance(refusal, dict)
                    and (
                        refusal.get("stream_resume")
                        or refusal.get("transient")
                    )
                ):
                    # a PERMANENT 409 (quarantined/build-failed machine):
                    # surface the typed error NOW —
                    # retrying a per-revision condition only buries it
                    handle_response(resp, resource_name="Stream open")
                # router-side transient (e.g. a shard between homes):
                # retry the open on the house backoff
                last_error = IOError(
                    f"Stream open answered transient 409: {resp.body!r}"
                )
                _count("io_error")
                if attempt <= self.n_retries:
                    sleep(self.backoff_scale * backoff_seconds(attempt, jitter=self.jitter))
                continue
            payload = handle_response(resp, resource_name="Stream open")
            self.session_id = payload["session"]
            for name, info in (payload.get("machines") or {}).items():
                self._tail_rows[name] = int(info.get("tail_rows") or 0)
                self.seq[name] = int(info.get("seq") or 0)
            _count("ok")
            return payload
        raise StreamBroken(
            f"Could not open stream for {self.machines} after "
            f"{self.n_retries + 1} attempt(s): {last_error}"
        )

    def _reconnect(self, attempt: int, why: str) -> None:
        self.reconnects += 1
        logger.warning(
            "Stream %s reconnecting (%s); replaying window tails",
            self.session_id, why,
        )
        _count("resumed")
        sleep(self.backoff_scale * backoff_seconds(attempt, jitter=self.jitter))
        self.open(resume=True)

    def send(
        self,
        rows: typing.Union[np.ndarray, list, dict],
        y: typing.Union[np.ndarray, list, dict, None] = None,
    ) -> typing.Union[np.ndarray, typing.Dict[str, np.ndarray]]:
        """
        Push one update and return its scores (a bare array for
        single-machine streams opened with a string, else a
        ``{machine: scores}`` dict). Reconnect + window-tail replay on
        resume 409s and transport errors; Retry-After honored on sheds.
        """
        if self.session_id is None:
            raise StreamBroken("Stream is not open (use `with` or .open())")
        single = not isinstance(rows, dict)
        per_machine = (
            {self.machines[0]: rows} if single else dict(rows)
        )
        y_per_machine: typing.Dict[str, typing.Any] = {}
        if y is not None:
            y_per_machine = (
                {self.machines[0]: y} if not isinstance(y, dict) else dict(y)
            )
        payload_rows = {
            name: np.asarray(value, dtype="float64").tolist()
            for name, value in per_machine.items()
        }
        last_error: typing.Optional[Exception] = None
        for attempt in range(1, self.n_retries + 2):
            updates = {
                name: {
                    "rows": value,
                    "seq": self.seq.get(name, 0),
                    **(
                        {
                            "y": np.asarray(
                                y_per_machine[name], dtype="float64"
                            ).tolist()
                        }
                        if name in y_per_machine
                        else {}
                    ),
                }
                for name, value in payload_rows.items()
            }
            try:
                resp = self._post(
                    f"/{self.session_id}/update", {"updates": updates}
                )
            except TRANSPORT_ERRORS as exc:
                last_error = exc
                _count("io_error")
                if attempt <= self.n_retries:
                    self._reconnect(attempt, f"transport error: {exc}")
                continue
            if resp.status == 503:
                retry_after = resp.headers.get("retry-after")
                last_error = IOError(
                    f"Stream update shed with 503 (Retry-After "
                    f"{retry_after})"
                )
                _count("shed")
                self.sheds_honored += 1
                if attempt <= self.n_retries:
                    try:
                        base = float(retry_after)
                    except (TypeError, ValueError):
                        base = backoff_seconds(attempt)
                    sleep(retry_after_seconds(base, jitter=self.jitter))
                continue
            resume = self._resume_block(resp)
            if resume is not None:
                last_error = IOError(
                    f"Stream session lost ({resume.get('reason')})"
                )
                if attempt <= self.n_retries:
                    self._reconnect(
                        attempt, str(resume.get("reason") or "resume")
                    )
                continue
            payload = handle_response(resp, resource_name="Stream update")
            _count("ok")
            scores = {}
            for name, result in (payload.get("scores") or {}).items():
                scores[name] = np.asarray(
                    result.get("rows") or [], dtype="float32"
                )
                self._ack(name, payload_rows[name], int(result["seq"]))
            if single:
                return scores.get(self.machines[0], np.empty((0,)))
            return scores
        raise StreamBroken(
            f"Stream update failed after {self.n_retries + 1} attempt(s): "
            f"{last_error}"
        )

    def _ack(self, name: str, sent_rows: list, acked_seq: int) -> None:
        """Advance the replay tail: keep the last ``tail_rows`` ACKED
        raw rows (plus their absolute start seq) — exactly what a
        resume open must replay as context."""
        tail_len = self._tail_rows.get(name, 0)
        start, tail = self._tails.get(name, (self.seq.get(name, 0), []))
        tail = list(tail) + list(sent_rows)
        overflow = max(0, len(tail) - tail_len) if tail_len else len(tail)
        if overflow:
            tail = tail[overflow:]
            start += overflow
        self._tails[name] = (start, tail)
        self.seq[name] = acked_seq

    def close(self) -> None:
        """Best-effort close (the server's session would idle-evict
        anyway; this frees the device-resident window NOW)."""
        if self.session_id is None:
            return
        try:
            self._post(f"/{self.session_id}/close", {})
        except Exception as exc:  # noqa: BLE001 - close is best-effort
            logger.debug("Stream close failed (ignored): %s", exc)
        self.session_id = None
