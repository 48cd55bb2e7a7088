"""
The client's reading of a server's replies (the port of
``gordo_tpu.client.io``): a status maps to a typed exception, so a
caller branches on the kind of failure, not on status numbers. A reply
is a :class:`gordo_tpu_torch.utils.http.Reply` (status, lower-cased
headers, body bytes); the messages and exceptions are the JAX module's.
"""

import json
import math
from typing import Optional, Union

from gordo_tpu_torch.observability.tracing import TRACE_ID_RESPONSE_HEADER


class HttpUnprocessableEntity(Exception):
    """HTTP 422: in practice, ``/anomaly/prediction`` asked of a model
    that is not an anomaly detector."""


class ResourceGone(Exception):
    """HTTP 410: the requested revision is gone from the server."""


class BadGordoRequest(Exception):
    """Any other 4xx."""


class NotFound(Exception):
    """HTTP 404."""


class ServerOverloaded(IOError):
    """
    HTTP 503 with a ``Retry-After`` header: the server shed the request
    (batching or stream admission control). Transient: the retry loops
    take ``retry_after`` (seconds) as their backoff base. An
    :class:`IOError`, so the retry-on-IO-error paths catch it.
    """

    def __init__(self, msg: str, retry_after: Optional[float] = None,
                 trace_id: Optional[str] = None):
        super().__init__(msg)
        self.retry_after = retry_after
        self.trace_id = trace_id


class MachineUnavailable(Exception):
    """
    HTTP 409: the server refuses predictions for a machine its build
    recorded as failed or quarantined, for the whole revision, so
    retrying is pointless. ``unavailable`` is the reply's ``{name:
    {reason, ...}}``; ``trace_id`` the server's echoed
    ``X-Gordo-Trace-Id``.
    """

    def __init__(self, msg: str, unavailable: Optional[dict] = None,
                 trace_id: Optional[str] = None):
        super().__init__(msg)
        self.unavailable = unavailable or {}
        self.trace_id = trace_id


class ReplicaUnavailable(MachineUnavailable):
    """
    A 409 marked ``"transient": true``: the router names machines whose
    every replica is ejected for now. Handled as its parent within a run
    (the machines are recorded, the rest goes on), but worth retrying
    later (``retry_after``).
    """

    def __init__(self, msg: str, unavailable: Optional[dict] = None,
                 trace_id: Optional[str] = None, retry_after: Optional[float] = None):
        super().__init__(msg, unavailable, trace_id=trace_id)
        self.retry_after = retry_after


def handle_response(resp, resource_name: Optional[str] = None) -> Union[dict, bytes]:
    """
    The parsed JSON of a 2xx JSON reply, the body bytes of another 2xx;
    else the typed exception of the status: 422
    :class:`HttpUnprocessableEntity`, 410 :class:`ResourceGone`, 404
    :class:`NotFound`, 409 :class:`MachineUnavailable` (or
    :class:`ReplicaUnavailable`), another 4xx :class:`BadGordoRequest`, a
    503 with a seconds ``Retry-After`` :class:`ServerOverloaded`, any
    other status ``IOError``.
    """
    status = resp.status
    if 200 <= status <= 299:
        content_type = resp.headers.get("content-type", "")
        if content_type.split(";")[0].strip() == "application/json":
            return json.loads(resp.body)
        return resp.body

    if resource_name:
        msg = (
            f"Failed to fetch resource: {resource_name}. "
            f"Status: {status}. Content: {resp.body!r}"
        )
    else:
        msg = f"Failed to get response: {status}: {resp.body!r}"
    # the server echoes the request's trace id on every reply: the failure
    # can be found in its span and event logs
    trace_id = resp.headers.get(TRACE_ID_RESPONSE_HEADER.lower())
    if trace_id:
        msg += f" (server trace id: {trace_id})"

    if status == 422:
        raise HttpUnprocessableEntity(msg)
    if status == 410:
        raise ResourceGone(msg)
    if status == 404:
        raise NotFound(msg)
    if status == 409:
        try:
            body = json.loads(resp.body)
        except ValueError:
            body = {}
        if not isinstance(body, dict):
            body = {}
        detail = body.get("unavailable") or {}
        if body.get("transient"):
            raise ReplicaUnavailable(
                msg, detail, trace_id=trace_id,
                retry_after=_parse_retry_after(
                    resp.headers.get("retry-after") or body.get("retry_after_s")
                ),
            )
        raise MachineUnavailable(msg, detail, trace_id=trace_id)
    if 400 <= status <= 499:
        raise BadGordoRequest(msg)
    if status == 503:
        # only a seconds value upgrades the error; an HTTP date or none
        # leaves it on the exponential backoff
        retry_after = _parse_retry_after(resp.headers.get("retry-after"))
        if retry_after is not None:
            raise ServerOverloaded(msg, retry_after=retry_after, trace_id=trace_id)
    raise IOError(msg)


#: the longest sleep a ``Retry-After`` asks for is capped as the
#: exponential backoff is (``utils.backoff_seconds``)
MAX_RETRY_AFTER_S = 300.0


def _parse_retry_after(value) -> Optional[float]:
    """A seconds ``Retry-After`` capped at :data:`MAX_RETRY_AFTER_S`, or
    None when it is missing or not a finite number at least 0."""
    if value is None:
        return None
    try:
        seconds = float(value)
    except (TypeError, ValueError):
        return None
    if not math.isfinite(seconds) or seconds < 0:
        return None
    return min(seconds, MAX_RETRY_AFTER_S)
