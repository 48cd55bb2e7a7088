"""
The model server (the port of ``gordo_tpu.server.app``'s single-machine
and fleet routes), a plain WSGI callable on the standard library and
JSON:

- ``GET  /gordo/v0/specs.json`` (an OpenAPI 3.0.3 document of these
  routes, written from the route table as the JAX server writes it from
  its URL map)
- ``GET  /healthcheck`` and ``GET /server-version``
- ``GET  /healthz`` (readiness: 503 and ``Retry-After`` while a batcher
  is saturated or shedding, or a stream session's backlog is saturated)
- ``GET  /gordo/v0/<project>/models``
- ``GET  /gordo/v0/<project>/revisions``
- ``GET  /gordo/v0/<project>/expected-models``
- ``GET  /gordo/v0/<project>/<name>/metadata`` (also ``…/healthcheck``)
- ``GET  /gordo/v0/<project>/<name>/download-model``
- ``POST /gordo/v0/<project>/<name>/prediction``
- ``POST /gordo/v0/<project>/<name>/anomaly/prediction``
- ``POST /gordo/v0/<project>/prediction/fleet`` and
  ``POST /gordo/v0/<project>/anomaly/prediction/fleet``: JSON bodies
  ``{"machines": {name: ...}}``, each architecture group of the named
  machines scored by one stacked forward (``server/fleet_serving.py``);
  with ``GORDO_BATCH_WAIT_MS`` above 0, concurrent fleet requests are
  coalesced (``server/batching.py``). Multipart (parquet) bodies are
  refused with a 400: the card's machine has no parquet reader.
- ``POST /gordo/v0/<project>/stream/open``, ``…/stream/<id>/update`` and
  ``…/stream/<id>/close``: streaming sessions (``streaming/``), whose
  machines keep their window context on the device; an update's scores
  come back inline, through the same stacked dispatch (and batcher) as
  the fleet routes. A session the server no longer holds answers 409
  with a ``stream_resume`` body (the client replays its window tail into
  a new session); a saturated session or table answers 503 with
  ``Retry-After``.

Request and response bodies, status codes and error bodies are those of
the JAX server; every JSON body and response carries the ``revision``
served. The served revision is the collection directory's name, or the
sibling directory that a ``?revision=`` query or a ``revision`` header
names (:func:`resolve_sibling_revision`; a name it refuses gets 410).
When the collection directory is a symlink (a ``latest`` link that a
promotion re-points), it is resolved on every request: the first request
after a re-point stops the batchers and expires the stream sessions of
the other revisions (their next update answers 409 ``revision_rolled``).
Models load on first use onto the app's device and stay there, keyed by
their real directory. Machines that the revision's ``build_report.json``
records as failed or quarantined answer 409 on every prediction route,
and ``/models`` lists them under ``unavailable``.

Observability, as the JAX server's: a request's ``traceparent`` header
(W3C trace context) parents its ``server.request`` span when tracing is
on (``GORDO_TPU_TRACE_LOG``), and every reply echoes the trace id in
``X-Gordo-Trace-Id``, errors included; the probe paths (``/healthcheck``,
``/healthz``, ``/metrics``, ``/telemetry/snapshot``) echo but record
nothing. A request's phase ledger (``observability/attribution.py``;
``GORDO_PHASE_LEDGER=0`` turns it off) times its seven phases into
``gordo_phase_seconds{plane="server"}``, the span's attributes and the
``Server-Timing`` header, beside the ``model_load``, ``predict`` and
``queue`` entries. With ``enable_prometheus`` (``ENABLE_PROMETHEUS``)
``GET /metrics`` writes the request metrics and the process registry in
the Prometheus text format (``server/prometheus/metrics.py``); else it
answers 404. ``GET /telemetry/snapshot`` is the registry's versioned
snapshot with the ``/healthz`` status (``observability/rollup.py``). The
``serve`` fault site (``robustness/faults.py``) is asked on every
prediction route for each machine named, and a firing answers 503 with
``Fault injection: ...``, as a ``batch`` firing in the batcher does; the
``stream`` site at the top of each update (``drop``: the session is
forgotten and the update answers the resume 409; ``stall``: the update
sleeps; ``burst``: the update weighs as several against the backlog).
Streams write ``stream_opened``, ``stream_resumed``, ``stream_closed``
and ``stream_update_shed`` events and run under ``stream.session`` and
``stream.update`` spans; a ``latest`` roll writes ``revision_rolled``.

A sharded replica (``shard_manifest``, ``GORDO_SHARD_MANIFEST``; its id
``replica_id``, ``GORDO_REPLICA_ID``) serves the consistent-hash share of
the collection that the ring gives it (``router/ring.py``): ``/models``
lists its shard, its fleet scorers stack its shard's machines, and a
prediction or stream route naming a machine of another shard answers a
421 naming the owner, unless the request carries the router's
``X-Gordo-Shard-Adopt`` header (failover, hedging). The router
(``gordo_tpu_torch.router``) fronts such replicas.
"""

import contextlib
import json
import logging
import os
import re
import threading
import time
import timeit
import traceback
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple
from urllib.parse import parse_qs

import numpy as np

from gordo_tpu_torch import __version__, serializer
from gordo_tpu_torch.data.sensor_tag import tag_names
from gordo_tpu_torch.device import DeviceLike, resolve_device
from gordo_tpu_torch.models.utils import make_base_dataframe
from gordo_tpu_torch.models.anomaly.diff import DiffBasedAnomalyDetector
from gordo_tpu_torch.observability import (
    attribution,
    emit_event,
    prom_text,
    rollup,
    sampling,
    tracing,
)
from gordo_tpu_torch.observability.registry import get_registry
from gordo_tpu_torch.robustness import faults
from gordo_tpu_torch.server import batching
from gordo_tpu_torch.server import utils as server_utils
from gordo_tpu_torch.server.catalog import ADOPT_HEADER, ServingCatalog, ShardSpec
from gordo_tpu_torch.server.model_io import get_model_output
from gordo_tpu_torch.server.utils import ApiError
from gordo_tpu_torch.streaming import session as stream_session
from gordo_tpu_torch.tuning.profile import TunedOption, resolve_tuned_options

logger = logging.getLogger(__name__)

MODEL_COLLECTION_DIR_ENV_VAR = "MODEL_COLLECTION_DIR"
EXPECTED_MODELS_ENV_VAR = "EXPECTED_MODELS"
#: the serving settings a collection's tuning profile may default (the
#: JAX server's): an explicit argument of the app, else the variable,
#: else the profile, else the default
SERVER_TUNED_OPTIONS = (
    TunedOption("batch_wait_ms", "batch_wait_ms", "GORDO_BATCH_WAIT_MS", float, 0.0),
    TunedOption("batch_queue_limit", "batch_queue_limit", "GORDO_BATCH_QUEUE_LIMIT", int, 64),
    TunedOption("scorer_cache_size", "scorer_cache_size", "GORDO_SCORER_CACHE_SIZE", int, 16),
)
#: the other serving settings: (environment variable, type, default); an
#: explicit argument of the app wins over the variable
STREAM_MAX_SESSIONS = ("GORDO_STREAM_MAX_SESSIONS", int, stream_session.DEFAULT_MAX_SESSIONS)
STREAM_MAX_BACKLOG = ("GORDO_STREAM_MAX_BACKLOG", int, stream_session.DEFAULT_MAX_BACKLOG)
STREAM_IDLE_S = ("GORDO_STREAM_IDLE_S", float, stream_session.DEFAULT_IDLE_AFTER_S)
SHARD_MANIFEST = ("GORDO_SHARD_MANIFEST", str, "")
REPLICA_ID = ("GORDO_REPLICA_ID", str, "")


def _env_bool(value: str) -> bool:
    return str(value).strip().lower() in ("1", "true", "yes", "on")


ENABLE_PROMETHEUS = ("ENABLE_PROMETHEUS", _env_bool, False)

_STATUS_TEXT = {
    200: "OK",
    201: "CREATED",
    400: "BAD REQUEST",
    404: "NOT FOUND",
    405: "METHOD NOT ALLOWED",
    409: "CONFLICT",
    410: "GONE",
    421: "MISDIRECTED REQUEST",
    422: "UNPROCESSABLE ENTITY",
    500: "INTERNAL SERVER ERROR",
    503: "SERVICE UNAVAILABLE",
}

_PROJECT = "/gordo/v0/<gordo_project>"
_MACHINE = _PROJECT + "/<gordo_name>"
#: (method, path template, view name), in the JAX URL map's order; a
#: ``<name>`` segment is a path argument
_ROUTES = [
    ("GET", "/gordo/v0/specs.json", "specs"),
    ("GET", "/healthcheck", "healthcheck"),
    ("GET", "/healthz", "healthz"),
    ("GET", "/server-version", "server_version"),
    ("GET", "/metrics", "metrics"),
    ("GET", "/telemetry/snapshot", "telemetry_snapshot"),
    ("GET", _PROJECT + "/models", "models"),
    ("GET", _PROJECT + "/revisions", "revisions"),
    ("GET", _PROJECT + "/expected-models", "expected_models"),
    ("GET", _MACHINE + "/metadata", "metadata"),
    ("GET", _MACHINE + "/healthcheck", "metadata"),
    ("GET", _MACHINE + "/download-model", "download_model"),
    ("POST", _MACHINE + "/prediction", "prediction"),
    ("POST", _MACHINE + "/anomaly/prediction", "anomaly_prediction"),
    ("POST", _PROJECT + "/prediction/fleet", "fleet_prediction"),
    ("POST", _PROJECT + "/anomaly/prediction/fleet", "fleet_anomaly_prediction"),
    ("POST", _PROJECT + "/stream/open", "stream_open"),
    ("POST", _PROJECT + "/stream/<stream_id>/update", "stream_update"),
    ("POST", _PROJECT + "/stream/<stream_id>/close", "stream_close"),
]
_SEGMENT = re.compile(r"<([^<>]+)>")


def compile_routes(routes) -> list:
    """(method, regex, view) of (method, template, view) routes: a
    ``<name>`` segment matches one path segment as argument ``name``."""
    return [(method, re.compile(_SEGMENT.sub(r"(?P<\1>[^/]+)", re.escape(template)) + "/?$"),
             view)
            for method, template, view in routes]


_COMPILED_ROUTES = compile_routes(_ROUTES)

#: view -> the operation summary of the OpenAPI document (the JAX
#: server's words)
SPEC_SUMMARIES = {
    "specs": "OpenAPI description of this API",
    "healthcheck": "Liveness check",
    "healthz": "Readiness check (reflects batching-queue saturation)",
    "server_version": "Server version",
    "metrics": "Prometheus metrics exposition",
    "telemetry_snapshot": "Versioned registry dump + process identity (plane rollup)",
    "models": "List models in the served revision",
    "revisions": "List available model revisions",
    "expected_models": "List models the deployment expects",
    "metadata": "Build metadata for one model",
    "download_model": "Download the serialized model",
    "prediction": "Run the model on posted data",
    "anomaly_prediction": "Run anomaly scoring on posted data",
    "fleet_prediction": "Batched multi-machine scoring (TPU extension)",
    "fleet_anomaly_prediction": "Batched multi-machine anomaly scoring (TPU extension)",
    "stream_open": "Open a streaming scoring session (TPU extension)",
    "stream_update": (
        "Push incremental sensor rows to a stream session; scores return inline"
    ),
    "stream_close": "Close a streaming scoring session",
}


def openapi_document(routes, title: str) -> dict:
    """The OpenAPI 3.0.3 document of (method, template, view) routes as
    the JAX server writes it from its URL map: ``<arg>`` becomes
    ``{arg}``, an operation's id is its view with ``_2``, ``_3``, ... when
    several routes share the view, and its path arguments are sorted."""
    paths: Dict[str, dict] = {}
    op_counts: Dict[str, int] = {}
    for method, template, view in routes:
        path = _SEGMENT.sub(r"{\1}", template)
        n = op_counts.get(view, 0)
        op_counts[view] = n + 1
        paths.setdefault(path, {})[method.lower()] = {
            "operationId": view if n == 0 else f"{view}_{n + 1}",
            "summary": SPEC_SUMMARIES.get(view, view),
            "parameters": [
                {"name": arg, "in": "path", "required": True, "schema": {"type": "string"}}
                for arg in sorted(_SEGMENT.findall(template))
            ],
            "responses": {"200": {"description": "Success"}},
        }
    return {"openapi": "3.0.3", "info": {"title": title, "version": __version__},
            "paths": paths}


class Response:
    """One reply: a status and either body bytes or a JSON payload, which
    is encoded once the revision is stamped into it."""

    def __init__(
        self,
        body: bytes = b"",
        status: int = 200,
        mimetype: str = "text/plain",
        payload: Optional[dict] = None,
    ):
        self.body = body
        self.status = status
        self.mimetype = mimetype
        self.payload = payload
        self.headers: Dict[str, str] = {}


def _json_response(payload: dict, status: int = 200) -> Response:
    return Response(status=status, mimetype="application/json", payload=payload)


def resolve_sibling_revision(latest_dir: str, requested: str) -> Optional[str]:
    """
    The path of revision ``requested`` as a sibling of ``latest_dir``, or
    None when the name is not servable (the JAX server's name policy):
    dot names (staging directories and lifecycle state), names with a
    path separator (they would traverse), a symlink sibling (an alias of
    a revision, such as ``latest``), a loose file and a missing name.
    """
    if requested.startswith(".") or "/" in requested or "\\" in requested:
        return None
    candidate = os.path.join(latest_dir, "..", requested)
    if os.path.islink(candidate):
        return None
    try:
        os.listdir(candidate)
    except (FileNotFoundError, NotADirectoryError):
        return None
    return candidate


def _setting(value, setting):
    """An explicit value, else the environment variable's, else the default."""
    env, kind, default = setting
    if value is None:
        raw = os.environ.get(env)
        value = default if raw in (None, "") else raw
    return kind(value)


class RequestContext:
    """A request's timing: its ``Server-Timing`` entries, its trace id
    (the ``traceparent``'s, or the request span's) and its phase ledger."""

    def __init__(self):
        self.start_time = timeit.default_timer()
        #: (phase name, seconds) pairs, the Server-Timing entries
        self.timings: List[Tuple[str, float]] = []
        self.trace_id = ""
        self.ledger = attribution.ledger_for("server")

    def record_phase(self, name: str, seconds: float) -> None:
        """One phase: a Server-Timing entry, an observation of
        ``gordo_server_phase_seconds`` and, with tracing on, a span
        under the request's."""
        self.timings.append((name, seconds))
        get_registry().histogram(
            "gordo_server_phase_seconds", "Server request phase durations", ("phase",)
        ).observe(seconds, phase=name)
        tracing.record_span(name, seconds)


class Body:
    """A request's body reader, its content type, whether it carries the
    router's adopt header, and its :class:`RequestContext`."""

    def __init__(self, read: Callable[[], bytes], content_type: Optional[str] = None,
                 adopt: bool = False, ctx: Optional[RequestContext] = None):
        self._read = read
        self.content_type = content_type or ""
        self.adopt = bool(adopt)
        self.ctx = ctx if ctx is not None else RequestContext()

    def __call__(self) -> bytes:
        return self._read()


class Revision(NamedTuple):
    """What one request serves: the revision's name and directory (None
    for a name that cannot be served)."""

    name: str
    directory: Optional[str]


class GordoApp:
    """WSGI application serving one collection of port artifacts."""

    def __init__(
        self,
        collection_dir: Optional[str] = None,
        device: DeviceLike = None,
        batch_wait_ms: Optional[float] = None,
        batch_queue_limit: Optional[int] = None,
        scorer_cache_size: Optional[int] = None,
        stream_max_sessions: Optional[int] = None,
        stream_max_backlog: Optional[int] = None,
        stream_idle_s: Optional[float] = None,
        shard_manifest: Optional[str] = None,
        replica_id: Optional[str] = None,
        enable_prometheus: Optional[bool] = None,
    ):
        self.device = resolve_device(device)
        #: process start, the uptime epoch of /telemetry/snapshot
        self._started_at = time.time()
        self.prometheus_metrics = None
        if _setting(enable_prometheus, ENABLE_PROMETHEUS):
            from gordo_tpu_torch.server.prometheus.metrics import GordoServerPrometheusMetrics

            self.prometheus_metrics = GordoServerPrometheusMetrics()
        shard_manifest = _setting(shard_manifest, SHARD_MANIFEST)
        shard = None
        if shard_manifest:
            shard = ShardSpec.load(shard_manifest, _setting(replica_id, REPLICA_ID) or None)
            logger.info("Serving shard %s of replica set %s", shard.replica_id,
                        list(shard.ring.replicas))
        # a directory, or a symlink resolved on every request
        self.collection_dir = collection_dir or os.environ[MODEL_COLLECTION_DIR_ENV_VAR]
        # the real directory the symlink pointed at when last resolved
        self._served_latest: Optional[str] = None
        self._served_latest_lock = threading.Lock()
        # keyed by (real directory of the revision, model name)
        self._models: Dict[Tuple[str, str], Any] = {}
        self._metadata: Dict[Tuple[str, str], dict] = {}
        self._lock = threading.Lock()
        tuned = {"batch_wait_ms": batch_wait_ms, "batch_queue_limit": batch_queue_limit,
                 "scorer_cache_size": scorer_cache_size}
        #: the tuned settings the collection's profile gave: {knob: value}
        self.tuning_applied = resolve_tuned_options(tuned, self.collection_dir,
                                                    SERVER_TUNED_OPTIONS, subsystem="server")
        self.catalog = ServingCatalog(
            scorer_cache_size=tuned["scorer_cache_size"],
            batch_wait_s=tuned["batch_wait_ms"] / 1000.0,
            batch_queue_limit=tuned["batch_queue_limit"],
            stream_max_sessions=_setting(stream_max_sessions, STREAM_MAX_SESSIONS),
            stream_max_backlog=_setting(stream_max_backlog, STREAM_MAX_BACKLOG),
            stream_idle_after_s=_setting(stream_idle_s, STREAM_IDLE_S),
            device=self.device,
            shard=shard,
        )

    # -- WSGI plumbing -----------------------------------------------------
    def __call__(self, environ, start_response):
        response = self.dispatch(
            environ.get("REQUEST_METHOD", "GET"),
            environ.get("PATH_INFO", "/") or "/",
            lambda: _read_body(environ),
            query_string=environ.get("QUERY_STRING", ""),
            revision=environ.get("HTTP_REVISION"),
            content_type=environ.get("CONTENT_TYPE"),
            adopt=bool(environ.get("HTTP_" + ADOPT_HEADER.upper().replace("-", "_"))),
            traceparent=environ.get("HTTP_TRACEPARENT"),
        )
        headers = [
            ("Content-Type", response.mimetype),
            ("Content-Length", str(len(response.body))),
            *response.headers.items(),
        ]
        status = f"{response.status} {_STATUS_TEXT.get(response.status, '')}".strip()
        start_response(status, headers)
        return [response.body]

    #: probes: their spans would be noise (a liveness poll every few
    #: seconds), and they are no traffic for the ledger or the request
    #: metrics; a probe's traceparent is still echoed
    _TRACE_EXEMPT_PATHS = frozenset({"/healthcheck", "/healthz", "/metrics",
                                     "/telemetry/snapshot"})
    #: views whose JSON keeps its schema: the revision rides the header only
    _REVISION_BODY_EXEMPT = frozenset({"specs", "telemetry_snapshot"})

    def dispatch(
        self,
        method: str,
        path: str,
        read_body: Callable[[], bytes],
        query_string: str = "",
        revision: Optional[str] = None,
        content_type: Optional[str] = None,
        adopt: bool = False,
        traceparent: Optional[str] = None,
    ) -> Response:
        """One request: ``revision`` is the ``revision`` header's value; a
        ``revision`` in ``query_string`` takes precedence over it;
        ``adopt`` whether the router's adopt header came with it;
        ``traceparent`` the W3C trace-context header's value."""
        ctx = RequestContext()
        read_body = Body(read_body, content_type, adopt, ctx)
        incoming = tracing.parse_traceparent(traceparent)
        if path in self._TRACE_EXEMPT_PATHS:
            ctx.trace_id = incoming.trace_id if incoming is not None else ""
            ctx.ledger = attribution.NOOP_LEDGER
            return self._dispatch_traced(method, path, read_body, query_string, revision,
                                         tracing.NOOP_SPAN)
        with tracing.start_span("server.request", parent=incoming, method=method,
                                path=path) as span:
            ctx.trace_id = span.trace_id or (incoming.trace_id if incoming is not None else "")
            # the ledger is the thread's sink: the scorer and the
            # estimators add transfer and device seconds to it
            with ctx.ledger.activate():
                return self._dispatch_traced(method, path, read_body, query_string, revision,
                                             span)

    def _dispatch_traced(self, method: str, path: str, read_body: Body, query_string: str,
                         revision: Optional[str], span) -> Response:
        ctx = read_body.ctx
        view = url_args = None
        served = None
        try:
            # routing and revision resolution are the request's admission:
            # ``parse`` time, as the body's decode
            with ctx.ledger.phase("parse"):
                view, url_args = self._match(method, path)
                served = current = self._current_revision()
                if view is not None:
                    requested = (parse_qs(query_string).get("revision", [None])[0]
                                 or revision)
                    if requested:
                        directory = resolve_sibling_revision(current.directory, requested)
                        served = Revision(requested, directory)
            if view is None:
                response = url_args  # the 404/405 reply
            elif served.directory is None:
                response = _json_response(
                    {"error": f"Revision '{served.name}' not found."}, 410
                )
            else:
                response = getattr(self, f"view_{view}")(served, read_body, **url_args)
        except ApiError as exc:
            response = _json_response(exc.payload, exc.status)
        except batching.BatchQueueFull as exc:
            response = _json_response(
                {
                    "error": str(exc),
                    "queue_depth": exc.queue_depth,
                    "queue_limit": exc.queue_limit,
                    "retry_after_s": exc.retry_after_s,
                },
                503,
            )
            response.headers["Retry-After"] = str(exc.retry_after_s)
        except stream_session.StreamShed as exc:
            stream_session.count_update("shed")
            emit_event("stream_update_shed", retry_after_s=exc.retry_after_s)
            response = _json_response({"error": str(exc), "retry_after_s": exc.retry_after_s},
                                      503)
            response.headers["Retry-After"] = str(exc.retry_after_s)
        except stream_session.StreamGone as exc:
            # the reconnect contract: the client replays its window tail
            stream_session.count_update("resume_required")
            response = _json_response(
                {
                    "error": str(exc),
                    "stream_resume": {"reason": exc.reason, "machines": exc.machines},
                    "transient": True,
                    "retry_after_s": 1,
                },
                409,
            )
        except faults.InjectedFault as exc:
            # the ``serve`` and ``batch`` fault sites: a 503 that a chaos
            # run tells apart from a real server error
            response = _json_response({"error": f"Fault injection: {exc}"}, 503)
        except Exception:
            logger.error("Unhandled server error:\n%s", traceback.format_exc())
            response = _json_response(
                {"error": "Something unexpected happened; check your input data"}, 500
            )
        span.set_attribute("endpoint", view or "unmatched")
        span.set_attribute("status_code", response.status)
        if response.status >= 500:
            span.set_status("error")
        return self._finalize(method, path, ctx, served, view, response)

    def _finalize(self, method: str, path: str, ctx: RequestContext,
                  served: Optional[Revision], view: Optional[str],
                  response: Response) -> Response:
        """Stamp the revision, encode the JSON body, close the ledger and
        write ``Server-Timing``, the pid and the trace id."""
        stamped = served is not None and served.directory is not None  # a 410 names none
        if stamped:
            if response.payload is not None and view not in self._REVISION_BODY_EXEMPT:
                response.payload["revision"] = served.name
            response.headers["revision"] = served.name
        if response.payload is not None:
            # ``serialize`` as the JAX server's: the stamped JSON of a
            # matched route (its 404, 410 and exempt bodies are not timed)
            timed = stamped and view is not None and view not in self._REVISION_BODY_EXEMPT
            with ctx.ledger.phase("serialize") if timed else contextlib.nullcontext():
                response.body = json.dumps(response.payload, default=str).encode()
        runtime_s = timeit.default_timer() - ctx.start_time
        # the ledger's phases that the coarse entries do not carry join
        # Server-Timing (``queue`` rides its own entry)
        already_timed = {name for name, _ in ctx.timings}
        summary = ctx.ledger.finish(span=tracing.current_span(), wall_s=runtime_s)
        for name, seconds in (summary.get("phases") or {}).items():
            if name not in already_timed:
                ctx.record_phase(name, seconds)
        # dur in milliseconds, as the header's spec says; the legacy
        # ``request_walltime_s`` keeps its seconds
        entries = [f"{name};dur={seconds * 1000.0:.2f}" for name, seconds in ctx.timings]
        entries.append(f"total;dur={runtime_s * 1000.0:.2f}")
        entries.append(f"request_walltime_s;dur={runtime_s}")
        response.headers["Server-Timing"] = ", ".join(entries)
        response.headers["X-Gordo-Server-Pid"] = str(os.getpid())
        if ctx.trace_id:
            # on every reply, errors too: a casualty the client reports
            # can be found in this server's span and event logs
            response.headers[tracing.TRACE_ID_RESPONSE_HEADER] = ctx.trace_id
        if self.prometheus_metrics is not None and path not in self._TRACE_EXEMPT_PATHS:
            self.prometheus_metrics.observe(method, path, view or "unmatched", response.status,
                                            runtime_s)
        return response

    def _current_revision(self) -> Revision:
        """The revision served unless a request names another: the
        collection directory, or the directory its symlink points at now
        (the trailing separator is stripped for the link check only)."""
        directory = self.collection_dir
        if os.path.islink(directory.rstrip(os.sep) or os.sep):
            directory = os.path.realpath(directory)
            self._note_revision_roll(directory)
        return Revision(os.path.basename(os.path.normpath(directory)), directory)

    def _note_revision_roll(self, latest_real: str) -> None:
        """On the first request after the symlink was re-pointed, stop the
        batchers and expire the stream sessions of other revisions (model
        and scorer caches are keyed by the real directory, so the old
        entries only age out)."""
        with self._served_latest_lock:
            previous = self._served_latest
            if previous == latest_real:
                return
            # a request that resolved the link before a flip and gets here
            # after a later one noted the new target is dropped: the served
            # revision only moves forward
            if previous is not None and os.path.realpath(self.collection_dir) != latest_real:
                return
            self._served_latest = latest_real
        if previous is None:
            return  # the first request of the process: nothing rolled
        n_stopped = self.catalog.stop_stale_batchers(latest_real)
        n_streams = self.catalog.expire_stale_streams(latest_real)
        get_registry().counter(
            "gordo_server_revision_rolls_total",
            "Hot promotions observed by this server (latest symlink flips)",
        ).inc()
        emit_event("revision_rolled", previous=os.path.basename(previous),
                   current=os.path.basename(latest_real), n_batchers_stopped=n_stopped,
                   n_streams_expired=n_streams)
        logger.info(
            "Revision rolled: now serving %s as latest (was %s); %d stale batcher(s) stopped, "
            "%d stream session(s) expired", latest_real, previous, n_stopped, n_streams,
        )

    @staticmethod
    def _match(method: str, path: str) -> Tuple[Optional[str], Any]:
        allowed = False
        for route_method, pattern, view in _COMPILED_ROUTES:
            match = pattern.match(path)
            if match:
                if route_method == method:
                    return view, match.groupdict()
                allowed = True
        if allowed:
            return None, _json_response({"error": f"Method {method} not allowed"}, 405)
        return None, _json_response({"error": f"No route for {path}"}, 404)

    # -- model/metadata loading --------------------------------------------
    @staticmethod
    def _artifact_dir(served: Revision, name: str) -> str:
        if name.startswith(".") or os.sep in name:
            raise ApiError({"error": f"Model '{name}' not found"}, 404)
        return os.path.join(served.directory, name)

    @staticmethod
    def _model_missing(served: Revision, name: str) -> ApiError:
        return ApiError({"error": f"Model '{name}' not found in revision {served.name}"}, 404)

    def _get_model(self, served: Revision, name: str, ctx: Optional[RequestContext] = None):
        """The machine's model, loaded once onto the app's device; with a
        request's ``ctx``, its ``model_load`` phase (the cache lookup once
        loaded), as the JAX server times every load."""
        start = timeit.default_timer()
        key = (os.path.realpath(served.directory), name)
        with self._lock:
            model = self._models.get(key)
            if model is None:
                try:
                    model = serializer.load(self._artifact_dir(served, name), self.device)
                except FileNotFoundError:
                    raise self._model_missing(served, name) from None
                self._models[key] = model
        if ctx is not None:
            ctx.record_phase("model_load", timeit.default_timer() - start)
        return model

    def _get_metadata(self, served: Revision, name: str) -> dict:
        key = (os.path.realpath(served.directory), name)
        with self._lock:
            metadata = self._metadata.get(key)
            if metadata is None:
                try:
                    metadata = serializer.load_metadata(self._artifact_dir(served, name))
                except FileNotFoundError:
                    raise ApiError(
                        {"error": f"Metadata for '{name}' not found"}, 404
                    ) from None
                self._metadata[key] = metadata
        return metadata

    @staticmethod
    def _tags(metadata: dict) -> Tuple[List[str], List[str]]:
        dataset = metadata["dataset"]
        tags = tag_names(dataset["tag_list"])
        targets = tag_names(dataset.get("target_tag_list") or [])
        return tags, targets or tags

    @staticmethod
    def _json_body(read_body):
        """The request's JSON body, or None when it is not JSON."""
        try:
            return json.loads(read_body() or b"null")
        except ValueError:
            return None

    def _extract(self, read_body, metadata: dict):
        tags, target_tags = self._tags(metadata)
        with read_body.ctx.ledger.phase("parse"):
            X, y = server_utils.extract_X_y(self._json_body(read_body), tags, target_tags)
        return tags, target_tags, X, y

    # -- casualties and shards ---------------------------------------------
    def _refuse_wrong_shard(self, read_body, names) -> None:
        """421 for machines of another replica's shard, unless the
        router's adopt header routed them here (a no-op unsharded)."""
        self.catalog.refuse_wrong_shard(names, adopt=read_body.adopt)

    def _refuse_unavailable(self, served: Revision, names) -> None:
        """409 when a requested machine is a casualty of the revision's
        build (``build_report.json``), with the JAX server's body."""
        unavailable = self.catalog.unavailable_machines(served.directory)
        bad = {name: unavailable[name] for name in names if name in unavailable}
        if bad:
            raise ApiError(
                {
                    "error": "Machine(s) unavailable in this revision: "
                    + ", ".join(f"{name} ({info['reason']})" for name, info in sorted(bad.items())),
                    "unavailable": bad,
                },
                409,
            )

    # -- views -------------------------------------------------------------
    def view_specs(self, served: Revision, read_body) -> Response:
        """The OpenAPI 3.0.3 document of the routes this server serves."""
        return _json_response(openapi_document(_ROUTES, "gordo-tpu model server"))

    def view_healthcheck(self, served: Revision, read_body) -> Response:
        return Response(b"", 200)

    def view_server_version(self, served: Revision, read_body) -> Response:
        return _json_response({"version": __version__})

    def view_metrics(self, served: Revision, read_body) -> Response:
        """The request metrics and the process registry in the Prometheus
        text format; 404 unless the app was built with them."""
        if self.prometheus_metrics is None:
            return _json_response({"error": "Prometheus metrics are not enabled"}, 404)
        return Response(self.prometheus_metrics.exposition(), 200,
                        mimetype=prom_text.CONTENT_TYPE)

    def view_telemetry_snapshot(self, served: Revision, read_body) -> Response:
        """This replica's registry and identity, versioned
        (``rollup.snapshot_payload``), with the ``/healthz`` status."""
        status, _ = self._readiness()
        shard = self.catalog.shard
        return _json_response(rollup.snapshot_payload(
            role="replica",
            replica_id=shard.replica_id if shard is not None else None,
            revision=served.name,
            status=status,
            registry=get_registry(),
            started_at=self._started_at,
        ))

    def view_healthz(self, served: Revision, read_body) -> Response:
        """Readiness, the JAX server's body: 200 while the server can take
        work; 503 with ``Retry-After`` while a batcher is saturated or has
        just shed, or a stream session's backlog is saturated."""
        payload, retry_after = self._readiness()
        if retry_after is None:
            return _json_response(payload)
        response = _json_response(payload, 503)
        response.headers["Retry-After"] = str(retry_after)
        return response

    def _readiness(self) -> Tuple[dict, Optional[float]]:
        """The ``/healthz`` body and its Retry-After (None while the
        server takes work)."""
        stats = self.catalog.batcher_stats()
        overloaded = [s for s in stats if s["saturated"] or s["shedding"]]
        streams = self.catalog.stream_stats()
        overloaded += [s for s in streams if s["saturated"]]
        payload = {
            "status": "overloaded" if overloaded else "ok",
            "batching": {
                "enabled": self.catalog.batch_wait_s > 0,
                "batch_wait_ms": self.catalog.batch_wait_s * 1000.0,
                "queue_limit": self.catalog.batch_queue_limit,
                "batchers": len(stats),
                "queue_depth": sum(s["queue_depth"] for s in stats),
                "sheds_total": sum(s["sheds_total"] for s in stats),
                "shedding": any(s["shedding"] for s in stats),
            },
            "streaming": {
                "sessions": len(streams),
                "max_sessions": self.catalog.streams.max_sessions,
                "max_backlog": self.catalog.streams.max_backlog,
                "backlog": sum(s["pending"] for s in streams),
                "saturated_sessions": sum(s["saturated"] for s in streams),
            },
        }
        if not overloaded:
            return payload, None
        return payload, max(s["retry_after_s"] for s in overloaded)

    def view_models(self, served: Revision, read_body, gordo_project: str) -> Response:
        """The revision's machines (a sharded replica's: its shard's);
        casualties of its build are listed under ``unavailable`` instead,
        with their reasons, and a sharded replica names its shard."""
        catalog = self.catalog
        unavailable = catalog.unavailable_machines(served.directory)
        payload: Dict[str, Any] = {"models": list(catalog.servable_machines(served.directory))}
        # by ring ownership, not presence on disk: a casualty of the fetch
        # has no artifact but belongs to one shard all the same
        mine = {name: info for name, info in unavailable.items()
                if catalog.shard is None or catalog.shard.owns(name)}
        if mine:
            payload["unavailable"] = mine
        if catalog.shard is not None:
            payload["shard"] = catalog.shard.to_dict()
        return _json_response(payload)

    def view_revisions(self, served: Revision, read_body, gordo_project: str) -> Response:
        """The sibling real directories of the served revision: no dot
        entries, no symlinks, no files. ``latest`` is the revision the app
        serves when none is named."""
        latest = self._current_revision().name
        parent = os.path.join(served.directory, "..")
        try:
            available = sorted(
                name
                for name in os.listdir(parent)
                if not name.startswith(".")
                and os.path.isdir(os.path.join(parent, name))
                and not os.path.islink(os.path.join(parent, name))
            )
        except FileNotFoundError:
            available = [latest]
        return _json_response({"latest": latest, "available-revisions": available})

    def view_expected_models(self, served: Revision, read_body, gordo_project: str) -> Response:
        """``$EXPECTED_MODELS`` as a JSON list; ``[]`` when it is unset."""
        return _json_response(
            {"expected-models": json.loads(os.environ.get(EXPECTED_MODELS_ENV_VAR, "[]"))}
        )

    def view_metadata(
        self, served: Revision, read_body, gordo_project: str, gordo_name: str
    ) -> Response:
        return _json_response(
            {
                "gordo-server-version": __version__,
                "metadata": self._get_metadata(served, gordo_name),
                "env": {MODEL_COLLECTION_DIR_ENV_VAR: self.collection_dir},
            }
        )

    def view_download_model(
        self, served: Revision, read_body, gordo_project: str, gordo_name: str
    ) -> Response:
        """The model's artifact as one gzipped tar of its three files
        (``serializer.dumps``; ``serializer.loads`` reads it back). The
        JAX route sends a pickle; the port's artifacts are never pickled."""
        try:
            body = serializer.dumps(self._artifact_dir(served, gordo_name))
        except FileNotFoundError:
            raise self._model_missing(served, gordo_name) from None
        response = Response(body, 200, mimetype="application/octet-stream")
        response.headers["Content-Disposition"] = "attachment; filename=model.tar.gz"
        return response

    @staticmethod
    def _inner_seconds(ctx: RequestContext) -> float:
        """The transfer and device seconds the request's ledger holds."""
        return ctx.ledger.phases.get("transfer", 0.0) + ctx.ledger.phases.get("device", 0.0)

    def view_prediction(
        self, served: Revision, read_body, gordo_project: str, gordo_name: str
    ) -> Response:
        ctx = read_body.ctx
        self._refuse_unavailable(served, [gordo_name])
        self._refuse_wrong_shard(read_body, [gordo_name])
        faults.inject("serve", gordo_name)
        model = self._get_model(served, gordo_name, ctx)
        tags, target_tags, X, _ = self._extract(
            read_body, self._get_metadata(served, gordo_name)
        )
        start = timeit.default_timer()
        # ``transform`` is the predict's host remainder: its time less
        # the transfer and device seconds the estimator recorded
        inner_before = self._inner_seconds(ctx)
        try:
            output = get_model_output(model, X)
        except ValueError as err:
            return _json_response({"error": f"ValueError: {err}"}, 400)
        except Exception:
            logger.error("Failed to predict:\n%s", traceback.format_exc())
            return _json_response(
                {"error": "Something unexpected happened; check your input data"}, 400
            )
        elapsed = timeit.default_timer() - start
        ctx.record_phase("predict", elapsed)
        ctx.ledger.add("transform",
                       max(0.0, elapsed - (self._inner_seconds(ctx) - inner_before)))
        with ctx.ledger.phase("postprocess"):
            data = make_base_dataframe(
                tags=tags,
                model_input=X.values,
                model_output=output,
                target_tag_list=target_tags,
                index=X.index,
            )
        with ctx.ledger.phase("serialize"):
            data = server_utils.dataframe_to_dict(data)
        return _json_response(
            {
                "data": data,
                "time-seconds": f"{timeit.default_timer() - ctx.start_time:.4f}",
            }
        )

    def view_anomaly_prediction(
        self, served: Revision, read_body, gordo_project: str, gordo_name: str
    ) -> Response:
        ctx = read_body.ctx
        self._refuse_unavailable(served, [gordo_name])
        self._refuse_wrong_shard(read_body, [gordo_name])
        faults.inject("serve", gordo_name)
        model = self._get_model(served, gordo_name, ctx)
        metadata = self._get_metadata(served, gordo_name)
        _, _, X, y = self._extract(read_body, metadata)
        if y is None:
            return _json_response(
                {"message": "Cannot perform anomaly without 'y' to compare against."},
                400,
            )
        frequency = server_utils.resolution_to_timedelta(
            metadata["dataset"].get("resolution", "10min")
        )
        start = timeit.default_timer()
        # the anomaly call's host remainder (transforms, statistic,
        # thresholds) is ``postprocess``
        inner_before = self._inner_seconds(ctx)
        try:
            anomaly = model.anomaly(X, y, frequency=frequency)
        except AttributeError:
            return _json_response(
                {
                    "message": "Model is not an AnomalyDetector, it is of type: "
                    f"{type(model)}"
                },
                422,
            )
        except ValueError as err:
            return _json_response({"error": f"ValueError: {err}"}, 400)
        elapsed = timeit.default_timer() - start
        ctx.record_phase("predict", elapsed)
        ctx.ledger.add("postprocess",
                       max(0.0, elapsed - (self._inner_seconds(ctx) - inner_before)))
        with ctx.ledger.phase("serialize"):
            data = server_utils.dataframe_to_dict(anomaly)
        return _json_response(
            {
                "data": data,
                "time-seconds": f"{timeit.default_timer() - ctx.start_time:.4f}",
            }
        )

    # -- fleet routes --------------------------------------------------------
    @staticmethod
    def _fleet_request_machines(read_body) -> Optional[dict]:
        """The body's ``machines`` mapping, or None when it has none."""
        if read_body.content_type.startswith("multipart/"):
            raise ApiError(
                {
                    "error": "Multipart (parquet) fleet bodies are not supported by this "
                    'server; post JSON {"machines": {<name>: <frame>}}'
                },
                400,
            )
        body = GordoApp._json_body(read_body)
        machines = body.get("machines") if isinstance(body, dict) else None
        return machines if isinstance(machines, dict) and machines else None

    @staticmethod
    def _parse_fleet_frame(raw, columns: List[str]):
        """A machine's posted frame (dict or list of rows), verified
        against its columns."""
        return server_utils.verify_dataframe(server_utils.dataframe_from_dict(raw), columns)

    def _fleet_scorer(self, served: Revision, names=(), ctx: Optional[RequestContext] = None
                      ) -> Tuple[tuple, tuple]:
        """(the machines scored, the (scorer, prefixes, fallback) over all
        of them): the revision's servable machines (a sharded replica's
        shard), with any of ``names`` it adopts. One scorer a revision,
        whatever machines a request names: each group's weights are
        stacked once, a request for the whole group or a subset that
        rounds up to it scatters into that stack, a smaller one gathers
        from it, and requests for different machines coalesce in one
        batcher."""
        servable = self.catalog.servable_machines(served.directory)
        adopted = sorted(set(names) - set(servable))
        if adopted:
            servable = tuple(sorted((*servable, *adopted)))
        return servable, self.catalog.fleet_scorer(
            served.directory, servable, lambda name: self._get_model(served, name, ctx)
        )

    def _fleet_predict(self, served: Revision, servable, scorer, inputs: dict,
                       ctx: RequestContext) -> dict:
        """One stacked scoring of ``inputs``: straight through the scorer
        with batching off (no batcher is ever built), else through the
        revision's batcher, whose drainer may coalesce it with concurrent
        requests. A batched request's ``queue`` phase is its whole wait
        less the dispatch's own phases, which the batcher hands back to
        its ledger."""
        if self.catalog.batch_wait_s <= 0:
            return scorer.predict(inputs)
        key = (os.path.realpath(served.directory), servable)
        submitted = timeit.default_timer()
        for _ in range(8):
            try:
                pending = self.catalog.batcher(key, scorer).submit(inputs, ctx.trace_id)
                break
            except batching.BatcherStopped:
                continue  # the batcher was replaced between lookup and submit
        else:
            raise RuntimeError(f"The batcher of revision {served.name!r} kept stopping")
        shared_s = sum(pending.phase_seconds.values())
        queue_s = max(0.0, timeit.default_timer() - submitted - shared_s)
        ctx.record_phase("queue", queue_s)
        attribution.record_current("queue", queue_s)
        for phase, seconds in pending.phase_seconds.items():
            attribution.record_current(phase, seconds)
        span = tracing.current_span()
        if span is not None:
            span.set_attribute("queue_wait_ms", round(pending.queue_wait_s * 1000.0, 3))
            if pending.batch_span_id:
                span.set_attribute("batch_trace_id", pending.batch_trace_id)
                span.set_attribute("batch_span_id", pending.batch_span_id)
                span.set_attribute("batch_n_requests", pending.n_coalesced)
        return pending.outputs

    @staticmethod
    def _record_predict_phase(ctx: RequestContext, elapsed: float) -> None:
        """``predict``, net of the batching ``queue`` entry already timed."""
        queued = sum(seconds for name, seconds in ctx.timings if name == "queue")
        ctx.record_phase("predict", max(0.0, elapsed - queued))

    def _fleet_inputs(self, served: Revision, names, machines, prefixes, fallback, anomaly,
                      ctx: RequestContext):
        """(X frames, y frames, scorer inputs, metadata) of a fleet body,
        or the 400 reply of its first bad entry."""
        frames, targets, inputs, meta = {}, {}, {}, {}
        for name in names:
            metadata = meta[name] = self._get_metadata(served, name)
            tags, target_tags = self._tags(metadata)
            raw = machines[name]
            if anomaly:
                if not isinstance(raw, dict) or "X" not in raw:
                    return _json_response(
                        {"error": f"Machine {name!r} entry must contain 'X'."}, 400
                    )
                if raw.get("y") is None:
                    return _json_response(
                        {
                            "message": "Cannot perform anomaly without 'y' to compare "
                            f"against (machine {name!r})."
                        },
                        400,
                    )
            try:
                with ctx.ledger.phase("parse"):
                    if anomaly:
                        frames[name] = self._parse_fleet_frame(raw["X"], tags)
                        targets[name] = self._parse_fleet_frame(raw["y"], target_tags)
                    else:
                        frames[name] = self._parse_fleet_frame(raw, tags)
            except (ValueError, ApiError) as err:
                return _json_response({"error": f"Bad input for machine {name!r}: {err}"}, 400)
            if name in fallback:
                continue  # scored by its own predict
            with ctx.ledger.phase("transform"):
                transformed = frames[name].values
                for step in prefixes.get(name, []):
                    transformed = step.transform(transformed)
                inputs[name] = np.asarray(transformed, dtype=np.float32)
        return frames, targets, inputs, meta

    def view_fleet_prediction(self, served: Revision, read_body, gordo_project: str) -> Response:
        """Base predictions of several machines, each architecture group
        scored by one stacked forward: ``{"machines": {name: X}}`` ->
        ``{"data": {name: frame}}``."""
        ctx = read_body.ctx
        with ctx.ledger.phase("parse"):
            machines = self._fleet_request_machines(read_body)
        if machines is None:
            return _json_response(
                {"error": "Body must contain a non-empty 'machines' mapping."}, 400
            )
        names = tuple(sorted(machines))
        self._refuse_unavailable(served, names)
        self._refuse_wrong_shard(read_body, names)
        for name in names:
            faults.inject("serve", name)
        servable, (scorer, prefixes, fallback) = self._fleet_scorer(served, names, ctx)
        parsed = self._fleet_inputs(served, names, machines, prefixes, fallback, False, ctx)
        if isinstance(parsed, Response):
            return parsed
        frames, _, inputs, meta = parsed
        start = timeit.default_timer()
        try:
            outputs = (self._fleet_predict(served, servable, scorer, inputs, ctx)
                       if inputs else {})
            for name in names:
                if name not in outputs:  # no port estimator: its own predict
                    outputs[name] = get_model_output(self._get_model(served, name), frames[name])
        except (batching.BatchQueueFull, faults.InjectedFault):
            raise  # structured 503s, not input errors
        except ValueError as err:
            return _json_response({"error": f"ValueError: {err}"}, 400)
        except Exception:
            logger.error("Fleet prediction failed:\n%s", traceback.format_exc())
            return _json_response(
                {"error": "Something unexpected happened; check your input data"}, 400
            )
        self._record_predict_phase(ctx, timeit.default_timer() - start)
        data = {}
        for name in names:
            tags, target_tags = self._tags(meta[name])
            with ctx.ledger.phase("postprocess"):
                frame = make_base_dataframe(
                    tags=tags,
                    model_input=frames[name].values,
                    model_output=outputs[name],
                    target_tag_list=target_tags,
                    index=frames[name].index,
                )
            with ctx.ledger.phase("serialize"):
                data[name] = server_utils.dataframe_to_dict(frame)
        return _json_response(
            {"data": data, "time-seconds": f"{timeit.default_timer() - ctx.start_time:.4f}"}
        )

    def view_fleet_anomaly_prediction(
        self, served: Revision, read_body, gordo_project: str
    ) -> Response:
        """Anomaly frames of several detectors: ``{"machines": {name: {"X":
        frame, "y": frame}}}``; the base estimators' outputs come from one
        stacked forward a group and feed each detector's ``anomaly``. 422
        when a requested model is not an anomaly detector."""
        ctx = read_body.ctx
        with ctx.ledger.phase("parse"):
            machines = self._fleet_request_machines(read_body)
        if machines is None:
            return _json_response(
                {"error": "Body must contain a non-empty 'machines' mapping."}, 400
            )
        names = tuple(sorted(machines))
        self._refuse_unavailable(served, names)
        self._refuse_wrong_shard(read_body, names)
        for name in names:
            faults.inject("serve", name)
        models = {name: self._get_model(served, name, ctx) for name in names}
        non_anomaly = [n for n, m in models.items() if not isinstance(m, DiffBasedAnomalyDetector)]
        if non_anomaly:
            return _json_response(
                {
                    "message": "Models are not AnomalyDetectors: "
                    + ", ".join(f"{n} ({type(models[n]).__name__})" for n in non_anomaly)
                },
                422,
            )
        servable, (scorer, prefixes, fallback) = self._fleet_scorer(served, names, ctx)
        parsed = self._fleet_inputs(served, names, machines, prefixes, fallback, True, ctx)
        if isinstance(parsed, Response):
            return parsed
        frames, targets, inputs, meta = parsed
        data = {}
        start = timeit.default_timer()
        try:
            outputs = (self._fleet_predict(served, servable, scorer, inputs, ctx)
                       if inputs else {})
            for name in names:
                frequency = server_utils.resolution_to_timedelta(
                    meta[name]["dataset"].get("resolution", "10min")
                )
                # machines the scorer lacks run their own predict inside
                kwargs = {"model_output": outputs[name]} if name in outputs else {}
                with ctx.ledger.phase("postprocess"):
                    frame = models[name].anomaly(
                        frames[name], targets[name], frequency=frequency, **kwargs
                    )
                with ctx.ledger.phase("serialize"):
                    data[name] = server_utils.dataframe_to_dict(frame)
        except (batching.BatchQueueFull, faults.InjectedFault):
            raise  # structured 503s, not input errors
        except ValueError as err:
            return _json_response({"error": f"ValueError: {err}"}, 400)
        except Exception:
            logger.error("Fleet anomaly prediction failed:\n%s", traceback.format_exc())
            return _json_response(
                {"error": "Something unexpected happened; check your input data"}, 400
            )
        self._record_predict_phase(ctx, timeit.default_timer() - start)
        return _json_response(
            {"data": data, "time-seconds": f"{timeit.default_timer() - ctx.start_time:.4f}"}
        )

    # -- streaming sessions --------------------------------------------------
    @staticmethod
    def _stream_machines_spec(body) -> Optional[Dict[str, dict]]:
        """An open body's ``machines`` as ``{name: spec}`` (a list means
        empty specs; the mapping form carries ``resume`` blocks), or None
        when it is missing, empty or malformed."""
        spec = body.get("machines") if isinstance(body, dict) else None
        if isinstance(spec, list) and spec:
            return {str(name): {} for name in spec}
        if isinstance(spec, dict) and spec:
            normalized = {}
            for name, entry in spec.items():
                if entry is not None and not isinstance(entry, dict):
                    return None
                entry = entry or {}
                if entry.get("resume") is not None and not isinstance(entry["resume"], dict):
                    return None
                normalized[str(name)] = entry
            return normalized
        return None

    @staticmethod
    def _stream_transform(steps: list) -> Callable[[np.ndarray], np.ndarray]:
        """A machine's host prefix transformers as the fleet routes apply
        them: raw rows as float64, each step, float32 last (the steps are
        row-wise, so k rows alone transform as inside a larger frame)."""

        def transform(rows: np.ndarray) -> np.ndarray:
            out = np.asarray(rows, dtype="float64")
            for step in steps:
                out = step.transform(out)
            return np.asarray(out, dtype="float32")

        return transform

    def view_stream_open(self, served: Revision, read_body, gordo_project: str) -> Response:
        """Open a session over machines that stay resident on the device::

            {"machines": ["m1", "m2"]}
            {"machines": {"m1": {"resume": {"rows": [[...]], "seq": 40}}}}

        A ``resume`` block is the reconnect contract: ``rows`` are the
        client's replayed window tail (raw), ``seq`` the first one's index;
        they rebuild the resident context and are never scored again. 201
        with the session's id and each machine's cursor and geometry."""
        spec = self._stream_machines_spec(self._json_body(read_body))
        if spec is None:
            return _json_response(
                {"error": "Body must carry a non-empty 'machines' list or mapping."}, 400
            )
        names = tuple(sorted(spec))
        self._refuse_unavailable(served, names)
        self._refuse_wrong_shard(read_body, names)
        models = {name: self._get_model(served, name, read_body.ctx) for name in names}
        _, (scorer, prefixes, fallback) = self._fleet_scorer(served, names, read_body.ctx)
        unstackable = [n for n in names if scorer is None or n in fallback
                       or n not in scorer.names]
        if unstackable:
            return _json_response(
                {
                    "message": "Machine(s) cannot stream (no stacked estimator to keep a "
                    "device-resident window for): " + ", ".join(unstackable)
                },
                422,
            )
        with tracing.start_span("stream.session", n_machines=len(names)) as span:
            streams: Dict[str, stream_session.MachineStream] = {}
            resumed = []
            for name in names:
                geometry = scorer.machine_geometry(name)
                transform = self._stream_transform(prefixes.get(name, []))
                stream = stream_session.MachineStream(
                    name,
                    lookback=geometry["lookback"],
                    lookahead=geometry["lookahead"],
                    n_features=geometry["n_features"],
                    transform=transform,
                    scaler=getattr(models[name], "scaler", None),
                    threshold=getattr(models[name], "aggregate_threshold_", None),
                    device=self.device,
                )
                resume = spec[name].get("resume")
                if resume:
                    rows = np.asarray(resume.get("rows") or [], dtype="float64")
                    if len(rows) and rows.shape[-1] != geometry["n_features"]:
                        return _json_response(
                            {
                                "error": f"Machine {name!r} resume rows carry "
                                f"{rows.shape[-1]} feature column(s), expected "
                                f"{geometry['n_features']}"
                            },
                            400,
                        )
                    stream.window.resume(
                        transform(rows) if len(rows)
                        else rows.reshape(0, geometry["n_features"]),
                        int(resume.get("seq", 0)),
                    )
                    resumed.append(name)
                streams[name] = stream
            session = stream_session.StreamSession(
                stream_session.StreamSession.new_id(),
                os.path.realpath(served.directory),
                served.name,
                streams,
                max_backlog=self.catalog.streams.max_backlog,
            )
            self.catalog.streams.open(session)  # StreamShed: 503
            span.set_attribute("session", session.id)
            span.set_attribute("resumed", bool(resumed))
        emit_event("stream_opened", session=session.id, machines=list(names),
                   revision=served.name, resumed=bool(resumed))
        if resumed:
            emit_event("stream_resumed", session=session.id, machines=resumed,
                       revision=served.name)
        return _json_response(
            {
                "session": session.id,
                "machines": {
                    name: {
                        "seq": streams[name].window.seq,
                        "tail_rows": streams[name].window.context_rows,
                        "lookback": streams[name].window.lookback,
                        "lookahead": streams[name].window.lookahead,
                        "monitored": streams[name].monitorable,
                    }
                    for name in names
                },
            },
            201,
        )

    def view_stream_update(
        self, served: Revision, read_body, gordo_project: str, stream_id: str
    ) -> Response:
        """Push one update and score it::

            {"updates": {"m1": {"rows": [[...]], "seq": 40[, "y": [[...]]]}}}

        Each machine's outputs for its new rows come back inline (the
        reply is the stream's backpressure). A session the server no
        longer holds, a revision roll and a sequence gap answer the 409
        resume contract; a saturated backlog 503 with ``Retry-After``."""
        session = self.catalog.streams.require(stream_id)
        if session.collection_dir != os.path.realpath(served.directory):
            # the served revision moved: never score old windows with new weights
            self.catalog.streams.close(stream_id)
            raise stream_session.StreamGone("revision_rolled", session.names)
        burst_weight = 1
        action = faults.stream_fault_action(session.names)
        if action is not None:
            mode, value = action
            if mode == "drop":
                self.catalog.streams.close(stream_id)
                stream_session.emit_closed(session, "chaos_drop")
                raise stream_session.StreamGone("dropped", session.names)
            if mode == "stall":
                time.sleep(value)
            elif mode == "burst":
                burst_weight = max(1, int(value))
        body = self._json_body(read_body)
        updates = body.get("updates") if isinstance(body, dict) else None
        if not isinstance(updates, dict) or not updates:
            return _json_response({"error": "Body must carry a non-empty 'updates' mapping."},
                                  400)
        for name, payload in updates.items():
            if not isinstance(payload, dict) or "rows" not in payload:
                return _json_response(
                    {"error": f"Update for machine {name!r} must carry 'rows'."}, 400
                )
        session.admit(burst_weight)  # StreamShed: 503
        try:
            servable, (scorer, _, _) = self._fleet_scorer(served, session.names, read_body.ctx)
            with tracing.start_span("stream.update", session=stream_id,
                                    n_machines=len(updates)) as span:
                try:
                    results = session.apply_update(
                        updates,
                        dispatch=lambda inputs: self._fleet_predict(
                            served, servable, scorer, inputs, read_body.ctx),
                    )
                except (KeyError, ValueError) as err:
                    return _json_response({"error": str(err)}, 400)
                except stream_session.StreamGone:
                    # a gap ends this session: drop it now, so it neither
                    # holds its windows nor sheds the reconnect that
                    # replaces it
                    self.catalog.streams.close(stream_id)
                    raise
                span.set_attribute("transferred_rows", session.last_transfer_rows)
                span.set_attribute("resident_rows", session.last_resident_rows)
        finally:
            session.release(burst_weight)
        return _json_response({"session": session.id, "scores": results})

    def view_stream_close(
        self, served: Revision, read_body, gordo_project: str, stream_id: str
    ) -> Response:
        """Close a session; closing an unknown or expired one succeeds too."""
        session = self.catalog.streams.close(stream_id)
        if session is not None:
            stream_session.emit_closed(session, "client")
        return _json_response({"session": stream_id, "closed": session is not None})


def _read_body(environ) -> bytes:
    try:
        length = int(environ.get("CONTENT_LENGTH") or 0)
    except ValueError:
        length = 0
    return environ["wsgi.input"].read(length) if length > 0 else b""


def build_app(collection_dir: Optional[str] = None, device: DeviceLike = None,
              **settings) -> GordoApp:
    """The WSGI app over ``collection_dir`` (default: ``$MODEL_COLLECTION_DIR``)
    on ``device`` (the card unless ``"cpu"`` is asked for); ``settings``:
    ``batch_wait_ms``, ``batch_queue_limit``, ``scorer_cache_size``,
    ``stream_max_sessions``, ``stream_max_backlog``, ``stream_idle_s``
    (else ``GORDO_BATCH_WAIT_MS``, ``GORDO_BATCH_QUEUE_LIMIT``,
    ``GORDO_SCORER_CACHE_SIZE``, ``GORDO_STREAM_MAX_SESSIONS``,
    ``GORDO_STREAM_MAX_BACKLOG``, ``GORDO_STREAM_IDLE_S``, else 0, 64, 16,
    64, 8 and 30; the first three take the collection's
    ``tuning_profile.json`` before their default, ``tuning/profile.py``);
    ``shard_manifest`` and ``replica_id`` (else ``GORDO_SHARD_MANIFEST``
    and ``GORDO_REPLICA_ID``; unset: the whole collection);
    ``enable_prometheus`` (else ``ENABLE_PROMETHEUS``, else off).
    ``GORDO_PROFILE_HZ`` starts the sampling wall profiler here
    (``observability/sampling.py``; one environment lookup when unset)."""
    sampling.maybe_start_from_env()
    return GordoApp(collection_dir, device, **settings)
