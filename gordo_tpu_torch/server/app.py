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

A sharded replica (``shard_manifest``, ``GORDO_SHARD_MANIFEST``; its id
``replica_id``, ``GORDO_REPLICA_ID``) serves the consistent-hash share of
the collection that the ring gives it (``router/ring.py``): ``/models``
lists its shard, its fleet scorers stack its shard's machines, and a
prediction or stream route naming a machine of another shard answers a
421 naming the owner, unless the request carries the router's
``X-Gordo-Shard-Adopt`` header (failover, hedging). The router
(``gordo_tpu_torch.router``) fronts such replicas.
"""

import json
import logging
import os
import re
import threading
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
from gordo_tpu_torch.server import batching
from gordo_tpu_torch.server import utils as server_utils
from gordo_tpu_torch.server.catalog import ADOPT_HEADER, ServingCatalog, ShardSpec
from gordo_tpu_torch.server.utils import ApiError
from gordo_tpu_torch.streaming import session as stream_session

logger = logging.getLogger(__name__)

MODEL_COLLECTION_DIR_ENV_VAR = "MODEL_COLLECTION_DIR"
EXPECTED_MODELS_ENV_VAR = "EXPECTED_MODELS"
#: serving settings: (environment variable, type, default); an explicit
#: argument of the app wins over the variable
BATCH_WAIT_MS = ("GORDO_BATCH_WAIT_MS", float, 0.0)
BATCH_QUEUE_LIMIT = ("GORDO_BATCH_QUEUE_LIMIT", int, 64)
SCORER_CACHE_SIZE = ("GORDO_SCORER_CACHE_SIZE", int, 16)
STREAM_MAX_SESSIONS = ("GORDO_STREAM_MAX_SESSIONS", int, stream_session.DEFAULT_MAX_SESSIONS)
STREAM_MAX_BACKLOG = ("GORDO_STREAM_MAX_BACKLOG", int, stream_session.DEFAULT_MAX_BACKLOG)
STREAM_IDLE_S = ("GORDO_STREAM_IDLE_S", float, stream_session.DEFAULT_IDLE_AFTER_S)
SHARD_MANIFEST = ("GORDO_SHARD_MANIFEST", str, "")
REPLICA_ID = ("GORDO_REPLICA_ID", str, "")

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


class Body:
    """A request's body reader, its content type, and whether it carries
    the router's adopt header."""

    def __init__(self, read: Callable[[], bytes], content_type: Optional[str] = None,
                 adopt: bool = False):
        self._read = read
        self.content_type = content_type or ""
        self.adopt = bool(adopt)

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
    ):
        self.device = resolve_device(device)
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
        self.catalog = ServingCatalog(
            scorer_cache_size=_setting(scorer_cache_size, SCORER_CACHE_SIZE),
            batch_wait_s=_setting(batch_wait_ms, BATCH_WAIT_MS) / 1000.0,
            batch_queue_limit=_setting(batch_queue_limit, BATCH_QUEUE_LIMIT),
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
        )
        headers = [
            ("Content-Type", response.mimetype),
            ("Content-Length", str(len(response.body))),
            *response.headers.items(),
        ]
        status = f"{response.status} {_STATUS_TEXT.get(response.status, '')}".strip()
        start_response(status, headers)
        return [response.body]

    def dispatch(
        self,
        method: str,
        path: str,
        read_body: Callable[[], bytes],
        query_string: str = "",
        revision: Optional[str] = None,
        content_type: Optional[str] = None,
        adopt: bool = False,
    ) -> Response:
        """One request: ``revision`` is the ``revision`` header's value; a
        ``revision`` in ``query_string`` takes precedence over it;
        ``adopt`` whether the router's adopt header came with it."""
        read_body = Body(read_body, content_type, adopt)
        view, url_args = self._match(method, path)
        served = current = self._current_revision()
        try:
            if view is None:
                response = url_args  # the 404/405 reply
            else:
                requested = parse_qs(query_string).get("revision", [None])[0] or revision
                if requested:
                    directory = resolve_sibling_revision(current.directory, requested)
                    served = Revision(requested, directory)
                if served.directory is None:
                    response = _json_response(
                        {"error": f"Revision '{requested}' not found."}, 410
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
            response = _json_response({"error": str(exc), "retry_after_s": exc.retry_after_s},
                                      503)
            response.headers["Retry-After"] = str(exc.retry_after_s)
        except stream_session.StreamGone as exc:
            # the reconnect contract: the client replays its window tail
            response = _json_response(
                {
                    "error": str(exc),
                    "stream_resume": {"reason": exc.reason, "machines": exc.machines},
                    "transient": True,
                    "retry_after_s": 1,
                },
                409,
            )
        except Exception:
            logger.error("Unhandled server error:\n%s", traceback.format_exc())
            response = _json_response(
                {"error": "Something unexpected happened; check your input data"}, 500
            )
        if served.directory is not None:  # a 410 names no revision
            # the OpenAPI document keeps its schema: the revision rides
            # the header only
            if response.payload is not None and view != "specs":
                response.payload["revision"] = served.name
            response.headers["revision"] = served.name
        if response.payload is not None:
            response.body = json.dumps(response.payload, default=str).encode()
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

    def _get_model(self, served: Revision, name: str):
        key = (os.path.realpath(served.directory), name)
        with self._lock:
            model = self._models.get(key)
            if model is None:
                try:
                    model = serializer.load(self._artifact_dir(served, name), self.device)
                except FileNotFoundError:
                    raise self._model_missing(served, name) from None
                self._models[key] = model
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

    def view_healthz(self, served: Revision, read_body) -> Response:
        """Readiness, the JAX server's body: 200 while the server can take
        work; 503 with ``Retry-After`` while a batcher is saturated or has
        just shed, or a stream session's backlog is saturated."""
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
            return _json_response(payload)
        response = _json_response(payload, 503)
        response.headers["Retry-After"] = str(max(s["retry_after_s"] for s in overloaded))
        return response

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

    def view_prediction(
        self, served: Revision, read_body, gordo_project: str, gordo_name: str
    ) -> Response:
        start = timeit.default_timer()
        self._refuse_unavailable(served, [gordo_name])
        self._refuse_wrong_shard(read_body, [gordo_name])
        model = self._get_model(served, gordo_name)
        tags, target_tags, X, _ = self._extract(
            read_body, self._get_metadata(served, gordo_name)
        )
        try:
            output = model.predict(X)
        except ValueError as err:
            return _json_response({"error": f"ValueError: {err}"}, 400)
        except Exception:
            logger.error("Failed to predict:\n%s", traceback.format_exc())
            return _json_response(
                {"error": "Something unexpected happened; check your input data"}, 400
            )
        data = make_base_dataframe(
            tags=tags,
            model_input=X.values,
            model_output=output,
            target_tag_list=target_tags,
            index=X.index,
        )
        return _json_response(
            {
                "data": server_utils.dataframe_to_dict(data),
                "time-seconds": f"{timeit.default_timer() - start:.4f}",
            }
        )

    def view_anomaly_prediction(
        self, served: Revision, read_body, gordo_project: str, gordo_name: str
    ) -> Response:
        start = timeit.default_timer()
        self._refuse_unavailable(served, [gordo_name])
        self._refuse_wrong_shard(read_body, [gordo_name])
        model = self._get_model(served, gordo_name)
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
        return _json_response(
            {
                "data": server_utils.dataframe_to_dict(anomaly),
                "time-seconds": f"{timeit.default_timer() - start:.4f}",
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

    def _fleet_scorer(self, served: Revision, names=()) -> Tuple[tuple, tuple]:
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
            served.directory, servable, lambda name: self._get_model(served, name)
        )

    def _fleet_predict(self, served: Revision, servable, scorer, inputs: dict) -> dict:
        """One stacked scoring of ``inputs``: straight through the scorer
        with batching off (no batcher is ever built), else through the
        revision's batcher, whose drainer may coalesce it with concurrent
        requests."""
        if self.catalog.batch_wait_s <= 0:
            return scorer.predict(inputs)
        key = (os.path.realpath(served.directory), servable)
        for _ in range(8):
            try:
                return self.catalog.batcher(key, scorer).submit(inputs).outputs
            except batching.BatcherStopped:
                continue  # the batcher was replaced between lookup and submit
        raise RuntimeError(f"The batcher of revision {served.name!r} kept stopping")

    def _fleet_inputs(self, served: Revision, names, machines, prefixes, fallback, anomaly):
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
                if anomaly:
                    frames[name] = self._parse_fleet_frame(raw["X"], tags)
                    targets[name] = self._parse_fleet_frame(raw["y"], target_tags)
                else:
                    frames[name] = self._parse_fleet_frame(raw, tags)
            except (ValueError, ApiError) as err:
                return _json_response({"error": f"Bad input for machine {name!r}: {err}"}, 400)
            if name in fallback:
                continue  # scored by its own predict
            transformed = frames[name].values
            for step in prefixes.get(name, []):
                transformed = step.transform(transformed)
            inputs[name] = np.asarray(transformed, dtype=np.float32)
        return frames, targets, inputs, meta

    def view_fleet_prediction(self, served: Revision, read_body, gordo_project: str) -> Response:
        """Base predictions of several machines, each architecture group
        scored by one stacked forward: ``{"machines": {name: X}}`` ->
        ``{"data": {name: frame}}``."""
        start = timeit.default_timer()
        machines = self._fleet_request_machines(read_body)
        if machines is None:
            return _json_response(
                {"error": "Body must contain a non-empty 'machines' mapping."}, 400
            )
        names = tuple(sorted(machines))
        self._refuse_unavailable(served, names)
        self._refuse_wrong_shard(read_body, names)
        models = {name: self._get_model(served, name) for name in names}
        servable, (scorer, prefixes, fallback) = self._fleet_scorer(served, names)
        parsed = self._fleet_inputs(served, names, machines, prefixes, fallback, anomaly=False)
        if isinstance(parsed, Response):
            return parsed
        frames, _, inputs, meta = parsed
        try:
            outputs = self._fleet_predict(served, servable, scorer, inputs) if inputs else {}
            for name in names:
                if name not in outputs:  # no port estimator: its own predict
                    outputs[name] = models[name].predict(frames[name])
        except batching.BatchQueueFull:
            raise
        except ValueError as err:
            return _json_response({"error": f"ValueError: {err}"}, 400)
        except Exception:
            logger.error("Fleet prediction failed:\n%s", traceback.format_exc())
            return _json_response(
                {"error": "Something unexpected happened; check your input data"}, 400
            )
        data = {}
        for name in names:
            tags, target_tags = self._tags(meta[name])
            frame = make_base_dataframe(
                tags=tags,
                model_input=frames[name].values,
                model_output=outputs[name],
                target_tag_list=target_tags,
                index=frames[name].index,
            )
            data[name] = server_utils.dataframe_to_dict(frame)
        return _json_response(
            {"data": data, "time-seconds": f"{timeit.default_timer() - start:.4f}"}
        )

    def view_fleet_anomaly_prediction(
        self, served: Revision, read_body, gordo_project: str
    ) -> Response:
        """Anomaly frames of several detectors: ``{"machines": {name: {"X":
        frame, "y": frame}}}``; the base estimators' outputs come from one
        stacked forward a group and feed each detector's ``anomaly``. 422
        when a requested model is not an anomaly detector."""
        start = timeit.default_timer()
        machines = self._fleet_request_machines(read_body)
        if machines is None:
            return _json_response(
                {"error": "Body must contain a non-empty 'machines' mapping."}, 400
            )
        names = tuple(sorted(machines))
        self._refuse_unavailable(served, names)
        self._refuse_wrong_shard(read_body, names)
        models = {name: self._get_model(served, name) for name in names}
        non_anomaly = [n for n, m in models.items() if not isinstance(m, DiffBasedAnomalyDetector)]
        if non_anomaly:
            return _json_response(
                {
                    "message": "Models are not AnomalyDetectors: "
                    + ", ".join(f"{n} ({type(models[n]).__name__})" for n in non_anomaly)
                },
                422,
            )
        servable, (scorer, prefixes, fallback) = self._fleet_scorer(served, names)
        parsed = self._fleet_inputs(served, names, machines, prefixes, fallback, anomaly=True)
        if isinstance(parsed, Response):
            return parsed
        frames, targets, inputs, meta = parsed
        data = {}
        try:
            outputs = self._fleet_predict(served, servable, scorer, inputs) if inputs else {}
            for name in names:
                frequency = server_utils.resolution_to_timedelta(
                    meta[name]["dataset"].get("resolution", "10min")
                )
                # machines the scorer lacks run their own predict inside
                kwargs = {"model_output": outputs[name]} if name in outputs else {}
                frame = models[name].anomaly(
                    frames[name], targets[name], frequency=frequency, **kwargs
                )
                data[name] = server_utils.dataframe_to_dict(frame)
        except batching.BatchQueueFull:
            raise
        except ValueError as err:
            return _json_response({"error": f"ValueError: {err}"}, 400)
        except Exception:
            logger.error("Fleet anomaly prediction failed:\n%s", traceback.format_exc())
            return _json_response(
                {"error": "Something unexpected happened; check your input data"}, 400
            )
        return _json_response(
            {"data": data, "time-seconds": f"{timeit.default_timer() - start:.4f}"}
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
        models = {name: self._get_model(served, name) for name in names}
        _, (scorer, prefixes, fallback) = self._fleet_scorer(served, names)
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
        streams: Dict[str, stream_session.MachineStream] = {}
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
                            "error": f"Machine {name!r} resume rows carry {rows.shape[-1]} "
                            f"feature column(s), expected {geometry['n_features']}"
                        },
                        400,
                    )
                stream.window.resume(
                    transform(rows) if len(rows) else rows.reshape(0, geometry["n_features"]),
                    int(resume.get("seq", 0)),
                )
            streams[name] = stream
        session = stream_session.StreamSession(
            stream_session.StreamSession.new_id(),
            os.path.realpath(served.directory),
            served.name,
            streams,
            max_backlog=self.catalog.streams.max_backlog,
        )
        self.catalog.streams.open(session)  # StreamShed: 503
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
        session.admit()  # StreamShed: 503
        try:
            servable, (scorer, _, _) = self._fleet_scorer(served, session.names)
            try:
                results = session.apply_update(
                    updates,
                    dispatch=lambda inputs: self._fleet_predict(served, servable, scorer, inputs),
                )
            except (KeyError, ValueError) as err:
                return _json_response({"error": str(err)}, 400)
            except stream_session.StreamGone:
                # a gap ends this session: drop it now, so it neither holds
                # its windows nor sheds the reconnect that replaces it
                self.catalog.streams.close(stream_id)
                raise
        finally:
            session.release()
        return _json_response({"session": session.id, "scores": results})

    def view_stream_close(
        self, served: Revision, read_body, gordo_project: str, stream_id: str
    ) -> Response:
        """Close a session; closing an unknown or expired one succeeds too."""
        session = self.catalog.streams.close(stream_id)
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
    64, 8 and 30); ``shard_manifest`` and ``replica_id`` (else
    ``GORDO_SHARD_MANIFEST`` and ``GORDO_REPLICA_ID``; unset: the whole
    collection)."""
    return GordoApp(collection_dir, device, **settings)
