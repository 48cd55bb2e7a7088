"""
The router (the port of ``gordo_tpu.router.app``): a WSGI app with the
surface of one ``run-server`` process in front of N replicas that each
serve a shard of one collection (``run-server --shard-manifest``).

- Single-machine routes go to the machine's ring owner, or, while the
  owner is ejected, to its first routable successor with the adopt
  header (``server/catalog.py``); a 421 from a replica whose manifest
  has drifted is retried once with the header.
- Fleet routes split the posted machines by owner (successors for
  ejected owners), call the shards at once, and join the frames into one
  reply. ``HEDGE_MS`` above 0 sends a straggling shard's call once more
  to the next routable successor; the first answer wins.
- A replica's health is a circuit breaker (``router/health.py``) fed by
  the calls' outcomes and by ``/healthz`` probes of ejected replicas. A
  machine whose every candidate replica is ejected, or whose shard call
  failed, comes back in a 409 marked ``transient`` that names it and its
  owner; build casualties answer 409 as from one server, from the same
  ``build_report.json``.
- A replica's 503 and its ``Retry-After`` pass through; past
  ``MAX_INFLIGHT`` requests the router sheds at its own door (503).
- ``GET /router/replicas`` shows the membership and health; ``POST`` it
  (``{"replicas": {id: url}}``) swaps the membership: a new ring, held
  streams answer the resume contract on their next update.
- The three ``stream/`` routes: the client sees one session; the router
  holds a sub-session on each replica that owns some of its machines.
- A pinned revision (``?revision=`` or the ``revision`` header) is
  forwarded to the replicas as a query parameter.

The router holds no model and needs no card: it reads the collection's
directory and build report (``CollectionView``) and calls the replicas
with ``http.client``, over keep-alive connections kept per replica. The
JAX router's ``/metrics``, ``/status`` and ``/telemetry/snapshot``, its
``replica:`` fault grammar, events and tracing spans are not ported
(ROADMAP.md queue 1 item 9): the three routes answer 404 saying so.
"""

import http.client
import json
import logging
import os
import socket
import threading
import time
import timeit
import traceback
import uuid
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeout
from concurrent.futures import wait as futures_wait
from typing import Dict, List, Optional, Sequence, Tuple
from urllib.parse import parse_qs, urlencode, urlsplit

from gordo_tpu_torch import __version__, serializer
from gordo_tpu_torch.router.health import ReplicaHealthTracker
from gordo_tpu_torch.router.ring import DEFAULT_VNODES, HashRing
from gordo_tpu_torch.server.app import (
    _STATUS_TEXT,
    Body,
    GordoApp,
    Response,
    compile_routes,
    resolve_sibling_revision,
)
from gordo_tpu_torch.server.catalog import ADOPT_HEADER, CollectionView
from gordo_tpu_torch.server.utils import ApiError

logger = logging.getLogger(__name__)

MODEL_COLLECTION_DIR_ENV_VAR = "MODEL_COLLECTION_DIR"
#: the router's settings and their defaults (the JAX router's)
DEFAULTS = {
    "REPLICAS": {},
    "VNODES": DEFAULT_VNODES,
    #: consecutive failures that eject a replica
    "EJECT_AFTER": 3,
    #: the scale on the 8/16/32 s ejection windows
    "BACKOFF_SCALE": 0.25,
    #: seconds between /healthz probes of ejected replicas; 0: no prober
    #: (a window's end re-admits a replica by itself)
    "PROBE_INTERVAL_S": 1.0,
    #: a shard call silent this long is sent once more to the next
    #: routable successor; 0: no hedging
    "HEDGE_MS": 0.0,
    "REPLICA_TIMEOUT_S": 30.0,
    #: requests in flight past this are shed with 503
    "MAX_INFLIGHT": 64,
    #: where the collection is; None reads MODEL_COLLECTION_DIR per request
    "COLLECTION_DIR": None,
    #: how replicas are called (``HttpTransport``), replaceable in tests
    "TRANSPORT": None,
}
#: the JAX router's routes that wait for the port's telemetry
UNPORTED_ROUTES = ("/metrics", "/status", "/telemetry/snapshot")
#: bounds on the router's table of held streams: opens purge proxies idle
#: past the window, and the table never outgrows the count
STREAM_PROXY_BOUND = 4096
STREAM_PROXY_IDLE_S = 900.0

_PROJECT = "/gordo/v0/<gordo_project>"
_MACHINE = _PROJECT + "/<gordo_name>"
_ROUTES = [
    ("GET", "/healthcheck", "healthcheck"),
    ("GET", "/healthz", "healthz"),
    ("GET", "/server-version", "server_version"),
    ("GET", "/router/replicas", "replicas"),
    ("POST", "/router/replicas", "set_replicas"),
    ("GET", _PROJECT + "/models", "models"),
    ("GET", _PROJECT + "/revisions", "revisions"),
    ("GET", _MACHINE + "/metadata", "metadata"),
    ("GET", _MACHINE + "/healthcheck", "metadata"),
    ("GET", _MACHINE + "/download-model", "proxy_get"),
    ("POST", _MACHINE + "/prediction", "single_prediction"),
    ("POST", _MACHINE + "/anomaly/prediction", "single_prediction"),
    ("POST", _PROJECT + "/prediction/fleet", "fleet_prediction"),
    ("POST", _PROJECT + "/anomaly/prediction/fleet", "fleet_prediction"),
    ("POST", _PROJECT + "/stream/open", "stream_open"),
    ("POST", _PROJECT + "/stream/<stream_id>/update", "stream_update"),
    ("POST", _PROJECT + "/stream/<stream_id>/close", "stream_close"),
]
_COMPILED_ROUTES = compile_routes(_ROUTES)


class Reply:
    """A replica's answer: status, headers (names lower-cased), body."""

    def __init__(self, status: int, headers: Dict[str, str], body: bytes):
        self.status = status
        self.headers = headers
        self.body = body

    def json(self):
        return json.loads(self.body or b"null")


class HttpTransport:
    """Calls replicas over ``http.client`` connections kept alive and
    pooled per replica (a connection serves one call at a time). A call
    on a pooled connection that the replica has since closed is sent
    again, once, on a fresh one."""

    def __init__(self):
        self._idle: Dict[Tuple[str, int], List[http.client.HTTPConnection]] = {}
        self._lock = threading.Lock()

    def request(self, method: str, url: str, body: Optional[bytes] = None,
                headers: Optional[Dict[str, str]] = None, timeout: float = 30.0) -> Reply:
        parts = urlsplit(url)
        key = (parts.hostname, parts.port or 80)
        target = parts.path + (f"?{parts.query}" if parts.query else "")
        for attempt in (0, 1):
            with self._lock:
                pool = self._idle.setdefault(key, [])
                conn = pool.pop() if pool else None
            reused = conn is not None
            try:
                if conn is None:
                    conn = http.client.HTTPConnection(key[0], key[1], timeout=timeout)
                    conn.connect()
                    # http.client sends the headers and the body in two
                    # writes: without this the body waits for the
                    # replica's delayed ACK of the headers
                    conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                conn.request(method, target, body=body, headers=headers or {})
                resp = conn.getresponse()
                data = resp.read()
            except (ConnectionError, http.client.HTTPException, OSError):
                conn.close()
                if reused and attempt == 0:
                    continue  # the replica closed the idle connection
                raise
            if resp.will_close:
                conn.close()
            else:
                with self._lock:
                    self._idle.setdefault(key, []).append(conn)
            return Reply(resp.status, {k.lower(): v for k, v in resp.getheaders()}, data)
        raise ConnectionError(f"no connection to {url}")  # not reached

    def close(self) -> None:
        with self._lock:
            pools, self._idle = self._idle, {}
        for pool in pools.values():
            for conn in pool:
                conn.close()


class Request:
    """One request to the router."""

    def __init__(self, method: str, path: str, body: bytes = b"", query_string: str = "",
                 headers: Optional[Dict[str, str]] = None):
        self.method = method
        self.path = path
        self.body = body
        self.args = {k: v[0] for k, v in parse_qs(query_string).items()}
        self.headers = {k.lower(): v for k, v in (headers or {}).items()}
        self.content_type = self.headers.get("content-type", "")

    def json(self):
        try:
            return json.loads(self.body or b"null")
        except ValueError:
            return None


def _json_response(payload: dict, status: int = 200) -> Response:
    """A JSON reply of the router's own, encoded once its revision is
    stamped (``RouterApp._finalize``)."""
    return Response(status=status, mimetype="application/json", payload=payload)


class _Ctx:
    """A request's revision: the served directory, its name, and the
    revision the caller pinned (forwarded to every replica call)."""

    def __init__(self):
        self.start = timeit.default_timer()
        self.collection_dir = ""
        self.current_revision = ""
        self.revision = ""
        self.requested_revision = ""

    def forward_params(self, request: Request) -> dict:
        params = dict(request.args)
        if self.requested_revision and "revision" not in params:
            params["revision"] = self.requested_revision
        return params


class _StreamProxy:
    """A router-held stream session: one id for the client, a sub-session
    on each replica that serves some of its machines. ``stale`` (a replica
    failed mid-update, or the membership changed) makes the next update
    answer the resume contract."""

    __slots__ = ("sid", "machines", "subs", "stale", "last_active", "project", "params")

    def __init__(self, sid: str, machines: List[str], subs: list, project: str, params: dict):
        self.sid = sid
        self.machines = machines
        #: [{"rid", "url", "sid", "machines"}]
        self.subs = subs
        self.stale = False
        self.last_active = time.monotonic()
        self.project = project
        self.params = params


class _ShardResult:
    """One shard call's outcome: ok | unavailable | overloaded | refused
    | wrong_shard | error."""

    __slots__ = ("kind", "replica", "payload", "status", "retry_after")

    def __init__(self, kind, replica, payload=None, status=None, retry_after=None):
        self.kind = kind
        self.replica = replica
        self.payload = payload
        self.status = status
        self.retry_after = retry_after


class RouterApp:
    """WSGI router in front of N shard replicas (module note)."""

    def __init__(self, config: Optional[dict] = None):
        self.config = dict(DEFAULTS, **(config or {}))
        replicas = dict(self.config.get("REPLICAS") or {})
        if not replicas:
            raise ValueError(
                "RouterApp needs at least one replica (REPLICAS config / run-router --replica id=url)"
            )
        self.vnodes = int(self.config["VNODES"] or DEFAULT_VNODES)
        self._membership_lock = threading.Lock()
        self._replicas = replicas
        self._ring = HashRing(sorted(replicas), self.vnodes)
        probe_interval = float(self.config["PROBE_INTERVAL_S"] or 0.0)
        self.health = ReplicaHealthTracker(
            sorted(replicas), eject_after=int(self.config["EJECT_AFTER"] or 3),
            backoff_scale=float(self.config["BACKOFF_SCALE"] or 0.25),
            lazy_half_open=probe_interval <= 0,
        )
        # the casualties and machines of the collection, from its files
        self.catalog = CollectionView()
        self.hedge_s = float(self.config["HEDGE_MS"] or 0.0) / 1000.0
        self.replica_timeout_s = float(self.config["REPLICA_TIMEOUT_S"] or 30.0)
        self.max_inflight = int(self.config["MAX_INFLIGHT"] or 64)
        self._inflight = threading.BoundedSemaphore(self.max_inflight)
        self.transport = self.config["TRANSPORT"] or HttpTransport()
        # a moving mean of request seconds: the Retry-After of a shed
        self._ema_lock = threading.Lock()
        self._ema_request_s = 0.25
        self._streams: Dict[str, _StreamProxy] = {}
        self._streams_lock = threading.Lock()
        self._stopping = threading.Event()
        self._prober: Optional[threading.Thread] = None
        if probe_interval > 0:
            self._prober = threading.Thread(target=self._probe_loop, args=(probe_interval,),
                                            name="gordo-router-prober", daemon=True)
            self._prober.start()

    # -- membership ------------------------------------------------------
    def routing_view(self) -> Tuple[Dict[str, str], HashRing]:
        """The (replicas, ring) a request routes by, taken once at its
        start: a membership change never re-partitions a request in
        flight."""
        with self._membership_lock:
            return self._replicas, self._ring

    def set_replicas(self, replicas: Dict[str, str]) -> None:
        """Swap the membership: a new ring; removed replicas drain (their
        calls in flight finish), added ones take their share on the next
        request, and every held stream answers the resume contract."""
        if not replicas:
            raise ValueError("Replica set cannot be empty")
        ring = HashRing(sorted(replicas), self.vnodes)
        # tracked before the ring is published: a new replica must not look
        # ejected to a request that already routes by the new ring
        self.health.ensure(replicas)
        with self._membership_lock:
            previous = set(self._replicas)
            self._replicas = dict(replicas)
            self._ring = ring
        for rid in sorted(previous - set(replicas)):
            self.health.forget(rid)
        with self._streams_lock:
            for proxy in self._streams.values():
                proxy.stale = True
        logger.info("Router membership: %s", sorted(replicas))

    def close(self) -> None:
        self._stopping.set()
        if self._prober is not None:
            self._prober.join(timeout=5.0)
            self._prober = None
        if hasattr(self.transport, "close"):
            self.transport.close()

    # -- health probing --------------------------------------------------
    def _probe_loop(self, interval: float) -> None:
        while not self._stopping.wait(interval):
            self.probe_ejected()

    def probe_ejected(self) -> None:
        """``/healthz`` of each ejected replica whose window has passed; a
        200 moves it to probation."""
        replicas, _ = self.routing_view()
        for rid, base_url in replicas.items():
            if self.health.probe_due(rid):
                self.health.note_probe(rid, self._probe_replica(base_url))

    def _probe_replica(self, base_url: str) -> bool:
        try:
            reply = self.transport.request("GET", f"{base_url}/healthz",
                                           timeout=min(3.0, self.replica_timeout_s))
        except Exception:
            return False
        # a 503 is "alive but melting": not ready yet
        return 200 <= reply.status < 300

    # -- WSGI plumbing -----------------------------------------------------
    def __call__(self, environ, start_response):
        try:
            length = int(environ.get("CONTENT_LENGTH") or 0)
        except ValueError:
            length = 0
        body = environ["wsgi.input"].read(length) if length > 0 else b""
        headers = {key[5:].replace("_", "-").lower(): value for key, value in environ.items()
                   if key.startswith("HTTP_")}
        if environ.get("CONTENT_TYPE"):
            headers["content-type"] = environ["CONTENT_TYPE"]
        response = self.dispatch(environ.get("REQUEST_METHOD", "GET"),
                                  environ.get("PATH_INFO", "/") or "/", body,
                                  environ.get("QUERY_STRING", ""), headers)
        status = f"{response.status} {_STATUS_TEXT.get(response.status, '')}".strip()
        start_response(status, [("Content-Type", response.mimetype),
                                ("Content-Length", str(len(response.body))),
                                *response.headers.items()])
        return [response.body]

    def dispatch(self, method: str, path: str, body: bytes = b"", query_string: str = "",
                 headers: Optional[Dict[str, str]] = None) -> Response:
        request = Request(method, path, body, query_string, headers)
        ctx = _Ctx()
        try:
            view, url_args = self._match(method, path)
            if view is None:
                response = url_args
            else:
                response = self._resolve_revision(ctx, request) or getattr(
                    self, f"view_{view}")(ctx, request, **url_args)
        except ApiError as exc:
            response = _json_response(exc.payload, exc.status)
            retry_after = exc.payload.get("retry_after_s")
            if retry_after is not None:
                response.headers["Retry-After"] = str(retry_after)
        except Exception:
            logger.error("Unhandled router error:\n%s", traceback.format_exc())
            response = _json_response({"error": "Something unexpected happened in the router"},
                                      500)
        return self._finalize(ctx, response)

    @staticmethod
    def _match(method: str, path: str):
        if path.rstrip("/") in UNPORTED_ROUTES:
            return None, _json_response(
                {"error": f"{path} is not ported yet (ROADMAP.md queue 1 item 9)"}, 404)
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

    def _resolve_revision(self, ctx: _Ctx, request: Request) -> Optional[Response]:
        """The server's revision rules on the same directory: the
        collection (a symlink resolved on every request), or the sibling
        ``?revision=`` or the ``revision`` header names (410 if none)."""
        pointer = self.config["COLLECTION_DIR"] or os.environ.get(MODEL_COLLECTION_DIR_ENV_VAR)
        if not pointer:
            return _json_response(
                {"error": f"{MODEL_COLLECTION_DIR_ENV_VAR} is not set on the router process"
                          " — start it with `run-router --collection-dir PATH`"},
                503,
            )
        ctx.collection_dir = pointer
        if os.path.islink(pointer.rstrip(os.sep) or os.sep):
            ctx.collection_dir = os.path.realpath(pointer)
        ctx.current_revision = os.path.basename(os.path.normpath(ctx.collection_dir))
        requested = request.args.get("revision") or request.headers.get("revision")
        if requested:
            resolved = resolve_sibling_revision(ctx.collection_dir, requested)
            if resolved is None:
                return _json_response({"error": f"Revision '{requested}' not found."}, 410)
            ctx.revision = ctx.requested_revision = requested
            ctx.collection_dir = resolved
        else:
            ctx.revision = ctx.current_revision
        return None

    @staticmethod
    def _finalize(ctx: _Ctx, response: Response) -> Response:
        """The server's revision stamp on the body and header, and the
        router's own Server-Timing entry after the replica's. A replica's
        JSON reply that carries the ``revision`` header has the stamp in
        its body too (the server sets both), so only one without is read
        again."""
        if ctx.revision and response.payload is not None:
            response.payload.setdefault("revision", ctx.revision)
        elif (ctx.revision and response.mimetype == "application/json"
              and "revision" not in response.headers):
            try:
                data = json.loads(response.body or b"null")
                if isinstance(data, dict) and "revision" not in data:
                    data["revision"] = ctx.revision
                    response.body = json.dumps(data).encode()
            except ValueError:
                pass
        if response.payload is not None:
            response.body = json.dumps(response.payload, default=str).encode()
        if ctx.revision:
            response.headers.setdefault("revision", ctx.revision)
        entry = f"router_total;dur={(timeit.default_timer() - ctx.start) * 1000.0:.2f}"
        existing = response.headers.get("Server-Timing")
        response.headers["Server-Timing"] = f"{existing}, {entry}" if existing else entry
        return response

    # -- admission control -------------------------------------------------
    def _admit(self) -> None:
        if not self._inflight.acquire(blocking=False):
            raise ApiError(
                {
                    "error": "Router at max in-flight requests; retry later",
                    "max_inflight": self.max_inflight,
                    "retry_after_s": round(max(0.1, 2.0 * self._ema_request_s), 2),
                },
                503,
            )

    def _release(self, started: float) -> None:
        self._inflight.release()
        elapsed = timeit.default_timer() - started
        with self._ema_lock:
            self._ema_request_s += 0.2 * (elapsed - self._ema_request_s)

    def _admitted(self, call, *args):
        self._admit()
        started = timeit.default_timer()
        try:
            return call(*args)
        finally:
            self._release(started)

    # -- routing -----------------------------------------------------------
    def _candidates(self, name: str, ring: HashRing, replicas: Dict[str, str]
                    ) -> Tuple[List[str], str]:
        """(routable replicas in ring order, the true owner); empty when
        every candidate is ejected."""
        preference = [r for r in ring.preference(name) if r in replicas]
        owner = preference[0] if preference else ""
        return [r for r in preference if self.health.routable(r)], owner

    def _refuse_unavailable(self, ctx: _Ctx, names) -> None:
        """Build casualties answer 409 as from one server, before any
        replica is called."""
        unavailable = self.catalog.unavailable_machines(ctx.collection_dir)
        bad = {n: unavailable[n] for n in names if n in unavailable}
        if bad:
            raise ApiError(
                {
                    "error": "Machine(s) unavailable in this revision: "
                    + ", ".join(f"{name} ({info['reason']})" for name, info in sorted(bad.items())),
                    "unavailable": bad,
                },
                409,
            )

    def _replica_call(self, rid: str, base_url: str, method: str, path: str, params=None,
                      body: Optional[bytes] = None, headers=None) -> Reply:
        """One call to a replica, its outcome recorded in the breaker: a
        transport error (raised) and a 5xx other than 503 count against
        it."""
        url = f"{base_url}{path}" + (f"?{urlencode(params)}" if params else "")
        try:
            reply = self.transport.request(method, url, body=body, headers=dict(headers or {}),
                                           timeout=self.replica_timeout_s)
        except Exception:
            self.health.record_failure(rid)
            raise
        if reply.status >= 500 and reply.status != 503:
            self.health.record_failure(rid)
        else:
            self.health.record_success(rid)
        return reply

    @staticmethod
    def _passthrough(reply: Reply) -> Response:
        """A replica's reply forwarded as it is, with the headers that
        matter."""
        out = Response(reply.body, reply.status,
                       reply.headers.get("content-type", "application/json").split(";")[0])
        for header in ("revision", "Retry-After", "Server-Timing", "Content-Disposition"):
            value = reply.headers.get(header.lower())
            if value:
                out.headers[header] = value
        return out

    def _shard_retry_after(self, replicas: Sequence[str]) -> float:
        """When the replicas' ejection windows end: the Retry-After of
        their shards' casualties."""
        waits = [self.health.retry_after_s(r) for r in replicas if r]
        return round(max(waits), 2) if any(waits) else 1.0

    def _transient_unavailable_payload(self, machines_to_owner: Dict[str, str], why: str) -> dict:
        unavailable = {
            name: {"reason": "replica_unavailable", "replica": owner,
                   "retry_after_s": self._shard_retry_after([owner])}
            for name, owner in machines_to_owner.items()
        }
        return {
            "error": "Machine(s) temporarily unroutable: " + ", ".join(sorted(machines_to_owner))
            + f" ({why})",
            "unavailable": unavailable,
            # not a casualty of the revision: the client may ask again
            "transient": True,
            "retry_after_s": max(info["retry_after_s"] for info in unavailable.values()),
        }

    # -- views: from the collection's files ------------------------------
    def view_healthcheck(self, ctx, request) -> Response:
        return Response(b"", 200, "text/plain")

    def view_server_version(self, ctx, request) -> Response:
        return _json_response({"version": __version__, "role": "router"})

    def view_replicas(self, ctx, request) -> Response:
        replicas, ring = self.routing_view()
        return _json_response({"replicas": replicas, "vnodes": ring.vnodes,
                               "health": self.health.snapshot()})

    def view_set_replicas(self, ctx, request) -> Response:
        body = request.json()
        replicas = body.get("replicas") if isinstance(body, dict) else None
        if not isinstance(replicas, dict) or not replicas:
            return _json_response(
                {"error": "Body must carry a non-empty 'replicas' mapping of id -> base URL."},
                400)
        self.set_replicas({str(k): str(v) for k, v in replicas.items()})
        return self.view_replicas(ctx, request)

    def view_healthz(self, ctx, request) -> Response:
        """Ready while any replica is routable; 503 with ``Retry-After``
        while none is."""
        replicas, _ = self.routing_view()
        snapshot = self.health.snapshot()
        routable = [r for r in replicas if self.health.routable(r)]
        payload = {"status": "ok" if routable else "no_replicas", "replicas": snapshot,
                   "routable": len(routable), "max_inflight": self.max_inflight}
        if routable:
            return _json_response(payload)
        response = _json_response(payload, 503)
        retry_in = [s["retry_in_s"] for s in snapshot.values() if s["retry_in_s"] > 0]
        response.headers["Retry-After"] = str(round(min(retry_in), 2) if retry_in else 1.0)
        return response

    def view_models(self, ctx, request, gordo_project: str) -> Response:
        """The whole collection's machines, whichever replicas are up."""
        available = self.catalog.list_machines(ctx.collection_dir)
        unavailable = self.catalog.unavailable_machines(ctx.collection_dir)
        payload: dict = {"models": [m for m in available if m not in unavailable]}
        if unavailable:
            payload["unavailable"] = unavailable
        return _json_response(payload)

    def view_revisions(self, ctx, request, gordo_project: str) -> Response:
        parent = os.path.join(ctx.collection_dir, "..")
        try:
            available = sorted(
                name for name in os.listdir(parent)
                if not name.startswith(".") and os.path.isdir(os.path.join(parent, name))
                and not os.path.islink(os.path.join(parent, name))
            )
        except FileNotFoundError:
            available = [ctx.current_revision]
        return _json_response({"latest": ctx.current_revision, "available-revisions": available})

    def view_metadata(self, ctx, request, gordo_project: str, gordo_name: str) -> Response:
        """Metadata from the artifacts themselves: served while every
        replica of the machine's shard is down, and for casualties."""
        if gordo_name.startswith(".") or os.sep in gordo_name:
            return _json_response({"error": f"Metadata for '{gordo_name}' not found"}, 404)
        try:
            metadata = serializer.load_metadata(os.path.join(ctx.collection_dir, gordo_name))
        except FileNotFoundError:
            return _json_response({"error": f"Metadata for '{gordo_name}' not found"}, 404)
        return _json_response({
            "gordo-server-version": __version__,
            "metadata": metadata,
            "env": {MODEL_COLLECTION_DIR_ENV_VAR: self.config["COLLECTION_DIR"]
                    or os.environ.get(MODEL_COLLECTION_DIR_ENV_VAR)},
        })

    # -- views: one machine ----------------------------------------------
    def view_proxy_get(self, ctx, request, gordo_project: str, gordo_name: str) -> Response:
        """``download-model``: to the owner, or a routable successor."""
        replicas, ring = self.routing_view()
        candidates, owner = self._candidates(gordo_name, ring, replicas)
        if not candidates:
            raise ApiError(
                {
                    "error": f"No replica available for machine '{gordo_name}' (owner "
                    f"{owner or 'unknown'} and all successors ejected)",
                    "retry_after_s": self._shard_retry_after([owner]),
                },
                503,
            )
        rid = candidates[0]
        try:
            reply = self._replica_call(rid, replicas[rid], "GET", request.path,
                                       params=ctx.forward_params(request),
                                       headers={ADOPT_HEADER: "failover"} if rid != owner else None)
        except Exception as exc:
            raise ApiError(
                {"error": f"Replica {rid} failed for machine '{gordo_name}': {exc}",
                 "retry_after_s": self._shard_retry_after([rid])},
                503,
            )
        return self._passthrough(reply)

    def view_single_prediction(self, ctx, request, gordo_project: str, gordo_name: str
                               ) -> Response:
        self._refuse_unavailable(ctx, [gordo_name])
        return self._admitted(self._single_prediction, ctx, request, gordo_name)

    def _single_prediction(self, ctx, request, gordo_name: str) -> Response:
        replicas, ring = self.routing_view()
        candidates, owner = self._candidates(gordo_name, ring, replicas)
        if not candidates:
            raise ApiError(self._transient_unavailable_payload(
                {gordo_name: owner}, "every candidate replica is ejected"), 409)
        rid = candidates[0]
        headers = {"Content-Type": request.content_type} if request.content_type else {}
        if rid != owner:
            headers[ADOPT_HEADER] = "failover"
        params = ctx.forward_params(request)
        try:
            reply = self._replica_call(rid, replicas[rid], "POST", request.path, params=params,
                                       body=request.body, headers=headers)
            if reply.status == 421:
                # the replica's manifest and the router's differ (a
                # membership change one side has not seen): adopt once
                reply = self._replica_call(rid, replicas[rid], "POST", request.path,
                                           params=params, body=request.body,
                                           headers={**headers, ADOPT_HEADER: "failover"})
        except Exception as exc:
            raise ApiError(self._transient_unavailable_payload(
                {gordo_name: owner}, f"routed replica {rid} failed ({exc})"), 409)
        # a replica's 503 passes through: its shed load is not sprayed on
        # its peers
        return self._passthrough(reply)

    # -- views: the fleet fan-out ------------------------------------------
    def view_fleet_prediction(self, ctx, request, gordo_project: str) -> Response:
        anomaly = "/anomaly/" in request.path
        machines = GordoApp._fleet_request_machines(
            Body(lambda: request.body, request.content_type))
        if machines is None:
            return _json_response({"error": "Body must contain a non-empty 'machines' mapping."},
                                  400)
        self._refuse_unavailable(ctx, sorted(machines))
        return self._admitted(self._fleet_fanout, ctx, request, machines, anomaly)

    def _route(self, names, replicas: Dict[str, str], ring: HashRing):
        """(replica -> its machines, machine -> owner, machine -> owner of
        those with no routable candidate): each machine to its owner, or
        to the owner's first routable successor."""
        routable = {r for r in replicas if self.health.routable(r)}
        shards: Dict[str, List[str]] = {}
        owners: Dict[str, str] = {}
        dead: Dict[str, str] = {}
        for name in sorted(names):
            owner = ring.owner(name)
            owners[name] = owner
            target = owner if owner in routable else next(
                (r for r in ring.preference(name) if r in routable), None)
            if target is None:
                dead[name] = owner
            else:
                shards.setdefault(target, []).append(name)
        return shards, owners, dead

    def _fleet_fanout(self, ctx, request, machines: dict, anomaly: bool) -> Response:
        replicas, ring = self.routing_view()
        shards, owners, dead = self._route(machines, replicas, ring)
        if dead:
            # before any call: the client may post the rest again at once
            raise ApiError(self._transient_unavailable_payload(
                dead, "every candidate replica is ejected"), 409)
        params = ctx.forward_params(request)
        ordered = sorted(shards.items())
        args = (owners, machines, request, params, replicas, ring)
        if len(ordered) == 1:
            results = [self._call_shard(*ordered[0], *args)]
        else:
            with ThreadPoolExecutor(max_workers=len(ordered)) as pool:
                futures = [pool.submit(self._call_shard, rid, group, *args)
                           for rid, group in ordered]
                results = [f.result() for f in futures]
        return self._join_fleet_results(ctx, ordered, owners, results)

    def _call_shard(self, rid: str, group: List[str], owners, machines, request, params,
                    replicas, ring) -> _ShardResult:
        """One shard's call to its routed replica (hedged when
        ``HEDGE_MS`` is set). A transport failure is not retried elsewhere
        within the request: it feeds the breaker and the shard's machines
        come back as named transient casualties."""
        body = json.dumps({"machines": {name: machines[name] for name in group}}).encode()

        def attempt(replica: str, adopted: bool) -> _ShardResult:
            headers = {"Content-Type": "application/json"}
            if adopted:
                headers[ADOPT_HEADER] = "failover"
            reply = self._replica_call(replica, replicas[replica], "POST", request.path,
                                       params=params, body=body, headers=headers)
            return self._classify_shard_response(replica, reply)

        adopted = any(owners[m] != rid for m in group)
        backup = next((r for r in ring.preference(group[0])
                       if r in replicas and r != rid and self.health.routable(r)),
                      None) if self.hedge_s > 0 else None
        try:
            if backup is not None:
                result = self._hedged_attempt(attempt, rid, backup, adopted)
            else:
                result = attempt(rid, adopted)
            if result.kind == "wrong_shard":
                # manifest drift: adopt once on the same replica
                result = attempt(rid, True)
                if result.kind == "wrong_shard":
                    return _ShardResult("error", rid, payload="replica refuses shard even "
                                        "with adopt header (manifest drift)")
        except Exception as exc:
            return _ShardResult("error", rid, payload=str(exc))
        return result

    def _hedged_attempt(self, attempt, primary: str, backup: str, adopted: bool) -> _ShardResult:
        """One more copy of a straggling shard call to ``backup``; the
        first ok answer wins (predictions are idempotent), the other is
        left to finish in the background."""
        pool = ThreadPoolExecutor(max_workers=2)
        try:
            first = pool.submit(attempt, primary, adopted)
            try:
                return first.result(timeout=self.hedge_s)
            except FutureTimeout:
                pass
            pending = {first, pool.submit(attempt, backup, True)}
            last_exc, last_result = None, None
            while pending:
                done, pending = futures_wait(pending, return_when=FIRST_COMPLETED)
                for future in done:
                    if future.exception() is not None:
                        last_exc = future.exception()
                        continue
                    result = future.result()
                    if result.kind == "ok":
                        return result
                    last_result = result
            if last_result is not None:
                return last_result
            raise last_exc
        finally:
            pool.shutdown(wait=False)

    @staticmethod
    def _classify_shard_response(rid: str, reply: Reply) -> _ShardResult:
        if 200 <= reply.status < 300:
            try:
                return _ShardResult("ok", rid, payload=reply.json())
            except ValueError:
                return _ShardResult("error", rid, payload="unparseable replica response")
        if reply.status == 503:
            try:
                retry_after_s = float(reply.headers.get("retry-after") or 1.0)
            except ValueError:
                retry_after_s = 1.0
            return _ShardResult("overloaded", rid, retry_after=retry_after_s)
        if reply.status == 421:
            return _ShardResult("wrong_shard", rid)
        try:
            body = reply.json()
        except ValueError:
            body = {"error": reply.body[:500].decode(errors="replace")}
        if reply.status == 409:
            detail = body.get("unavailable") if isinstance(body, dict) else None
            return _ShardResult("unavailable", rid, payload=detail or {})
        return _ShardResult("refused", rid, payload=body, status=reply.status)

    def _join_fleet_results(self, ctx, ordered, owners, results) -> Response:
        """The shards' outcomes joined into one reply with the single
        server's contract: the merged data, or the most actionable error
        (a shard's 503, then a deterministic 4xx, then named 409
        casualties). ``ordered`` is the (replica, machines) list the
        results came from, position for position."""
        overloaded = [r for r in results if r.kind == "overloaded"]
        if overloaded:
            retry_after = max(r.retry_after for r in overloaded)
            response = _json_response(
                {"error": "Replica(s) shedding load: "
                          + ", ".join(sorted(r.replica for r in overloaded)),
                 "retry_after_s": retry_after},
                503,
            )
            response.headers["Retry-After"] = str(retry_after)
            return response
        refused = [r for r in results if r.kind == "refused"]
        if refused:
            first = sorted(refused, key=lambda r: r.replica)[0]
            return _json_response(first.payload, first.status)
        data: dict = {}
        casualties: Dict[str, dict] = {}
        all_transient = True
        for result, (rid, group) in zip(results, ordered):
            if result.kind == "ok":
                data.update(result.payload.get("data") or {})
            elif result.kind == "unavailable":
                # the replica's build-report view named casualties
                casualties.update(result.payload or {})
                all_transient = all_transient and not result.payload
            else:  # the whole shard is a transient casualty
                for name in group:
                    owner = owners.get(name, rid)
                    casualties[name] = {"reason": "replica_unavailable", "replica": owner,
                                        "retry_after_s": self._shard_retry_after([owner])}
        if casualties:
            payload: dict = {"error": "Machine(s) unavailable: " + ", ".join(sorted(casualties)),
                             "unavailable": casualties}
            if all_transient:
                payload["transient"] = True
                payload["retry_after_s"] = max(info.get("retry_after_s", 1.0)
                                               for info in casualties.values())
            raise ApiError(payload, 409)
        return _json_response({"data": data,
                               "time-seconds": f"{timeit.default_timer() - ctx.start:.4f}"})

    # -- views: streams ----------------------------------------------------
    def _stream_resume_error(self, reason: str, machines: Sequence[str],
                             replicas: Sequence[str] = ()) -> ApiError:
        """The resume 409, shaped as a replica's own: the client opens a
        new session through the router and replays its window tail."""
        return ApiError(
            {
                "error": f"Stream session gone ({reason})",
                "stream_resume": {"reason": reason, "machines": sorted(machines)},
                "transient": True,
                "retry_after_s": self._shard_retry_after(list(replicas)),
            },
            409,
        )

    @staticmethod
    def _body_of(reply: Reply) -> Optional[dict]:
        try:
            body = reply.json()
        except ValueError:
            return None
        return body if isinstance(body, dict) else None

    def view_stream_open(self, ctx, request, gordo_project: str) -> Response:
        # the server's own parser: the router forwards the normalised form
        spec = GordoApp._stream_machines_spec(request.json() or {})
        if spec is None:
            return _json_response(
                {"error": "Body must carry a non-empty 'machines' list or mapping."}, 400)
        names = sorted(spec)
        self._refuse_unavailable(ctx, names)
        return self._admitted(self._stream_open, ctx, request, gordo_project, spec, names)

    def _stream_open(self, ctx, request, project: str, spec: dict, names) -> Response:
        replicas, ring = self.routing_view()
        shards, owners, dead = self._route(names, replicas, ring)
        if dead:
            raise self._stream_resume_error("every candidate replica is ejected", dead,
                                            dead.values())
        params = ctx.forward_params(request)
        subs: List[dict] = []
        merged: dict = {}
        try:
            for rid, group in sorted(shards.items()):
                headers = {"Content-Type": "application/json"}
                if any(owners[m] != rid for m in group):
                    headers[ADOPT_HEADER] = "failover"
                reply = self._replica_call(
                    rid, replicas[rid], "POST", f"/gordo/v0/{project}/stream/open", params=params,
                    body=json.dumps({"machines": {m: spec[m] for m in group}}).encode(),
                    headers=headers)
                refused = reply.status in (400, 404, 410, 422) or (
                    reply.status == 409 and not (self._body_of(reply) or {}).get("transient"))
                if reply.status == 503 or refused:
                    # a shed, or a refusal that would repeat: as it is
                    self._close_subs(subs, project, params)
                    return self._passthrough(reply)
                if reply.status >= 300:
                    raise IOError(f"replica {rid} refused stream open ({reply.status}): "
                                  f"{reply.body[:300]!r}")
                payload = reply.json()
                subs.append({"rid": rid, "url": replicas[rid], "sid": payload["session"],
                             "machines": list(group)})
                merged.update(payload.get("machines") or {})
        except Exception as exc:
            self._close_subs(subs, project, params)
            raise self._stream_resume_error(f"stream open failed ({exc})", names, shards.keys())
        proxy = _StreamProxy(uuid.uuid4().hex[:16], list(names), subs, project, params)
        evicted: List[_StreamProxy] = []
        with self._streams_lock:
            # proxies a crashed client abandoned go, and the table is bounded
            now = time.monotonic()
            for sid in [s for s, p in self._streams.items()
                        if p.stale or now - p.last_active > STREAM_PROXY_IDLE_S]:
                evicted.append(self._streams.pop(sid))
            while len(self._streams) >= STREAM_PROXY_BOUND:
                evicted.append(self._streams.pop(next(iter(self._streams))))
            self._streams[proxy.sid] = proxy
        for old in evicted:
            self._close_subs(old.subs, old.project, old.params)
        return _json_response({"session": proxy.sid, "machines": merged}, 201)

    def _close_subs(self, subs: List[dict], project: str, params) -> None:
        """Close sub-sessions, best effort: their windows free now."""
        for sub in subs:
            try:
                self._replica_call(sub["rid"], sub["url"], "POST",
                                   f"/gordo/v0/{project}/stream/{sub['sid']}/close",
                                   params=params)
            except Exception:  # cleanup only
                pass

    def view_stream_update(self, ctx, request, gordo_project: str, stream_id: str) -> Response:
        with self._streams_lock:
            proxy = self._streams.get(stream_id)
            if proxy is not None and proxy.stale:
                self._streams.pop(stream_id, None)
        if proxy is None:
            raise self._stream_resume_error("unknown_session", [])
        if proxy.stale:
            self._close_subs(proxy.subs, proxy.project, proxy.params)
            raise self._stream_resume_error("membership_changed", proxy.machines)
        proxy.last_active = time.monotonic()
        body = request.json()
        updates = body.get("updates") if isinstance(body, dict) else None
        if not isinstance(updates, dict) or not updates:
            return _json_response({"error": "Body must carry a non-empty 'updates' mapping."},
                                  400)
        unknown = sorted(set(updates) - set(proxy.machines))
        if unknown:
            return _json_response({"error": f"Machine(s) not in stream session: {unknown}"}, 400)
        return self._admitted(self._stream_fanout, ctx, request, gordo_project, proxy, updates)

    def _stream_fanout(self, ctx, request, project: str, proxy: _StreamProxy, updates: dict
                       ) -> Response:
        params = ctx.forward_params(request)
        jobs = [(sub, {m: updates[m] for m in sub["machines"] if m in updates})
                for sub in proxy.subs]
        jobs = [(sub, payload) for sub, payload in jobs if payload]

        def call(sub, payload):
            return self._replica_call(
                sub["rid"], sub["url"], "POST", f"/gordo/v0/{project}/stream/{sub['sid']}/update",
                params=params, body=json.dumps({"updates": payload}).encode(),
                headers={"Content-Type": "application/json"})

        try:
            if len(jobs) == 1:
                results = [(jobs[0][0], call(*jobs[0]))]
            else:
                with ThreadPoolExecutor(max_workers=max(1, len(jobs))) as pool:
                    futures = [(sub, pool.submit(call, sub, payload)) for sub, payload in jobs]
                    results = [(sub, f.result()) for sub, f in futures]
        except Exception as exc:
            # a replica died mid-stream: the breaker has the failure; this
            # session answers the resume contract
            proxy.stale = True
            raise self._stream_resume_error(f"replica failed mid-stream ({exc})", proxy.machines,
                                            [sub["rid"] for sub, _ in jobs])
        # every outcome is classified first: a sub that answered 200 has
        # committed its rows, so once one has, the only safe error is the
        # resume contract (the replayed tail re-anchors every sub-session)
        scores, ok, shed, refused, lost = {}, [], [], [], []
        for sub, reply in results:
            if 200 <= reply.status < 300:
                try:
                    scores.update(reply.json().get("scores") or {})
                    ok.append(sub)
                    continue
                except ValueError:
                    lost.append((sub, "unparseable response"))
            elif reply.status == 503:
                shed.append((sub, reply))
            elif reply.status in (400, 404, 422) or (
                    reply.status == 409 and "stream_resume" not in (self._body_of(reply) or {})):
                refused.append((sub, reply))  # would repeat: surfaced as it is
            else:
                lost.append((sub, f"answered {reply.status}"))
        if refused:
            if ok or lost:
                proxy.stale = True
            return self._passthrough(sorted(refused, key=lambda pair: pair[0]["rid"])[0][1])
        if shed and not ok and not lost:
            return self._passthrough(shed[0][1])  # nothing committed: retry is exact
        if lost or shed:
            proxy.stale = True
            raise self._stream_resume_error(
                "; ".join([f"replica {sub['rid']} {why}" for sub, why in lost]
                          + [f"replica {sub['rid']} shed mid-update" for sub, _ in shed]),
                proxy.machines, [sub["rid"] for sub, _ in lost + shed])
        return _json_response({"session": proxy.sid, "scores": scores})

    def view_stream_close(self, ctx, request, gordo_project: str, stream_id: str) -> Response:
        with self._streams_lock:
            proxy = self._streams.pop(stream_id, None)
        if proxy is not None:
            self._close_subs(proxy.subs, gordo_project, ctx.forward_params(request))
        return _json_response({"session": stream_id, "closed": proxy is not None})


def parse_replica_entries(entries) -> Dict[str, str]:
    """``id=url`` entries (each may be a comma-separated list, the
    environment variable's form) -> {id: url}; a malformed entry is a
    ``ValueError``."""
    replicas: Dict[str, str] = {}
    flat: List[str] = []
    for item in entries:
        flat.extend(p for p in str(item).split(",") if p.strip())
    for entry in flat:
        rid, sep, url = entry.strip().partition("=")
        rid, url = rid.strip(), url.strip().rstrip("/")
        if not sep or not rid or not url:
            raise ValueError(f"Replica entries must be id=url, got {entry!r}")
        replicas[rid] = url
    return replicas


#: config key -> (environment variable, type) of :func:`build_router_app`
ENV_SETTINGS = {
    "VNODES": ("GORDO_ROUTER_VNODES", int),
    "EJECT_AFTER": ("GORDO_ROUTER_EJECT_AFTER", int),
    "BACKOFF_SCALE": ("GORDO_ROUTER_BACKOFF_SCALE", float),
    "PROBE_INTERVAL_S": ("GORDO_ROUTER_PROBE_INTERVAL_S", float),
    "HEDGE_MS": ("GORDO_ROUTER_HEDGE_MS", float),
    "REPLICA_TIMEOUT_S": ("GORDO_ROUTER_REPLICA_TIMEOUT_S", float),
    "MAX_INFLIGHT": ("GORDO_ROUTER_MAX_INFLIGHT", int),
}


def build_router_app(config: Optional[dict] = None) -> RouterApp:
    """The router app; settings missing from ``config`` come from the
    environment (``GORDO_ROUTER_REPLICAS`` and ``ENV_SETTINGS``), else
    ``DEFAULTS``."""
    config = dict(config or {})
    if "REPLICAS" not in config and os.environ.get("GORDO_ROUTER_REPLICAS"):
        config["REPLICAS"] = parse_replica_entries([os.environ["GORDO_ROUTER_REPLICAS"]])
    for key, (env, cast) in ENV_SETTINGS.items():
        if key not in config and os.environ.get(env):
            config[key] = cast(os.environ[env])
    return RouterApp(config)


def run_router(host: str, port: int, config: Optional[dict] = None) -> None:
    """Serve the router on the port's threaded HTTP server until
    interrupted (one process: the router holds no device, so more routers
    go behind a plain load balancer)."""
    from gordo_tpu_torch.server.runner import make_http_server

    app = build_router_app(config)
    server = make_http_server(app, host, port)
    logger.info("Router on %s:%d over replicas %s", host, server.server_port,
                sorted(app.routing_view()[0]))
    try:
        server.serve_forever()
    finally:
        server.server_close()
        app.close()
