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

- The plane's telemetry (``observability/rollup.py``):
  ``/telemetry/snapshot`` is this router's own registry and identity;
  ``/status`` and ``/metrics`` are the merge of its replicas' snapshots
  and its own (counters summed, gauges labelled by replica, histograms
  bucket-wise), with the control signals. With ``ROLLUP_INTERVAL_S``
  above 0 a poller thread keeps the merge warm and, with
  ``ROLLUP_PERSIST_PATH``, appends each merge to a JSONL file trimmed to
  ``ROLLUP_RETENTION`` lines; with 0 no thread runs and no replica is
  asked for a snapshot until ``/status`` or ``/metrics`` is, which polls
  once per request. The router counts its requests by outcome
  (``gordo_router_requests_total``), its sheds, failovers and hedges.

The router holds no model and needs no card: it reads the collection's
directory and build report (``CollectionView``) and calls the replicas
with ``utils/http.py``'s ``HttpTransport``, over keep-alive connections
kept per replica (the rollup's snapshot fetches too).

- Observability, as the JAX router's: each request but the probe paths
  runs under a ``router.request`` span parented on its ``traceparent``,
  each replica call under a ``router.fanout`` span (``router.failover``
  off an ejected owner; a hedge's copy carries ``hedge``), whose context
  rides the call's ``traceparent``; every reply echoes the trace id in
  ``X-Gordo-Trace-Id``. The router plane of the phase ledger times the
  replicas' wait as ``queue`` and the reply's re-stamp as ``serialize``
  (``gordo_phase_seconds{plane="router"}``). A membership swap writes a
  ``router_membership_changed`` event, each shard routed off its owner a
  ``shard_failover`` one, and the breaker ``replica_ejected`` and
  ``replica_recovered``.
- The ``replica`` fault site (``robustness/faults.py``) is asked before
  each replica call and probe: ``die`` fails the call as a refused
  connection does, ``slow`` sleeps before the send.
"""

import json
import logging
import os
import threading
import time
import timeit
import traceback
import uuid
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeout
from concurrent.futures import wait as futures_wait
from typing import Dict, List, Optional, Sequence, Tuple
from urllib.parse import parse_qs, urlencode

from gordo_tpu_torch import __version__, serializer
from gordo_tpu_torch.observability import attribution, emit_event, tracing
from gordo_tpu_torch.observability import rollup as rollup_mod
from gordo_tpu_torch.observability.registry import get_registry
from gordo_tpu_torch.robustness import faults
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
from gordo_tpu_torch.utils.http import HttpTransport, Reply

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
    #: seconds between rollup polls; 0: no poller thread
    "ROLLUP_INTERVAL_S": 0.0,
    #: merged snapshots kept in the persisted JSONL
    "ROLLUP_RETENTION": 500,
    #: where each merge is appended; None: not persisted
    "ROLLUP_PERSIST_PATH": None,
}
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
    ("GET", "/telemetry/snapshot", "telemetry_snapshot"),
    ("GET", "/status", "status"),
    ("GET", "/metrics", "metrics"),
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
    """A request's revision (the served directory, its name, and the
    revision the caller pinned, forwarded to every replica call), its
    trace id and its router-plane phase ledger."""

    def __init__(self):
        self.start = timeit.default_timer()
        self.collection_dir = ""
        self.current_revision = ""
        self.revision = ""
        self.requested_revision = ""
        self.trace_id = ""
        self.ledger = attribution.ledger_for("router")

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
        # the plane rollup: a poller thread only with an interval; without
        # one nothing runs until /status or /metrics is asked for
        self._started_at = time.time()
        self._rollup_lock = threading.Lock()
        self._rollup: Optional[rollup_mod.RollupPoller] = None
        rollup_interval = float(self.config["ROLLUP_INTERVAL_S"] or 0.0)
        if rollup_interval > 0:
            self._rollup = self._build_rollup(rollup_interval)
            self._rollup.start()

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
        removed = sorted(previous - set(replicas))
        for rid in removed:
            self.health.forget(rid)
        n_streams = 0
        with self._streams_lock:
            for proxy in self._streams.values():
                if not proxy.stale:
                    proxy.stale = True
                    n_streams += 1
        emit_event("router_membership_changed", added=sorted(set(replicas) - previous),
                   removed=removed, n_replicas=len(replicas), n_streams_drained=n_streams)
        logger.info("Router membership: %s", sorted(replicas))

    def close(self) -> None:
        self._stopping.set()
        if self._prober is not None:
            self._prober.join(timeout=5.0)
            self._prober = None
        with self._rollup_lock:
            rollup, self._rollup = self._rollup, None
        if rollup is not None:
            rollup.stop()
        if hasattr(self.transport, "close"):
            self.transport.close()

    # -- the plane rollup ----------------------------------------------------
    def _build_rollup(self, interval_s: float) -> rollup_mod.RollupPoller:
        def members() -> Dict[str, str]:
            return dict(self.routing_view()[0])

        def fetch(url: str) -> dict:
            return rollup_mod.fetch_json(url.rstrip("/") + "/telemetry/snapshot",
                                         timeout=self.replica_timeout_s,
                                         transport=self.transport)

        return rollup_mod.RollupPoller(
            members=members, interval_s=interval_s, fetch=fetch,
            local_members={"__router__": self._self_snapshot},
            persist_path=self.config["ROLLUP_PERSIST_PATH"] or None,
            retention=int(self.config["ROLLUP_RETENTION"] or 500),
            name="router-rollup",
        )

    def _rollup_poller(self) -> rollup_mod.RollupPoller:
        """The poller; without an interval, a threadless one made on the
        first ``/status`` or ``/metrics``."""
        with self._rollup_lock:
            if self._rollup is None:
                self._rollup = self._build_rollup(0.0)
            return self._rollup

    def _self_snapshot(self) -> dict:
        """This router's own ``/telemetry/snapshot``, also its member of
        the merge."""
        replicas, _ = self.routing_view()
        routable = [r for r in replicas if self.health.routable(r)]
        return rollup_mod.snapshot_payload(
            role="router",
            status={"status": "ok" if routable else "no_replicas",
                    "replicas": self.health.snapshot(), "routable": len(routable),
                    "max_inflight": self.max_inflight},
            registry=get_registry(),
            started_at=self._started_at,
        )

    def _merged_snapshot(self) -> dict:
        """The latest merge: the poller thread's, or one polled now."""
        poller = self._rollup_poller()
        merged = poller.merged()
        if merged is None or poller.interval_s <= 0:
            merged = poller.poll_once()
        return merged

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
                self.health.note_probe(rid, self._probe_replica(rid, base_url))

    def _probe_replica(self, rid: str, base_url: str) -> bool:
        action = faults.replica_fault_action(rid)
        if action is not None and action[0] == "die":
            return False
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

    #: probes and telemetry: no span, no ledger (a trace id is still echoed)
    _TRACE_EXEMPT_PATHS = frozenset({"/healthcheck", "/healthz", "/metrics", "/status",
                                     "/telemetry/snapshot"})

    def dispatch(self, method: str, path: str, body: bytes = b"", query_string: str = "",
                 headers: Optional[Dict[str, str]] = None) -> Response:
        request = Request(method, path, body, query_string, headers)
        ctx = _Ctx()
        incoming = tracing.parse_traceparent(request.headers.get(tracing.TRACEPARENT_HEADER))
        if path in self._TRACE_EXEMPT_PATHS:
            ctx.trace_id = incoming.trace_id if incoming is not None else ""
            ctx.ledger = attribution.NOOP_LEDGER
            return self._dispatch_traced(ctx, request, tracing.NOOP_SPAN)
        with tracing.start_span("router.request", parent=incoming, method=method,
                                path=path) as span:
            ctx.trace_id = span.trace_id or (incoming.trace_id if incoming is not None else "")
            # the replica calls on this thread record their wait here
            with ctx.ledger.activate():
                return self._dispatch_traced(ctx, request, span)

    def _dispatch_traced(self, ctx: _Ctx, request: Request, span) -> Response:
        view = None
        try:
            view, url_args = self._match(request.method, request.path)
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
        span.set_attribute("endpoint", view or "unmatched")
        span.set_attribute("status_code", response.status)
        if response.status >= 500:
            span.set_status("error")
        return self._finalize(ctx, response)

    @staticmethod
    def _match(method: str, path: str):
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
        """The server's revision stamp on the body and header (timed as
        the ledger's ``serialize``), the router's own Server-Timing entry
        after the replica's, and the trace id. A replica's JSON reply that
        carries the ``revision`` header has the stamp in its body too (the
        server sets both), so only one without is read again."""
        if ctx.revision:
            with ctx.ledger.phase("serialize"):
                if response.payload is not None:
                    response.payload.setdefault("revision", ctx.revision)
                elif (response.mimetype == "application/json"
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
        runtime_s = timeit.default_timer() - ctx.start
        ctx.ledger.finish(span=tracing.current_span(), wall_s=runtime_s)
        entry = f"router_total;dur={runtime_s * 1000.0:.2f}"
        existing = response.headers.get("Server-Timing")
        response.headers["Server-Timing"] = f"{existing}, {entry}" if existing else entry
        if ctx.trace_id:
            response.headers[tracing.TRACE_ID_RESPONSE_HEADER] = ctx.trace_id
        return response

    # -- admission control -------------------------------------------------
    def _admit(self) -> None:
        if not self._inflight.acquire(blocking=False):
            get_registry().counter("gordo_router_sheds_total",
                                   "Requests shed at the router's own admission door").inc()
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

    @staticmethod
    def _count_request(outcome: str) -> None:
        get_registry().counter(
            "gordo_router_requests_total",
            "Routed prediction requests by outcome (ok/partial/shed/refused/error)",
            ("outcome",),
        ).inc(outcome=outcome)

    @staticmethod
    def _note_failover(from_replica: str, to_target: str, n_machines: int) -> None:
        get_registry().counter("gordo_router_failovers_total",
                               "Shard calls re-routed off their ring owner").inc()
        emit_event("shard_failover", from_replica=from_replica, target=to_target,
                   n_machines=n_machines)

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
                      body: Optional[bytes] = None, headers=None,
                      span_name: str = "router.fanout", span_attrs: Optional[dict] = None,
                      parent_ctx=None) -> Reply:
        """One call to a replica under its span, through the ``replica``
        fault site, its outcome recorded in the breaker: a transport error
        (raised) and a 5xx other than 503 count against it. Its wait is
        the request ledger's ``queue`` (a no-op on a fan-out worker, whose
        caller times the whole fan-out)."""
        with tracing.start_span(span_name, parent=parent_ctx, replica=rid,
                                **(span_attrs or {})) as span:
            action = faults.replica_fault_action(rid)
            if action is not None:
                if action[0] == "die":
                    self.health.record_failure(rid)
                    span.set_status("error")
                    raise ConnectionRefusedError(f"injected replica death: {rid}")
                time.sleep(action[1])  # slow
            url = f"{base_url}{path}" + (f"?{urlencode(params)}" if params else "")
            send_headers = dict(headers or {})
            send_headers.update(tracing.propagation_headers(span))
            t_wait = time.perf_counter()
            try:
                reply = self.transport.request(method, url, body=body, headers=send_headers,
                                               timeout=self.replica_timeout_s)
            except Exception:
                self.health.record_failure(rid)
                span.set_status("error")
                raise
            finally:
                attribution.record_current("queue", time.perf_counter() - t_wait)
            if reply.status >= 500 and reply.status != 503:
                self.health.record_failure(rid)
            else:
                self.health.record_success(rid)
            span.set_attribute("status_code", reply.status)
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

    def view_telemetry_snapshot(self, ctx, request) -> Response:
        """This router's own registry and identity (the plane's merge is
        ``/status`` and ``/metrics``: a rollup polling a router must not
        merge a merge again)."""
        return _json_response(self._self_snapshot())

    def view_status(self, ctx, request) -> Response:
        """The plane's status: each replica's health, load and breaker,
        the control signals, the merge's errors (what ``top`` shows)."""
        return _json_response(rollup_mod.plane_status(self._merged_snapshot()))

    def view_metrics(self, ctx, request) -> Response:
        """The merged registries in the Prometheus text format."""
        merged = self._merged_snapshot()
        return Response(rollup_mod.render_prometheus_text(merged.get("metrics") or {}).encode(),
                        200, "text/plain")

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
        adopted = rid != owner
        if adopted:
            self._note_failover(owner, gordo_name, 1)
        try:
            reply = self._replica_call(
                rid, replicas[rid], "GET", request.path, params=ctx.forward_params(request),
                headers={ADOPT_HEADER: "failover"} if adopted else None,
                span_name="router.failover" if adopted else "router.fanout",
                span_attrs=({"from_replica": owner, "machine": gordo_name} if adopted
                            else {"machine": gordo_name}),
                parent_ctx=tracing.current_context())
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
            self._count_request("partial")
            raise ApiError(self._transient_unavailable_payload(
                {gordo_name: owner}, "every candidate replica is ejected"), 409)
        rid = candidates[0]
        adopted = rid != owner
        headers = {"Content-Type": request.content_type} if request.content_type else {}
        if adopted:
            headers[ADOPT_HEADER] = "failover"
            self._note_failover(owner, gordo_name, 1)
        params = ctx.forward_params(request)
        try:
            reply = self._replica_call(
                rid, replicas[rid], "POST", request.path, params=params, body=request.body,
                headers=headers, span_name="router.failover" if adopted else "router.fanout",
                span_attrs=({"from_replica": owner, "machine": gordo_name} if adopted
                            else {"machine": gordo_name}),
                parent_ctx=tracing.current_context())
            if reply.status == 421:
                # the replica's manifest and the router's differ (a
                # membership change one side has not seen): adopt once
                reply = self._replica_call(
                    rid, replicas[rid], "POST", request.path, params=params,
                    body=request.body, headers={**headers, ADOPT_HEADER: "failover"},
                    span_attrs={"machine": gordo_name, "adopt_retry": True},
                    parent_ctx=tracing.current_context())
        except Exception as exc:
            self._count_request("partial")
            raise ApiError(self._transient_unavailable_payload(
                {gordo_name: owner}, f"routed replica {rid} failed ({exc})"), 409)
        # a replica's 503 passes through: its shed load is not sprayed on
        # its peers
        self._count_request("ok" if reply.status < 400 else
                            "shed" if reply.status == 503 else "refused")
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
            self._count_request("partial")
            raise ApiError(self._transient_unavailable_payload(
                dead, "every candidate replica is ejected"), 409)
        # routing off an ejected owner is the failover, recorded for each
        # true owner whose machines a successor took
        for rid, group in sorted(shards.items()):
            moved: Dict[str, int] = {}
            for name in group:
                if owners[name] != rid:
                    moved[owners[name]] = moved.get(owners[name], 0) + 1
            for owner, n_moved in sorted(moved.items()):
                self._note_failover(owner, rid, n_moved)
        params = ctx.forward_params(request)
        ordered = sorted(shards.items())
        args = (owners, machines, request, params, replicas, ring, tracing.current_context())
        if len(ordered) == 1:
            results = [self._call_shard(*ordered[0], *args)]
        else:
            # the whole fan-out's wait is this thread's ``queue``
            t_wait = time.perf_counter()
            with ThreadPoolExecutor(max_workers=len(ordered)) as pool:
                futures = [pool.submit(self._call_shard, rid, group, *args)
                           for rid, group in ordered]
                results = [f.result() for f in futures]
            attribution.record_current("queue", time.perf_counter() - t_wait)
        return self._join_fleet_results(ctx, ordered, owners, results)

    def _call_shard(self, rid: str, group: List[str], owners, machines, request, params,
                    replicas, ring, parent_ctx=None) -> _ShardResult:
        """One shard's call to its routed replica (hedged when
        ``HEDGE_MS`` is set). A transport failure is not retried elsewhere
        within the request: it feeds the breaker and the shard's machines
        come back as named transient casualties."""
        body = json.dumps({"machines": {name: machines[name] for name in group}}).encode()
        failover_from = next((owners[m] for m in group if owners[m] != rid), None)

        def attempt(replica: str, adopted: bool, hedge: bool = False) -> _ShardResult:
            headers = {"Content-Type": "application/json"}
            if adopted:
                headers[ADOPT_HEADER] = "failover"
            from_owner = failover_from if replica == rid else rid
            attrs: dict = {"n_machines": len(group)}
            if adopted and not hedge and from_owner:
                attrs["from_replica"] = from_owner
            if hedge:
                attrs["hedge"] = True
            reply = self._replica_call(
                replica, replicas[replica], "POST", request.path, params=params, body=body,
                headers=headers,
                span_name="router.failover" if adopted and not hedge else "router.fanout",
                span_attrs=attrs, parent_ctx=parent_ctx)
            return self._classify_shard_response(replica, reply)

        adopted = failover_from is not None
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
        # both copies run on the pool: the wait is this thread's ``queue``
        t_wait = time.perf_counter()
        try:
            first = pool.submit(attempt, primary, adopted)
            try:
                return first.result(timeout=self.hedge_s)
            except FutureTimeout:
                pass
            get_registry().counter("gordo_router_hedges_total",
                                   "Hedge requests fired for straggling shard calls").inc()
            pending = {first, pool.submit(attempt, backup, True, True)}
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
            attribution.record_current("queue", time.perf_counter() - t_wait)
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
            self._count_request("shed")
            return response
        refused = [r for r in results if r.kind == "refused"]
        if refused:
            first = sorted(refused, key=lambda r: r.replica)[0]
            self._count_request("refused")
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
            self._count_request("partial")
            raise ApiError(payload, 409)
        self._count_request("ok")
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
            self._count_request("partial")
            raise self._stream_resume_error("every candidate replica is ejected", dead,
                                            dead.values())
        params = ctx.forward_params(request)
        parent_ctx = tracing.current_context()
        subs: List[dict] = []
        merged: dict = {}
        try:
            for rid, group in sorted(shards.items()):
                headers = {"Content-Type": "application/json"}
                adopted = any(owners[m] != rid for m in group)
                if adopted:
                    headers[ADOPT_HEADER] = "failover"
                for owner in sorted({owners[m] for m in group if owners[m] != rid}):
                    self._note_failover(owner, rid, sum(1 for m in group if owners[m] == owner))
                reply = self._replica_call(
                    rid, replicas[rid], "POST", f"/gordo/v0/{project}/stream/open", params=params,
                    body=json.dumps({"machines": {m: spec[m] for m in group}}).encode(),
                    headers=headers, span_name="router.failover" if adopted else "router.fanout",
                    span_attrs={"n_machines": len(group), "stream": True}, parent_ctx=parent_ctx)
                refused = reply.status in (400, 404, 410, 422) or (
                    reply.status == 409 and not (self._body_of(reply) or {}).get("transient"))
                if reply.status == 503 or refused:
                    # a shed, or a refusal that would repeat: as it is
                    self._close_subs(subs, project, params)
                    self._count_request("shed" if reply.status == 503 else "refused")
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
            self._count_request("partial")
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
        self._count_request("ok")
        return _json_response({"session": proxy.sid, "machines": merged}, 201)

    def _close_subs(self, subs: List[dict], project: str, params) -> None:
        """Close sub-sessions, best effort: their windows free now."""
        for sub in subs:
            try:
                self._replica_call(sub["rid"], sub["url"], "POST",
                                   f"/gordo/v0/{project}/stream/{sub['sid']}/close",
                                   params=params, span_attrs={"stream": True})
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
        parent_ctx = tracing.current_context()
        jobs = [(sub, {m: updates[m] for m in sub["machines"] if m in updates})
                for sub in proxy.subs]
        jobs = [(sub, payload) for sub, payload in jobs if payload]

        def call(sub, payload):
            return self._replica_call(
                sub["rid"], sub["url"], "POST", f"/gordo/v0/{project}/stream/{sub['sid']}/update",
                params=params, body=json.dumps({"updates": payload}).encode(),
                headers={"Content-Type": "application/json"},
                span_attrs={"n_machines": len(payload), "stream": True}, parent_ctx=parent_ctx)

        try:
            if len(jobs) == 1:
                results = [(jobs[0][0], call(*jobs[0]))]
            else:
                t_wait = time.perf_counter()
                with ThreadPoolExecutor(max_workers=max(1, len(jobs))) as pool:
                    futures = [(sub, pool.submit(call, sub, payload)) for sub, payload in jobs]
                    results = [(sub, f.result()) for sub, f in futures]
                attribution.record_current("queue", time.perf_counter() - t_wait)
        except Exception as exc:
            # a replica died mid-stream: the breaker has the failure; this
            # session answers the resume contract
            proxy.stale = True
            self._count_request("partial")
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
            self._count_request("refused")
            return self._passthrough(sorted(refused, key=lambda pair: pair[0]["rid"])[0][1])
        if shed and not ok and not lost:
            self._count_request("shed")
            return self._passthrough(shed[0][1])  # nothing committed: retry is exact
        if lost or shed:
            proxy.stale = True
            self._count_request("partial")
            raise self._stream_resume_error(
                "; ".join([f"replica {sub['rid']} {why}" for sub, why in lost]
                          + [f"replica {sub['rid']} shed mid-update" for sub, _ in shed]),
                proxy.machines, [sub["rid"] for sub, _ in lost + shed])
        self._count_request("ok")
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
    "ROLLUP_INTERVAL_S": ("GORDO_ROLLUP_INTERVAL_S", float),
    "ROLLUP_RETENTION": ("GORDO_ROLLUP_RETENTION", int),
    "ROLLUP_PERSIST_PATH": ("GORDO_ROLLUP_PERSIST", str),
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
