"""
The knob registry (the port of ``gordo_tpu.tuning.knobs``): one
declaration for each performance knob of the fleet, with its flag, its
environment variable, its default, its subsystem, the values it may
take and the telemetry signals that judge it. ``tune``, the profile's
validation and the commands that apply a profile read it.

Every knob, its name, flag, variable, default, domain, signals and
``tunable`` are the JAX registry's, so a profile the JAX tuner wrote
validates here. ``unported`` says whether the port has the knob: None,
or the reason it has not (``programs/`` stays out of the port, and its
``run-server`` and ``run-router`` are no gunicorn). ``tune fit`` never
recommends a knob the port lacks, and ``build-fleet`` and ``run-server``
refuse a profile that does, by name. Standard library only.

``NON_KNOB_ENV_VARS`` names the ``GORDO_*`` variables that are no
performance knob (paths, identities, log levels, fault switches).
"""

import dataclasses
import typing

# --------------------------------------------------------------------------
# value domains
# --------------------------------------------------------------------------


class Domain:
    """A knob's legal value set — profile validation and the
    ``tune plan --check`` drift gate both test membership."""

    def contains(self, value) -> bool:  # pragma: no cover - abstract
        raise NotImplementedError

    def describe(self) -> str:  # pragma: no cover - abstract
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class IntRange(Domain):
    lo: int
    hi: int
    #: extra non-integer sentinels the flag accepts (e.g. "auto")
    extra: typing.Tuple[str, ...] = ()

    def contains(self, value) -> bool:
        if isinstance(value, str) and value in self.extra:
            return True
        return (
            isinstance(value, int)
            and not isinstance(value, bool)
            and self.lo <= value <= self.hi
        )

    def describe(self) -> str:
        extra = f" | {'|'.join(self.extra)}" if self.extra else ""
        return f"int {self.lo}..{self.hi}{extra}"


@dataclasses.dataclass(frozen=True)
class FloatRange(Domain):
    lo: float
    hi: float

    def contains(self, value) -> bool:
        return (
            isinstance(value, (int, float))
            and not isinstance(value, bool)
            and self.lo <= float(value) <= self.hi
        )

    def describe(self) -> str:
        return f"float {self.lo:g}..{self.hi:g}"


@dataclasses.dataclass(frozen=True)
class Choice(Domain):
    values: typing.Tuple[typing.Any, ...]

    def contains(self, value) -> bool:
        return value in self.values

    def describe(self) -> str:
        return " | ".join(str(v) for v in self.values)


@dataclasses.dataclass(frozen=True)
class IntList(Domain):
    """Comma-separated ascending positive ints (``GORDO_AOT_ROW_BUCKETS``
    shape); accepts the string spelling or a list of ints."""

    lo: int = 1
    hi: int = 1 << 20

    def _items(self, value) -> typing.Optional[typing.List[int]]:
        if isinstance(value, str):
            try:
                value = [int(p) for p in value.split(",") if p.strip()]
            except ValueError:
                return None
        if not isinstance(value, (list, tuple)) or not value:
            return None
        if not all(
            isinstance(v, int) and not isinstance(v, bool) for v in value
        ):
            return None
        return list(value)

    def contains(self, value) -> bool:
        items = self._items(value)
        return items is not None and all(
            self.lo <= v <= self.hi for v in items
        ) and items == sorted(items)

    def describe(self) -> str:
        return f"ascending comma-separated ints {self.lo}..{self.hi}"


BOOL = Choice((True, False))


# --------------------------------------------------------------------------
# signals
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Signal:
    """One telemetry series that judges a knob: the canonical metric
    name, the objective direction, and the JSON field spellings the
    corpus reader recognizes it under. Order in ``Knob.signals`` is
    priority: the cost model optimizes the FIRST signal the corpus
    actually measured across >= 2 arms; the rest ride as evidence."""

    metric: str
    objective: str  # "min" | "max"
    fields: typing.Tuple[str, ...]

    def better(self, a: float, b: float) -> bool:
        """Is measurement ``a`` better than ``b`` under this signal?"""
        return a < b if self.objective == "min" else a > b


# --------------------------------------------------------------------------
# knobs
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Knob:
    name: str  # canonical id: profile key, docs table row
    flag: str  # CLI flag spelling ("" = env-only knob)
    cli: str  # the command carrying the flag ("" = env-only)
    env_var: str
    default: typing.Any
    subsystem: str  # builder | server | router | programs | streaming | ledger
    domain: Domain
    doc: str
    #: JSON field spellings a corpus record states the knob's value under
    data_keys: typing.Tuple[str, ...] = ()
    #: priority-ordered telemetry signals that judge the knob
    signals: typing.Tuple[Signal, ...] = ()
    #: the autotuner may emit a recommendation (False = catalogued and
    #: disciplined, but judged by hand — e.g. robustness trade-offs)
    tunable: bool = False
    #: None where the port has the knob, else why it has not
    unported: typing.Optional[str] = None


#: why the port lacks a knob (``Knob.unported``)
_PROGRAMS = ("programs/ stays out of the port: it serializes XLA executables, and the port "
             "builds its CUDA once behind ops/_build.py's source digest (ROADMAP.md queue 1 "
             "item 9)")
_DONATION = ("the port's fleet scorer donates no input buffer: buffer donation waits for a "
             "measurement that asks for it (ROADMAP.md queue 1 item 9)")
_NO_GUNICORN = ("the port's run-server is not gunicorn: one process serves with a thread a "
                "connection (server/runner.py), and takes no --threads, --workers or "
                "--worker-connections")
_NO_PRELOAD = ("the port's run-server loads each model on its first request: it has no "
               "preload (server/app.py)")
_ROUTER_THREADS = ("the port's run-router serves with a thread a connection and takes no "
                   "--threads (router/app.py)")

#: measured wall-clock signals shared by several serving knobs
_P99 = Signal("p99_ms", "min", ("p99_ms", "p99_per_update_ms"))
_GOODPUT = Signal(
    "goodput_machine_scores_per_s",
    "max",
    ("goodput_machine_scores_per_s", "machine_scores_per_s"),
)

KNOBS: typing.Tuple[Knob, ...] = (
    # -- builder / training ------------------------------------------------
    Knob(
        name="epoch_chunk",
        flag="--epoch-chunk",
        cli="build-fleet",
        env_var="GORDO_EPOCH_CHUNK",
        default=1,
        subsystem="builder",
        domain=IntRange(1, 512),
        doc="Epochs fused into one compiled program (one host sync per "
        "chunk); bit-identical to per-epoch dispatch",
        data_keys=("epoch_chunk",),
        signals=(
            Signal(
                "steady_state_sensor_timesteps_per_s",
                "max",
                ("steady_state_sensor_timesteps_per_s",),
            ),
            Signal("steady_state_epoch_s", "min", ("steady_state_epoch_s",)),
            Signal("dispatch_overhead_s", "min", ("dispatch_overhead_s",)),
        ),
        tunable=True,
    ),
    Knob(
        name="bucket_policy",
        flag="--bucket-policy",
        cli="build-fleet",
        env_var="GORDO_BUCKET_POLICY",
        default="exact",
        subsystem="builder",
        domain=Choice(("exact", "padded")),
        doc="Bucketing-compiler grouping: exact geometry per program, or "
        "padded fusion of same-family ragged widths",
        data_keys=("bucket_policy",),
        signals=(
            Signal("models_per_hour", "max", ("models_per_hour",)),
            Signal(
                "padding_waste_ratio", "min", ("padding_waste_ratio",)
            ),
        ),
        tunable=True,
    ),
    Knob(
        name="build_workers",
        flag="--workers",
        cli="build-fleet",
        env_var="GORDO_BUILD_WORKERS",
        default=1,
        subsystem="ledger",
        domain=IntRange(1, 256, extra=("auto",)),
        doc="Worker processes sharing the build through the crash-"
        "tolerant work ledger",
        data_keys=("workers", "n_workers"),
        signals=(Signal("models_per_hour", "max", ("models_per_hour",)),),
        tunable=True,
    ),
    Knob(
        name="lease_ttl",
        flag="--lease-ttl",
        cli="build-fleet",
        env_var="GORDO_LEASE_TTL",
        default=60.0,
        subsystem="ledger",
        domain=FloatRange(1.0, 3600.0),
        doc="Seconds a ledger lease may go silent before a live worker "
        "steals it",
        data_keys=("lease_ttl",),
        signals=(
            Signal("goodput_retained", "max", ("goodput_retained",)),
        ),
        tunable=True,
    ),
    Knob(
        name="max_attempts",
        flag="--max-attempts",
        cli="build-fleet",
        env_var="GORDO_MAX_ATTEMPTS",
        default=3,
        subsystem="ledger",
        domain=IntRange(1, 32),
        doc="Worker deaths a unit survives before it is poisoned into a "
        "casualty",
    ),
    Knob(
        name="fetch_retries",
        flag="--fetch-retries",
        cli="build-fleet",
        env_var="GORDO_FETCH_RETRIES",
        default=2,
        subsystem="builder",
        domain=IntRange(0, 16),
        doc="Per-machine data-fetch retries (exponential backoff)",
    ),
    Knob(
        name="fetch_timeout",
        flag="--fetch-timeout",
        cli="build-fleet",
        env_var="GORDO_FETCH_TIMEOUT",
        default=None,
        subsystem="builder",
        domain=FloatRange(0.001, 86400.0),
        doc="Per-machine cap on one data fetch, seconds (unset waits "
        "forever)",
    ),
    Knob(
        name="precision",
        flag="--precision",
        cli="build-fleet",
        env_var="GORDO_PRECISION",
        default="float32",
        subsystem="builder",
        domain=Choice(("float32", "bf16", "auto")),
        doc="Per-machine inference precision: auto calibrates each "
        "machine against the MAE-parity tolerance and falls back to "
        "float32 where bf16 breaches it",
        data_keys=("precision",),
        signals=(
            Signal(
                "steady_state_sensor_timesteps_per_s",
                "max",
                ("steady_state_sensor_timesteps_per_s",),
            ),
            _P99,
            Signal(
                "worst_machine_mae_delta",
                "min",
                ("worst_machine_mae_delta", "max_mae_delta"),
            ),
        ),
        tunable=True,
    ),
    Knob(
        name="precision_tolerance",
        flag="--precision-tolerance",
        cli="build-fleet",
        env_var="GORDO_PRECISION_TOLERANCE",
        default=0.25,
        subsystem="builder",
        domain=FloatRange(0.0, 10.0),
        doc="Relative per-machine MAE-parity bound a bf16 calibration "
        "must stay within, else the machine serves float32",
    ),
    Knob(
        name="prefetch_depth",
        flag="--prefetch-depth",
        cli="build-fleet",
        env_var="GORDO_PREFETCH_DEPTH",
        default=0,
        subsystem="builder",
        domain=IntRange(0, 8),
        doc="Host->device transfers kept in flight ahead of the "
        "consuming dispatch (builder data path, chunked fit, stream "
        "updates); 0 = transfer on the critical path, bit-identical",
        data_keys=("prefetch_depth",),
        signals=(
            Signal(
                "transfer_overlap_ratio",
                "max",
                ("transfer_overlap_ratio",),
            ),
            Signal(
                "steady_state_sensor_timesteps_per_s",
                "max",
                ("steady_state_sensor_timesteps_per_s",),
            ),
        ),
        tunable=True,
    ),
    Knob(
        name="donate",
        flag="",
        cli="",
        env_var="GORDO_DONATE",
        default=False,
        subsystem="server",
        domain=BOOL,
        doc="Donate the serving dispatch's stacked input batch so XLA "
        "reuses its memory for the output; off by default — the alias "
        "annotation alone shifts fusion (~1-2 ulp measured on CPU) and "
        "the default serving path is pinned bit-identical",
        data_keys=("donate",),
        signals=(_P99, _GOODPUT),
        tunable=True,
        unported=_DONATION,
    ),
    # -- serving -----------------------------------------------------------
    Knob(
        name="batch_wait_ms",
        flag="--batch-wait-ms",
        cli="run-server",
        env_var="GORDO_BATCH_WAIT_MS",
        default=0.0,
        subsystem="server",
        domain=FloatRange(0.0, 10000.0),
        doc="Dynamic-batching latency-SLO cap: coalesce concurrent fleet "
        "requests for up to this long into one stacked dispatch",
        data_keys=("batch_wait_ms",),
        signals=(
            _P99,
            _GOODPUT,
            Signal(
                "queue_wait_p99_ms", "min", ("queue_wait_p99_ms",)
            ),
            Signal(
                "queue_wait_mean_ms", "min", ("queue_wait_mean_ms",)
            ),
            Signal("mean_batch_size", "max", ("mean_batch_size",)),
        ),
        tunable=True,
    ),
    Knob(
        name="batch_queue_limit",
        flag="--queue-limit",
        cli="run-server",
        env_var="GORDO_BATCH_QUEUE_LIMIT",
        default=64,
        subsystem="server",
        domain=IntRange(1, 65536),
        doc="Batching admission control: waiters past this shed with a "
        "structured 503 + Retry-After",
        data_keys=("queue_limit", "batch_queue_limit"),
        signals=(_P99, Signal("sheds", "min", ("sheds",))),
        tunable=True,
    ),
    Knob(
        name="scorer_cache_size",
        flag="--scorer-cache-size",
        cli="run-server",
        env_var="GORDO_SCORER_CACHE_SIZE",
        default=16,
        subsystem="server",
        domain=IntRange(1, 4096),
        doc="Count bound on resident fleet-scorer/batcher LRUs where the "
        "device reports no memory stats",
    ),
    Knob(
        name="server_threads",
        flag="--threads",
        cli="run-server",
        env_var="GORDO_SERVER_THREADS",
        default=8,
        subsystem="server",
        domain=IntRange(1, 256),
        doc="Per-worker bound on concurrently handled requests",
        unported=_NO_GUNICORN,
    ),
    Knob(
        name="server_workers",
        flag="--workers",
        cli="run-server",
        env_var="GORDO_SERVER_WORKERS",
        default=1,
        subsystem="server",
        domain=IntRange(1, 32),
        doc="Pre-forked server processes (keep 1 on TPU: the chip is "
        "process-exclusive)",
        unported=_NO_GUNICORN,
    ),
    Knob(
        name="server_worker_connections",
        flag="--worker-connections",
        cli="run-server",
        env_var="GORDO_SERVER_WORKER_CONNECTIONS",
        default=None,
        subsystem="server",
        domain=IntRange(1, 65536),
        doc="Per-worker bound on simultaneously accepted connections",
        unported=_NO_GUNICORN,
    ),
    Knob(
        name="server_preload",
        flag="",
        cli="",
        env_var="GORDO_SERVER_PRELOAD",
        default=False,
        subsystem="server",
        domain=BOOL,
        doc="Eagerly load + jit-warm every owned model behind the "
        "readiness probe instead of on first request",
        unported=_NO_PRELOAD,
    ),
    # -- AOT executable cache ---------------------------------------------
    Knob(
        name="aot_cache",
        flag="--aot-cache/--no-aot-cache",
        cli="build-fleet, run-server",
        env_var="GORDO_AOT_CACHE",
        default=True,
        subsystem="programs",
        domain=BOOL,
        doc="Build-time AOT compile + serve-time deserialize of serving "
        "executables (.programs)",
        unported=_PROGRAMS,
    ),
    Knob(
        name="aot_row_buckets",
        flag="",
        cli="",
        env_var="GORDO_AOT_ROW_BUCKETS",
        default="128,256",
        subsystem="programs",
        domain=IntList(1, 1 << 16),
        doc="Request row shapes AOT-compiled per serving group; requests "
        "pad up to the nearest bucket",
        data_keys=("row_buckets", "aot_row_buckets"),
        signals=(
            Signal(
                "padding_waste_ratio", "min", ("padding_waste_ratio",)
            ),
            _P99,
        ),
        tunable=True,
        unported=_PROGRAMS,
    ),
    Knob(
        name="program_cache_size",
        flag="",
        cli="",
        env_var="GORDO_PROGRAM_CACHE_SIZE",
        default=128,
        subsystem="programs",
        domain=IntRange(1, 65536),
        doc="Count bound on cached compiled-program handles where the "
        "device reports no memory stats",
        unported=_PROGRAMS,
    ),
    Knob(
        name="program_min_headroom",
        flag="",
        cli="",
        env_var="GORDO_PROGRAM_MIN_HEADROOM",
        default=0.1,
        subsystem="programs",
        domain=FloatRange(0.0, 1.0),
        doc="Fraction of device memory kept free before the program "
        "cache sheds back to its count bound",
        unported=_PROGRAMS,
    ),
    # -- streaming ---------------------------------------------------------
    Knob(
        name="stream_max_sessions",
        flag="",
        cli="",
        env_var="GORDO_STREAM_MAX_SESSIONS",
        default=64,
        subsystem="streaming",
        domain=IntRange(1, 65536),
        doc="Device-resident stream sessions admitted per process (CPU "
        "count bound; HBM-headroom-governed on real devices)",
    ),
    Knob(
        name="stream_max_backlog",
        flag="",
        cli="",
        env_var="GORDO_STREAM_MAX_BACKLOG",
        default=8,
        subsystem="streaming",
        domain=IntRange(1, 4096),
        doc="Per-session update backlog before admission sheds with 503 "
        "+ Retry-After",
    ),
    Knob(
        name="stream_idle_s",
        flag="",
        cli="",
        env_var="GORDO_STREAM_IDLE_S",
        default=30.0,
        subsystem="streaming",
        domain=FloatRange(0.1, 86400.0),
        doc="Seconds since last update before a session's device windows "
        "may evict (the resume contract rebuilds them)",
    ),
    # -- router ------------------------------------------------------------
    Knob(
        name="hedge_ms",
        flag="--hedge-ms",
        cli="run-router",
        env_var="GORDO_ROUTER_HEDGE_MS",
        default=0.0,
        subsystem="router",
        domain=FloatRange(0.0, 60000.0),
        doc="Straggler hedging: a shard call silent this long gets ONE "
        "duplicate to the next routable successor",
        data_keys=("hedge_ms",),
        signals=(_P99, _GOODPUT),
        tunable=True,
    ),
    Knob(
        name="router_max_inflight",
        flag="--max-inflight",
        cli="run-router",
        env_var="GORDO_ROUTER_MAX_INFLIGHT",
        default=64,
        subsystem="router",
        domain=IntRange(1, 65536),
        doc="Router admission control: concurrent predictions past this "
        "shed with 503 + Retry-After",
    ),
    Knob(
        name="router_vnodes",
        flag="--vnodes",
        cli="run-router",
        env_var="GORDO_ROUTER_VNODES",
        default=64,
        subsystem="router",
        domain=IntRange(1, 4096),
        doc="Virtual nodes per replica on the consistent-hash ring (must "
        "match the shard manifest)",
    ),
    Knob(
        name="router_eject_after",
        flag="--eject-after",
        cli="run-router",
        env_var="GORDO_ROUTER_EJECT_AFTER",
        default=3,
        subsystem="router",
        domain=IntRange(1, 64),
        doc="Consecutive failures before a replica ejects and its shard "
        "fails over",
    ),
    Knob(
        name="router_backoff_scale",
        flag="--backoff-scale",
        cli="run-router",
        env_var="GORDO_ROUTER_BACKOFF_SCALE",
        default=0.25,
        subsystem="router",
        domain=FloatRange(0.001, 100.0),
        doc="Scale on the house backoff schedule for ejection windows",
    ),
    Knob(
        name="router_probe_interval_s",
        flag="--probe-interval",
        cli="run-router",
        env_var="GORDO_ROUTER_PROBE_INTERVAL_S",
        default=1.0,
        subsystem="router",
        domain=FloatRange(0.0, 3600.0),
        doc="Seconds between /healthz probes of ejected replicas (0 = "
        "lazy expiry only)",
    ),
    Knob(
        name="router_replica_timeout_s",
        flag="--replica-timeout",
        cli="run-router",
        env_var="GORDO_ROUTER_REPLICA_TIMEOUT_S",
        default=30.0,
        subsystem="router",
        domain=FloatRange(0.1, 3600.0),
        doc="Per-call timeout against replicas, seconds",
    ),
    Knob(
        name="router_threads",
        flag="--threads",
        cli="run-router",
        env_var="GORDO_ROUTER_THREADS",
        default=32,
        subsystem="router",
        domain=IntRange(1, 1024),
        doc="Bound on concurrently handled router requests",
        unported=_ROUTER_THREADS,
    ),
    Knob(
        name="rollup_interval_s",
        flag="--rollup-interval",
        cli="run-router",
        env_var="GORDO_ROLLUP_INTERVAL_S",
        default=0.0,
        subsystem="router",
        domain=FloatRange(0.0, 3600.0),
        doc="Seconds between plane-rollup polls of member "
        "/telemetry/snapshot endpoints (0 = no poller thread; /status "
        "polls on demand)",
    ),
    Knob(
        name="rollup_retention",
        flag="--rollup-retention",
        cli="run-router",
        env_var="GORDO_ROLLUP_RETENTION",
        default=500,
        subsystem="router",
        domain=IntRange(1, 1_000_000),
        doc="Merged plane snapshots kept in the persisted rollup JSONL "
        "(oldest trimmed)",
    ),
)

KNOBS_BY_NAME: typing.Dict[str, Knob] = {k.name: k for k in KNOBS}
KNOBS_BY_ENV: typing.Dict[str, Knob] = {k.env_var: k for k in KNOBS}

#: ``GORDO_*`` env vars that are deliberately NOT performance knobs —
#: identities, paths, log levels, chaos switches, gate opt-outs (the JAX
#: registry's set, so that both classify every variable alike).
NON_KNOB_ENV_VARS: typing.FrozenSet[str] = frozenset(
    {
        # chaos / CI switches
        "GORDO_FAULT_INJECT",
        "GORDO_FAULT_INJECT_FILE",
        "GORDO_SKIP_LINT",
        "GORDO_SKIP_TUNE_CHECK",
        "GORDO_LOCK_SANITIZE",
        "GORDO_LOCK_SANITIZE_REPORT",
        # observability sinks + sampling (config, not tunables)
        "GORDO_TPU_EVENT_LOG",
        "GORDO_TPU_EVENT_LOG_MAX_MB",
        "GORDO_ROLLUP_PERSIST",
        "GORDO_TPU_TRACE_LOG",
        "GORDO_TPU_TRACE_SAMPLE",
        "GORDO_TPU_PROFILE_DIR",
        "GORDO_PHASE_LEDGER",
        "GORDO_PROFILE_HZ",
        "GORDO_PROFILE_OUT",
        # paths and mounts
        "GORDO_TPU_LAKE_DIR",
        "GORDO_XLA_CACHE_DIR",
        "GORDO_MOUNT_PATH",
        "GORDO_MOUNT_WAIT_SECONDS",
        "GORDO_TUNING_PROFILE",
        # identities / topology wiring
        "GORDO_WORKER_ID",
        "GORDO_REPLICA_ID",
        "GORDO_SHARD_MANIFEST",
        "GORDO_ROUTER_REPLICAS",
        # behavior policies with no throughput/latency axis
        "GORDO_ON_ERROR",
        "GORDO_FLEET_RESUME",
        # process plumbing
        "GORDO_LOG_LEVEL",
        "GORDO_SERVER_LOG_LEVEL",
        "GORDO_ROUTER_LOG_LEVEL",
        "GORDO_SERVER_HOST",
        "GORDO_SERVER_PORT",
        "GORDO_ROUTER_HOST",
        "GORDO_ROUTER_PORT",
    }
)


def declared_env_vars() -> typing.FrozenSet[str]:
    """Every classified GORDO_* env var: knob or explicit non-knob."""
    return frozenset(KNOBS_BY_ENV) | NON_KNOB_ENV_VARS


def tunable_knobs() -> typing.Tuple[Knob, ...]:
    return tuple(k for k in KNOBS if k.tunable)


def knobs_for_subsystem(*subsystems: str) -> typing.Tuple[Knob, ...]:
    wanted = set(subsystems)
    return tuple(k for k in KNOBS if k.subsystem in wanted)


def get_knob(name: str) -> Knob:
    try:
        return KNOBS_BY_NAME[name]
    except KeyError:
        known = ", ".join(sorted(KNOBS_BY_NAME))
        raise KeyError(f"unknown knob {name!r}; known knobs: {known}")
