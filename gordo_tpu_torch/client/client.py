"""
The batch prediction client (the port of ``gordo_tpu.client.client``):
it finds a project's revisions and machines on a server (or a router),
rebuilds each machine's dataset with its own data provider over the
asked range (its start moved back by the model's offset), cuts the rows
into chunks and posts them to ``/anomaly/prediction``, or to
``/prediction`` once a machine answers 422 there, with jittered
exponential retries; each answered chunk goes to an optional forwarder.

The JAX client runs on ``requests`` and pandas, which the card's machine
lacks. This one calls the server with ``utils/http.py``'s
``HttpTransport`` (``http.client``, kept-alive connections,
``TCP_NODELAY``) and returns :class:`BlockFrame` frames (the JAX client's
two-level columns as blocks). Its requests carry the JAX client's data:
the same rows from the same provider give the same replies. A client
takes ``headers`` sent with every call (the JAX ``session``'s headers)
and, for tests, a ``transport``. Metadata calls time out after
``metadata_timeout`` seconds; scoring calls wait as long as the server
takes (only their connect is bounded). Parquet bodies need pyarrow,
which the port does not use: ``use_parquet=True`` raises.

Tracing, as the JAX client's: ``client.predict`` spans each run,
``client.predict_machine`` or ``client.predict_group`` each machine or
group under it (the parent handed to the pool's threads), and one
``client.request`` span each chunk, retries and the 422 fallback
included, whose ``traceparent`` rides every attempt. Its calls are
counted in the process registry (``gordo_client_request_seconds``,
``gordo_client_requests_total``, ``gordo_client_retries_total``).
"""

import http.client
import itertools
import json
import logging
from concurrent.futures import ThreadPoolExecutor
from datetime import datetime, timedelta, timezone
from time import monotonic, sleep
from typing import Any, Callable, Dict, List, Optional, Set, Tuple
from urllib.parse import urlencode

from gordo_tpu_torch.client.frames import concat_frames, frame_from_reply, frame_to_dict
from gordo_tpu_torch.client.io import (
    BadGordoRequest,
    HttpUnprocessableEntity,
    MachineUnavailable,
    NotFound,
    ReplicaUnavailable,
    ResourceGone,
    handle_response,
)
from gordo_tpu_torch.client.utils import (
    DEFAULT_RETRY_JITTER,
    PredictionResult,
    backoff_seconds,
    cached_method,
    retry_after_seconds,
)
from gordo_tpu_torch.machine import Machine
from gordo_tpu_torch.models.utils import BlockFrame, Frame
from gordo_tpu_torch.observability import tracing
from gordo_tpu_torch.observability.registry import get_registry
from gordo_tpu_torch.utils.compat import frequency_to_ns
from gordo_tpu_torch.utils.http import HttpTransport

logger = logging.getLogger(__name__)

#: transport failures a prediction call retries
TRANSPORT_ERRORS = (OSError, http.client.HTTPException)


def _observe_request(path: str, outcome: str, seconds: float) -> None:
    """One prediction POST's latency and outcome (path ``fleet`` or
    ``single``; outcome ok, io_error, refused, gone or unavailable)."""
    reg = get_registry()
    reg.histogram(
        "gordo_client_request_seconds", "Client prediction POST latency", ("path", "outcome"),
    ).observe(seconds, path=path, outcome=outcome)
    reg.counter(
        "gordo_client_requests_total", "Client prediction POSTs by outcome", ("path", "outcome"),
    ).inc(path=path, outcome=outcome)


def _count_retry(path: str) -> None:
    get_registry().counter(
        "gordo_client_retries_total", "Prediction POST retries after IO errors", ("path",),
    ).inc(path=path)


def _retry_sleep_seconds(exc: Exception, attempt: int) -> float:
    """A shedding server's ``Retry-After`` as the base, jittered up;
    else the exponential backoff, jittered down."""
    retry_after = getattr(exc, "retry_after", None)
    if retry_after is not None:
        return retry_after_seconds(retry_after, jitter=DEFAULT_RETRY_JITTER)
    return backoff_seconds(attempt, jitter=DEFAULT_RETRY_JITTER)


def refuse_parquet() -> None:
    raise ImportError(
        "Parquet bodies need the 'pyarrow' package, which this port does not use; "
        "the client sends JSON (ROADMAP.md queue 3 item 1 (i))"
    )


class Client:
    """
    A client of one project on a server: routes are
    ``<scheme>://<host>:<port>/gordo/v0/<project>/...``.

    ``data_provider`` fetches the machines' raw data again; a
    ``prediction_forwarder`` is called as ``forwarder(predictions=...,
    machine=..., metadata=...)`` with each answered chunk (and
    ``resampled_sensor_data=`` with the raw frames when
    ``forward_resampled_sensors``). ``batch_size`` rows a POST,
    ``parallelism`` threads, ``n_retries`` retries a chunk.
    """

    #: seconds before a metadata call gives up
    DEFAULT_METADATA_TIMEOUT_S = 30.0

    def __init__(
        self,
        project: str,
        host: str = "localhost",
        port: int = 443,
        scheme: str = "https",
        metadata: Optional[dict] = None,
        data_provider=None,
        prediction_forwarder: Optional[Callable[..., None]] = None,
        batch_size: int = 100000,
        parallelism: int = 10,
        forward_resampled_sensors: bool = False,
        n_retries: int = 5,
        use_parquet: bool = False,
        headers: Optional[Dict[str, str]] = None,
        transport: Optional[HttpTransport] = None,
        metadata_timeout: Optional[float] = DEFAULT_METADATA_TIMEOUT_S,
    ):
        if use_parquet:
            refuse_parquet()
        self.base_url = f"{scheme}://{host}:{port}"
        self.server_endpoint = f"{self.base_url}/gordo/v0/{project}"
        self.metadata = metadata if metadata is not None else dict()
        self.prediction_forwarder = prediction_forwarder
        self.data_provider = data_provider
        self.use_parquet = False
        self.project_name = project
        # a machine that answers 422 on /anomaly/prediction is remembered
        # and posted to /prediction from then on
        self.prediction_path = "/anomaly/prediction"
        self._fallback_machines: Set[str] = set()
        self.batch_size = batch_size
        self.parallelism = parallelism
        self.forward_resampled_sensors = forward_resampled_sensors
        self.n_retries = n_retries
        self.format = "json"
        self.headers = dict(headers or {})
        self.transport = transport or HttpTransport()
        self.metadata_timeout = metadata_timeout

    # -- calls ---------------------------------------------------------------
    def _get(self, url: str, params: Optional[dict] = None):
        if params:
            url = f"{url}?{urlencode(params)}"
        return self.transport.request("GET", url, headers=dict(self.headers),
                                      timeout=self.metadata_timeout)

    def _post_json(self, url: str, payload: Any, params: Optional[dict] = None,
                   headers: Optional[Dict[str, str]] = None):
        """A scoring POST: the body encoded as ``requests`` encodes
        ``json=`` (NaN refused); connect bounded, no read timeout."""
        if params:
            url = f"{url}?{urlencode(params)}"
        body = json.dumps(payload, allow_nan=False).encode()
        sent = {**self.headers, **(headers or {}), "Content-Type": "application/json"}
        return self.transport.request("POST", url, body=body, headers=sent,
                                      timeout=(self.metadata_timeout, None))

    # -- discovery -----------------------------------------------------------
    @cached_method(maxsize=1, ttl=5)
    def get_revisions(self) -> dict:
        """``{"latest": ..., "available-revisions": [...]}``."""
        resp = self._get(f"{self.server_endpoint}/revisions")
        return handle_response(resp, resource_name="List of available revisions from server")

    def _get_latest_revision(self) -> str:
        return self.get_revisions()["latest"]

    @cached_method(maxsize=64, ttl=30)
    def _get_available_machines(self, revision: str) -> dict:
        resp = self._get(f"{self.server_endpoint}/models", {"revision": revision})
        model_response = handle_response(
            resp, resource_name=f"Model name listing for revision {revision}"
        )
        if "models" not in model_response:
            raise ValueError(
                f"Invalid response from server, key 'models' not found in: {model_response}"
            )
        model_response["revision"] = model_response.get("revision", revision)
        return model_response

    def get_available_machines(self, revision: Optional[str] = None) -> dict:
        """The ``/models`` reply for ``revision`` (default: latest)."""
        return self._get_available_machines(revision or self._get_latest_revision())

    def get_machine_names(self, revision: Optional[str] = None) -> List[str]:
        """The machines served under ``revision`` (default: latest)."""
        return self.get_available_machines(revision=revision).get("models")

    def _get_machines(self, revision: Optional[str] = None,
                      machine_names: Optional[List[str]] = None) -> List[Machine]:
        """Each machine from its metadata route, fetched at once."""
        _revision = revision or self._get_latest_revision()
        names = machine_names or self.get_machine_names(revision=_revision)
        with ThreadPoolExecutor(max_workers=self.parallelism) as executor:
            return list(executor.map(lambda name: self._machine_from_server(name, _revision),
                                     names))

    @cached_method(maxsize=25000)
    def _machine_from_server(self, name: str, revision: str) -> Machine:
        resp = self._get(f"{self.server_endpoint}/{name}/metadata", {"revision": revision})
        metadata = handle_response(resp, resource_name=f"Machine metadata for {name}")
        if isinstance(metadata, dict) and metadata.get("metadata"):
            return Machine.unvalidated(**metadata["metadata"])
        raise NotFound(f"Machine {name} not found")

    # -- models --------------------------------------------------------------
    def download_archives(self, revision: Optional[str] = None,
                          targets: Optional[List[str]] = None) -> Dict[str, bytes]:
        """Each machine's ``/download-model`` archive (the port's gzipped
        tar of its artifact), for ``revision`` (default: latest)."""
        archives = {}
        _revision = revision or self._get_latest_revision()
        for machine_name in targets or self.get_machine_names(revision=_revision):
            resp = self._get(f"{self.server_endpoint}/{machine_name}/download-model",
                             {"revision": _revision})
            content = handle_response(
                resp, resource_name=f"Model download for model {machine_name}"
            )
            if not isinstance(content, bytes):
                raise ValueError(
                    f"Unexpected return type {type(content)} downloading model {machine_name}"
                )
            archives[machine_name] = content
        return archives

    def download_model(self, revision: Optional[str] = None,
                       targets: Optional[List[str]] = None, device=None) -> Dict[str, Any]:
        """Each machine's model from its archive, its weights on
        ``device`` (the card unless ``"cpu"`` is asked for)."""
        from gordo_tpu_torch import serializer

        return {name: serializer.loads(data, device)
                for name, data in self.download_archives(revision, targets).items()}

    def get_metadata(self, revision: Optional[str] = None,
                     targets: Optional[List[str]] = None) -> Dict[str, Any]:
        """Machine name -> its :class:`Metadata`."""
        machines = self._get_machines(revision=revision, machine_names=targets)
        return {machine.name: machine.metadata for machine in machines}

    # -- prediction ----------------------------------------------------------
    def predict(self, start: datetime, end: datetime, targets: Optional[List[str]] = None,
                revision: Optional[str] = None) -> List[PredictionResult]:
        """
        Predictions for [start, end] of every machine (or ``targets``),
        machines on a thread pool: one :class:`PredictionResult` each,
        ``(name, frame, error messages)`` with ``.revision`` the revision
        the server stamped on the replies (None for none or a mix).
        """
        _revision = revision or self._get_latest_revision()
        machines = self._get_machines(revision=_revision, machine_names=targets)
        with tracing.start_span("client.predict", path="single",
                                n_machines=len(machines)) as span:
            parent_ctx = span.context
            with ThreadPoolExecutor(max_workers=self.parallelism) as executor:
                return list(executor.map(
                    lambda machine: self._predict_single_traced(
                        parent_ctx, machine=machine, start=start, end=end, revision=_revision),
                    machines,
                ))

    def _predict_single_traced(self, parent_ctx, machine: Machine, start, end,
                               revision) -> PredictionResult:
        with tracing.start_span("client.predict_machine", parent=parent_ctx,
                                machine=machine.name):
            return self.predict_single_machine(machine=machine, start=start, end=end,
                                               revision=revision)

    def predict_fleet(self, start: datetime, end: datetime, targets: Optional[List[str]] = None,
                      revision: Optional[str] = None,
                      group_size: int = 8) -> List[PredictionResult]:
        """
        Predictions through the fleet routes: ``group_size`` machines a
        POST, each group's chunk scored by one stacked forward on the
        server. A group the route refuses (422: a machine that is no
        anomaly detector) before anything was answered goes machine by
        machine; a machine known to refuse the anomaly route goes in
        groups to ``/prediction/fleet``. Results as :meth:`predict`'s.
        """
        _revision = revision or self._get_latest_revision()
        machines = self._get_machines(revision=_revision, machine_names=targets)
        base_path = [m for m in machines if m.name in self._fallback_machines]
        anomaly_path = [m for m in machines if m.name not in self._fallback_machines]
        size = max(1, group_size)
        jobs: List[Tuple[List[Machine], bool]] = []
        for pool, use_base in ((anomaly_path, False), (base_path, True)):
            jobs.extend((pool[i : i + size], use_base) for i in range(0, len(pool), size))
        results: List[PredictionResult] = []
        with tracing.start_span("client.predict", path="fleet",
                                n_machines=len(machines)) as span:
            parent_ctx = span.context
            with ThreadPoolExecutor(max_workers=self.parallelism) as executor:
                for group_results in executor.map(
                    lambda job: self._predict_group_traced(
                        parent_ctx, job[0], start=start, end=end, revision=_revision,
                        use_base_path=job[1]),
                    jobs,
                ):
                    results.extend(group_results)
        return results

    def _predict_group_traced(self, parent_ctx, group, start, end, revision,
                              use_base_path) -> List[PredictionResult]:
        with tracing.start_span("client.predict_group", parent=parent_ctx,
                                n_machines=len(group)):
            return self._predict_machine_group(group, start=start, end=end, revision=revision,
                                               use_base_path=use_base_path)

    def _predict_machine_group(self, group: List[Machine], start: datetime, end: datetime,
                               revision: str,
                               use_base_path: bool = False) -> List[PredictionResult]:
        """One group: its raw data, then its row chunks to the fleet route."""
        anomaly = not use_base_path and self.prediction_path == "/anomaly/prediction"
        url = (f"{self.server_endpoint}/anomaly/prediction/fleet" if anomaly
               else f"{self.server_endpoint}/prediction/fleet")
        data: Dict[str, Tuple[Machine, Frame, Frame]] = {}
        for machine in group:
            X, y = self._raw_data(machine, start, end)
            if y is None:
                y = X
            if self.prediction_forwarder is not None and self.forward_resampled_sensors:
                self.prediction_forwarder(resampled_sensor_data=X)
            data[machine.name] = (machine, X, y)
        chunk_bounds = {
            name: self._row_chunks(len(X.index), self.batch_size, self._min_chunk_rows(machine))
            for name, (machine, X, _) in data.items()
        }
        n_chunks = max((len(b) for b in chunk_bounds.values()), default=0)
        frames: Dict[str, List[BlockFrame]] = {name: [] for name in data}
        errors: Dict[str, List[str]] = {name: [] for name in data}
        # casualties the server named (409): out of the group's payloads
        # for good, their error recorded once
        excluded: Set[str] = set()
        served_revisions: Dict[str, set] = {name: set() for name in data}

        def build_payload(k: int):
            payload: Dict[str, Any] = {}
            chunk_names: List[str] = []
            for name, (machine, X, y) in data.items():
                if name in excluded or k >= len(chunk_bounds[name]):
                    continue
                rows = slice(*chunk_bounds[name][k])
                if not len(X.index[rows]):
                    continue
                chunk_names.append(name)
                if anomaly:
                    payload[name] = {"X": frame_to_dict(X, rows), "y": frame_to_dict(y, rows)}
                else:
                    payload[name] = frame_to_dict(X, rows)
            return payload, chunk_names

        for k in range(n_chunks):
            payload, chunk_names = build_payload(k)
            if not payload:
                continue
            while True:
                status, resp, chunk_revision = self._post_fleet_chunk(url, payload, revision)
                if status != "unavailable":
                    break
                # the 409 names the casualties: record each once, drop
                # them, and post the chunk again for the rest
                named = set(resp.unavailable or {}) & set(data)
                bad = named - excluded
                if not bad:
                    # a 409 naming nothing that was sent: no progress is
                    # possible, so this chunk alone is recorded as failed
                    for name in chunk_names:
                        bounds = chunk_bounds[name][k]
                        errors[name].append(
                            f"Fleet chunk rows {bounds[0]}:{bounds[1]} failed for '{name}': "
                            "server answered 409 without naming a machine in the payload "
                            f"({resp})"
                        )
                    status = "skipped"
                    break
                transient = isinstance(resp, ReplicaUnavailable)
                for name in sorted(bad):
                    info = (resp.unavailable or {}).get(name) or {}
                    if transient:
                        errors[name].append(
                            f"Machine '{name}' is temporarily unroutable "
                            f"({info.get('reason', 'replica_unavailable')}, replica "
                            f"{info.get('replica', 'unknown')}): transient; recorded for "
                            "this run, retry later"
                        )
                    else:
                        errors[name].append(
                            f"Machine '{name}' is unavailable on the server "
                            f"({info.get('reason', 'unknown')}): permanent for this "
                            "revision; recorded, not retried"
                        )
                excluded |= bad
                payload, chunk_names = build_payload(k)
                if not payload:
                    status = "skipped"
                    break
            if status == "skipped":
                continue
            if status == "refused" and not any(frames.values()):
                # refused before anything was answered or forwarded:
                # machine by machine (casualties keep their errors)
                return [
                    self.predict_single_machine(machine=machine, start=start, end=end,
                                                revision=revision)
                    if name not in excluded
                    else PredictionResult(name=name, predictions=BlockFrame([]),
                                          error_messages=errors[name])
                    for name, (machine, _, _) in data.items()
                ]
            if status != "ok":
                # a failure after earlier chunks were forwarded: this
                # chunk is recorded failed for each of its machines
                for name in chunk_names:
                    (s, e) = chunk_bounds[name][k]
                    errors[name].append(f"Fleet chunk rows {s}:{e} failed for '{name}': {resp}")
                continue
            for name, frame_dict in resp["data"].items():
                frame = frame_from_reply(frame_dict)
                frames[name].append(frame)
                if chunk_revision is not None:
                    served_revisions[name].add(chunk_revision)
                if self.prediction_forwarder is not None:
                    self.prediction_forwarder(predictions=frame, machine=data[name][0],
                                              metadata=self.metadata)

        for name, seen in served_revisions.items():
            if len(seen) > 1:
                errors[name].append(
                    f"Chunks for '{name}' were served by MIXED revisions {sorted(seen)}; "
                    "result revision recorded as unknown"
                )
        return [
            PredictionResult(
                name=name,
                predictions=concat_frames(frames[name]),
                error_messages=errors[name],
                revision=(next(iter(served_revisions[name]))
                          if len(served_revisions[name]) == 1 else None),
            )
            for name in data
        ]

    def _post_fleet_chunk(self, url: str, payload: Dict[str, Any], revision: str):
        """
        One fleet chunk under one ``client.request`` span (its
        ``traceparent`` on every retry), as ``(status, reply or error,
        served revision)``: ``ok`` with the reply; ``refused`` (a 4xx the
        server would repeat); ``unavailable`` with the
        :class:`MachineUnavailable` naming the casualties; ``io_error``
        once the retries are spent. A 410 raises.
        """
        with tracing.start_span("client.request", path="fleet") as span:
            return self._post_fleet_chunk_traced(url, payload, revision, span)

    def _post_fleet_chunk_traced(self, url, payload, revision, span):
        headers = tracing.propagation_headers(span)
        served_revision: Optional[str] = None
        for current_attempt in itertools.count(start=1):
            attempt_start = monotonic()
            try:
                raw = self._post_json(url, {"machines": payload}, {"revision": revision},
                                      headers)
                # the revision the server served, stamped on every reply
                served_revision = raw.headers.get("revision") or served_revision
                result = "ok", handle_response(raw), served_revision
                _observe_request("fleet", "ok", monotonic() - attempt_start)
                return result
            except TRANSPORT_ERRORS as exc:
                _observe_request("fleet", "io_error", monotonic() - attempt_start)
                if current_attempt <= self.n_retries:
                    _count_retry("fleet")
                    time_to_sleep = _retry_sleep_seconds(exc, current_attempt)
                    logger.warning("Fleet chunk failed attempt %d of %d; retrying in %.1fs",
                                   current_attempt, self.n_retries, time_to_sleep)
                    sleep(time_to_sleep)
                    continue
                logger.error("Fleet chunk failed after retries: %s", exc)
                message = str(exc)
                if span.recording:
                    message += f" (trace id: {span.trace_id})"
                return "io_error", message, served_revision
            except ResourceGone:
                _observe_request("fleet", "gone", monotonic() - attempt_start)
                raise
            except MachineUnavailable as exc:
                _observe_request("fleet", "unavailable", monotonic() - attempt_start)
                logger.warning("Fleet endpoint refused group with 409 (unavailable machines: %s)",
                               sorted(exc.unavailable) or "unnamed")
                return "unavailable", exc, served_revision
            except (HttpUnprocessableEntity, BadGordoRequest, NotFound) as exc:
                _observe_request("fleet", "refused", monotonic() - attempt_start)
                logger.warning("Fleet endpoint refused group (%s); falling back to per-machine "
                               "path", exc)
                return "refused", str(exc), served_revision

    def predict_single_machine(self, machine: Machine, start: datetime, end: datetime,
                               revision: str) -> PredictionResult:
        """One machine's raw data, posted chunk by chunk on a thread pool."""
        X, y = self._raw_data(machine, start, end)
        if self.prediction_forwarder is not None and self.forward_resampled_sensors:
            self.prediction_forwarder(resampled_sensor_data=X)
        chunks = self._row_chunks(len(X.index), self.batch_size, self._min_chunk_rows(machine))
        # the pool's threads do not inherit the context: hand it over
        parent_ctx = tracing.current_context()
        with ThreadPoolExecutor(max_workers=self.parallelism) as executor:
            jobs = executor.map(
                lambda bounds: self._send_prediction_request(
                    X, y, chunk=slice(*bounds), machine=machine, start=X.index[bounds[0]],
                    end=X.index[bounds[1] - 1], revision=revision, trace_parent=parent_ctx),
                chunks,
            )
            prediction_frames = []
            error_messages: List[str] = []
            served: Set[str] = set()
            for result in jobs:
                if result.predictions is not None:
                    prediction_frames.append(result.predictions)
                error_messages.extend(result.error_messages)
                if result.revision is not None:
                    served.add(result.revision)
            predictions = concat_frames(prediction_frames)
        if len(served) > 1:
            error_messages.append(
                f"Batches for '{machine.name}' were served by MIXED revisions {sorted(served)}; "
                "result revision recorded as unknown"
            )
        return PredictionResult(name=machine.name, predictions=predictions,
                                error_messages=error_messages,
                                revision=next(iter(served)) if len(served) == 1 else None)

    def _send_prediction_request(self, X: Frame, y: Optional[Frame], chunk: slice,
                                 machine: Machine, start: datetime, end: datetime, revision: str,
                                 trace_parent=None) -> PredictionResult:
        """
        One chunk: 422 moves the machine to ``/prediction`` for good;
        transport errors retry with backoff; another 4xx or a 409 gives
        the chunk up; a 410 raises. Every attempt and the fallback run
        under one ``client.request`` span.
        """
        with tracing.start_span("client.request", parent=trace_parent, path="single",
                                machine=machine.name) as span:
            return self._send_prediction_request_traced(X, y, chunk, machine, start, end,
                                                        revision, span)

    def _send_prediction_request_traced(self, X, y, chunk, machine, start, end, revision, span):
        path = "/prediction" if machine.name in self._fallback_machines else self.prediction_path
        url = f"{self.server_endpoint}/{machine.name}{path}"
        params = {"format": self.format, "revision": revision}
        headers = tracing.propagation_headers(span)
        body = {
            "X": frame_to_dict(X, chunk),
            "y": frame_to_dict(y, chunk) if y is not None else None,
        }
        served_revision: Optional[str] = None

        def post(target: str) -> Any:
            nonlocal served_revision
            raw = self._post_json(target, body, params, headers)
            served_revision = raw.headers.get("revision") or served_revision
            return handle_response(raw)

        for current_attempt in itertools.count(start=1):
            attempt_start = monotonic()
            try:
                try:
                    resp = post(url)
                except HttpUnprocessableEntity:
                    self._fallback_machines.add(machine.name)
                    url = f"{self.server_endpoint}/{machine.name}/prediction"
                    resp = post(url)
            except TRANSPORT_ERRORS as exc:
                _observe_request("single", "io_error", monotonic() - attempt_start)
                if current_attempt <= self.n_retries:
                    _count_retry("single")
                    time_to_sleep = _retry_sleep_seconds(exc, current_attempt)
                    logger.warning("Failed attempt %d of %d; retrying in %.1fs",
                                   current_attempt, self.n_retries, time_to_sleep)
                    sleep(time_to_sleep)
                    continue
                msg = (f"Failed to get predictions for dates {start} -> {end} "
                       f"for target: '{machine.name}' Error: {exc}")
                if span.recording:
                    msg += f" (trace id: {span.trace_id})"
                logger.error(msg)
                return PredictionResult(name=machine.name, predictions=None,
                                        error_messages=[msg], revision=served_revision)
            except MachineUnavailable as exc:
                _observe_request("single", "unavailable", monotonic() - attempt_start)
                if isinstance(exc, ReplicaUnavailable):
                    msg = (f"Machine '{machine.name}' is temporarily unroutable (replica "
                           f"outage) for dates {start} -> {end}: {exc}; transient — retry later")
                else:
                    msg = (f"Machine '{machine.name}' is unavailable on the server for dates "
                           f"{start} -> {end}: {exc}")
                logger.error(msg)
                return PredictionResult(name=machine.name, predictions=None,
                                        error_messages=[msg], revision=served_revision)
            except (HttpUnprocessableEntity, BadGordoRequest, NotFound) as exc:
                _observe_request("single", "refused", monotonic() - attempt_start)
                msg = (f"Failed with bad request or not found for dates {start} -> {end} for "
                       f"target: '{machine.name}' Error: {exc}")
                logger.error(msg)
                return PredictionResult(name=machine.name, predictions=None,
                                        error_messages=[msg], revision=served_revision)
            except ResourceGone:
                _observe_request("single", "gone", monotonic() - attempt_start)
                raise
            else:
                _observe_request("single", "ok", monotonic() - attempt_start)
                predictions = self.dataframe_from_response(resp)
                if self.prediction_forwarder is not None:
                    self.prediction_forwarder(predictions=predictions, machine=machine,
                                              metadata=self.metadata)
                return PredictionResult(name=machine.name, predictions=predictions,
                                        error_messages=[], revision=served_revision)

    # -- streaming -----------------------------------------------------------
    def stream_machine(self, machines, revision: Optional[str] = None,
                       backoff_scale: float = 1.0):
        """
        A scoring stream for one machine (or several)::

            with client.stream_machine("pump-07") as stream:
                for rows in feed:
                    scores = stream.send(rows)

        The :class:`~gordo_tpu_torch.client.streaming.StreamPublisher`
        keeps each machine's window tail and reconnects when the session
        is shed, lost, rolled to a new revision or failed over. A pinned
        ``revision`` rides every call; by default the stream follows
        ``latest``.
        """
        from gordo_tpu_torch.client.streaming import StreamPublisher

        names = [machines] if isinstance(machines, str) else list(machines)
        return StreamPublisher(
            transport=self.transport,
            server_endpoint=self.server_endpoint,
            machines=names,
            revision=revision,
            n_retries=self.n_retries,
            # an update is a scoring call: a connect bound only
            timeout=(self.metadata_timeout, None),
            backoff_scale=backoff_scale,
            headers=self.headers,
        )

    # -- data ----------------------------------------------------------------
    def _raw_data(self, machine: Machine, start: datetime,
                  end: datetime) -> Tuple[Frame, Optional[Frame]]:
        """The machine's dataset rebuilt with the client's provider over
        [start - (model_offset + 5) resolutions, end], as frames."""
        resolution = machine.dataset.resolution
        n_intervals = machine.metadata.build_metadata.model.model_offset + 5
        start = self._adjust_for_offset(dt=start, resolution=resolution,
                                        n_intervals=n_intervals)
        config = machine.dataset.to_dict()
        config.update(dict(data_provider=self.data_provider, train_start_date=start,
                           train_end_date=end))
        dataset = machine.dataset.from_dict(config)
        X, y, index = dataset.get_data()
        from gordo_tpu_torch.data.base import to_datetimes

        stamps = to_datetimes(index.astype("int64"))
        x_columns = [name for tag in dataset.tag_list for name in dataset._columns_of(tag)]
        y_columns = list(dataset.target_columns)
        return Frame(X, x_columns, stamps), Frame(y, y_columns, stamps)

    @staticmethod
    def _adjust_for_offset(dt: datetime, resolution: str, n_intervals: int = 100) -> datetime:
        """
        ``dt - n_intervals * resolution``.

        >>> from datetime import datetime
        >>> date = datetime.fromisoformat("2019-01-01T12:00:00+00:00")
        >>> str(Client._adjust_for_offset(date, resolution='15min', n_intervals=5))
        '2019-01-01 10:45:00+00:00'
        """
        step = timedelta(microseconds=frequency_to_ns(resolution) / 1000)
        return dt - step * n_intervals

    @staticmethod
    def _row_chunks(n_rows: int, batch_size: int, min_rows: int = 1) -> List[Tuple[int, int]]:
        """
        [start, end) bounds of about ``batch_size`` rows; a last chunk
        shorter than ``min_rows`` joins the one before it (a windowed
        model consumes ``model_offset`` rows before its first output).

        >>> Client._row_chunks(78, 40, min_rows=5)
        [(0, 40), (40, 78)]
        >>> Client._row_chunks(90, 40, min_rows=5)
        [(0, 40), (40, 80), (80, 90)]
        >>> Client._row_chunks(90, 17, min_rows=32)
        [(0, 32), (32, 90)]
        """
        batch_size = max(batch_size, min_rows)
        bounds = [(s, min(s + batch_size, n_rows)) for s in range(0, n_rows, batch_size)]
        if len(bounds) > 1 and bounds[-1][1] - bounds[-1][0] < min_rows:
            bounds.pop()
            bounds[-1] = (bounds[-1][0], n_rows)
        return bounds

    @staticmethod
    def _min_chunk_rows(machine: Machine) -> int:
        offset = 0
        try:
            offset = int(machine.metadata.build_metadata.model.model_offset or 0)
        except AttributeError:
            pass
        return offset + 1

    @staticmethod
    def dataframe_from_response(response) -> BlockFrame:
        """A prediction reply's ``data`` as a frame; a parquet (bytes)
        reply is refused."""
        if isinstance(response, dict):
            return frame_from_reply(response["data"])
        refuse_parquet()


def make_date_ranges(start: datetime, end: datetime, max_interval_days: int,
                     freq: str = "h") -> List[Tuple[datetime, datetime]]:
    """
    [start, end] cut into consecutive ``freq`` intervals from ``start``
    when it spans ``max_interval_days`` days or more, the remainder past
    the last whole interval appended (as the JAX client does); else the
    pair itself. ``freq`` is a fixed frequency ("h", "30min", "1D").
    """
    if (end - start).days >= max_interval_days:
        step = timedelta(microseconds=frequency_to_ns(freq) / 1000)
        # absolute steps, as pandas takes a fixed frequency, in start's zone
        origin = start.astimezone(timezone.utc)
        n_steps = int((end.astimezone(timezone.utc) - origin) // step)
        stamps = [(origin + i * step).astimezone(start.tzinfo) for i in range(n_steps + 1)]
        ranges = [(stamps[i], stamps[i + 1]) for i in range(len(stamps) - 1)]
        if stamps and stamps[-1] < end:
            ranges.append((stamps[-1], end))
        return ranges
    return [(start, end)]
