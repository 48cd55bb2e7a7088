"""
Calibration sweeps (the port of ``gordo_tpu.tuning.calibrate``): for a
fleet with no recorded telemetry, ``tune calibrate`` measures a corpus.

- :func:`epoch_chunk_calibration` fits a synthetic feedforward-hourglass
  fleet with the port's ``FleetTrainer`` once for each ``epoch_chunk``,
  smallest first, and reports each fit's own telemetry
  (``fit_telemetry_``): steady-state epoch seconds and sensor-timesteps a
  second, dispatches and host syncs, and whether its losses are bitwise
  those of the smallest chunk (chunking is scheduling only).
- :func:`batch_wait_calibration` runs, for each ``batch_wait_ms``, an
  in-process port server over a throwaway hourglass collection under
  open-loop Poisson arrivals (a seeded stream), and reports the requests'
  p50 and p99 with the registry's ``gordo_serve_batch_queue_wait_seconds``
  and ``gordo_serve_batch_requests`` histograms, the registry reset
  between arms. The caller's ``MODEL_COLLECTION_DIR`` is left as it was.

The rows have the keys of the JAX sweeps (``benchmarks/fleet_throughput.py``
and ``benchmarks/load_test.py``, which drive the JAX package; this module
carries its own sweep code and imports nothing from ``benchmarks/``).
:func:`run_calibration` writes them as ``results_calibration.json``,
stamped ``bench_schema_version``, an ordinary corpus file. The sweeps run
on the card unless ``device="cpu"`` is given.
"""

import json
import logging
import os
import random
import tempfile
import threading
import time
import typing
import urllib.error
import urllib.request
from datetime import datetime, timezone
from pathlib import Path

from gordo_tpu_torch.utils.atomic import atomic_write_json

logger = logging.getLogger(__name__)

BENCH_SCHEMA_VERSION = 1
CALIBRATION_FILENAME = "results_calibration.json"

#: one machine of the serving sweep's collection (a day of random rows)
_MACHINE_TEMPLATE = """
  - name: bench-m{i}
    dataset:
      type: RandomDataset
      tags: [tag-0, tag-1, tag-2, tag-3]
      target_tag_list: [tag-0, tag-1, tag-2, tag-3]
      train_start_date: '2019-01-01T00:00:00+00:00'
      train_end_date: '2019-01-02T00:00:00+00:00'
      asset: gra
    model:
      gordo_tpu.models.anomaly.DiffBasedAnomalyDetector:
        base_estimator:
          gordo_tpu.models.AutoEncoder:
            kind: feedforward_hourglass
            epochs: 1
"""


class CalibrationUnavailable(RuntimeError):
    """A sweep that cannot run here (the JAX package's name; the port's
    sweeps need nothing outside the package, so only a caller raises it)."""


def epoch_chunk_calibration(chunks: typing.Sequence[int], n_machines: int = 4,
                            n_rows: int = 256, n_features: int = 4, epochs: int = 8,
                            batch_size: int = 32, device=None) -> typing.List[dict]:
    """One row for each chunk of the sweep (module docstring), on
    ``device``."""
    import numpy as np

    from gordo_tpu_torch.models.factories.feedforward import feedforward_hourglass
    from gordo_tpu_torch.parallel.fleet import FleetTrainer, StackedData

    rng = np.random.default_rng(0)
    Xs = [rng.random((n_rows, n_features)).astype("float32") for _ in range(n_machines)]
    data = StackedData.from_ragged(Xs, [x.copy() for x in Xs], device=device)
    spec = feedforward_hourglass(n_features=n_features)
    rows = []
    baseline_losses = None
    # the smallest chunk first: every row compares against a real baseline
    for chunk in sorted(set(int(c) for c in chunks)):
        trainer = FleetTrainer(spec, epoch_chunk=chunk, device=device)
        _, losses = trainer.fit(data, seeds=list(range(n_machines)), epochs=epochs,
                                batch_size=batch_size)
        if baseline_losses is None:
            baseline_losses = losses
        t = trainer.fit_telemetry_
        rows.append({
            "epoch_chunk": chunk,
            "epochs_run": t["epochs_run"],
            "n_dispatches": t["n_dispatches"],
            "n_host_syncs": t["n_host_syncs"],
            "epochs_per_sync": t["epochs_per_sync"],
            "steady_state_epoch_s": t["steady_state_epoch_s"],
            "steady_state_sensor_timesteps_per_s": t["steady_state_sensor_timesteps_per_s"],
            "dispatch_overhead_s": t["dispatch_overhead_s"],
            "dispatch_gap_s_mean": t["dispatch_gap_s_mean"],
            "losses_bitequal_vs_smallest_chunk": bool(np.array_equal(losses, baseline_losses)),
        })
    return rows


def open_loop(url: str, body: bytes, rps: float, duration: float, seed: int):
    """Poisson arrivals at ``rps`` for ``duration`` seconds, a thread a
    request (an arrival never waits for a reply): (latencies in ms,
    errors, sheds, partials, elapsed s). A shed is a 503 with
    ``Retry-After``, a partial a 409 naming casualties; ``elapsed`` runs
    from the first arrival to the last reply."""
    rng = random.Random(seed)
    latencies: list = []
    errors: list = []
    sheds: list = []
    partials: list = []
    done_at: list = []

    def one_request():
        request = urllib.request.Request(url, data=body,
                                         headers={"Content-Type": "application/json"})
        start = time.perf_counter()
        try:
            try:
                with urllib.request.urlopen(request, timeout=60) as reply:
                    reply.read()
            except urllib.error.HTTPError as err:
                detail = err.read()
                retry_after = err.headers.get("Retry-After")
                if err.code == 503 and retry_after is not None:
                    sheds.append(float(retry_after))
                elif err.code == 409:
                    try:
                        named = json.loads(detail).get("unavailable") or {}
                    except ValueError:
                        named = {}
                    partials.append(len(named))
                else:
                    errors.append(err.code)
                return
            except Exception:
                errors.append("exception")
                return
            latencies.append((time.perf_counter() - start) * 1000)
        finally:
            done_at.append(time.perf_counter())

    threads = []
    start = time.perf_counter()
    next_arrival = start
    while next_arrival - start < duration:
        next_arrival += rng.expovariate(rps)
        delay = next_arrival - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        thread = threading.Thread(target=one_request)
        thread.start()
        threads.append(thread)
    for thread in threads:
        thread.join()
    elapsed = (max(done_at) if done_at else time.perf_counter()) - start
    return latencies, errors, sheds, partials, elapsed


def build_collection(n_machines: int, tmp: str, device=None) -> str:
    """A servable collection of ``n_machines`` random-data hourglass
    machines under ``tmp``, built by ``local_build`` on ``device``."""
    from gordo_tpu_torch import serializer
    from gordo_tpu_torch.builder.local_build import local_build

    config = "machines:" + "".join(_MACHINE_TEMPLATE.format(i=i) for i in range(n_machines))
    collection = os.path.join(tmp, "proj", "models", "rev1")
    for fitted, machine in local_build(config, device=device):
        serializer.dump(fitted, os.path.join(collection, machine.name),
                        metadata=machine.to_dict())
    return collection


def batch_wait_calibration(waits_ms: typing.Sequence[float], rps: float = 20.0,
                           duration: float = 5.0, n_machines: int = 2, queue_limit: int = 64,
                           device=None) -> typing.List[dict]:
    """One open-loop arm for each ``batch_wait_ms`` (module docstring),
    each against its own server on a free port."""
    from gordo_tpu_torch.observability.registry import get_registry
    from gordo_tpu_torch.server.app import build_app
    from gordo_tpu_torch.server.runner import make_http_server

    arms: typing.List[dict] = []
    previous_collection = os.environ.get("MODEL_COLLECTION_DIR")
    try:
        with tempfile.TemporaryDirectory(prefix="gordo-tune-calibrate-") as tmp:
            collection = build_collection(n_machines, tmp, device=device)
            os.environ["MODEL_COLLECTION_DIR"] = collection
            machines = sorted(os.listdir(collection))
            # the fleet route's body: one frame (tag -> column) a machine
            rows = [[0.1, 0.2, 0.3, 0.4]] * 8
            frame = {f"tag-{i}": [row[i] for row in rows] for i in range(len(rows[0]))}
            body = json.dumps({"machines": {name: frame for name in machines}}).encode()
            for wait_ms in waits_ms:
                get_registry().reset()
                app = build_app(collection, device=device, batch_wait_ms=float(wait_ms),
                                batch_queue_limit=queue_limit)
                server = make_http_server(app, "127.0.0.1", 0)
                threading.Thread(target=server.serve_forever, daemon=True).start()
                url = f"http://127.0.0.1:{server.server_port}/gordo/v0/proj/prediction/fleet"
                try:
                    latencies, errors, sheds, partials, elapsed = open_loop(
                        url, body, rps=rps, duration=duration, seed=7)
                finally:
                    server.shutdown()
                    server.server_close()
                    app.catalog.stop()
                snap = get_registry().snapshot()
                arm = {
                    "batch_wait_ms": float(wait_ms),
                    "queue_limit": queue_limit,
                    "requests": len(latencies),
                    "errors": len(errors),
                    "sheds": len(sheds),
                    "partials": len(partials),
                    "achieved_rps": round(len(latencies) / elapsed, 2) if elapsed else 0.0,
                }
                if latencies:
                    ordered = sorted(latencies)
                    arm["p50_ms"] = round(ordered[len(ordered) // 2], 3)
                    arm["p99_ms"] = round(
                        ordered[min(len(ordered) - 1, int(len(ordered) * 0.99))], 3)
                # the corpus reader derives queue_wait_p99_ms and
                # mean_batch_size from these
                for metric in ("gordo_serve_batch_queue_wait_seconds",
                               "gordo_serve_batch_requests"):
                    if metric in snap:
                        arm[metric] = snap[metric]
                arms.append(arm)
    finally:
        if previous_collection is None:
            os.environ.pop("MODEL_COLLECTION_DIR", None)
        else:
            os.environ["MODEL_COLLECTION_DIR"] = previous_collection
    return arms


def run_calibration(output_dir: typing.Union[str, Path],
                    epoch_chunks: typing.Sequence[int] = (1, 4, 8), n_machines: int = 4,
                    n_rows: int = 256, n_features: int = 4, epochs: int = 8,
                    batch_size: int = 32,
                    batch_wait_sweep: typing.Optional[typing.Sequence[float]] = None,
                    rps: float = 20.0, duration: float = 5.0, device=None
                    ) -> typing.Tuple[Path, dict]:
    """Run the sweeps on ``device`` and publish ``results_calibration.json``
    under ``output_dir``: (path, payload)."""
    payload: dict = {
        "bench_schema_version": BENCH_SCHEMA_VERSION,
        "kind": "tune_calibration",
        "generated": datetime.now(timezone.utc).isoformat(),
        "epoch_chunk_sweep": epoch_chunk_calibration(
            epoch_chunks, n_machines=n_machines, n_rows=n_rows, n_features=n_features,
            epochs=epochs, batch_size=batch_size, device=device),
    }
    if batch_wait_sweep:
        payload["batch_wait_sweep"] = batch_wait_calibration(
            batch_wait_sweep, rps=rps, duration=duration, device=device)
    path = Path(output_dir) / CALIBRATION_FILENAME
    atomic_write_json(path, payload, indent=2, sort_keys=True)
    logger.info("Calibration written to %s", path)
    return path, payload
