#!/usr/bin/env python3
"""
Smoke run of the PyTorch/CUDA port (``gordo_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--out results.json] [--profile]

Phases, each raising on failure (no result line is printed then):

1. the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel from ``gordo_tpu_torch/csrc`` with nvcc for
   sm_90a, one nvcc per source, all started together;
3. each kernel against its plain PyTorch version on the card, at the
   shapes the serving path gives it and a few more, with its time beside
   the plain version's, one PyTorch library call's (a yardstick only) and
   the bound (the larger of bytes over 3.35 TB/s and operations over the
   type's peak rate, published H100 SXM figures);
4. end to end: the ``turbine-9900-transformer`` machine of
   ``examples/config.yaml`` at full width with ``attention_impl: flash``
   (random weights from a numpy seed in the Flax layout, carried over by
   ``gordo_tpu_torch.convert``), served over HTTP by the port's server on
   the card; ``/prediction`` and ``/anomaly/prediction`` with 144 rows and
   with 8255 rows (one full 8192-window chunk); launch counts reset just
   before and read just after; model output held against the same
   artifact on the CPU;
5. one JSON line of per-kernel numbers, then the result line.

Exits non-zero without a result line when no CUDA card is available.
"""

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from datetime import datetime, timedelta, timezone

SEED = 1234
# published H100 SXM peaks (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}
TOLERANCE = {"float32": 1e-4, "bfloat16": 2e-2}

# examples/config.yaml, machine turbine-9900-transformer, + attention_impl flash
MACHINE = "turbine-9900-transformer"
TAGS = ["GRA-TURB-SPEED 1", "GRA-TURB-TEMP 2", "GRA-TURB-LOAD 3"]
BASE_ESTIMATOR = {
    "kind": "transformer_model",
    "lookback_window": 64,
    "d_model": 64,
    "n_heads": 4,
    "n_layers": 2,
    "epochs": 10,
    "attention_impl": "flash",
}
DEFINITION = {
    "gordo_tpu.models.anomaly.DiffBasedAnomalyDetector": {
        "base_estimator": {"gordo_tpu.models.TransformerAutoEncoder": BASE_ESTIMATOR}
    }
}
CHUNK_WINDOWS = 8192
# timed requests per (route, size); the first includes the model's load
REPEATS = 5


def log(*parts) -> None:
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
        timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn``, after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def attention_bound(shape, causal: bool, dtype_name: str, elem_bytes: int):
    """(bound ms, "bytes" or "operations") for one forward call: q, k, v
    read once, out and the float32 LSE written once; 4·head_dim operations
    per (query, key) pair the mask keeps."""
    batch, seq, heads, head_dim = shape
    n = batch * seq * heads * head_dim
    moved = 4 * n * elem_bytes + batch * heads * seq * 4
    pairs = seq * (seq + 1) // 2 if causal else seq * seq
    ops = 4 * head_dim * batch * heads * pairs
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def kernel_phase(torch, fa):
    """Phase 3: the flash forward kernel against its plain version."""
    import torch.nn.functional as F

    cases = [
        ("model-shape", (8192, 64, 4, 16), True, torch.float32),
        ("ragged-causal", (4, 1000, 2, 64), True, torch.float32),
        ("ragged-full", (4, 1000, 2, 64), False, torch.float32),
        ("head-dim-32", (16, 200, 2, 32), True, torch.float32),
        ("head-dim-128", (2, 300, 2, 128), False, torch.float32),
        ("model-shape-bf16", (8192, 64, 4, 16), True, torch.bfloat16),
    ]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    results = []
    for name, shape, causal, dtype in cases:
        q, k, v = (
            torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(3)
        )
        out, lse = fa.flash_attention_forward(q, k, v, causal=causal)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.flash_attention_reference(q, k, v, causal=causal)
        err_out = (out.float() - ref_out.float()).abs().max().item()
        err_lse = (lse - ref_lse).abs().max().item()
        dtype_name = str(dtype).replace("torch.", "")
        tol = TOLERANCE[dtype_name]
        ms = time_ms(lambda: fa.flash_attention_forward(q, k, v, causal=causal))
        plain_ms = time_ms(
            lambda: fa.flash_attention_reference(q, k, v, causal=causal), reps=5
        )
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        library_ms = time_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
        )
        bound_ms, bound_by = attention_bound(shape, causal, dtype_name, q.element_size())
        row = {
            "case": name,
            "shape": list(shape),
            "causal": causal,
            "dtype": dtype_name,
            "max_abs_err": err_out,
            "max_abs_err_lse": err_lse,
            "tolerance": tol,
            "ms": ms,
            "plain_ms": plain_ms,
            "library_ms": library_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
        }
        log("kernel-check", json.dumps(row))
        if not (err_out <= tol and err_lse <= tol):
            raise AssertionError(f"flash_attention_fwd disagrees with its plain version: {row}")
        results.append(row)
        del q, k, v, out, lse, ref_out, ref_lse
        torch.cuda.empty_cache()
    return results


def flax_layout_tree(rng, n_features, d_model, n_layers, ff_dim):
    """Random TransformerNet weights in the Flax parameter layout."""
    import numpy as np

    def dense(n_in, n_out):
        return {
            "kernel": (rng.normal(size=(n_in, n_out)) / math.sqrt(n_in)).astype(np.float32),
            "bias": (0.02 * rng.normal(size=n_out)).astype(np.float32),
        }

    def norm(n):
        return {
            "scale": (1.0 + 0.1 * rng.normal(size=n)).astype(np.float32),
            "bias": (0.1 * rng.normal(size=n)).astype(np.float32),
        }

    params = {"embed": dense(n_features, d_model)}
    for i in range(n_layers):
        params[f"TransformerBlock_{i}"] = {
            "LayerNorm_0": norm(d_model),
            "MultiHeadSelfAttention_0": {
                proj: dense(d_model, d_model) for proj in ("query", "key", "value", "out")
            },
            "LayerNorm_1": norm(d_model),
            "Dense_0": dense(d_model, ff_dim),
            "Dense_1": dense(ff_dim, d_model),
        }
    params["LayerNorm_0"] = norm(d_model)
    params["head"] = dense(d_model, n_features)
    return {"params": params}


def sensor_body(rng, n_rows: int) -> dict:
    start = datetime(2019, 6, 1, tzinfo=timezone.utc)
    stamps = [(start + timedelta(minutes=10 * i)).isoformat() for i in range(n_rows)]
    frame = {
        tag: dict(zip(stamps, rng.normal(size=n_rows).tolist())) for tag in TAGS
    }
    return {"X": frame, "y": frame}


def post(url: str, payload: bytes):
    """(parsed JSON reply, seconds from sending to the last reply byte)."""
    request = urllib.request.Request(
        url, data=payload, headers={"Content-Type": "application/json"}, method="POST"
    )
    t0 = time.perf_counter()
    with urllib.request.urlopen(request, timeout=600) as reply:
        raw = reply.read()
        if reply.status != 200:
            raise AssertionError(f"{url} answered {reply.status}")
    seconds = time.perf_counter() - t0
    return json.loads(raw), seconds


def block_array(block: dict, keys) -> "list":
    return [[block[label][key] for label in block] for key in keys]


def end_to_end_phase(torch, fa, profile: bool):
    """Phase 4: serve the full-width machine over HTTP on the card."""
    import numpy as np

    from gordo_tpu_torch import convert, serializer
    from gordo_tpu_torch.server.app import build_app
    from gordo_tpu_torch.server.runner import make_http_server

    rng = np.random.default_rng(SEED)
    n_layers = BASE_ESTIMATOR["n_layers"]
    lookback = BASE_ESTIMATOR["lookback_window"]
    tree = flax_layout_tree(
        rng, len(TAGS), BASE_ESTIMATOR["d_model"], n_layers, 4 * BASE_ESTIMATOR["d_model"]
    )
    center = rng.normal(size=len(TAGS)).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, size=len(TAGS)).astype(np.float32)
    thresholds = {"aggregate_threshold_": 1.5, "feature_thresholds_": [0.8, 0.9, 1.1]}
    metadata = {
        "name": MACHINE,
        "dataset": {
            "tag_list": TAGS,
            "target_tag_list": TAGS,
            "resolution": "10T",
            "train_start_date": "2019-01-01T00:00:00+00:00",
            "train_end_date": "2019-06-01T00:00:00+00:00",
        },
        "model": DEFINITION,
        "metadata": {"build_metadata": {"model": {"model_offset": lookback - 1}}},
        "runtime": {},
        "project_name": "plant-a-anomaly",
        "evaluation": {},
    }
    report = {"requests": []}
    with tempfile.TemporaryDirectory() as tmp:
        collection = os.path.join(tmp, "1700000000000")
        artifact = os.path.join(collection, MACHINE)
        convert.write_artifact(
            artifact, tree, DEFINITION, center, scale, thresholds, metadata
        )
        app = build_app(collection)  # the card: no device argument
        server = make_http_server(app, "127.0.0.1", 0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{server.server_port}/gordo/v0/plant-a-anomaly/{MACHINE}"
        bodies = {n: sensor_body(rng, n) for n in (144, lookback - 1 + CHUNK_WINDOWS)}
        try:
            with urllib.request.urlopen(f"{base}/metadata", timeout=60) as reply:
                meta_reply = json.loads(reply.read())
            if meta_reply["metadata"]["name"] != MACHINE:
                raise AssertionError(f"metadata route answered {meta_reply}")
            payloads = {n: json.dumps(body).encode() for n, body in bodies.items()}
            replies = {}
            fa.reset_launch_counts()
            for n_rows, payload in payloads.items():
                n_windows = n_rows - lookback + 1
                expected = n_layers * math.ceil(n_windows / CHUNK_WINDOWS)
                for route in ("prediction", "anomaly/prediction"):
                    times = []
                    for _ in range(REPEATS):
                        before = fa.launch_counts[fa.KERNEL]
                        reply, seconds = post(f"{base}/{route}", payload)
                        launched = fa.launch_counts[fa.KERNEL] - before
                        if launched != expected:
                            raise AssertionError(
                                f"{route} with {n_rows} rows launched the kernel "
                                f"{launched} times, expected {expected}"
                            )
                        times.append(seconds)
                    replies[(route, n_rows)] = reply
                    row = {"route": route, "rows": n_rows, "launches_each": expected,
                           "median_s": statistics.median(times), "seconds": times}
                    report["requests"].append(row)
                    log("request", json.dumps(row))
            launches = fa.launch_counts[fa.KERNEL]
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)

        # what came out: shapes, finite values, and the card against the CPU
        cpu_model = serializer.load(artifact, device="cpu")
        max_cpu_diff = 0.0
        for (route, n_rows), reply in replies.items():
            data = reply["data"]
            keys = list(data["model-output"][TAGS[0]])
            if len(keys) != n_rows - lookback + 1:
                raise AssertionError(f"{route}: {len(keys)} rows for {n_rows} posted")
            for top, block in data.items():
                if top in ("start", "end"):
                    continue
                values = np.asarray(block_array(block, keys), dtype=np.float64)
                if not np.isfinite(values).all():
                    raise AssertionError(f"{route}: non-finite values in {top}")
            X = np.asarray(
                block_array(bodies[n_rows]["X"], list(bodies[n_rows]["X"][TAGS[0]])),
                dtype=np.float32,
            )
            card = np.asarray(block_array(data["model-output"], keys))
            diff = float(np.abs(card - cpu_model.predict(X)).max())
            max_cpu_diff = max(max_cpu_diff, diff)
        report["max_abs_diff_card_vs_cpu"] = max_cpu_diff
        log("card-vs-cpu model-output max abs diff", max_cpu_diff)
        if not max_cpu_diff <= 1e-4:
            raise AssertionError(f"card and CPU model outputs differ by {max_cpu_diff}")

        if profile:
            report["profile"] = profile_predict(torch, artifact, bodies)
            report["anomaly_phases_ms"] = anomaly_phases(torch, artifact, bodies)
    return launches, report


def anomaly_phases(torch, artifact, bodies):
    """Median milliseconds of each step the anomaly route takes for the
    largest body, run in-process (no HTTP): JSON decode and frame
    parsing, the model's forward (synchronised), the anomaly arithmetic,
    the frame-to-dict conversion and the JSON encode."""
    from gordo_tpu_torch import serializer
    from gordo_tpu_torch.server import utils as server_utils

    model = serializer.load(artifact)
    payload = json.dumps(bodies[max(bodies)]).encode()
    steps = {name: [] for name in ("parse", "forward", "anomaly", "to_dict", "encode")}
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        X, y = server_utils.extract_X_y(json.loads(payload), TAGS, TAGS)
        t1 = time.perf_counter()
        output = model.predict(X)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        frame = model.anomaly(X, y, timedelta(minutes=10), model_output=output)
        t3 = time.perf_counter()
        data = server_utils.dataframe_to_dict(frame)
        t4 = time.perf_counter()
        json.dumps({"data": data}, default=str)
        t5 = time.perf_counter()
        for name, (a, b) in zip(steps, ((t0, t1), (t1, t2), (t2, t3), (t3, t4), (t4, t5))):
            steps[name].append((b - a) * 1e3)
    phases = {name: statistics.median(values) for name, values in steps.items()}
    log("anomaly route phases ms", json.dumps(phases))
    return phases


def profile_predict(torch, artifact, bodies):
    """Device time by kernel for one 8192-window predict (torch.profiler)."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gordo_tpu_torch import serializer

    model = serializer.load(artifact)
    body = bodies[max(bodies)]
    X = np.asarray(block_array(body["X"], list(body["X"][TAGS[0]])), dtype=np.float32)
    model.predict(X)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.predict(X)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for event in prof.key_averages():
        # kernels only: an operator's row repeats its kernels' device time
        if event.device_type != DeviceType.CUDA:
            continue
        device_us = event.self_device_time_total
        if device_us > 0:
            rows.append({"name": event.key[:80], "count": event.count, "device_us": device_us})
    rows.sort(key=lambda r: -r["device_us"])
    total_us = sum(r["device_us"] for r in rows)
    log("profile predict wall ms", wall_ms, "device ms", total_us / 1e3)
    for row in rows[:12]:
        log("profile", json.dumps(row))
    return {"wall_ms": wall_ms, "device_ms": total_us / 1e3, "kernels": rows[:20]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Smoke run of gordo_tpu_torch on one card")
    parser.add_argument("--out", default=None, help="also write the numbers to this JSON file")
    parser.add_argument("--profile", action="store_true",
                        help="add a torch.profiler breakdown of one 8192-window predict")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    # float32 means float32: no TF32 in matrix products or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from gordo_tpu_torch.ops import _build
    from gordo_tpu_torch.ops import flash_attention as fa

    card = card_line()
    log(card)
    log("torch", torch.__version__, "cuda", torch.version.cuda,
        "device", torch.cuda.get_device_name(0))

    t0 = time.perf_counter()
    compiler_output = _build.build_all(_build.sources())
    build_s = time.perf_counter() - t0
    log("build seconds", build_s)
    for name, text in compiler_output.items():
        log(f"nvcc {name}:\n{text.strip()}")

    checks = kernel_phase(torch, fa)
    launches, report = end_to_end_phase(torch, fa, args.profile)
    if launches <= 0:
        raise AssertionError("the served path never launched flash_attention_fwd")

    model_case = checks[0]
    kernels = {
        "kernels": [
            {
                "name": fa.KERNEL,
                "route": "cuda",
                "source": "gordo_tpu_torch/csrc/flash_attention_fwd.cu",
                "replaces": "gordo_tpu/ops/flash_attention.py:72",
                "launches": launches,
                "max_abs_err": model_case["max_abs_err"],
                "ms": model_case["ms"],
                "plain_ms": model_case["plain_ms"],
                "bound_ms": model_case["bound_ms"],
                "bound_by": model_case["bound_by"],
                "library_ms": model_case["library_ms"],
            }
        ]
    }
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(
                {"card": card, "build_s": build_s, "checks": checks, "end_to_end": report,
                 **kernels},
                fh,
                indent=1,
            )
    log(card)
    log(json.dumps(kernels))
    log(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
