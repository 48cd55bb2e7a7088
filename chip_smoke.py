#!/usr/bin/env python3
"""
Smoke run of the PyTorch/CUDA port (``gordo_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--out results.json] [--profile]

Phases, each raising on failure (no result line is printed then):

1. the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel from ``gordo_tpu_torch/csrc`` with nvcc for
   sm_90a, one nvcc per source, all started together (each source's nvcc
   seconds and the whole build's are printed);
3. each kernel against its plain PyTorch version on the card, at the
   shapes the serving and training paths give it and a few more, with
   its device time (torch.profiler; ``call_ms``: CUDA events around the
   call, host gaps included) beside the plain version's, one PyTorch
   library call's (a yardstick only) and the bound (the larger of bytes over 3.35 TB/s and
   operations over the type's peak rate, published H100 SXM figures):
   the flash forward, then the dq and dk/dv backward kernels, each also
   on views one element into their memory (no 16-byte aligned row: the
   kernels' element-by-element path), at head_dim 64, 128 and 256, at the
   JAX package's long-context record (1, 8192, 4, 64) in float32 and
   bf16, at head_dims the wrappers pad (8 to 16, 48 to 64, 200 to 256,
   300 to 384, 1100 to 1152), at 640 and 2048, in float16 and float64
   (float32 sums inside the kernels, as in the Pallas kernels) and in
   bf16 and float16 at kernel widths 64 and 128 (the tensor-core
   kernels); each call must run the
   CUDA kernel its width and type route to (``expected_kernel``); two
   dq and two dk/dv launches bitwise equal in ``BITWISE_CASES``; then the
   gradient of a loss through the autograd Function on the card against
   dense attention's on the card, at head_dim 16, 64, 48, 200 and 300;
4. serving: the ``turbine-9900-transformer`` machine of
   ``examples/config.yaml`` at full width with ``attention_impl: flash``
   (random weights from a numpy seed in the Flax layout, carried over by
   ``gordo_tpu_torch.convert``), served over HTTP by the port's server on
   the card; ``/prediction`` and ``/anomaly/prediction`` with 144 rows and
   with 8255 rows (one full 8192-window chunk); launch counts reset just
   before and read just after; model output held against the same
   artifact on the CPU;
5. training: the same machine, read from ``examples/config.yaml`` through
   the port's config layer (``get_dict_from_yaml``, ``NormalizedConfig``)
   with ``attention_impl: flash``, built by the port's ``ModelBuilder`` on the
   card from its dataset span (2019-01-01 to 2019-06-01 at 10 minutes,
   21 744 rows of seeded daily sinusoids plus noise) with the evaluation
   defaults (TimeSeriesSplit(3) cross-validation with the four metrics,
   its three folds trained at once as one fleet fit, thresholds, then the
   fit), 5 epochs where the config has 10 (the build's eager steps are
   host-bound, and on a slow host 10 epochs took 265 s, over the phase's
   3-minute budget); launch counts reset just before and read just after
   (each backward kernel exactly ``n_layers`` times per optimizer step, a
   CV step launching once for all three folds); the artifact it writes served
   over HTTP; one full-width training step on the card against the same
   step on the CPU; step time, steps/s, CV and fit seconds (with
   ``--profile``, a ``torch.profiler`` breakdown of 20 training steps);
6. default pipeline: ``examples/config.yaml``'s ``pump-4130`` and
   ``compressor-2201`` (MinMaxScaler + feedforward hourglass AutoEncoder,
   1 epoch, batch 32, full width and span, no cut), read through the
   port's config layer, each built by ``python -m gordo_tpu_torch.cli
   build`` in a subprocess on the card from the normalized machine as
   YAML text (fetch and resample, CV and thresholds, fit, artifact); its
   row count held to the JAX data layer's (766, 10 975),
   its fit on the card; the artifact served over HTTP on the card with the
   machine's first 144 rows and all its rows, medians of 5, each reply
   within 1e-5 of the same request on the CPU; fetch, CV and fit seconds
   and steps/s (with ``--profile``, one fit traced: its device idle
   share); no flash kernel launches on this path;
7. models beyond the served machine's head size: the port's
   TransformerNet at compute dtype bfloat16 over the JAX package's
   long-context record (3 features, d_model 256, 4 heads of 64, 2 layers,
   causal, one (1, 8192, 3) window) takes one forward + backward with
   flash attention and the same step with dense attention on the card:
   the tensor-core forward, dq and dk/dv kernels each launch once a
   layer (counts reset just before, read just after), the loss and every
   gradient agree within 16 bf16 steps, and both step times are printed;
   then a Transformer with 2 heads of 300 (run at 384: the sliced
   forward and the tiled dq and dk/dv) the same way, in float32 within
   1e-4 (the CUDA-core tiled kernels) and in bfloat16 within 16 bf16
   steps (the tensor-core tiled kernels);
8. recurrent machines: the JAX package's headline workload (bench.py's
   50-tag LSTM autoencoder, lookback 64, encoder 128/64, decoder 64/128,
   fused, batch 512) and a 50-tag ``GRUForecast(gru_hourglass)`` with its
   unfused cells, each a ``DiffBasedAnomalyDetector`` built by
   ``python -m gordo_tpu_torch.cli build`` in a subprocess on the card
   (16 414 rows at 10 minutes, as the JAX data layer gives; 1 epoch where
   bench.py trains 3), served over HTTP on the card with 144 rows and the
   whole history (medians of 5), each reply within 1e-4 of the CPU's;
   build, CV and fit seconds, steps/s, one training step's ms, and its
   CUDA launches and the device's idle share over a torch.profiler window
   of 3 steps (20 with ``--profile``, which adds the kernel breakdown);
   one forward of the ``stacked`` schedule card against CPU; no flash
   kernel launches on this path;
9. project build: ``PROJECT_CONFIG``, a YAML project of three machines
   (a full-width ``TCNAutoEncoder`` detector over phase 8's 50-tag data,
   1 epoch; a ``RawModelRegressor``; a detector over ``InfImputer``,
   ``FunctionTransformer(multiply_by)``, ``MinMaxScaler`` and an
   ``AutoEncoder``), built by the port's ``local_build`` on the card in
   this process, each artifact served over HTTP on the card with 144 rows
   and the whole history (medians of 5), each reply within 1e-4 (TCN) or
   1e-5 of the CPU's; build, CV and fit seconds, the TCN's training step,
   its launches and idle share over 3 profiled steps, its receptive
   field; no flash kernel launches on this path;
10. fleet build: ``fleet_machines`` (four machines with the
   Transformer's model at full width, each on its own tag names over the
   config's span, 1 epoch where the config has 10; then
   ``examples/machines_fleet.yaml``'s four feedforward machines as they
   are) built by ``build-fleet`` in a subprocess on the card, in one
   process and three buckets, each bucket's CV folds and final fit fleet
   fits (the flash kernels under the machine axis, folded into their
   batch); the build report clean; one Transformer machine served on
   ``/anomaly/prediction`` and one feedforward machine on ``/prediction``
   with 144 rows, each reply within 1e-4 of the CPU's; the vmapped flash
   forward and backward against the plain version on a (2, 4, 64, 4, 16)
   machine batch; 3 fleet steps card against CPU; fleet and solo step
   times, launches a step and idle share; each bucket's CV and fit
   seconds and the path's flash launches;
11. one JSON line of per-kernel numbers, each time with the timer that
   took it (``"profiler"``: device time; ``"events"``: CUDA events around
   the calls, host gaps included, taken when three traces came back
   incomplete): the quad and wide kernels under each entry point's name,
   and the tensor-core, sliced and tiled kernels each under its own,
   with its launches on every path above; then the result line.

Exits non-zero without a result line when no CUDA card is available.
"""

import argparse
import contextlib
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
from typing import Optional

SEED = 1234
# published H100 SXM peaks (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
# float64 inputs: the kernels' operations are float32 (each element is
# converted on load, as the Pallas kernels do), so the float32 rate
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12, "float64": 67e12}
# float16: one rounding of outputs up to 8; float64: float32 sums in the
# kernels against float64 in the plain versions
TOLERANCE = {"float32": 1e-4, "bfloat16": 2e-2, "float16": 5e-3, "float64": 1e-5}

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
PROJECT = "plant-a-anomaly"
# the machine's dataset span, 2019-01-01 to 2019-06-01 at 10 minutes
TRAIN_START = datetime(2019, 1, 1, tzinfo=timezone.utc)
TRAIN_ROWS = 151 * 144
BATCH_SIZE = 32  # the fit's default
# the evaluation's default metrics
METRIC_NAMES = ("explained_variance_score", "r2_score", "mean_squared_error",
                "mean_absolute_error")
# epochs of the train phase, cut from the config's 10: the build's eager
# steps are host-bound and the card's host speed varies about 3x; on a
# slow host 10 epochs took 265 s of build, over the phase's 3-minute budget
TRAIN_EPOCHS = 5
# training steps timed (and, with --profile, traced) after the build
TIMED_STEPS = 50
PROFILED_STEPS = 20

# examples/config.yaml's default-pipeline machines (MinMaxScaler +
# feedforward_hourglass AutoEncoder), read through the port's config
# layer (example_machines, which tests/test_torch_cli.py pins against the
# JAX package's NormalizedConfig), and the rows the JAX data layer gives
# each (tests/test_torch_data.py)
DEFAULT_ROWS = {"pump-4130": 766, "compressor-2201": 10975}
DEFAULT_COLLECTION = "1700000000002"

# Phase 8's machines, as the workflow passes them to `build` (the JSON of
# gordo_tpu.workflow's NormalizedConfig, which tests/test_torch_cli.py
# pins; the 50 tags are filled in below): the JAX package's headline
# workload (bench.py: a 50-tag LSTM autoencoder, lookback 64, encoder
# 128/64, decoder 64/128, tanh, fused, the `layer` schedule bench.py runs
# on the chip, batch 512, float32) as a DiffBasedAnomalyDetector machine,
# and a GRU forecaster (gru_hourglass with its defaults: unfused cells,
# dims 42/33/25/25/33/42) at the same lookback and batch. The data: 114
# days at 10 minutes (16 414 rows) of a RandomDataProvider's seeded
# samples, 16 400 a tag. A RandomDataset's provider draws 100-300 samples
# a tag, which leaves no row with all 50 tags at this span. Epochs: 1, cut
# from bench.py's 3 (on an H100 at 3 epochs the two builds took 47 and 69 s,
# most of the phase's budget of about 2 minutes); widths, span and batch
# are not cut.
PLANT_TAGS = [f"GRA-TAG {i}" for i in range(1, 51)]
_PLANT_DATASET = json.loads(r"""{"train_start_date": "2019-01-01T00:00:00+00:00",
 "train_end_date": "2019-04-25T00:00:00+00:00", "data_provider": {"type": "RandomDataProvider",
 "min_size": 16400, "max_size": 16400}, "resolution": "10T", "row_filter": "",
 "aggregation_methods": "mean", "row_filter_buffer_size": 0, "asset": null,
 "default_asset": null, "n_samples_threshold": 0, "low_threshold": -1000,
 "high_threshold": 50000, "interpolation_method": "linear_interpolation",
 "interpolation_limit": "8H", "filter_periods": {}, "type": "TimeSeriesDataset"}""")
_PLANT_MACHINE = json.loads(r"""{
 "metadata": {"user_defined": {"global-metadata": {}, "machine-metadata": {}},
  "build_metadata": {"model": {"model_offset": 0, "model_creation_date": null,
  "model_builder_version": "0.1.0", "cross_validation": {"scores": {},
  "cv_duration_sec": null, "splits": {}}, "model_training_duration_sec": null,
  "model_meta": {}}, "dataset": {"query_duration_sec": null, "dataset_meta": {}}}},
 "runtime": {"reporters": [], "server": {"resources": {"requests": {"memory": 3000,
  "cpu": 1000}, "limits": {"memory": 6000, "cpu": 2000}}},
  "prometheus_metrics_server": {"resources": {"requests": {"memory": 200, "cpu": 100},
  "limits": {"memory": 1000, "cpu": 200}}},
  "builder": {"resources": {"requests": {"memory": 3900, "cpu": 1001},
  "limits": {"memory": 3900, "cpu": 1001}}, "remote_logging": {"enable": false},
  "machines_per_pod": 30, "tpu": {"enable": false, "accelerator": "v5litepod-16"}},
  "client": {"resources": {"requests": {"memory": 3500, "cpu": 100},
  "limits": {"memory": 4000, "cpu": 2000}}, "max_instances": 30},
  "influx": {"enable": true, "resources": {"requests": {"memory": 3440, "cpu": 520},
  "limits": {"memory": 3440, "cpu": 10040}}}},
 "project_name": "plant-a-anomaly",
 "evaluation": {"cv_mode": "full_build",
  "scoring_scaler": "sklearn.preprocessing.RobustScaler",
  "metrics": ["explained_variance_score", "r2_score", "mean_squared_error",
  "mean_absolute_error"]}
}""")
_RECURRENT_ESTIMATORS = {
    "lstm-plant-50": {"gordo_tpu.models.LSTMAutoEncoder": {
        "kind": "lstm_model", "lookback_window": 64, "encoding_dim": [128, 64],
        "encoding_func": ["tanh", "tanh"], "decoding_dim": [64, 128],
        "decoding_func": ["tanh", "tanh"], "fused": True, "schedule": "layer",
        "batch_size": 512, "epochs": 1}},
    "gru-plant-50": {"gordo_tpu.models.GRUForecast": {
        "kind": "gru_hourglass", "lookback_window": 64, "batch_size": 512, "epochs": 1}},
}
RECURRENT_MACHINES = {
    name: {
        "name": name,
        "dataset": dict(_PLANT_DATASET, tag_list=PLANT_TAGS, target_tag_list=PLANT_TAGS),
        "model": {"gordo_tpu.models.anomaly.DiffBasedAnomalyDetector": {
            "base_estimator": estimator}},
        **_PLANT_MACHINE,
    }
    for name, estimator in _RECURRENT_ESTIMATORS.items()
}
# rows the JAX data layer gives each (tests/test_torch_cli.py)
RECURRENT_ROWS = 16414
RECURRENT_COLLECTION = "1700000000003"
# timed whole-history requests of each phase-8 machine, cut from REPEATS:
# each takes 5.5-8.7 s of host JSON on an H100's host, and at 5 the two
# machines' serving took about 150 s of a 660 s run on a slow host
RECURRENT_HISTORY_REPEATS = 3
# training batch of the 50-tag plant machines (phases 8 and 9)
PLANT_BATCH = 512

# Phase 9's project, built in one process by the port's local_build:
# - tcn-plant-50: a DiffBasedAnomalyDetector(TCNAutoEncoder) at the
#   factory's full width (channels 64/64/64, kernel 3, dilations 1/2/4,
#   dropout 0.1, relu) over phase 8's 50-tag plant data (16 414 rows at 10
#   minutes) at lookback 64 and batch 512; 1 epoch, the cut phase 8 makes;
# - raw-regressor: a RawModelRegressor with tests/test_models.py's spec
#   (Dense 8 tanh, Dense 1) from the conftest dataset's 4 tags onto one;
# - imputed-pump: a detector over InfImputer, FunctionTransformer
#   (multiply_by, factor 2), MinMaxScaler and a feedforward hourglass
#   AutoEncoder, on the conftest dataset.
_CONFTEST_DATASET = """
      type: RandomDataset
      tags: [tag-0, tag-1, tag-2, tag-3]
      train_start_date: '2019-01-01T00:00:00+00:00'
      train_end_date: '2019-01-03T00:00:00+00:00'
      asset: gra"""
PROJECT_CONFIG = f"""
machines:
  - name: tcn-plant-50
    dataset:
      type: TimeSeriesDataset
      data_provider: {{type: RandomDataProvider, min_size: 16400, max_size: 16400}}
      tags: [{", ".join(PLANT_TAGS)}]
      train_start_date: '2019-01-01T00:00:00+00:00'
      train_end_date: '2019-04-25T00:00:00+00:00'
    model:
      gordo_tpu.models.anomaly.DiffBasedAnomalyDetector:
        base_estimator:
          gordo_tpu.models.TCNAutoEncoder:
            kind: tcn_model
            lookback_window: 64
            channels: [64, 64, 64]
            kernel_size: 3
            dilations: [1, 2, 4]
            dropout: 0.1
            func: relu
            batch_size: 512
            epochs: 1
  - name: raw-regressor
    dataset:{_CONFTEST_DATASET}
      target_tag_list: [tag-0]
    model:
      gordo_tpu.models.RawModelRegressor:
        kind:
          compile: {{loss: mse, optimizer: adam}}
          spec:
            layers:
              - Dense: {{units: 8, activation: tanh}}
              - Dense: {{units: 1}}
  - name: imputed-pump
    dataset:{_CONFTEST_DATASET}
    model:
      gordo_tpu.models.anomaly.DiffBasedAnomalyDetector:
        base_estimator:
          sklearn.pipeline.Pipeline:
            steps:
              - gordo_tpu.models.transformers.InfImputer
              - sklearn.preprocessing.FunctionTransformer:
                  func: gordo_tpu.models.transformer_funcs.general.multiply_by
                  kw_args: {{factor: 2}}
              - sklearn.preprocessing.MinMaxScaler
              - gordo_tpu.models.AutoEncoder:
                  kind: feedforward_hourglass
"""
# the routes each project machine is served on, and the card-against-CPU
# bound of its replies
PROJECT_SERVING = {
    "tcn-plant-50": (("anomaly/prediction",), 1e-4),
    "raw-regressor": (("prediction",), 1e-5),
    "imputed-pump": (("prediction", "anomaly/prediction"), 1e-5),
}
PROJECT_COLLECTION = "1700000000004"

# Phase 10's fleet, one YAML list built by `build-fleet` in one process:
# FLEET_TRANSFORMERS machines with turbine-9900-transformer's model from
# examples/config.yaml (the detector over TransformerAutoEncoder, 3 tags,
# lookback 64, d_model 64, 4 heads of 16, 2 layers, causal, float32, with
# attention_impl flash as phases 4-5 patch it), each on its own tag names
# over the config's span (2019-01-01 to 2019-06-01 at 10 minutes: from a
# random provider of 21 744 samples a tag the data layer gives 21 744 rows,
# or 21 745 when a sample falls in the span's last bucket), FLEET_EPOCHS epoch where the config has 10 (a fleet build runs the
# three CV folds and the final fit, and at the train phase's host speed
# more epochs would take the phase past its share of the budget); then
# examples/machines_fleet.yaml's four feedforward machines verbatim (two
# buckets, no cut).
FLEET_COLLECTION = "1700000000005"
FLEET_TRANSFORMERS = 4
FLEET_EPOCHS = 1
FLEET_SAMPLES = 21744
FLEET_ROWS = (21744, 21745)
# the vmapped flash check: (machines, batch, seq, heads, head_dim)
FLEET_FLASH_CASE = (2, 4, 64, 4, 16)
# fleet steps of the Transformer bucket held card against CPU, and timed
FLEET_PARITY_STEPS = 3
FLEET_TIMED_STEPS = 20
# runs `python -m gordo_tpu_torch.cli build-fleet`'s main in a subprocess
# and writes the flash launches of that process (counted from 0 at its
# start) to the file named first
FLEET_DRIVER = (
    "import json, sys\n"
    "from gordo_tpu_torch.cli.cli import main\n"
    "from gordo_tpu_torch.ops import flash_attention as fa\n"
    "code = main(sys.argv[2:])\n"
    "with open(sys.argv[1], 'w') as fh:\n"
    "    json.dump(fa.kernel_launches, fh)\n"
    "sys.exit(code)\n"
)


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


def device_ms(fn, reps: int = 20, warmup: int = 3, tries: int = 3):
    """(milliseconds per call of ``fn``, the timer that measured them).
    With ``"profiler"``: the device time of every kernel its ``reps``
    calls launched (torch.profiler), over ``reps``; unlike CUDA events
    around a call, the host's gaps between launches do not count, so a
    small kernel's own time shows. Now and then a trace misses some or all
    of its kernels (a kernel's count is then not a multiple of ``reps``);
    it is taken again, up to ``tries`` times, and then the time is
    ``time_ms``'s, named ``"events"``: it counts those gaps too, so it is
    not a device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows, total_us = kernel_rows(prof)
        if total_us > 0 and all(row["count"] % reps == 0 for row in rows):
            return total_us / 1e3 / reps, "profiler"
    print(f"device_ms: {tries} incomplete traces, timing with CUDA events", file=sys.stderr)
    return time_ms(fn, reps, warmup=0), "events"


def attention_bound(shape, causal: bool, dtype_name: str, elem_bytes: int,
                    n_tensors: int, n_stats: int, dots: int):
    """(bound ms, "bytes" or "operations") for one call of an attention
    kernel: ``n_tensors`` (B, S, H, D) tensors and ``n_stats`` float32
    (B·H, S) row statistics, each read or written once; ``dots`` dot
    products of head_dim per (query, key) pair the mask keeps, 2
    operations per multiply-add. The forward: 4 tensors (q, k, v in, out),
    1 statistic (LSE), 2 dots (scores, p·v). dq: 6 tensors (q, k, v, O,
    dO in, dq out), 2 statistics (LSE in, delta out), 3 dots (scores,
    dO·v, ds·k). dk/dv: 6 tensors (q, k, v, dO in, dk, dv out), 2
    statistics (LSE, delta), 4 dots (scores, dO·v, p·dO, ds·q)."""
    batch, seq, heads, head_dim = shape
    moved = (n_tensors * batch * seq * heads * head_dim * elem_bytes
             + n_stats * batch * heads * seq * 4)
    pairs = seq * (seq + 1) // 2 if causal else seq * seq
    ops = 2 * dots * head_dim * batch * heads * pairs
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def expected_kernel(entry: str, dtype_name: str, width: int) -> str:
    """The CUDA kernel (``<entry point>_<family>``, as
    ``flash_attention.kernel_launches`` names it) a call at kernel width
    ``width`` in ``dtype_name`` routes to: the quad kernels at 16 and 32;
    at 64 and 128 the tensor-core kernels in bfloat16/float16, else the
    wide kernels, as at 256; above 256 the width-sliced forward and the
    tiled dq and dk/dv kernels, on the tensor cores in bfloat16/float16."""
    sixteen_bit = dtype_name in ("bfloat16", "float16")
    if width <= 32:
        family = "quad"
    elif width > 256:
        if entry.endswith("_fwd"):
            family = "sliced"
        else:
            family = "tiled_mma" if sixteen_bit else "tiled"
    elif width in (64, 128) and sixteen_bit:
        family = "mma"
    else:
        family = "wide"
    return f"{entry}_{family}"


def card_tensor(torch, gen, shape, dtype, misaligned: bool = False):
    """A random (B, S, H, D) tensor on the card; ``misaligned``: a view one
    element into its memory, so no row start is 16-byte aligned and the
    kernels take their element-by-element path."""
    if not misaligned:
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    flat = torch.randn(math.prod(shape) + 1, generator=gen, device="cuda").to(dtype)
    return flat[1:].view(shape)


def library_view(x):
    """(B, H, S, D) view of a fresh copy of ``x`` for the library
    yardstick: SDPA's kernels fault on a misaligned view, and
    ``contiguous()`` keeps one whose strides are already contiguous."""
    return x.clone().transpose(1, 2)


# the misaligned case: (B, S, H, D) views one element into their memory
MISALIGNED = "train-step-misaligned"
# cases of the forward and both backward phases: the JAX package's on-chip
# long-context record (docs/performance.md: causal, batch 1, 4 heads,
# head_dim 64), head_dims the wrappers zero-pad to the next kernel width
# (examples/long_context_training.py's 8 runs at 16, 48 at 64, 200 at
# 256, 300 at 384), the widest fixed-width kernel, run-time widths (300,
# 640, 1100 at 1152 and 2048: the sliced forward, the tiled dq and dk/dv;
# and (2, 2048, 4, 512) in bf16, a launch that fills the card), the
# float16 and float64 element types, and bfloat16/float16 at kernel
# widths 64 and 128 (the tensor-core kernels)
WIDE_CASES = [
    ("long-context-64", (1, 8192, 4, 64), True, "float32"),
    ("long-context-64-bf16", (1, 8192, 4, 64), True, "bfloat16"),
    ("padded-8", (32, 64, 4, 8), True, "float32"),
    ("padded-48", (16, 200, 2, 48), True, "float32"),
    ("head-dim-256", (2, 300, 2, 256), False, "float32"),
    ("padded-200", (2, 512, 4, 200), True, "float32"),
    ("fp16-64", (4, 1000, 2, 64), True, "float16"),
    ("fp64-128", (2, 300, 2, 128), False, "float64"),
    ("bf16-128", (2, 300, 2, 128), False, "bfloat16"),
    ("fp16-128", (2, 300, 2, 128), False, "float16"),
    ("padded-48-bf16", (16, 200, 2, 48), True, "bfloat16"),
    ("padded-48-fp16", (16, 200, 2, 48), True, "float16"),
    ("head-dim-300", (2, 300, 2, 300), True, "float32"),
    ("head-dim-300-bf16", (2, 300, 2, 300), True, "bfloat16"),
    ("head-dim-640", (1, 256, 2, 640), False, "float32"),
    ("head-dim-640-bf16", (1, 256, 2, 640), False, "bfloat16"),
    ("head-dim-1100", (1, 128, 2, 1100), True, "float32"),
    ("head-dim-2048-bf16", (1, 64, 1, 2048), False, "bfloat16"),
    ("head-dim-512-bf16-long", (2, 2048, 4, 512), True, "bfloat16"),
]
# the cases each kernel's `wide` rows of the `kernels` line report
WIDE_ROWS = ("head-dim-128", "head-dim-256", "long-context-64")
# the cases the tensor-core, the sliced and the tiled kernels' entries
# report: the first is the entry's own row, the others its `wide` rows
MMA_ROWS = ("long-context-64-bf16", "fp16-64", "bf16-128", "padded-48-bf16")
SLICED_ROWS = ("head-dim-300", "head-dim-640", "head-dim-300-bf16", "head-dim-1100",
               "head-dim-2048-bf16", "head-dim-512-bf16-long")
TILED_ROWS = ("head-dim-300", "head-dim-640", "head-dim-1100")
TILED_MMA_ROWS = ("head-dim-300-bf16", "head-dim-640-bf16", "head-dim-2048-bf16",
                  "head-dim-512-bf16-long")


def kernel_phase(torch, fa):
    """Phase 3: the flash forward kernel against its plain version."""
    import torch.nn.functional as F

    cases = [
        ("model-shape", (8192, 64, 4, 16), True, torch.float32),
        ("train-step", (BATCH_SIZE, 64, 4, 16), True, torch.float32),
        ("ragged-causal", (4, 1000, 2, 64), True, torch.float32),
        ("ragged-full", (4, 1000, 2, 64), False, torch.float32),
        ("head-dim-32", (16, 200, 2, 32), True, torch.float32),
        ("head-dim-128", (2, 300, 2, 128), False, torch.float32),
        ("model-shape-bf16", (8192, 64, 4, 16), True, torch.bfloat16),
        (MISALIGNED, (BATCH_SIZE, 64, 4, 16), True, torch.float32),
        *((name, shape, causal, getattr(torch, dtype)) for name, shape, causal, dtype in WIDE_CASES),
    ]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    results = []
    for name, shape, causal, dtype in cases:
        q, k, v = (
            card_tensor(torch, gen, shape, dtype, name == MISALIGNED) for _ in range(3)
        )
        dtype_name = str(dtype).replace("torch.", "")
        before = dict(fa.kernel_launches)
        out, lse = fa.flash_attention_forward(q, k, v, causal=causal)
        torch.cuda.synchronize()
        ran = kernels_ran(fa, before)
        want = expected_kernel(fa.KERNEL, dtype_name, fa.kernel_width(shape[-1]))
        if ran != [want]:
            raise AssertionError(f"{name}: the forward ran {ran}, expected {want}")
        ref_out, ref_lse = fa.flash_attention_reference(q, k, v, causal=causal)
        err_out = (out.float() - ref_out.float()).abs().max().item()
        err_lse = (lse - ref_lse).abs().max().item()
        tol = TOLERANCE[dtype_name]
        def run():
            return fa.flash_attention_forward(q, k, v, causal=causal)

        qt, kt, vt = (library_view(x) for x in (q, k, v))
        (ms, ms_timer), call_ms = device_ms(run), time_ms(run)
        plain_ms, plain_timer = device_ms(
            lambda: fa.flash_attention_reference(q, k, v, causal=causal), reps=5
        )
        library_ms, library_timer = device_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
        )
        bound_ms, bound_by = attention_bound(
            shape, causal, dtype_name, q.element_size(), n_tensors=4, n_stats=1, dots=2
        )
        width = shape[:-1] + (fa.kernel_width(shape[-1]),)
        row = {
            "case": name,
            "cuda_kernel": want,
            "shape": list(shape),
            "causal": causal,
            "dtype": dtype_name,
            "key_splits": fa.forward_splits(torch.empty(width, dtype=dtype, device="cuda"), causal),
            "rows_16b_aligned": fa.rows_16b_aligned(q, k, v, out),
            "max_abs_err": err_out,
            "max_abs_err_lse": err_lse,
            "tolerance": tol,
            "ms": ms,
            "ms_timer": ms_timer,
            "call_ms": call_ms,
            "plain_ms": plain_ms,
            "plain_ms_timer": plain_timer,
            "library_ms": library_ms,
            "library_ms_timer": library_timer,
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


# (case, shape (B, S, H, D), causal, dtype) of the backward kernels' checks
BACKWARD_CASES = [
    ("train-step", (BATCH_SIZE, 64, 4, 16), True, "float32"),
    ("model-shape", (8192, 64, 4, 16), True, "float32"),
    ("ragged-causal", (4, 1000, 2, 64), True, "float32"),
    ("ragged-full", (4, 1000, 2, 64), False, "float32"),
    ("head-dim-32", (16, 200, 2, 32), True, "float32"),
    ("head-dim-128", (2, 300, 2, 128), False, "float32"),
    ("train-step-bf16", (BATCH_SIZE, 64, 4, 16), True, "bfloat16"),
    (MISALIGNED, (BATCH_SIZE, 64, 4, 16), True, "float32"),
    *WIDE_CASES,
    # grids far under one wave: dq splits its keys across blocks (the wide
    # kernel in float32, the tensor-core one in bf16)
    ("dq-split-64", (1, 500, 1, 64), True, "float32"),
    ("dq-split-64-bf16", (1, 500, 1, 64), True, "bfloat16"),
]
# cases where two dq launches (dq and delta) and two dk/dv launches must
# agree bit for bit
BITWISE_CASES = ("train-step", MISALIGNED, "dq-split-64", "dq-split-64-bf16",
                 "long-context-64-bf16", "fp16-64", "bf16-128", "padded-48-fp16", "head-dim-300",
                 "head-dim-640-bf16", "head-dim-1100", "head-dim-2048-bf16")
# of those, the cases whose dq must split its keys
SPLIT_CASES = ("dq-split-64", "dq-split-64-bf16")


def backward_phase(torch, fa):
    """Phase 3, backward: the dq and dk/dv kernels, each against its plain
    version on the same inputs (the dk/dv pair both take the plain
    delta), each the CUDA kernel its width and type route to; in
    ``BITWISE_CASES`` a second dq and a second dk/dv launch equal the
    first bit for bit, and in ``SPLIT_CASES`` dq splits its keys. The library
    yardstick is the backward of ``scaled_dot_product_attention`` through
    ``torch.autograd.grad`` (dq, dk and dv together), its forward timed
    apart and subtracted."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    results = []
    for name, shape, causal, dtype_name in BACKWARD_CASES:
        dtype = getattr(torch, dtype_name)
        q, k, v, d_out = (
            card_tensor(torch, gen, shape, dtype, name == MISALIGNED) for _ in range(4)
        )
        out, lse = fa.flash_attention_forward(q, k, v, causal=causal)
        scale = 1.0 / math.sqrt(shape[-1])
        width = shape[:-1] + (fa.kernel_width(shape[-1]),)
        padded = torch.empty(width, dtype=dtype, device="cuda")
        dq_splits, dkv_splits = fa.dq_splits(padded, causal), fa.dkv_splits(padded, causal)
        if name in SPLIT_CASES and dq_splits < 2:
            raise AssertionError(f"dq did not split its keys: {name}")
        before = dict(fa.kernel_launches)
        dq, delta = fa.flash_attention_bwd_dq(q, k, v, out, lse, d_out, causal)
        torch.cuda.synchronize()
        ran = {fa.KERNEL_DQ: kernels_ran(fa, before)}
        bitwise = {fa.KERNEL_DQ: None, fa.KERNEL_DKV: None}
        if name in BITWISE_CASES:
            dq2, delta2 = fa.flash_attention_bwd_dq(q, k, v, out, lse, d_out, causal)
            torch.cuda.synchronize()
            bitwise[fa.KERNEL_DQ] = bool(torch.equal(dq, dq2) and torch.equal(delta, delta2))
            if not bitwise[fa.KERNEL_DQ]:
                raise AssertionError(f"two dq launches differ: {name}")
        ref_dq, ref_delta = fa.flash_attention_bwd_dq_reference(
            q, k, v, out, lse, d_out, causal, scale
        )
        before = dict(fa.kernel_launches)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, lse, ref_delta, d_out, causal)
        torch.cuda.synchronize()
        ran[fa.KERNEL_DKV] = kernels_ran(fa, before)
        if name in BITWISE_CASES:
            dk2, dv2 = fa.flash_attention_bwd_dkv(q, k, v, lse, ref_delta, d_out, causal)
            torch.cuda.synchronize()
            bitwise[fa.KERNEL_DKV] = bool(torch.equal(dk, dk2) and torch.equal(dv, dv2))
            if not bitwise[fa.KERNEL_DKV]:
                raise AssertionError(f"two dk/dv launches differ: {name}")
        want = {entry: expected_kernel(entry, dtype_name, fa.kernel_width(shape[-1]))
                for entry in ran}
        if any(ran[entry] != [want[entry]] for entry in ran):
            raise AssertionError(f"{name}: the backward ran {ran}, expected {want}")
        ref_dk, ref_dv = fa.flash_attention_bwd_dkv_reference(
            q, k, v, lse, ref_delta, d_out, causal, scale
        )
        errors = {
            label: (got.float() - want.float()).abs().max().item()
            for label, got, want in (
                ("dq", dq, ref_dq), ("delta", delta, ref_delta),
                ("dk", dk, ref_dk), ("dv", dv, ref_dv),
            )
        }
        tol = TOLERANCE[dtype_name]
        if not all(err <= tol for err in errors.values()):
            raise AssertionError(f"backward kernels disagree with their plain versions: "
                                 f"{name} {errors}")

        qt, kt, vt = (library_view(x).detach().requires_grad_(True) for x in (q, k, v))
        d_out_t = library_view(d_out)

        def sdpa_forward():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)

        def sdpa_forward_backward():
            torch.autograd.grad(sdpa_forward(), (qt, kt, vt), d_out_t)

        (both_ms, both_timer), (forward_ms, forward_timer) = (
            device_ms(sdpa_forward_backward), device_ms(sdpa_forward)
        )
        library_ms = both_ms - forward_ms
        library_timer = "profiler" if both_timer == forward_timer == "profiler" else "events"
        timings = {
            fa.KERNEL_DQ: (
                lambda: fa.flash_attention_bwd_dq(q, k, v, out, lse, d_out, causal),
                lambda: fa.flash_attention_bwd_dq_reference(
                    q, k, v, out, lse, d_out, causal, scale),
                3, ("dq", "delta"),
            ),
            fa.KERNEL_DKV: (
                lambda: fa.flash_attention_bwd_dkv(q, k, v, lse, ref_delta, d_out, causal),
                lambda: fa.flash_attention_bwd_dkv_reference(
                    q, k, v, lse, ref_delta, d_out, causal, scale),
                4, ("dk", "dv"),
            ),
        }
        for kernel, (run, plain, dots, outputs) in timings.items():
            bound_ms, bound_by = attention_bound(
                shape, causal, dtype_name, q.element_size(), n_tensors=6, n_stats=2, dots=dots
            )
            (ms, ms_timer), (plain_ms, plain_timer) = device_ms(run), device_ms(plain, reps=5)
            row = {
                "kernel": kernel,
                "cuda_kernel": want[kernel],
                "case": name,
                "shape": list(shape),
                "causal": causal,
                "dtype": dtype_name,
                "rows_16b_aligned": fa.rows_16b_aligned(q, k, v, d_out),
                "max_abs_err": max(errors[label] for label in outputs),
                "errors": {label: errors[label] for label in outputs},
                "tolerance": tol,
                "bitwise_repeat": bitwise[kernel],
                # dq's key splits, dk/dv's query splits
                "splits": dq_splits if kernel == fa.KERNEL_DQ else dkv_splits,
                "ms": ms,
                "ms_timer": ms_timer,
                "call_ms": time_ms(run),
                "plain_ms": plain_ms,
                "plain_ms_timer": plain_timer,
                "library_ms": library_ms,
                "library_ms_timer": library_timer,
                "library_call": "scaled_dot_product_attention backward (dq, dk, dv)",
                "bound_ms": bound_ms,
                "bound_by": bound_by,
            }
            log("kernel-check", json.dumps(row))
            results.append(row)
        del q, k, v, d_out, out, lse, dq, delta, dk, dv, qt, kt, vt
        del ref_dq, ref_delta, ref_dk, ref_dv
        torch.cuda.empty_cache()
    return results


def kernels_ran(fa, before) -> list:
    """The CUDA kernels launched since ``before`` (a copy of
    ``fa.kernel_launches``)."""
    return sorted(name for name, n in fa.kernel_launches.items() if n != before[name])


def gradient_phase(torch, fa):
    """Phase 3, the repair: the gradient of a loss through the flash
    autograd Function on the card equals dense attention's on the card,
    through (batch, seq, heads, head_dim) views of one tensor as the
    model feeds them: at the model's head_dim 16, at 64, at 48, which
    the Function pads to 64, at 200, which it pads to 256, and at 300,
    which it pads to 384 (the sliced and tiled kernels). Each backward launches
    dq and dk/dv once."""
    from gordo_tpu_torch.models.specs_seq import dense_attention

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    report = {}
    for head_dim in (16, 64, 48, 200, 300):
        for causal in (True, False):
            wide = torch.randn((BATCH_SIZE, 64, 4, 3 * head_dim), generator=gen, device="cuda")
            wide.requires_grad_(True)
            q, k, v = (wide[..., i * head_dim:(i + 1) * head_dim] for i in range(3))
            before = dict(fa.launch_counts)
            fa.flash_attention(q, k, v, causal=causal).square().sum().backward()
            torch.cuda.synchronize()
            for kernel in (fa.KERNEL, fa.KERNEL_DQ, fa.KERNEL_DKV):
                if fa.launch_counts[kernel] != before[kernel] + 1:
                    raise AssertionError(f"the flash Function at head_dim {head_dim} did not "
                                         f"launch {kernel} once")
            flash_grad = wide.grad.clone()
            wide.grad = None
            dense_attention(q, k, v, causal=causal).square().sum().backward()
            err = (flash_grad - wide.grad).abs().max().item()
            label = "causal" if causal else "full"
            report[label if head_dim == 16 else f"head-dim-{head_dim}-{label}"] = err
            if not err <= TOLERANCE["float32"]:
                raise AssertionError(f"flash and dense gradients differ on the card by {err} "
                                     f"at head_dim {head_dim}")
    log("flash-vs-dense gradient max abs diff on the card", json.dumps(report))
    return report


# Phase 7's models. The JAX package's on-chip long-context record
# (docs/performance.md: a causal forward + backward at batch 1, 4 heads of
# 64, seq 8192, bf16) as the port's TransformerNet at compute dtype
# bfloat16: 3 features, d_model 256, 2 layers, ff 1024, one (1, 8192, 3)
# window. Then a Transformer whose heads are wider than 256 (2 heads of
# 300, run at 384), 1 layer, a (4, 256, 3) batch of windows, in float32
# and in bfloat16.
MODEL_16BIT = dict(n_features=3, d_model=256, n_heads=4, n_layers=2, ff_dim=1024, out_dim=3,
                   causal=True)
WINDOW_16BIT = (1, 8192, 3)
MODEL_WIDE_HEAD = dict(n_features=3, d_model=600, n_heads=2, n_layers=1, ff_dim=1200,
                       out_dim=3, causal=True)
WINDOW_WIDE_HEAD = (4, 256, 3)
# flash against dense on the card: the loss and every gradient within 16
# bf16 steps (2^-8 relative) of its largest magnitude in bfloat16 (each
# path rounds at other places: the flash kernels round P and dS, dense
# attention its scores, softmax and products; tests/test_torch_transformer.py
# holds the CPU model to JAX at the same bound), within 1e-4 of it in
# float32 (summation order)
MODEL_STEPS_16BIT = 16
MODEL_REL_FLOAT32 = 1e-4
MODEL_TIMED_STEPS = 5


def model_step_check(torch, fa, label, widths, window, dtype):
    """One forward + backward of the port's TransformerNet (random weights
    from the seed, ``attention_impl`` flash, then the same step dense),
    a mean squared error against seeded targets: the launches of each
    CUDA kernel in the flash step (counts reset just before, read just
    after), the step times (host clock, synchronised, median of
    ``MODEL_TIMED_STEPS``), and the largest difference of the loss and of
    every gradient between the two, each over its largest magnitude. An
    attention key bias's gradient is 0 in exact arithmetic (the softmax
    ignores a shift of every key), so it is measured on the scale of its
    layer's key weight gradient."""
    import numpy as np

    from gordo_tpu_torch.models.specs_seq import TransformerNet

    rng = np.random.default_rng(SEED + 3)
    x = torch.from_numpy(rng.normal(size=window).astype(np.float32)).cuda()
    y = torch.from_numpy(rng.normal(size=(window[0], widths["out_dim"])).astype(np.float32)).cuda()
    torch.manual_seed(SEED)
    state = TransformerNet(**widths, dtype=dtype).state_dict()
    steps = {}
    for impl in ("flash", "dense"):
        net = TransformerNet(**widths, attention_impl=impl, dtype=dtype)
        net.load_state_dict(state)
        net = net.cuda().train()  # dropout 0: no generator needed

        def step():
            net.zero_grad(set_to_none=True)
            loss = (net(x) - y).square().mean()
            loss.backward()
            return loss

        torch.cuda.synchronize()
        fa.reset_launch_counts()
        loss = step()
        torch.cuda.synchronize()
        launches = {name: n for name, n in fa.kernel_launches.items() if n}
        grads = {name: p.grad.detach().float().clone() for name, p in net.named_parameters()}
        times = []
        for _ in range(MODEL_TIMED_STEPS):
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        steps[impl] = {"loss": loss.item(), "grads": grads, "launches": launches,
                       "step_ms": statistics.median(times)}
        del net
    flash, dense = steps["flash"], steps["dense"]
    if dense["launches"]:
        raise AssertionError(f"{label}: the dense step launched flash kernels {dense['launches']}")

    def scale_of(name):
        if name.endswith("attn.key.bias"):
            return dense["grads"][name[: -len("bias")] + "weight"].abs().max().item()
        return dense["grads"][name].abs().max().item()

    loss_rel = abs(flash["loss"] - dense["loss"]) / abs(dense["loss"])
    grad_rel = {
        name: (flash["grads"][name] - g).abs().max().item() / max(scale_of(name), 1e-30)
        for name, g in dense["grads"].items()
    }
    worst = max(grad_rel, key=grad_rel.get)
    result = {
        "dtype": str(dtype).replace("torch.", ""),
        "window": list(window),
        "loss_flash": flash["loss"],
        "loss_dense": dense["loss"],
        "loss_rel_diff": loss_rel,
        "max_grad_rel_diff": grad_rel[worst],
        "max_grad_rel_diff_param": worst,
        "step_ms_flash": flash["step_ms"],
        "step_ms_dense": dense["step_ms"],
        "launches": flash["launches"],
    }
    if dtype == torch.bfloat16:
        limit = MODEL_STEPS_16BIT * 2.0 ** -8
        result["loss_bf16_steps"] = loss_rel / 2.0 ** -8
        result["max_grad_bf16_steps"] = grad_rel[worst] / 2.0 ** -8
    else:
        limit = MODEL_REL_FLOAT32
    result["rel_tolerance"] = limit
    log(label, json.dumps(result))
    if not (loss_rel <= limit and grad_rel[worst] <= limit):
        raise AssertionError(f"{label}: flash and dense steps differ beyond {limit}: {result}")
    return result


def model_phase(torch, fa):
    """Phase 7: the 16-bit path and the wide-head path through the model a
    user builds: the bf16 long-context Transformer runs the tensor-core
    forward, dq and dk/dv kernels once per layer; the Transformer with
    heads of 300 runs the sliced forward and the tiled dq and dk/dv once
    per layer: the CUDA-core ones in float32, the tensor-core ones in
    bfloat16."""
    report = {}
    for label, widths, window, dtype, kernels in (
        ("bf16_model", MODEL_16BIT, WINDOW_16BIT, torch.bfloat16,
         (f"{fa.KERNEL}_mma", f"{fa.KERNEL_DQ}_mma", f"{fa.KERNEL_DKV}_mma")),
        ("wide_head_model", MODEL_WIDE_HEAD, WINDOW_WIDE_HEAD, torch.float32,
         (f"{fa.KERNEL}_sliced", f"{fa.KERNEL_DQ}_tiled", f"{fa.KERNEL_DKV}_tiled")),
        ("wide_head_bf16_model", MODEL_WIDE_HEAD, WINDOW_WIDE_HEAD, torch.bfloat16,
         (f"{fa.KERNEL}_sliced", f"{fa.KERNEL_DQ}_tiled_mma", f"{fa.KERNEL_DKV}_tiled_mma")),
    ):
        result = model_step_check(torch, fa, label, widths, window, dtype)
        want = {name: widths["n_layers"] for name in kernels}
        if result["launches"] != want:
            raise AssertionError(f"{label} launched {result['launches']}, expected {want}")
        report[label] = result
        torch.cuda.empty_cache()
    return report


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


@contextlib.contextmanager
def http_server(collection: str, machine: str = MACHINE):
    """The port's server over ``collection`` on the card, on a free local
    port, for the ``with`` block; yields ``machine``'s base URL."""
    from gordo_tpu_torch.server.app import build_app
    from gordo_tpu_torch.server.runner import make_http_server

    app = build_app(collection)  # the card: no device argument
    server = make_http_server(app, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_port}/gordo/v0/{PROJECT}/{machine}"
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)


def block_array(block: dict, keys) -> "list":
    return [[block[label][key] for label in block] for key in keys]


def end_to_end_phase(torch, fa, profile: bool):
    """Phase 4: serve the full-width machine over HTTP on the card."""
    import numpy as np

    from gordo_tpu_torch import convert, serializer

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
        "project_name": PROJECT,
        "evaluation": {},
    }
    report = {"requests": []}
    with tempfile.TemporaryDirectory() as tmp:
        collection = os.path.join(tmp, "1700000000000")
        artifact = os.path.join(collection, MACHINE)
        convert.write_artifact(
            artifact, tree, DEFINITION, center, scale, thresholds, metadata
        )
        bodies = {n: sensor_body(rng, n) for n in (144, lookback - 1 + CHUNK_WINDOWS)}
        with http_server(collection) as base:
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
            report["kernel_launches"] = dict(fa.kernel_launches)

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


def kernel_rows(prof):
    """(rows of device microseconds by kernel, largest first; their sum)
    from a torch.profiler run."""
    from torch.autograd import DeviceType

    rows = []
    for event in prof.key_averages():
        # kernels only: an operator's row repeats its kernels' device time,
        # and a user annotation's (Optimizer.step) spans its whole region
        if event.device_type != DeviceType.CUDA or getattr(event, "is_user_annotation", False):
            continue
        device_us = event.self_device_time_total
        if device_us > 0:
            rows.append({"name": event.key[:80], "count": event.count, "device_us": device_us})
    rows.sort(key=lambda r: -r["device_us"])
    return rows, sum(r["device_us"] for r in rows)


def profile_predict(torch, artifact, bodies):
    """Device time by kernel for one 8192-window predict (torch.profiler)."""
    import numpy as np
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
    rows, total_us = kernel_rows(prof)
    log("profile predict wall ms", wall_ms, "device ms", total_us / 1e3)
    for row in rows[:12]:
        log("profile", json.dumps(row))
    return {"wall_ms": wall_ms, "device_ms": total_us / 1e3, "kernels": rows[:20]}


def sensor_rows(n_rows: int, seed: int):
    """(rows, 3) float32 sensor data: a daily sinusoid per tag with its own
    phase, level and amplitude, plus noise, from a numpy seed; and the
    rows' 10-minute timestamps from the start of the machine's span."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.arange(n_rows)[:, None]
    phase = rng.uniform(0, 2 * np.pi, size=len(TAGS))
    level = rng.uniform(-1.0, 1.0, size=len(TAGS))
    amplitude = rng.uniform(0.5, 2.0, size=len(TAGS))
    daily = np.sin(2 * np.pi * t / 144 + phase)
    X = level + amplitude * daily + 0.1 * rng.normal(size=(n_rows, len(TAGS)))
    index = [TRAIN_START + timedelta(minutes=10 * i) for i in range(n_rows)]
    return X.astype(np.float32), index


def optimizer_steps(n_rows: int, lookback: int, epochs: int) -> int:
    """Optimizer steps of a full build on ``n_rows``: the TimeSeriesSplit(3)
    folds as one fleet fit (``ceil(windows of the largest fold /
    batch_size)`` steps an epoch, each step all three folds at once), then
    the fit on every row (``ceil(windows / batch_size)`` an epoch)."""
    from gordo_tpu_torch.models.utils import TimeSeriesSplit
    from gordo_tpu_torch.ops.windowing import num_windows

    largest_fold = max(len(train) for train, _ in TimeSeriesSplit(n_splits=3).split(range(n_rows)))
    return epochs * sum(math.ceil(num_windows(n, lookback, 0) / BATCH_SIZE)
                        for n in (largest_fold, n_rows))


def train_phase(torch, fa, profile: bool):
    """Phase 5: build, calibrate and serve the machine through the port's
    builder on the card, ``TRAIN_EPOCHS`` epochs; then one training step
    card against CPU and the step timings."""
    from gordo_tpu_torch.builder import ModelBuilder

    epochs = TRAIN_EPOCHS
    base = dict(BASE_ESTIMATOR, epochs=epochs)
    n_layers, lookback = base["n_layers"], base["lookback_window"]
    definition = {
        "gordo_tpu.models.anomaly.DiffBasedAnomalyDetector": {
            "base_estimator": {"gordo_tpu.models.TransformerAutoEncoder": base}
        }
    }
    # the config's machine with the flash path, the cut epochs and the seed
    machine = example_machines(
        os.path.dirname(os.path.abspath(__file__)),
        {MACHINE: {"model": definition, "evaluation": {"seed": SEED}}},
    )[MACHINE]
    if machine.evaluation.get("scoring_scaler") is None or [
        tag.name for tag in machine.dataset.tag_list
    ] != TAGS:
        raise AssertionError(f"unexpected normalized machine: {machine}")
    X, index = sensor_rows(TRAIN_ROWS, SEED)
    steps = optimizer_steps(len(X), lookback, epochs)
    report = {"rows": len(X), "epochs": epochs, "optimizer_steps": steps}
    with tempfile.TemporaryDirectory() as tmp:
        collection = os.path.join(tmp, "1700000000001")
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        model, built = ModelBuilder(machine).build(
            X, X, index=index, output_dir=os.path.join(collection, MACHINE)
        )
        torch.cuda.synchronize()
        report["build_s"] = time.perf_counter() - t0
        launches = dict(fa.launch_counts)
        report["launches"] = launches
        report["kernel_launches"] = dict(fa.kernel_launches)
        log("train launches", json.dumps(launches), "optimizer steps", steps)
        for kernel in (fa.KERNEL_DQ, fa.KERNEL_DKV):
            if launches[kernel] != n_layers * steps:
                raise AssertionError(
                    f"{kernel} launched {launches[kernel]} times in the build; "
                    f"expected n_layers x optimizer steps = {n_layers * steps}"
                )
        if launches[fa.KERNEL] < n_layers * steps:
            raise AssertionError(f"the forward kernel launched only {launches[fa.KERNEL]} times")

        model_meta = built.to_dict()["metadata"]["build_metadata"]["model"]
        history = model.base_estimator.history_
        report.update(
            cv_s=model_meta["cross_validation"]["cv_duration_sec"],
            fit_s=model_meta["model_training_duration_sec"],
            fit_steps=history["params"]["steps"] * epochs,
            epoch_loss=history["loss"],
            # the aggregate scorers' fold means (the per-tag ones are in --out)
            scores={
                name.replace("_", "-"): model_meta["cross_validation"]["scores"][
                    name.replace("_", "-")]["fold-mean"]
                for name in METRIC_NAMES
            },
        )
        report["fit_steps_per_s"] = report["fit_steps"] / report["fit_s"]
        report["build_steps_per_s"] = steps / (report["cv_s"] + report["fit_s"])
        if not history["loss"][-1] < history["loss"][0]:
            raise AssertionError(f"the fit's loss did not fall: {history['loss']}")
        thresholds = {
            "aggregate": model_meta["model_meta"]["aggregate-threshold"],
            "features": model_meta["model_meta"]["feature-thresholds"],
            "per_fold": model_meta["model_meta"]["aggregate-thresholds-per-fold"],
        }
        values = [thresholds["aggregate"], *thresholds["features"], *thresholds["per_fold"].values()]
        if not all(math.isfinite(x) and x > 0 for x in values):
            raise AssertionError(f"thresholds not finite and positive: {thresholds}")
        report["thresholds"] = thresholds
        if model_meta["model_offset"] != lookback - 1:
            raise AssertionError(f"model_offset {model_meta['model_offset']}")
        log("train", json.dumps({k: v for k, v in report.items() if k != "launches"}))

        report["served"] = serve_trained(fa, collection, X, index, n_layers, lookback)
    report["step_parity"] = step_parity(torch, X, base)
    report["step_timing"] = time_train_steps(torch, X, base, profile)
    return report


def serve_trained(fa, collection: str, X, index, n_layers: int, lookback: int):
    """The artifact the build wrote, served over HTTP on the card:
    ``/anomaly/prediction`` at 144 rows answers with finite confidences."""
    import numpy as np

    stamps = [stamp.isoformat() for stamp in index[-144:]]
    frame = {tag: dict(zip(stamps, X[-144:, j].tolist())) for j, tag in enumerate(TAGS)}
    payload = json.dumps({"X": frame, "y": frame}).encode()
    with http_server(collection) as base:
        fa.reset_launch_counts()
        reply, seconds = post(f"{base}/anomaly/prediction", payload)
        launches = fa.launch_counts[fa.KERNEL]
        kernel_launches = dict(fa.kernel_launches)
    data = reply["data"]
    for key in ("total-anomaly-confidence", "anomaly-confidence"):
        if key not in data:
            raise AssertionError(f"the trained machine's reply has no {key!r}")
    (confidence,) = data["total-anomaly-confidence"].values()
    confidence = np.asarray(list(confidence.values()), dtype=np.float64)
    if len(confidence) != 144 - lookback + 1 or not np.isfinite(confidence).all():
        raise AssertionError(f"total-anomaly-confidence: {confidence}")
    if launches != n_layers:
        raise AssertionError(f"serving the trained machine launched the forward {launches} times")
    served = {"seconds": seconds, "launches": launches, "kernel_launches": kernel_launches,
              "median_total_confidence": float(np.median(confidence))}
    log("served trained artifact", json.dumps(served))
    return served


def _fresh_step(torch, X, base, device, seed):
    """(module, optimizer, loss name, batch) for training steps of the
    machine's full-width model on ``device`` from the seed's weights (the
    same on every device): the first ``BATCH_SIZE`` windows of X."""
    from gordo_tpu_torch.models import TransformerAutoEncoder
    from gordo_tpu_torch.ops.windowing import gather_windows

    estimator = TransformerAutoEncoder(**base, n_features=len(TAGS), n_features_out=len(TAGS))
    spec = estimator._build_spec()
    spec.module.load_state_dict(estimator._initial_state(spec, seed))
    module = spec.module.to(device).train()
    optimizer = spec.make_optimizer(module.parameters())
    lookback = base["lookback_window"]
    Xd = torch.from_numpy(X[: lookback - 1 + BATCH_SIZE]).to(device)
    xb, yb = gather_windows(Xd, Xd, torch.arange(BATCH_SIZE, device=device), lookback, 0)
    weights = torch.ones(BATCH_SIZE, device=device)
    return module, optimizer, spec.loss, (xb, yb, weights)


def step_parity(torch, X, base):
    """One full-width training step (the machine's Adam) from the same
    weights and batch on the card and on the CPU, dropout 0 (the two
    devices' generators differ): the loss, every gradient and every
    parameter after the step within 1e-4. The attention key biases are
    held by their gradient only: it is 0 in exact arithmetic (a shift of
    every key moves a query's scores by a constant, which the softmax
    ignores), so each device's is rounding noise, which Adam's first step
    turns into a step of up to the learning rate either way."""
    from gordo_tpu_torch.models.core import train_step

    base = dict(base, dropout=0.0)
    outcome = {}
    for device in ("cpu", "cuda"):
        module, optimizer, loss_name, (xb, yb, w) = _fresh_step(torch, X, base, device, SEED)
        loss = train_step(module, optimizer, loss_name, xb, yb, w).item() / BATCH_SIZE
        outcome[device] = (
            loss,
            {n: p.grad.detach().cpu() for n, p in module.named_parameters()},
            {n: p.detach().cpu() for n, p in module.named_parameters()},
        )
    (cpu_loss, cpu_grads, cpu_params), (card_loss, card_grads, card_params) = (
        outcome["cpu"], outcome["cuda"]
    )
    grad_err = max((card_grads[n] - cpu_grads[n]).abs().max().item() for n in cpu_grads)
    param_err = max(
        (card_params[n] - cpu_params[n]).abs().max().item()
        for n in cpu_params if not n.endswith("attn.key.bias")
    )
    key_bias_grad = max(
        max(grads[n].abs().max().item() for n in grads if n.endswith("attn.key.bias"))
        for grads in (cpu_grads, card_grads)
    )
    parity = {"loss_cpu": cpu_loss, "loss_card": card_loss,
              "loss_err": abs(card_loss - cpu_loss), "max_grad_err": grad_err,
              "max_param_err": param_err, "max_key_bias_grad": key_bias_grad}
    log("train step card vs cpu", json.dumps(parity))
    if not (parity["loss_err"] <= 1e-4 and grad_err <= 1e-4 and param_err <= 1e-4):
        raise AssertionError(f"one training step differs between the card and the CPU: {parity}")
    return parity


def time_train_steps(torch, X, base, profile: bool):
    """Host-clock training step times at full width on the card, dropout
    on as configured: the median of ``TIMED_STEPS`` steps each ended by a
    synchronise, and ``TIMED_STEPS`` steps back to back as the fit runs
    them (one synchronise at the end). With ``profile``, a torch.profiler
    trace of ``PROFILED_STEPS`` back-to-back steps: device time by kernel
    and the device's idle share of the window."""
    from gordo_tpu_torch.models.core import train_step

    module, optimizer, loss_name, (xb, yb, w) = _fresh_step(torch, X, base, "cuda", SEED)
    generator = torch.Generator(device="cuda").manual_seed(SEED)

    def step():
        return train_step(module, optimizer, loss_name, xb, yb, w, generator)

    for _ in range(5):
        step()
    torch.cuda.synchronize()
    synced = []
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        synced.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        step()
    torch.cuda.synchronize()
    back_to_back_ms = (time.perf_counter() - t0) * 1e3 / TIMED_STEPS
    timing = {"step_ms_median": statistics.median(synced),
              "step_ms_back_to_back": back_to_back_ms,
              "steps_per_s": 1e3 / back_to_back_ms}
    log("train step timing", json.dumps(timing))
    if profile:
        from torch.profiler import ProfilerActivity, profile as torch_profile

        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(PROFILED_STEPS):
                step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        rows, total_us = kernel_rows(prof)
        host = sorted(
            ({"name": e.key[:80], "count": e.count, "self_cpu_us": e.self_cpu_time_total}
             for e in prof.key_averages() if e.self_cpu_time_total > 0),
            key=lambda r: -r["self_cpu_us"],
        )
        timing["profile"] = {
            "steps": PROFILED_STEPS,
            "wall_ms": wall_ms,
            "device_ms": total_us / 1e3,
            "device_idle_share": 1.0 - total_us / 1e3 / wall_ms,
            "kernels": rows[:25],
            "host_ops": host[:25],
        }
        log("profile train steps wall ms", wall_ms, "device ms", total_us / 1e3,
            "idle share", timing["profile"]["device_idle_share"])
        for row in rows[:15]:
            log("profile", json.dumps(row))
        for row in host[:15]:
            log("profile host", json.dumps(row))
    return timing


def default_pipeline_phase(torch, fa, profile: bool):
    """Phase 6: each default-pipeline machine of examples/config.yaml, read
    through the port's config layer, built by the port's CLI on the card
    (``python -m gordo_tpu_torch.cli build``, ``MACHINE`` the normalized
    machine as YAML text: fetch and resample, TimeSeriesSplit(3) CV and
    thresholds, fit, artifact), its row count against the JAX data
    layer's, its fit on the card; then served over HTTP on the card with
    the machine's own first 144 rows and all its rows, each reply held
    against the same request to the same artifact on the CPU. The flash
    counts are reset just before and read just after: this path has no
    attention, so none may launch."""
    from gordo_tpu_torch import serializer
    from gordo_tpu_torch.data import _get_dataset
    from gordo_tpu_torch.models.utils import TimeSeriesSplit

    root = os.path.dirname(os.path.abspath(__file__))
    report = {"startup": startup_probe(root)}
    machines = example_machines(root)
    fa.reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        collection = os.path.join(tmp, DEFAULT_COLLECTION)
        for name in DEFAULT_ROWS:
            machine = machines[name].to_dict()
            artifact = os.path.join(collection, name)
            wall_s, build_log = cli_build(root, machine, artifact)
            meta = serializer.load_metadata(artifact)["metadata"]["build_metadata"]
            dataset_meta = meta["dataset"]["dataset_meta"]
            rows = dataset_meta["tag_loading_metadata"]["aggregate_metadata"]["dropped_na_length"]
            if rows != DEFAULT_ROWS[name]:
                raise AssertionError(f"{name}: {rows} rows, the JAX data layer gives "
                                     f"{DEFAULT_ROWS[name]}")
            folds = [len(train) for train, _ in TimeSeriesSplit(n_splits=3).split(range(rows))]
            steps = sum(math.ceil(n / BATCH_SIZE) for n in folds + [rows])  # 1 epoch each
            model_meta = meta["model"]
            row = {
                "rows": rows,
                "build_wall_s": wall_s,
                "fetch_s": meta["dataset"]["query_duration_sec"],
                "cv_s": model_meta["cross_validation"]["cv_duration_sec"],
                "fit_s": model_meta["model_training_duration_sec"],
                "optimizer_steps": steps,
                "aggregate_threshold": model_meta["model_meta"]["aggregate-threshold"],
            }
            row["steps_per_s"] = steps / (row["cv_s"] + row["fit_s"])
            row["fit_steps_per_s"] = math.ceil(rows / BATCH_SIZE) / row["fit_s"]
            row["build_log"] = build_log
            log("default pipeline build", name, json.dumps(row))
            thresholds = [row["aggregate_threshold"],
                          *model_meta["model_meta"]["feature-thresholds"]]
            if not all(math.isfinite(x) and x > 0 for x in thresholds):
                raise AssertionError(f"{name}: thresholds not finite and positive: {model_meta}")
            X, _, stamps = _get_dataset(machine["dataset"]).get_data()
            row["requests"] = serve_built(torch, collection, machine, X, stamps,
                                          ("prediction", "anomaly/prediction"), 1e-5)
            if profile:
                row["fit_profile"] = profile_default_fit(torch, artifact, X)
            report[name] = row
        report["flash_launches"] = dict(fa.launch_counts)
        report["kernel_launches"] = dict(fa.kernel_launches)
    if any(report["flash_launches"].values()):
        raise AssertionError(f"the default pipeline launched flash kernels: {report}")
    return report


def example_machines(root: str, patches: Optional[dict] = None) -> dict:
    """{name: Machine} of examples/config.yaml, read and normalized by the
    port's config layer (``get_dict_from_yaml``, ``NormalizedConfig``) as
    the workflow normalizes them; ``patches`` maps a machine's name to
    keys laid over its own block first."""
    from gordo_tpu_torch.workflow.config_elements import NormalizedConfig
    from gordo_tpu_torch.workflow.workflow_generator import get_dict_from_yaml

    config = get_dict_from_yaml(os.path.join(root, "examples", "config.yaml"))
    for block in config["machines"]:
        block.update((patches or {}).get(block["name"], {}))
    return {m.name: m for m in NormalizedConfig(config, project_name=PROJECT).machines}


def yaml_text(value, indent: int = 0) -> str:
    """``value`` (dicts, lists, strings, numbers, booleans, None) as block
    YAML: strings double-quoted, floats always with a dot and a signed
    exponent where they have one (YAML 1.1 reads ``1e-05`` as a string)."""
    pad = " " * indent
    if isinstance(value, (dict, list)) and value:
        lines = []
        items = value.items() if isinstance(value, dict) else ((None, v) for v in value)
        for key, item in items:
            head = f"{pad}{json.dumps(str(key))}:" if isinstance(value, dict) else f"{pad}-"
            if isinstance(item, (dict, list)) and item:
                lines.append(f"{head}\n{yaml_text(item, indent + 2)}")
            else:
                lines.append(f"{head} {yaml_text(item)}")
        return "\n".join(lines)
    if isinstance(value, float) and math.isfinite(value):
        mantissa, _, exponent = repr(value).partition("e")
        if exponent:
            mantissa = mantissa if "." in mantissa else mantissa + ".0"
            return f"{mantissa}e{exponent if exponent[0] in '+-' else '+' + exponent}"
        return mantissa
    if isinstance(value, float):
        return ".nan" if math.isnan(value) else ("-.inf" if value < 0 else ".inf")
    return json.dumps(value)


def cli_build(root: str, machine: dict, artifact: str):
    """``python -m gordo_tpu_torch.cli build`` of ``machine`` (``MACHINE``
    its YAML text) into ``artifact`` in a subprocess on the card: (wall
    seconds, the log's fetch, cross-validation and fit lines). Raises
    unless it exits 0 having fitted on the card."""
    name = machine["name"]
    env = dict(os.environ, MACHINE=yaml_text(machine), OUTPUT_DIR=artifact)
    env.pop("GORDO_TPU_LAKE_DIR", None)
    t0 = time.perf_counter()
    built = subprocess.run(
        [sys.executable, "-m", "gordo_tpu_torch.cli", "build"],
        cwd=root, env=env, capture_output=True, text=True, timeout=300,
    )
    wall_s = time.perf_counter() - t0
    if built.returncode != 0:
        raise AssertionError(f"build {name} exited {built.returncode}:\n{built.stderr[-4000:]}")
    if "model parameters on cuda" not in built.stderr:
        raise AssertionError(f"build {name} did not fit on the card:\n{built.stderr}")
    return wall_s, [line for line in built.stderr.splitlines()
                    if "Fetched" in line or "Cross-validated" in line or "Fitted" in line]


def startup_probe(root: str) -> dict:
    """What a fresh build process pays before its steady state, timed in
    a subprocess as the CLI runs: importing torch, the first CUDA
    operation, importing the port, the port's first optimizer
    (``gordo_tpu_torch.models.optim``; a ``torch.optim`` one imported
    ``torch._dynamo`` on first use),
    and two 1-epoch fits of pump-4130's net on 64 rows (the first pays the
    first launch of every kernel)."""
    code = (
        "import json, time\n"
        "t0 = time.perf_counter()\n"
        "import torch\n"
        "t1 = time.perf_counter()\n"
        "torch.zeros(1, device='cuda'); torch.cuda.synchronize()\n"
        "t2 = time.perf_counter()\n"
        "import numpy as np\n"
        "from gordo_tpu_torch.models import AutoEncoder\n"
        "t3 = time.perf_counter()\n"
        "from gordo_tpu_torch.models.specs import make_optimizer\n"
        "make_optimizer('adam', {}, [torch.zeros(1, device='cuda', requires_grad=True)])\n"
        "t4 = time.perf_counter()\n"
        "X = np.random.default_rng(0).random((64, 3))\n"
        "fits = []\n"
        "for _ in range(2):\n"
        "    t = time.perf_counter()\n"
        "    AutoEncoder('feedforward_hourglass').fit(X, X); torch.cuda.synchronize()\n"
        "    fits.append(time.perf_counter() - t)\n"
        "print(json.dumps({'import_torch_s': t1 - t0, 'first_cuda_op_s': t2 - t1,\n"
        "                  'import_port_s': t3 - t2, 'first_optimizer_s': t4 - t3,\n"
        "                  'first_fit_s': fits[0],\n"
        "                  'second_fit_s': fits[1]}))\n"
    )
    t0 = time.perf_counter()
    probe = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                           text=True, timeout=300)
    if probe.returncode != 0:
        raise AssertionError(f"start-up probe failed:\n{probe.stderr[-4000:]}")
    result = json.loads(probe.stdout.strip().splitlines()[-1])
    result["process_wall_s"] = time.perf_counter() - t0
    log("build process start-up", json.dumps(result))
    return result


def serve_built(torch, collection: str, machine: dict, X, stamps, routes, tolerance: float,
                history_repeats: int = REPEATS):
    """A built artifact served over HTTP on the card: each of ``routes``
    with the machine's first 144 rows (``REPEATS`` times) and with all its
    rows (``history_repeats`` times; none when 0); every reply's numbers
    within ``tolerance`` of the same request to the same artifact on the
    CPU."""
    import numpy as np

    from gordo_tpu_torch import serializer
    from gordo_tpu_torch.builder.build_model import fitted_estimator
    from gordo_tpu_torch.data.base import to_datetimes
    from gordo_tpu_torch.server.app import GordoApp

    name, tags = machine["name"], machine["dataset"]["tag_list"]
    keys = [stamp.isoformat() for stamp in to_datetimes(stamps.astype(np.int64))]
    cpu_app = GordoApp(collection, device="cpu")
    card_model = serializer.load(os.path.join(collection, name))
    device = next(fitted_estimator(card_model).spec_.module.parameters()).device
    if device.type != "cuda":
        raise AssertionError(f"{name} loaded onto {device}, not the card")
    metadata = serializer.load_metadata(os.path.join(collection, name))
    offset = metadata["metadata"]["build_metadata"]["model"]["model_offset"]
    rows = []
    with http_server(collection, name) as base:
        for n_rows in ((144, len(X)) if history_repeats else (144,)):
            frame = {tag: dict(zip(keys[:n_rows], X[:n_rows, j].tolist()))
                     for j, tag in enumerate(tags)}
            payload = json.dumps({"X": frame, "y": frame}).encode()
            for route in routes:
                times = []
                for _ in range(REPEATS if n_rows == 144 else history_repeats):
                    reply, seconds = post(f"{base}/{route}", payload)
                    times.append(seconds)
                path = f"/gordo/v0/{PROJECT}/{name}/{route}"
                t0 = time.perf_counter()
                cpu = cpu_app.dispatch("POST", path, lambda: payload)
                cpu_s = time.perf_counter() - t0
                if cpu.status != 200:
                    raise AssertionError(f"{name} {route} on the CPU answered {cpu.status}")
                diff = max_block_diff(reply["data"], cpu.payload["data"], n_rows - offset)
                result = {"route": route, "rows": n_rows, "median_s": statistics.median(times),
                          "seconds": times, "cpu_s": cpu_s, "max_abs_diff_card_vs_cpu": diff}
                log("served", name, json.dumps(result))
                if not diff <= tolerance:
                    raise AssertionError(f"{name} {route}: card and CPU differ by {diff}")
                rows.append(result)
    return rows


def max_block_diff(card: dict, cpu: dict, n_rows: int) -> float:
    """Largest difference between two replies' numeric blocks, which must
    have the same blocks, ``n_rows`` finite rows each."""
    import numpy as np

    if set(card) != set(cpu):
        raise AssertionError(f"reply blocks differ: {sorted(set(card) ^ set(cpu))}")
    def columns(block: dict, labels, keys) -> "np.ndarray":
        """The block's columns as rows of an array, each column checked to
        carry exactly ``keys``, in order (a whole-history block has
        millions of cells, so no lookup per cell)."""
        if list(block) != labels:
            raise AssertionError(f"{top}: columns {list(block)} against {labels}")
        for label in labels:
            if list(block[label]) != keys:
                raise AssertionError(f"{top}/{label}: the rows' labels differ")
        return np.asarray([list(block[label].values()) for label in labels], dtype=np.float64)

    worst = 0.0
    for top, block in card.items():
        if top in ("start", "end"):
            continue
        labels, keys = list(block), list(block[next(iter(block))])
        if len(keys) != n_rows:
            raise AssertionError(f"{top}: {len(keys)} rows for {n_rows} posted")
        got, want = columns(block, labels, keys), columns(cpu[top], labels, keys)
        if not np.isfinite(got).all():
            raise AssertionError(f"non-finite values in {top}")
        worst = max(worst, float(np.abs(got - want).max()))
    return worst


def profile_default_fit(torch, artifact: str, X):
    """torch.profiler over one fit of the machine's model on its rows on
    the card (1 epoch, batch 32): wall and device time, idle share."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from gordo_tpu_torch import serializer

    with open(os.path.join(artifact, serializer.DEFINITION_FILENAME)) as fh:
        definition = json.load(fh)
    model = serializer.from_definition(definition)
    model.fit(X, X)  # warm-up: the first fit pays CUDA's start-up
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serializer.from_definition(definition).fit(X, X)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows, total_us = kernel_rows(prof)
    result = {"wall_ms": wall_ms, "device_ms": total_us / 1e3,
              "device_idle_share": 1.0 - total_us / 1e3 / wall_ms, "kernels": rows[:10]}
    log("profile default fit", json.dumps({k: v for k, v in result.items() if k != "kernels"}))
    return result


def recurrent_phase(torch, fa, profile: bool):
    """Phase 8: each recurrent machine built by the port's CLI on the card
    (``python -m gordo_tpu_torch.cli build`` from its normalized JSON:
    fetch and resample, TimeSeriesSplit(3) CV and thresholds, fit,
    artifact), its row count against the JAX data layer's; then served
    over HTTP on the card (``/anomaly/prediction`` with the first 144 rows
    and with all rows, medians of ``REPEATS``), each reply within 1e-4 of
    the same request on the CPU; one training step's time, launches and
    (with ``profile``, over ``PROFILED_STEPS`` steps) device idle share;
    then one forward of the stacked schedule at the LSTM's widths, card
    against CPU. The flash counts are reset just before and read just
    after: no flash kernel may launch on this path."""
    from gordo_tpu_torch import serializer
    from gordo_tpu_torch.data import _get_dataset
    from gordo_tpu_torch.models.utils import TimeSeriesSplit

    root = os.path.dirname(os.path.abspath(__file__))
    report = {}
    fa.reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        collection = os.path.join(tmp, RECURRENT_COLLECTION)
        for name, machine in RECURRENT_MACHINES.items():
            artifact = os.path.join(collection, name)
            wall_s, build_log = cli_build(root, machine, artifact)
            meta = serializer.load_metadata(artifact)["metadata"]["build_metadata"]
            dataset_meta = meta["dataset"]["dataset_meta"]
            rows = dataset_meta["tag_loading_metadata"]["aggregate_metadata"]["dropped_na_length"]
            if rows != RECURRENT_ROWS:
                raise AssertionError(f"{name}: {rows} rows, the JAX data layer gives "
                                     f"{RECURRENT_ROWS}")
            (estimator,) = machine["model"]["gordo_tpu.models.anomaly.DiffBasedAnomalyDetector"][
                "base_estimator"].values()
            epochs, lookback = estimator["epochs"], estimator["lookback_window"]
            model_meta = meta["model"]
            offset = model_meta["model_offset"]
            folds = [len(train) for train, _ in TimeSeriesSplit(n_splits=3).split(range(rows))]
            fit_steps = epochs * math.ceil((rows - offset) / PLANT_BATCH)
            steps = fit_steps + epochs * sum(
                math.ceil((n - offset) / PLANT_BATCH) for n in folds)
            row = {
                "rows": rows,
                "epochs": epochs,
                "build_wall_s": wall_s,
                "fetch_s": meta["dataset"]["query_duration_sec"],
                "cv_s": model_meta["cross_validation"]["cv_duration_sec"],
                "fit_s": model_meta["model_training_duration_sec"],
                "optimizer_steps": steps,
                "epoch_loss": model_meta["model_meta"]["history"]["loss"],
                "explained_variance": model_meta["cross_validation"]["scores"][
                    "explained-variance-score"]["fold-mean"],
                "build_log": build_log,
            }
            row["steps_per_s"] = steps / (row["cv_s"] + row["fit_s"])
            row["fit_steps_per_s"] = fit_steps / row["fit_s"]
            log("recurrent build", name, json.dumps(row))
            thresholds = [model_meta["model_meta"]["aggregate-threshold"],
                          *model_meta["model_meta"]["feature-thresholds"]]
            if not all(math.isfinite(x) and x > 0 for x in thresholds):
                raise AssertionError(f"{name}: thresholds not finite and positive: {model_meta}")
            lookahead = model_meta["model_meta"]["forecast_steps"]
            if offset != lookback - 1 + lookahead:
                raise AssertionError(f"{name}: model_offset {offset}, lookahead {lookahead}")
            X, _, stamps = _get_dataset(machine["dataset"]).get_data()
            t0 = time.perf_counter()
            row["requests"] = serve_built(torch, collection, machine, X, stamps,
                                          ("anomaly/prediction",), 1e-4,
                                          RECURRENT_HISTORY_REPEATS)
            row["serve_check_s"] = time.perf_counter() - t0
            row["step"] = time_window_steps(torch, machine, X, profile)
            report[name] = row
        report["stacked"] = stacked_forward_check(torch, X)
        report["flash_launches"] = dict(fa.launch_counts)
        report["kernel_launches"] = dict(fa.kernel_launches)
    log("recurrent flash launches", json.dumps(report["flash_launches"]))
    if any(report["flash_launches"].values()):
        raise AssertionError(f"the recurrent path launched flash kernels: {report}")
    return report


def window_batch(torch, estimator, X):
    """(module, optimizer, loss name, batch) for training steps of a
    windowed estimator's net on the card from the seed's weights: its
    first ``PLANT_BATCH`` windows of X."""
    import numpy as np

    from gordo_tpu_torch.ops.windowing import gather_windows

    estimator.kwargs.update(n_features=X.shape[1], n_features_out=X.shape[1])
    spec = estimator._build_spec()
    spec.module.load_state_dict(estimator._initial_state(spec, SEED))
    module = spec.module.to("cuda").train()
    lookback, lookahead = spec.lookback_window, estimator.lookahead
    rows = np.asarray(X[: lookback + lookahead - 1 + PLANT_BATCH], dtype=np.float32)
    Xd = torch.from_numpy(rows).to("cuda")
    xb, yb = gather_windows(Xd, Xd, torch.arange(PLANT_BATCH, device="cuda"), lookback,
                            lookahead)
    weights = torch.ones(PLANT_BATCH, device="cuda")
    return module, spec.make_optimizer(module.parameters()), spec.loss, (xb, yb, weights)


def time_window_steps(torch, machine, X, profile: bool):
    """Training steps of a windowed machine's net (phases 8 and 9) at full
    width on the card: the median host-clock time of 10 steps each ended
    by a synchronise, 10 back to back as the fit runs them, and a
    torch.profiler window of 3 steps (``PROFILED_STEPS`` with
    ``profile``): CUDA kernel launches a step and the device's idle share
    of the window. The window records CUDA activity only: kernels are
    what it counts, and at 9000-16 000 launches a step the CPU operator
    events took the host tens of seconds to parse."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from gordo_tpu_torch import serializer
    from gordo_tpu_torch.models.core import train_step

    estimator = serializer.from_definition(machine["model"]).base_estimator
    module, optimizer, loss_name, (xb, yb, w) = window_batch(torch, estimator, X)
    generator = torch.Generator(device="cuda").manual_seed(SEED)  # dropout masks

    def step():
        return train_step(module, optimizer, loss_name, xb, yb, w, generator)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    synced = []
    for _ in range(10):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        synced.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    for _ in range(10):
        step()
    torch.cuda.synchronize()
    back_to_back_ms = (time.perf_counter() - t0) * 1e3 / 10
    n_steps = PROFILED_STEPS if profile else 3
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows, total_us = kernel_rows(prof)
    if not rows:
        raise AssertionError(f"{machine['name']}: the profiler recorded no CUDA kernel")
    timing = {
        "batch": PLANT_BATCH,
        "step_ms_median": statistics.median(synced),
        "step_ms_back_to_back": back_to_back_ms,
        "steps_per_s": 1e3 / back_to_back_ms,
        "profiled_steps": n_steps,
        "launches_per_step": sum(row["count"] for row in rows) / n_steps,
        "profiled_wall_ms": wall_ms,
        "device_ms": total_us / 1e3,
        "device_idle_share": 1.0 - total_us / 1e3 / wall_ms,
    }
    log("training step", machine["name"], json.dumps(timing))
    if profile:
        timing["kernels"] = rows[:25]
        for row in rows[:10]:
            log("profile", json.dumps(row))
    return timing


def project_build_phase(torch, fa, profile: bool):
    """Phase 9: ``PROJECT_CONFIG`` built by the port's ``local_build`` on
    the card in this one process (read by the port's YAML reader,
    normalized, then each machine fetched, cross-validated and fitted),
    each artifact written and served over HTTP on the card on its
    ``PROJECT_SERVING`` routes with its first 144 rows and all its rows
    (medians of ``REPEATS``), every reply within its bound of the same
    request on the CPU; the TCN's training step time, CUDA launches a step
    and device idle share (``time_window_steps``) and its receptive field.
    The flash counts are reset just before and read just after: no flash
    kernel may launch on this path."""
    from gordo_tpu_torch import serializer
    from gordo_tpu_torch.builder.local_build import local_build
    from gordo_tpu_torch.data import _get_dataset
    from gordo_tpu_torch.models.specs_seq import receptive_field

    report = {}
    fa.reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        collection = os.path.join(tmp, PROJECT_COLLECTION)
        machines = []
        t0 = time.perf_counter()
        for model, machine in local_build(PROJECT_CONFIG):
            build_s = time.perf_counter() - t0
            serializer.dump(model, os.path.join(collection, machine.name), machine.to_dict())
            meta = machine.metadata.build_metadata
            model_meta = meta.model.model_meta
            row = {
                "rows": meta.dataset.dataset_meta["tag_loading_metadata"]["aggregate_metadata"][
                    "dropped_na_length"],
                "build_s": build_s,
                "fetch_s": meta.dataset.query_duration_sec,
                "cv_s": meta.model.cross_validation.cv_duration_sec,
                "fit_s": meta.model.model_training_duration_sec,
                "model_offset": meta.model.model_offset,
                "explained_variance": meta.model.cross_validation.scores[
                    "explained-variance-score"]["fold-mean"],
            }
            thresholds = [model_meta.get("aggregate-threshold", 1.0),
                          *model_meta.get("feature-thresholds", ())]
            if not all(math.isfinite(x) and x > 0 for x in thresholds):
                raise AssertionError(f"{machine.name}: thresholds not finite and positive")
            log("project build", machine.name, json.dumps(row))
            report[machine.name] = row
            machines.append(machine.to_dict())
            t0 = time.perf_counter()
        if [m["name"] for m in machines] != list(PROJECT_SERVING):
            raise AssertionError(f"built {[m['name'] for m in machines]}")
        tcn = report["tcn-plant-50"]
        if (tcn["rows"], tcn["model_offset"]) != (RECURRENT_ROWS, 63):
            raise AssertionError(f"tcn-plant-50: {tcn}")
        for machine in machines:
            name = machine["name"]
            X, _, stamps = _get_dataset(machine["dataset"]).get_data()
            routes, bound = PROJECT_SERVING[name]
            report[name]["requests"] = serve_built(torch, collection, machine, X, stamps, routes,
                                                   bound)
            if name == "tcn-plant-50":
                tcn["step"] = time_window_steps(torch, machine, X, profile)
                tcn["receptive_field"] = receptive_field(3, (1, 2, 4))
                log("tcn receptive field", tcn["receptive_field"])
        report["build_total_s"] = sum(report[m["name"]]["build_s"] for m in machines)
        report["flash_launches"] = dict(fa.launch_counts)
        report["kernel_launches"] = dict(fa.kernel_launches)
    log("project build flash launches", json.dumps(report["flash_launches"]))
    if any(report["flash_launches"].values()):
        raise AssertionError(f"the project build launched flash kernels: {report}")
    return report


def fleet_machines(root: str) -> list:
    """Phase 10's YAML list (as Python values): the Transformer bucket,
    each machine the config's normalized turbine-9900-transformer on its
    own tag names (machine i: the config's three tag kinds numbered 3i+1
    to 3i+3) and a random provider, then examples/machines_fleet.yaml as
    it is."""
    from gordo_tpu_torch.workflow.yaml_reader import safe_load

    base = dict(BASE_ESTIMATOR, epochs=FLEET_EPOCHS)
    definition = {"gordo_tpu.models.anomaly.DiffBasedAnomalyDetector": {
        "base_estimator": {"gordo_tpu.models.TransformerAutoEncoder": base}}}
    config = example_machines(
        root, {MACHINE: {"model": definition, "evaluation": {"seed": SEED}}}
    )[MACHINE].to_dict()
    machines = []
    for i in range(FLEET_TRANSFORMERS):
        tags = [f"{tag.rsplit(' ', 1)[0]} {3 * i + j + 1}" for j, tag in enumerate(TAGS)]
        dataset = dict(config["dataset"], tag_list=tags, target_tag_list=tags,
                       data_provider={"type": "RandomDataProvider", "min_size": FLEET_SAMPLES,
                                      "max_size": FLEET_SAMPLES})
        machines.append(dict(config, name=f"{MACHINE}-{i}", dataset=dataset))
    with open(os.path.join(root, "examples", "machines_fleet.yaml")) as fh:
        machines.extend(safe_load(fh.read()))
    return machines


def fleet_flash_check(torch, fa):
    """The three kernels under a machine axis on the card: vmapped flash
    attention forward and backward on a ``FLEET_FLASH_CASE`` machine batch
    (one launch of each kernel for all machines) against the plain
    version run machine by machine on the card, within float32's 1e-4."""
    from torch.func import vmap

    m, b, s, h, d = FLEET_FLASH_CASE
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    q, k, v, d_out = (torch.randn((m, b, s, h, d), generator=gen, device="cuda")
                      for _ in range(4))
    q, k, v = (x.requires_grad_(True) for x in (q, k, v))
    fa.reset_launch_counts()
    out = vmap(lambda x, y, z: fa.flash_attention(x, y, z, causal=True))(q, k, v)
    dq, dk, dv = torch.autograd.grad(out, (q, k, v), d_out)
    torch.cuda.synchronize()
    launches = dict(fa.launch_counts)
    scale = 1.0 / math.sqrt(d)
    errs = {"out": 0.0, "dq": 0.0, "dk": 0.0, "dv": 0.0}
    for i in range(m):
        with torch.no_grad():
            want, lse = fa.flash_attention_reference(q[i], k[i], v[i], True, scale)
            grads = fa.flash_attention_backward_reference(q[i], k[i], v[i], want, lse, d_out[i],
                                                          True, scale)
        for name, got, ref in zip(errs, (out[i], dq[i], dk[i], dv[i]), (want, *grads)):
            errs[name] = max(errs[name], (got.detach() - ref).abs().max().item())
    result = {"shape": list(FLEET_FLASH_CASE), "launches": launches, "max_abs_err": errs}
    log("vmapped flash", json.dumps(result))
    if launches != {fa.KERNEL: 1, fa.KERNEL_DQ: 1, fa.KERNEL_DKV: 1}:
        raise AssertionError(f"vmapped flash: one launch of each kernel expected: {launches}")
    if not all(err <= TOLERANCE["float32"] for err in errs.values()):
        raise AssertionError(f"vmapped flash differs from the plain version: {errs}")
    return result


def fleet_step_check(torch, fa, Xs):
    """``FLEET_PARITY_STEPS`` fleet steps of the Transformer bucket at full
    width (dropout 0) from the same initial weights on the card and on
    the CPU: every parameter within 1e-4, the attention key biases aside
    (their gradient is 0 in exact arithmetic, and Adam turns each
    device's rounding noise into steps of up to the learning rate; see
    ``step_parity``); each backward kernel launched once a layer a step."""
    import numpy as np

    from gordo_tpu_torch.models import TransformerAutoEncoder
    from gordo_tpu_torch.parallel.fleet import FleetTrainer, StackedData

    base = dict(BASE_ESTIMATOR, dropout=0.0)
    rows = base["lookback_window"] - 1 + FLEET_PARITY_STEPS * BATCH_SIZE
    out = {}
    for device in ("cpu", "cuda"):
        estimator = TransformerAutoEncoder(**base, n_features=len(TAGS), n_features_out=len(TAGS))
        spec = estimator._build_spec()
        trainer = FleetTrainer(spec, device=device, seed=SEED)
        params = trainer.stack_params([
            {n: t.clone() for n, t in estimator._initial_state(spec, SEED + i).items()}
            for i in range(len(Xs))
        ])
        data = StackedData.from_ragged([X[:rows] for X in Xs], [X[:rows] for X in Xs],
                                       device=device)
        fa.reset_launch_counts()
        params, losses = trainer.fit(data, params=params, epochs=1, batch_size=BATCH_SIZE)
        out[device] = ({n: t.detach().cpu() for n, t in params.items()}, losses,
                       dict(fa.launch_counts), trainer.fit_telemetry_["steps_per_epoch"])
    (cpu, cpu_loss, _, steps), (card, card_loss, launches, _) = out["cpu"], out["cuda"]
    err = max((card[n] - cpu[n]).abs().max().item() for n in cpu if not n.endswith("key.bias"))
    result = {"machines": len(Xs), "steps": steps, "max_param_err": err,
              "max_loss_err": float(np.abs(card_loss - cpu_loss).max()), "launches": launches}
    log("fleet steps card vs cpu", json.dumps(result))
    n_layers = base["n_layers"]
    if steps != FLEET_PARITY_STEPS or launches[fa.KERNEL_DQ] != n_layers * steps \
            or launches[fa.KERNEL_DKV] != n_layers * steps:
        raise AssertionError(f"fleet steps: {result}")
    if not err <= 1e-4:
        raise AssertionError(f"fleet steps differ between the card and the CPU: {result}")
    return result


def time_fleet_steps(torch, Xs):
    """Host-clock training steps at the served machine's full width on the
    card, batch 32: a fleet step of all the bucket's machines (a fit of
    ``FLEET_TIMED_STEPS`` steps, over its steps) against a solo step of one
    machine (``train_step``, the same count, one synchronise), each after a
    warm-up; then a torch.profiler window (CUDA activity) over a 3-step
    fleet fit: CUDA launches a step and the device's idle share."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from gordo_tpu_torch.models import TransformerAutoEncoder
    from gordo_tpu_torch.models.core import train_step
    from gordo_tpu_torch.parallel.fleet import FleetTrainer, StackedData

    estimator = TransformerAutoEncoder(**BASE_ESTIMATOR, n_features=len(TAGS),
                                       n_features_out=len(TAGS))
    spec = estimator._build_spec()
    trainer = FleetTrainer(spec, seed=SEED)
    init = trainer.stack_params([
        {n: t.clone() for n, t in estimator._initial_state(spec, SEED + i).items()}
        for i in range(len(Xs))
    ])
    lookback = BASE_ESTIMATOR["lookback_window"]

    def fleet_fit(steps):
        rows = lookback - 1 + steps * BATCH_SIZE
        data = StackedData.from_ragged([X[:rows] for X in Xs], [X[:rows] for X in Xs])
        t0 = time.perf_counter()
        trainer.fit(data, params=init, epochs=1, batch_size=BATCH_SIZE)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / steps

    fleet_fit(3)
    fleet_ms = fleet_fit(FLEET_TIMED_STEPS)
    module, optimizer, loss_name, (xb, yb, w) = _fresh_step(torch, Xs[0], BASE_ESTIMATOR, "cuda",
                                                          SEED)
    generator = torch.Generator(device="cuda").manual_seed(SEED)
    for _ in range(3):
        train_step(module, optimizer, loss_name, xb, yb, w, generator)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(FLEET_TIMED_STEPS):
        train_step(module, optimizer, loss_name, xb, yb, w, generator)
    torch.cuda.synchronize()
    solo_ms = (time.perf_counter() - t0) * 1e3 / FLEET_TIMED_STEPS
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fleet_fit(3)
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows, total_us = kernel_rows(prof)
    if not rows:
        raise AssertionError("fleet steps: the profiler recorded no CUDA kernel")
    timing = {
        "machines": len(Xs), "batch": BATCH_SIZE, "fleet_step_ms": fleet_ms,
        "solo_step_ms": solo_ms, "fleet_ms_per_machine_step": fleet_ms / len(Xs),
        "profiled_steps": 3, "launches_per_step": sum(r["count"] for r in rows) / 3,
        "profiled_wall_ms": wall_ms, "device_ms": total_us / 1e3,
        "device_idle_share": 1.0 - total_us / 1e3 / wall_ms,
    }
    log("fleet step timing", json.dumps(timing))
    return timing


def fleet_build_phase(torch, fa, profile: bool):
    """Phase 10: ``fleet_machines`` built by ``build-fleet`` in a
    subprocess on the card (the CLI's ``main``, with the process's flash
    launches written out at its end): all eight machines in one process,
    three buckets, each bucket's CV folds and final fit fleet fits; the
    build report clean. Then one Transformer machine served on
    ``/anomaly/prediction`` and one feedforward machine on ``/prediction``
    (144 rows, medians of ``REPEATS``) from the output, each reply within
    1e-4 of the same artifact served on the CPU; the vmapped flash check;
    ``FLEET_PARITY_STEPS`` fleet steps card against CPU; fleet and solo
    step times, launches a step and idle share."""
    import numpy as np

    from gordo_tpu_torch import serializer
    from gordo_tpu_torch.data import _get_dataset

    root = os.path.dirname(os.path.abspath(__file__))
    machines = fleet_machines(root)
    report = {"machines": [m["name"] for m in machines]}
    with tempfile.TemporaryDirectory() as tmp:
        collection = os.path.join(tmp, FLEET_COLLECTION)
        listing, counts = os.path.join(tmp, "machines.yaml"), os.path.join(tmp, "launches.json")
        with open(listing, "w") as fh:
            fh.write(yaml_text(machines) + "\n")
        t0 = time.perf_counter()
        # OUTPUT_DIR by the environment: with --machines-from, a lone
        # positional binds to the MACHINES slot, as in the JAX command
        built = subprocess.run(
            [sys.executable, "-c", FLEET_DRIVER, counts, "build-fleet", "--machines-from",
             listing, "--print-cv-scores"],
            cwd=root, env=dict(os.environ, OUTPUT_DIR=collection), capture_output=True,
            text=True, timeout=900,
        )
        report["build_s"] = time.perf_counter() - t0
        log("fleet build seconds", report["build_s"])
        if built.returncode != 0 or "FAILED" in built.stdout or "QUARANTINED" in built.stdout:
            raise AssertionError(
                f"build-fleet exited {built.returncode}:\n{built.stdout[-2000:]}\n"
                f"{built.stderr[-4000:]}"
            )
        with open(counts) as fh:
            report["kernel_launches"] = json.load(fh)
        with open(os.path.join(collection, "build_report.json")) as fh:
            build_report = json.load(fh)
        with open(os.path.join(collection, "telemetry_report.json")) as fh:
            telemetry = json.load(fh)
        if (build_report["n_built"], build_report["n_failed"]) != (len(machines), 0):
            raise AssertionError(f"build-fleet report: {build_report}")
        report["buckets"] = [
            {key: bucket[key] for key in ("machines", "n_timesteps_grid", "epochs",
                                          "cv_duration_s", "fit_duration_s", "bucket_wall_s")}
            | {"steps_per_epoch": bucket["fit"]["steps_per_epoch"]}
            for bucket in telemetry["buckets"]
        ]
        for bucket in report["buckets"]:
            log("fleet bucket", json.dumps(bucket))
        if len(report["buckets"]) != 3:
            raise AssertionError(f"expected 3 buckets: {report['buckets']}")
        flash = {name: count for name, count in report["kernel_launches"].items() if count}
        log("fleet build flash launches", json.dumps(flash))
        if not all(report["kernel_launches"][f"{kernel}_quad"] > 0
                   for kernel in (fa.KERNEL, fa.KERNEL_DQ, fa.KERNEL_DKV)):
            raise AssertionError(f"build-fleet launched no flash kernel: {flash}")

        served = {}
        for name, routes in ((f"{MACHINE}-0", ("anomaly/prediction",)),
                             ("example-pump-0", ("prediction",))):
            metadata = serializer.load_metadata(os.path.join(collection, name))
            model_meta = metadata["metadata"]["build_metadata"]["model"]["model_meta"]
            if name.startswith(MACHINE):
                thresholds = [model_meta["aggregate-threshold"], *model_meta["feature-thresholds"]]
                if not (model_meta.get("cv-fleet-masks") is True
                        and all(math.isfinite(x) and x > 0 for x in thresholds)):
                    raise AssertionError(f"{name}: thresholds {model_meta}")
            X, _, stamps = _get_dataset(metadata["dataset"]).get_data()
            if name.startswith(MACHINE) and len(X) not in FLEET_ROWS:
                raise AssertionError(f"{name}: {len(X)} rows, expected {FLEET_ROWS}")
            served[name] = serve_built(torch, collection, metadata, X, stamps, routes, 1e-4,
                                       history_repeats=0)
        report["served"] = served
        Xs = [np.asarray(_get_dataset(m["dataset"]).get_data()[0], dtype=np.float32)
              for m in machines[:FLEET_TRANSFORMERS]]
    report["vmapped_flash"] = fleet_flash_check(torch, fa)
    report["step_parity"] = fleet_step_check(torch, fa, Xs)
    report["step_timing"] = time_fleet_steps(torch, Xs)
    return report


def stacked_forward_check(torch, X):
    """One forward of the ``stacked`` schedule (LSTM and GRU cells, the
    LSTM machine's widths: 50 tags, 128/64/64/128, lookback 64) over the
    first ``PLANT_BATCH`` windows of X on the card, against the same
    forward on the CPU from the same seeded weights: within 1e-4."""
    import numpy as np

    from gordo_tpu_torch.models.specs import LSTMNet, flax_default_init_

    lookback = 64
    rows = torch.from_numpy(np.asarray(X[: lookback - 1 + PLANT_BATCH], dtype=np.float32))
    xb = rows.unfold(0, lookback, 1).transpose(1, 2).contiguous()  # (batch, lookback, tags)
    result = {}
    for cell in ("lstm", "gru"):
        net = LSTMNet(X.shape[1], (128, 64, 64, 128), ("tanh",) * 4, X.shape[1], fused=True,
                      cell=cell, schedule="stacked")
        flax_default_init_(net, torch.Generator().manual_seed(SEED))
        with torch.no_grad():
            cpu = net(xb)[0]
            net.to("cuda")
            net(xb.cuda())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            card = net(xb.cuda())[0]
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        err = (card.cpu() - cpu).abs().max().item()
        result[cell] = {"shape": list(xb.shape), "max_abs_err_card_vs_cpu": err, "card_ms": ms}
        log("stacked forward", cell, json.dumps(result[cell]))
        if not (torch.isfinite(card).all() and err <= 1e-4):
            raise AssertionError(f"stacked {cell} forward: card and CPU differ by {err}")
    return result


def wide_row(check):
    """A head_dim 64/128/256 check row as the ``kernels`` line reports it."""
    keys = ("case", "shape", "dtype", "ms", "ms_timer", "bound_ms", "bound_by", "plain_ms",
            "plain_ms_timer", "library_ms", "library_ms_timer")
    return {key: check[key] for key in keys}


def kernel_entry(kernel, source, replaces, check, launches_by_path, wide_checks):
    """One kernel's object of the ``kernels`` line; ``wide`` holds its
    rows at the other cases it reports."""
    return {
        "name": kernel,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": sum(launches_by_path.values()),
        "launches_by_path": launches_by_path,
        "max_abs_err": check["max_abs_err"],
        "ms": check["ms"],
        "ms_timer": check["ms_timer"],
        "call_ms": check["call_ms"],
        "plain_ms": check["plain_ms"],
        "plain_ms_timer": check["plain_ms_timer"],
        "bound_ms": check["bound_ms"],
        "bound_by": check["bound_by"],
        "library_ms": check["library_ms"],
        "library_ms_timer": check["library_ms_timer"],
        "shape": check["shape"],
        "wide": [wide_row(row) for row in wide_checks],
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Smoke run of gordo_tpu_torch on one card")
    parser.add_argument("--out", default=None, help="also write the numbers to this JSON file")
    parser.add_argument("--profile", action="store_true",
                        help="add torch.profiler breakdowns of one 8192-window predict "
                             "and of 20 training steps")
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
    for name, (text, seconds) in compiler_output.items():
        log(f"nvcc {name} ({seconds:.1f} s):\n{text.strip()}")
    log("build seconds", build_s)

    phase_s = {"build": build_s}

    def timed(name, phase, *phase_args):
        t0 = time.perf_counter()
        result = phase(torch, fa, *phase_args)
        phase_s[name] = time.perf_counter() - t0
        log("phase", name, "seconds", phase_s[name])
        return result

    checks = timed("forward_kernels", kernel_phase)
    backward_checks = timed("backward_kernels", backward_phase)
    gradients = timed("gradients", gradient_phase)
    serve_launches, report = timed("serve", end_to_end_phase, args.profile)
    if serve_launches <= 0:
        raise AssertionError("the served path never launched flash_attention_fwd")
    train = timed("train", train_phase, args.profile)
    default_pipeline = timed("default_pipeline", default_pipeline_phase, args.profile)
    models = timed("models", model_phase)
    recurrent = timed("recurrent", recurrent_phase, args.profile)
    project = timed("project_build", project_build_phase, args.profile)
    fleet = timed("fleet_build", fleet_build_phase, args.profile)

    def check(kernel, case, rows):
        return next(r for r in rows if r.get("kernel", fa.KERNEL) == kernel and r["case"] == case)

    # each path's launches by CUDA kernel, counted from 0 just before it
    paths = {"serve": report["kernel_launches"], "train": train["kernel_launches"],
             "serve_trained": train["served"]["kernel_launches"],
             "default_pipeline": default_pipeline["kernel_launches"],
             "recurrent": recurrent["kernel_launches"],
             "project_build": project["kernel_launches"],
             "fleet_build": fleet["kernel_launches"],
             **{label: models[label]["launches"] for label in models}}

    def entry(kernel, families, source, replaces, cases, rows):
        """The ``kernels`` entry of ``kernel``'s CUDA kernels of
        ``families``: launches on each path, the first case's numbers and
        the other cases as its ``wide`` rows."""
        names = [f"{kernel}_{family}" for family in families]
        by_path = {path: sum(counts.get(name, 0) for name in names)
                   for path, counts in paths.items()}
        rows_of = [check(kernel, case, rows) for case in cases]
        name = kernel if len(families) > 1 else names[0]
        return kernel_entry(name, source, replaces, rows_of[0], by_path, rows_of[1:])

    fwd_source = "gordo_tpu_torch/csrc/flash_attention_fwd.cu"
    bwd_source = "gordo_tpu_torch/csrc/flash_attention_bwd.cu"
    fwd_tpu, dq_tpu, dkv_tpu = ("gordo_tpu/ops/flash_attention.py:72",
                                "gordo_tpu/ops/flash_attention.py:176",
                                "gordo_tpu/ops/flash_attention.py:213")
    earlier = ("quad", "wide")  # the kernels of PRs 1-7, reported under the entry's name
    kernels = {
        "kernels": [
            entry(fa.KERNEL, earlier, fwd_source, fwd_tpu, ("model-shape", *WIDE_ROWS), checks),
            entry(fa.KERNEL_DQ, earlier, bwd_source, dq_tpu, ("train-step", *WIDE_ROWS),
                  backward_checks),
            entry(fa.KERNEL_DKV, earlier, bwd_source, dkv_tpu, ("train-step", *WIDE_ROWS),
                  backward_checks),
            entry(fa.KERNEL, ("mma",), fwd_source, fwd_tpu, MMA_ROWS, checks),
            entry(fa.KERNEL_DQ, ("mma",), bwd_source, dq_tpu, MMA_ROWS, backward_checks),
            entry(fa.KERNEL_DKV, ("mma",), bwd_source, dkv_tpu, MMA_ROWS, backward_checks),
            entry(fa.KERNEL, ("sliced",), fwd_source, fwd_tpu, SLICED_ROWS, checks),
            entry(fa.KERNEL_DQ, ("tiled",), bwd_source, dq_tpu, TILED_ROWS, backward_checks),
            entry(fa.KERNEL_DKV, ("tiled",), bwd_source, dkv_tpu, TILED_ROWS, backward_checks),
            entry(fa.KERNEL_DQ, ("tiled_mma",), bwd_source, dq_tpu, TILED_MMA_ROWS,
                  backward_checks),
            entry(fa.KERNEL_DKV, ("tiled_mma",), bwd_source, dkv_tpu, TILED_MMA_ROWS,
                  backward_checks),
        ]
    }
    for item in kernels["kernels"]:
        if item["launches"] <= 0:
            raise AssertionError(f"{item['name']} was launched on no path: {item}")
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(
                {"card": card, "build_s": build_s, "phase_s": phase_s, "checks": checks,
                 "nvcc_s": {name: seconds for name, (_, seconds) in compiler_output.items()},
                 "backward_checks": backward_checks, "gradients": gradients,
                 "end_to_end": report, "train": train,
                 "default_pipeline": default_pipeline, "models": models,
                 "recurrent": recurrent, "project_build": project, "fleet_build": fleet,
                 **kernels},
                fh,
                indent=1,
                default=str,
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
