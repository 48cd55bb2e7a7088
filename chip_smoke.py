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
   fit), 2 epochs where the config has 10 (the build's eager steps are
   host-bound: on a slow host 10 epochs took 265 s, over the phase's
   3-minute budget, and 5 took 108 s of a 639 s script); launch counts reset just before and read just after
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
   bench.py trains 3), served over HTTP on the card with 144 rows
   (medians of 5) and the LSTM once with its whole history (the other
   whole-history requests were cut to keep the script within 600 s),
   each reply within 1e-4 of the CPU's;
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
   (medians of 5) and the whole history (once), each reply within 1e-4 (TCN) or
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
11. fleet serving: phase 10's collection served on the card by the
   fleet routes: ``/anomaly/prediction/fleet`` for the four Transformers
   (one group, one stacked forward: one flash forward launch a layer for
   all four, against one a layer a machine for four solo requests, and no
   backward launch) at 144 and 8255 rows, each machine's reply within
   rtol 1e-4 / atol 1e-5 of its own ``/anomaly/prediction`` value by
   value (the anomaly columns at that bound carried through the
   detector's scaling and thresholds) and the reply within 1e-4 of the
   CPU's; ``/prediction/fleet`` with all eight machines (two groups,
   each scattered into its resident stack), a 3-of-4 subset (scattered)
   and a 1-of-4 subset (a gathered copy), each within 1e-4 of the
   CPU's; the path's launch counts take the fleet requests only; ``SERVE_CLIENTS`` concurrent clients coalesced by a batcher
   (``BATCH_WAIT_MS``), each reply within 1e-6 of the unbatched one;
   then ``build-fleet --precision auto`` of ``BF16_MACHINES`` (4032 rows,
   1 epoch; the second computing in bfloat16) in a subprocess, each
   served group taking the report's decision, replies within 2e-2 of the
   CPU's, each group's flash forward counted by kernel and input type,
   and the folded bf16 forward at the served shape against its plain
   version; fleet and solo request times, one dispatch's device time,
   a request's launches and idle share, requests a second batched and
   not, bf16 against float32 request times;
12. build options: seeded CSV files for ``turbine-9900-transformer``'s
   three tags (5-minute samples over the config's span, with planted
   spikes) in the file-system provider's layout; the machine (full width,
   flash, 1 epoch where the config has 10) read from a YAML project
   through the port's config layer with a ``row_filter`` and its buffer,
   a median ``filter_periods``, ``aggregation_methods: max``, ``cv:
   KFold(3, shuffle)``, a ``StandardScaler`` scoring scaler, six metrics
   (the new ones among them) and ``scaler: StandardScaler`` on the
   detector, built by ``python -m gordo_tpu_torch.cli build
   --model-register-dir`` in a subprocess on the card, then built again:
   a cache hit, no flash launch, the artifact untouched; a feedforward
   machine with ``aggregation_methods: [mean, max]`` whose model string
   is filled by ``--model-parameter``; the Transformer served on the card
   with 144 rows, within 1e-4 of the CPU; pipelined transfers read only
   after their copies (``parallel/transfer.py``), and four full-width
   Transformers stepped by ``FleetTrainer`` at ``prefetch_depth`` 0 and 2,
   bitwise equal, with the transfer counts and step ms; the served
   Transformer (float32, dropout 0.1) and phase 7's bf16 long-context
   net each stepped with ``remat`` off and on: the flash forward twice a
   layer under remat, gradients within 1e-6 (float32) and 2^-7 (bf16) of
   the plain step's, peak device memory and step ms;
13. lake and streaming: (a) ``turbine-9900-transformer`` (full width,
   flash, 1 epoch where the config has 10) read from ``LAKE_PROJECT``
   through the port's config layer and built by ``build`` in a
   subprocess on the card from a seeded lake (two tags as long-format
   CSV day partitions with restated samples and a stray partition, the
   third in a file-system CSV directory, behind a ``CompoundProvider``),
   with ``filter_method: all`` (the median and isolation-forest period
   filters) and a ``SqliteReporter``: rows each provider read, held to
   the written samples, rows kept, drop periods by method, the forest's
   fit and score seconds, the build's flash launches and the sqlite row
   against the machine's JSON; (b) phase 10's four Transformers streamed
   over phase 11's 8255 whole-history rows by one session of the
   ``stream/`` routes (a warming update, then 144-row updates): each
   update's latency, rows copied to the card (the transfer counter: its
   own rows only) and flash launches (one forward a layer when scored,
   none when warming), the device idle share over a few updates
   (torch.profiler), the streamed outputs against one
   ``/prediction/fleet`` over the same rows within ``STREAM_RTOL``, the
   resume contract (a closed session answers 409; reopened with its
   window tail, it continues as the unbroken stream) and a ``latest``
   symlink re-pointed mid-stream (the next update answers 409
   ``revision_rolled``);
14. plane: (a) ``sweep`` of four learning rates (``PLANE_LRS``) on
   phase 10's first Transformer (full width, flash, its 21 744 rows, 1
   epoch where the config has 10) in this process: each trial's loss,
   the three kernels' launches and step ms, and a one-machine fit at the
   first rate on the card within 1e-4 of its trial; (c) two ``run-server``
   replicas over one shard manifest and a ``run-router``, each a
   subprocess (the replicas on the card), over phase 10's collection:
   phase 11's 144- and 8255-row anomaly fleet requests of the four
   Transformers through the router, bitwise equal to one unsharded
   server's (phase 11's, in this process); each replica's launches
   (counted in the replica) and fleet scorers within its shard; a
   request sent straight to the wrong replica answers 421 naming the
   owner; a stream (40 warming rows, one 144-row update) through the
   router bitwise equal to the direct one; one replica killed: its
   shard answers a transient 409 until ejected, then failover answers
   every machine, bitwise again; latencies through the router and
   direct, and the failover's seconds; (b) ``FleetTrainer`` on the four
   Transformers (full width, dropout 0.1, each cut to its first 4096
   rows: the phase's time budget) fitted 2 epochs unbroken and 1 epoch
   with a checkpointer then resumed to 2 (where the config has 10):
   bitwise equal, a torn newest checkpoint restoring the one before;
   then ``build-fleet --resume`` over phase 10's directory in a
   subprocess (all eight machines reused, no launch) and again with one
   Transformer's artifact removed (only it rebuilt, 1 epoch as in phase
   10; the other artifacts untouched), seconds and launches of each run;
15. one JSON line of per-kernel numbers, each time with the timer that
   took it (``"profiler"``: device time; ``"events"``: CUDA events around
   the calls, host gaps included, taken when three traces came back
   incomplete): the quad and wide kernels under each entry point's name,
   and the tensor-core, sliced and tiled kernels each under its own,
   with its launches on every path above; then the result line.

Phase 3 also times the quad forward at the folded shapes of phase 11's
fleet requests (four machines' windows in one batch).

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
# slow host 10 epochs took 265 s of build, over the phase's 3-minute
# budget, and 5 took 108 s of a 639 s script once phase 11 came in
TRAIN_EPOCHS = 2
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
# timed whole-history requests of the phase-8 machines, cut from REPEATS
# each to 3, then to one request of the LSTM when phase 11 took the script
# past 600 s: each takes 5.5-8.7 s of host JSON on an H100's host and its
# CPU comparison 10-13 s, and the two machines' 3 with their CPU
# comparisons took about 63 s of a 637 s run
RECURRENT_HISTORY_REPEATS = {"lstm-plant-50": 1}
# timed whole-history requests of phase 9's machines, cut from REPEATS for
# the same reason (the TCN's take 7.5-8.6 s each)
PROJECT_HISTORY_REPEATS = 1
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
    "    json.dump({'kernels': fa.kernel_launches, 'typed': fa.typed_launches}, fh)\n"
    "sys.exit(code)\n"
)

# Phase 11 serves phase 10's collection: the four Transformers at 144 rows
# each and at the whole-history size of phase 4 (8255 rows), all eight
# machines, a 3-of-4 and a 1-of-4 subset, SERVE_CLIENTS concurrent clients
# batched (BATCH_WAIT_MS) and not; then `build-fleet --precision auto` of
# BF16_MACHINES over BF16_DAYS days at 10 minutes (a random provider of
# 4032 samples a tag, which the data layer makes 4030 and 4032 rows: a
# tag's empty first buckets drop out; cut from the config's 151 days; 1
# epoch where the config has 10, as phase 10 cuts): the config's model
# (float32 layers) and the same model computing in bfloat16 (`dtype:
# bfloat16`), one bucket each, served from the card
SERVE_ROWS = (144, 8255)
SERVE_CLIENTS = 8
SERVE_ROUNDS = 3
# timed 8255-row fleet requests (each with four whole-history frames of JSON)
WHOLE_HISTORY_REPEATS = 2
BATCH_WAIT_MS = 5.0
BF16_COLLECTION = "1700000000006"
BF16_DAYS = 28
BF16_ROWS = (4024, 4033)  # the least and most rows a machine may have
BF16_MACHINES = (f"{MACHINE}-bf16-0", f"{MACHINE}-bf16-1")
# the quad forward at phase 11's folded fleet-serve shapes: four machines'
# windows in one batch, 144 rows padded to 256 (193 windows each) and 8255
# rows padded to 16 384 (16 321 windows each)
FLEET_SERVE_CASES = (("fleet-serve-144", (4 * 193, 64, 4, 16)),
                     ("fleet-serve-8255", (4 * 16321, 64, 4, 16)))

# Phase 12: the build options of a machine config. The Transformer
# machine reads OPTIONS_SAMPLES_A_DAY samples a day of seeded daily
# sinusoids plus noise a tag over the config's span (2019-01-01 to
# 2019-06-01), written as CSV files in the file-system provider's layout
# (<lake>/gra/<tag>/<tag>_2019.csv), with a spike planted every
# OPTIONS_SPIKE_EVERY samples for the period filter to find, and builds 1
# epoch where the config has 10 (each build of phase 12 cross-validates
# with three folds trained one after another, KFold's training rows not
# being one run); widths and span are the config's.
OPTIONS_COLLECTION = "1700000000007"
OPTIONS_SAMPLES_A_DAY = 288
OPTIONS_SPIKE_EVERY = 4001
OPTIONS_EPOCHS = 1
OPTIONS_METRICS = ["explained_variance_score", "r2_score", "median_absolute_error", "max_error",
                   "mean_absolute_percentage_error", "root_mean_squared_error"]
OPTIONS_PROJECT = """
machines:
  - name: {name}
    dataset:
      type: TimeSeriesDataset
      data_provider: {{type: FileSystemProvider, base_dir: "{lake}"}}
      tags: [{tags}]
      train_start_date: '2019-01-01T00:00:00+00:00'
      train_end_date: '2019-06-01T00:00:00+00:00'
      asset: gra
      aggregation_methods: max
      row_filter: "`GRA-TURB-SPEED 1` > -2.0 & `GRA-TURB-LOAD 3` < 0.45"
      row_filter_buffer_size: 2
      filter_periods: {{filter_method: median, window: 144, n_iqr: 5}}
    model:
      gordo_tpu.models.anomaly.DiffBasedAnomalyDetector:
        scaler: sklearn.preprocessing.StandardScaler
        base_estimator:
          gordo_tpu.models.TransformerAutoEncoder:
            kind: transformer_model
            lookback_window: 64
            d_model: 64
            n_heads: 4
            n_layers: 2
            epochs: {epochs}
            attention_impl: flash
    evaluation:
      cv: {{sklearn.model_selection.KFold: {{n_splits: 3, shuffle: true, random_state: 0}}}}
      scoring_scaler: sklearn.preprocessing.StandardScaler
      metrics: [{metrics}]
"""
# the feedforward machine: the same files, two aggregations a tag, and a
# model template filled by --model-parameter
OPTIONS_TEMPLATE = "gordo_tpu.models.AutoEncoder: {kind: '{{ kind }}', epochs: {{ epochs }}}"
OPTIONS_PARAMETERS = ("kind,feedforward_hourglass", "epochs,1")
# FleetTrainer at prefetch depth 0 and 2: four full-width Transformers on
# ragged rows (the shorter machines' last steps gated), 3 epochs read one
# at a time (a patience none runs out of), so every chunk after the first
# stages its vector under the chunk before
PREFETCH_STEPS = (20, 20, 19, 18)
PREFETCH_EPOCHS = 3
# remat against plain: float32 gradients within 1e-6 of their largest
# magnitude (the recompute is the same arithmetic), bf16 within 2^-7
REMAT_TOLERANCE = {"float32": 1e-6, "bfloat16": 2.0 ** -7}
REMAT_TIMED_STEPS = 5
# Phase 13a builds turbine-9900-transformer (full width, flash, 1 epoch
# where the config has 10, as phase 12 cuts) from a lake: a long-format
# CSV lake of day partitions holding two of its three tags (5-minute
# samples over the config's span, phase 12's spikes), with LAKE_DUPLICATES
# samples restated: the day's first file holds them off by LAKE_OFFSET and
# a later file of the same day the true value (the last row wins), and a
# partition dated LAKE_STRAY_DAY (outside the window and its day of slop)
# holding in-window rows off by LAKE_OFFSET that must not be read; the
# third tag in a file-system CSV directory, listed first in a
# CompoundProvider (the long-format provider claims every tag of a
# directory that holds data); both period filters (`filter_method: all`)
# and a SqliteReporter
LAKE_COLLECTION = "1700000000008"
LAKE_DUPLICATES = 500
LAKE_OFFSET = 500.0
LAKE_STRAY_DAY = datetime(2019, 6, 10, tzinfo=timezone.utc)
LAKE_PROJECT = """
machines:
  - name: {name}
    dataset:
      type: TimeSeriesDataset
      data_provider:
        type: CompoundProvider
        providers:
          - type: FileSystemProvider
            base_dir: "{fs}"
          - type: LongFormatProvider
            base_dir: "{long}"
      tags: [{tags}]
      train_start_date: '2019-01-01T00:00:00+00:00'
      train_end_date: '2019-06-01T00:00:00+00:00'
      asset: gra
      filter_periods:
        filter_method: all
    model:
      gordo_tpu.models.anomaly.DiffBasedAnomalyDetector:
        base_estimator:
          gordo_tpu.models.TransformerAutoEncoder:
            kind: transformer_model
            lookback_window: 64
            d_model: 64
            n_heads: 4
            n_layers: 2
            epochs: {epochs}
            attention_impl: flash
    runtime:
      reporters:
        - gordo_tpu.reporters.postgres.SqliteReporter:
            path: "{db}"
"""
# Phase 13b streams phase 10's four Transformers over phase 11's 8255
# whole-history rows: a warming update of STREAM_FIRST rows (fewer than a
# window), then updates of STREAM_UPDATE rows (the last one shorter);
# STREAM_PROFILED updates from STREAM_PROFILE_AT run under torch.profiler
# (and are left out of the latency figures); the resume check cuts a
# second session after STREAM_RESUME_AT updates and continues it for
# STREAM_RESUME_MORE; streamed outputs within STREAM_RTOL (relative to the
# largest output) of one /prediction/fleet over the same rows
STREAM_FIRST = 40
STREAM_UPDATE = 144
STREAM_PROFILE_AT = 10
STREAM_PROFILED = 5
STREAM_RESUME_AT = 11
STREAM_RESUME_MORE = 5
STREAM_RTOL = 1e-5


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
        *((name, shape, True, torch.float32) for name, shape in FLEET_SERVE_CASES),
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
def http_server(collection: str, machine: str = MACHINE, app=None):
    """The port's server over ``collection`` on the card (or ``app``), on a
    free local port, for the ``with`` block; yields ``machine``'s base URL
    (with ``machine=None`` the project's)."""
    from gordo_tpu_torch.server.app import build_app
    from gordo_tpu_torch.server.runner import make_http_server

    app = app or build_app(collection)  # the card: no device argument
    server = make_http_server(app, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{server.server_port}/gordo/v0/{PROJECT}"
        yield base if machine is None else f"{base}/{machine}"
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        app.catalog.stop()


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
                                          RECURRENT_HISTORY_REPEATS.get(name, 0))
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
                                                   bound, PROJECT_HISTORY_REPEATS)
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


def fleet_build_phase(torch, fa, profile: bool, workdir: Optional[str] = None):
    """Phase 10: ``fleet_machines`` built by ``build-fleet`` in a
    subprocess on the card (the CLI's ``main``, with the process's flash
    launches written out at its end): all eight machines in one process,
    three buckets, each bucket's CV folds and final fit fleet fits; the
    build report clean. Then one Transformer machine served on
    ``/anomaly/prediction`` and one feedforward machine on ``/prediction``
    (144 rows, medians of ``REPEATS``) from the output, each reply within
    1e-4 of the same artifact served on the CPU; the vmapped flash check;
    ``FLEET_PARITY_STEPS`` fleet steps card against CPU; fleet and solo
    step times, launches a step and idle share. With ``workdir`` the
    collection is built there and kept (``report["collection"]``: phase 11
    serves it); else in a temporary directory."""
    import numpy as np

    from gordo_tpu_torch import serializer
    from gordo_tpu_torch.data import _get_dataset

    root = os.path.dirname(os.path.abspath(__file__))
    machines = fleet_machines(root)
    report = {"machines": [m["name"] for m in machines]}
    with contextlib.ExitStack() as stack:
        tmp = workdir or stack.enter_context(tempfile.TemporaryDirectory())
        collection = os.path.join(tmp, FLEET_COLLECTION)
        if workdir:
            report["collection"] = collection
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
            launched = json.load(fh)
        report["kernel_launches"], report["typed_launches"] = launched["kernels"], launched["typed"]
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


def frame_of(X, keys, tags, rows: slice) -> dict:
    """``{tag: {stamp: value}}`` of rows ``rows`` of X."""
    return {tag: dict(zip(keys[rows], X[rows, j].tolist())) for j, tag in enumerate(tags)}


def block_rel_diff(got: dict, want: dict, rtol: float, atol: float) -> float:
    """Largest |got - want| / (atol + rtol |want|) over two replies' numeric
    blocks, at most 1 when every value is within the tolerance. Where it
    is above 1, the worst value is logged."""
    import numpy as np

    if set(got) != set(want):
        raise AssertionError(f"reply blocks differ: {sorted(set(got) ^ set(want))}")
    worst, where = 0.0, None
    for top, block in want.items():
        if top in ("start", "end"):
            continue
        for label, column in block.items():
            a = np.asarray(list(got[top][label].values()), dtype=np.float64)
            b = np.asarray(list(column.values()), dtype=np.float64)
            if list(got[top][label]) != list(column) or not np.isfinite(a).all():
                raise AssertionError(f"{top}/{label}: rows or values differ")
            ratio = np.abs(a - b) / (atol + rtol * np.abs(b))
            i = int(ratio.argmax())
            if ratio[i] > worst:
                worst, where = float(ratio[i]), (top, label, i, float(a[i]), float(b[i]))
    if worst > 1.0:
        log("worst value", json.dumps(where), "ratio", worst)
    return worst


def anomaly_bound_ratios(got: dict, want: dict, detector, rtol: float, atol: float) -> dict:
    """Largest |got - want| / bound, block by block, of two anomaly replies
    of ``detector`` (the ``want`` reply's model output taken as the true
    one), value by value. ``model-output`` is held at e = atol + rtol
    |output|, and each anomaly column at e carried through the detector's
    arithmetic: |output - y| keeps it, scaling divides it by the tag's
    scale, a total (the mean square over tags) takes the mean of 2 |a| e +
    e^2, and a confidence divides by its threshold; so a wrong scale or
    threshold on one side shows as a ratio far above 1."""
    import numpy as np

    def arrays(reply):
        return {top: np.asarray([list(column.values()) for column in block.values()],
                                dtype=np.float64).T
                for top, block in reply.items() if top not in ("start", "end")}

    if set(got) != set(want):
        raise AssertionError(f"reply blocks differ: {sorted(set(got) ^ set(want))}")
    for top, block in want.items():
        for label, column in block.items():
            if top not in ("start", "end") and list(got[top][label]) != list(column):
                raise AssertionError(f"{top}/{label}: rows differ")
    if detector.window is not None:
        raise AssertionError("no bound is derived here for a smoothed detector")
    a, b = arrays(got), arrays(want)
    e = atol + rtol * np.abs(b["model-output"])
    e_scaled = e / np.asarray(detector.scaler.scale_, dtype=np.float64)

    def total(flavor, err):
        return (2 * b[f"tag-anomaly-{flavor}"] * err + err ** 2).mean(axis=1, keepdims=True)

    bounds = {
        "model-input": np.full_like(e, atol),
        "model-output": e,
        "tag-anomaly-unscaled": e,
        "tag-anomaly-scaled": e_scaled,
        "total-anomaly-unscaled": total("unscaled", e),
        "total-anomaly-scaled": total("scaled", e_scaled),
    }
    if detector.feature_thresholds_ is not None:
        bounds["anomaly-confidence"] = e_scaled / np.asarray(detector.feature_thresholds_)
    if detector.aggregate_threshold_ is not None:
        bounds["total-anomaly-confidence"] = (bounds["total-anomaly-scaled"]
                                              / detector.aggregate_threshold_)
    if set(b) != set(bounds):
        raise AssertionError(f"blocks with no derived bound: {sorted(set(b) ^ set(bounds))}")
    if not all(np.isfinite(x).all() for x in a.values()):
        raise AssertionError("a reply holds values that are not finite")
    return {top: float((np.abs(a[top] - b[top]) / bounds[top]).max()) for top in b}


def post_all(url: str, payloads: list) -> list:
    """Each payload POSTed to ``url`` from its own thread, all released at
    once: [(reply, seconds)] in payload order."""
    barrier = threading.Barrier(len(payloads))
    out = [None] * len(payloads)

    def run(i):
        barrier.wait()
        out[i] = post(url, payloads[i])

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(payloads))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if any(item is None for item in out):
        raise AssertionError(f"a concurrent POST to {url} failed")
    return out


def profile_window(torch, fn, reps: int = REPEATS, tries: int = 3):
    """(wall ms, device ms, CUDA kernels launched), each a call, of
    ``reps`` calls of ``fn`` under torch.profiler (CUDA activity of every
    thread of the process). A trace now and then comes back with no
    kernel; it is taken again, up to ``tries`` times, and then the device
    numbers are None: not measured."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    for _ in range(tries):
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / reps
        rows, total_us = kernel_rows(prof)
        if total_us > 0:
            return wall_ms, total_us / 1e3 / reps, sum(r["count"] for r in rows) / reps
    log(f"profile_window: {tries} traces with no kernel; device time not measured")
    return wall_ms, None, None


def bf16_machines(root: str) -> list:
    """Phase 11's bf16 build: the first two of ``fleet_machines`` renamed,
    over ``BF16_DAYS`` days; the second computing in bfloat16."""
    machines = []
    for i, machine in enumerate(fleet_machines(root)[:2]):
        dataset = dict(machine["dataset"])
        start = datetime.fromisoformat(str(dataset["train_start_date"]))
        samples = BF16_DAYS * 144
        dataset.update(train_end_date=(start + timedelta(days=BF16_DAYS)).isoformat(),
                       data_provider={"type": "RandomDataProvider", "min_size": samples,
                                      "max_size": samples})
        model = json.loads(json.dumps(machine["model"]))
        if i == 1:
            (detector,) = model.values()
            (base,) = detector["base_estimator"].values()
            base["dtype"] = "bfloat16"
        machines.append(dict(machine, name=BF16_MACHINES[i], dataset=dataset, model=model))
    return machines


def fleet_serve_phase(torch, fa, profile: bool, collection: str):
    """Phase 11: phase 10's collection served by the fleet routes on the
    card (``/anomaly/prediction/fleet`` for the four Transformers at each of
    ``SERVE_ROWS``, each machine's reply against its own
    ``/anomaly/prediction`` and the fleet reply against the CPU's; all
    eight machines in two groups, a 3-of-4 and a 1-of-4 subset on
    ``/prediction/fleet`` against the CPU), flash launches of a fleet
    request against four solo ones (no backward kernel), coalescing of
    ``SERVE_CLIENTS`` concurrent clients, and the bf16 build and serve;
    times on the host clock, one dispatch's device time and a request's
    launches and idle share by torch.profiler."""
    import numpy as np

    from gordo_tpu_torch import serializer
    from gordo_tpu_torch.data import _get_dataset
    from gordo_tpu_torch.data.base import to_datetimes
    from gordo_tpu_torch.server.app import GordoApp, build_app
    from gordo_tpu_torch.server.fleet_serving import fleet_scorer_from_models

    root = os.path.dirname(os.path.abspath(__file__))
    n_layers = BASE_ESTIMATOR["n_layers"]
    transformers = [f"{MACHINE}-{i}" for i in range(FLEET_TRANSFORMERS)]
    names = transformers + [m["name"] for m in fleet_machines(root)[FLEET_TRANSFORMERS:]]
    data = {}
    for name in names:
        metadata = serializer.load_metadata(os.path.join(collection, name))
        X, _, stamps = _get_dataset(metadata["dataset"]).get_data()
        keys = [stamp.isoformat() for stamp in to_datetimes(stamps.astype(np.int64))]
        data[name] = (np.asarray(X), keys, metadata["dataset"]["tag_list"])

    def machines_body(chosen, n_rows, anomaly, start=0):
        body = {}
        for name in chosen:
            X, keys, tags = data[name]
            frame = frame_of(X, keys, tags, slice(start, start + n_rows))
            body[name] = {"X": frame, "y": frame} if anomaly else frame
        return json.dumps({"machines": body}).encode()

    report = {"requests": []}
    cpu_app = GordoApp(collection, device="cpu", batch_wait_ms=0)

    def cpu_reply(route, payload):
        reply = cpu_app.dispatch("POST", f"/gordo/v0/{PROJECT}/{route}", lambda: payload)
        if reply.status != 200:
            raise AssertionError(f"{route} on the CPU answered {reply.status}")
        return reply.payload["data"]

    def against_cpu(label, route, payload, reply, chosen, tolerance=1e-4):
        cpu = cpu_reply(route, payload)
        diff = max(block_rel_diff(reply["data"][n], cpu[n], 0.0, tolerance) for n in chosen)
        log("fleet served", label, "card vs cpu (x 1e-4)", diff)
        if not diff <= 1.0:
            raise AssertionError(f"{label}: card and CPU differ by {diff} x {tolerance}")
        return diff * tolerance

    sections, t_section = {}, [time.perf_counter()]

    def section(name):
        now = time.perf_counter()
        sections[name] = now - t_section[0]
        t_section[0] = now

    app = build_app(collection, batch_wait_ms=0)
    with http_server(collection, None, app=app) as base:
        anomaly_url, predict_url = f"{base}/anomaly/prediction/fleet", f"{base}/prediction/fleet"
        payloads = {n_rows: machines_body(transformers, n_rows, True) for n_rows in SERVE_ROWS}
        post(anomaly_url, payloads[144])  # loads the models and builds the scorer
        ((scorer, _, _),) = app.catalog._fleet_scorers.values()
        report["groups_all_eight"] = scorer.n_groups
        if scorer.n_groups != 2:
            raise AssertionError(f"all eight machines in {scorer.n_groups} groups, expected 2")
        replies = {}
        fa.reset_launch_counts()
        # the main path, fleet requests only: counts from 0 just before,
        # read just after
        for n_rows in SERVE_ROWS:
            times = []
            for _ in range(REPEATS if n_rows == 144 else WHOLE_HISTORY_REPEATS):
                replies[n_rows], seconds = post(anomaly_url, payloads[n_rows])
                times.append(seconds)
            section(f"anomaly_{n_rows}_rows")
            row = {"route": "anomaly/prediction/fleet", "machines": len(transformers),
                   "rows": n_rows, "median_s": statistics.median(times), "seconds": times,
                   "card_vs_cpu": against_cpu(f"{n_rows} rows", "anomaly/prediction/fleet",
                                              payloads[n_rows], replies[n_rows], transformers)}
            report["requests"].append(row)
            section(f"anomaly_{n_rows}_rows_cpu")
        # every group in full, a subset that rounds up to the group (scattered
        # into the resident stack) and one machine (a gathered copy, the
        # machine axis floored at 2)
        for label, chosen, source in (("all eight", names, {"resident": 2}),
                                      ("3 of 4", transformers[:3], {"resident": 1}),
                                      ("1 of 4", transformers[2:3], {"gathered": 1})):
            payload = machines_body(chosen, 144, False)
            before = scorer.dispatch_counts()
            reply, seconds = post(predict_url, payload)
            after = scorer.dispatch_counts()
            dispatched = {k: after[k] - before[k] for k in after if after[k] != before[k]}
            if sorted(reply["data"]) != sorted(chosen):
                raise AssertionError(f"{label}: replies for {sorted(reply['data'])}")
            if dispatched != source:
                raise AssertionError(f"{label}: dispatches {dispatched}, expected {source}")
            row = {"route": "prediction/fleet", "label": label, "machines": len(chosen),
                   "rows": 144, "seconds": seconds, "dispatches": dispatched,
                   "card_vs_cpu": against_cpu(label, "prediction/fleet", payload, reply, chosen)}
            report["requests"].append(row)
            log("fleet request", json.dumps(row))
        report["kernel_launches"] = dict(fa.kernel_launches)
        report["typed_launches"] = dict(fa.typed_launches)
        section("predict_subsets")

        # each machine's fleet reply against its own /anomaly/prediction,
        # value by value (anomaly_bound_ratios), outside the counted window
        models = {n: serializer.load(os.path.join(collection, n)) for n in transformers}
        for row in report["requests"][:len(SERVE_ROWS)]:
            frames = json.loads(payloads[row["rows"]])["machines"]
            ratios = {}
            for name in transformers:
                solo, _ = post(f"{base}/{name}/anomaly/prediction",
                               json.dumps(frames[name]).encode())
                mine = anomaly_bound_ratios(replies[row["rows"]]["data"][name], solo["data"],
                                            models[name], 1e-4, 1e-5)
                ratios = {k: max(v, ratios.get(k, 0.0)) for k, v in mine.items()}
            row["vs_solo_ratio"] = ratios
            log("fleet request", json.dumps(row))
            if not max(ratios.values()) <= 1.0:
                raise AssertionError(f"fleet and solo replies differ ({ratios}, "
                                     f"{row['rows']} rows)")
            section(f"vs_solo_{row['rows']}_rows")

        # one fleet request against four solo ones: flash launches and times
        before = dict(fa.launch_counts)
        post(anomaly_url, payloads[144])
        fleet_launches = {k: fa.launch_counts[k] - before[k] for k in before}
        before = dict(fa.launch_counts)
        solo_payloads = [json.dumps(json.loads(payloads[144])["machines"][n]).encode()
                         for n in transformers]
        for name, payload in zip(transformers, solo_payloads):
            post(f"{base}/{name}/anomaly/prediction", payload)
        solo_launches = {k: fa.launch_counts[k] - before[k] for k in before}
        report["flash_launches"] = {"fleet_request": fleet_launches,
                                    "four_solo_requests": solo_launches}
        log("flash launches", json.dumps(report["flash_launches"]))
        if fleet_launches != {fa.KERNEL: n_layers, fa.KERNEL_DQ: 0, fa.KERNEL_DKV: 0} \
                or solo_launches[fa.KERNEL] != n_layers * len(transformers):
            raise AssertionError(f"flash launches: {report['flash_launches']}")
        fleet_s, solo_s = [], []
        for _ in range(REPEATS):
            fleet_s.append(post(anomaly_url, payloads[144])[1])
            solo_s.append(sum(post(f"{base}/{n}/anomaly/prediction", p)[1]
                              for n, p in zip(transformers, solo_payloads)))
        fleet_scorer, _, _ = fleet_scorer_from_models(models)
        inputs = {n: data[n][0][:144].astype(np.float32) for n in transformers}
        fleet_scorer.predict(inputs)
        dispatch = profile_window(torch, lambda: fleet_scorer.predict(inputs))
        request = profile_window(torch, lambda: post(anomaly_url, payloads[144]))
        report["timing"] = {
            "fleet_request_median_s": statistics.median(fleet_s), "fleet_request_s": fleet_s,
            "four_solo_requests_median_s": statistics.median(solo_s), "four_solo_s": solo_s,
            "dispatch_wall_ms": dispatch[0], "dispatch_device_ms": dispatch[1],
            "dispatch_launches": dispatch[2],
            "request_wall_ms": request[0], "request_device_ms": request[1],
            "request_launches": request[2],
            "request_device_idle_share": (None if request[1] is None
                                          else 1.0 - request[1] / request[0]),
            "whole_history_request_median_s": report["requests"][1]["median_s"],
        }
        log("fleet timing", json.dumps(report["timing"]))
        section("launches_and_timing")

        # coalescing: SERVE_CLIENTS concurrent clients, batched and not
        bodies = [machines_body(transformers, 144, True, start=144 * (i + 1))
                  for i in range(SERVE_CLIENTS)]
        unbatched = [post(anomaly_url, body)[0] for body in bodies]
        batched_app = build_app(collection, batch_wait_ms=BATCH_WAIT_MS)
        with http_server(collection, None, app=batched_app) as batched_base:
            batched_url = f"{batched_base}/anomaly/prediction/fleet"
            post(batched_url, bodies[0])
            (batcher,) = batched_app.catalog._batchers.values()
            stats0 = batcher.stats()
            replies = post_all(batched_url, bodies)
            stats1 = batcher.stats()
            dispatches = stats1["dispatches_total"] - stats0["dispatches_total"]
            worst = max(block_rel_diff(r["data"][n], u["data"][n], 0.0, 1e-6)
                        for (r, _), u in zip(replies, unbatched) for n in transformers)
            bitwise = all(r["data"] == u["data"] for (r, _), u in zip(replies, unbatched))
            rates = {}
            for label, url in (("unbatched", anomaly_url), ("batched", batched_url)):
                t0 = time.perf_counter()
                for _ in range(SERVE_ROUNDS):
                    post_all(url, bodies)
                rates[label] = SERVE_ROUNDS * SERVE_CLIENTS / (time.perf_counter() - t0)
            stats2 = batcher.stats()
        report["coalescing"] = {
            "clients": SERVE_CLIENTS, "batch_wait_ms": BATCH_WAIT_MS, "dispatches": dispatches,
            "max_abs_diff_vs_unbatched": worst * 1e-6, "bitwise_equal": bitwise,
            "requests_per_s": rates,
            "rounds_mean_batch_size": (stats2["requests_total"] - stats1["requests_total"])
            / max(1, stats2["dispatches_total"] - stats1["dispatches_total"]),
        }
        log("coalescing", json.dumps(report["coalescing"]))
        if not dispatches < SERVE_CLIENTS:
            raise AssertionError(f"{SERVE_CLIENTS} concurrent requests, {dispatches} dispatches")
        if not worst <= 1.0:
            raise AssertionError(f"batched replies differ from unbatched by {worst} x 1e-6")

        float32_times = [post(predict_url, machines_body(transformers[:1], 144, False))[1]
                         for _ in range(REPEATS)]
        section("coalescing")
    report["bf16"] = bf16_serve(torch, fa, root, os.path.dirname(collection), float32_times)
    section("bf16_build_and_serve")
    report["section_s"] = sections
    log("fleet serve sections", json.dumps(sections))
    return report


def bf16_serve(torch, fa, root: str, workdir: str, float32_times: list) -> dict:
    """Phase 11's bf16 part: ``bf16_machines`` built by ``build-fleet
    --precision auto`` in a subprocess on the card, each decision named by
    the report and taken by the served group; replies against the CPU's
    within bf16's tolerance; each group's flash forward counted by kernel
    and input type; the folded bf16 forward at the served shape against
    its plain version; each machine's request time against a float32
    Transformer's (``float32_times``)."""
    import numpy as np

    from gordo_tpu_torch import serializer
    from gordo_tpu_torch.data import _get_dataset
    from gordo_tpu_torch.data.base import to_datetimes
    from gordo_tpu_torch.server.app import GordoApp, build_app

    machines = bf16_machines(root)
    collection = os.path.join(workdir, BF16_COLLECTION)
    listing, counts = os.path.join(workdir, "bf16.yaml"), os.path.join(workdir, "bf16.json")
    with open(listing, "w") as fh:
        fh.write(yaml_text(machines) + "\n")
    t0 = time.perf_counter()
    built = subprocess.run(
        [sys.executable, "-c", FLEET_DRIVER, counts, "build-fleet", "--machines-from", listing,
         "--precision", "auto"],
        cwd=root, env=dict(os.environ, OUTPUT_DIR=collection), capture_output=True, text=True,
        timeout=600,
    )
    result = {"build_s": time.perf_counter() - t0}
    if built.returncode != 0 or "FAILED" in built.stdout or "QUARANTINED" in built.stdout:
        raise AssertionError(f"bf16 build-fleet exited {built.returncode}:\n"
                             f"{built.stdout[-2000:]}\n{built.stderr[-4000:]}")
    with open(counts) as fh:
        launched = json.load(fh)
    result["build_launches"], result["build_typed_launches"] = launched["kernels"], launched["typed"]
    with open(os.path.join(collection, "build_report.json")) as fh:
        block = json.load(fh)["precision"]
    result["report"] = block
    decisions = {name: block["machines"][name]["precision"] for name in BF16_MACHINES}
    log("bf16 build", json.dumps({k: result[k] for k in ("build_s", "report")}))
    if block["mode"] != "auto" or "bf16" not in decisions.values():
        raise AssertionError(f"bf16 build: no machine serves bf16: {block}")
    n_layers = BASE_ESTIMATOR["n_layers"]
    app, cpu_app = build_app(collection, batch_wait_ms=0), GordoApp(collection, device="cpu")
    times, typed, served = {}, {}, {}
    launches = dict.fromkeys(fa.kernel_launches, 0)
    with http_server(collection, None, app=app) as base:
        url = f"{base}/prediction/fleet"
        for name in BF16_MACHINES:
            metadata = serializer.load_metadata(os.path.join(collection, name))
            X, _, stamps = _get_dataset(metadata["dataset"]).get_data()
            if not BF16_ROWS[0] <= len(X) <= BF16_ROWS[1]:
                raise AssertionError(f"{name}: {len(X)} rows, expected {BF16_ROWS}")
            keys = [s.isoformat() for s in to_datetimes(stamps.astype(np.int64))]
            frame = frame_of(np.asarray(X), keys, metadata["dataset"]["tag_list"], slice(0, 144))
            payload = json.dumps({"machines": {name: frame}}).encode()
            post(url, payload)
            fa.reset_launch_counts()
            reply, _ = post(url, payload)
            typed[name] = dict(fa.typed_launches)
            for kernel, count in fa.kernel_launches.items():
                launches[kernel] += count
            cpu = cpu_app.dispatch("POST", f"/gordo/v0/{PROJECT}/prediction/fleet", lambda: payload)
            # within 2e-2 of the CPU's, relative above 1: the bfloat16 layers
            # round on each device after their own summation order
            served[name] = block_rel_diff(reply["data"][name], cpu.payload["data"][name],
                                          TOLERANCE["bfloat16"], TOLERANCE["bfloat16"])
            times[name] = [post(url, payload)[1] for _ in range(REPEATS)]
        precisions = {}
        for entry in app.catalog._fleet_scorers.values():
            precisions.update(entry[0].group_precisions())
    compute = {BF16_MACHINES[0]: "float32", BF16_MACHINES[1]: "bfloat16"}
    result.update({
        "decisions": decisions, "served_precisions": precisions, "typed_launches": typed,
        "kernel_launches": launches,
        "card_vs_cpu": served,
        "median_s": {name: statistics.median(t) for name, t in times.items()},
        "float32_transformer_median_s": statistics.median(float32_times),
    })
    log("bf16 serve", json.dumps({k: result[k] for k in (
        "decisions", "served_precisions", "typed_launches", "card_vs_cpu", "median_s",
        "float32_transformer_median_s")}))
    if precisions != decisions:
        raise AssertionError(f"served precisions {precisions} against the report's {decisions}")
    for name, launches in typed.items():
        want = {f"{fa.KERNEL}_quad_{compute[name]}": n_layers}
        if launches != want:
            raise AssertionError(f"{name}: flash launches {launches}, expected {want}")
    if not all(diff <= 1.0 for diff in served.values()):
        raise AssertionError(f"bf16 replies: card against CPU {served} x 2e-2")
    result["folded_forward"] = folded_bf16_check(torch, fa)
    return result


def folded_bf16_check(torch, fa) -> dict:
    """The flash forward under a machine axis in bfloat16 at the served
    shape of a one-machine group (the machine axis floored at 2, 144 rows
    padded to 256: 193 windows of 64, 4 heads of 16): one launch of the
    quad kernel for both machines, within bf16's 2e-2 of the plain
    version."""
    from torch.func import vmap

    lookback, heads = BASE_ESTIMATOR["lookback_window"], BASE_ESTIMATOR["n_heads"]
    shape = (2, 256 - lookback + 1, lookback, heads, BASE_ESTIMATOR["d_model"] // heads)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    fa.reset_launch_counts()
    with torch.no_grad():
        out = vmap(lambda x, y, z: fa.flash_attention(x, y, z, causal=True))(q, k, v)
        torch.cuda.synchronize()
        launches = dict(fa.typed_launches)
        scale = 1.0 / math.sqrt(shape[-1])
        err = max((out[i].float() - fa.flash_attention_reference(q[i], k[i], v[i], True, scale)[0]
                   .float()).abs().max().item() for i in range(shape[0]))
    result = {"shape": list(shape), "launches": launches, "max_abs_err": err}
    log("folded bf16 flash forward", json.dumps(result))
    if launches != {f"{fa.KERNEL}_quad_bfloat16": 1} or not err <= TOLERANCE["bfloat16"]:
        raise AssertionError(f"folded bf16 forward: {result}")
    return result


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


def write_options_lake(lake: str) -> dict:
    """Phase 12's CSV files: ``OPTIONS_SAMPLES_A_DAY`` samples a day a tag
    over the config's span from ``sensor_rows``' generator (5-minute
    samples at half its 10-minute step), a spike of +40 on the second tag
    every ``OPTIONS_SPIKE_EVERY`` samples; in the file-system layout, one
    file a tag and year. Returns {tag: samples}."""
    rows = 151 * OPTIONS_SAMPLES_A_DAY
    X, _ = sensor_rows(rows, SEED + 12)
    X[::OPTIONS_SPIKE_EVERY, 1] += 40.0
    step = timedelta(days=1) / OPTIONS_SAMPLES_A_DAY
    stamps = [(TRAIN_START + i * step).isoformat() for i in range(rows)]
    for j, tag in enumerate(TAGS):
        folder = os.path.join(lake, "gra", tag)
        os.makedirs(folder)
        with open(os.path.join(folder, f"{tag}_2019.csv"), "w") as fh:
            fh.write("Time,Value,Status\n")
            fh.writelines(f"{t},{float(v)!r},0\n" for t, v in zip(stamps, X[:, j]))
    return {tag: rows for tag in TAGS}


def options_machines(lake: str):
    """(the Transformer machine, read from ``OPTIONS_PROJECT`` by the port's
    config layer, as the workflow hands it to ``build``; the feedforward
    machine with a model template, as ``build`` takes a raw machine)."""
    from gordo_tpu_torch.workflow.config_elements import NormalizedConfig
    from gordo_tpu_torch.workflow.yaml_reader import safe_load

    text = OPTIONS_PROJECT.format(
        name=f"{MACHINE}-options", lake=lake, tags=", ".join(TAGS), epochs=OPTIONS_EPOCHS,
        metrics=", ".join(OPTIONS_METRICS),
    )
    (transformer,) = NormalizedConfig(safe_load(text), project_name=PROJECT).machines
    transformer = json.loads(json.dumps(transformer.to_dict(), default=str))
    feedforward = {
        "name": "pump-options-feedforward", "project_name": PROJECT,
        "dataset": {"type": "TimeSeriesDataset", "tags": list(TAGS), "asset": "gra",
                    "train_start_date": "2019-01-01T00:00:00+00:00",
                    "train_end_date": "2019-06-01T00:00:00+00:00",
                    "aggregation_methods": ["mean", "max"],
                    "data_provider": {"type": "FileSystemProvider", "base_dir": lake}},
        "model": OPTIONS_TEMPLATE,
    }
    return transformer, feedforward


def driven_build(root: str, machine: dict, artifact: str, *args) -> dict:
    """``build`` of ``machine`` into ``artifact`` with ``args``, through the
    CLI's ``main`` in a subprocess on the card (``FLEET_DRIVER``, which
    writes the process's flash launches): wall seconds, the launches and
    the log's fetch, cache and fit lines. Raises unless it exits 0."""
    with tempfile.NamedTemporaryFile("r", suffix=".json") as launches:
        # both by the environment: a lone positional binds to MACHINE
        env = dict(os.environ, MACHINE=yaml_text(machine), OUTPUT_DIR=artifact)
        env.pop("GORDO_TPU_LAKE_DIR", None)
        t0 = time.perf_counter()
        built = subprocess.run(
            [sys.executable, "-c", FLEET_DRIVER, launches.name, "build", *args],
            cwd=root, env=env, capture_output=True, text=True, timeout=600,
        )
        wall_s = time.perf_counter() - t0
        if built.returncode != 0:
            raise AssertionError(f"build {machine['name']} exited {built.returncode}:\n"
                                 f"{built.stderr[-4000:]}")
        counts = json.load(open(launches.name))
    lines = [line for line in built.stderr.splitlines()
             if any(key in line for key in ("Fetched", "Cross-validated", "Fitted", "Cache hit"))]
    return {"wall_s": wall_s, "kernels": {k: n for k, n in counts["kernels"].items() if n},
            "log": lines, "stderr": built.stderr}


def transfer_order_check(torch):
    """Pipelined transfers on the card read only after their copies: a
    32 MiB array moved by ``device_put_sliced`` at depth 2 and used at
    once, and eight rows walked by ``prefetch_iter`` at depth 2, each used
    as it is yielded; every value bitwise the host's."""
    import numpy as np

    from gordo_tpu_torch.parallel import transfer

    big = np.random.default_rng(SEED + 13).normal(size=(8, 1 << 20)).astype(np.float32)
    moved = transfer.device_put_sliced(big, 2, plane="build", device="cuda")
    doubled = (moved * 2).cpu().numpy()
    rows_equal = [np.array_equal(row.cpu().numpy(), big[i]) for i, row in
                  enumerate(transfer.prefetch_iter(list(big), depth=2, device="cuda"))]
    result = {"sliced_equal": bool(np.array_equal(doubled, big * 2)), "rows_equal": rows_equal}
    log("transfer order check", json.dumps(result))
    if not (result["sliced_equal"] and all(rows_equal)):
        raise AssertionError(f"a pipelined transfer was read before its copy: {result}")
    return result


def prefetch_fleet_check(torch):
    """Four full-width Transformers stepped by ``FleetTrainer`` at
    ``prefetch_depth`` 0 and 2 on the card (``PREFETCH_STEPS`` steps of
    each machine an epoch, ``PREFETCH_EPOCHS`` epochs read one at a time),
    after a warm-up fit: the parameters and losses bitwise equal, the
    transfers by (plane, mode), and the host-clock ms a step (the stacking
    and copy of the data included)."""
    from gordo_tpu_torch.models import TransformerAutoEncoder
    from gordo_tpu_torch.parallel import transfer
    from gordo_tpu_torch.parallel.fleet import FleetTrainer, StackedData

    lookback = BASE_ESTIMATOR["lookback_window"]
    Xs = [sensor_rows(lookback - 1 + steps * BATCH_SIZE - 3 * i, SEED + 20 + i)[0]
          for i, steps in enumerate(PREFETCH_STEPS)]
    runs = {}
    # the first fit pays the first launch of every kernel: a warm-up, then
    # each depth
    for depth in (0, 0, 2):
        estimator = TransformerAutoEncoder(**BASE_ESTIMATOR, n_features=len(TAGS),
                                           n_features_out=len(TAGS))
        spec = estimator._build_spec()
        trainer = FleetTrainer(spec, seed=SEED, epoch_chunk=1, prefetch_depth=depth)
        init = trainer.stack_params([
            {n: t.clone() for n, t in estimator._initial_state(spec, SEED + i).items()}
            for i in range(len(Xs))
        ])
        torch.cuda.synchronize()
        transfer.reset_transfer_counts()
        t0 = time.perf_counter()
        data = StackedData.from_ragged(Xs, Xs, prefetch_depth=depth)
        params, losses = trainer.fit(data, params=init, epochs=PREFETCH_EPOCHS,
                                     batch_size=BATCH_SIZE, early_stopping_patience=100)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        steps = trainer.fit_telemetry_["steps_per_epoch"] * PREFETCH_EPOCHS
        runs[depth] = ({n: t.detach().cpu() for n, t in params.items()}, losses,
                       {f"{plane}/{mode}": n for (plane, mode), n in
                        sorted(transfer.transfer_counts.items())}, wall_ms / steps)
    (p0, l0, c0, ms0), (p2, l2, c2, ms2) = runs[0], runs[2]
    result = {
        "machines": len(Xs), "epochs": PREFETCH_EPOCHS,
        "bitwise_equal": bool((l0 == l2).all() and all(torch.equal(p0[n], p2[n]) for n in p0)),
        "transfers_depth_0": c0, "transfers_depth_2": c2,
        "step_ms_depth_0": ms0, "step_ms_depth_2": ms2,
    }
    log("prefetch fleet steps", json.dumps(result))
    want = {"build/prefetched": 9, "train/direct": 1, "train/prefetched": PREFETCH_EPOCHS - 1}
    if not result["bitwise_equal"] or c0 or c2 != want:
        raise AssertionError(f"prefetch depth 2 against 0: {result}, expected {want}")
    return result


def remat_step_check(torch, fa, label, net_for, window, dtype, expected):
    """One forward + backward of a TransformerNet with ``remat`` off and on
    (the same weights; dropout draws from generators of one seed): the
    flash launches of each step by CUDA kernel (reset just before, read
    just after), every gradient of the remat step against the plain
    step's, each over its largest magnitude, peak device memory
    (``torch.cuda.max_memory_allocated`` over the step) and the step's
    host-clock ms (median of ``REMAT_TIMED_STEPS``)."""
    import numpy as np

    rng = np.random.default_rng(SEED + 5)
    x = torch.from_numpy(rng.normal(size=window).astype(np.float32)).cuda()
    torch.manual_seed(SEED)
    state = net_for(False).state_dict()
    out_dim = state["head.weight"].shape[0]
    y = torch.from_numpy(rng.normal(size=(window[0], out_dim)).astype(np.float32)).cuda()
    runs = {}
    for remat in (False, True):
        net = net_for(remat)
        net.load_state_dict(state)
        net = net.cuda().train()

        def step(seed=SEED):
            generator = torch.Generator(device="cuda").manual_seed(seed)
            net.zero_grad(set_to_none=True)
            loss = (net(x, generator) - y).square().mean()
            loss.backward()
            return loss

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fa.reset_launch_counts()
        loss = step()
        torch.cuda.synchronize()
        launches = {name: n for name, n in fa.kernel_launches.items() if n}
        peak = torch.cuda.max_memory_allocated() - base
        grads = {name: p.grad.detach().float().clone() for name, p in net.named_parameters()}
        times = []
        for _ in range(REMAT_TIMED_STEPS):
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        runs[remat] = {"loss": loss.item(), "grads": grads, "launches": launches,
                       "peak_bytes": peak, "step_ms": statistics.median(times)}
        del net
    plain, remat = runs[False], runs[True]
    rel = {name: (remat["grads"][name] - g).abs().max().item() / max(g.abs().max().item(), 1e-30)
           for name, g in plain["grads"].items()}
    worst = max(rel, key=rel.get)
    dtype_name = str(dtype).replace("torch.", "")
    result = {
        "dtype": dtype_name, "window": list(window),
        "launches_plain": plain["launches"], "launches_remat": remat["launches"],
        "loss_plain": plain["loss"], "loss_remat": remat["loss"],
        "max_grad_rel_diff": rel[worst], "max_grad_rel_diff_param": worst,
        "tolerance": REMAT_TOLERANCE[dtype_name],
        "max_memory_allocated_plain": plain["peak_bytes"],
        "max_memory_allocated_remat": remat["peak_bytes"],
        "step_ms_plain": plain["step_ms"], "step_ms_remat": remat["step_ms"],
    }
    log(label, json.dumps(result))
    want_plain, want_remat = expected
    if plain["launches"] != want_plain or remat["launches"] != want_remat:
        raise AssertionError(f"{label}: launches {plain['launches']} / {remat['launches']}, "
                             f"expected {want_plain} / {want_remat}")
    if not rel[worst] <= REMAT_TOLERANCE[dtype_name]:
        raise AssertionError(f"{label}: remat and plain gradients differ: {result}")
    return result


def build_options_phase(torch, fa, profile: bool):
    """Phase 12: the build options of a machine config on the card (the
    module docstring's phase 12); the path's flash launches are the first
    Transformer build's."""
    from gordo_tpu_torch import serializer
    from gordo_tpu_torch.data import _get_dataset
    from gordo_tpu_torch.models import TransformerAutoEncoder
    from gordo_tpu_torch.models.specs_seq import TransformerNet

    root = os.path.dirname(os.path.abspath(__file__))
    report = {}
    with tempfile.TemporaryDirectory() as tmp:
        lake = os.path.join(tmp, "lake")
        t0 = time.perf_counter()
        report["csv_samples"] = write_options_lake(lake)
        report["csv_write_s"] = time.perf_counter() - t0
        transformer, feedforward = options_machines(lake)
        collection = os.path.join(tmp, OPTIONS_COLLECTION)
        register = os.path.join(tmp, "register")
        artifact = os.path.join(collection, transformer["name"])
        first = driven_build(root, transformer, artifact, "--model-register-dir", register)
        files = {name: os.stat(os.path.join(artifact, name)).st_mtime_ns
                 for name in sorted(os.listdir(artifact))}
        again = driven_build(root, transformer, artifact, "--model-register-dir", register)
        if any("Cache hit" in line for line in first["log"]) or not any(
                "Cache hit" in line for line in again["log"]):
            raise AssertionError(f"the register: first {first['log']}, again {again['log']}")
        if again["kernels"] or {name: os.stat(os.path.join(artifact, name)).st_mtime_ns
                                for name in sorted(os.listdir(artifact))} != files:
            raise AssertionError(f"the cache hit launched {again['kernels']} or rewrote the "
                                 "artifact")
        if "model parameters on cuda" not in first["stderr"]:
            raise AssertionError(f"the options build did not fit on the card:\n{first['stderr']}")
        ff_artifact = os.path.join(collection, feedforward["name"])
        ff = driven_build(root, feedforward, ff_artifact,
                          *(arg for p in OPTIONS_PARAMETERS for arg in ("--model-parameter", p)))
        metadata = serializer.load_metadata(artifact)["metadata"]
        build_meta = metadata["build_metadata"]
        dataset_meta = build_meta["dataset"]["dataset_meta"]
        scores = build_meta["model"]["cross_validation"]["scores"]
        dataset = _get_dataset(transformer["dataset"])
        X, _, stamps = dataset.get_data()
        joined = dataset.get_metadata()["tag_loading_metadata"]["aggregate_metadata"][
            "joined_length"]
        ff_meta = serializer.load_metadata(ff_artifact)["metadata"]
        ff_columns = list(ff_meta["build_metadata"]["dataset"]["dataset_meta"]["x_hist"])
        model = serializer.load(artifact, device="cpu")
        report["transformer"] = {
            "build_s": first["wall_s"], "cache_hit_build_s": again["wall_s"],
            "build_kernels": first["kernels"], "cache_hit_kernels": again["kernels"],
            "log": first["log"], "rows_joined": joined, "rows_built": len(X),
            "filtered_periods": len(dataset_meta["filtered_periods"]["median"]),
            "scaler": type(model.scaler).__name__,
            "cv_splitter": "KFold", "cv_fast_path": metadata["build_metadata"]["model"][
                "model_meta"].get("cv-fast-path"),
            "scores": {name: scores[name]["fold-mean"] for name in scores
                       if "-GRA-" not in name},
        }
        report["feedforward"] = {"build_s": ff["wall_s"], "kernels": ff["kernels"],
                                 "columns": ff_columns,
                                 "definition": json.load(open(os.path.join(
                                     ff_artifact, "definition.json")))}
        log("build options", json.dumps({k: v for k, v in report.items()}, default=str))
        if not (len(X) < joined and report["transformer"]["filtered_periods"] > 0):
            raise AssertionError(f"the row and period filters removed nothing: {report}")
        if report["transformer"]["scaler"] != "StandardScaler" or not all(
                f"{name.replace('_', '-')}" in scores for name in OPTIONS_METRICS):
            raise AssertionError(f"the options did not reach the model: {report}")
        if len(ff_columns) != 2 * len(TAGS) or ff["kernels"]:
            raise AssertionError(f"the feedforward machine: {report['feedforward']}")
        report["transformer"]["requests"] = serve_built(
            torch, collection, transformer, X, stamps, ("anomaly/prediction",), 1e-4, 0)
    report["transfer_order"] = transfer_order_check(torch)
    report["prefetch"] = prefetch_fleet_check(torch)

    served = TransformerAutoEncoder(**BASE_ESTIMATOR, n_features=len(TAGS),
                                    n_features_out=len(TAGS))

    def served_net(remat):
        """The served machine's net (the factory's, dropout 0.1)."""
        net = served._build_spec().module
        net.remat = remat
        return net

    layers = BASE_ESTIMATOR["n_layers"]
    quad = {f"{k}_quad": layers for k in (fa.KERNEL, fa.KERNEL_DQ, fa.KERNEL_DKV)}
    report["remat_served"] = remat_step_check(
        torch, fa, "remat served transformer", served_net,
        (BATCH_SIZE, BASE_ESTIMATOR["lookback_window"], len(TAGS)), torch.float32,
        (quad, dict(quad, **{f"{fa.KERNEL}_quad": 2 * layers})),
    )
    mma = {f"{k}_mma": MODEL_16BIT["n_layers"] for k in (fa.KERNEL, fa.KERNEL_DQ, fa.KERNEL_DKV)}
    report["remat_bf16"] = remat_step_check(
        torch, fa, "remat bf16 long-context net",
        lambda remat: TransformerNet(**MODEL_16BIT, attention_impl="flash",
                                     dtype=torch.bfloat16, remat=remat),
        WINDOW_16BIT, torch.bfloat16,
        (mma, dict(mma, **{f"{fa.KERNEL}_mma": 2 * MODEL_16BIT["n_layers"]})),
    )
    for key in ("remat_served", "remat_bf16"):
        report[key]["kernel_launches"] = report[key]["launches_remat"]
    report["kernel_launches"] = {
        name: first["kernels"].get(name, 0) for name in fa.kernel_launches}
    return report


def write_lake(root: str) -> dict:
    """Phase 13a's lake under ``root``: ``long/`` (day partitions of
    ``tag,time,value`` rows of the first two tags, the restated samples
    and the stray partition of ``LAKE_PROJECT``'s note) and ``fs/`` (the
    third tag, one file-system CSV file). Returns the directories and the
    true samples, {tag: (int ns stamps, values)}."""
    import numpy as np

    from gordo_tpu_torch.data.base import to_ns

    rows = 151 * OPTIONS_SAMPLES_A_DAY
    X, _ = sensor_rows(rows, SEED + 13)
    X[::OPTIONS_SPIKE_EVERY, 1] += 40.0
    step = timedelta(days=1) / OPTIONS_SAMPLES_A_DAY
    stamps = [TRAIN_START + i * step for i in range(rows)]
    restated = set(np.random.default_rng(SEED + 13).choice(rows, LAKE_DUPLICATES, replace=False)
                   .tolist())
    long_dir, fs_dir = os.path.join(root, "long"), os.path.join(root, "fs")
    for day in range(151):
        date = TRAIN_START + timedelta(days=day)
        folder = os.path.join(long_dir, f"{date.year:04d}", f"{date.month:02d}",
                              f"{date.day:02d}")
        os.makedirs(folder)
        span = range(day * OPTIONS_SAMPLES_A_DAY, (day + 1) * OPTIONS_SAMPLES_A_DAY)
        with open(os.path.join(folder, "a-readings.csv"), "w") as fh:
            fh.write("tag,time,value\n")
            for j, tag in enumerate(TAGS[:2]):
                fh.writelines(
                    f"{tag},{stamps[i].isoformat()},"
                    f"{float(X[i, j]) + (LAKE_OFFSET if i in restated else 0.0)!r}\n"
                    for i in span)
        late = [i for i in span if i in restated]
        if late:
            with open(os.path.join(folder, "b-corrections.csv"), "w") as fh:
                fh.write("Tag,Time,Value\n")
                fh.writelines(f"{tag},{stamps[i].isoformat()},{float(X[i, j])!r}\n"
                              for i in late for j, tag in enumerate(TAGS[:2]))
    stray = os.path.join(long_dir, f"{LAKE_STRAY_DAY.year:04d}", f"{LAKE_STRAY_DAY.month:02d}",
                         f"{LAKE_STRAY_DAY.day:02d}")
    os.makedirs(stray)
    with open(os.path.join(stray, "a-readings.csv"), "w") as fh:
        fh.write("tag,time,value\n")
        fh.writelines(f"{tag},{stamps[i].isoformat()},{LAKE_OFFSET}\n"
                      for i in range(0, rows, 97) for tag in TAGS[:2])
    os.makedirs(fs_dir)
    with open(os.path.join(fs_dir, f"{TAGS[2]}.csv"), "w") as fh:
        fh.write("Time,Value\n")
        fh.writelines(f"{t.isoformat()},{float(v)!r}\n" for t, v in zip(stamps, X[:, 2]))
    ns = np.asarray([to_ns(t) for t in stamps], dtype=np.int64)
    return {"long": long_dir, "fs": fs_dir,
            "truth": {tag: (ns, X[:, j].astype(np.float64)) for j, tag in enumerate(TAGS)}}


def lake_build_check(root: str, workdir: str, device_args=()) -> dict:
    """Phase 13a: the lake machine read through the port's config layer and
    built by ``build`` in a subprocess on the card (``device_args`` for a
    rehearsal elsewhere): rows each provider fetched (against the written
    samples: the restated ones at their true values, the stray partition
    unread), rows kept, drop periods by method, the forest's seconds, the
    build's flash launches and the sqlite row against the machine's JSON."""
    import sqlite3

    import numpy as np

    from gordo_tpu_torch import serializer
    from gordo_tpu_torch.data.providers import FileSystemProvider, LongFormatProvider
    from gordo_tpu_torch.data.sensor_tag import SensorTag
    from gordo_tpu_torch.workflow.config_elements import NormalizedConfig
    from gordo_tpu_torch.workflow.yaml_reader import safe_load

    t0 = time.perf_counter()
    lake = write_lake(os.path.join(workdir, "lake"))
    report = {"lake_write_s": time.perf_counter() - t0}
    db = os.path.join(workdir, "machines.db")
    text = LAKE_PROJECT.format(name=f"{MACHINE}-lake", fs=lake["fs"], long=lake["long"],
                               tags=", ".join(f'"{tag}"' for tag in TAGS), epochs=OPTIONS_EPOCHS,
                               db=db)
    (machine,) = NormalizedConfig(safe_load(text), project_name=PROJECT).machines
    machine = json.loads(json.dumps(machine.to_dict(), default=str))
    end = TRAIN_START + timedelta(days=151)
    fetched = {}
    t0 = time.perf_counter()
    for provider, tags in ((LongFormatProvider(lake["long"]), TAGS[:2]),
                           (FileSystemProvider(lake["fs"]), TAGS[2:])):
        series = list(provider.load_series(TRAIN_START, end, [SensorTag(t, "gra") for t in tags]))
        for tag, got in zip(tags, series):
            ns, values = lake["truth"][tag]
            if not (np.array_equal(got.index, ns) and np.allclose(got.values, values,
                                                                   rtol=0, atol=1e-6)):
                raise AssertionError(f"{type(provider).__name__} read {tag} wrong: "
                                     f"{len(got)} of {len(ns)} samples")
        fetched[type(provider).__name__] = sum(len(s) for s in series)
    report["provider_read_s"] = time.perf_counter() - t0
    report["rows_fetched"] = fetched
    artifact = os.path.join(workdir, LAKE_COLLECTION, machine["name"])
    built = driven_build(root, machine, artifact, *device_args)
    metadata = serializer.load_metadata(artifact)
    periods = metadata["metadata"]["build_metadata"]["dataset"]["dataset_meta"][
        "filtered_periods"]
    kept = [int(line.split("Fetched ")[1].split()[0]) for line in built["log"]
            if "Fetched " in line]
    forest = [line.split("Isolation forest: ")[1] for line in built["stderr"].splitlines()
              if "Isolation forest: " in line]
    with sqlite3.connect(db) as conn:
        rows = conn.execute("SELECT name, dataset, model, metadata FROM machine").fetchall()
    if len(rows) != 1 or rows[0][0] != machine["name"]:
        raise AssertionError(f"the sqlite reporter wrote {[r[0] for r in rows]}")
    report.update({
        "build_s": built["wall_s"], "kernel_launches": built["kernels"],
        "rows_kept": kept[0] if kept else None,
        "drop_periods": {method: len(p) for method, p in periods.items()},
        "forest": forest,
        "sqlite_dataset_equal": json.loads(rows[0][1]) == metadata["dataset"],
        "sqlite_model_equal": json.loads(rows[0][2]) == metadata["model"],
        "sqlite_metadata_keys_equal": set(json.loads(rows[0][3])) == set(metadata["metadata"]),
    })
    log("lake build", json.dumps(report))
    if sorted(report["drop_periods"]) != ["iforest", "median"] or not all(
            report["drop_periods"].values()):
        raise AssertionError(f"both period filters should drop periods: {report['drop_periods']}")
    if not (report["sqlite_dataset_equal"] and report["sqlite_model_equal"]
            and report["sqlite_metadata_keys_equal"]):
        raise AssertionError(f"the sqlite row is not the machine's JSON: {report}")
    if not forest or not kept:
        raise AssertionError(f"the build log lacks the forest or fetch line: {built['log']}")
    return report


def request_json(url: str, body=None):
    """(status, parsed JSON reply, seconds) of a POST of ``body`` as JSON,
    whatever the status."""
    import urllib.error

    request = urllib.request.Request(
        url, data=json.dumps(body).encode() if body is not None else b"",
        headers={"Content-Type": "application/json"}, method="POST")
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(request, timeout=600) as reply:
            status, raw = reply.status, reply.read()
    except urllib.error.HTTPError as err:
        status, raw = err.code, err.read()
    return status, json.loads(raw), time.perf_counter() - t0


def stream_chunks(n_rows: int) -> list:
    """(start, rows) of each streamed update over ``n_rows`` rows."""
    chunks, start = [(0, STREAM_FIRST)], STREAM_FIRST
    while start < n_rows:
        chunks.append((start, min(STREAM_UPDATE, n_rows - start)))
        start += STREAM_UPDATE
    return chunks


def stream_check(torch, fa, collection: str, device=None) -> dict:
    """Phase 13b: phase 10's four Transformers streamed on the card
    (``device`` for a rehearsal elsewhere) over phase 11's whole-history
    rows (the module docstring): per update its latency, rows copied to
    the device and flash launches; the streamed outputs against one
    ``/prediction/fleet``; the device idle share over
    ``STREAM_PROFILED`` updates; the resume contract; and a ``latest``
    symlink rolled mid-stream."""
    import shutil

    import numpy as np

    from gordo_tpu_torch import serializer
    from gordo_tpu_torch.data import _get_dataset
    from gordo_tpu_torch.data.base import to_datetimes
    from gordo_tpu_torch.parallel import transfer
    from gordo_tpu_torch.server.app import build_app

    transformers = [f"{MACHINE}-{i}" for i in range(FLEET_TRANSFORMERS)]
    n_rows, n_layers = SERVE_ROWS[1], BASE_ESTIMATOR["n_layers"]
    lookback = BASE_ESTIMATOR["lookback_window"]
    data = {}
    for name in transformers:
        metadata = serializer.load_metadata(os.path.join(collection, name))
        X, _, stamps = _get_dataset(metadata["dataset"]).get_data()
        keys = [stamp.isoformat() for stamp in to_datetimes(stamps.astype(np.int64))]
        data[name] = (np.asarray(X, dtype=np.float64)[:n_rows], keys[:n_rows],
                      metadata["dataset"]["tag_list"])
    forward = [name for name in fa.kernel_launches if name.startswith(fa.KERNEL + "_")]

    def launches():
        return (sum(fa.kernel_launches[k] for k in forward),
                sum(fa.launch_counts[k] for k in (fa.KERNEL_DQ, fa.KERNEL_DKV)))

    def copied_rows():
        return sum(n for (plane, _), n in transfer.transfer_rows.items() if plane == "stream")

    def updates(start, k):
        return {"updates": {n: {"rows": data[n][0][start:start + k].tolist(), "seq": start}
                            for n in transformers}}

    def output_rows(block):
        return np.asarray([list(column.values()) for column in block.values()]).T

    report = {}
    app = build_app(collection, device=device, batch_wait_ms=0)
    with http_server(collection, None, app=app) as base:
        status, reply, seconds = request_json(f"{base}/prediction/fleet", {"machines": {
            n: frame_of(X, keys, tags, slice(0, n_rows)) for n, (X, keys, tags) in data.items()}})
        if status != 200:
            raise AssertionError(f"/prediction/fleet answered {status}: {reply}")
        one_shot = {n: output_rows(reply["data"][n]["model-output"]) for n in transformers}
        report["one_shot_s"] = seconds

        status, opened, _ = request_json(f"{base}/stream/open", {"machines": transformers})
        if status != 201:
            raise AssertionError(f"stream/open answered {status}: {opened}")
        sid = opened["session"]
        streamed = {n: [] for n in transformers}
        rows_log, profiled = [], {}
        fa.reset_launch_counts()
        transfer.reset_transfer_counts()

        def push(start, k):
            before_launch, before_rows = launches(), copied_rows()
            status, body, seconds = request_json(f"{base}/stream/{sid}/update", updates(start, k))
            if status != 200:
                raise AssertionError(f"update at row {start} answered {status}: {body}")
            after_launch = launches()
            scored = [len(body["scores"][n]["rows"]) for n in transformers]
            for name in transformers:
                streamed[name].extend(body["scores"][name]["rows"])
            row = {"start": start, "rows": k, "seconds": seconds, "outputs": scored[0],
                   "warming": body["scores"][transformers[0]]["warming"],
                   "copied_rows": copied_rows() - before_rows,
                   "forward_launches": after_launch[0] - before_launch[0],
                   "backward_launches": after_launch[1] - before_launch[1]}
            rows_log.append(row)
            if row["copied_rows"] != len(transformers) * k:
                raise AssertionError(f"update at row {start} copied {row['copied_rows']} rows, "
                                     f"not its {len(transformers)} x {k}")
            want = 0 if row["warming"] else n_layers
            if row["forward_launches"] != want or row["backward_launches"]:
                raise AssertionError(f"update at row {start}: {row}")

        chunks = stream_chunks(n_rows)
        for i, (start, k) in enumerate(chunks):
            if i == STREAM_PROFILE_AT:
                pending = iter(chunks[i:i + STREAM_PROFILED])
                wall_ms, device_ms, kernels = profile_window(
                    torch, lambda: push(*next(pending)), reps=STREAM_PROFILED, tries=1)
                profiled = {"wall_ms": wall_ms, "device_ms": device_ms, "kernels": kernels,
                            "idle_share": None if device_ms is None else 1 - device_ms / wall_ms}
            elif not STREAM_PROFILE_AT < i < STREAM_PROFILE_AT + STREAM_PROFILED:
                push(start, k)
        stream_launches = dict(fa.kernel_launches)
        server_root = base.split("/gordo/")[0]
        with urllib.request.urlopen(f"{server_root}/healthz", timeout=60) as reply:
            report["healthz_streaming"] = json.loads(reply.read())["streaming"]
        if report["healthz_streaming"]["sessions"] != 1:
            raise AssertionError(f"/healthz: {report['healthz_streaming']}")
        diffs = {}
        for name in transformers:
            got = np.asarray(streamed[name], dtype=np.float64)
            want = one_shot[name]
            if got.shape != want.shape or got.shape[0] != n_rows - lookback + 1:
                raise AssertionError(f"{name}: streamed {got.shape}, one-shot {want.shape}")
            diffs[name] = float(np.abs(got - want).max() / np.abs(want).max())
        timed = [r["seconds"] for j, r in enumerate(rows_log)
                 if not r["warming"] and not STREAM_PROFILE_AT <= j < STREAM_PROFILE_AT
                 + STREAM_PROFILED]
        report.update({
            "updates": len(rows_log), "rows": n_rows,
            "update_median_ms": 1e3 * statistics.median(timed),
            "update_p90_ms": 1e3 * float(np.percentile(timed, 90)),
            "copied_rows_per_update": sorted({r["copied_rows"] for r in rows_log}),
            "forward_launches_scored": sorted({r["forward_launches"] for r in rows_log
                                               if not r["warming"]}),
            "forward_launches_warming": [r["forward_launches"] for r in rows_log
                                         if r["warming"]],
            "max_rel_diff_vs_one_shot": max(diffs.values()),
            "profiled": profiled, "kernel_launches": stream_launches,
            "transfers": {f"{p}/{m}": n for (p, m), n in transfer.transfer_counts.items()},
        })
        if not report["max_rel_diff_vs_one_shot"] <= STREAM_RTOL:
            raise AssertionError(f"streamed against one-shot: {diffs}")
        request_json(f"{base}/stream/{sid}/close")

        # the resume contract: a second session cut after STREAM_RESUME_AT updates
        status, opened, _ = request_json(f"{base}/stream/open", {"machines": transformers})
        sid = opened["session"]
        resumed = {n: [] for n in transformers}
        for start, k in chunks[:STREAM_RESUME_AT]:
            status, body, _ = request_json(f"{base}/stream/{sid}/update", updates(start, k))
            if status != 200:
                raise AssertionError(f"the second session's update answered {status}: {body}")
        cut = chunks[STREAM_RESUME_AT][0]
        request_json(f"{base}/stream/{sid}/close")
        status, gone, _ = request_json(f"{base}/stream/{sid}/update", updates(cut, STREAM_UPDATE))
        if status != 409 or gone["stream_resume"]["reason"] != "unknown_session":
            raise AssertionError(f"a closed session's update answered {status}: {gone}")
        tail = cut - (lookback - 1)
        status, opened, _ = request_json(f"{base}/stream/open", {"machines": {
            n: {"resume": {"rows": data[n][0][tail:cut].tolist(), "seq": tail}}
            for n in transformers}})
        sid = opened["session"]
        for start, k in chunks[STREAM_RESUME_AT:STREAM_RESUME_AT + STREAM_RESUME_MORE]:
            status, body, _ = request_json(f"{base}/stream/{sid}/update", updates(start, k))
            if status != 200:
                raise AssertionError(f"the resumed session's update answered {status}: {body}")
            for name in transformers:
                resumed[name].extend(body["scores"][name]["rows"])
        first = cut - lookback + 1
        resume_diff = max(
            float(np.abs(np.asarray(resumed[n]) - np.asarray(streamed[n][first:first + len(
                resumed[n])])).max()) for n in transformers)
        report["resume"] = {"cut_at_row": cut, "closed_answer": gone["stream_resume"],
                            "outputs_after": len(resumed[transformers[0]]),
                            "max_abs_diff_vs_unbroken": resume_diff}
        if not resume_diff <= STREAM_RTOL * max(np.abs(one_shot[n]).max() for n in one_shot):
            raise AssertionError(f"the resumed stream left the unbroken one: {report['resume']}")
        request_json(f"{base}/stream/{sid}/close")

    # the latest symlink rolled mid-stream
    with tempfile.TemporaryDirectory() as revisions:
        for rev in ("rev-a", "rev-b"):
            for name in transformers:
                shutil.copytree(os.path.join(collection, name), os.path.join(revisions, rev, name))
        latest = os.path.join(revisions, "latest")
        os.symlink(os.path.join(revisions, "rev-a"), latest)
        rolled_app = build_app(latest, device=device, batch_wait_ms=0)
        with http_server(latest, None, app=rolled_app) as base:
            status, opened, _ = request_json(f"{base}/stream/open", {"machines": transformers})
            sid = opened["session"]
            for start, k in chunks[:2]:
                request_json(f"{base}/stream/{sid}/update", updates(start, k))
            swap = os.path.join(revisions, ".latest-swap")
            os.symlink(os.path.join(revisions, "rev-b"), swap)
            os.replace(swap, latest)
            start, k = chunks[2]
            status, rolled, _ = request_json(f"{base}/stream/{sid}/update", updates(start, k))
        report["roll"] = {"status": status, "answer": rolled.get("stream_resume"),
                          "revision": rolled.get("revision")}
        if status != 409 or rolled["stream_resume"]["reason"] != "revision_rolled":
            raise AssertionError(f"the update after the roll answered {status}: {rolled}")
    log("streaming", json.dumps({k: v for k, v in report.items() if k != "kernel_launches"}))
    log("streaming updates", json.dumps(rows_log))
    return report


def lake_stream_phase(torch, fa, profile: bool, collection: str):
    """Phase 13: the lake build (13a) and the streaming sessions (13b)."""
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as workdir:
        report = {"lake_build": lake_build_check(root, workdir)}
    report["stream"] = stream_check(torch, fa, collection)
    return report


# Phase 14, "plane": the sweep, resumed fits and builds, and the routed
# plane, over phase 10's collection and data at full width. (a) `sweep`
# of PLANE_LRS on turbine-9900-transformer-0 (phase 10's 21 744 rows),
# PLANE_SWEEP_EPOCHS epoch where the config has 10; (b) FleetTrainer on
# the four Transformers cut to their first PLANE_RESUME_ROWS rows (the
# phase's time budget: 4 epochs in all), 2 epochs where the config has
# 10, dropout PLANE_DROPOUT; then `build-fleet --resume` over phase 10's
# directory as it is, and again with one Transformer's artifact removed
# (its bucket trains 1 epoch, as phase 10's); (c) PLANE_REPLICAS
# `run-server` replicas and a `run-router`, each a subprocess, over
# phase 10's collection, with phase 11's 144- and 8255-row requests and
# a phase 13 stream cut to PLANE_STREAM_ROWS rows
PLANE_LRS = (1e-4, 3e-4, 1e-3, 3e-3)
PLANE_SWEEP_EPOCHS = 1
PLANE_SWEEP_RTOL = 1e-4
PLANE_RESUME_ROWS = 4096
PLANE_DROPOUT = 0.1
PLANE_REPLICAS = ("r0", "r1")
PLANE_REBUILT = f"{MACHINE}-3"
PLANE_STREAM_ROWS = STREAM_FIRST + STREAM_UPDATE
PLANE_ROUTED_REPEATS = 5
# runs `python -m gordo_tpu_torch.cli run-server`'s main in a subprocess;
# on SIGUSR1 it writes that process's flash launches and the machines of
# each fleet scorer its server built to the file named first
REPLICA_DRIVER = (
    "import json, signal, sys\n"
    "from gordo_tpu_torch.cli.cli import main\n"
    "from gordo_tpu_torch.ops import flash_attention as fa\n"
    "from gordo_tpu_torch.server import runner\n"
    "apps = []\n"
    "build_app = runner.build_app\n"
    "def capture(*args, **kwargs):\n"
    "    apps.append(build_app(*args, **kwargs))\n"
    "    return apps[-1]\n"
    "runner.build_app = capture\n"
    "def dump(*_):\n"
    "    scorers = [list(key[1]) for app in apps for key in app.catalog._fleet_scorers]\n"
    "    with open(sys.argv[1] + '.tmp', 'w') as fh:\n"
    "        json.dump({'kernels': fa.kernel_launches, 'scorers': scorers}, fh)\n"
    "    import os; os.replace(sys.argv[1] + '.tmp', sys.argv[1])\n"
    "signal.signal(signal.SIGUSR1, dump)\n"
    "sys.exit(main(sys.argv[2:]))\n"
)


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def wait_ready(url: str, process, seconds: float = 180.0) -> float:
    """Seconds until ``url`` answers 200; raises if ``process`` exits or
    the time runs out."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        if process.poll() is not None:
            raise AssertionError(f"{url}: the process exited {process.returncode}")
        try:
            with urllib.request.urlopen(url, timeout=5) as reply:
                if reply.status == 200:
                    return time.perf_counter() - t0
        except OSError:
            pass
        time.sleep(0.25)
    raise AssertionError(f"{url} not ready after {seconds} s")


def replica_counts(process, path: str) -> dict:
    """A replica's launches and scorers, asked for by SIGUSR1."""
    import signal

    if os.path.exists(path):
        os.unlink(path)
    process.send_signal(signal.SIGUSR1)
    for _ in range(200):
        if os.path.exists(path):
            with open(path) as fh:
                return json.load(fh)
        time.sleep(0.05)
    raise AssertionError(f"replica wrote no counts to {path}")


def sweep_check(torch, fa, root: str, device=None) -> dict:
    """Phase 14a: `sweep` of ``PLANE_LRS`` on phase 10's first Transformer
    in this process (launches counted from 0 just before), and a
    one-machine fit at the first rate held to its trial (``device``: the
    card, unless a rehearsal names another)."""
    device_args = ["--device", device] if device else []
    import io

    import numpy as np

    from gordo_tpu_torch import serializer
    from gordo_tpu_torch.builder.fleet_build import _find_torch_estimator
    from gordo_tpu_torch.cli import cli
    from gordo_tpu_torch.data import _get_dataset
    from gordo_tpu_torch.machine import Machine
    from gordo_tpu_torch.models.specs import make_optimizer
    from gordo_tpu_torch.parallel import sweep as sweep_module
    from gordo_tpu_torch.parallel.fleet import FleetTrainer, StackedData

    machine = fleet_machines(root)[0]
    telemetry = []
    fit = sweep_module.HyperparamSweep.fit

    def recording(self, *args, **kwargs):
        result = fit(self, *args, **kwargs)
        telemetry.append(self.trainer.fit_telemetry_)
        return result

    sweep_module.HyperparamSweep.fit = recording
    out = io.StringIO()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            code = cli.main(["sweep", json.dumps(machine), "--param",
                             "lr=" + ",".join(str(lr) for lr in PLANE_LRS),
                             "--epochs", str(PLANE_SWEEP_EPOCHS), *device_args])
    finally:
        sweep_module.HyperparamSweep.fit = fit
    seconds = time.perf_counter() - t0
    launches = dict(fa.kernel_launches)
    lines = out.getvalue().strip().splitlines()
    log("sweep", *lines)
    if code != 0 or len(lines) != len(PLANE_LRS) + 1:
        raise AssertionError(f"sweep exited {code}: {lines}")
    losses = {}
    for line in lines[:-1]:
        hp, loss = line.split(": ", 1)[1].rsplit(" loss=", 1)
        losses[float(hp.split("=", 1)[1])] = float(loss)
    (fit_telemetry,) = telemetry
    steps = fit_telemetry["steps_per_epoch"] * fit_telemetry["epochs_run"]

    # the solo fit at the first rate, as the command fits its trial
    normalized = Machine.from_config(machine, project_name=machine["project_name"])
    est = _find_torch_estimator(serializer.from_definition(normalized.model))
    X, _, _ = _get_dataset(normalized.dataset.to_dict()).get_data()
    X = np.asarray(X, dtype="float32")
    est.kwargs.update({"n_features": X.shape[1], "n_features_out": X.shape[1]})
    spec = est._build_spec()
    lr = PLANE_LRS[0]
    trainer = FleetTrainer(spec, lookahead=est.lookahead, seed=0, device=device,
                           optimizer=make_optimizer(spec.optimizer, dict(
                               spec.optimizer_kwargs, learning_rate=lr)))
    t0 = time.perf_counter()
    _, solo = trainer.fit(StackedData.from_ragged([X], [X], device=device), seeds=[0],
                          epochs=PLANE_SWEEP_EPOCHS, batch_size=int(est.kwargs.get("batch_size", 32)))
    solo_seconds = time.perf_counter() - t0
    solo_loss = float(solo[-1, 0])
    diff = abs(losses[lr] - solo_loss) / max(abs(solo_loss), 1e-12)
    report = {
        "losses": losses, "solo_loss": solo_loss, "trial0_vs_solo_rel": diff,
        "seconds": seconds, "solo_seconds": solo_seconds, "steps": steps,
        "step_ms": 1000.0 * fit_telemetry["epoch_loop_s"] / steps,
        "solo_step_ms": 1000.0 * trainer.fit_telemetry_["epoch_loop_s"]
        / (trainer.fit_telemetry_["steps_per_epoch"] * PLANE_SWEEP_EPOCHS),
        "kernel_launches": launches,
    }
    log("sweep check", json.dumps({k: v for k, v in report.items() if k != "kernel_launches"}))
    if not diff <= PLANE_SWEEP_RTOL:
        raise AssertionError(f"trial at lr {lr}: {losses[lr]} against a solo fit's {solo_loss}")
    if not all(launches[f"{k}_quad"] > 0 for k in (fa.KERNEL, fa.KERNEL_DQ, fa.KERNEL_DKV)):
        raise AssertionError(f"the sweep launched no flash kernel: {launches}")
    return report


def resume_fit_check(torch, fa, collection: str, device=None) -> dict:
    """Phase 14b, the fit: four Transformers (phase 10's data, cut to
    ``PLANE_RESUME_ROWS`` rows) fitted 2 epochs unbroken, then 1 epoch
    with a checkpointer and resumed to 2 (launches of these two counted);
    bitwise equal; a torn newest checkpoint restores the one before."""
    import numpy as np

    from gordo_tpu_torch.data import _get_dataset
    from gordo_tpu_torch import serializer
    from gordo_tpu_torch.models import TransformerAutoEncoder
    from gordo_tpu_torch.parallel.checkpoint import FleetCheckpointer
    from gordo_tpu_torch.parallel.fleet import FleetTrainer, StackedData

    Xs = []
    for i in range(FLEET_TRANSFORMERS):
        metadata = serializer.load_metadata(os.path.join(collection, f"{MACHINE}-{i}"))
        X = _get_dataset(metadata["dataset"]).get_data()[0]
        Xs.append(np.asarray(X, dtype=np.float32)[:PLANE_RESUME_ROWS])
    est = TransformerAutoEncoder(**dict(BASE_ESTIMATOR, dropout=PLANE_DROPOUT),
                                 n_features=len(TAGS), n_features_out=len(TAGS))
    data = StackedData.from_ragged(Xs, Xs, device=device)
    seeds = [SEED + i for i in range(FLEET_TRANSFORMERS)]

    def trainer():
        return FleetTrainer(est._build_spec(), seed=SEED, device=device)

    def synchronize():
        if data.X.is_cuda:
            torch.cuda.synchronize()

    report = {}
    t0 = time.perf_counter()
    full, full_losses = trainer().fit(data, seeds=seeds, epochs=2, batch_size=BATCH_SIZE)
    synchronize()
    report["unbroken_s"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = FleetCheckpointer(os.path.join(tmp, "ckpt"))
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        trainer().fit(data, seeds=seeds, epochs=1, batch_size=BATCH_SIZE, checkpointer=ckpt)
        report["first_epoch_s"] = time.perf_counter() - t0
        resumed_trainer = trainer()
        t0 = time.perf_counter()
        resumed, losses = resumed_trainer.fit(data, seeds=seeds, epochs=2, batch_size=BATCH_SIZE,
                                              checkpointer=ckpt)
        synchronize()
        report["resumed_s"] = time.perf_counter() - t0
        report["kernel_launches"] = dict(fa.kernel_launches)
        report["resumed_from_epoch"] = resumed_trainer.fit_telemetry_["resumed_from_epoch"]
        report["bitwise_equal"] = all(torch.equal(resumed[k], full[k]) for k in full)
        report["losses_equal"] = bool(np.array_equal(losses, full_losses[1:]))
        report["max_abs_diff"] = max(float((resumed[k] - full[k]).abs().max()) for k in full)
        params_file = os.path.join(tmp, "ckpt", "1", "params.npz")
        with open(params_file, "r+b") as fh:
            fh.truncate(os.path.getsize(params_file) - 9)
        # templates in the optimizer's view: the stack as one flat tensor
        flat = {"flat": torch.cat([v.reshape(FLEET_TRANSFORMERS, -1) for v in full.values()], 1)}
        _, _, fallback = ckpt.restore(flat, resumed_trainer.optimizer.init(
            flat, n_machines=FLEET_TRANSFORMERS))
        report["torn_newest_restored_epoch"] = fallback
    log("resume fit", json.dumps({k: v for k, v in report.items() if k != "kernel_launches"}))
    if not (report["bitwise_equal"] and report["losses_equal"]
            and report["resumed_from_epoch"] == 1 and fallback == 0):
        raise AssertionError(f"resumed fit: {report}")
    return report


def resume_build_check(collection: str, device=None) -> dict:
    """Phase 14b, the builder: `build-fleet --resume` over phase 10's
    collection (every machine reused, no launch), then with
    ``PLANE_REBUILT``'s artifact removed (only it rebuilt; the others'
    files untouched), each in a subprocess whose launches are counted."""
    import shutil

    root = os.path.dirname(os.path.abspath(__file__))
    listing = os.path.join(os.path.dirname(collection), "machines.yaml")
    counts = os.path.join(os.path.dirname(collection), "resume_launches.json")
    n_machines = len(fleet_machines(root))
    stamps = {name: os.path.getmtime(os.path.join(collection, name, "params.npz"))
              for name in os.listdir(collection)
              if os.path.isdir(os.path.join(collection, name)) and name != PLANE_REBUILT}
    report = {}
    for label, expected in (("all_current", (n_machines, 0)), ("one_removed",
                                                                (n_machines - 1, 1))):
        if label == "one_removed":
            shutil.rmtree(os.path.join(collection, PLANE_REBUILT))
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-c", FLEET_DRIVER, counts, "build-fleet", "--machines-from",
             listing, "--resume", *(["--device", device] if device else [])],
            cwd=root, env=dict(os.environ, OUTPUT_DIR=collection), capture_output=True,
            text=True, timeout=600,
        )
        seconds = time.perf_counter() - t0
        if run.returncode != 0:
            raise AssertionError(f"build-fleet --resume exited {run.returncode}:\n"
                                 f"{run.stdout[-2000:]}\n{run.stderr[-4000:]}")
        with open(counts) as fh:
            launches = json.load(fh)["kernels"]
        with open(os.path.join(collection, "build_report.json")) as fh:
            build_report = json.load(fh)
        got = (build_report["n_resumed"], build_report["n_built"])
        report[label] = {"seconds": seconds, "n_resumed": got[0], "n_built": got[1],
                         "kernel_launches": launches}
        log("resume build", label, json.dumps(report[label]))
        if got != expected or build_report["n_failed"]:
            raise AssertionError(f"build-fleet --resume ({label}): {build_report}")
    if any(report["all_current"]["kernel_launches"].values()):
        raise AssertionError(f"a resume that reused everything launched: {report}")
    rebuilt = report["one_removed"]["kernel_launches"]
    if not all(rebuilt[f"{k}_quad"] > 0 for k in ("flash_attention_fwd", "flash_attention_bwd_dq",
                                                  "flash_attention_bwd_dkv")):
        raise AssertionError(f"the rebuilt Transformer launched no flash kernel: {rebuilt}")
    touched = [name for name, stamp in stamps.items()
               if os.path.getmtime(os.path.join(collection, name, "params.npz")) != stamp]
    if touched:
        raise AssertionError(f"resume rewrote reused artifacts: {touched}")
    report["kernel_launches"] = rebuilt
    return report


def routed_check(torch, fa, collection: str, device=None) -> dict:
    """Phase 14c: ``PLANE_REPLICAS`` `run-server` replicas over one shard
    manifest and a `run-router`, each a subprocess; phase 11's fleet
    requests through the router bitwise against one unsharded server (in
    this process, as phase 11's), each replica's forward launches and
    scorers within its shard, a 421 from the wrong replica, a stream
    through the router against a direct one, and a replica killed: its
    shard transient until ejected, then failover, bitwise again."""
    import numpy as np

    from gordo_tpu_torch import serializer
    from gordo_tpu_torch.data import _get_dataset
    from gordo_tpu_torch.data.base import to_datetimes
    from gordo_tpu_torch.router.ring import HashRing
    from gordo_tpu_torch.server.app import build_app
    from gordo_tpu_torch.server.catalog import write_shard_manifest

    root = os.path.dirname(os.path.abspath(__file__))
    n_layers = BASE_ESTIMATOR["n_layers"]
    transformers = [f"{MACHINE}-{i}" for i in range(FLEET_TRANSFORMERS)]
    ring = HashRing(PLANE_REPLICAS)
    shards = ring.partition(transformers)
    data = {}
    for name in transformers:
        metadata = serializer.load_metadata(os.path.join(collection, name))
        X, _, stamps = _get_dataset(metadata["dataset"]).get_data()
        keys = [stamp.isoformat() for stamp in to_datetimes(stamps.astype(np.int64))]
        data[name] = (np.asarray(X), keys, metadata["dataset"]["tag_list"])

    def body(n_rows, start=0):
        return {"machines": {n: {"X": frame_of(X, k, t, slice(start, start + n_rows)),
                                 "y": frame_of(X, k, t, slice(start, start + n_rows))}
                             for n, (X, k, t) in data.items()}}

    report = {"shards": shards}
    workdir = tempfile.mkdtemp(prefix="plane-")
    manifest = write_shard_manifest(os.path.join(workdir, "manifest.json"), PLANE_REPLICAS)
    ports = {rid: free_port() for rid in PLANE_REPLICAS}
    router_port = free_port()
    processes = {}
    try:
        t0 = time.perf_counter()
        for rid in PLANE_REPLICAS:
            processes[rid] = subprocess.Popen(
                [sys.executable, "-c", REPLICA_DRIVER, os.path.join(workdir, f"{rid}.json"),
                 "run-server", "--collection-dir", collection, "--host", "127.0.0.1",
                 "--port", str(ports[rid]), "--batch-wait-ms", "0", "--shard-manifest",
                 manifest, "--replica-id", rid, *(["--device", device] if device else [])],
                cwd=root, stdout=subprocess.DEVNULL, stderr=open(
                    os.path.join(workdir, f"{rid}.log"), "w"))
        processes["router"] = subprocess.Popen(
            [sys.executable, "-m", "gordo_tpu_torch.cli", "run-router", "--host", "127.0.0.1",
             "--port", str(router_port), "--collection-dir", collection,
             *[arg for rid in PLANE_REPLICAS
               for arg in ("--replica", f"{rid}=http://127.0.0.1:{ports[rid]}")]],
            cwd=root, stdout=subprocess.DEVNULL,
            stderr=open(os.path.join(workdir, "router.log"), "w"))
        for rid in PLANE_REPLICAS:
            wait_ready(f"http://127.0.0.1:{ports[rid]}/healthz", processes[rid])
        wait_ready(f"http://127.0.0.1:{router_port}/healthz", processes["router"])
        report["start_s"] = time.perf_counter() - t0
        log("plane up in", report["start_s"], "s; shards", json.dumps(shards))
        routed = f"http://127.0.0.1:{router_port}/gordo/v0/{PROJECT}"

        single = build_app(collection, device=device, batch_wait_ms=0)
        with http_server(collection, None, app=single) as direct:
            payloads = {n: json.dumps(body(n)).encode() for n in SERVE_ROWS}
            want = {n: post(f"{direct}/anomaly/prediction/fleet", payloads[n])[0]["data"]
                    for n in SERVE_ROWS}
            before = {rid: replica_counts(processes[rid], os.path.join(workdir, f"{rid}.json"))
                      ["kernels"] for rid in PLANE_REPLICAS}
            latency = {}
            for n_rows in SERVE_ROWS:
                got, seconds = post(f"{routed}/anomaly/prediction/fleet", payloads[n_rows])
                if got["data"] != want[n_rows]:
                    worst = max(block_rel_diff(got["data"][m], want[n_rows][m], 0.0, 1.0)
                                for m in transformers)
                    raise AssertionError(f"{n_rows} rows through the router differ from one "
                                         f"server by up to {worst}")
                latency[n_rows] = {"routed_s": [seconds], "direct_s": []}
            after = {rid: replica_counts(processes[rid], os.path.join(workdir, f"{rid}.json"))
                     for rid in PLANE_REPLICAS}
            # the main path, through the router: each replica's launches from 0
            launches = {rid: {k: after[rid]["kernels"][k] - before[rid][k] for k in before[rid]}
                        for rid in PLANE_REPLICAS}
            report["replica_launches"] = launches
            report["replica_scorers"] = {rid: after[rid]["scorers"] for rid in PLANE_REPLICAS}
            report["kernel_launches"] = {k: sum(launches[rid][k] for rid in PLANE_REPLICAS)
                                         for k in launches[PLANE_REPLICAS[0]]}
            everything = [m["name"] for m in fleet_machines(root)]
            for rid in PLANE_REPLICAS:
                mine = ring.shard(everything, rid)
                forward = sum(v for k, v in launches[rid].items() if k.startswith(fa.KERNEL + "_"))
                backward = launches[rid][f"{fa.KERNEL_DQ}_quad"] + launches[rid][
                    f"{fa.KERNEL_DKV}_quad"]
                # at least one stacked forward a layer for each request its
                # shard's Transformers are in, none for a shard without them
                scorers = after[rid]["scorers"]
                if (forward >= n_layers * len(SERVE_ROWS)) != (rid in shards) or backward \
                        or not scorers or any(set(s) - mine for s in scorers):
                    raise AssertionError(f"replica {rid}: {launches[rid]} launches, scorers "
                                         f"{scorers}, shard {sorted(mine)}")
            for n_rows in SERVE_ROWS:
                for _ in range(PLANE_ROUTED_REPEATS - 1):
                    latency[n_rows]["routed_s"].append(
                        post(f"{routed}/anomaly/prediction/fleet", payloads[n_rows])[1])
                for _ in range(PLANE_ROUTED_REPEATS):
                    latency[n_rows]["direct_s"].append(
                        post(f"{direct}/anomaly/prediction/fleet", payloads[n_rows])[1])
                latency[n_rows]["routed_median_s"] = statistics.median(latency[n_rows]["routed_s"])
                latency[n_rows]["direct_median_s"] = statistics.median(latency[n_rows]["direct_s"])
            report["latency"] = latency
            log("routed latency", json.dumps(latency))

            # a machine sent straight to a replica that does not own it
            name = transformers[0]
            owner = ring.owner(name)
            wrong = next(r for r in PLANE_REPLICAS if r != owner)
            status, refused, _ = request_json(
                f"http://127.0.0.1:{ports[wrong]}/gordo/v0/{PROJECT}/anomaly/prediction/fleet",
                {"machines": {name: body(144)["machines"][name]}})
            report["wrong_replica"] = {"status": status, "body": refused}
            if status != 421 or refused["wrong_shard"] != {name: {"owner": owner}}:
                raise AssertionError(f"the wrong replica answered {status}: {refused}")

            # a stream through the router against a direct one
            def stream(base):
                status, opened, _ = request_json(f"{base}/stream/open", {"machines": transformers})
                if status != 201:
                    raise AssertionError(f"stream/open answered {status}: {opened}")
                scores = []
                for start, k in ((0, STREAM_FIRST), (STREAM_FIRST, STREAM_UPDATE)):
                    status, got, seconds = request_json(
                        f"{base}/stream/{opened['session']}/update",
                        {"updates": {n: {"rows": data[n][0][start:start + k].tolist(),
                                         "seq": start} for n in transformers}})
                    if status != 200:
                        raise AssertionError(f"stream update answered {status}: {got}")
                    scores.append(got["scores"])
                request_json(f"{base}/stream/{opened['session']}/close")
                return scores, seconds

            direct_stream, _ = stream(direct)
            routed_stream, stream_s = stream(routed)
            report["stream"] = {"bitwise_equal": routed_stream == direct_stream,
                                "update_s": stream_s}
            if routed_stream != direct_stream:
                raise AssertionError("the stream through the router differs from the direct one")

            # a replica dies: its shard transient until ejected, then failover
            victim = max(shards, key=lambda rid: len(shards[rid]))
            processes[victim].kill()
            processes[victim].wait(timeout=30)
            t0 = time.perf_counter()
            statuses = []
            for _ in range(6):
                status, got, _ = request_json(f"{routed}/anomaly/prediction/fleet", body(144))
                statuses.append(status)
                if status == 200:
                    break
                if not (status == 409 and got.get("transient") is True
                        and set(got["unavailable"]) == set(shards[victim])):
                    raise AssertionError(f"while {victim} was down: {status} {got}")
            report["failover"] = {"victim": victim, "statuses": statuses,
                                  "seconds": time.perf_counter() - t0}
            log("failover", json.dumps(report["failover"]))
            if statuses[0] != 409 or statuses[-1] != 200 or got["data"] != want[144]:
                raise AssertionError(f"failover: {report['failover']}")
    finally:
        for process in processes.values():
            if process.poll() is None:
                process.terminate()
        for process in processes.values():
            try:
                process.wait(timeout=30)
            except subprocess.TimeoutExpired:
                process.kill()
                process.wait(timeout=30)
    return report


def plane_phase(torch, fa, profile: bool, collection: str, device=None):
    """Phase 14: the sweep (14a), resumed fits and builds (14b) and the
    routed plane (14c), the module docstring's; on the card unless
    ``device`` names another (a rehearsal)."""
    root = os.path.dirname(os.path.abspath(__file__))
    report = {}
    t0 = time.perf_counter()
    report["sweep"] = sweep_check(torch, fa, root, device)
    report["sweep"]["phase_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    report["routed"] = routed_check(torch, fa, collection, device)
    report["routed"]["phase_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    report["resume_fit"] = resume_fit_check(torch, fa, collection, device)
    report["resume_build"] = resume_build_check(collection, device)
    report["resume_build"]["phase_s"] = time.perf_counter() - t0
    return report


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
    with tempfile.TemporaryDirectory() as fleet_dir:
        fleet = timed("fleet_build", fleet_build_phase, args.profile, fleet_dir)
        fleet_serve = timed("fleet_serve", fleet_serve_phase, args.profile, fleet["collection"])
        options = timed("build_options", build_options_phase, args.profile)
        lake_stream = timed("lake_stream", lake_stream_phase, args.profile, fleet["collection"])
        plane = timed("plane", plane_phase, args.profile, fleet["collection"])

    def check(kernel, case, rows):
        return next(r for r in rows if r.get("kernel", fa.KERNEL) == kernel and r["case"] == case)

    # each path's launches by CUDA kernel, counted from 0 just before it
    paths = {"serve": report["kernel_launches"], "train": train["kernel_launches"],
             "serve_trained": train["served"]["kernel_launches"],
             "default_pipeline": default_pipeline["kernel_launches"],
             "recurrent": recurrent["kernel_launches"],
             "project_build": project["kernel_launches"],
             "fleet_build": fleet["kernel_launches"],
             "fleet_serve": fleet_serve["kernel_launches"],
             "bf16_fleet_build": fleet_serve["bf16"]["build_launches"],
             "bf16_fleet_serve": fleet_serve["bf16"]["kernel_launches"],
             "build_options": options["kernel_launches"],
             "remat_served": options["remat_served"]["kernel_launches"],
             "remat_bf16": options["remat_bf16"]["kernel_launches"],
             "lake_build": lake_stream["lake_build"]["kernel_launches"],
             "stream": lake_stream["stream"]["kernel_launches"],
             "sweep": plane["sweep"]["kernel_launches"],
             "resume_fit": plane["resume_fit"]["kernel_launches"],
             "resume_build": plane["resume_build"]["kernel_launches"],
             "routed": plane["routed"]["kernel_launches"],
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
            entry(fa.KERNEL, earlier, fwd_source, fwd_tpu,
                  ("model-shape", *(name for name, _ in FLEET_SERVE_CASES), *WIDE_ROWS), checks),
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
                 "fleet_serve": fleet_serve, "build_options": options,
                 "lake_stream": lake_stream, "plane": plane,
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
