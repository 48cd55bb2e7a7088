#!/usr/bin/env python3
"""
Smoke run of the PyTorch/CUDA port (``gordo_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--out results.json] [--profile]

Phases, each raising on failure (no result line is printed then):

1. the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel from ``gordo_tpu_torch/csrc`` with nvcc for
   sm_90a, one nvcc per source, all started together (each source's nvcc
   seconds and the whole build's are printed), while phases 6, 8 and 9,
   whose paths launch no flash kernel, run;
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
   card from the first 76 days of its dataset span (2019-01-01 to
   2019-06-01 at 10 minutes: 10 944 rows of seeded daily sinusoids plus
   noise, cut from the span's 21 744) with the evaluation
   defaults (TimeSeriesSplit(3) cross-validation with the four metrics,
   its three folds trained at once as one fleet fit, thresholds, then the
   fit), 2 epochs where the config has 10 (the build's eager steps are
   host-bound: on a slow host 10 epochs took 265 s, over the phase's
   3-minute budget, and 5 took 108 s of a 639 s script; the phase holds
   the loss to fall, so 1 epoch would not do); launch counts reset just before and read just after
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
   (8206 rows at 10 minutes, as the port's data layer gives: the first
   57 of 114 days; 1 epoch where bench.py trains 3), served over HTTP on the card with 144 rows
   (medians of 5; the whole-history requests were cut, the last one when
   phase 16 took the script past 800 s), each reply within 1e-4 of the
   CPU's;
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
   (medians of 5; the whole-history requests cut with phase 8's), each
   reply within 1e-4 (TCN) or 1e-5 of the CPU's; build, CV and fit seconds, the TCN's training step,
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
   then ``build-fleet --precision auto`` of ``BF16_MACHINES`` (2012 and 2017 rows,
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
   phase 10's first Transformer (full width, flash, its first
   ``PLANE_SWEEP_DAYS`` days, 1 epoch where the config has 10) in this
   process: each trial's loss,
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
   then ``build-fleet --resume`` over phase 10's directory in this
   process (all eight machines reused, no launch) and again with one
   Transformer's artifact removed (only it rebuilt, 1 epoch as in phase
   10; the other artifacts untouched), seconds and launches of each run;
15. lifecycle: a copy of phase 10's collection as ``models/<revision>``
   plus a ``latest`` symlink, every tick over ``LIFECYCLE_WINDOW`` (the
   span's last 28 days, 4032 rows a machine; widths as the config's):
   (a) a dry tick (``--no-promote``, thresholds no machine passes) on the
   card and on the CPU: each Transformer's ratio (card within 1e-4 of
   CPU) and exceedance (within one row's share), the monitored list, and
   flash forward launches only; (b) ``python -m gordo_tpu_torch.cli lifecycle tick`` in a
   subprocess with ``GORDO_FAULT_INJECT`` shifting three of the four
   Transformers, degrading the second's candidate and poisoning the
   third's refit at epoch 0 (the thresholds the defaults, or, when (a)
   found a clean machine over them, twice its largest ratio and halfway
   from its largest exceedance to 1, printed): the three drifted, the
   first promoted, the second rejected, the third quarantined; the
   refit's launches (forward, dq and dk/dv) apart from the scan's and the
   shadow gate's (forward only); a new revision whose retained artifacts
   are hard links, and ``latest`` flipped; the port's server on ``latest``
   (in this process), asked before and after: the promoted machine's
   reply changed, the retained machines' bitwise the same, the
   quarantined machine 409; (c) a ``promote:torn`` tick: ``latest``
   untouched, the ``.promote-*`` directory left; (d) the first
   Transformer streamed over the window through that server with the
   event log on, then a tick fed by the log: that machine assessed from
   the stream (``source: stream``) with no window fetch, its ratio within
   1e-4 of a scan of the same rows and its exceedance within a row;
16. the client: phase 10's collection served in this process on the card
   with ``/metrics`` on, and the port's ``Client``: (a) ``predict`` of the
   four Transformers over ``CLIENT_SPAN`` (one day, ``CLIENT_BATCH`` rows
   a POST: 2 chunks a machine), each frame within ``CLIENT_RTOL`` of
   direct ``/anomaly/prediction`` POSTs of the same chunk rows, the
   forward kernel launched 2 layers x chunks x machines, no dq or dk/dv;
   (b) ``predict_fleet(group_size=4)``, within 1e-4 / 1e-5 of (a), the
   forward 2 x chunks; (c) ``stream_machine`` of the first Transformer
   over 8255 rows with its session closed by the server after
   ``CLIENT_STREAM_CUT`` updates: one reconnect, the outputs bitwise a
   direct session's, the forward 2 a scored update; (d) the command
   line's ``client ... predict --output-dir`` and ``metadata`` in one
   subprocess with no card (``CUDA_VISIBLE_DEVICES=""``), files as (a)'s;
   (e) ``/metrics``: the request count the requests sent, the phase
   ledger's server phases; (f) one traced prediction: the trace id
   echoed, each ``server.request`` span under the client's
   ``client.request``, ``trace export`` Chrome-trace JSON; (g) tracing's
   and the ledger's cost (``measure_overhead``) and a 144-row request's
   wall ms with the ledger on and off (``GORDO_PHASE_LEDGER=0``); (h) the
   wall seconds of (a), (b) and the direct POSTs;
17. the build plane, run beside phase 12 (after phase 11) over phase 10's
   machine list (three
   exact buckets: three ledger units): (a) ``buckets plan`` under
   ``exact`` and ``padded`` in a subprocess with no card, the exact plan's
   buckets the units the ledger publishes; (b) ``build-fleet --workers 2
   --lease-ttl 3`` on the card into a fresh directory with
   ``GORDO_FAULT_INJECT=worker:die:fetch@worker:0`` (worker 0 dies once
   it has leased its first unit, before fetching its data; worker 1
   steals the unit once its lease is 3 s stale and builds it), with the
   event log and the span log on; (c) every unit done, the dead worker's in 2
   attempts (``--ledger-status``), no casualty, the build report's counts
   phase 10's, every ``params.npz`` bitwise phase 10's one-process
   artifact's (else the largest difference and the reason, asserted at
   ``BUILD_PLANE_ATOL``), the events ``worker_started``,
   ``fault_injected``, ``lease_stolen``, ``ledger_finalized`` and
   ``worker_finished``, and the worker that committed the Transformer
   unit launching the forward, dq and dk/dv kernels exactly phase 10's
   counts (each live worker writes its counts to its own report,
   ``.ledger/telemetry/<worker>.json``); (d) ``telemetry summarize
   --as-json`` over the directory: models built, casualties, each
   bucket's peak device memory, the ledger section; (e) the span log:
   ``build.fleet`` > ``build.bucket`` > ``build.cv`` / ``build.fit`` >
   ``train.dispatch``, read back by ``trace summarize``; (f) the two-worker
   build's wall seconds beside phase 10's one-process wall (nothing
   asserted on them);
18. tuning and the plane, over phase 10's collection and list: (a)
   ``PLANE_REPLICAS`` ``run-server`` replicas over one shard manifest and
   ``run-router --rollup-interval 1 --rollup-persist``, each a
   subprocess; phase 11's 144-row fleet request through the router
   ``TUNING_REQUESTS`` times, ``TUNING_REQUEST_GAP`` s apart, each reply
   bitwise one unsharded server's,
   each replica's forward launches phase 14c's for each request (one a
   layer for a shard with Transformers) and no backward; after two more
   polls the router's ``/status``, ``/metrics`` and ``/telemetry/snapshot``
   answer 200, the merged predict count equals the sum of the replicas'
   own, the router's ok count the requests sent, and the persisted rollup
   holds stamped merges; (b) ``slo check`` of ``TUNING_SLO`` (p99 latency,
   error rate) over the router's URL and over the rollup file, both
   passing, ``top --once --as-json`` and ``rollup --once`` over the
   replicas; (c) ``tune calibrate`` with ``TUNING_CALIBRATE`` on the card
   (in this process, as (b) and (d)): the chunk rows' losses bitwise the
   smallest chunk's, both batch-wait arms answered; (d) ``tune plan --as-json`` and
   ``tune fit`` over phase 10's collection, the rollup file and (c)'s
   directory into a fresh directory, each recommendation printed with its
   source and evidence, none of a knob the port lacks, ``tune plan
   --check`` passing; (e) ``build-fleet`` of phase 10's four Transformers
   (its Transformer unit only) into that directory on the card, in this
   process, launches counted from its start: one
   ``tuning_profile_loaded`` event naming the profile's builder and ledger
   recommendations, the forward, dq and dk/dv kernels launched phase 10's
   counts, every ``params.npz`` bitwise phase 10's when only scheduling
   knobs applied (else the largest difference and the knobs; phase 10
   keeps a copy of its Transformers' params, which phase 14b rebuilds);
   (f) ``run-server`` on that directory, and another with
   ``GORDO_BATCH_WAIT_MS`` set, both subprocesses on the card started
   during (e): each
   reply bitwise a server's with no profile, the first's event naming
   the profile's server recommendations, the second's leaving
   ``batch_wait_ms`` to the environment;
19. game days: (a) ``PLANE_REPLICAS`` ``run-server`` replicas (batching
   at ``FAULT_BATCH_WAIT_MS``) and a ``run-router`` (a replica ejected
   after one failure, windows scaled by ``FAULT_BACKOFF_SCALE``), each a
   subprocess over phase 10's collection with one
   ``GORDO_FAULT_INJECT_FILE``, armed while they run: ``serve:raise`` on a
   machine answers 503 ``Fault injection`` on its routes and only there;
   ``batch:raise`` fails only that request of four concurrent ones in one
   batch; ``replica:die@attempts:2`` gives transient 409s naming the
   replica's machines, then failover, each 200 bitwise the direct
   server's; ``replica:flap@burst:3`` ejects and recovers
   (``replica_ejected``, ``shard_failover``, ``replica_recovered`` in the
   router's event log); a Transformer stream of the port's client through
   the router under ``stream:drop`` reconnects once and is bitwise a
   direct session's; ``stream:burst`` answers 503 with ``Retry-After``;
   the firings by site, the ``gordo_serve_group_*``, ``gordo_stream_*``
   and router-plane ``gordo_phase_seconds`` series, and the replicas'
   forward launches (the ``fault_plane`` path; no backward); (b)
   ``python -m gordo_tpu_torch.cli gameday run --output`` in a subprocess
   on the card: every runnable scenario ``ok`` (its SLO budget, no
   unstructured error, its expectations, its streams bitwise its
   one-shots) and ``rolling-upgrade`` skipped; ``gameday run
   rolling-upgrade`` exits 2 naming ``programs/``;
20. the profilers and the multi-chip paths: (a) ``python -m
   gordo_tpu_torch.cli build`` of the config's Transformer with
   ``GORDO_TPU_PROFILE_DIR`` in a subprocess on the card: its
   ``torch.profiler`` Chrome trace names the forward, dq and dk/dv quad
   kernels (their device ms read from the trace's kernel events) and the
   ``data-fetch``, ``cross-validation``, ``fit`` and ``train-dispatch``
   ranges; meanwhile two ``run-server`` subprocesses over phase 10's
   collection, one with ``GORDO_PROFILE_HZ``, answer the same 144-row
   fleet request in turn (each one's median printed), and the sampled one,
   stopped with SIGTERM, exits 0 having written its dump, which ``profile
   report`` and ``profile flame`` render (exit 0, server-plane phases,
   samples above 0; the server's forward launches are the
   ``sampled_server`` path); (b) ``distributed.initialize`` with an
   explicit coordinator, one process, rank 0, on NCCL: data-parallel
   steps of the turbine Transformer (flash) with ``zero1`` off and on
   (equal; forward, dq and dk/dv launched: the ``data_parallel`` paths)
   held to the same steps on the CPU within 1e-4, then long-context steps
   with ring and with Ulysses attention (remat) on windows of 8192, the
   first loss equal to the local dense twin's, with peak allocated memory;
21. one JSON line of per-kernel numbers, each time with the timer that
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
import concurrent.futures
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
# the machine's dataset span starts here (2019-01-01; it ends 2019-06-01), 10 minutes a row
TRAIN_START = datetime(2019, 1, 1, tzinfo=timezone.utc)
TRAIN_ROWS = 76 * 144
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
# dims 42/33/25/25/33/42) at the same lookback and batch. The data: 57
# days at 10 minutes (8206 rows) of a RandomDataProvider's seeded samples,
# 8200 a tag, cut from 114 days (16 414 rows; the LSTM's and GRU's builds
# took 32.6 and 42.2 s at once on an H100 whose host ran 1.4x slow, with phase 19 in the
# script). A RandomDataset's provider draws 100-300 samples a tag, which
# leaves no row with all 50 tags at this span. Epochs: 1, cut from
# bench.py's 3 (on an H100 at 3 epochs the two builds took 47 and 69 s,
# most of the phase's budget of about 2 minutes); widths and batch are
# not cut.
PLANT_TAGS = [f"GRA-TAG {i}" for i in range(1, 51)]
_PLANT_DATASET = json.loads(r"""{"train_start_date": "2019-01-01T00:00:00+00:00",
 "train_end_date": "2019-02-27T00:00:00+00:00", "data_provider": {"type": "RandomDataProvider",
 "min_size": 8200, "max_size": 8200}, "resolution": "10T", "row_filter": "",
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
# rows the data layer gives each (the JAX data layer gives 16 414 at the whole
# span, tests/test_torch_cli.py)
RECURRENT_ROWS = 8206
#: a windowed net's timed training steps, synchronised and back to back
#: (phases 8 and 9; 10 of each before the cuts for phase 19)
WINDOW_TIMED_STEPS = 5
RECURRENT_COLLECTION = "1700000000003"
# timed whole-history requests of the phase-8 machines, cut from REPEATS
# each to 3, then to one request of the LSTM when phase 11 took the script
# past 600 s, then to none when phase 16 took it past 800 s (982 s on a
# slow host, where the LSTM's request and its CPU comparison took 27 s)
RECURRENT_HISTORY_REPEATS: dict = {}
# timed whole-history requests of phase 9's machines, cut from REPEATS for
# the same reasons (the TCN's and its CPU comparison took 22 s there)
PROJECT_HISTORY_REPEATS = 0
# training batch of the 50-tag plant machines (phases 8 and 9)
PLANT_BATCH = 512

# Phase 9's project, built in one process by the port's local_build:
# - tcn-plant-50: a DiffBasedAnomalyDetector(TCNAutoEncoder) at the
#   factory's full width (channels 64/64/64, kernel 3, dilations 1/2/4,
#   dropout 0.1, relu) over phase 8's 50-tag plant data (8206 rows at 10
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
      data_provider: {{type: RandomDataProvider, min_size: 8200, max_size: 8200}}
      tags: [{", ".join(PLANT_TAGS)}]
      train_start_date: '2019-01-01T00:00:00+00:00'
      train_end_date: '2019-02-27T00:00:00+00:00'
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
# Phase 17: `build-fleet --workers BUILD_PLANE_WORKERS` of phase 10's list
# with worker 0 killed at its first fetch (at its first commit the
# Transformer unit, when worker 0 took it, was built twice: 137 s on a slow
# host); a lease goes stale after BUILD_PLANE_TTL seconds without a
# heartbeat
BUILD_PLANE_WORKERS = 2
BUILD_PLANE_TTL = 3
BUILD_PLANE_FAULT = "worker:die:fetch@worker:0"
BUILD_PLANE_EVENTS = ("worker_started", "fault_injected", "lease_stolen", "ledger_finalized",
                      "worker_finished")
# the bound on a weight of the two-worker build against phase 10's when
# not bitwise equal
BUILD_PLANE_ATOL = 1e-6
# runs each argv of a JSON list through the port's command line in one
# process and prints each one's exit code and standard output as JSON
CLI_CAPTURE_DRIVER = (
    "import contextlib, io, json, sys\n"
    "from gordo_tpu_torch.cli.cli import main\n"
    "out = []\n"
    "for argv in json.loads(sys.argv[1]):\n"
    "    buffer = io.StringIO()\n"
    "    with contextlib.redirect_stdout(buffer):\n"
    "        code = main(argv)\n"
    "    out.append([code, buffer.getvalue()])\n"
    "print(json.dumps(out))\n"
)

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
# 2016 samples a tag, which the data layer makes 2012 and 2017 rows: a
# tag's empty first buckets drop out; cut from the config's 151 days, and
# from 28 once phase 20 came in; 1
# epoch where the config has 10, as phase 10 cuts): the config's model
# (float32 layers) and the same model computing in bfloat16 (`dtype:
# bfloat16`), one bucket each, served from the card
SERVE_ROWS = (144, 8255)
SERVE_CLIENTS = 8
#: the Transformers of phase 11's 8255-row request also run on the CPU
#: and are held to the card's reply
CPU_WHOLE_HISTORY_MACHINES = 1
SERVE_ROUNDS = 3
# timed 8255-row fleet requests (each with four whole-history frames of JSON)
WHOLE_HISTORY_REPEATS = 2
BATCH_WAIT_MS = 5.0
BF16_COLLECTION = "1700000000006"
BF16_DAYS = 14
BF16_ROWS = (2008, 2017)  # the least and most rows a machine may have
BF16_MACHINES = (f"{MACHINE}-bf16-0", f"{MACHINE}-bf16-1")
# the quad forward at phase 11's folded fleet-serve shapes: four machines'
# windows in one batch, 144 rows padded to 256 (193 windows each) and 8255
# rows padded to 16 384 (16 321 windows each)
FLEET_SERVE_CASES = (("fleet-serve-144", (4 * 193, 64, 4, 16)),
                     ("fleet-serve-8255", (4 * 16321, 64, 4, 16)))

# Phase 12: the build options of a machine config. The Transformer
# machine reads OPTIONS_SAMPLES_A_DAY samples a day of seeded daily
# sinusoids plus noise a tag over the first OPTIONS_DAYS days of the
# config's span (2019-01-01 to 2019-06-01; its 151 days took the
# Transformer's build 44.5 s on an H100 whose host ran 1.4x slow), written as CSV files in the
# file-system provider's layout
# (<lake>/gra/<tag>/<tag>_2019.csv), with a spike planted every
# OPTIONS_SPIKE_EVERY samples for the period filter to find, and builds 1
# epoch where the config has 10 (each build of phase 12 cross-validates
# with three folds trained one after another, KFold's training rows not
# being one run); widths are the config's.
OPTIONS_COLLECTION = "1700000000007"
OPTIONS_DAYS = 76
OPTIONS_END = "2019-03-18T00:00:00+00:00"  # OPTIONS_PROJECT's train_end_date
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
      train_end_date: '2019-03-18T00:00:00+00:00'
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
# samples over LAKE_DAYS days of the config's span, phase 12's spikes), with LAKE_DUPLICATES
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
LAKE_STRAY_DAY = datetime(2019, 3, 27, tzinfo=timezone.utc)
# the lake's days from the span's start (2019-01-01), cut from the config's
# 151 (the build read 21 092 rows in 49.6 s on an H100 whose host ran 1.4x slow); the window
# ends at LAKE_END
LAKE_DAYS = 76
LAKE_END = "2019-03-18T00:00:00+00:00"
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
      train_end_date: '{end}'
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


class _ThreadStdout:
    """``sys.stdout`` for a smoke whose phases run in threads: a thread's
    writes go to the stream it captures into (:func:`captured_stdout`),
    any other thread's to the real standard output. ``redirect_stdout``
    swaps ``sys.stdout`` for the whole process, so a capture in one
    thread would take another thread's lines."""

    def __init__(self, real):
        self.real = real
        self.local = threading.local()

    def _stream(self):
        return getattr(self.local, "stream", None) or self.real

    def write(self, text):
        return self._stream().write(text)

    def flush(self):
        self._stream().flush()

    def __getattr__(self, name):
        return getattr(self.real, name)


@contextlib.contextmanager
def captured_stdout(stream):
    """This thread's standard output into ``stream``; other threads'
    writes go on to the real standard output."""
    if not isinstance(sys.stdout, _ThreadStdout):
        sys.stdout = _ThreadStdout(sys.stdout)
    local = sys.stdout.local
    previous = getattr(local, "stream", None)
    local.stream = stream
    try:
        yield stream
    finally:
        local.stream = previous


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


def device_ms(fn, reps: int = 20, warmup: int = 3, tries: int = 1):
    """(milliseconds per call of ``fn``, the timer that measured them).
    With ``"profiler"``: the device time of every kernel its ``reps``
    calls launched (torch.profiler), over ``reps``; unlike CUDA events
    around a call, the host's gaps between launches do not count, so a
    small kernel's own time shows. A trace often misses some or all of
    its kernels (a kernel's count is then not a multiple of ``reps``); it
    is taken again, up to ``tries`` times (one by default: with three, most
    of the kernel checks' timings missed on every try, and each try costs
    a profiler session),
    and then the time is ``time_ms``'s, named ``"events"``: it counts those
    gaps too, so it is not a device time."""
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
        # both builds at once: each process is mostly its own start-up
        built = cli_builds(root, [(machines[name].to_dict(), os.path.join(collection, name))
                                  for name in DEFAULT_ROWS])
        for name in DEFAULT_ROWS:
            machine = machines[name].to_dict()
            artifact = os.path.join(collection, name)
            wall_s, build_log = built[name]
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


def cli_builds(root: str, jobs) -> dict:
    """``python -m gordo_tpu_torch.cli build`` of each ``(machine,
    artifact)`` of ``jobs`` (``MACHINE`` its YAML text) in subprocesses on
    the card, all started at once: {name: (wall seconds, the log's fetch,
    cross-validation and fit lines)}. Raises unless each exits 0 having
    fitted on the card."""
    started = {}
    for machine, artifact in jobs:
        env = dict(os.environ, MACHINE=yaml_text(machine), OUTPUT_DIR=artifact)
        env.pop("GORDO_TPU_LAKE_DIR", None)
        err = tempfile.TemporaryFile(mode="w+")
        started[machine["name"]] = (time.perf_counter(), err, subprocess.Popen(
            [sys.executable, "-m", "gordo_tpu_torch.cli", "build"],
            cwd=root, env=env, stdout=subprocess.DEVNULL, stderr=err, text=True))
    out = {}
    try:
        for name, (t0, err, process) in started.items():
            code = process.wait(timeout=300)
            wall_s = time.perf_counter() - t0
            err.seek(0)
            stderr = err.read()
            if code != 0:
                raise AssertionError(f"build {name} exited {code}:\n{stderr[-4000:]}")
            if "model parameters on cuda" not in stderr:
                raise AssertionError(f"build {name} did not fit on the card:\n{stderr}")
            out[name] = (wall_s, [line for line in stderr.splitlines()
                                  if "Fetched" in line or "Cross-validated" in line
                                  or "Fitted" in line])
    finally:
        for _, err, process in started.values():
            if process.poll() is None:
                process.kill()
                process.wait(timeout=30)
            err.close()
    return out


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
        # the two builds at once (each host-bound, on its own cores)
        built = cli_builds(root, [(machine, os.path.join(collection, name))
                                  for name, machine in RECURRENT_MACHINES.items()])
        for name, machine in RECURRENT_MACHINES.items():
            artifact = os.path.join(collection, name)
            wall_s, build_log = built[name]
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
    width on the card: the median host-clock time of ``WINDOW_TIMED_STEPS``
    steps each ended by a synchronise, as many back to back as the fit
    runs them, and a
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
    for _ in range(WINDOW_TIMED_STEPS):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        synced.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    for _ in range(WINDOW_TIMED_STEPS):
        step()
    torch.cuda.synchronize()
    back_to_back_ms = (time.perf_counter() - t0) * 1e3 / WINDOW_TIMED_STEPS
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
        if workdir:
            # later phases rebuild machines in place (phase 14b): phase 18
            # holds its tuned build to these
            import shutil

            kept = os.path.join(tmp, "phase10-params")
            os.makedirs(kept)
            for name in (f"{MACHINE}-{i}" for i in range(FLEET_TRANSFORMERS)):
                shutil.copy(os.path.join(collection, name, "params.npz"),
                            os.path.join(kept, f"{name}.npz"))
            report["transformer_params"] = kept
        Xs = [np.asarray(_get_dataset(m["dataset"]).get_data()[0], dtype=np.float32)
              for m in machines[:FLEET_TRANSFORMERS]]
    report["vmapped_flash"] = fleet_flash_check(torch, fa)
    report["step_parity"] = fleet_step_check(torch, fa, Xs)
    report["step_timing"] = time_fleet_steps(torch, Xs)
    return report


def cli_output(argv) -> str:
    """The standard output of the port's command line run in this
    process (``main`` must exit 0)."""
    import io

    from gordo_tpu_torch.cli.cli import main

    buffer = io.StringIO()
    with captured_stdout(buffer):
        code = main(argv)
    if code != 0:
        raise AssertionError(f"{argv[:2]} exited {code}:\n{buffer.getvalue()[-2000:]}")
    return buffer.getvalue()


def npz_arrays(path: str) -> dict:
    import numpy as np

    with np.load(path, allow_pickle=False) as npz:
        return {name: npz[name] for name in npz.files}


def span_tree_ok(spans: list) -> bool:
    """Whether some ``build.fleet`` span has a ``build.bucket`` child with
    a ``build.cv`` and a ``build.fit`` child, each over a
    ``train.dispatch``."""
    children: dict = {}
    for span in spans:
        children.setdefault(span.get("parent_span_id"), []).append(span)

    def named(span, name):
        return [c for c in children.get(span["span_id"], []) if c["name"] == name]

    return any(
        all(any(named(stage, "train.dispatch") for stage in named(bucket, name))
            for name in ("build.cv", "build.fit"))
        for root in spans if root["name"] == "build.fleet"
        for bucket in named(root, "build.bucket")
    )


def build_plane_phase(torch, fa, profile: bool, fleet: dict, device=None):
    """Phase 17 (the module docstring's): phase 10's list built again by
    two ledger workers on the card (``device`` for a rehearsal elsewhere),
    one of them killed at its first fetch, held to phase 10's
    one-process collection ``fleet["collection"]``."""
    import numpy as np

    from gordo_tpu_torch.builder import ledger

    root = os.path.dirname(os.path.abspath(__file__))
    collection = fleet["collection"]
    workdir = os.path.dirname(collection)
    listing = os.path.join(workdir, "machines.yaml")
    output = os.path.join(workdir, "build-plane")
    events = os.path.join(output, "events.jsonl")
    spans = os.path.join(workdir, "build-plane-spans.jsonl")
    device_args = ["--device", device] if device else []
    report = {}

    # (a) the plans, in a process with no card, run while (b) builds
    t_plan = time.perf_counter()
    planner = subprocess.Popen(
        [sys.executable, "-c", CLI_CAPTURE_DRIVER, json.dumps([
            ["buckets", "plan", "--machines-from", listing, "--bucket-policy", policy,
             "--as-json"] for policy in ("exact", "padded")])],
        cwd=root, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
    )

    # (b) two ledger workers, worker 0 killed at its first fetch
    env = {k: v for k, v in os.environ.items() if k not in ("MACHINES", "GORDO_WORKER_ID")}
    env.update(OUTPUT_DIR=output, GORDO_FAULT_INJECT=BUILD_PLANE_FAULT,
               GORDO_TPU_EVENT_LOG=events, GORDO_TPU_TRACE_LOG=spans)
    t0 = time.perf_counter()
    built = subprocess.run(
        [sys.executable, "-m", "gordo_tpu_torch.cli", "build-fleet", "--machines-from", listing,
         "--workers", str(BUILD_PLANE_WORKERS), "--lease-ttl", str(BUILD_PLANE_TTL),
         *device_args],
        cwd=root, env=env, capture_output=True, text=True, timeout=900,
    )
    report["build_s"] = time.perf_counter() - t0
    report["one_process_build_s"] = fleet["build_s"]
    log("build plane: two-worker build seconds", report["build_s"], "one process (phase 10)",
        fleet["build_s"])
    if built.returncode != 0 or "FAILED" in built.stdout or "QUARANTINED" in built.stdout:
        planner.kill()
        raise AssertionError(f"build-fleet --workers exited {built.returncode}:\n"
                             f"{built.stdout[-2000:]}\n{built.stderr[-4000:]}")
    plan_out, plan_err = planner.communicate(timeout=300)
    if planner.returncode != 0:
        raise AssertionError(f"buckets plan exited {planner.returncode}:\n{plan_err[-4000:]}")
    (code_exact, exact), (code_padded, padded) = json.loads(plan_out.strip().splitlines()[-1])
    exact, padded = json.loads(exact), json.loads(padded)
    report["plan_s"] = time.perf_counter() - t_plan  # its process's end, seen after (b)
    report["plans"] = {plan["policy"]: [p["machines"] for p in plan["programs"]]
                       for plan in (exact, padded)}
    log("build plane: plans", json.dumps(report["plans"]))
    machines = sorted(fleet["machines"])
    for plan in (exact, padded):
        if sorted(m for p in plan["programs"] for m in p["machines"]) != machines:
            raise AssertionError(f"buckets plan ({plan['policy']}) lost machines: {plan}")

    # (c) the ledger, the report, the artifacts, the events, the launches
    with open(os.path.join(output, ledger.LEDGER_DIRNAME, ledger.PLAN_FILENAME)) as fh:
        units = {u["id"]: u["machines"] for u in json.load(fh)["units"]}
    if sorted(units.values()) != sorted(report["plans"]["exact"]):
        raise AssertionError(f"the ledger's units {units} are not the exact plan's "
                             f"{report['plans']['exact']}")
    status_text = cli_output(["build-fleet", "--ledger-status", output])
    log("build plane: ledger status\n" + status_text.rstrip())
    status = ledger.Ledger(output, "smoke").status()
    report["units"] = {u["unit"]: {"state": u["state"], "worker": u.get("worker"),
                                   "attempt": u.get("attempt"), "machines": u["machines"]}
                       for u in status["units"]}
    attempts = sorted(u["attempt"] for u in report["units"].values())
    if (status["counts"]["done"] != len(units) or attempts != [1] * (len(units) - 1) + [2]
            or "attempt 2" not in status_text):
        raise AssertionError(f"ledger status: {status}")
    with open(os.path.join(output, "build_report.json")) as fh:
        merged = json.load(fh)
    with open(os.path.join(collection, "build_report.json")) as fh:
        single = json.load(fh)
    keys = ("n_machines", "n_built", "n_resumed", "n_failed", "n_quarantined", "failed",
            "quarantined", "precision")
    if {k: merged[k] for k in keys} != {k: single[k] for k in keys} or merged["n_failed"]:
        raise AssertionError(f"the two-worker report {merged} is not phase 10's {single}")
    worst, differing = 0.0, []
    for name in fleet["machines"]:
        got = npz_arrays(os.path.join(output, name, "params.npz"))
        want = npz_arrays(os.path.join(collection, name, "params.npz"))
        if sorted(got) != sorted(want):
            raise AssertionError(f"{name}: params {sorted(got)} against {sorted(want)}")
        for key in want:
            if got[key].tobytes() != want[key].tobytes():
                differing.append(f"{name}/{key}")
                worst = max(worst, float(np.abs(got[key].astype(np.float64)
                                                - want[key].astype(np.float64)).max()))
    report["params_bitwise"] = not differing
    report["params_max_abs_diff"] = worst
    report["params_differing"] = differing
    log("build plane: params bitwise phase 10's", report["params_bitwise"],
        "largest difference", worst, differing[:8])
    if worst > BUILD_PLANE_ATOL:
        raise AssertionError(f"params differ from phase 10's by {worst}: {differing}")
    from gordo_tpu_torch.observability import read_events

    kinds = [e["event"] for e in read_events(events)]
    report["events"] = {kind: kinds.count(kind) for kind in sorted(set(kinds))}
    log("build plane: events", json.dumps(report["events"]))
    missing = [kind for kind in BUILD_PLANE_EVENTS if kind not in kinds]
    if missing:
        raise AssertionError(f"the event log lacks {missing}: {report['events']}")
    transformer_unit = next(uid for uid, names in units.items() if f"{MACHINE}-0" in names)
    workers = {}
    telemetry_dir = os.path.join(output, ledger.LEDGER_DIRNAME, ledger.WORKER_TELEMETRY_DIRNAME)
    for entry in sorted(os.listdir(telemetry_dir)):
        with open(os.path.join(telemetry_dir, entry)) as fh:
            workers[entry[: -len(".json")]] = json.load(fh)
    report["workers"] = {wid: {"units_committed": w["units_committed"],
                               "wall_time_s": w["wall_time_s"],
                               "peak_bytes_in_use": w["device_memory"]["peak_bytes_in_use"],
                               "kernel_launches": {k: v for k, v in w["kernel_launches"].items()
                                                   if v}}
                         for wid, w in workers.items()}
    log("build plane: workers", json.dumps(report["workers"]))
    committer = next(w for w in workers.values() if transformer_unit in w["units_committed"])
    report["kernel_launches"] = committer["kernel_launches"]
    for kernel in (fa.KERNEL, fa.KERNEL_DQ, fa.KERNEL_DKV):
        name = f"{kernel}_quad"
        if committer["kernel_launches"][name] != fleet["kernel_launches"][name]:
            raise AssertionError(
                f"the committing worker launched {name} {committer['kernel_launches'][name]} "
                f"times, phase 10's build {fleet['kernel_launches'][name]}")

    # (d) the summary
    summary = json.loads(cli_output(["telemetry", "summarize", output, "--as-json"]))
    merged_report = next(r["report"] for r in summary["reports"]
                         if os.path.dirname(r["path"]) == output)
    peaks = [b["device_memory"]["peak_bytes_in_use"] for b in merged_report["buckets"]]
    report["summary"] = {
        "n_built": merged_report["n_built"],
        "machines_failed": merged_report["machines_failed"],
        "machines_quarantined": merged_report["machines_quarantined"],
        "peak_bytes_in_use": max((p for p in peaks if p is not None), default=None),
        "ledger": merged_report["ledger"],
        "events": summary["events"].get("ledger"),
    }
    log("build plane: summary", json.dumps(report["summary"]))
    if (merged_report["n_built"] != len(fleet["machines"]) or merged_report["machines_failed"]
            or merged_report["ledger"]["steals"] != 1
            or merged_report["ledger"]["n_units"] != len(units)
            or (device != "cpu" and not report["summary"]["peak_bytes_in_use"])):
        raise AssertionError(f"telemetry summarize: {report['summary']}")

    # (e) the spans
    from gordo_tpu_torch.observability.tracing import read_spans

    traced = read_spans(spans)
    report["spans"] = {name: sum(s["name"] == name for s in traced)
                       for name in sorted({s["name"] for s in traced})}
    log("build plane: spans", json.dumps(report["spans"]))
    if not span_tree_ok(traced):
        raise AssertionError(f"no build.fleet > build.bucket > build.cv/build.fit > "
                             f"train.dispatch tree: {report['spans']}")
    summarized = cli_output(["trace", "summarize", spans])
    if "build.fleet" not in summarized or "train.dispatch" not in summarized:
        raise AssertionError(f"trace summarize:\n{summarized}")
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
            # the whole history against the CPU for the first machines only:
            # the CPU's forward of four Transformers over 8255 rows took 34 s
            on_cpu = transformers if n_rows == 144 else transformers[:CPU_WHOLE_HISTORY_MACHINES]
            row = {"route": "anomaly/prediction/fleet", "machines": len(transformers),
                   "rows": n_rows, "median_s": statistics.median(times), "seconds": times,
                   "card_vs_cpu": against_cpu(f"{n_rows} rows", "anomaly/prediction/fleet",
                                              machines_body(on_cpu, n_rows, True),
                                              replies[n_rows], on_cpu),
                   "cpu_machines": len(on_cpu)}
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
    rows = OPTIONS_DAYS * OPTIONS_SAMPLES_A_DAY
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
                    "train_end_date": OPTIONS_END,
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
        ff_artifact = os.path.join(collection, feedforward["name"])
        # the feedforward build in its own process while the Transformer's run
        pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        ff_future = pool.submit(
            driven_build, root, feedforward, ff_artifact,
            *(arg for p in OPTIONS_PARAMETERS for arg in ("--model-parameter", p)))
        pool.shutdown(wait=False)
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
        ff = ff_future.result()
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

    rows = LAKE_DAYS * OPTIONS_SAMPLES_A_DAY
    X, _ = sensor_rows(rows, SEED + 13)
    X[::OPTIONS_SPIKE_EVERY, 1] += 40.0
    step = timedelta(days=1) / OPTIONS_SAMPLES_A_DAY
    stamps = [TRAIN_START + i * step for i in range(rows)]
    restated = set(np.random.default_rng(SEED + 13).choice(rows, LAKE_DUPLICATES, replace=False)
                   .tolist())
    long_dir, fs_dir = os.path.join(root, "long"), os.path.join(root, "fs")
    for day in range(LAKE_DAYS):
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
                               db=db, end=LAKE_END)
    (machine,) = NormalizedConfig(safe_load(text), project_name=PROJECT).machines
    machine = json.loads(json.dumps(machine.to_dict(), default=str))
    end = TRAIN_START + timedelta(days=LAKE_DAYS)
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
# of PLANE_LRS on turbine-9900-transformer-0 (PLANE_SWEEP_DAYS days of it),
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
# the sweep's and its solo fit's data: phase 10's first Transformer over the
# span's first PLANE_SWEEP_DAYS days (a random provider of 144 samples a
# day), cut from its 151: both fits ran over 21 744 rows
PLANE_SWEEP_DAYS = 28
PLANE_SWEEP_RTOL = 1e-4
PLANE_RESUME_ROWS = 4096
PLANE_DROPOUT = 0.1
PLANE_REPLICAS = ("r0", "r1")
PLANE_REBUILT = f"{MACHINE}-3"
PLANE_STREAM_ROWS = STREAM_FIRST + STREAM_UPDATE
PLANE_ROUTED_REPEATS = 3
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


# Phase 15: the lifecycle over a copy of phase 10's collection laid out as
# models/<FLEET_COLLECTION> plus a `latest` symlink. Every tick scores and
# refits over LIFECYCLE_WINDOW, the config span's last 28 days (4032 rows
# a machine where phase 10's build read 21 744: the phase's time budget;
# widths are the config's), and a refit trains its window's first three
# quarters 1 epoch, as phase 10's build. LIFECYCLE_NEVER are thresholds no
# machine passes: a tick under them scores every machine and refits none.
LIFECYCLE_WINDOW = ("2019-05-04T00:00:00+00:00", "2019-06-01T00:00:00+00:00")
LIFECYCLE_NEVER = {"ratio_threshold": 1e12, "exceedance_threshold": 2.0}
LIFECYCLE_DEFAULTS = {"ratio_threshold": 1.0, "exceedance_threshold": 0.5}
LIFECYCLE_RTOL = 1e-4  # card against CPU, the Transformer's tolerance
# one scored row's share of a window's exceedance (3969 windows of 4032 rows)
LIFECYCLE_ONE_ROW = 1.0 / 3900
LIFECYCLE_SHIFTED = tuple(f"{MACHINE}-{i}" for i in (1, 2, 3))
LIFECYCLE_STREAM_UPDATE = 1008
# runs `python -m gordo_tpu_torch.cli lifecycle ...`'s main in a
# subprocess and writes that process's flash launches, and those made
# inside the tick's refit and inside its shadow gate, to the file named
# first
LIFECYCLE_DRIVER = (
    "import json, sys\n"
    "from gordo_tpu_torch.cli.cli import main\n"
    "from gordo_tpu_torch.lifecycle.manager import LifecycleManager\n"
    "from gordo_tpu_torch.ops import flash_attention as fa\n"
    "phases = {'refit': {}, 'shadow': {}}\n"
    "def counted(phase, method):\n"
    "    def run(*args, **kwargs):\n"
    "        before = dict(fa.kernel_launches)\n"
    "        try:\n"
    "            return method(*args, **kwargs)\n"
    "        finally:\n"
    "            for k, v in fa.kernel_launches.items():\n"
    "                phases[phase][k] = phases[phase].get(k, 0) + v - before[k]\n"
    "    return run\n"
    "LifecycleManager._refit = counted('refit', LifecycleManager._refit)\n"
    "LifecycleManager._shadow_one = counted('shadow', LifecycleManager._shadow_one)\n"
    "code = main(sys.argv[2:])\n"
    "with open(sys.argv[1], 'w') as fh:\n"
    "    json.dump({'kernels': fa.kernel_launches, 'phases': phases}, fh)\n"
    "sys.exit(code)\n"
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
    machine["dataset"] = dict(
        machine["dataset"],
        train_end_date=(TRAIN_START + timedelta(days=PLANE_SWEEP_DAYS)).isoformat(),
        data_provider={"type": "RandomDataProvider", "min_size": 144 * PLANE_SWEEP_DAYS,
                       "max_size": 144 * PLANE_SWEEP_DAYS})
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
        with captured_stdout(out):
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


def resume_build_check(fa, collection: str, device=None) -> dict:
    """Phase 14b, the builder: `build-fleet --resume` over phase 10's
    collection (every machine reused, no launch), then with
    ``PLANE_REBUILT``'s artifact removed (only it rebuilt; the others'
    files untouched), each run by the command line in this process (a
    process's start-up was a fifth of it), its launches counted from 0
    just before."""
    import shutil

    root = os.path.dirname(os.path.abspath(__file__))
    listing = os.path.join(os.path.dirname(collection), "machines.yaml")
    n_machines = len(fleet_machines(root))
    stamps = {name: os.path.getmtime(os.path.join(collection, name, "params.npz"))
              for name in os.listdir(collection)
              if os.path.isdir(os.path.join(collection, name)) and name != PLANE_REBUILT}
    report = {}
    for label, expected in (("all_current", (n_machines, 0)), ("one_removed",
                                                                (n_machines - 1, 1))):
        if label == "one_removed":
            shutil.rmtree(os.path.join(collection, PLANE_REBUILT))
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        with scoped_environ(drop=FLEET_ENV_DROP, OUTPUT_DIR=collection):
            cli_output(["build-fleet", "--machines-from", listing, "--resume",
                        *(["--device", device] if device else [])])
        seconds = time.perf_counter() - t0
        launches = dict(fa.kernel_launches)
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


def start_routed_plane(collection: str, device=None) -> dict:
    """Phase 14c's processes, started: ``PLANE_REPLICAS`` `run-server`
    replicas over one shard manifest and a `run-router` (``processes``,
    their ports, the working directory, the start time)."""
    from gordo_tpu_torch.server.catalog import write_shard_manifest

    root = os.path.dirname(os.path.abspath(__file__))
    workdir = tempfile.mkdtemp(prefix="plane-")
    manifest = write_shard_manifest(os.path.join(workdir, "manifest.json"), PLANE_REPLICAS)
    ports = {rid: free_port() for rid in PLANE_REPLICAS}
    router_port = free_port()
    processes = {}
    started = time.perf_counter()
    try:
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
    except BaseException:
        stop_processes(processes.values())
        raise
    return {"processes": processes, "ports": ports, "router_port": router_port,
            "workdir": workdir, "started": started}


def routed_check(torch, fa, collection: str, plane: dict, device=None) -> dict:
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
    processes, ports, router_port = plane["processes"], plane["ports"], plane["router_port"]
    workdir = plane["workdir"]
    try:
        t0 = time.perf_counter()
        for rid in PLANE_REPLICAS:
            wait_ready(f"http://127.0.0.1:{ports[rid]}/healthz", processes[rid])
        wait_ready(f"http://127.0.0.1:{router_port}/healthz", processes["router"])
        # the processes started before (a): the wait left here, and the time
        # since their start
        report["start_wait_s"] = time.perf_counter() - t0
        report["start_s"] = time.perf_counter() - plane["started"]
        log("plane up; waited", report["start_wait_s"], "s; shards", json.dumps(shards))
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
        stop_processes(processes.values())
    return report


def plane_phase(torch, fa, profile: bool, collection: str, device=None):
    """Phase 14: the sweep (14a), resumed fits and builds (14b) and the
    routed plane (14c), the module docstring's; on the card unless
    ``device`` names another (a rehearsal)."""
    root = os.path.dirname(os.path.abspath(__file__))
    report = {}
    # (c)'s processes start first and come up while (a) and (b) run here
    plane = start_routed_plane(collection, device)
    try:
        t0 = time.perf_counter()
        report["sweep"] = sweep_check(torch, fa, root, device)
        report["sweep"]["phase_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        report["resume_fit"] = resume_fit_check(torch, fa, collection, device)
        report["resume_build"] = resume_build_check(fa, collection, device)
        report["resume_build"]["phase_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        report["routed"] = routed_check(torch, fa, collection, plane, device)
        report["routed"]["phase_s"] = time.perf_counter() - t0
    finally:
        stop_processes(plane["processes"].values())
    return report


def lifecycle_windows(collection: str, names) -> dict:
    """Each machine's ``LIFECYCLE_WINDOW`` rows: (X, row keys, tags)."""
    import numpy as np

    from gordo_tpu_torch import serializer
    from gordo_tpu_torch.data import _get_dataset
    from gordo_tpu_torch.data.base import to_datetimes

    out = {}
    for name in names:
        dataset = dict(serializer.load_metadata(os.path.join(collection, name))["dataset"],
                       train_start_date=LIFECYCLE_WINDOW[0], train_end_date=LIFECYCLE_WINDOW[1])
        X, _, stamps = _get_dataset(dataset).get_data()
        keys = [stamp.isoformat() for stamp in to_datetimes(stamps.astype(np.int64))]
        out[name] = (np.asarray(X), keys, dataset["tag_list"])
    return out


def launches_apart(total: dict, *parts: dict) -> dict:
    """``total`` less each of ``parts``, kernel by kernel."""
    return {k: v - sum(part.get(k, 0) for part in parts) for k, v in total.items()}


def lifecycle_phase(torch, fa, profile: bool, collection: str, device=None):
    """Phase 15 (the module docstring's): (a) a dry tick on the card and
    on the CPU, (b) ``lifecycle tick`` in a subprocess under drift,
    degrade and NaN faults with the port's server answering from
    ``latest`` around it, (c) a torn promotion, (d) a stream-fed tick;
    on the card unless ``device`` names another (a rehearsal)."""
    import shutil

    from gordo_tpu_torch.lifecycle import DriftMonitor, LifecycleConfig, LifecycleManager
    from gordo_tpu_torch.lifecycle import TornPromotion, read_promotion_report
    from gordo_tpu_torch.robustness import faults
    from gordo_tpu_torch.server.app import build_app

    root = os.path.dirname(os.path.abspath(__file__))
    transformers = [f"{MACHINE}-{i}" for i in range(FLEET_TRANSFORMERS)]
    quad = {kernel: f"{kernel}_quad" for kernel in (fa.KERNEL, fa.KERNEL_DQ, fa.KERNEL_DKV)}
    device_args = ["--device", device] if device else []
    report = {"window": list(LIFECYCLE_WINDOW)}
    workdir = tempfile.mkdtemp(prefix="lifecycle-")

    def config(**overrides):
        return LifecycleConfig(window_start=LIFECYCLE_WINDOW[0],
                               window_end=LIFECYCLE_WINDOW[1], **overrides)

    def backward(counts):
        return counts[quad[fa.KERNEL_DQ]] + counts[quad[fa.KERNEL_DKV]]

    try:
        models = os.path.join(workdir, "models")
        base = os.path.join(models, FLEET_COLLECTION)
        shutil.copytree(collection, base)
        pointer = os.path.join(models, "latest")
        os.symlink(FLEET_COLLECTION, pointer)

        # (a) the dry tick: every machine scored, none refitted, on the card
        # and on the CPU, each with a monitor of its own
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        card = LifecycleManager(pointer, config(promote=False, **LIFECYCLE_NEVER),
                                monitor=DriftMonitor(**LIFECYCLE_NEVER), device=device).tick()
        report["dry_s"] = time.perf_counter() - t0
        report["dry_launches"] = dict(fa.kernel_launches)
        t0 = time.perf_counter()
        cpu = LifecycleManager(pointer, config(promote=False, **LIFECYCLE_NEVER),
                               monitor=DriftMonitor(**LIFECYCLE_NEVER), device="cpu").tick()
        report["dry_cpu_s"] = time.perf_counter() - t0
        if card.monitored != transformers or cpu.monitored != transformers or card.drifted:
            raise AssertionError(f"dry tick: monitored {card.monitored}, drifted {card.drifted}")
        stats = {}
        for name in transformers:
            got = card.report["decisions"][name]["drift"]
            want = cpu.report["decisions"][name]["drift"]
            stats[name] = {"ratio": got["ratio"], "exceedance": got["exceedance"],
                           "cpu_ratio": want["ratio"], "cpu_exceedance": want["exceedance"]}
            # the exceedance counts rows over 1: within one row's share
            if not (abs(got["ratio"] - want["ratio"]) <= LIFECYCLE_RTOL * abs(want["ratio"])
                    and abs(got["exceedance"] - want["exceedance"]) <= LIFECYCLE_ONE_ROW):
                raise AssertionError(f"{name}: card {got} against CPU {want}")
        report["dry_stats"] = stats
        log("lifecycle dry tick monitored", card.monitored, "stats", json.dumps(stats))
        log("lifecycle dry tick launches",
            json.dumps({k: v for k, v in report["dry_launches"].items() if v}))
        if report["dry_launches"][quad[fa.KERNEL]] <= 0 or backward(report["dry_launches"]):
            raise AssertionError(f"dry tick launches: {report['dry_launches']}")
        ratio = max(s["ratio"] for s in stats.values())
        exceedance = max(s["exceedance"] for s in stats.values())
        thresholds = dict(LIFECYCLE_DEFAULTS)
        if (ratio > LIFECYCLE_DEFAULTS["ratio_threshold"]
                or exceedance > LIFECYCLE_DEFAULTS["exceedance_threshold"]):
            thresholds = {"ratio_threshold": 2.0 * ratio,
                          "exceedance_threshold": (1.0 + exceedance) / 2.0}
        report["thresholds"] = thresholds
        log("lifecycle thresholds", json.dumps(thresholds), "(clean max ratio", ratio,
            "exceedance", exceedance, ")")
        threshold_args = ["--ratio-threshold", repr(thresholds["ratio_threshold"]),
                          "--exceedance-threshold", repr(thresholds["exceedance_threshold"])]

        # (b) the drifted tick in a subprocess, the server on latest around it
        spec = ";".join([f"drift:shift:{name}" for name in LIFECYCLE_SHIFTED]
                        + [f"refit:degrade:{MACHINE}-2", f"refit:nan:{MACHINE}-3@epoch:0"])
        data = lifecycle_windows(base, transformers)
        bodies = {}
        for name, (X, keys, tags) in data.items():
            frame = frame_of(X, keys, tags, slice(0, 144))
            bodies[name] = {"X": frame, "y": frame}
        app = build_app(pointer, device=device)
        with http_server(pointer, None, app=app) as served:
            before = {name: request_json(f"{served}/{name}/anomaly/prediction", bodies[name])
                      for name in transformers}
            if any(status != 200 for status, _, _ in before.values()):
                raise AssertionError(f"base revision replies: {before}")
            counts = os.path.join(workdir, "tick_launches.json")
            t0 = time.perf_counter()
            run = subprocess.run(
                [sys.executable, "-c", LIFECYCLE_DRIVER, counts, "lifecycle", "tick",
                 "--model-collection-dir", pointer, "--window-start", LIFECYCLE_WINDOW[0],
                 "--window-end", LIFECYCLE_WINDOW[1], *threshold_args, *device_args],
                cwd=root, env=dict(os.environ, GORDO_FAULT_INJECT=spec), capture_output=True,
                text=True, timeout=600,
            )
            report["tick_s"] = time.perf_counter() - t0
            if run.returncode != 0:
                raise AssertionError(f"lifecycle tick exited {run.returncode}:\n"
                                     f"{run.stdout[-2000:]}\n{run.stderr[-4000:]}")
            summary = json.loads(run.stdout)
            with open(counts) as fh:
                launched = json.load(fh)
            refit, shadow = launched["phases"]["refit"], launched["phases"]["shadow"]
            report["tick"] = {key: summary[key] for key in (
                "base_revision", "revision", "monitored", "drifted", "promoted", "rejected",
                "quarantined", "wall_time_s")}
            report["tick_launches"] = {"scan": launches_apart(launched["kernels"], refit, shadow),
                                       "refit": refit, "shadow": shadow}
            report["tick"]["decisions"] = summary["report"]["decisions"]
            log("lifecycle tick", json.dumps({k: v for k, v in report["tick"].items()
                                              if k != "decisions"}))
            for name in transformers:
                log("lifecycle decision", name, json.dumps(summary["report"]["decisions"][name]))
            log("lifecycle tick launches", json.dumps(
                {phase: {k: v for k, v in counts_.items() if v}
                 for phase, counts_ in report["tick_launches"].items()}))
            expected = (list(LIFECYCLE_SHIFTED), [f"{MACHINE}-1"], [f"{MACHINE}-2"],
                        [f"{MACHINE}-3"])
            got = tuple(summary[key] for key in ("drifted", "promoted", "rejected", "quarantined"))
            if got != expected:
                raise AssertionError(f"tick decisions {got}, expected {expected}")
            revision = summary["revision"]
            new = os.path.join(models, revision)
            if os.readlink(pointer) != revision:
                raise AssertionError(f"latest points at {os.readlink(pointer)}, not {revision}")
            for name in os.listdir(base):
                if os.path.isdir(os.path.join(base, name)) and name != f"{MACHINE}-1":
                    for fname in os.listdir(os.path.join(base, name)):
                        if not os.path.samefile(os.path.join(base, name, fname),
                                                os.path.join(new, name, fname)):
                            raise AssertionError(f"{name}/{fname} is not a hard link")
            if read_promotion_report(new)["counts"].get("promoted") != 1:
                raise AssertionError(f"promotion report: {read_promotion_report(new)}")
            if not (backward(refit) > 0 and refit[quad[fa.KERNEL]] > 0
                    and shadow[quad[fa.KERNEL]] > 0 and not backward(shadow)):
                raise AssertionError(f"tick launches: {report['tick_launches']}")
            after = {name: request_json(f"{served}/{name}/anomaly/prediction", bodies[name])
                     for name in transformers}
            report["served"] = {name: after[name][0] for name in transformers}
            if after[f"{MACHINE}-3"][0] != 409:
                raise AssertionError(f"the quarantined machine answered {after[f'{MACHINE}-3']}")
            if after[f"{MACHINE}-1"][0] != 200 or after[f"{MACHINE}-1"][1]["data"] == (
                    before[f"{MACHINE}-1"][1]["data"]):
                raise AssertionError("the promoted machine's reply did not change")
            for name in (f"{MACHINE}-0", f"{MACHINE}-2"):
                if after[name][0] != 200 or after[name][1]["data"] != before[name][1]["data"]:
                    raise AssertionError(f"the retained machine {name} answers differently")
            log("lifecycle served after the tick", json.dumps(report["served"]))

            # (c) a torn promotion: latest untouched, the staging directory left
            published = sorted(n for n in os.listdir(models) if n.isdigit())
            os.environ[faults.FAULT_INJECT_ENV_VAR] = f"drift:shift:{MACHINE}-0;promote:torn"
            faults.reset()
            fa.reset_launch_counts()
            t0 = time.perf_counter()
            try:
                LifecycleManager(pointer, config(**thresholds), device=device).tick()
                raise AssertionError("a torn promotion published")
            except TornPromotion as exc:
                staging = exc.staging_dir
            finally:
                del os.environ[faults.FAULT_INJECT_ENV_VAR]
                faults.reset()
            report["torn_s"] = time.perf_counter() - t0
            report["torn_launches"] = dict(fa.kernel_launches)
            if (os.readlink(pointer) != revision or not os.path.isdir(staging)
                    or not os.path.basename(staging).startswith(".promote-")
                    or sorted(n for n in os.listdir(models) if n.isdigit()) != published):
                raise AssertionError(f"torn tick: latest {os.readlink(pointer)}, {staging}")
            log("lifecycle torn tick left", os.path.basename(staging), "latest", revision)

            # (d) a stream-fed tick: the streamed machine assessed from its
            # events, with no window fetch of its own
            streamed = f"{MACHINE}-0"
            events = os.path.join(workdir, "serve-events.jsonl")
            X = data[streamed][0]
            fa.reset_launch_counts()
            t0 = time.perf_counter()
            os.environ["GORDO_TPU_EVENT_LOG"] = events
            try:
                status, opened, _ = request_json(f"{served}/stream/open", {"machines": [streamed]})
                if status != 201 or not opened["machines"][streamed]["monitored"]:
                    raise AssertionError(f"stream/open answered {status}: {opened}")
                for start in range(0, len(X), LIFECYCLE_STREAM_UPDATE):
                    rows = X[start:start + LIFECYCLE_STREAM_UPDATE].tolist()
                    status, reply, _ = request_json(
                        f"{served}/stream/{opened['session']}/update",
                        {"updates": {streamed: {"rows": rows, "seq": start}}})
                    if status != 200:
                        raise AssertionError(f"stream update answered {status}: {reply}")
            finally:
                del os.environ["GORDO_TPU_EVENT_LOG"]
            fetches = []
            fetch = LifecycleManager._fetch_window

            def counted_fetch(meta, start, end):
                fetches.append(meta["name"])
                return fetch(meta, start, end)

            LifecycleManager._fetch_window = staticmethod(counted_fetch)
            try:
                fed = LifecycleManager(
                    pointer, config(stream_observations=events, promote=False, **thresholds),
                    monitor=DriftMonitor(**thresholds), device=device).tick()
            finally:
                LifecycleManager._fetch_window = staticmethod(fetch)
            report["stream_s"] = time.perf_counter() - t0
            report["stream_launches"] = dict(fa.kernel_launches)
            record = fed.report["decisions"][streamed]
            if record.get("source") != "stream" or streamed in fetches:
                raise AssertionError(f"stream-fed tick: {record}, fetched {fetches}")
            # the same statistic as a scan of the streamed rows
            scan = LifecycleManager(pointer, config(**LIFECYCLE_NEVER),
                                    monitor=DriftMonitor(**LIFECYCLE_NEVER), device=device)
            live = os.path.realpath(pointer)
            meta = scan._load_metadata(live, streamed)
            window = scan._machine_window(meta)
            scanned = scan._score_one(streamed, scan._load_monitorable(live, streamed),
                                      scan._fetch_window(meta, window["start"], window["end"]),
                                      revision, meta)
            report["stream"] = {"streamed": record["drift"], "scanned": scanned.to_dict(),
                                "fetched": fetches, "drifted": fed.drifted}
            log("lifecycle stream-fed tick", json.dumps(report["stream"]))
            if not (abs(record["drift"]["ratio"] - scanned.ratio)
                    <= LIFECYCLE_RTOL * abs(scanned.ratio)
                    and abs(record["drift"]["exceedance"] - scanned.exceedance)
                    <= LIFECYCLE_ONE_ROW):
                raise AssertionError(f"streamed {record['drift']} against scanned {scanned}")
        return report
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


# Phase 16: the port's client against phase 10's collection, served in this
# process with /metrics on: one day of the config's span (the client moves
# its start back by the model's offset and 5 resolutions), CLIENT_BATCH
# rows a POST (each Transformer posts 2 chunks), one Transformer streamed
# over phase 11's 8255 whole-history rows, its session closed by the
# server after CLIENT_STREAM_CUT updates
CLIENT_SPAN = ("2019-05-20T00:00:00+00:00", "2019-05-21T00:00:00+00:00")
CLIENT_BATCH = 100
CLIENT_STREAM_CUT = 20
CLIENT_RTOL = 1e-6  # the client's frames against direct POSTs of the same chunks
CLIENT_FLEET_RTOL, CLIENT_FLEET_ATOL = 1e-4, 1e-5  # fleet against solo, as phase 11
CLIENT_LEDGER_REPEATS = 10  # 144-row requests a block, two blocks each way
CLIENT_PROBE_PATHS = ("/healthcheck", "/healthz", "/metrics", "/telemetry/snapshot")
# runs each argv of a JSON list through the port's command line in one
# process and prints their exit codes
CLIENT_CLI_DRIVER = (
    "import json, sys\n"
    "from gordo_tpu_torch.cli.cli import main\n"
    "print(json.dumps([main(argv) for argv in json.loads(sys.argv[1])]))\n"
)


class CountedApp:
    """A WSGI app that counts the requests it answers, probes aside (the
    requests the server's request metrics count)."""

    def __init__(self, app):
        self.app = app
        self.catalog = app.catalog
        self.requests = 0
        self._lock = threading.Lock()

    def __call__(self, environ, start_response):
        if environ.get("PATH_INFO") not in CLIENT_PROBE_PATHS:
            with self._lock:
                self.requests += 1
        return self.app(environ, start_response)


def numeric_blocks(frame) -> dict:
    """A BlockFrame's number blocks, as float64 arrays."""
    import numpy as np

    return {top: np.asarray(values, dtype=np.float64)
            for top, (_, values) in frame.blocks.items() if values.dtype != object}


def frames_rel_diff(got, want, atol: float = 0.0) -> float:
    """The largest |got - want| / (atol + |want|.max()) over the number
    blocks of two frames of one index and blocks."""
    import numpy as np

    if [str(x) for x in got.index] != [str(x) for x in want.index]:
        raise AssertionError(f"frames of other rows: {len(got.index)} and {len(want.index)}")
    if list(got.blocks) != list(want.blocks):
        raise AssertionError(f"frames of other blocks: {list(got.blocks)}, {list(want.blocks)}")
    a, b = numeric_blocks(got), numeric_blocks(want)
    return max(float(np.abs(a[k] - b[k]).max() / (atol + np.abs(b[k]).max())) for k in b)


def read_csv_gz(path: str) -> dict:
    """A ``client predict --output-dir`` file: {(top, sub): column} and
    the row labels."""
    import csv
    import gzip

    with gzip.open(path, "rt", newline="") as fh:
        rows = list(csv.reader(fh))
    tops, subs = rows[0][1:], rows[1][1:]
    columns = {(t, s): [row[1 + j] for row in rows[2:]] for j, (t, s) in enumerate(zip(tops, subs))}
    return {"index": [row[0] for row in rows[2:]], "columns": columns}


def client_phase(torch, fa, profile: bool, collection: str, device=None):
    """Phase 16 (the module docstring's): the port's client against the
    port's server on the card (``device`` for a rehearsal elsewhere; on
    the CPU the plain versions' calls stand in for launches)."""
    import numpy as np

    from gordo_tpu_torch import serializer
    from gordo_tpu_torch.client import Client
    from gordo_tpu_torch.client.frames import concat_frames, frame_from_reply, frame_to_dict
    from gordo_tpu_torch.data import _get_dataset
    from gordo_tpu_torch.data.providers import RandomDataProvider
    from gordo_tpu_torch.observability import attribution, prom_text, tracing
    from gordo_tpu_torch.server.app import build_app

    root = os.path.dirname(os.path.abspath(__file__))
    transformers = [f"{MACHINE}-{i}" for i in range(FLEET_TRANSFORMERS)]
    n_layers, lookback = BASE_ESTIMATOR["n_layers"], BASE_ESTIMATOR["lookback_window"]
    start, end = (datetime.fromisoformat(t) for t in CLIENT_SPAN)
    forward = [k for k in fa.kernel_launches if k.startswith(fa.KERNEL + "_")]
    for var in (tracing.TRACE_LOG_ENV_VAR, attribution.LEDGER_ENV_VAR):
        os.environ.pop(var, None)

    def launches():
        fwd = sum(fa.kernel_launches[k] for k in forward)
        back = sum(fa.launch_counts[k] for k in (fa.KERNEL_DQ, fa.KERNEL_DKV))
        if device == "cpu":
            fwd += fa.plain_calls[fa.KERNEL]
            back += fa.plain_calls[fa.KERNEL_DQ] + fa.plain_calls[fa.KERNEL_DKV]
        return fwd, back

    workdir = tempfile.mkdtemp(prefix="client-")
    report = {"span": list(CLIENT_SPAN), "batch_size": CLIENT_BATCH}
    app = CountedApp(build_app(collection, device=device, batch_wait_ms=0,
                               enable_prometheus=True))
    with http_server(collection, None, app=app) as base:
        server_root = base.split("/gordo/")[0]
        port = int(server_root.rsplit(":", 1)[1])
        provider = RandomDataProvider(min_size=FLEET_SAMPLES, max_size=FLEET_SAMPLES)
        client = Client(PROJECT, host="127.0.0.1", port=port, scheme="http",
                        data_provider=provider, batch_size=CLIENT_BATCH, parallelism=4)
        machines = client._get_machines(machine_names=transformers)
        raw = {m.name: client._raw_data(m, start, end) for m in machines}
        chunks = {m.name: client._row_chunks(len(raw[m.name][0].index), CLIENT_BATCH,
                                             client._min_chunk_rows(m)) for m in machines}
        report["chunks"] = {name: len(c) for name, c in chunks.items()}
        if min(report["chunks"].values()) < 2:
            raise AssertionError(f"each machine should post 2 chunks or more: {chunks}")

        # (a) predict, then the same chunks posted directly
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        solo = {r.name: r for r in client.predict(start, end, targets=transformers)}
        report["predict_s"] = time.perf_counter() - t0
        solo_launches, (fwd, back) = dict(fa.kernel_launches), launches()
        want = n_layers * sum(report["chunks"].values())
        report["predict_launches"] = {"forward": fwd, "backward": back, "expected": want}
        if fwd != want or back:
            raise AssertionError(f"client predict launches: {report['predict_launches']}")
        for name, result in solo.items():
            if result.error_messages or not len(result.predictions.index):
                raise AssertionError(f"{name}: {result.error_messages}")
        t0 = time.perf_counter()
        direct = {}
        for name in transformers:
            X, y = raw[name]
            frames = []
            for s, e in chunks[name]:
                rows = slice(s, e)
                status, reply, _ = request_json(f"{base}/{name}/anomaly/prediction", {
                    "X": frame_to_dict(X, rows), "y": frame_to_dict(y, rows)})
                if status != 200:
                    raise AssertionError(f"{name} direct POST answered {status}: {reply}")
                frames.append(frame_from_reply(reply["data"]))
            direct[name] = concat_frames(frames)
        report["direct_s"] = time.perf_counter() - t0
        report["predict_vs_direct"] = {n: frames_rel_diff(solo[n].predictions, direct[n])
                                       for n in transformers}
        if max(report["predict_vs_direct"].values()) > CLIENT_RTOL:
            raise AssertionError(f"client frames against direct POSTs: {report}")
        report["rows"] = {n: len(solo[n].predictions.index) for n in transformers}

        # (b) predict_fleet: one folded forward a layer for each group chunk
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        fleet = {r.name: r for r in client.predict_fleet(start, end, targets=transformers,
                                                          group_size=4)}
        report["fleet_s"] = time.perf_counter() - t0
        fleet_launches, (fwd, back) = dict(fa.kernel_launches), launches()
        want = n_layers * max(report["chunks"].values())
        report["fleet_launches"] = {"forward": fwd, "backward": back, "expected": want}
        if fwd != want or back:
            raise AssertionError(f"client fleet launches: {report['fleet_launches']}")
        report["fleet_vs_predict"] = {
            n: frames_rel_diff(fleet[n].predictions, solo[n].predictions,
                               atol=CLIENT_FLEET_ATOL / CLIENT_FLEET_RTOL)
            for n in transformers}
        for n in transformers:
            got, ref = numeric_blocks(fleet[n].predictions), numeric_blocks(solo[n].predictions)
            for top in ref:
                if not np.allclose(got[top], ref[top], rtol=CLIENT_FLEET_RTOL,
                                   atol=CLIENT_FLEET_ATOL):
                    raise AssertionError(f"{n} {top}: fleet against solo {report}")

        # (c) a stream with one server-side close, against a direct session
        name = transformers[0]
        metadata = serializer.load_metadata(os.path.join(collection, name))
        rows = np.asarray(_get_dataset(metadata["dataset"]).get_data()[0],
                          dtype=np.float64)[:SERVE_ROWS[1]]
        updates = stream_chunks(len(rows))
        fa.reset_launch_counts()
        streamed = []
        with client.stream_machine(name, backoff_scale=0.0) as stream:
            for i, (s, k) in enumerate(updates):
                if i == CLIENT_STREAM_CUT:
                    status, _, _ = request_json(f"{base}/stream/{stream.session_id}/close")
                    if status != 200:
                        raise AssertionError(f"out-of-band close answered {status}")
                streamed.append(stream.send(rows[s:s + k]))
            reconnects = stream.reconnects
        stream_launches, (fwd, back) = dict(fa.kernel_launches), launches()
        scored = sum(1 for s, k in updates if s + k >= lookback)
        report["stream"] = {"updates": len(updates), "scored": scored, "reconnects": reconnects,
                            "forward": fwd, "backward": back, "expected": n_layers * scored}
        if reconnects != 1 or fwd != n_layers * scored or back:
            raise AssertionError(f"client stream: {report['stream']}")
        status, opened, _ = request_json(f"{base}/stream/open", {"machines": [name]})
        sid = opened["session"]
        plain = []
        for s, k in updates:
            status, body, _ = request_json(f"{base}/stream/{sid}/update", {
                "updates": {name: {"rows": rows[s:s + k].tolist(), "seq": s}}})
            if status != 200:
                raise AssertionError(f"direct stream update at {s} answered {status}")
            plain.append(np.asarray(body["scores"][name]["rows"] or [], dtype=np.float32))
        request_json(f"{base}/stream/{sid}/close")
        got = np.concatenate([x.reshape(-1, rows.shape[1]) for x in streamed if len(x)])
        want = np.concatenate([x.reshape(-1, rows.shape[1]) for x in plain if len(x)])
        report["stream"]["outputs"] = int(len(got))
        if got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError(f"the client's stream left the direct session's: {got.shape} "
                                 f"{want.shape}")

        # (d) the client command in a subprocess (no card there)
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
        env.pop(tracing.TRACE_LOG_ENV_VAR, None)
        outdir = os.path.join(workdir, "predictions")
        os.makedirs(outdir)
        group = ["client", "--project", PROJECT, "--host", "127.0.0.1", "--port", str(port),
                 "--scheme", "http", "--batch-size", str(CLIENT_BATCH)]
        targets = [arg for n in transformers for arg in ("--target", n)]
        provider_text = json.dumps({"type": "RandomDataProvider", "min_size": FLEET_SAMPLES,
                                    "max_size": FLEET_SAMPLES})
        meta_file = os.path.join(workdir, "metadata.json")
        commands = [
            [*group, "predict", CLIENT_SPAN[0], CLIENT_SPAN[1], "--data-provider",
             provider_text, "--output-dir", outdir, *targets],
            [*group, "metadata", "--output-file", meta_file, *targets],
        ]
        # both commands in one process (one start-up): the command's main,
        # each exit code printed
        t0 = time.perf_counter()
        cli_run = subprocess.run(
            [sys.executable, "-c", CLIENT_CLI_DRIVER, json.dumps(commands)],
            cwd=root, env=env, capture_output=True, text=True, timeout=300)
        report["cli_s"] = time.perf_counter() - t0
        codes = cli_run.stdout.strip().splitlines()[-1:] or ["none"]
        if cli_run.returncode or codes != ["[0, 0]"]:
            raise AssertionError(f"client commands exited {cli_run.returncode} ({codes}):\n"
                                 f"{cli_run.stdout[-2000:]}\n{cli_run.stderr[-2000:]}")
        cli_diff = {}
        for n in transformers:
            table = read_csv_gz(os.path.join(outdir, f"{n}.csv.gz"))
            frame = solo[n].predictions
            if table["index"] != [str(x) for x in frame.index]:
                raise AssertionError(f"{n}: the command's rows differ from (a)'s")
            diff = 0.0
            for top, values in numeric_blocks(frame).items():
                for j, sub in enumerate(frame.labels(top)):
                    column = np.asarray([float(x) if x else np.nan
                                         for x in table["columns"][(top, sub)]])
                    diff = max(diff, float(np.nanmax(np.abs(column - values[:, j]))
                                           / np.abs(values).max()))
            cli_diff[n] = diff
        report["cli_vs_predict"] = cli_diff
        if max(cli_diff.values()) > CLIENT_RTOL:
            raise AssertionError(f"the command's files against (a): {cli_diff}")
        with open(meta_file) as fh:
            written = json.load(fh)
        want_meta = json.loads(json.dumps({n: m.metadata.to_dict() for n, m in zip(
            transformers, machines)}, default=str))
        if written != want_meta:
            raise AssertionError("the command's metadata file differs from the client's")

        # (f) one traced prediction: the server's spans under the client's
        spans = os.path.join(workdir, "spans", "spans.jsonl")
        os.environ[tracing.TRACE_LOG_ENV_VAR] = spans
        try:
            traced = client.predict(start, end, targets=[name])
            with tracing.start_span("chip_smoke.echo") as span:
                reply = client.transport.request(
                    "GET", f"{server_root}/gordo/v0/{PROJECT}/models",
                    headers=tracing.propagation_headers(span), timeout=30)
                echoed = reply.headers.get("x-gordo-trace-id") == span.trace_id
        finally:
            os.environ.pop(tracing.TRACE_LOG_ENV_VAR, None)
        records = tracing.read_spans(spans)
        requests_ = {r["span_id"]: r for r in records if r["name"] == "client.request"}
        served = [r for r in records if r["name"] == "server.request"
                  and r["parent_span_id"] in requests_
                  and r["trace_id"] == requests_[r["parent_span_id"]]["trace_id"]]
        chrome = os.path.join(workdir, "chrome.json")
        from gordo_tpu_torch.cli import trace as trace_cli

        exported = trace_cli.main(["export", os.path.dirname(spans), "-o", chrome])
        with open(chrome) as fh:
            events = json.load(fh)["traceEvents"]
        complete = [e for e in events if e.get("ph") == "X"]
        report["tracing"] = {"spans": len(records), "client_requests": len(requests_),
                             "server_requests_under_client": len(served), "echoed": echoed,
                             "chrome_events": len(complete),
                             "errors": traced[0].error_messages}
        if not (echoed and exported == 0 and len(served) == len(requests_)
                == report["chunks"][name] and len(complete) == len(records)):
            raise AssertionError(f"tracing: {report['tracing']}")

        # (e) /metrics: the requests sent, the ledger's server phases
        with urllib.request.urlopen(f"{server_root}/metrics", timeout=60) as reply:
            samples = prom_text.parse_samples(reply.read().decode())
        counted = sum(v for (n, _), v in samples.items() if n == "gordo_server_requests_total")
        phases = sorted({dict(labels)["phase"] for (n, labels) in samples
                         if n == "gordo_phase_seconds_count"
                         and dict(labels).get("plane") == "server"})
        report["metrics"] = {"requests_counted": counted, "requests_sent": app.requests,
                             "server_phases": phases}
        expected_phases = {"parse", "transform", "transfer", "device", "postprocess", "serialize"}
        if counted != app.requests or not expected_phases <= set(phases) <= set(
                attribution.PHASES):
            raise AssertionError(f"/metrics: {report['metrics']}")

        # (g) what tracing and the ledger cost
        report["tracing_overhead"] = tracing.measure_overhead()
        report["ledger_overhead"] = attribution.measure_overhead()
        X, y = raw[name]
        body = {"X": frame_to_dict(X, slice(0, SERVE_ROWS[0])),
                "y": frame_to_dict(y, slice(0, SERVE_ROWS[0]))}
        walls = {"on": [], "off": []}
        for _ in range(2):
            for mode in ("on", "off"):
                if mode == "off":
                    os.environ[attribution.LEDGER_ENV_VAR] = "0"
                try:
                    for _ in range(CLIENT_LEDGER_REPEATS):
                        status, _, seconds = request_json(f"{base}/{name}/anomaly/prediction",
                                                          body)
                        walls[mode].append(1e3 * seconds)
                finally:
                    os.environ.pop(attribution.LEDGER_ENV_VAR, None)
        report["ledger_request_ms"] = {mode: statistics.median(v) for mode, v in walls.items()}
        client.transport.close()
    report["kernel_launches"] = {"client_predict": solo_launches, "client_fleet": fleet_launches,
                                 "client_stream": stream_launches}
    log("client", json.dumps({k: v for k, v in report.items() if k != "kernel_launches"}))
    return report


# Phase 18, "tuning and the plane", over phase 10's collection and list:
# (a) PLANE_REPLICAS `run-server` replicas over one shard manifest and a
# `run-router --rollup-interval TUNING_ROLLUP_INTERVAL --rollup-persist`,
# phase 11's 144-row fleet request through the router TUNING_REQUESTS
# times; (b) `slo check` of TUNING_SLO over the router's URL and over the
# persisted rollup, `top --once --as-json`, `rollup --once`; (c) `tune
# calibrate` with TUNING_CALIBRATE's arms on the card; (d) `tune plan` and
# `tune fit` over phase 10's collection, the rollup and (c)'s directory,
# the profile written into a fresh directory; (e) `build-fleet` of phase
# 10's four Transformers (its Transformer unit only) into that directory;
# (f) `run-server` on it, with and without TUNING_ENV_WAIT_MS in the
# environment
TUNING_REQUESTS = 20
#: seconds between the routed requests: their polls' windows then hold
#: the first request's cold forward (module load, first launches) alone
#: among several warm ones, as steady traffic would
TUNING_REQUEST_GAP = 0.15
TUNING_ROLLUP_INTERVAL = 1.0
TUNING_POLL_TIMEOUT = 60.0
TUNING_SLO = {"name": "smoke", "objectives": [
    {"name": "predict-latency", "signal": "predict_p99_ms", "threshold": 250.0,
     "window_s": 3600, "budget": 0.5},
    {"name": "errors", "signal": "unstructured_error_rate", "threshold": 0.01,
     "window_s": 3600, "budget": 0.01},
]}
TUNING_CALIBRATE = ["--epoch-chunks", "1,4", "--epochs", "4", "--batch-wait-sweep", "0,2",
                    "--duration", "1"]
TUNING_ENV_WAIT_MS = 7.0
#: the variables phase 18's in-process build and calibration run without:
#: a machines list, a worker id, a tuning profile override, the tuned
#: options' own variables
FLEET_ENV_DROP = ("MACHINES", "GORDO_WORKER_ID", "GORDO_TUNING", "GORDO_EPOCH_CHUNK",
                  "GORDO_BUCKET_POLICY", "GORDO_BUILD_WORKERS", "GORDO_LEASE_TTL",
                  "GORDO_PRECISION", "GORDO_PREFETCH_DEPTH", "GORDO_BATCH")
#: the knobs whose values only schedule work: a build that applied no
#: other knob writes phase 10's artifacts bit for bit
TUNING_SCHEDULING_KNOBS = ("epoch_chunk", "prefetch_depth")


def fleet_request_body(collection: str, n_rows: int, start: int = 0) -> dict:
    """Phase 11's fleet request: ``n_rows`` rows from ``start`` of each
    of phase 10's four Transformers, as X and y."""
    return {"machines": {name: fleet_request_frame(collection, name, n_rows, start)
                         for name in (f"{MACHINE}-{i}" for i in range(FLEET_TRANSFORMERS))}}


def get_json(url: str):
    with urllib.request.urlopen(url, timeout=60) as reply:
        return json.loads(reply.read())


def prom_values(text: str, name: str) -> dict:
    """``{label text: value}`` of the samples of ``name`` in Prometheus
    text."""
    out = {}
    for line in text.splitlines():
        if line.startswith(name) and not line.startswith("#"):
            key, _, value = line.rpartition(" ")
            if key == name or key.startswith(name + "{"):
                out[key[len(name):]] = float(value)
    return out


def stop_processes(processes) -> None:
    for process in processes:
        if process.poll() is None:
            process.terminate()
    for process in processes:
        try:
            process.wait(timeout=30)
        except subprocess.TimeoutExpired:
            process.kill()
            process.wait(timeout=30)


@contextlib.contextmanager
def scoped_environ(drop=(), **values):
    """The process environment with ``values`` set and the variables in
    ``drop`` (or starting with one of them) unset, for the ``with`` block."""
    saved = dict(os.environ)
    for name in list(os.environ):
        if name.startswith(tuple(drop)):
            del os.environ[name]
    os.environ.update(values)
    try:
        yield
    finally:
        os.environ.clear()
        os.environ.update(saved)


def rollup_plane_check(fa, collection: str, workdir: str, device=None) -> dict:
    """Phase 18 (a) and (b)."""
    from gordo_tpu_torch.router.ring import HashRing
    from gordo_tpu_torch.server.app import build_app
    from gordo_tpu_torch.server.catalog import write_shard_manifest

    root = os.path.dirname(os.path.abspath(__file__))
    n_layers = BASE_ESTIMATOR["n_layers"]
    shards = HashRing(PLANE_REPLICAS).partition(
        [f"{MACHINE}-{i}" for i in range(FLEET_TRANSFORMERS)])
    persist = os.path.join(workdir, "rollup.jsonl")
    manifest = write_shard_manifest(os.path.join(workdir, "manifest.json"), PLANE_REPLICAS)
    ports = {rid: free_port() for rid in PLANE_REPLICAS}
    router_port = free_port()
    counts = {rid: os.path.join(workdir, f"{rid}.json") for rid in PLANE_REPLICAS}
    payload = json.dumps(fleet_request_body(collection, 144)).encode()
    report = {"shards": shards}
    processes = {}
    try:
        t0 = time.perf_counter()
        for rid in PLANE_REPLICAS:
            processes[rid] = subprocess.Popen(
                [sys.executable, "-c", REPLICA_DRIVER, counts[rid], "run-server",
                 "--collection-dir", collection, "--host", "127.0.0.1", "--port",
                 str(ports[rid]), "--batch-wait-ms", "0", "--shard-manifest", manifest,
                 "--replica-id", rid, *(["--device", device] if device else [])],
                cwd=root, stdout=subprocess.DEVNULL,
                stderr=open(os.path.join(workdir, f"{rid}.log"), "w"))
        processes["router"] = subprocess.Popen(
            [sys.executable, "-m", "gordo_tpu_torch.cli", "run-router", "--host", "127.0.0.1",
             "--port", str(router_port), "--collection-dir", collection,
             "--rollup-interval", str(TUNING_ROLLUP_INTERVAL), "--rollup-persist", persist,
             *[arg for rid in PLANE_REPLICAS
               for arg in ("--replica", f"{rid}=http://127.0.0.1:{ports[rid]}")]],
            cwd=root, stdout=subprocess.DEVNULL,
            stderr=open(os.path.join(workdir, "router.log"), "w"))
        # the direct reply while the plane starts
        single = build_app(collection, device=device, batch_wait_ms=0)
        with http_server(collection, None, app=single) as direct:
            want = post(f"{direct}/anomaly/prediction/fleet", payload)[0]["data"]
        for rid in PLANE_REPLICAS:
            wait_ready(f"http://127.0.0.1:{ports[rid]}/healthz", processes[rid])
        router = f"http://127.0.0.1:{router_port}"
        wait_ready(f"{router}/healthz", processes["router"])
        report["start_s"] = time.perf_counter() - t0
        routed = f"{router}/gordo/v0/{PROJECT}/anomaly/prediction/fleet"
        # the replicas' launches from 0 for the first request, then the rest
        before = {rid: replica_counts(processes[rid], counts[rid])["kernels"]
                  for rid in PLANE_REPLICAS}
        seconds = []
        for i in range(TUNING_REQUESTS):
            got, took = post(routed, payload)
            seconds.append(took)
            if got["data"] != want:
                raise AssertionError(f"routed request {i} differs from the direct server's")
            if i == 0:
                first = {rid: replica_counts(processes[rid], counts[rid])["kernels"]
                         for rid in PLANE_REPLICAS}
            time.sleep(TUNING_REQUEST_GAP)
        after = {rid: replica_counts(processes[rid], counts[rid])["kernels"]
                 for rid in PLANE_REPLICAS}
        launches, per_request = {}, {}
        for rid in PLANE_REPLICAS:
            launches[rid] = {k: after[rid][k] - before[rid][k] for k in before[rid]}
            per_request[rid] = {k: first[rid][k] - before[rid][k] for k in before[rid]}
            forward = sum(v for k, v in per_request[rid].items()
                          if k.startswith(fa.KERNEL + "_"))
            backward = launches[rid][f"{fa.KERNEL_DQ}_quad"] + launches[rid][
                f"{fa.KERNEL_DKV}_quad"]
            # phase 14c's: one stacked forward a layer for a request its
            # shard's Transformers are in, none for a shard without them
            if (forward != (n_layers if rid in shards else 0) or backward
                    or any(launches[rid][k] != TUNING_REQUESTS * per_request[rid][k]
                           for k in launches[rid])):
                raise AssertionError(f"replica {rid}: {launches[rid]} launches for "
                                     f"{TUNING_REQUESTS} requests, {per_request[rid]} the first")
        report["replica_launches"] = launches
        report["kernel_launches"] = {k: sum(launches[rid][k] for rid in PLANE_REPLICAS)
                                     for k in launches[PLANE_REPLICAS[0]]}
        report["request_s"] = {"median": statistics.median(seconds), "max": max(seconds)}
        log("tuning plane: routed", TUNING_REQUESTS, "requests bitwise the direct server's;",
            json.dumps(report["request_s"]), "launches",
            json.dumps({rid: {k: v for k, v in by_kernel.items() if v}
                        for rid, by_kernel in launches.items()}))

        # two polls after the traffic: the merge then holds every request
        polls = get_json(f"{router}/status")["poll"]["n_polls"]
        t0 = time.perf_counter()
        while get_json(f"{router}/status")["poll"]["n_polls"] < polls + 2:
            if time.perf_counter() - t0 > TUNING_POLL_TIMEOUT:
                raise AssertionError("the router's rollup did not poll twice in "
                                     f"{TUNING_POLL_TIMEOUT} s")
            time.sleep(0.2)
        status = get_json(f"{router}/status")
        with urllib.request.urlopen(f"{router}/metrics", timeout=60) as reply:
            metrics_status, metrics = reply.status, reply.read().decode()
        own = get_json(f"{router}/telemetry/snapshot")
        replica_counts_sum = 0
        for rid in PLANE_REPLICAS:
            snap = get_json(f"http://127.0.0.1:{ports[rid]}/telemetry/snapshot")
            series = (snap["metrics"].get("gordo_server_phase_seconds") or {}).get("series", [])
            replica_counts_sum += sum(s["count"] for s in series
                                      if s["labels"] == {"phase": "predict"})
        merged_predict = prom_values(metrics, "gordo_server_phase_seconds_count").get(
            '{phase="predict"}')
        merged_ok = prom_values(metrics, "gordo_router_requests_total").get('{outcome="ok"}')
        report["rollup"] = {
            "n_polls": status["poll"]["n_polls"], "member_errors": status["poll"]["member_errors"],
            "merged_predict_count": merged_predict, "replicas_predict_count": replica_counts_sum,
            "merged_router_ok": merged_ok, "signals": status["signals"],
            "merge_errors": status["merge_errors"], "router_role": own["role"],
        }
        log("tuning plane: rollup", json.dumps(report["rollup"]))
        if (metrics_status != 200 or own["role"] != "router" or status["merge_errors"]
                or status["poll"]["member_errors"] or merged_ok != TUNING_REQUESTS
                or merged_predict != replica_counts_sum or replica_counts_sum < TUNING_REQUESTS
                or sorted(status["replicas"]) != sorted(PLANE_REPLICAS)):
            raise AssertionError(f"the router's plane view: {report['rollup']}")
        with open(persist) as fh:
            lines = [json.loads(line) for line in fh if line.strip()]
        report["rollup"]["persisted_lines"] = len(lines)
        if len(lines) < 2 or not all(line.get("unix_ms") and line.get("role") == "plane"
                                     and "signals" in line for line in lines):
            raise AssertionError(f"{persist}: {len(lines)} lines")

        # (b) the plane's commands
        spec = os.path.join(workdir, "slo.json")
        with open(spec, "w") as fh:
            json.dump(TUNING_SLO, fh)
        report["slo"] = {}
        for label, target in (("url", f"{router}/status"), ("rollup", persist)):
            out = cli_output(["slo", "check", spec, target, "--as-json"])
            verdict = json.loads(out)
            report["slo"][label] = {o["name"]: {"last": o["last_value"], "n": o["n_samples"]}
                                    for o in verdict["objectives"]}
            if not verdict["ok"]:
                raise AssertionError(f"slo check {label}: {verdict}")
        top = json.loads(cli_output(["top", router, "--once", "--as-json"]))
        merged = json.loads(cli_output(
            ["rollup", *[arg for rid in PLANE_REPLICAS
                         for arg in ("--member", f"{rid}=http://127.0.0.1:{ports[rid]}")],
             "--once"]))
        report["top"] = {"role": top["role"], "replicas": sorted(top["replicas"]),
                         "signals": top["signals"]}
        report["rollup_once"] = {"members": sorted(merged["members"]),
                                 "merge_errors": merged["merge_errors"]}
        log("tuning plane: slo", json.dumps(report["slo"]), "top", json.dumps(report["top"]),
            "rollup --once", json.dumps(report["rollup_once"]))
        if (top["role"] != "plane" or sorted(top["replicas"]) != sorted(PLANE_REPLICAS)
                or report["rollup_once"]["members"] != sorted(PLANE_REPLICAS)
                or merged["merge_errors"]):
            raise AssertionError(f"top / rollup: {report['top']} {report['rollup_once']}")
        report["persist"] = persist
        return report
    finally:
        stop_processes(processes.values())


def start_tuned_servers(tuned: str, workdir: str, device=None) -> dict:
    """Phase 18 (f)'s two `run-server` subprocesses on the tuned
    directory, started while (e) builds into it: one as it is, one with
    ``GORDO_BATCH_WAIT_MS`` set. {label: (process, port, event log)}."""
    root = os.path.dirname(os.path.abspath(__file__))
    servers = {}
    for label, extra in (("profile", {}), ("env", {"GORDO_BATCH_WAIT_MS":
                                                   str(TUNING_ENV_WAIT_MS)})):
        port, log_path = free_port(), os.path.join(workdir, f"serve-{label}-events.jsonl")
        env = {k: v for k, v in os.environ.items() if not k.startswith("GORDO_BATCH")}
        env.update(extra, GORDO_TPU_EVENT_LOG=log_path)
        process = subprocess.Popen(
            [sys.executable, "-m", "gordo_tpu_torch.cli", "run-server", "--collection-dir",
             tuned, "--host", "127.0.0.1", "--port", str(port),
             *(["--device", device] if device else [])],
            cwd=root, env=env, stdout=subprocess.DEVNULL,
            stderr=open(os.path.join(workdir, f"serve-{label}.log"), "w"))
        servers[label] = (process, port, log_path)
    return servers


def tuned_server_check(collection: str, tuned: str, profile: dict, servers: dict,
                       device=None) -> dict:
    """Phase 18 (f): each of ``servers`` (``start_tuned_servers``) asked
    for phase 11's request once the tuned build is in place."""
    from gordo_tpu_torch.observability import read_events
    from gordo_tpu_torch.server.app import SERVER_TUNED_OPTIONS, build_app

    casts = {option.knob: option.cast for option in SERVER_TUNED_OPTIONS}
    server_recs = {name: casts[name](rec["value"])
                   for name, rec in profile["recommendations"].items() if name in casts}
    payload = json.dumps(fleet_request_body(collection, 144)).encode()
    for process, port, _ in servers.values():
        wait_ready(f"http://127.0.0.1:{port}/healthz", process)
    # a server with no profile: every tuned setting given
    plain = build_app(tuned, device=device, batch_wait_ms=0, batch_queue_limit=64,
                      scorer_cache_size=16)
    with http_server(tuned, None, app=plain) as direct:
        want = post(f"{direct}/anomaly/prediction/fleet", payload)[0]["data"]
    report = {"recommended": server_recs}
    for label, (_, port, log_path) in servers.items():
        base = f"http://127.0.0.1:{port}"
        got = post(f"{base}/gordo/v0/{PROJECT}/anomaly/prediction/fleet", payload)[0]["data"]
        # a server that applied nothing emitted nothing: no log file
        events = [e for e in (read_events(log_path) if os.path.exists(log_path) else [])
                  if e["event"] == "tuning_profile_loaded"]
        batching = get_json(f"{base}/healthz")["batching"]
        report[label] = {"bitwise": got == want, "applied": [e["applied"] for e in events],
                         "batch_wait_ms": batching["batch_wait_ms"],
                         "queue_limit": batching["queue_limit"]}
    log("tuning plane: tuned servers", json.dumps(report))
    expected = {"profile": dict(server_recs),
                "env": {k: v for k, v in server_recs.items() if k != "batch_wait_ms"}}
    for label, applied in expected.items():
        if not report[label]["bitwise"]:
            raise AssertionError(f"the {label} server's reply differs from no profile's")
        if report[label]["applied"] != ([applied] if applied else []):
            raise AssertionError(f"the {label} server applied {report[label]['applied']}, "
                                 f"the profile recommends {server_recs}")
    if report["env"]["batch_wait_ms"] != TUNING_ENV_WAIT_MS or (
            "batch_wait_ms" in server_recs
            and report["profile"]["batch_wait_ms"] != float(server_recs["batch_wait_ms"])):
        raise AssertionError(f"the servers' batch waits: {report}")
    return report


def tuning_phase(torch, fa, profile: bool, fleet: dict, device=None):
    """Phase 18 (the module docstring's): on the card unless ``device``
    names another (a rehearsal)."""
    from gordo_tpu_torch.tuning.knobs import KNOBS_BY_NAME
    from gordo_tpu_torch.tuning.profile import TUNING_PROFILE_FILENAME

    collection = fleet["collection"]
    workdir = tempfile.mkdtemp(prefix="tuning-", dir=os.path.dirname(collection))
    device_args = ["--device", device] if device else []
    report = {}

    t0 = time.perf_counter()
    report["plane"] = rollup_plane_check(fa, collection, workdir, device)
    report["plane_s"] = time.perf_counter() - t0

    # (c) a calibration corpus, on the card, in this process (a process's
    # start-up would cost more than the sweep; its serving arms reset the
    # process registry, which no later phase reads)
    calibration = os.path.join(workdir, "calibration")
    t0 = time.perf_counter()
    with scoped_environ(drop=FLEET_ENV_DROP):
        cli_output(["tune", "calibrate", calibration, *TUNING_CALIBRATE, *device_args])
    report["calibrate_s"] = time.perf_counter() - t0
    with open(os.path.join(calibration, "results_calibration.json")) as fh:
        sweep = json.load(fh)
    report["calibration"] = {
        "epoch_chunk_sweep": [{k: row[k] for k in ("epoch_chunk", "steady_state_epoch_s",
                                                   "steady_state_sensor_timesteps_per_s",
                                                   "losses_bitequal_vs_smallest_chunk")}
                              for row in sweep["epoch_chunk_sweep"]],
        "batch_wait_sweep": [{k: arm.get(k) for k in ("batch_wait_ms", "requests", "errors",
                                                      "p50_ms", "p99_ms", "achieved_rps")}
                             for arm in sweep["batch_wait_sweep"]],
    }
    log("tuning plane: calibration", report["calibrate_s"], "s",
        json.dumps(report["calibration"]))
    if (not all(row["losses_bitequal_vs_smallest_chunk"] for row in sweep["epoch_chunk_sweep"])
            or [row["epoch_chunk"] for row in sweep["epoch_chunk_sweep"]] != [1, 4]
            or [arm["batch_wait_ms"] for arm in sweep["batch_wait_sweep"]] != [0.0, 2.0]
            or any(arm["errors"] or not arm["requests"] for arm in sweep["batch_wait_sweep"])):
        raise AssertionError(f"tune calibrate: {report['calibration']}")

    # (d) the plan and the profile, in a fresh directory
    corpus = [collection, report["plane"]["persist"], calibration]
    tuned = os.path.join(workdir, "tuned")
    os.makedirs(tuned)
    t0 = time.perf_counter()
    plan = json.loads(cli_output(["tune", "plan", "--as-json", *corpus]))
    fitted = cli_output(["tune", "fit", *corpus, "--out", tuned])
    checked = cli_output(["tune", "plan", "--check", tuned])
    report["fit_s"] = time.perf_counter() - t0
    with open(os.path.join(tuned, TUNING_PROFILE_FILENAME)) as fh:
        profile_json = json.load(fh)
    recs = profile_json["recommendations"]
    report["corpus"] = {k: plan["corpus"][k] for k in ("n_files", "n_observations")}
    report["recommendations"] = {
        name: {"value": rec["value"], "source": rec["source"], "signal": rec["signal"],
               "predicted": rec["predicted"], "predicted_default": rec["predicted_default"],
               "evidence": [(arm["value"], arm["mean"], arm["n"]) for arm in rec["evidence"]]}
        for name, rec in recs.items()}
    log("tuning plane: tune fit\n" + fitted.rstrip() + "\n" + checked.rstrip())
    if (plan["recommendations"] != recs or not recs
            or any(KNOBS_BY_NAME[name].unported for name in recs)
            or "ok (" not in checked):
        raise AssertionError(f"tune plan / fit / check: {report['recommendations']}")

    # (f)'s servers start while (e) builds into their directory
    servers = start_tuned_servers(tuned, workdir, device)
    try:
        report.update(tuned_build_and_serve(fa, fleet, recs, profile_json, tuned, workdir,
                                            device_args, servers, device))
    finally:
        stop_processes([process for process, _, _ in servers.values()])
    return report


def tuned_build_and_serve(fa, fleet: dict, recs: dict, profile_json: dict, tuned: str,
                          workdir: str, device_args, servers: dict, device=None) -> dict:
    """Phase 18 (e), then (f) over ``servers``."""
    import numpy as np

    from gordo_tpu_torch.cli.cli import FLEET_TUNED_OPTIONS
    from gordo_tpu_torch.observability import read_events
    from gordo_tpu_torch.tuning.knobs import KNOBS_BY_NAME

    root = os.path.dirname(os.path.abspath(__file__))
    collection = fleet["collection"]
    report = {}
    builder_recs = {name: rec["value"] for name, rec in recs.items()
                    if KNOBS_BY_NAME[name].subsystem in ("builder", "ledger")}
    listing = os.path.join(workdir, "transformers.yaml")
    with open(listing, "w") as fh:
        fh.write(yaml_text(fleet_machines(root)[:FLEET_TRANSFORMERS]) + "\n")
    events = os.path.join(workdir, "tuned-build-events.jsonl")
    # in this process (a process's start-up is a fifth of the build), its
    # launches counted from here
    before = dict(fa.kernel_launches)
    t0 = time.perf_counter()
    with scoped_environ(drop=FLEET_ENV_DROP, OUTPUT_DIR=tuned, GORDO_TPU_EVENT_LOG=events):
        built = cli_output(["build-fleet", "--machines-from", listing, *device_args])
    report["build_s"] = time.perf_counter() - t0
    report["build_launches"] = {k: v - before[k] for k, v in fa.kernel_launches.items()}
    if "FAILED" in built or "QUARANTINED" in built:
        raise AssertionError(f"tuned build-fleet:\n{built[-2000:]}")
    applied = [e["applied"] for e in read_events(events) if e["event"] == "tuning_profile_loaded"]
    report["build_applied"] = applied
    worst, differing = 0.0, []
    for name in (f"{MACHINE}-{i}" for i in range(FLEET_TRANSFORMERS)):
        got = npz_arrays(os.path.join(tuned, name, "params.npz"))
        want = npz_arrays(os.path.join(fleet["transformer_params"], f"{name}.npz"))
        for key in want:
            if got[key].tobytes() != want[key].tobytes():
                differing.append(f"{name}/{key}")
                worst = max(worst, float(np.abs(got[key].astype(np.float64)
                                                - want[key].astype(np.float64)).max()))
    report["params_bitwise"] = not differing
    report["params_max_abs_diff"] = worst
    report["params_differing_knobs"] = sorted(set(builder_recs) - set(TUNING_SCHEDULING_KNOBS))
    log("tuning plane: tuned build", report["build_s"], "s, applied", json.dumps(applied),
        "launches", json.dumps({k: v for k, v in report["build_launches"].items() if v}),
        "params bitwise phase 10's", report["params_bitwise"], "largest difference", worst,
        "non-scheduling knobs applied", report["params_differing_knobs"])
    casts = {option.knob: option.cast for option in FLEET_TUNED_OPTIONS}
    expected = {name: casts[name](value) for name, value in builder_recs.items()}
    if applied != ([expected] if expected else []):
        raise AssertionError(f"the tuned build applied {applied}, the profile {builder_recs}")
    for kernel in (fa.KERNEL, fa.KERNEL_DQ, fa.KERNEL_DKV):
        name = f"{kernel}_quad"
        if report["build_launches"][name] != fleet["kernel_launches"][name]:
            raise AssertionError(f"the tuned build launched {name} "
                                 f"{report['build_launches'][name]} times, phase 10's "
                                 f"{fleet['kernel_launches'][name]}")
    if not report["params_differing_knobs"] and differing:
        raise AssertionError(f"scheduling knobs only, yet params differ by {worst}: {differing}")

    # (f) the tuned servers, and the environment over the profile
    t0 = time.perf_counter()
    report["servers"] = tuned_server_check(collection, tuned, profile_json, servers, device)
    report["servers_s"] = time.perf_counter() - t0
    return report


# Phase 19: game days. (a) the fault sites of the serving plane on phase
# 10's collection: PLANE_REPLICAS `run-server` replicas (batching on,
# FAULT_BATCH_WAIT_MS) and a `run-router` (a replica ejected after one
# failure, windows scaled by FAULT_BACKOFF_SCALE, no prober), each a
# subprocess armed and disarmed through one GORDO_FAULT_INJECT_FILE while
# it runs; (b) `gameday run` of the shipped scenarios in one subprocess on
# the card, then `gameday run rolling-upgrade`, refused
FAULT_BATCH_WAIT_MS = 100
FAULT_BACKOFF_SCALE = 0.01
FAULT_BATCH_REQUESTS = 4
FAULT_STREAM_CHUNKS = (STREAM_FIRST, 144, 144)
FAULT_REQUEST_GAP = 0.1
FAULT_MAX_REQUESTS = 40
GAMEDAY_TIMEOUT = 600


def request_with_headers(url: str, body=None):
    """(status, parsed JSON reply, headers) of a POST of ``body`` as JSON,
    whatever the status."""
    import urllib.error

    request = urllib.request.Request(
        url, data=json.dumps(body).encode() if body is not None else b"",
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(request, timeout=600) as reply:
            return reply.status, json.loads(reply.read()), dict(reply.headers)
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read()), dict(err.headers)


def metric_series(snapshot: dict, name: str, field: str = "count") -> dict:
    """``{labels as sorted tuples: value}`` of one metric of a
    ``/telemetry/snapshot`` body (a histogram's ``field``: count or sum)."""
    out = {}
    for series in (snapshot.get("metrics", {}).get(name) or {}).get("series", []):
        key = tuple(sorted(series["labels"].items()))
        out[key] = series.get("value", series.get(field))
    return out


def fault_plane_check(torch, fa, collection: str, workdir: str, device=None) -> dict:
    """Phase 19a (the module docstring's)."""
    from urllib.parse import urlsplit

    import numpy as np

    from gordo_tpu_torch.client.client import Client
    from gordo_tpu_torch.observability import read_events
    from gordo_tpu_torch.robustness import faults
    from gordo_tpu_torch.router.ring import HashRing
    from gordo_tpu_torch.server.app import build_app
    from gordo_tpu_torch.server.catalog import write_shard_manifest

    root = os.path.dirname(os.path.abspath(__file__))
    ring = HashRing(PLANE_REPLICAS)
    transformers = [f"{MACHINE}-{i}" for i in range(FLEET_TRANSFORMERS)]
    everything = [m["name"] for m in fleet_machines(root)]
    shards = ring.partition(everything)
    body = fleet_request_body(collection, 144)
    fault_file = os.path.join(workdir, "faults.spec")
    manifest = write_shard_manifest(os.path.join(workdir, "manifest.json"), PLANE_REPLICAS)
    ports = {rid: free_port() for rid in PLANE_REPLICAS}
    router_port = free_port()
    counts = {rid: os.path.join(workdir, f"{rid}.json") for rid in PLANE_REPLICAS}
    events = {name: os.path.join(workdir, f"{name}-events.jsonl")
              for name in (*PLANE_REPLICAS, "router")}
    report = {"shards": shards}
    processes = {}

    def env(name):
        return dict(os.environ, **{faults.FAULT_INJECT_FILE_ENV_VAR: fault_file,
                                   "GORDO_TPU_EVENT_LOG": events[name]})

    def arm(spec):
        faults.arm_file(fault_file, spec)
        log("fault plane: armed", spec)

    try:
        t0 = time.perf_counter()
        for rid in PLANE_REPLICAS:
            processes[rid] = subprocess.Popen(
                [sys.executable, "-c", REPLICA_DRIVER, counts[rid], "run-server",
                 "--collection-dir", collection, "--host", "127.0.0.1", "--port",
                 str(ports[rid]), "--batch-wait-ms", str(FAULT_BATCH_WAIT_MS),
                 "--shard-manifest", manifest, "--replica-id", rid,
                 *(["--device", device] if device else [])],
                cwd=root, env=env(rid), stdout=subprocess.DEVNULL,
                stderr=open(os.path.join(workdir, f"{rid}.log"), "w"))
        processes["router"] = subprocess.Popen(
            [sys.executable, "-m", "gordo_tpu_torch.cli", "run-router", "--host", "127.0.0.1",
             "--port", str(router_port), "--collection-dir", collection, "--eject-after", "1",
             "--backoff-scale", str(FAULT_BACKOFF_SCALE), "--probe-interval", "0",
             *[arg for rid in PLANE_REPLICAS
               for arg in ("--replica", f"{rid}=http://127.0.0.1:{ports[rid]}")]],
            cwd=root, env=env("router"), stdout=subprocess.DEVNULL,
            stderr=open(os.path.join(workdir, "router.log"), "w"))
        # the direct server's replies while the plane starts
        single = build_app(collection, device=device, batch_wait_ms=0)
        with http_server(collection, None, app=single) as direct:
            want = post(f"{direct}/anomaly/prediction/fleet", json.dumps(body).encode())[0]
            streamed = transformers[0]
            direct_stream = Client(PROJECT, host="127.0.0.1", port=urlsplit(direct).port,
                                   scheme="http").stream_machine(streamed)
            X = np.asarray(fleet_request_rows(collection, streamed, sum(FAULT_STREAM_CHUNKS)))
            want_stream = stream_through(direct_stream, X)
        for rid in PLANE_REPLICAS:
            wait_ready(f"http://127.0.0.1:{ports[rid]}/healthz", processes[rid])
        router = f"http://127.0.0.1:{router_port}"
        wait_ready(f"{router}/healthz", processes["router"])
        report["start_s"] = time.perf_counter() - t0
        replica_url = {rid: f"http://127.0.0.1:{ports[rid]}" for rid in PLANE_REPLICAS}
        routed = f"{router}/gordo/v0/{PROJECT}/anomaly/prediction/fleet"
        before = {rid: replica_counts(processes[rid], counts[rid])["kernels"]
                  for rid in PLANE_REPLICAS}
        snapshots0 = {rid: get_json(f"{url}/telemetry/snapshot")
                      for rid, url in replica_url.items()}
        t0 = time.perf_counter()

        # (i) serve: the named machine's routes answer 503, the others serve
        victim = transformers[0]
        owner = ring.owner(victim)
        other = next(m for m in shards[owner] if m != victim)
        arm(f"serve:raise:{victim}")
        base = f"{replica_url[owner]}/gordo/v0/{PROJECT}"
        served = {
            "single": request_with_headers(f"{base}/{victim}/anomaly/prediction",
                                           body["machines"][victim])[:2],
            "fleet": request_with_headers(f"{base}/anomaly/prediction/fleet",
                                          {"machines": {victim: body["machines"][victim]}})[:2],
            "other": request_with_headers(f"{base}/prediction/fleet", {"machines": {
                other: fleet_request_frame(collection, other, 144, anomaly=False)}})[:2],
        }
        report["serve"] = {k: v[0] for k, v in served.items()}
        log("fault plane: serve", json.dumps(report["serve"]))
        for key in ("single", "fleet"):
            status, reply = served[key]
            if status != 503 or not reply["error"].startswith(
                    f"Fault injection: Injected fault at site 'serve' for machine '{victim}'"):
                raise AssertionError(f"serve fault on the {key} route: {status} {reply}")
        if served["other"][0] != 200:
            raise AssertionError(f"serve fault hit {other}: {served['other']}")

        # (ii) batch: four concurrent requests in one batch, only the named fails
        arm(f"batch:raise:{victim}")
        others = [m for m in shards[owner] if m != victim]
        bodies = [{"machines": {m: fleet_request_frame(collection, m, 144, anomaly=False)}}
                  for m in [victim, *(others * FAULT_BATCH_REQUESTS)[:FAULT_BATCH_REQUESTS - 1]]]
        snap = get_json(f"{replica_url[owner]}/telemetry/snapshot")
        batches0 = [sum(metric_series(snap, "gordo_serve_batch_requests", f).values())
                    for f in ("count", "sum")]
        statuses = [None] * len(bodies)
        barrier = threading.Barrier(len(bodies))

        def send(i):
            barrier.wait()
            statuses[i] = request_with_headers(f"{base}/prediction/fleet", bodies[i])[:2]

        threads = [threading.Thread(target=send, args=(i,)) for i in range(len(bodies))]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(timeout=120)
        snap = get_json(f"{replica_url[owner]}/telemetry/snapshot")
        dispatches, coalesced = [
            sum(metric_series(snap, "gordo_serve_batch_requests", f).values()) - was
            for f, was in zip(("count", "sum"), batches0)]
        report["batch"] = {"statuses": [s for s, _ in statuses], "dispatches": dispatches,
                           "requests": coalesced}
        log("fault plane: batch", json.dumps(report["batch"]))
        if [s for s, _ in statuses] != [503] + [200] * (len(bodies) - 1) \
                or "site 'batch'" not in statuses[0][1]["error"] \
                or (dispatches, coalesced) != (1, len(bodies)):
            raise AssertionError(f"batch fault: {report['batch']} {statuses[0][1]}")

        # (iii) replica:die: transient 409s, failover and recovery, replies
        # bitwise the direct server's
        rid = max(shards, key=lambda r: len(set(shards[r]) & set(transformers)))
        mine = sorted(set(shards[rid]) & set(transformers))
        arm(f"replica:die:{rid}@attempts:2")
        report["die"] = route_until(routed, body, want, mine, rid, router, lambda fired, seen:
                                    fired >= 2 and seen[-1] == 200)
        if report["die"]["fired"] != 2 or 409 not in report["die"]["statuses"]:
            raise AssertionError(f"replica die: {report['die']}")

        # (iv) replica:flap: ejected and recovered again and again
        arm(f"replica:flap:{rid}@burst:3")
        report["flap"] = route_until(routed, body, want, mine, rid, router, lambda fired, seen:
                                     recovered_after_ejection(events["router"]))
        faults.disarm_file(fault_file)
        kinds = [e["event"] for e in read_events(events["router"])
                 if e.get("replica", rid) == rid or e["event"] == "shard_failover"]
        report["router_events"] = {k: kinds.count(k) for k in sorted(set(kinds))}
        log("fault plane: router events", json.dumps(report["router_events"]))
        for kind in ("fault_injected", "replica_ejected", "shard_failover", "replica_recovered"):
            if kind not in kinds:
                raise AssertionError(f"the router's event log lacks {kind}: {kinds}")

        # (v) stream:drop: the client's stream through the router resumes bitwise
        arm(f"stream:drop:{streamed}@attempts:1")
        stream = Client(PROJECT, host="127.0.0.1", port=router_port, scheme="http"
                        ).stream_machine(streamed, backoff_scale=FAULT_BACKOFF_SCALE)
        got_stream = stream_through(stream, X)
        report["stream_drop"] = {"reconnects": stream.reconnects,
                                 "rows": int(len(got_stream)),
                                 "bitwise": bool(np.array_equal(got_stream, want_stream))}
        log("fault plane: stream drop", json.dumps(report["stream_drop"]))
        if stream.reconnects != 1 or not report["stream_drop"]["bitwise"]:
            raise AssertionError(f"stream drop: {report['stream_drop']}")

        # (vi) stream:burst: a 503 with Retry-After
        arm(f"stream:burst:{streamed}@rate:12@attempts:1")
        owner_base = f"{replica_url[ring.owner(streamed)]}/gordo/v0/{PROJECT}"
        status, opened, _ = request_with_headers(f"{owner_base}/stream/open",
                                                 {"machines": [streamed]})
        status, shed, headers = request_with_headers(
            f"{owner_base}/stream/{opened['session']}/update",
            {"updates": {streamed: {"rows": X[:STREAM_FIRST].tolist(), "seq": 0}}})
        retry_after = {k.lower(): v for k, v in headers.items()}.get("retry-after")
        report["stream_burst"] = {"status": status, "retry_after": retry_after}
        request_with_headers(f"{owner_base}/stream/{opened['session']}/close")
        faults.disarm_file(fault_file)
        log("fault plane: stream burst", json.dumps(report["stream_burst"]))
        if status != 503 or not retry_after:
            raise AssertionError(f"stream burst: {status} {shed} {headers}")
        report["checks_s"] = time.perf_counter() - t0

        # the firings, the new series and the launches
        after = {rid: replica_counts(processes[rid], counts[rid])["kernels"]
                 for rid in PLANE_REPLICAS}
        launches = {r: {k: after[r][k] - before[r][k] for k in before[r]} for r in PLANE_REPLICAS}
        report["replica_launches"] = launches
        report["kernel_launches"] = {k: sum(launches[r][k] for r in PLANE_REPLICAS)
                                     for k in launches[PLANE_REPLICAS[0]]}
        router_snapshot = get_json(f"{router}/telemetry/snapshot")
        snapshots = {r: get_json(f"{url}/telemetry/snapshot") for r, url in replica_url.items()}
        fired = {}
        for snapshot, old in ([router_snapshot, None],
                              *[[snapshots[r], snapshots0[r]] for r in PLANE_REPLICAS]):
            for key, value in metric_series(snapshot, "gordo_fault_fired_total").items():
                was = metric_series(old, "gordo_fault_fired_total").get(key, 0) if old else 0
                site = dict(key)["site"]
                fired[site] = fired.get(site, 0) + value - was
        report["fired"] = fired
        series = {}
        for name in ("gordo_serve_group_latency_seconds", "gordo_serve_group_batch_size",
                     "gordo_serve_machines_scored_total", "gordo_stream_updates_total",
                     "gordo_stream_update_seconds", "gordo_stream_update_rows"):
            merged = {}
            for r in PLANE_REPLICAS:
                for key, value in metric_series(snapshots[r], name).items():
                    merged[" ".join(f"{k}={v}" for k, v in key)] = merged.get(
                        " ".join(f"{k}={v}" for k, v in key), 0) + value
            series[name] = merged
        series["gordo_phase_seconds{plane=router}"] = {
            dict(key)["phase"]: value
            for key, value in metric_series(router_snapshot, "gordo_phase_seconds").items()
            if dict(key).get("plane") == "router"}
        report["series"] = series
        log("fault plane: firings", json.dumps(fired))
        log("fault plane: series", json.dumps(series))
        log("fault plane: replica launches", json.dumps(
            {r: {k: v for k, v in by.items() if v} for r, by in launches.items()}))
        missing = [site for site in ("serve", "batch", "replica", "stream")
                   if not fired.get(site)]
        if missing or any(not v for v in series.values()):
            raise AssertionError(f"fault plane: no firing at {missing}, series {series}")
        forward = sum(v for k, v in report["kernel_launches"].items()
                      if k.startswith(fa.KERNEL + "_"))
        backward = report["kernel_launches"][f"{fa.KERNEL_DQ}_quad"] + report[
            "kernel_launches"][f"{fa.KERNEL_DKV}_quad"]
        if forward <= 0 or backward:
            raise AssertionError(f"fault plane launches: {report['kernel_launches']}")
    finally:
        if os.path.exists(fault_file):
            faults.disarm_file(fault_file)
        stop_processes(processes.values())
    return report


def fleet_request_rows(collection: str, name: str, n_rows: int):
    """The first ``n_rows`` rows of a phase 10 machine's data."""
    import numpy as np

    from gordo_tpu_torch import serializer
    from gordo_tpu_torch.data import _get_dataset

    metadata = serializer.load_metadata(os.path.join(collection, name))
    return np.asarray(_get_dataset(metadata["dataset"]).get_data()[0])[:n_rows]


def fleet_request_frame(collection: str, name: str, n_rows: int, start: int = 0,
                        anomaly: bool = True) -> dict:
    """``n_rows`` rows from ``start`` of a phase 10 machine as a request
    frame (``{"X", "y"}`` for the anomaly routes)."""
    import numpy as np

    from gordo_tpu_torch import serializer
    from gordo_tpu_torch.data import _get_dataset
    from gordo_tpu_torch.data.base import to_datetimes

    metadata = serializer.load_metadata(os.path.join(collection, name))
    X, _, stamps = _get_dataset(metadata["dataset"]).get_data()
    keys = [stamp.isoformat() for stamp in to_datetimes(stamps.astype(np.int64))]
    frame = frame_of(np.asarray(X), keys, metadata["dataset"]["tag_list"],
                     slice(start, start + n_rows))
    return {"X": frame, "y": frame} if anomaly else frame


def stream_through(stream, X):
    """``X`` sent in ``FAULT_STREAM_CHUNKS`` by a client stream (opened and
    closed here): the scores, concatenated."""
    import numpy as np

    stream.open()
    out, start = [], 0
    try:
        for k in FAULT_STREAM_CHUNKS:
            scores = stream.send(X[start:start + k])
            if len(scores):
                out.append(np.asarray(scores))
            start += k
    finally:
        stream.close()
    return np.concatenate(out)


def recovered_after_ejection(events_path: str) -> bool:
    from gordo_tpu_torch.observability import read_events

    kinds = [e["event"] for e in read_events(events_path)] if os.path.exists(events_path) else []
    return "replica_ejected" in kinds and "replica_recovered" in kinds[
        len(kinds) - kinds[::-1].index("replica_ejected"):]


def route_until(routed: str, body: dict, want: dict, mine, rid: str, router: str, done) -> dict:
    """Phase 11's 144-row request through the router (``FAULT_REQUEST_GAP``
    s after a 200, at once after a 409), until ``done(firings at the replica site, statuses)``: each
    reply a transient 409 naming exactly ``rid``'s machines, or a 200
    bitwise the direct server's ``want``."""
    def replica_fired():
        return sum(v for k, v in metric_series(get_json(f"{router}/telemetry/snapshot"),
                                               "gordo_fault_fired_total").items()
                   if dict(k)["site"] == "replica")

    start = replica_fired()
    statuses = []
    for _ in range(FAULT_MAX_REQUESTS):
        status, got, _ = request_with_headers(routed, body)
        statuses.append(status)
        if status == 200:
            if got["data"] != want["data"]:
                raise AssertionError("a routed reply differs from the direct server's")
        elif not (status == 409 and got.get("transient") is True
                  and sorted(got["unavailable"]) == sorted(mine)):
            raise AssertionError(f"routed request under the replica fault: {status} {got}")
        fired = replica_fired() - start
        if done(fired, statuses):
            log("fault plane: routed", json.dumps({"statuses": statuses, "fired": fired}))
            return {"statuses": statuses, "fired": fired}
        if status == 200:
            # after a 409 the next request comes at once, inside the
            # ejection window: it fails over
            time.sleep(FAULT_REQUEST_GAP)
    raise AssertionError(f"the replica fault never settled: {statuses}")


def gameday_phase(torch, fa, profile: bool, collection: str) -> dict:
    """Phase 19: (a) the fault plane over phase 10's collection, (b)
    ``gameday run`` on the card and ``gameday run rolling-upgrade``."""
    import io

    root = os.path.dirname(os.path.abspath(__file__))
    report = {}
    with tempfile.TemporaryDirectory() as workdir:
        t0 = time.perf_counter()
        report["fault_plane"] = fault_plane_check(torch, fa, collection, workdir)
        report["fault_plane"]["phase_s"] = time.perf_counter() - t0

        # (b) the shipped game days in one process on the card
        output = os.path.join(workdir, "gameday.json")
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-m", "gordo_tpu_torch.cli", "gameday", "run", "--workdir",
             os.path.join(workdir, "gameday"), "--output", output],
            cwd=root, env={k: v for k, v in os.environ.items()
                           if not k.startswith(("GORDO_FAULT", "GORDO_BATCH"))},
            capture_output=True, text=True, timeout=GAMEDAY_TIMEOUT)
        seconds = time.perf_counter() - t0
        log("gameday run:\n" + run.stdout.strip())
        if run.returncode != 0:
            raise AssertionError(f"gameday run exited {run.returncode}:\n{run.stdout[-3000:]}\n"
                                 f"{run.stderr[-4000:]}")
        with open(output) as fh:
            payload = json.load(fh)
        rows = {}
        for scenario in payload["scenarios"]:
            rows[scenario["scenario"]] = {
                "ok": scenario["ok"], "wall_time_s": scenario["wall_time_s"],
                "resumes": scenario["streams"]["reconnects"],
                "sheds_honored": scenario["streams"]["sheds_honored"],
                "fired": scenario["fault_sites_fired"],
                "promotions": scenario["lifecycle"]["promotions"],
                "bit_identity": scenario["bit_identity"],
                "max_burn_rate": scenario["slo"]["max_burn_rate"],
                "request_outcomes": scenario["request_outcomes"],
            }
        report["gameday"] = {"seconds": seconds, "scenarios": rows,
                             "skipped": payload["skipped"],
                             "scenarios_s": sum(r["wall_time_s"] for r in rows.values())}
        log("gameday", json.dumps(report["gameday"]))
        skipped = [s["scenario"] for s in payload["skipped"]]
        if (not payload["ok"] or len(rows) != 5 or not all(r["ok"] for r in rows.values())
                or skipped != ["rolling-upgrade"]):
            raise AssertionError(f"gameday run: {report['gameday']}")

        # the scenario the port cannot run is refused by name
        from gordo_tpu_torch.cli.cli import main

        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            try:
                code = main(["gameday", "run", "rolling-upgrade"])
            except SystemExit as exc:
                code = exc.code
        report["rolling_upgrade"] = {"exit": code, "error": err.getvalue().strip()[-400:]}
        log("gameday run rolling-upgrade", json.dumps(report["rolling_upgrade"]))
        if code != 2 or "programs/" not in err.getvalue():
            raise AssertionError(f"gameday run rolling-upgrade: {report['rolling_upgrade']}")
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


# Phase 20, the profilers and the multi-chip paths. (a) `python -m
# gordo_tpu_torch.cli build` of the config's turbine-9900-transformer at
# full width with GORDO_TPU_PROFILE_DIR, over PROFILE_BUILD_DAYS days (a
# random provider of 144 samples a day) and 1 epoch, where the config has
# 151 days and 10 epochs: a trace of the whole build (CV's three fold fits
# and the final fit) would hold millions of events; the trace must name
# PROFILE_KERNELS and PROFILE_RANGES. Then two `run-server` processes over
# phase 10's collection, one with GORDO_PROFILE_HZ, the same 144-row fleet
# request to each PROFILE_REQUESTS times, the sampled one stopped with
# SIGTERM: its dump rendered by `profile report` and `profile flame`.
# (b) one NCCL rank: DP_STEPS data-parallel steps of the turbine
# Transformer (flash) on DP_BATCH windows, with zero1 off and on, held to
# the same steps on the CPU (a gloo rank before the NCCL one); LONG_STEPS long-context steps (ring, then
# Ulysses; remat) on LONG_WINDOW windows, 128 times the config's 64.
PROFILE_BUILD_DAYS = 5
PROFILE_HZ = 97.0
PROFILE_REQUESTS = 10
PROFILE_KERNELS = {"flash_attention_fwd": "flash_fwd_quad_kernel",
                   "flash_attention_bwd_dq": "flash_bwd_dq_quad_kernel",
                   "flash_attention_bwd_dkv": "flash_bwd_dkv_quad_kernel"}
PROFILE_RANGES = ("data-fetch", "cross-validation", "fit", "train-dispatch")
DP_BATCH = 64
DP_STEPS = 3
LONG_WINDOW = (2, 8192, 3)
LONG_STEPS = 2
#: the parity of a data-parallel step, card against CPU (losses, and the
#: parameters but the keys' biases, whose gradient is 0 in exact
#: arithmetic: Adam moves them by rounding only, at most its learning
#: rate a step)
DP_TOLERANCE = 1e-4


def profiled_build_check(root: str, workdir: str, device=None) -> dict:
    """Phase 20a: the profiled build in a subprocess on the card (unless
    ``device`` names another: a rehearsal); the trace's kernels (device ms
    from its kernel events) and ranges."""
    import glob

    days = PROFILE_BUILD_DAYS
    base = dict(BASE_ESTIMATOR, epochs=1)
    definition = {"gordo_tpu.models.anomaly.DiffBasedAnomalyDetector": {
        "base_estimator": {"gordo_tpu.models.TransformerAutoEncoder": base}}}
    machine = example_machines(
        root, {MACHINE: {"model": definition, "evaluation": {"seed": SEED}}})[MACHINE].to_dict()
    machine["dataset"] = dict(
        machine["dataset"], train_end_date=(TRAIN_START + timedelta(days=days)).isoformat(),
        data_provider={"type": "RandomDataProvider", "min_size": 144 * days,
                       "max_size": 144 * days})
    traces = os.path.join(workdir, "traces")
    counts = os.path.join(workdir, "build-launches.json")
    env = dict(os.environ, MACHINE=yaml_text(machine), OUTPUT_DIR=os.path.join(workdir, MACHINE),
               GORDO_TPU_PROFILE_DIR=traces)
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-c", FLEET_DRIVER, counts, "build",
                          *(["--device", device] if device else [])], cwd=root,
                         env=env, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if run.returncode != 0 or f"model parameters on {device or 'cuda'}" not in run.stderr:
        raise AssertionError(f"profiled build exited {run.returncode}:\n{run.stderr[-4000:]}")
    with open(counts) as fh:
        launches = json.load(fh)["kernels"]
    found = glob.glob(os.path.join(traces, f"build-{MACHINE}-*", "trace.json"))
    if len(found) != 1:
        raise AssertionError(f"profiled build wrote {found} under {traces}")
    with open(found[0]) as fh:
        events = json.load(fh)["traceEvents"]
    kernels = {}
    for entry, symbol in PROFILE_KERNELS.items():
        hits = [e for e in events if e.get("cat") == "kernel" and symbol in e.get("name", "")]
        kernels[entry] = {"trace_launches": len(hits),
                          "device_ms": sum(e.get("dur", 0.0) for e in hits) / 1000.0,
                          "counted_launches": launches.get(f"{entry}_quad", 0)}
    ranges = {name: sum(1 for e in events if e.get("name") == name
                        and e.get("cat") in ("user_annotation", "gpu_user_annotation"))
              for name in PROFILE_RANGES}
    report = {"seconds": seconds, "trace": os.path.relpath(found[0], workdir),
              "trace_mb": os.path.getsize(found[0]) / 2**20, "events": len(events),
              "kernels": kernels, "ranges": ranges, "kernel_launches": launches}
    log("profiled build", json.dumps(report))
    if not all(k["trace_launches"] > 0 and k["counted_launches"] > 0 for k in kernels.values()):
        raise AssertionError(f"the trace does not name every flash kernel: {kernels}")
    if not all(ranges.values()):
        raise AssertionError(f"the trace lacks a range: {ranges}")
    return report


def sampled_server_check(root: str, collection: str, workdir: str, device=None) -> dict:
    """Phase 20a: ``run-server`` with and without the sampling profiler,
    the same fleet request to each in turn; the sampled one stopped with
    SIGTERM, its dump rendered by both ``profile`` commands."""
    import signal

    import numpy as np

    from gordo_tpu_torch.observability.sampling import PROFILE_HZ_ENV_VAR, PROFILE_OUT_ENV_VAR

    dump = os.path.join(workdir, "gordo_profile.json")
    processes, ports = {}, {}
    for label in ("off", "on"):
        env = {k: v for k, v in os.environ.items()
               if k not in (PROFILE_HZ_ENV_VAR, PROFILE_OUT_ENV_VAR)}
        if label == "on":
            env.update({PROFILE_HZ_ENV_VAR: str(PROFILE_HZ), PROFILE_OUT_ENV_VAR: dump})
        ports[label] = free_port()
        processes[label] = subprocess.Popen(
            [sys.executable, "-c", REPLICA_DRIVER, os.path.join(workdir, f"{label}.json"),
             "run-server", "--collection-dir", collection, "--host", "127.0.0.1", "--port",
             str(ports[label]), *(["--device", device] if device else [])],
            cwd=root, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    report = {}
    try:
        for label, process in processes.items():
            wait_ready(f"http://127.0.0.1:{ports[label]}/healthz", process)
        rng = np.random.default_rng(SEED)
        keys = [(datetime(2019, 6, 1, tzinfo=timezone.utc) + timedelta(minutes=10 * i)).isoformat()
                for i in range(SERVE_ROWS[0])]
        body = {}
        for i in range(FLEET_TRANSFORMERS):
            tags = [f"{tag.rsplit(' ', 1)[0]} {3 * i + j + 1}" for j, tag in enumerate(TAGS)]
            body[f"{MACHINE}-{i}"] = frame_of(rng.normal(size=(len(keys), 3)), keys, tags,
                                              slice(None))
        payload = json.dumps({"machines": body}).encode()
        seconds = {"off": [], "on": []}
        for rep in range(PROFILE_REQUESTS + 1):
            for label in ("off", "on") if rep % 2 else ("on", "off"):
                url = f"http://127.0.0.1:{ports[label]}/gordo/v0/{PROJECT}/prediction/fleet"
                reply, s = post(url, payload)
                if rep:  # the first of each loads the models
                    seconds[label].append(s)
        counts = replica_counts(processes["on"], os.path.join(workdir, "on.json"))
        report["forward_launches"] = sum(v for k, v in counts["kernels"].items()
                                         if k.startswith("flash_attention_fwd"))
        report["kernel_launches"] = counts["kernels"]
        report["median_ms"] = {label: 1000 * float(np.median(s)) for label, s in seconds.items()}
        processes["on"].send_signal(signal.SIGTERM)
        report["exit_on_sigterm"] = processes["on"].wait(timeout=60)
    finally:
        stop_processes(processes.values())
    if report["exit_on_sigterm"] != 0 or not os.path.exists(dump):
        raise AssertionError(f"the sampled server wrote no dump on SIGTERM: {report}")
    with open(dump) as fh:
        payload = json.load(fh)
    flame = os.path.join(workdir, "flame.txt")
    commands = {"report": ["profile", "report", dump], "flame": ["profile", "flame", dump,
                                                                 "-o", flame]}
    rendered = {name: subprocess.run([sys.executable, "-m", "gordo_tpu_torch.cli", *argv],
                                     cwd=root, capture_output=True, text=True, timeout=120)
                for name, argv in commands.items()}
    server_phases = sorted(k for k in payload["phase_seconds"] if k.startswith("server/"))
    report.update(
        n_samples=payload["n_samples"], duration_s=payload["duration_s"],
        server_phases=server_phases,
        sampled_server_phases={k: v for k, v in payload["per_phase"].items()
                               if k.startswith("server/")},
        exits={name: run.returncode for name, run in rendered.items()},
        flame_lines=len(open(flame).read().splitlines()) if os.path.exists(flame) else 0)
    log("sampled server", json.dumps(report))
    log("profile report:\n" + rendered["report"].stdout.strip())
    # the host phases' brackets are a few ms a request: at PROFILE_HZ a
    # sample may land in none of them (the ledger's device phase is no
    # bracket: a thread waiting on the card samples unattributed, as in JAX)
    if (any(report["exits"].values()) or payload["n_samples"] <= 0 or not server_phases
            or report["flame_lines"] <= 0 or report["forward_launches"] <= 0):
        raise AssertionError(f"the sampled server's dump: {report}\n"
                             f"{rendered['report'].stderr[-2000:]}")
    return report


def multi_chip_check(torch, fa, device=None) -> dict:
    """Phase 20b: one NCCL rank from an explicit coordinator (a gloo rank
    when ``device`` is ``"cpu"``: a rehearsal); the data-parallel and
    long-context trainers on it. The data-parallel trainer's CPU reference
    runs first, on a gloo rank of its own: its collectives take CPU
    tensors, which NCCL does not."""
    import numpy as np
    from torch.func import functional_call

    from gordo_tpu_torch.models.factories.transformer import transformer_model
    from gordo_tpu_torch.models.specs import per_sample_loss
    from gordo_tpu_torch.parallel import distributed
    from gordo_tpu_torch.parallel.data_parallel import DataParallelTrainer
    from gordo_tpu_torch.parallel.long_context import LongContextTrainer
    from gordo_tpu_torch.parallel.mesh import DATA_AXIS, get_device_mesh
    from gordo_tpu_torch.parallel.sequence import SEQ_AXIS

    widths = {k: BASE_ESTIMATOR[k] for k in ("lookback_window", "d_model", "n_heads",
                                             "n_layers", "attention_impl")}
    report = {}
    rng = np.random.default_rng(SEED)
    x = rng.standard_normal((DP_BATCH, widths["lookback_window"], 3)).astype(np.float32)
    y = rng.standard_normal((DP_BATCH, 3)).astype(np.float32)
    runs = {}

    def data_parallel_run(label, zero1, where):
        mesh = get_device_mesh(axis_names=(DATA_AXIS,))
        trainer = DataParallelTrainer(
            transformer_model(n_features=3, dropout=0.0, **widths), mesh, zero1=zero1,
            device=where)
        params, opt_state = trainer.init(seed=SEED)
        start = {k: v.detach().cpu().numpy() for k, v in params.items()}
        xb, yb = trainer.shard_batch(x), trainer.shard_batch(y)
        fa.reset_launch_counts()
        losses = []
        t0 = time.perf_counter()
        for _ in range(DP_STEPS):
            params, opt_state, loss = trainer.train_step(params, opt_state, xb, yb)
            losses.append(float(loss))
        runs[label] = {"losses": losses, "seconds": time.perf_counter() - t0,
                       "kernel_launches": dict(fa.kernel_launches),
                       "params": {k: v.detach().cpu().numpy() for k, v in params.items()},
                       "start": start}

    distributed.initialize(f"127.0.0.1:{free_port()}", 1, 0, device="cpu")
    try:
        data_parallel_run("cpu", False, "cpu")
    finally:
        distributed.shutdown()
    distributed.initialize(f"127.0.0.1:{free_port()}", 1, 0, device=device)
    try:
        report["backend"] = torch.distributed.get_backend()
        report["process_info"] = distributed.process_info()
        data_parallel_run("card", False, device)
        data_parallel_run("card_zero1", True, device)
        card, cpu = runs["card"], runs["cpu"]
        worst = {"zero1": 0.0, "cpu": 0.0}
        for name, value in card["params"].items():
            worst["zero1"] = max(worst["zero1"],
                                 float(np.abs(runs["card_zero1"]["params"][name] - value).max()))
            if name.endswith("attn.key.bias"):
                if max(np.abs(value - card["start"][name]).max(),
                       np.abs(cpu["params"][name] - cpu["start"][name]).max()) > \
                        DP_STEPS * 1e-3 * (1 + 1e-3):
                    raise AssertionError(f"{name} moved past Adam's steps")
                continue
            scale = np.maximum(np.abs(cpu["params"][name]), 1.0)
            worst["cpu"] = max(worst["cpu"],
                               float((np.abs(value - cpu["params"][name]) / scale).max()))
        report["data_parallel"] = {
            label: {k: v for k, v in run.items() if k not in ("params", "start")}
            for label, run in runs.items()}
        report["data_parallel"]["worst"] = worst
        log("data parallel", json.dumps(report["data_parallel"]))
        launched = card["kernel_launches"]
        if not all(launched.get(f"{k}_quad", 0) > 0 for k in PROFILE_KERNELS):
            raise AssertionError(f"the data-parallel step launched no flash kernel: {launched}")
        loss_gap = max(abs(a - b) / max(abs(b), 1.0) for a, b in zip(card["losses"], cpu["losses"]))
        if worst["zero1"] > 1e-6 or worst["cpu"] > DP_TOLERANCE or loss_gap > DP_TOLERANCE:
            raise AssertionError(f"data parallel: zero1, card against CPU: {worst}, {loss_gap}")

        seq_mesh = get_device_mesh(axis_names=(SEQ_AXIS,))
        windows = rng.standard_normal(LONG_WINDOW).astype(np.float32)
        targets = rng.standard_normal((LONG_WINDOW[0], 3)).astype(np.float32)
        report["long_context"] = {}
        for impl in ("ring", "ulysses"):
            trainer = LongContextTrainer(3, seq_mesh, attention_impl=impl, remat=True,
                                         d_model=widths["d_model"], n_heads=widths["n_heads"],
                                         n_layers=widths["n_layers"], device=device)
            params, opt_state = trainer.init(seed=SEED)
            with torch.no_grad():
                out = functional_call(trainer.local_module, params,
                                      (torch.as_tensor(windows, device=trainer.device),))
                local = float(per_sample_loss("mse", out, torch.as_tensor(
                    targets, device=trainer.device)).mean())
            if torch.cuda.is_available():
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            fa.reset_launch_counts()
            losses = []
            t0 = time.perf_counter()
            for _ in range(LONG_STEPS):
                params, opt_state, loss = trainer.train_step(params, opt_state, windows, targets)
                losses.append(float(loss))
            row = {"losses": losses, "local_twin_loss": local,
                   "seconds": time.perf_counter() - t0,
                   "peak_allocated_gb": (torch.cuda.max_memory_allocated() / 1e9
                                         if torch.cuda.is_available() else None),
                   "flash_launches": sum(fa.kernel_launches.values())}
            report["long_context"][impl] = row
            log("long context", impl, json.dumps(row))
            if abs(losses[0] - local) > 1e-5 * max(abs(local), 1.0) or not np.isfinite(losses).all():
                raise AssertionError(f"long context {impl}: {row}")
    finally:
        distributed.shutdown()
    return report


def profilers_phase(torch, fa, profile: bool, collection: str, device=None) -> dict:
    """Phase 20: the profilers (a) and the multi-chip paths at one NCCL
    rank (b), the module docstring's; on the card unless ``device`` names
    another (a rehearsal)."""
    root = os.path.dirname(os.path.abspath(__file__))
    report = {}
    with tempfile.TemporaryDirectory(prefix="profilers-") as workdir:
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
            # the build runs beside the servers: one process each
            building = pool.submit(profiled_build_check, root, workdir, device)
            report["sampled_server"] = sampled_server_check(root, collection, workdir, device)
            report["profiled_build"] = building.result()
        report["profilers_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        report["multi_chip"] = multi_chip_check(torch, fa, device)
        report["multi_chip_s"] = time.perf_counter() - t0
    return report


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

    phase_s = {}

    def timed(name, phase, *phase_args):
        t0 = time.perf_counter()
        result = phase(torch, fa, *phase_args)
        phase_s[name] = time.perf_counter() - t0
        log("phase", name, "seconds", phase_s[name])
        return result

    def timed_build():
        t0 = time.perf_counter()
        return _build.build_all(_build.sources()), time.perf_counter() - t0

    # nvcc compiles the kernels while the phases whose paths launch no
    # flash kernel (6, 8 and 9) run; the others wait for it
    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
        building = pool.submit(timed_build)
        default_pipeline = timed("default_pipeline", default_pipeline_phase, args.profile)
        recurrent = timed("recurrent", recurrent_phase, args.profile)
        project = timed("project_build", project_build_phase, args.profile)
        t0 = time.perf_counter()
        compiler_output, build_s = building.result()
    phase_s["build"] = build_s
    for name, (text, seconds) in compiler_output.items():
        log(f"nvcc {name} ({seconds:.1f} s):\n{text.strip()}")
    log("build seconds", build_s, "(waited", time.perf_counter() - t0, "s after phase 9)")

    checks = timed("forward_kernels", kernel_phase)
    backward_checks = timed("backward_kernels", backward_phase)
    gradients = timed("gradients", gradient_phase)
    serve_launches, report = timed("serve", end_to_end_phase, args.profile)
    if serve_launches <= 0:
        raise AssertionError("the served path never launched flash_attention_fwd")
    train = timed("train", train_phase, args.profile)
    models = timed("models", model_phase)
    with tempfile.TemporaryDirectory() as fleet_dir:
        fleet = timed("fleet_build", fleet_build_phase, args.profile, fleet_dir)
        fleet_serve = timed("fleet_serve", fleet_serve_phase, args.profile, fleet["collection"])
        # phase 17's ledger workers (subprocesses, their own launch counts)
        # build beside phase 12, whose checks read no time of theirs
        with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
            planing = pool.submit(timed, "build_plane", build_plane_phase, args.profile, fleet)
            options = timed("build_options", build_options_phase, args.profile)
            build_plane = planing.result()
        lake_stream = timed("lake_stream", lake_stream_phase, args.profile, fleet["collection"])
        plane = timed("plane", plane_phase, args.profile, fleet["collection"])
        lifecycle = timed("lifecycle", lifecycle_phase, args.profile, fleet["collection"])
        client = timed("client", client_phase, args.profile, fleet["collection"])
        tuning = timed("tuning", tuning_phase, args.profile, fleet)
        gamedays = timed("gameday", gameday_phase, args.profile, fleet["collection"])
        profilers = timed("profilers", profilers_phase, args.profile, fleet["collection"])

    def check(kernel, case, rows):
        return next(r for r in rows if r.get("kernel", fa.KERNEL) == kernel and r["case"] == case)

    # each path's launches by CUDA kernel, counted from 0 just before it
    paths = {"serve": report["kernel_launches"], "train": train["kernel_launches"],
             "serve_trained": train["served"]["kernel_launches"],
             "default_pipeline": default_pipeline["kernel_launches"],
             "recurrent": recurrent["kernel_launches"],
             "project_build": project["kernel_launches"],
             "fleet_build": fleet["kernel_launches"],
             "build_plane": build_plane["kernel_launches"],
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
             "lifecycle_scan": lifecycle["dry_launches"],
             "lifecycle_drift": lifecycle["tick_launches"]["scan"],
             "lifecycle_refit": lifecycle["tick_launches"]["refit"],
             "lifecycle_shadow": lifecycle["tick_launches"]["shadow"],
             "lifecycle_torn": lifecycle["torn_launches"],
             "lifecycle_stream": lifecycle["stream_launches"],
             "rollup_routed": tuning["plane"]["kernel_launches"],
             "tuned_build": tuning["build_launches"],
             "fault_plane": gamedays["fault_plane"]["kernel_launches"],
             "profiled_build": profilers["profiled_build"]["kernel_launches"],
             "sampled_server": profilers["sampled_server"]["kernel_launches"],
             "data_parallel": profilers["multi_chip"]["data_parallel"]["card"]["kernel_launches"],
             "data_parallel_zero1":
                 profilers["multi_chip"]["data_parallel"]["card_zero1"]["kernel_launches"],
             **client["kernel_launches"],
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
                 "lake_stream": lake_stream, "plane": plane, "lifecycle": lifecycle,
                 "client": client, "build_plane": build_plane, "tuning": tuning,
                 "gameday": gamedays, "profilers": profilers, **kernels},
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
