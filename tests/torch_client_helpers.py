"""
Shared pieces of the port's client tests: a small collection built by the
JAX ``local_build`` and carried into port artifacts
(``gordo_tpu_torch.convert``), the port's server on loopback HTTP, and
frame comparisons between the port's ``BlockFrame`` and the JAX client's
two-level pandas frames.

The collection (one revision, ``REVISION``):

- ``tf-a``: a ``DiffBasedAnomalyDetector`` around a Transformer (3 tags,
  lookback 8, d_model 16, 2 heads of 8, 1 layer), trained dense on the
  CPU and served with ``attention_impl: flash`` (the parameter tree is
  the same), so both servers run the flash forward (JAX: Pallas in
  interpret mode);
- ``ff-a``: a detector around a feedforward AutoEncoder (4 tags);
- ``raw-a``: a bare AutoEncoder (3 tags), which answers 422 on
  ``/anomaly/prediction``.

Each server runs on the CPU; every socket has a timeout, every server is
shut down by the fixture that started it and its thread is a daemon.
Where the port's replies are compared with the JAX client's values, the
port's server runs in a process of its own (``python -m
gordo_tpu_torch.server.runner``), apart from the JAX computations of the
test process.
"""

import copy
import json
import os
import shutil
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pandas as pd

from gordo_tpu import serializer as jax_serializer
from gordo_tpu.builder import local_build
from gordo_tpu.builder.fleet_build import _find_jax_estimator
from gordo_tpu.models.anomaly import DiffBasedAnomalyDetector as JaxDetector
from gordo_tpu.serializer import into_definition
from gordo_tpu_torch import convert
from gordo_tpu_torch.server.app import build_app
from gordo_tpu_torch.server.runner import make_http_server

PROJECT = "plant-client"
REVISION = "1700000000000"
TF, FF, RAW = "tf-a", "ff-a", "raw-a"
MACHINES = [FF, RAW, TF]
LOOKBACK = 8
RTOL, ATOL = 1e-4, 1e-5
#: a span of the RandomDataProvider's data the client predicts over
START, END = "2019-02-01T00:00:00+00:00", "2019-02-01T08:00:00+00:00"
CONFIG = f"""
machines:
  - name: {TF}
    dataset:
      type: RandomDataset
      tags: [tag-0, tag-1, tag-2]
      train_start_date: '2019-01-01T00:00:00+00:00'
      train_end_date: '2019-01-03T00:00:00+00:00'
      asset: gra
    model:
      gordo_tpu.models.anomaly.DiffBasedAnomalyDetector:
        base_estimator:
          gordo_tpu.models.TransformerAutoEncoder:
            kind: transformer_model
            lookback_window: {LOOKBACK}
            d_model: 16
            n_heads: 2
            n_layers: 1
            attention_impl: dense
            epochs: 1
            batch_size: 64
  - name: {FF}
    dataset:
      type: RandomDataset
      tags: [tag-3, tag-4, tag-5, tag-6]
      train_start_date: '2019-01-01T00:00:00+00:00'
      train_end_date: '2019-01-03T00:00:00+00:00'
      asset: gra
    model:
      gordo_tpu.models.anomaly.DiffBasedAnomalyDetector:
        base_estimator:
          gordo_tpu.models.AutoEncoder:
            kind: feedforward_hourglass
            epochs: 1
  - name: {RAW}
    dataset:
      type: RandomDataset
      tags: [tag-7, tag-8, tag-9]
      train_start_date: '2019-01-01T00:00:00+00:00'
      train_end_date: '2019-01-03T00:00:00+00:00'
      asset: gra
    evaluation:
      cv_mode: build_only
    model:
      gordo_tpu.models.AutoEncoder:
        kind: feedforward_hourglass
        epochs: 1
"""


def _with_flash(est):
    """A copy of a fitted JAX Transformer estimator that serves with the
    flash kernel."""
    flash = copy.copy(est)
    flash.kwargs = dict(est.kwargs, attention_impl="flash")
    flash.spec_ = flash._build_spec()
    flash._apply_fn = None
    return flash


def _flash_config(model_config):
    """The machine's model config with the Transformer's attention flash."""
    if isinstance(model_config, dict):
        return {key: ("flash" if key == "attention_impl" else _flash_config(value))
                for key, value in model_config.items()}
    return model_config


def build_collections(root: Path):
    """(JAX revision dir, port revision dir) of the three machines."""
    jax_dir, port_dir = root / "jax" / REVISION, root / "port" / REVISION
    for model, machine in local_build(CONFIG):
        metadata = machine.to_dict()
        if isinstance(model, JaxDetector) and machine.name == TF:
            model.base_estimator = _with_flash(model.base_estimator)
            metadata["model"] = _flash_config(metadata["model"])
        jax_serializer.dump(model, jax_dir / machine.name, metadata=metadata)
        loaded = jax_serializer.load(jax_dir / machine.name)
        kwargs = {}
        if isinstance(loaded, JaxDetector):
            kwargs = dict(
                scaler_arrays=convert.scaler_arrays_from_sklearn(loaded.scaler),
                thresholds={"aggregate_threshold_": loaded.aggregate_threshold_,
                            "feature_thresholds_": np.asarray(loaded.feature_thresholds_)},
            )
        convert.write_artifact(port_dir / machine.name,
                               params=_find_jax_estimator(loaded).params_,
                               definition=into_definition(loaded),
                               metadata=jax_serializer.load_metadata(jax_dir / machine.name),
                               **kwargs)
    return jax_dir, port_dir


def add_casualty_revision(revision_dir: Path, name: str, casualty: str) -> Path:
    """A sibling revision ``name`` of the same artifacts whose
    ``build_report.json`` records ``casualty`` as quarantined."""
    sibling = revision_dir.parent / name
    shutil.copytree(revision_dir, sibling)
    (sibling / "build_report.json").write_text(
        json.dumps({"failed": [], "quarantined": [{"machine": casualty, "epoch": 0}]})
    )
    return sibling


class HttpServer:
    """A WSGI app served on loopback (port 0) in a daemon thread."""

    def __init__(self, app):
        self.app = app
        self.server = make_http_server(app, "127.0.0.1", 0)
        self.server.timeout = 10
        self.port = self.server.server_port
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)


def port_server(collection_dir, **settings) -> HttpServer:
    return HttpServer(build_app(str(collection_dir), device="cpu", **settings))


class ServerProcess:
    """``python -m gordo_tpu_torch.server.runner`` on the CPU on a free
    loopback port, ready when ``/healthcheck`` answers."""

    def __init__(self, collection_dir, *args):
        with socket.socket() as probe:
            probe.bind(("127.0.0.1", 0))
            self.port = probe.getsockname()[1]
        env = {**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parent.parent)}
        for var in ("GORDO_TPU_TRACE_LOG", "GORDO_BATCH_WAIT_MS", "ENABLE_PROMETHEUS"):
            env.pop(var, None)
        self.process = subprocess.Popen(
            [sys.executable, "-m", "gordo_tpu_torch.server.runner", "--collection-dir",
             str(collection_dir), "--device", "cpu", "--host", "127.0.0.1", "--port",
             str(self.port), *args],
            env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        deadline = time.monotonic() + 120
        while True:
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{self.port}/healthcheck",
                                            timeout=5):
                    return
            except OSError:
                if self.process.poll() is not None or time.monotonic() > deadline:
                    self.close()
                    raise RuntimeError("the port's server process did not start")
                time.sleep(0.2)

    def close(self):
        self.process.terminate()
        try:
            self.process.wait(timeout=30)
        except subprocess.TimeoutExpired:
            self.process.kill()
            self.process.wait(timeout=30)


def assert_frame_matches(got, want: pd.DataFrame, rtol=0.0, atol=0.0, what=""):
    """A port ``BlockFrame`` against a JAX client's two-level frame: the
    same index, blocks and labels in order; strings equal; numbers equal,
    or within ``rtol``/``atol``."""
    assert len(got.index) == len(want.index), what
    assert [label.isoformat() for label in got.index] == [
        stamp.isoformat() for stamp in want.index
    ], what
    tops = list(dict.fromkeys(want.columns.get_level_values(0)))
    assert list(got.blocks) == tops, what
    for top in tops:
        sub = want[top]
        assert got.labels(top) == [str(c) for c in sub.columns], f"{what} {top}"
        values = got[top]
        if values.dtype == object:
            np.testing.assert_array_equal(values, sub.to_numpy(object), err_msg=f"{what} {top}")
        elif rtol == 0.0 and atol == 0.0:
            np.testing.assert_array_equal(values, sub.to_numpy(np.float64),
                                          err_msg=f"{what} {top}")
        else:
            np.testing.assert_allclose(values, sub.to_numpy(np.float64), rtol=rtol, atol=atol,
                                       err_msg=f"{what} {top}")


def assert_results_match(got, want, rtol=0.0, atol=0.0):
    """Two clients' PredictionResult lists: the same machines in order,
    errors, revisions and frames."""
    assert [r.name for r in got] == [r.name for r in want]
    for g, w in zip(got, want):
        assert g.error_messages == w.error_messages == [], (g.error_messages, w.error_messages)
        assert g.revision == w.revision
        assert len(g.predictions.index) > 0
        assert_frame_matches(g.predictions, w.predictions, rtol, atol, g.name)
