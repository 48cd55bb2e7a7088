"""
The port's profiler trace hooks (``observability/profiler.py``, the
``utils/tracing.py`` re-export): ``maybe_trace`` writes a Chrome trace of
``torch.profiler`` under ``<dir>/<name>-<unix_ms>/`` (the argument, else
``GORDO_TPU_PROFILE_DIR``) with ``annotate``'s ranges in it; ``annotate``
does nothing outside a trace; a profiler that fails never breaks the
traced work. A ``ModelBuilder`` build traced this way carries the
``data-fetch``, ``cross-validation``, ``fit`` and ``train-dispatch``
ranges, as the JAX builder's trace does.
"""

import glob
import json
import os

import pytest
import torch

from gordo_tpu_torch.observability import profiler
from gordo_tpu_torch.utils import tracing as tracing_shim

TINY_DETECTOR = {
    "gordo_tpu.models.anomaly.DiffBasedAnomalyDetector": {
        "base_estimator": {"gordo_tpu.models.TransformerAutoEncoder": {
            "kind": "transformer_model", "lookback_window": 4, "d_model": 8, "n_heads": 2,
            "n_layers": 1, "epochs": 1, "attention_impl": "flash"}}}}


def _events(directory, name):
    found = glob.glob(os.path.join(str(directory), f"{name}-*", profiler.TRACE_FILENAME))
    assert len(found) == 1, found
    with open(found[0]) as fh:
        return json.load(fh)["traceEvents"]


def _ranges(events):
    return {e["name"] for e in events if e.get("cat") == "user_annotation"}


def test_maybe_trace_writes_a_chrome_trace_with_the_ranges(tmp_path):
    with profiler.maybe_trace("unit", str(tmp_path)):
        assert profiler._active.tracing
        with profiler.annotate("fit"):
            torch.ones(4).sum()
    assert not profiler._active.tracing
    assert "fit" in _ranges(_events(tmp_path, "unit"))


def test_the_environment_names_the_directory(tmp_path, monkeypatch):
    monkeypatch.setenv(profiler.PROFILE_DIR_ENV_VAR, str(tmp_path))
    assert profiler.profile_dir() == str(tmp_path)
    with profiler.maybe_trace("env"):
        with profiler.annotate("data-fetch"):
            torch.ones(2)
    assert "data-fetch" in _ranges(_events(tmp_path, "env"))


def test_off_touches_no_profiler(monkeypatch, tmp_path):
    monkeypatch.delenv(profiler.PROFILE_DIR_ENV_VAR, raising=False)

    def _bomb(*args, **kwargs):  # pragma: no cover - the assertion is the test
        raise AssertionError("the profiler was touched while tracing is off")

    monkeypatch.setattr(profiler, "_profiler_call", _bomb)
    with profiler.maybe_trace("off"):
        with profiler.annotate("fit"):
            pass
    assert os.listdir(tmp_path) == []


def test_a_failing_profiler_never_breaks_the_work(tmp_path, caplog):
    def broken(_):
        raise RuntimeError("no profiler here")

    ran = []
    original = profiler._start
    profiler._start = broken
    try:
        with profiler.maybe_trace("broken", str(tmp_path)):
            with profiler.annotate("fit"):
                ran.append(1)
    finally:
        profiler._start = original
    assert ran == [1]
    assert "Could not start torch profiler trace" in caplog.text
    assert not glob.glob(os.path.join(str(tmp_path), "broken-*"))


def test_a_second_profiler_is_refused_without_breaking_the_work(tmp_path):
    ran = []
    with torch.profiler.profile():
        with profiler.maybe_trace("nested", str(tmp_path)):
            with profiler.annotate("fit"):
                ran.append(torch.ones(3).sum().item())
    assert ran == [3.0]


def test_the_shim_is_the_profiler():
    assert tracing_shim._active is profiler._active
    assert tracing_shim.maybe_trace is profiler.maybe_trace
    assert tracing_shim.annotate is profiler.annotate
    assert tracing_shim.PROFILE_DIR_ENV_VAR == "GORDO_TPU_PROFILE_DIR"


def _tiny_machine():
    return {
        "name": "traced-transformer",
        "project_name": "traced",
        "dataset": {"type": "RandomDataset", "tags": ["tag-0", "tag-1", "tag-2"],
                    "target_tag_list": ["tag-0", "tag-1", "tag-2"],
                    "train_start_date": "2019-01-01T00:00:00+00:00",
                    "train_end_date": "2019-01-03T00:00:00+00:00", "asset": "gra"},
        "model": TINY_DETECTOR,
    }


def test_a_traced_build_carries_the_builder_and_trainer_ranges(tmp_path, monkeypatch):
    from gordo_tpu_torch.builder.build_model import ModelBuilder

    monkeypatch.setenv(profiler.PROFILE_DIR_ENV_VAR, str(tmp_path))
    ModelBuilder(_tiny_machine()).build(device="cpu")
    ranges = _ranges(_events(tmp_path, "build-traced-transformer"))
    assert {"data-fetch", "cross-validation", "fit", "train-dispatch"} <= ranges


def test_a_build_whose_profiler_fails_still_builds(tmp_path, monkeypatch):
    from gordo_tpu_torch.builder.build_model import ModelBuilder

    monkeypatch.setenv(profiler.PROFILE_DIR_ENV_VAR, str(tmp_path))

    def broken(_):
        raise RuntimeError("no profiler here")

    monkeypatch.setattr(profiler, "_start", broken)
    model, machine = ModelBuilder(_tiny_machine()).build(device="cpu")
    assert machine.metadata.build_metadata.model.model_training_duration_sec > 0
    assert model.predict is not None
    assert os.listdir(tmp_path) == []
