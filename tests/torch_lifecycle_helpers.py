"""
Shared pieces of the port's lifecycle tests: the JAX package's
``lc-m-*`` fixture (``tests/test_lifecycle.py``: four
``DiffBasedAnomalyDetector(Pipeline(MinMaxScaler, AutoEncoder))``
machines over one day of ``RandomDataset``) built once by the JAX fleet
builder and carried into port artifacts with the same parameters,
scalers and thresholds (``gordo_tpu_torch.convert``), each package's
collection laid out as ``models/<revision>`` plus a ``latest`` symlink.

The JAX fleet trainer shuffles a feedforward bucket with each machine's
solo key folded with the epoch; :func:`jax_shuffle_noise` gives the
port's trainer the same draws (every ``lc-m-*`` machine has seed 0), so
both packages' refits see the same batches.
"""

import math
import os
import shutil
from pathlib import Path

import jax
import numpy as np
import torch

from gordo_tpu import serializer as jax_serializer
from gordo_tpu.builder.fleet_build import FleetModelBuilder as JaxFleetModelBuilder
from gordo_tpu.builder.fleet_build import _find_jax_estimator
from gordo_tpu.lifecycle import LifecycleConfig as JaxLifecycleConfig
from gordo_tpu.lifecycle import LifecycleManager as JaxLifecycleManager
from gordo_tpu.models.core import solo_init_key
from gordo_tpu_torch import convert
from gordo_tpu_torch.lifecycle import LifecycleConfig, LifecycleManager
from tests.test_lifecycle import BASE_REVISION, NAMES, make_lc_machine

PROJECT = "lifecycle-test"
SCALER_ATTRS = ("data_min_", "data_max_", "data_range_", "scale_", "min_")
#: thresholds under which no clean or shifted machine drifts: a dry tick
#: with them measures the statistics and refits nothing
NEVER = {"ratio_threshold": 1e12, "exceedance_threshold": 2.0}


def jax_shuffle_noise(self, m, n_samples, epoch):
    """The JAX fleet trainer's shuffle draws for machines of seed 0."""
    key = jax.random.fold_in(solo_init_key(0), epoch)
    noise = np.asarray(jax.random.uniform(key, (n_samples,)))
    return torch.from_numpy(np.stack([noise] * m))


def convert_machine(jax_dir: Path, port_dir: Path) -> None:
    """One JAX ``lc-m-*`` artifact as a port artifact: the flax params,
    the pipeline's MinMaxScaler, the detector's error scaler and its
    thresholds, and the JAX build metadata."""
    model = jax_serializer.load(jax_dir)
    scaler = model.base_estimator.steps[0][1]
    convert.write_artifact(
        port_dir,
        params=_find_jax_estimator(model).params_,
        definition=jax_serializer.into_definition(model),
        metadata=jax_serializer.load_metadata(jax_dir),
        pipeline_steps=[{attr: getattr(scaler, attr) for attr in SCALER_ATTRS}],
        scaler_arrays=convert.scaler_arrays_from_sklearn(model.scaler),
        thresholds={"aggregate_threshold_": model.aggregate_threshold_,
                    "feature_thresholds_": np.asarray(model.feature_thresholds_)},
    )


def build_pair(root: Path) -> Path:
    """``root/jax/models`` built by the JAX fleet builder and
    ``root/port/models`` converted from it, each ``<BASE_REVISION>`` plus
    ``latest``."""
    jax_models = root / "jax" / "models"
    JaxFleetModelBuilder(
        [make_lc_machine(n) for n in NAMES], fetch_backoff=lambda a: 0.0
    ).build(output_dir_base=jax_models / BASE_REVISION)
    os.symlink(BASE_REVISION, jax_models / "latest")
    port_models = root / "port" / "models"
    for name in NAMES:
        convert_machine(jax_models / BASE_REVISION / name, port_models / BASE_REVISION / name)
    shutil.copy(jax_models / BASE_REVISION / "build_report.json",
                port_models / BASE_REVISION / "build_report.json")
    os.symlink(BASE_REVISION, port_models / "latest")
    return root


def copy_pair(template: Path, dest: Path):
    """A private copy of both collections: (JAX models, port models)."""
    for package in ("jax", "port"):
        shutil.copytree(template / package, dest / package, symlinks=True)
    return dest / "jax" / "models", dest / "port" / "models"


def jax_manager(models: Path, **overrides) -> JaxLifecycleManager:
    return JaxLifecycleManager(str(models / "latest"), config=JaxLifecycleConfig(**overrides))


def port_manager(models: Path, **overrides) -> LifecycleManager:
    return LifecycleManager(str(models / "latest"), config=LifecycleConfig(**overrides),
                            device="cpu")


def revisions(models: Path):
    return sorted(n for n in os.listdir(models)
                  if not n.startswith(".") and os.path.isdir(models / n) and n != "latest")


def assert_close_tree(got, want, rtol: float, skip=("revision",), path="$"):
    """``got`` equals ``want`` with floats within ``rtol`` relative (1e-12
    absolute at 0), keys named in ``skip`` ignored at every level."""
    if isinstance(want, dict):
        assert isinstance(got, dict), f"{path}: {got!r} is not a dict"
        keys = set(want) - set(skip)
        assert set(got) - set(skip) == keys, f"{path}: keys {sorted(got)} != {sorted(want)}"
        for key in keys:
            assert_close_tree(got[key], want[key], rtol, skip, f"{path}.{key}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), f"{path}: {got!r} != {want!r}"
        for i, (g, w) in enumerate(zip(got, want)):
            assert_close_tree(g, w, rtol, skip, f"{path}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        assert isinstance(got, (int, float)), f"{path}: {got!r} is not a number"
        if math.isnan(want):
            assert math.isnan(got), f"{path}: {got} != nan"
        else:
            assert abs(got - want) <= max(rtol * abs(want), 1e-12), f"{path}: {got} != {want}"
    else:
        assert got == want, f"{path}: {got!r} != {want!r}"
