"""
The port stands alone: importing any of its modules loads neither JAX
nor the JAX package, nor any library the card's machine lacks.
"""

import json
import subprocess
import sys
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent.parent

FORBIDDEN = [
    "jax",
    "gordo_tpu",
    "flax",
    "optax",
    "pandas",
    "sklearn",
    "werkzeug",
    "yaml",
    "pyarrow",
    "dateutil",
    "click",
    "requests",
]


def test_port_imports_no_jax_and_no_missing_libraries():
    # every module of the package, found by walking it (pkgutil)
    script = (
        "import importlib, json, pkgutil, sys\n"
        "import gordo_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "gordo_tpu_torch.__path__, 'gordo_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        f"print(json.dumps([names, [m for m in {FORBIDDEN!r} if m in sys.modules]]))\n"
    )
    result = subprocess.run(
        [sys.executable, "-c", script],
        cwd=REPO_ROOT,
        capture_output=True,
        text=True,
        timeout=120,
        check=True,
    )
    names, loaded = json.loads(result.stdout.strip().splitlines()[-1])
    assert {
        "gordo_tpu_torch.builder.build_model",
        "gordo_tpu_torch.server.app",
        "gordo_tpu_torch.cli.cli",
        "gordo_tpu_torch.data.datasets",
        "gordo_tpu_torch.models.pipeline",
        "gordo_tpu_torch.workflow.yaml_reader",
        "gordo_tpu_torch.workflow.config_elements.normalized_config",
        "gordo_tpu_torch.machine.machine",
        "gordo_tpu_torch.builder.local_build",
        "gordo_tpu_torch.builder.fleet_build",
        "gordo_tpu_torch.models.optim",
        "gordo_tpu_torch.models.callbacks",
        "gordo_tpu_torch.parallel.fleet",
        "gordo_tpu_torch.parallel.bucketing",
        "gordo_tpu_torch.parallel.precision",
        "gordo_tpu_torch.server.fleet_serving",
        "gordo_tpu_torch.server.batching",
        "gordo_tpu_torch.server.catalog",
        "gordo_tpu_torch.utils.atomic",
        "gordo_tpu_torch.parallel.checkpoint",
        "gordo_tpu_torch.parallel.sweep",
        "gordo_tpu_torch.router.ring",
        "gordo_tpu_torch.router.health",
        "gordo_tpu_torch.router.app",
    } <= set(names)
    assert loaded == []
