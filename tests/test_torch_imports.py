"""
The port stands alone: importing any of its modules loads neither JAX
nor the JAX package, nor anything under ``benchmarks/``, nor any library
the card's machine lacks; neither does ``chip_smoke.py``. The client's
wire layer, the observability core, the tuner and the plane's commands
load no torch either.
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
    "prometheus_client",
    "influxdb",
    "benchmarks",
]

#: modules that need no torch: importing them alone loads none
TORCH_FREE = [
    "gordo_tpu_torch.client.io",
    "gordo_tpu_torch.client.utils",
    "gordo_tpu_torch.client.streaming",
    "gordo_tpu_torch.client.forwarders",
    "gordo_tpu_torch.observability.registry",
    "gordo_tpu_torch.observability.tracing",
    "gordo_tpu_torch.observability.attribution",
    "gordo_tpu_torch.observability.prom_text",
    "gordo_tpu_torch.observability.rollup",
    "gordo_tpu_torch.observability.device_memory",
    "gordo_tpu_torch.observability.report",
    "gordo_tpu_torch.robustness.faults",
    "gordo_tpu_torch.utils.http",
    "gordo_tpu_torch.cli.trace",
    "gordo_tpu_torch.observability.slo",
    "gordo_tpu_torch.tuning",
    "gordo_tpu_torch.tuning.knobs",
    "gordo_tpu_torch.tuning.corpus",
    "gordo_tpu_torch.tuning.model",
    "gordo_tpu_torch.tuning.profile",
    "gordo_tpu_torch.tuning.calibrate",
    "gordo_tpu_torch.cli.plane",
    "gordo_tpu_torch.cli.tune",
    "gordo_tpu_torch.observability.sampling",
    "gordo_tpu_torch.observability.profiler",
    "gordo_tpu_torch.utils.tracing",
    "gordo_tpu_torch.cli.profile",
    "gordo_tpu_torch.parallel.mesh",
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
        "gordo_tpu_torch.robustness.faults",
        "gordo_tpu_torch.observability.events",
        "gordo_tpu_torch.lifecycle.drift",
        "gordo_tpu_torch.lifecycle.refit",
        "gordo_tpu_torch.lifecycle.promote",
        "gordo_tpu_torch.lifecycle.manager",
        "gordo_tpu_torch.client.client",
        "gordo_tpu_torch.client.frames",
        "gordo_tpu_torch.cli.client",
        "gordo_tpu_torch.server.prometheus.metrics",
        "gordo_tpu_torch.builder.ledger",
        "gordo_tpu_torch.cli.buckets",
        "gordo_tpu_torch.server.model_io",
        "gordo_tpu_torch.parallel.distributed",
        "gordo_tpu_torch.parallel.data_parallel",
        "gordo_tpu_torch.parallel.sequence",
        "gordo_tpu_torch.parallel.long_context",
        *TORCH_FREE,
    } <= set(names)
    assert loaded == []


def test_the_client_wire_layer_and_observability_load_no_torch():
    script = (
        "import importlib, json, sys\n"
        f"for name in {TORCH_FREE!r}:\n"
        "    importlib.import_module(name)\n"
        f"print(json.dumps([m for m in ['torch', *{FORBIDDEN!r}] if m in sys.modules]))\n"
    )
    result = subprocess.run([sys.executable, "-c", script], cwd=REPO_ROOT, capture_output=True,
                            text=True, timeout=120, check=True)
    assert json.loads(result.stdout.strip().splitlines()[-1]) == []
    # and no module of the client imports torch itself
    for path in (REPO_ROOT / "gordo_tpu_torch" / "client").glob("*.py"):
        text = path.read_text()
        assert "import torch" not in text and "from torch" not in text, path.name


def test_chip_smoke_imports_no_jax_no_jax_package_and_no_benchmarks():
    """The smoke script, imported as a module (its main does not run),
    loads none of them; nor does any line of it name them."""
    script = (
        "import importlib.util, json, sys\n"
        "spec = importlib.util.spec_from_file_location('chip_smoke', 'chip_smoke.py')\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        f"print(json.dumps([m for m in {FORBIDDEN!r} if m in sys.modules]))\n"
    )
    result = subprocess.run([sys.executable, "-c", script], cwd=REPO_ROOT, capture_output=True,
                            text=True, timeout=120, check=True)
    assert json.loads(result.stdout.strip().splitlines()[-1]) == []
    for line in (REPO_ROOT / "chip_smoke.py").read_text().splitlines():
        stripped = line.strip()
        if stripped.startswith(("import ", "from ")):
            module = stripped.split()[1].split(".")[0]
            assert module not in ("jax", "gordo_tpu", "benchmarks"), line
