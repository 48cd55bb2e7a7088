"""
The port stands alone: importing its entry points loads neither JAX nor
the JAX package, nor any library the card's machine lacks.
"""

import json
import subprocess
import sys
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent.parent

MODULES = [
    "gordo_tpu_torch",
    "gordo_tpu_torch.server.app",
    "gordo_tpu_torch.server.runner",
    "gordo_tpu_torch.convert",
    "gordo_tpu_torch.models.anomaly.diff",
]
FORBIDDEN = [
    "jax",
    "gordo_tpu",
    "flax",
    "pandas",
    "sklearn",
    "werkzeug",
    "yaml",
    "pyarrow",
    "dateutil",
]


def test_port_imports_no_jax_and_no_missing_libraries():
    script = (
        "import importlib, json, sys\n"
        f"for name in {MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        f"print(json.dumps([m for m in {FORBIDDEN!r} if m in sys.modules]))\n"
    )
    result = subprocess.run(
        [sys.executable, "-c", script],
        cwd=REPO_ROOT,
        capture_output=True,
        text=True,
        timeout=120,
        check=True,
    )
    assert json.loads(result.stdout.strip().splitlines()[-1]) == []
