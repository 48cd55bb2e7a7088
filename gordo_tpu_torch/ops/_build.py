"""
Builds the port's CUDA sources into shared libraries and loads them with
ctypes.

Each ``csrc/<name>.cu`` is compiled on first use by ``nvcc`` for Hopper
(``sm_90a``) into ``_build/<name>-<digest>.so``, where the digest covers
the source, the shared headers (``csrc/*.cuh``) and the flags, so an
edited source never loads a stale library. The sources have a plain C interface (no PyTorch headers), which
keeps a build to seconds. The build directory is listed in ``.gitignore``.

Nothing here runs at import time: the CPU tests import every module, and
a machine without a card usually has no ``nvcc``.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, then ``nvcc`` on PATH, then the default toolkit."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the port's "
        "CUDA kernels are compiled from source on first use"
    )


def sources() -> List[str]:
    """The name of every ``csrc/<name>.cu``."""
    return sorted(path.stem for path in CSRC_DIR.glob("*.cu"))


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    digest = hashlib.sha256()
    for path in [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]:
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> Tuple[Path, str]:
    """
    Compile ``csrc/<name>.cu`` unless its library already exists; returns
    (library path, compiler output). The library is written under a
    temporary name and renamed into place, so a concurrent loader never
    sees a partial file.
    """
    target = library_path(name)
    if target.is_file():
        return target, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=f".{name}-", suffix=".so")
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / f"{name}.cu")]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {name}.cu (exit {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return target, proc.stdout + proc.stderr


def _timed_build(name: str) -> Tuple[str, float]:
    start = time.perf_counter()
    _, output = build(name)
    return output, time.perf_counter() - start


def build_all(names: Iterable[str]) -> Dict[str, Tuple[str, float]]:
    """Compile several sources at once (one nvcc each, started together);
    returns each source's (compiler output, seconds)."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        futures = {name: pool.submit(_timed_build, name) for name in names}
        return {name: future.result() for name, future in futures.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path, _ = build(name)
            lib = ctypes.CDLL(str(path))
            _loaded[name] = lib
        return lib
