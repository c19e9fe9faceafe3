"""Build and load the port's CUDA sources (route: nvcc → shared library with
a plain C interface → ctypes).

Each source in ``ddp_tpu_torch/csrc/`` is compiled on first use into
``ddp_tpu_torch/_build/``, under a name that carries the hash of the source
and the flags, so an edited source is rebuilt and a stale library is never
loaded.  Importing this module builds nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# No --use_fast_math / -ftz: the kernels rely on IEEE sqrt of a negative
# pivot giving NaN and on isfinite.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)  # fmt: skip

# source name → (loaded library, seconds nvcc took; 0.0 when reused)
_LOADED: dict[str, tuple[ctypes.CDLL, float]] = {}


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def load(source: str) -> ctypes.CDLL:
    """The shared library built from ``csrc/<source>``, compiled if needed."""
    if source in _LOADED:
        return _LOADED[source][0]
    src = CSRC / source
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    lib_path = BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:16]}.so"
    seconds = 0.0
    if not lib_path.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            capture_output=True, text=True,
        )  # fmt: skip
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, lib_path)  # atomic: a concurrent build sees all or nothing
    _LOADED[source] = (ctypes.CDLL(str(lib_path)), seconds)
    return _LOADED[source][0]


def build_seconds(source: str) -> float:
    """Seconds nvcc took for ``source`` in this process (0.0 if reused)."""
    return _LOADED[source][1]
