"""Build and load the port's CUDA sources (route: nvcc → shared library with
a plain C interface → ctypes).

Each source in ``ddp_tpu_torch/csrc/`` is compiled on first use into
``ddp_tpu_torch/_build/``.  A source whose kernels specialise on a shape
(the Riccati ladder on (n, m, e) and its order, the fd kernels on the joint
count) is built once per shape: ``load(source, consts)`` passes each entry
of ``consts`` to nvcc as ``-DDDP_<KEY>=<value>``, and the library serves
that one shape, in float and in double — what a Pallas kernel does when it
specialises at trace time.  The library's name carries the shape and the
hash of the source, of the headers beside it (``csrc/*.cuh``), of the flags
and of the defines, so an edited source is rebuilt, a stale library is never
loaded, and two shapes never share one.  Importing this module builds
nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
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

# (source, defines) → (loaded library, seconds nvcc took; 0.0 when reused)
_LOADED: dict[tuple[str, tuple[str, ...]], tuple[ctypes.CDLL, float]] = {}


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def defines(consts: dict | None = None) -> tuple[str, ...]:
    """The nvcc ``-D`` flags of ``consts``, in key order: {"N": 4} →
    ("-DDDP_N=4",).  Values are integers."""
    out = []
    for key, value in sorted((consts or {}).items()):
        if not key.isidentifier() or isinstance(value, bool) or not isinstance(value, int):
            raise ValueError(f"a build constant is NAME=int, got {key}={value!r}")
        out.append(f"-DDDP_{key}={value}")
    return tuple(out)


def library_path(source: str, consts: dict | None = None) -> Path:
    """Where the library of ``csrc/<source>`` built with ``consts`` lives:
    ``_build/<stem>[-<KEY><value>…]-<hash>.so``, the hash over the source,
    the headers, the flags and the defines."""
    src = CSRC / source
    flags = defines(consts)
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS + flags).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    tag = "".join(f"-{k}{v}" for k, v in sorted((consts or {}).items()))
    return BUILD_DIR / f"{src.stem}{tag}-{digest.hexdigest()[:16]}.so"


def nvcc_command(source: str, consts: dict | None, out: Path) -> list[str]:
    """The nvcc command that builds ``csrc/<source>`` with ``consts`` into
    ``out``."""
    return [_nvcc(), *NVCC_FLAGS, *defines(consts), "-o", str(out), str(CSRC / source)]


def load(source: str, consts: dict | None = None) -> ctypes.CDLL:
    """The shared library built from ``csrc/<source>`` with ``consts``,
    compiled if needed.  Raises RuntimeError with nvcc's output when the
    build fails."""
    key = (source, defines(consts))
    if key in _LOADED:
        return _LOADED[key][0]
    lib_path = library_path(source, consts)
    seconds = 0.0
    if not lib_path.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(nvcc_command(source, consts, tmp), capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed on {source} with {' '.join(key[1]) or 'no defines'}:\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, lib_path)  # atomic: a concurrent build sees all or nothing
    _LOADED[key] = (ctypes.CDLL(str(lib_path)), seconds)
    return _LOADED[key][0]


def build_seconds(source: str, consts: dict | None = None) -> float:
    """Seconds nvcc took for ``source`` with ``consts`` in this process (0.0
    if the library was reused)."""
    return _LOADED[(source, defines(consts))][1]


def loaded() -> set:
    """The (source, defines) of every library this process has loaded."""
    return set(_LOADED)
