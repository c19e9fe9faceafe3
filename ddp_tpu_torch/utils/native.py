"""ctypes bindings for the repo's native C++ runtime, ``cpp/ddp_runtime.cpp``
(≙ ddp_tpu/utils/native.py).

The source is compiled on first use with ``g++ -O2 -shared -fPIC`` into
``ddp_tpu_torch/_build/``, under a name that carries the hash of the source
and the flags (so an edited source is rebuilt), through a temporary file
and an atomic rename (so concurrent processes never load half a library).
When no compiler is available ``load`` returns None and callers degrade to
pure Python.  Native pieces: the chronometer and logging (≙ the reference's
``src/lib.cpp``), the colored failure report, and the URDF scanner (≙ its
urdfdom ingestion).  Importing this module builds nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile

import numpy as np

from ddp_tpu_torch.kernels._build import BUILD_DIR

SOURCE = BUILD_DIR.parent.parent / "cpp" / "ddp_runtime.cpp"
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

_lib = None
_tried = False


def _build() -> str | None:
    """Path of the built library, compiling it if needed; None when the
    source or the compiler is missing or the compile fails."""
    if not SOURCE.exists():
        return None
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode())
    so = BUILD_DIR / f"libddp_runtime-{digest.hexdigest()[:16]}.so"
    if so.exists():
        return str(so)
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(
            ["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
            check=True, capture_output=True, timeout=120,
        )  # fmt: skip
        os.replace(tmp, so)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return None
    return str(so)


def load():
    """Return the loaded native library, or None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    so = _build()
    if so is None:
        return None
    try:
        lib = ctypes.CDLL(so)
        _bind(lib)
    except (OSError, AttributeError):
        # unloadable or ABI-stale library (missing symbol) → no native path
        return None
    _lib = lib
    return _lib


def _bind(lib):
    lib.ddp_log.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.ddp_chrono_start.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.ddp_chrono_start.restype = ctypes.c_int64
    lib.ddp_chrono_stop.argtypes = [ctypes.c_int64]
    lib.ddp_chrono_stop.restype = ctypes.c_double
    lib.ddp_report_failure.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p,
    ]  # fmt: skip
    lib.ddp_urdf_parse.argtypes = [ctypes.c_char_p]
    lib.ddp_urdf_parse.restype = ctypes.c_int64
    for f in ("ddp_urdf_n_joints", "ddp_urdf_n_links"):
        getattr(lib, f).argtypes = [ctypes.c_int64]
        getattr(lib, f).restype = ctypes.c_int64
    lib.ddp_urdf_joint_numeric.argtypes = [
        ctypes.c_int64, ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
    ]  # fmt: skip
    lib.ddp_urdf_joint_limit_mimic.argtypes = [
        ctypes.c_int64, ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
    ]  # fmt: skip
    lib.ddp_urdf_link_inertial.argtypes = [ctypes.c_int64, ctypes.POINTER(ctypes.c_double)]
    lib.ddp_urdf_string.argtypes = [ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64]
    lib.ddp_urdf_string.restype = ctypes.c_char_p
    lib.ddp_urdf_free.argtypes = [ctypes.c_int64]


def _default_log() -> str:
    return os.path.join(tempfile.gettempdir(), "chrono.log")


class NativeChrono:
    """Context manager over the C++ chronometer (≙ chronometer_t); appends
    to ``path`` (``chrono.log`` in the temporary directory by default)."""

    def __init__(self, message: str, path: str | None = None):
        self.message = message
        self.path = path or _default_log()
        self.handle = None
        self.elapsed = None

    def __enter__(self):
        lib = load()
        if lib is not None:
            self.handle = lib.ddp_chrono_start(self.message.encode(), self.path.encode())
        return self

    def __exit__(self, *exc):
        lib = load()
        if lib is not None and self.handle is not None:
            self.elapsed = lib.ddp_chrono_stop(self.handle)
        return False


def native_log(path: str, msg: str) -> bool:
    lib = load()
    if lib is None:
        return False
    lib.ddp_log(path.encode(), msg.encode())
    return True


def parse_urdf_native(xml: str):
    """Parse URDF with the C++ scanner.  Returns a dict of raw records (the
    same information as ``models.urdf._records_from_etree``) or None if the
    native library is unavailable."""
    lib = load()
    if lib is None:
        return None
    h = lib.ddp_urdf_parse(xml.encode())
    if h == 0:
        raise ValueError("native URDF parse failed")

    def doubles(n):
        buf = np.zeros(n, dtype=np.float64)
        return buf, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_double))

    try:
        nj = lib.ddp_urdf_n_joints(h)
        nl = lib.ddp_urdf_n_links(h)
        (origin, p_origin), (axis, p_axis) = doubles(nj * 6), doubles(nj * 3)
        lib.ddp_urdf_joint_numeric(h, p_origin, p_axis)
        inertial, p_inertial = doubles(nl * 13)
        lib.ddp_urdf_link_inertial(h, p_inertial)
        (lim, p_lim), (mim, p_mim) = doubles(nj * 9), doubles(nj * 3)
        lib.ddp_urdf_joint_limit_mimic(h, p_lim, p_mim)
        lim = lim.reshape(nj, 9)
        mim = mim.reshape(nj, 3)

        def strings(table, n):
            return [lib.ddp_urdf_string(h, table.encode(), i).decode() for i in range(n)]

        mimic_joint = strings("joint_mimic_joint", nj)
        # the record format of _records_from_etree: None when the element is
        # absent, a dict of the attributes present otherwise
        joint_limits = [
            None
            if lim[i, 0] == 0.0
            else {
                k: lim[i, 2 + 2 * j]
                for j, k in enumerate(("lower", "upper", "velocity", "effort"))
                if lim[i, 1 + 2 * j] != 0.0
            }
            for i in range(nj)
        ]
        joint_mimic = [
            None
            if mim[i, 0] == 0.0
            else {"joint": mimic_joint[i], "multiplier": mim[i, 1], "offset": mim[i, 2]}
            for i in range(nj)
        ]
        return dict(
            robot_name=lib.ddp_urdf_string(h, b"robot_name", 0).decode(),
            joint_names=strings("joint_name", nj),
            joint_types=strings("joint_type", nj),
            joint_parents=strings("joint_parent", nj),
            joint_children=strings("joint_child", nj),
            joint_origin=origin.reshape(nj, 6),
            joint_axis=axis.reshape(nj, 3),
            joint_limits=joint_limits,
            joint_mimic=joint_mimic,
            link_names=strings("link_name", nl),
            link_inertial=inertial.reshape(nl, 13),
        )
    finally:
        lib.ddp_urdf_free(h)
