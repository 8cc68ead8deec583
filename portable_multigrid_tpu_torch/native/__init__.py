"""Native (C++) setup runtime, loaded via ctypes with build-on-demand.

Counterpart of ``portable_multigrid_tpu/native/__init__.py``, with a copy
of its ``pmg_native.cpp``: the host native tier, the counterpart of the
reference's C++ setup machinery (DoF enumeration, valence weights).  The
compute path is torch on the card; this library only numbers DoFs on the
host.

The shared library is compiled with g++ on first use into
``build/native/`` at the repository root (beside the CUDA kernels'
``build/kernels/``), never inside the package, and rebuilt when the source
is newer.  Every entry point has a pure-Python twin in ``fem/`` that runs
when the library cannot be built, and that the tests hold it against.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "pmg_native.cpp"
BUILD_DIR = _SRC.parents[2] / "build" / "native"
LIB_PATH = BUILD_DIR / "libpmg_native.so"
_lock = threading.Lock()
_lib = None


class NativeUnavailable(RuntimeError):
    pass


def _build() -> None:
    """Compile to a file of this process's own, then move it into place, so
    that processes building at once never load a half-written library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".libpmg_native.{os.getpid()}.so"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(_SRC), "-o",
           str(tmp)]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, LIB_PATH)


def get_lib():
    """Load (building if needed) the native library; raises NativeUnavailable."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        try:
            if (not LIB_PATH.exists()
                    or LIB_PATH.stat().st_mtime < _SRC.stat().st_mtime):
                _build()
            lib = ctypes.CDLL(str(LIB_PATH))
        except (OSError, subprocess.CalledProcessError) as exc:
            raise NativeUnavailable(str(exc)) from exc
        lib.pmg_enumerate_dofs.restype = ctypes.c_int64
        lib.pmg_enumerate_dofs.argtypes = [
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64,
        ]
        lib.pmg_valence_weights.restype = None
        lib.pmg_valence_weights.argtypes = [
            ctypes.c_int64,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double),
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    try:
        get_lib()
        return True
    except NativeUnavailable:
        return False


def enumerate_dofs_native(cells: np.ndarray, dim: int, degree: int):
    """C++ DoF enumeration; same contract as fem.dof_numbering.enumerate_dofs."""
    lib = get_lib()
    cells = np.ascontiguousarray(cells, dtype=np.int64)
    E = cells.shape[0]
    ndof = (degree + 1) ** dim
    l2g = np.zeros((E, ndof), dtype=np.int64)
    mask = np.zeros(E * ndof, dtype=np.float64)
    n = lib.pmg_enumerate_dofs(
        dim,
        degree,
        E,
        cells.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        l2g.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        mask.size,
    )
    if n < 0:
        raise RuntimeError("pmg_enumerate_dofs failed")
    return int(n), l2g, mask[:n].copy()


def valence_weights_native(l2g: np.ndarray, n_dofs: int) -> np.ndarray:
    lib = get_lib()
    l2g = np.ascontiguousarray(l2g, dtype=np.int64)
    out = np.zeros(n_dofs, dtype=np.float64)
    lib.pmg_valence_weights(
        l2g.shape[0],
        l2g.shape[1],
        l2g.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n_dofs,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return out


def enumerate_dofs(mesh, degree: int):
    """Native-if-available DoF enumeration (Python fallback otherwise)."""
    try:
        return enumerate_dofs_native(mesh.cells, mesh.dim, degree)
    except NativeUnavailable:
        from ..fem.dof_numbering import enumerate_dofs as py_enum

        return py_enum(mesh, degree)
