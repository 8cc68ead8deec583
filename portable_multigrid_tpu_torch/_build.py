"""Build and load the port's CUDA kernels (``csrc/*.cu``).

The sources compile with ``nvcc`` into one shared library with a plain C
interface, loaded with :mod:`ctypes` — no PyTorch headers, so a build takes
seconds.  The library goes to ``build/kernels/`` at the repository root,
named by a hash of the sources and flags: a changed source builds anew, an
unchanged one is reused.  Only the repository's own sources are compiled.
Building happens at first use, never at import (the CPU tests import every
module of the port on machines without ``nvcc``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
# argument lists of the C entry points (pointers and the stream as void*,
# so ctypes never truncates them to 32 bits)
_SIGNATURES = {
    "pmg_laplace": [_P] * 10 + [_D, _D] + [_I] * 6 + [_P],
    "pmg_cheb2": [_P] * 10 + [_D] * 5 + [_I] * 6 + [_P, _P],
    "pmg_transfer": [_P] * 5 + [_I] * 8 + [_P],
}


class BuildError(RuntimeError):
    """nvcc failed; the message carries its output."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise BuildError("nvcc not found on PATH or under /usr/local/cuda/bin")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


class KernelLibrary:
    """The loaded shared library plus how it was obtained."""

    def __init__(self, path: Path, seconds: float, log: str):
        self.path = path
        self.build_seconds = seconds
        self.build_log = log
        self._lib = ctypes.CDLL(str(path))
        for base, argtypes in _SIGNATURES.items():
            for suffix in ("f32", "f64"):
                fn = getattr(self._lib, f"{base}_{suffix}")
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int

    def fn(self, base: str, dtype_suffix: str):
        return getattr(self._lib, f"{base}_{dtype_suffix}")


_LIBRARY: KernelLibrary | None = None


def build(force: bool = False) -> KernelLibrary:
    """Compile (when needed) and load the kernel library."""
    global _LIBRARY
    if _LIBRARY is not None and not force:
        return _LIBRARY
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    target = BUILD_DIR / f"libpmg_kernels_{_digest()}.so"
    t0 = time.perf_counter()
    log = ""
    if force or not target.exists():
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
        proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise BuildError(
                f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{log}")
        os.replace(tmp, target)
    _LIBRARY = KernelLibrary(target, time.perf_counter() - t0, log)
    return _LIBRARY


def stream_handle(device) -> int:
    """PyTorch's current CUDA stream on ``device`` as an integer handle."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
