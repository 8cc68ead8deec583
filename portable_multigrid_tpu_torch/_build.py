"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source compiles with its own ``nvcc``, all started together, and the
objects link into one shared library with a plain C interface, loaded with
:mod:`ctypes` — no PyTorch headers, so a build takes seconds.  The library
goes to ``build/kernels/`` at the repository root, named by a hash of the
sources and flags: a changed source builds anew, an
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
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                              "-Xptxas=-v", "-c")
LINK_FLAGS = ARCH_FLAGS + ("-shared",)

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
# argument lists of the C entry points (pointers and the stream as void*,
# so ctypes never truncates them to 32 bits)
_SIGNATURES = {
    "pmg_laplace": [_P] * 21 + [_D, _D] + [_I] * 12 + [_P],
    "pmg_laplace2d": [_P] * 11 + [_D, _D] + [_I] * 7 + [_P],
    "pmg_cheb2": [_P] * 12 + [_D] * 5 + [_I] * 13 + [_P],
    "pmg_cheb2lr": [_P] * 10 + [_D] * 4 + [_I] * 6 + [_P],
    "pmg_prolong": [_P] * 5 + [_I] * 7 + [_P],
    "pmg_restrict": [_P] * 4 + [_I] * 6 + [_P],
    "pmg_elasticity": [_P] * 24 + [_D] * 4 + [_I] * 9 + [_P],
}
# entry points with no dtype suffix
_UNTYPED_SIGNATURES = {
    "pmg_mark": [_P, _I, _I, _P],
    "pmg_cheb2mma": _SIGNATURES["pmg_cheb2"],  # float32 only
    "pmg_elasticitymma": _SIGNATURES["pmg_elasticity"],  # float32 only
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
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
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
        for name, argtypes in _UNTYPED_SIGNATURES.items():
            fn = getattr(self._lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int

    def fn(self, base: str, dtype_suffix: str | None = None):
        """The entry point ``base_<dtype_suffix>``, or ``base`` itself for
        an untyped one."""
        if dtype_suffix is None:
            return getattr(self._lib, base)
        return getattr(self._lib, f"{base}_{dtype_suffix}")


_LIBRARY: KernelLibrary | None = None


def _run_logged(cmds: list[list[str]], logdir: Path) -> tuple[list[int], str]:
    """Run the commands side by side; return their exit codes and output."""
    logs = [logdir / f"{k}.log" for k in range(len(cmds))]
    procs = []
    for cmd, path in zip(cmds, logs):
        with open(path, "w") as fh:
            procs.append(subprocess.Popen(cmd, stdout=fh,
                                          stderr=subprocess.STDOUT))
    codes = [proc.wait() for proc in procs]
    return codes, "".join(path.read_text() for path in logs)


def _compile_and_link(target: Path) -> str:
    """One nvcc per source, all at once, then one link; returns the log."""
    work = target.with_suffix(f".{os.getpid()}.d")
    work.mkdir(exist_ok=True)
    try:
        nvcc = _nvcc()
        objs = [work / f"{src.stem}.o" for src in _sources()]
        cmds = [[nvcc, *COMPILE_FLAGS, "-o", str(obj), str(src)]
                for src, obj in zip(_sources(), objs)]
        tmp = work / target.name
        cmds_link = [[nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objs)]]
        log = ""
        for batch in (cmds, cmds_link):
            codes, out = _run_logged(batch, work)
            log += out
            bad = [" ".join(c) for c, code in zip(batch, codes) if code]
            if bad:
                raise BuildError(f"nvcc failed: {'; '.join(bad)}\n{log}")
        os.replace(tmp, target)
        return log
    finally:
        shutil.rmtree(work, ignore_errors=True)


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
        log = _compile_and_link(target)
    _LIBRARY = KernelLibrary(target, time.perf_counter() - t0, log)
    return _LIBRARY


def stream_handle(device) -> int:
    """PyTorch's current CUDA stream on ``device`` as an integer handle."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
