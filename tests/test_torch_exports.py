"""The port's top-level names (ROADMAP C.2) and its import rules: every name
of the JAX package's ``__all__`` is in the port's and is an object of the
port; importing the port, and every module this slice added, loads no JAX
module and builds nothing (neither the CUDA kernels nor the native DoF
enumerator)."""

import os
import subprocess
import sys

import pytest

import portable_multigrid_tpu
import portable_multigrid_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the modules added with general geometry, utils and driver 3
NEW_MODULES = (
    "portable_multigrid_tpu_torch.fem.general_mesh",
    "portable_multigrid_tpu_torch.fem.dof_numbering",
    "portable_multigrid_tpu_torch.native",
    "portable_multigrid_tpu_torch.ops.indexed",
    "portable_multigrid_tpu_torch.models.general_geometry",
    "portable_multigrid_tpu_torch.utils.vtu",
    "portable_multigrid_tpu_torch.utils.checkpoint",
    "portable_multigrid_tpu_torch.programs.unstructured_multigrid",
    "portable_multigrid_tpu_torch.convert",
)


@pytest.mark.parametrize("name", portable_multigrid_tpu.__all__)
def test_jax_name_exported_by_the_port(name):
    assert name in portable_multigrid_tpu_torch.__all__
    obj = getattr(portable_multigrid_tpu_torch, name)
    assert obj.__module__.startswith("portable_multigrid_tpu_torch."), (
        name, obj.__module__)


def test_every_port_export_resolves():
    for name in portable_multigrid_tpu_torch.__all__:
        assert getattr(portable_multigrid_tpu_torch, name) is not None


def test_import_loads_no_jax_and_builds_nothing():
    """In a child process with process creation made to fail: importing the
    package and the new modules starts no compiler and loads no library."""
    code = (
        "import subprocess, sys\n"
        "def refuse(*a, **k):\n"
        "    raise AssertionError(f'a process was started: {a}')\n"
        "subprocess.Popen = refuse\n"
        "subprocess.run = refuse\n"
        "import portable_multigrid_tpu_torch\n"
        + "".join(f"import {m}\n" for m in NEW_MODULES) +
        "from portable_multigrid_tpu_torch import _build, native\n"
        "assert _build._LIBRARY is None and native._lib is None\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'portable_multigrid_tpu'\n"
        "       or m.startswith('portable_multigrid_tpu.')]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("module", NEW_MODULES)
def test_new_module_source_names_no_jax(module):
    """No import of jax or of the JAX package in the source of each new
    module."""
    import importlib

    path = importlib.import_module(module).__file__
    with open(path) as fh:
        lines = [ln.strip() for ln in fh]
    imports = [ln for ln in lines if ln.startswith(("import ", "from "))]
    for ln in imports:
        words = ln.replace(",", " ").split()
        assert "jax" not in words and not any(
            w.startswith(("jax.", "portable_multigrid_tpu."))
            or w == "portable_multigrid_tpu" for w in words), (module, ln)
