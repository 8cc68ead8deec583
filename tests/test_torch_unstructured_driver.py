"""Driver 3 of the port (``programs/unstructured_multigrid.py``) against the
JAX package's at the JAX test's size (tests/test_programs.py: 2D Q2, one
refinement, rtol 1e-6, ``--vtu``), its refusal without a card, and driver
1's ``--vtu`` against the JAX driver's files."""

import base64
import os
import re
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

from portable_multigrid_tpu_torch.programs import unstructured_multigrid

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--dim", "2", "--degree", "2", "--refinements", "1", "--rtol",
        "1e-6"]
PORT = [sys.executable, "-m",
        "portable_multigrid_tpu_torch.programs.unstructured_multigrid"]


@pytest.fixture(autouse=True)
def _default_settings(monkeypatch):
    """Every PMG_* setting at its default, whatever the environment holds
    (both packages' Chebyshev setups read PMG_EIG_MAX_ITERS)."""
    for key in [k for k in os.environ if k.startswith("PMG_")]:
        monkeypatch.delenv(key)


def _run(cmd, cwd=ROOT, env_extra=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **(env_extra or {}))
    proc = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=600)
    return proc


def _arrays(path):
    """Every DataArray of a VTK XML file, decoded: name -> values."""
    text = open(path).read()
    hlen = len(base64.b64encode(struct.pack("<4I", 0, 0, 0, 0)))
    out = {}
    for m in re.finditer(r'<DataArray type="(\w+)" (?:Name="(\w+)" )?'
                         r'(?:NumberOfComponents="\d+" )?format="binary">'
                         r'\s*(\S+)\s*</DataArray>', text):
        typ, name, blob = m.groups()
        data = zlib.decompress(base64.b64decode(blob[hlen:]))
        dtype = {"Float32": np.float32, "Int32": np.int32,
                 "UInt8": np.uint8}[typ]
        out[name or "points"] = np.frombuffer(data, dtype=dtype)
    return out


def test_driver3_matches_the_jax_driver(tmp_path):
    a, b = str(tmp_path / "port.vtu"), str(tmp_path / "jax.vtu")
    port = _run(PORT + ARGS + ["--device", "cpu", "--vtu", a])
    jax_ = _run([sys.executable, "programs/unstructured_multigrid.py"]
                + ARGS + ["--vtu", b])
    assert port.returncode == 0, port.stderr[-2000:]
    assert jax_.returncode == 0, jax_.stderr[-2000:]
    for pattern in (r" \d+ unstructured DoFs \(by level: .*\)",
                    r"Solver converged in \d+ iterations\."):
        want = re.findall(pattern, jax_.stdout)
        assert want and re.findall(pattern, port.stdout) == want
    for line in ("setup: ", "setup by step: refine", "solve: ",
                 f"wrote {a}", "DoF enumerator: native"):
        assert line in port.stdout
    got, want = _arrays(a), _arrays(b)
    assert set(got) == set(want) == {"points", "connectivity", "offsets",
                                     "types", "solution"}
    for name in ("points", "connectivity", "offsets", "types"):
        np.testing.assert_array_equal(got[name], want[name])
    np.testing.assert_allclose(got["solution"], want["solution"], rtol=1e-6,
                               atol=1e-7 * np.abs(want["solution"]).max())


def test_driver3_main_returns_the_stats(capsys):
    st = unstructured_multigrid.main(ARGS + ["--device", "cpu"])
    assert st.converged and st.dofs_per_level == [25, 81]
    assert "Solver converged in" in capsys.readouterr().out


def test_driver3_without_a_card_fails_loudly(monkeypatch, capsys):
    from portable_multigrid_tpu_torch.models import general_geometry

    built = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(general_geometry, "UnstructuredMultigrid",
                        lambda *a, **k: built.append((a, k)))
    with pytest.raises(SystemExit) as exc:
        unstructured_multigrid.main(ARGS)
    assert exc.value.code not in (0, None)
    assert "--device cpu" in str(exc.value.code)
    assert not built and "Solver converged" not in capsys.readouterr().out


def test_driver3_cli_without_a_card_exits_nonzero():
    proc = _run(PORT + ARGS, env_extra={"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "--device cpu" in proc.stderr
    assert "Solver converged" not in proc.stdout


def test_geometric_driver_vtu_matches_the_jax_driver(tmp_path):
    """Driver 1's ``--vtu`` at the JAX test's size (2D Q1, one cycle): the
    same file names, header and grid, the solution within 1e-6."""
    args = ["--dim", "2", "--max-degree", "1", "--cycles", "1", "--vtu"]
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    port = _run([sys.executable, "-m",
                 "portable_multigrid_tpu_torch.programs.geometric_multigrid",
                 *args, "--device", "cpu"], cwd=tmp_path / "port",
                env_extra={"PYTHONPATH": ROOT})
    jax_ = _run([sys.executable,
                 os.path.join(ROOT, "programs", "geometric_multigrid.py"),
                 *args], cwd=tmp_path / "jax")
    assert port.returncode == 0, port.stderr[-2000:]
    assert jax_.returncode == 0, jax_.stderr[-2000:]
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) == [
        "solution_p1_c0.vti"]
    a = tmp_path / "port" / names[0]
    b = tmp_path / "jax" / names[0]
    head = lambda p: p.read_text().split("<DataArray")[0]  # noqa: E731
    assert head(a) == head(b)
    got, want = _arrays(a)["solution"], _arrays(b)["solution"]
    assert got.size == 5 ** 2  # 2D Q1 on 4 x 4 cells (r = 2)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
