"""Port parity: the elasticity operators (``ops/elasticity.py``, the kron
path, and ``ops/cuda_elasticity.py``, B.5) against the JAX package, on
CPU, where the B.5 wrapper runs its plain twin.

* the kron operator against the JAX ``make_elasticity(variant="kron")``
  and ``dense_elasticity_operator`` at the JAX tests' cases, to 1e-12;
  the separable inverse diagonal against the JAX element loop; symmetry;
* every B.5 mode of the twin against ``PallasElasticityOperator._run`` in
  interpret mode (``zpad=0``), in float64, to 1e-12: here on one block
  (p = 2, n = 4), in tests/test_torch_elasticity_blocks.py on a 2x2 block
  grid (each interpret run takes ~5 s);
* the kernel's grouping of the 21 chains (csrc/elasticity.cu), emulated
  with banded difference-form contractions, against the twin;
* the row sums of the difference form, the tile fit, layout checks, and
  the no-JAX import rule of the elasticity path.

Every comparison runs with mu = 0.7, lam = 1.3: at mu = lam a swap of G and
G^T, or of mu and lam, leaves the operator unchanged.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from portable_multigrid_tpu.fem.mesh import HyperCubeMesh as JMesh
from portable_multigrid_tpu.fem.space import FESpace as JSpace
from portable_multigrid_tpu.ops.elasticity import (
    _elasticity_diagonal,
    dense_elasticity_operator as jdense,
    make_elasticity as jmake_elasticity,
)
from portable_multigrid_tpu.ops.pallas_elasticity import make_pallas_elasticity
from portable_multigrid_tpu_torch import ElasticityMultigrid
from portable_multigrid_tpu_torch.fem.mesh import HyperCubeMesh
from portable_multigrid_tpu_torch.fem.space import FESpace
from portable_multigrid_tpu_torch.ops.cuda_elasticity import (
    LAUNCHES,
    SMEM_BUDGET,
    SMEM_LIMIT,
    elasticity_smem_elems,
    elasticity_tile,
    make_cuda_elasticity,
)
from portable_multigrid_tpu_torch.ops.cuda_laplace2d import banded
from portable_multigrid_tpu_torch.ops.elasticity import (
    dense_elasticity_operator,
    elasticity_diagonal_by_elements,
    make_elasticity,
)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MU, LAM = 0.7, 1.3
MODES = ["apply", "residual1t", "residual3t", "cheb", "chebl", "chebd",
         "chebdl"]
# the TPU kernel takes its scalars in float32: these are exact there
THETA, C0, C1 = 1.25, 0.5625, 1.3125


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(a).max()


def _spaces(dim, p, r):
    return JSpace(JMesh(dim, r), p), FESpace(HyperCubeMesh(dim, r), p)


@pytest.mark.parametrize("dim,p,r", [(2, 1, 2), (2, 2, 2), (3, 2, 1),
                                     (3, 3, 1)])
def test_kron_matches_jax_and_dense(dim, p, r):
    jsp, sp = _spaces(dim, p, r)
    op = make_elasticity(sp, torch.float64, MU, LAM)
    u = np.random.default_rng(p).standard_normal(op.shape)
    want = np.asarray(jmake_elasticity(jsp, jnp.float64, mu=MU, lam=LAM,
                                       variant="kron").apply(jnp.asarray(u)))
    A = dense_elasticity_operator(sp, MU, LAM)
    np.testing.assert_array_equal(A, jdense(jsp, MU, LAM))
    dense = (A @ u.reshape(-1)).reshape(op.shape)
    got = op.apply(torch.as_tensor(u)).numpy()
    assert _rel(want, got) < 1e-12
    assert _rel(dense, got) < 1e-12
    assert _rel(A, A.T) < 1e-14  # the operator is symmetric
    v = np.random.default_rng(p + 1).standard_normal(op.shape)
    uAv = float((torch.as_tensor(u) * op.apply(torch.as_tensor(v))).sum())
    vAu = float((torch.as_tensor(v) * op.apply(torch.as_tensor(u))).sum())
    assert uAv == pytest.approx(vAu, rel=1e-12)


@pytest.mark.parametrize("dim,p,r", [(2, 3, 2), (3, 2, 2)])
def test_separable_inverse_diagonal_matches_element_loop(dim, p, r):
    jsp, sp = _spaces(dim, p, r)
    want = 1.0 / _elasticity_diagonal(jsp, MU, LAM)
    np.testing.assert_array_equal(elasticity_diagonal_by_elements(sp, MU, LAM),
                                  _elasticity_diagonal(jsp, MU, LAM))
    assert _rel(want, make_elasticity(sp, torch.float64, MU, LAM)
                .inv_diag.numpy()) < 1e-12
    if dim == 3:
        assert _rel(want, make_cuda_elasticity(sp, torch.float64, MU, LAM)
                    .inv_diag.numpy()) < 1e-12


def _masked(sp, rng):
    return rng.standard_normal((3,) + sp.grid_shape) * sp.free_mask()[None]


def check_twin_matches_pallas_run(p, r, bx, mode):
    """One B.5 mode of the twin against the TPU kernel in interpret mode
    (``zpad=0``); the TPU modes that take the stacked full grid get it, the
    port's kernel its trimmed part."""
    jsp, sp = _spaces(3, p, r)
    jop = make_pallas_elasticity(jsp, jnp.float64, mu=MU, lam=LAM, bx=bx,
                                 by=bx, interpret=True, zpad=0)
    op = make_cuda_elasticity(sp, torch.float64, MU, LAM)
    rng = np.random.default_rng(7)
    full = [_masked(sp, rng) for _ in range(3)]
    u, r_, x = (np.ascontiguousarray(f[:, :-1, :-1, :-1]) for f in full)
    comps = lambda a: tuple(jnp.asarray(c) for c in a)  # noqa: E731
    if mode == "apply":
        want = (np.stack(jop._run("apply", jnp.asarray(full[0]))),)
        got = op.run("apply", torch.as_tensor(u))
    elif mode == "residual1t":
        want = (np.stack(jop._run("residual1", jnp.asarray(full[0]),
                                  comps(r_))),)
        got = op.run(mode, torch.as_tensor(u), (torch.as_tensor(r_),))
    elif mode == "residual3t":
        outs = jop._run("residual", jnp.asarray(full[0]), comps(r_),
                        [THETA, THETA])
        r0, d0 = np.stack(outs[:3]), np.stack(outs[3:])
        want = (r0, d0, u + d0)
        got = op.run(mode, torch.as_tensor(u), (torch.as_tensor(r_),),
                     (THETA,))
    else:
        xin = u if mode in ("chebd", "chebdl") else x
        jmode = "chebl" if mode.endswith("l") else "cheb"
        outs = jop._run(jmode, comps(u), comps(r_) + comps(xin), [C0, C1])
        want = tuple(np.stack(outs[k:k + 3]) for k in range(0, len(outs), 3))
        ins = ((torch.as_tensor(r_),) if mode in ("chebd", "chebdl")
               else (torch.as_tensor(r_), torch.as_tensor(x)))
        got = op.run(mode, torch.as_tensor(u), ins, (C0, C1))
    assert len(got) == len(want)
    for w, g in zip(want, got):
        assert g.shape == w.shape
        assert _rel(w, g.numpy()) <= 1e-12


@pytest.mark.parametrize("mode", MODES)
def test_twin_matches_pallas_run(mode):
    check_twin_matches_pallas_run(2, 2, 4, mode)


def kernel_emulation(op, u, lx=None):
    """The kernel's schedule in plain torch (csrc/elasticity.cu): x chunks
    of ``lx`` output planes (the launch tile's LX by default), each marched
    from its p lead-in planes before to p after; per input plane the z
    stage (K, M, G, H) and the y-z products of each component summed into
    the 12 groups (output c, x matrix); the groups of each plane in a ring
    of 2p+1 slots; once plane x+p is in, output x contracted from the ring
    along x.  Every K, G and H contraction in difference form."""
    p = op.degree
    R, N = 2 * p + 1, op.n * p
    lx = op.tile[0] if lx is None else lx

    def K(t, ax):
        return banded(t, op.kband, ax, op.ksum)

    def M(t, ax):
        return banded(t, op.mband, ax)

    def G(t, ax):
        return banded(t, op.gband, ax, op.gsum)

    def H(t, ax):
        return banded(t, op.hband, ax, op.hsum)

    mu, lam = op.mu, op.lam
    al = 2 * mu + lam
    k_, m_, g_, h_ = 0, 1, 2, 3  # x matrices: group 4 c + X
    out = torch.zeros_like(u)
    for x0 in range(0, N, lx):
        xs, xe = x0 - p, min(x0 + lx, N) + p
        ring = [None] * R
        for xin in range(xs, xe):
            plane = (u[:, xin] if 0 <= xin < N
                     else torch.zeros_like(u[:, 0]))
            g = [0.0] * 12
            for a in range(3):
                zk, zm, zg, zh = (W(plane[a], 1) for W in (K, M, G, H))
                mm, km, mk = M(zm, 0), K(zm, 0), M(zk, 0)
                gm, hm, gh, hg = G(zm, 0), H(zm, 0), G(zh, 0), H(zg, 0)
                mg, mh = M(zg, 0), M(zh, 0)
                terms = {
                    0: [(0 + k_, al * mm), (0 + m_, mu * (km + mk)),
                        (4 + g_, mu * hm), (4 + h_, lam * gm),
                        (8 + g_, mu * mh), (8 + h_, lam * mg)],
                    1: [(4 + k_, mu * mm), (4 + m_, al * km + mu * mk),
                        (0 + h_, mu * gm), (0 + g_, lam * hm),
                        (8 + m_, mu * gh + lam * hg)],
                    2: [(8 + k_, mu * mm), (8 + m_, mu * km + al * mk),
                        (0 + h_, mu * mg), (0 + g_, lam * mh),
                        (4 + m_, mu * hg + lam * gh)],
                }[a]
                for k, t in terms:
                    g[k] = g[k] + t
            ring[(xin - xs) % R] = [t + torch.zeros_like(plane[0])
                                    for t in g]
            x = xin - p
            if x < x0:
                continue
            base = (x - x0) % R
            cen = ring[(base + p) % R]
            for c in range(3):
                acc = (op.ksum[x] * cen[4 * c + k_]
                       + op.gsum[x] * cen[4 * c + g_]
                       + op.hsum[x] * cen[4 * c + h_])
                for o in range(R):
                    s = ring[(base + o) % R]
                    acc = (acc
                           + op.kband[o, x] * (s[4 * c + k_] - cen[4 * c + k_])
                           + op.mband[o, x] * s[4 * c + m_]
                           + op.gband[o, x] * (s[4 * c + g_] - cen[4 * c + g_])
                           + op.hband[o, x] * (s[4 * c + h_] - cen[4 * c + h_]))
                out[c, x] = acc
    return out


@pytest.mark.parametrize("p,r", [(1, 2), (3, 1), (4, 1)])
def test_kernel_grouping_matches_twin(p, r):
    op = make_cuda_elasticity(FESpace(HyperCubeMesh(3, r), p), torch.float64,
                              MU, LAM)
    rng = np.random.default_rng(p)
    u = torch.as_tensor(rng.standard_normal(op.trimmed_shape))
    (want,) = op.twin("apply", u)
    assert _rel(want, kernel_emulation(op, u)) < 1e-12


@pytest.mark.parametrize("p,r,lx", [(1, 2, 3), (2, 1, 3), (3, 1, 4),
                                    (2, 2, 5)])
def test_kernel_schedule_with_partial_chunk(p, r, lx):
    """N not a multiple of the chunk: the last chunk is short, and chunks
    start inside the grid, so their lead-in planes are real planes."""
    op = make_cuda_elasticity(FESpace(HyperCubeMesh(3, r), p), torch.float64,
                              MU, LAM)
    assert (op.n * p) % lx
    rng = np.random.default_rng(10 + p)
    u = torch.as_tensor(rng.standard_normal(op.trimmed_shape))
    (want,) = op.twin("apply", u)
    assert _rel(want, kernel_emulation(op, u, lx)) < 1e-12


@pytest.mark.parametrize("p,r", [(1, 3), (3, 2), (7, 2)])
def test_row_sums_are_those_of_the_folded_matrices(p, r):
    op = make_cuda_elasticity(FESpace(HyperCubeMesh(3, r), p), torch.float64,
                              MU, LAM)
    N = op.n * p
    for band, rows in ((op.kband, op.ksum), (op.gband, op.gsum),
                       (op.hband, op.hsum)):
        W = torch.zeros(N, N, dtype=torch.float64)
        for o in range(-p, p + 1):
            i = torch.arange(max(0, -o), min(N, N - o))
            W[i, i + o] = band[p + o, i]
        scale = float(band.abs().max())
        assert float((W.sum(1) - rows).abs().max()) <= 1e-13 * scale
        assert float(rows[p + 1:N - p].abs().max()) == 0.0
    Ht = torch.zeros(N, N, dtype=torch.float64)
    for o in range(-p, p + 1):
        i = torch.arange(max(0, -o), min(N, N - o))
        Ht[i, i + o] = op.hband[p + o, i]
    assert torch.equal(Ht, op.Gt.T)


@pytest.mark.parametrize("p", range(1, 8))
def test_tile_fits_shared_memory(p):
    """The tile, chunk and ring formula for p = 1..7 in both dtypes: within
    227 KB, and within half an SM in float32 (the kernel's register bound
    assumes two blocks per SM); the block is whole warps, at most 256
    threads (128 at p >= 4); the chunk of the Q3 r=6 levels minimises waves
    of two blocks per SM times the planes a block marches."""
    for itemsize in (4, 8):
        for N in (2 * p, 4 * p, 64 * p):
            lx, ty, tz = elasticity_tile(p, itemsize, N)
            nbytes = elasticity_smem_elems(p, ty) * itemsize
            assert nbytes <= SMEM_LIMIT
            if itemsize == 4:
                assert nbytes <= SMEM_BUDGET
            assert tz == 32 and ty * tz <= 256 and 256 % (ty * tz) == 0
            assert p <= 3 or ty * tz <= 128
            assert lx in (64, 48, 32, 16, 8, 4, 2)
    # one more warp of y rows: a window row of three components in both
    # buffers, a row of the four z products in both, and 2p+1 ring planes
    # of 12 groups for 32 more columns
    assert (elasticity_smem_elems(p, 2) - elasticity_smem_elems(p, 1)
            == 2 * 3 * (32 + 2 * p) + 2 * 4 * 32 + (2 * p + 1) * 12 * 32)
    # Q3 r=6, fine level down: 192^3 in 2 waves of 70 planes (not 3 of 54
    # at LX = 48), 96^3 in one wave of 22, 48^3 in one of 10
    chunks = [elasticity_tile(3, 4, 3 * 2 ** r)[0] for r in range(6, 0, -1)]
    assert chunks == [64, 16, 4, 2, 2, 2]


def test_operator_shapes_and_cpu_counts_nothing():
    op = make_cuda_elasticity(FESpace(HyperCubeMesh(3, 1), 2), torch.float32)
    assert op.shape == (3, 5, 5, 5) and op.trimmed_shape == (3, 4, 4, 4)
    assert op.n_dofs == 375
    before = dict(LAUNCHES)
    out = op.apply(torch.ones(op.shape))
    assert out.shape == op.shape and LAUNCHES == before


def test_wrapper_checks_layout_on_every_device():
    op = make_cuda_elasticity(FESpace(HyperCubeMesh(3, 1), 2), torch.float64)
    full = torch.zeros(op.shape, dtype=torch.float64)
    with pytest.raises(ValueError, match="contiguous"):
        op.run("apply", full[:, :-1, :-1, :-1])
    with pytest.raises(ValueError, match="shape"):
        op.run("apply", full[0, :-1, :-1, :-1].contiguous())
    with pytest.raises(ValueError, match="dtype"):
        op.run("apply", full[:, :-1, :-1, :-1].contiguous().float())
    with pytest.raises(ValueError, match="'residual'"):
        op.run("residual", full[:, :-1, :-1, :-1].contiguous())


def test_variant_errors():
    sp = FESpace(HyperCubeMesh(2, 1), 2)
    # 2D "auto" falls back to kron on every level, as the JAX package's
    # make_elasticity_auto does (no B.5 there, so nothing is fused)
    prob = ElasticityMultigrid(2, 2, 1, variant="auto", device="cpu")
    assert all(lvl.op.variant == "kron" for lvl in prob.levels)
    assert not any(getattr(lvl.smoother, "trimmed_io", False)
                   for lvl in prob.levels)
    with pytest.raises(ValueError, match="not ported: .*TPU-only"):
        make_elasticity(sp, variant="bkron")
    with pytest.raises(ValueError, match="not ported: .*TPU-only"):
        ElasticityMultigrid(3, 2, 1, variant="bkron", device="cpu")
    with pytest.raises(ValueError, match="3D"):
        make_cuda_elasticity(sp)


def test_elasticity_path_never_imports_jax():
    code = (
        "import sys\n"
        "import portable_multigrid_tpu_torch\n"
        "import portable_multigrid_tpu_torch.models.elasticity\n"
        "import portable_multigrid_tpu_torch.ops.cuda_elasticity\n"
        "import portable_multigrid_tpu_torch.convert\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m.startswith('portable_multigrid_tpu.')\n"
        "       or m == 'portable_multigrid_tpu']\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
