"""The sharded kernel path's plain twins against the JAX package's slab
kernels on the CPU: B.1's slab instance (``CudaLaplaceSlab``: ``apply`` on
x-full input, ``residual3f``, ``residual1f``, ``chebf``; the exact and the
``mxu`` core) and B.2's ``xext`` pair, against JAX's
``_build_stacked_pallas`` / ``ShardedPallasLaplace`` and
``_build_stacked_cheb2`` run in interpret mode, as
``tests/test_sharding.py`` runs them, on the same inputs (numpy seeds),
on the first, an interior and the last shard.  Tolerances: the exact
grade within 2e-5 max|want| (the JAX package's own bound for the sharded
kernel apply), duplicated planes within 1e-6 max; the bf16 grade within
8e-3 max|out| (two bf16 roundings at the largest value, as
``tests/test_torch_bf16_*.py`` hold it: the TPU core rounds per block,
the port's the global bands)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from portable_multigrid_tpu.fem.mesh import HyperCubeMesh as JMesh
from portable_multigrid_tpu.fem.space import FESpace as JSpace
from portable_multigrid_tpu.parallel import poisson as jpoisson
from portable_multigrid_tpu.parallel import sharding as jsharding
from portable_multigrid_tpu_torch.fem.mesh import HyperCubeMesh
from portable_multigrid_tpu_torch.fem.space import FESpace
from portable_multigrid_tpu_torch.ops.cuda_cheb2 import make_cheb2_xext
from portable_multigrid_tpu_torch.ops.cuda_laplace import (
    make_cuda_laplace,
    row_sums,
)
from portable_multigrid_tpu_torch.parallel import sharding
from portable_multigrid_tpu_torch.parallel.poisson import (
    _build_stacked_cheb2,
    _build_stacked_slab,
    _partial_assembled_1d,
    slab_eligible,
)

torch.set_num_threads(1)

CPU = torch.device("cpu")
EXACT, BF16 = 2e-5, 8e-3
SCAL = np.asarray([0.59, 1.26, 0.71, 1.52, 1.3], np.float32)


@pytest.fixture(scope="module", autouse=True)
def _pmg_defaults():
    """Every PMG_* setting of both packages at its default (the JAX slab's
    lane padding reads PMG_ZPAD_UP)."""
    with pytest.MonkeyPatch.context() as mp:
        for key in [k for k in os.environ if k.startswith("PMG_")]:
            mp.delenv(key)
        yield


def _unstack(tree, s):
    return jax.tree_util.tree_map(lambda a: a[s], tree)


def _masked_trimmed(rng, shape, x0, N):
    """Random trimmed state, zero on the constrained planes (global plane
    0 of each axis; the slab's planes from global x0)."""
    v = rng.standard_normal(shape).astype(np.float32)
    gx = x0 + np.arange(shape[0])
    v[(gx == 0) | (gx >= N)] = 0.0
    v[:, 0], v[:, :, 0] = 0.0, 0.0
    return v


def _close(got, want, tol):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("p,r,S", [(4, 3, 4), (1, 4, 2), (2, 3, 2),
                                   (3, 4, 2)])
def test_sharded_kernel_apply_matches_jax(p, r, S):
    """ShardedCudaLaplace.apply (B.1's slab, the thin completion,
    halo_sum, the mask combine) against JAX's ShardedPallasLaplace under
    shard_map, float32, at Q4 r=3 S=4 and at the smallest r where the JAX
    slab takes p = 1, 2, 3 (its 8-row alignment)."""
    jsp = JSpace(JMesh(3, r), p)
    n = jsp.mesh.cells_per_axis
    u = np.random.default_rng(p).standard_normal(jsp.grid_shape).astype(
        np.float32)
    sop = jpoisson._build_stacked_pallas(jsp, S, jnp.float32,
                                         interpret=True)
    assert sop is not None
    mesh = Mesh(np.array(jax.devices()[:S]), (jpoisson.AXIS,))
    want = np.asarray(jax.jit(jax.shard_map(
        lambda o, v: jpoisson._unstack(o).apply(v[0])[None], mesh=mesh,
        in_specs=(P(jpoisson.AXIS), P(jpoisson.AXIS)),
        out_specs=P(jpoisson.AXIS), check_vma=False))(
            sop, jnp.asarray(jsharding.partition_axis0(u, n, p, S))))
    op = _build_stacked_slab(FESpace(HyperCubeMesh(3, r), p), [CPU] * S,
                             torch.float32)
    got = op.apply(sharding.shard(u, n, p, [CPU] * S, torch.float32))
    scale = np.abs(want).max()
    for s in range(S):
        np.testing.assert_allclose(got.parts[s].numpy(), want[s], rtol=0,
                                   atol=EXACT * scale)
    for s in range(S - 1):
        np.testing.assert_allclose(got.parts[s][-1], got.parts[s + 1][0],
                                   rtol=0, atol=1e-6 * scale)


def test_slab_row_sums_and_eligibility():
    """The slab's x row sums (from the mask, as row_sums takes K's) equal
    the direct row sums of the masked partial matrix at the first and the
    last shard; the port's rule takes any 3D float32 level whose cells
    split evenly."""
    sp = FESpace(HyperCubeMesh(3, 3), 3)
    S, n_loc = 4, 2
    Kp, _ = _partial_assembled_1d(sp, n_loc)
    m1 = sp.free_mask_1d()
    for s in (0, S - 1):
        mx = sharding.partition_axis0(m1, 8, 3, S)[s]
        direct = (mx[:, None] * Kp * mx[None, :]).sum(axis=1)[:-1]
        np.testing.assert_allclose(row_sums(Kp, mx), direct, rtol=0,
                                   atol=1e-12 * np.abs(Kp).max())
        op = _build_stacked_slab(sp, [CPU] * S, torch.float64)
    assert op is None
    assert slab_eligible(sp, 4, torch.float32)
    assert not slab_eligible(sp, 3, torch.float32)
    assert not slab_eligible(FESpace(HyperCubeMesh(2, 3), 3), 4,
                             torch.float32)
    assert _build_stacked_cheb2(FESpace(HyperCubeMesh(3, 2), 3), [CPU] * 4,
                                torch.float32) is None  # one-cell slabs


MODES = {"apply": ((), None), "residual1f": (("rhs",), None),
         "residual3f": (("rhs",), (1.3, 1.3)),
         "chebf": (("r", "x"), (0.59, 1.26))}


@pytest.mark.parametrize("core", ["banded", "mxu"])
@pytest.mark.parametrize("mode", list(MODES))
def test_slab_modes_match_jax(mode, core):
    """Each slab mode's twin against JAX's ``_run`` in interpret mode on a
    shard's x-full input, Q4 r=3 S=4, shards 0, 1 and 3."""
    p, r, S = 4, 3, 4
    jsp = JSpace(JMesh(3, r), p)
    jop = jpoisson._build_stacked_pallas(jsp, S, jnp.float32, core=core,
                                         interpret=True)
    op = _build_stacked_slab(FESpace(HyperCubeMesh(3, r), p), [CPU] * S,
                             torch.float32, core)
    N = 2 ** r * p
    L = N // S
    names, scal = MODES[mode]
    tol = EXACT if core == "banded" else BF16
    for s in (0, 1, S - 1):
        rng = np.random.default_rng(10 * s + len(mode))
        u = _masked_trimmed(rng, (L + 1, N, N), s * L, N)
        ins = [_masked_trimmed(rng, (L, N, N), s * L, N) for _ in names]
        loc = _unstack(jop, s).local
        want = loc._run(mode, jnp.asarray(u),
                        tuple(jnp.asarray(v) for v in ins),
                        None if scal is None else jnp.asarray(scal,
                                                              jnp.float32))
        want = want if isinstance(want, (tuple, list)) else (want,)
        got = op.local[s].run(mode, torch.from_numpy(u),
                              tuple(torch.from_numpy(v) for v in ins),
                              () if scal is None else
                              scal if mode == "chebf" else scal[:1])
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g.numpy(), np.asarray(w), tol)


PAIR_MODES = ("cheb2", "cheb2l", "chebd2", "cheb2f0", "cheb2f0l")


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("mode", PAIR_MODES)
def test_xext_pair_matches_jax(mode, exact):
    """B.2's xext twin on a shard's extended inputs (d and b with 2p
    planes of halo a side, r with p) against JAX's xext Cheb2Kernel in
    interpret mode at float32 state, Q4 r=3 S=4, shards 0, 1 and 3; the
    exact grade (JAX's ``exact=True``) and the production grade."""
    p, r, S = 4, 3, 4
    jk = jpoisson._build_stacked_cheb2(JSpace(JMesh(3, r), p), S,
                                       jnp.float32, interpret=True, bx=2,
                                       by=4, exact=exact)
    op = make_cuda_laplace(FESpace(HyperCubeMesh(3, r), p), torch.float32,
                           core="banded" if exact else "mxu")
    N = 2 ** r * p
    L = N // S
    rng = np.random.default_rng(len(mode) + exact)
    d, rr, x = (_masked_trimmed(rng, (N, N, N), 0, N) for _ in range(3))

    def ext(t, lo, hi):
        out = np.zeros((hi - lo, N, N), np.float32)
        a, b = max(lo, 0), min(hi, N)
        out[a - lo: b - lo] = t[a:b]
        return out

    f0 = mode.startswith("cheb2f0")
    scal = SCAL if f0 else SCAL[:4]
    for s in (0, 1, S - 1):
        lo, hi = s * L, (s + 1) * L
        de, re, xs = ext(d, lo - 2 * p, hi + 2 * p), ext(rr, lo - p, hi + p), \
            x[lo:hi]
        args = (de, None if f0 else re,
                xs if mode in ("cheb2", "cheb2l") else None)
        want = _unstack(jk, s).steps2(
            *(None if a is None else jnp.asarray(a) for a in args),
            jnp.asarray(scal), mode, sdtype="f32")
        got = make_cheb2_xext(op, lo, L).steps2(
            *(None if a is None else torch.from_numpy(a) for a in args),
            tuple(map(float, scal)), mode)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g.numpy(), np.asarray(w), EXACT if exact else BF16)


def test_xext_twin_is_the_single_device_twin():
    """On every shard the xext twin gives the single-device pair's twin at
    the shard's planes, bit for bit, at both grades (p = 1 and 3, S = 4
    and 2, every mode)."""
    from portable_multigrid_tpu_torch.ops.cuda_cheb2 import MODES as PMODES
    from portable_multigrid_tpu_torch.ops.cuda_cheb2 import make_cheb2
    for p, r, S in ((1, 3, 4), (3, 2, 2)):
        sp = FESpace(HyperCubeMesh(3, r), p)
        N = 2 ** r * p
        L = N // S
        rng = np.random.default_rng(p)
        d, rr, x = (torch.from_numpy(_masked_trimmed(rng, (N, N, N), 0, N))
                    for _ in range(3))
        for core in ("banded", "mxu"):
            op = make_cuda_laplace(sp, torch.float32, core=core)
            for mode in PMODES:
                f0 = mode.startswith("cheb2f0")
                scal = tuple(map(float, SCAL if f0 else SCAL[:4]))
                has_x = mode in ("cheb2", "cheb2l")
                want = make_cheb2(op).steps2(d, None if f0 else rr,
                                             x if has_x else None, scal,
                                             mode)
                for s in range(S):
                    lo, hi = s * L, (s + 1) * L
                    pad = torch.nn.functional.pad

                    def ext(t, h):
                        return pad(t, (0, 0, 0, 0, h, h))[lo: hi + 2 * h]

                    got = make_cheb2_xext(op, lo, L).steps2(
                        ext(d, 2 * p), None if f0 else ext(rr, p),
                        x[lo:hi] if has_x else None, scal, mode)
                    for g, w in zip(got, want):
                        assert torch.equal(g, w[lo:hi]), (p, core, mode, s)


def test_xext_checks_its_inputs():
    op = make_cuda_laplace(FESpace(HyperCubeMesh(3, 2), 2), torch.float32)
    k = make_cheb2_xext(op, 2, 2)
    d = torch.zeros(2 + 8, 8, 8)
    with pytest.raises(ValueError, match="shape"):
        k.steps2(torch.zeros(2, 8, 8), torch.zeros(6, 8, 8),
                 torch.zeros(2, 8, 8), tuple(map(float, SCAL[:4])))
    assert len(k.steps2(d, torch.zeros(6, 8, 8), torch.zeros(2, 8, 8),
                        tuple(map(float, SCAL[:4])))) == 3
    with pytest.raises(ValueError, match="leaves the grid"):
        make_cheb2_xext(op, 6, 4)
