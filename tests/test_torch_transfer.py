"""Port parity: grid transfers against the JAX package.

* ``Transfer`` / ``TrimmedTransfer`` against JAX ``make_h_transfer`` to
  1e-13 in float64;
* the B.3 twin against ``PallasTransfer`` in interpret mode (``bf=4``,
  Q4 r3 <-> r2) to 2e-5 in float32, the JAX package's own bound
  (tests/test_pallas_transfer.py), for both coarse representations;
* restriction is the exact transpose: <P c, f> = <c, R f>;
* the x-marching restriction and prolongation of csrc/transfer.cu,
  emulated in plain torch from the padded rows and the launch geometry,
  against ``transfer_twin`` on scalar and [3, ...] fields, with and without
  the addend.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from portable_multigrid_tpu.fem.mesh import HyperCubeMesh as JMesh
from portable_multigrid_tpu.fem.space import FESpace as JSpace
from portable_multigrid_tpu.ops.pallas_transfer import make_pallas_h_transfer
from portable_multigrid_tpu.ops.transfer import (
    TrimmedTransfer as JTrimmedTransfer,
    make_h_transfer as jmake_h_transfer,
)
from portable_multigrid_tpu_torch.fem.mesh import HyperCubeMesh
from portable_multigrid_tpu_torch.fem.space import FESpace
from portable_multigrid_tpu_torch.ops.cuda_transfer import (
    PROLONG_COLUMN,
    PROLONG_STAGES,
    RESTRICT_TILE,
    make_cuda_h_transfer,
    prolong_chunk,
    transfer_twin,
)
from portable_multigrid_tpu_torch.ops.transfer import (
    TrimmedTransfer,
    make_h_transfer,
)

torch.set_num_threads(1)


def _pair(p, r, jax_side=False):
    if jax_side:
        return JSpace(JMesh(3, r - 1), p), JSpace(JMesh(3, r), p)
    return FESpace(HyperCubeMesh(3, r - 1), p), FESpace(HyperCubeMesh(3, r), p)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(a).max()


def _trim(a):
    return a[tuple(slice(0, s - 1) for s in a.shape)]


@pytest.mark.parametrize("p,r", [(1, 2), (2, 2), (3, 1), (4, 2)])
def test_transfer_matches_jax(p, r):
    jt = jmake_h_transfer(*_pair(p, r, True), jnp.float64)
    tt = make_h_transfer(*_pair(p, r), torch.float64)
    coarse, fine = _pair(p, r)
    rng = np.random.default_rng(p)
    f = rng.standard_normal(fine.grid_shape)
    c = rng.standard_normal(coarse.grid_shape)
    u = rng.standard_normal(fine.grid_shape)
    assert _rel(jt.restrict(jnp.asarray(f)), tt.restrict(torch.as_tensor(f))) < 1e-13
    assert _rel(jt.prolongate(jnp.asarray(c)),
                tt.prolongate(torch.as_tensor(c))) < 1e-13
    assert _rel(jt.prolongate_and_add(jnp.asarray(u), jnp.asarray(c)),
                tt.prolongate_and_add(torch.as_tensor(u),
                                      torch.as_tensor(c))) < 1e-13


@pytest.mark.parametrize("coarse_trimmed", [True, False])
def test_trimmed_transfer_matches_jax(coarse_trimmed):
    p, r = 3, 2
    coarse, fine = _pair(p, r)
    jt = JTrimmedTransfer(fine_trimmed=True, coarse_trimmed=coarse_trimmed,
                          base=jmake_h_transfer(*_pair(p, r, True), jnp.float64))
    tt = TrimmedTransfer(fine_trimmed=True, coarse_trimmed=coarse_trimmed,
                         base=make_h_transfer(coarse, fine, torch.float64))
    rng = np.random.default_rng(5)
    f = _trim(rng.standard_normal(fine.grid_shape) * fine.free_mask())
    c = rng.standard_normal(coarse.grid_shape) * coarse.free_mask()
    c = _trim(c) if coarse_trimmed else c
    assert _rel(jt.restrict(jnp.asarray(f)), tt.restrict(torch.as_tensor(f))) < 1e-13
    assert _rel(jt.prolongate(jnp.asarray(c)),
                tt.prolongate(torch.as_tensor(c))) < 1e-13


@pytest.mark.parametrize("coarse_trimmed", [True, False])
def test_kernel_twin_matches_pallas_transfer(coarse_trimmed):
    p, r = 4, 3
    jt = make_pallas_h_transfer(*_pair(p, r, True), jnp.float32, bf=4,
                                coarse_trimmed=coarse_trimmed, interpret=True)
    tt = make_cuda_h_transfer(*_pair(p, r), torch.float32,
                              coarse_trimmed=coarse_trimmed)
    coarse, fine = _pair(p, r)
    rng = np.random.default_rng(1)
    f = _trim(rng.standard_normal(fine.grid_shape)).astype(np.float32)
    u = _trim(rng.standard_normal(fine.grid_shape)).astype(np.float32)
    c = rng.standard_normal(coarse.grid_shape).astype(np.float32)
    c = _trim(c) if coarse_trimmed else c
    pairs = [
        (jt.restrict(jnp.asarray(f)), tt.restrict(torch.as_tensor(f))),
        (jt.prolongate(jnp.asarray(c)), tt.prolongate(torch.as_tensor(c))),
        (jt.prolongate_and_add(jnp.asarray(u), jnp.asarray(c)),
         tt.prolongate_and_add(torch.as_tensor(u), torch.as_tensor(c))),
    ]
    for want, got in pairs:
        assert tuple(got.shape) == want.shape
        assert _rel(want, got.numpy()) <= 2e-5


@pytest.mark.parametrize("p", [1, 2, 4, 7])
def test_restriction_is_exact_transpose(p):
    coarse, fine = _pair(p, 2)
    rng = np.random.default_rng(p)
    f = torch.as_tensor(rng.standard_normal(fine.grid_shape))
    c = torch.as_tensor(rng.standard_normal(coarse.grid_shape))
    plain = make_h_transfer(coarse, fine, torch.float64)
    lhs = torch.sum(plain.prolongate(c) * f)
    rhs = torch.sum(c * plain.restrict(f))
    assert abs(float(lhs - rhs)) <= 1e-12 * abs(float(lhs))
    kern = make_cuda_h_transfer(coarse, fine, torch.float64)
    ft, ct = f[:-1, :-1, :-1].contiguous(), c[:-1, :-1, :-1].contiguous()
    lhs = torch.sum(kern.prolongate(ct) * ft)
    rhs = torch.sum(ct * kern.restrict(ft))
    assert abs(float(lhs - rhs)) <= 1e-12 * abs(float(lhs))


def restrict_emulation(W, f):
    """restrict_kernel's schedule in plain torch: per component, coarse x
    chunk and coarse (y, z) column, march over the fine x planes the chunk
    reaches; each plane's (LY, LZ) window (zeros past the grid) contracted
    along z, then y, from the padded rows, and added into the chunk's
    coarse x rows whose windows hold the plane."""
    chunk, ty, tz = RESTRICT_TILE
    starts = [int(s) for s in W.starts]
    vals, w, (LY, LZ) = W.vals, W.w, W.lens
    n_in, n_out = W.n_in, W.n_out
    lead = f.shape[:-3]
    fields = f.reshape((-1,) + f.shape[-3:])
    out = torch.zeros((fields.shape[0],) + (n_out,) * 3, dtype=f.dtype)

    def rows(r0, t, s0):
        """(offsets in the window, [t, w] values) of rows r0..r0+t-1,
        zero rows past n_out."""
        off = torch.zeros(t, dtype=torch.long)
        v = torch.zeros(t, w, dtype=f.dtype)
        for j in range(min(t, n_out - r0)):
            off[j] = starts[r0 + j] - s0
            v[j] = vals[r0 + j]
        return off, v

    taps = torch.arange(w)
    for comp, fine in enumerate(fields):
        for cx0 in range(0, n_out, chunk):
            cn = min(chunk, n_out - cx0)
            f0, f1 = starts[cx0], starts[cx0 + cn - 1] + w
            for y0 in range(0, n_out, ty):
                for z0 in range(0, n_out, tz):
                    sy, sz = starts[y0], starts[z0]
                    oy, vy = rows(y0, ty, sy)
                    oz, vz = rows(z0, tz, sz)
                    acc = torch.zeros(chunk, ty, tz, dtype=f.dtype)
                    for fx in range(f0, f1):
                        win = torch.zeros(LY, LZ, dtype=f.dtype)
                        part = fine[fx, sy:sy + LY, sz:sz + LZ]
                        win[:part.shape[0], :part.shape[1]] = part
                        # z: zb[ly, c] = sum_k vz[c, k] win[ly, oz[c] + k]
                        zb = (win[:, oz[:, None] + taps] * vz).sum(-1)
                        # y: v[r, c] = sum_k vy[r, k] zb[oy[r] + k, c]
                        v = (zb[oy[:, None] + taps] * vy[..., None]).sum(1)
                        for c in range(cn):
                            k = fx - starts[cx0 + c]
                            if 0 <= k < w:
                                acc[c] += vals[cx0 + c, k] * v
                    ny, nz = min(ty, n_out - y0), min(tz, n_out - z0)
                    out[comp, cx0:cx0 + cn, y0:y0 + ny, z0:z0 + nz] = \
                        acc[:cn, :ny, :nz]
    return out.reshape(lead + (n_out,) * 3)


@pytest.mark.parametrize("lead", [(), (3,)], ids=["scalar", "vector"])
@pytest.mark.parametrize("p,r", [(1, 2), (2, 3), (3, 4), (7, 2)])
def test_restrict_schedule_matches_twin(p, r, lead):
    """Chunks and column tiles partial or several (coarse rows: 2 at p = 1,
    r = 2; 8 at p = 2, r = 3; 24 at p = 3, r = 4, two chunks and three y
    tiles; 14 at p = 7, r = 2, the widest rows)."""
    coarse, fine = _pair(p, r)
    tr = make_cuda_h_transfer(coarse, fine, torch.float64)
    W = tr.restrict_
    assert W.restrict and W.n_in == 2 * W.n_out
    f = torch.as_tensor(np.random.default_rng(p).standard_normal(
        lead + (W.n_in,) * 3))
    want = transfer_twin(W.dense, f)
    assert _rel(want, restrict_emulation(W, f)) < 1e-13
    assert _rel(want, tr.restrict(f)) == 0.0


def prolongation_emulation(W, c, add=None, lx=None):
    """prolong_kernel's schedule in plain torch: per component, fine x
    chunk of LX rows (``lx`` overrides the launch's) and fine (y, z)
    column, march over the coarse x planes the chunk reaches, the loads
    PROLONG_STAGES - 1 planes ahead into rotating buffers; each plane's
    (LY, LZ) window (zeros past the grid) contracted along z, then y, from
    the padded rows into a ring of the last w planes; a group of chunk
    rows that share a window (at most 2w) is emitted, with its addend, when
    the plane that ends the window arrives."""
    ty, tz = PROLONG_COLUMN
    starts = [int(s) for s in W.starts]
    vals, w, (LY, LZ) = W.vals, W.w, W.lens
    n_in, n_out = W.n_in, W.n_out
    lead = c.shape[:-3]
    fields = c.reshape((-1,) + c.shape[-3:])
    adds = None if add is None else add.reshape((-1,) + add.shape[-3:])
    LX = lx or prolong_chunk(n_out, w, fields.shape[0], c.element_size())
    out = torch.full((fields.shape[0],) + (n_out,) * 3, float("nan"),
                     dtype=c.dtype)

    def rows(r0, t, s0):
        """(offsets in the window, [t, w] values) of rows r0..r0+t-1, zero
        rows past n_out."""
        off = torch.zeros(t, dtype=torch.long)
        v = torch.zeros(t, w, dtype=c.dtype)
        for j in range(min(t, n_out - r0)):
            off[j] = starts[r0 + j] - s0
            v[j] = vals[r0 + j]
        return off, v

    taps = torch.arange(w)
    for comp, coarse in enumerate(fields):
        for x0 in range(0, n_out, LX):
            cn = min(LX, n_out - x0)
            f0 = starts[x0]
            n_planes = starts[x0 + cn - 1] + w - f0
            for y0 in range(0, n_out, ty):
                for z0 in range(0, n_out, tz):
                    sy, sz = starts[y0], starts[z0]
                    oy, vy = rows(y0, ty, sy)
                    oz, vz = rows(z0, tz, sz)
                    ny, nz = min(ty, n_out - y0), min(tz, n_out - z0)
                    buf = [None] * PROLONG_STAGES

                    def load_plane(j):
                        if j < n_planes:
                            win = torch.zeros(LY, LZ, dtype=c.dtype)
                            part = coarse[f0 + j, sy:sy + LY, sz:sz + LZ]
                            win[:part.shape[0], :part.shape[1]] = part
                            buf[j % PROLONG_STAGES] = (j, win)

                    ring = [torch.zeros(ty, tz, dtype=c.dtype)] * w
                    nxt = 0
                    for j in range(PROLONG_STAGES - 1):
                        load_plane(j)
                    for j in range(n_planes):
                        load_plane(j + PROLONG_STAGES - 1)
                        jj, win = buf[j % PROLONG_STAGES]
                        assert jj == j
                        # z: zb[ly, c] = sum_k vz[c, k] win[ly, oz[c] + k]
                        zb = (win[:, oz[:, None] + taps] * vz).sum(-1)
                        # y: v[r, c] = sum_k vy[r, k] zb[oy[r] + k, c]
                        v = (zb[oy[:, None] + taps] * vy[..., None]).sum(1)
                        ring = ring[1:] + [v]
                        while nxt < cn and starts[x0 + nxt] + w - 1 == f0 + j:
                            # a group: up to 2w rows that share a window
                            group = [r for r in range(nxt, min(nxt + 2 * w, cn))
                                     if starts[x0 + r] == starts[x0 + nxt]]
                            for r in group:
                                acc = sum(vals[x0 + r, k] * ring[k]
                                          for k in range(w))[:ny, :nz]
                                if adds is not None:
                                    acc = acc + adds[comp, x0 + r,
                                                     y0:y0 + ny, z0:z0 + nz]
                                out[comp, x0 + r, y0:y0 + ny, z0:z0 + nz] = acc
                            nxt += len(group)
                    assert nxt == cn
    return out.reshape(lead + (n_out,) * 3)


@pytest.mark.parametrize("with_add", [False, True], ids=["plain", "add"])
@pytest.mark.parametrize("lead", [(), (3,)], ids=["scalar", "vector"])
@pytest.mark.parametrize("p,r,lx", [(1, 2, None), (2, 3, 5), (3, 4, 20),
                                     (7, 2, 9)])
def test_prolongation_schedule_matches_twin(p, r, lx, lead, with_add):
    """Chunks several and partial or one, cutting coarse cells or not,
    column tiles partial or several (fine rows: 4 at p = 1, r = 2, rows of
    one tap, in the launch's chunk; 16 at p = 2, r = 3 in chunks of 5; 48
    at p = 3, r = 4 in chunks of 20 over six y tiles and two z tiles; 28
    at p = 7, r = 2, the widest rows, in chunks of 9)."""
    coarse, fine = _pair(p, r)
    tr = make_cuda_h_transfer(coarse, fine, torch.float64)
    W = tr.prolong
    assert not W.restrict and W.n_out == 2 * W.n_in and W.w <= p + 1
    rng = np.random.default_rng(p)
    c = torch.as_tensor(rng.standard_normal(lead + (W.n_in,) * 3))
    add = (torch.as_tensor(rng.standard_normal(lead + (W.n_out,) * 3))
           if with_add else None)
    want = transfer_twin(W.dense, c, add)
    assert _rel(want, prolongation_emulation(W, c, add, lx)) < 1e-13
    got = tr.prolongate_and_add(add, c) if with_add else tr.prolongate(c)
    assert _rel(want, got) == 0.0
