"""Plain reference of the Poisson configurations: the Q_p Laplace operator.

The operator of the reference program (deal.II portable-multigrid,
``source/geometric_multigrid/program.cc`` and
``source/polynomial_multigrid/program.cc``): continuous Q_p elements on
2^r equal cells per axis of the unit cube or square, Dirichlet on the whole
boundary, with the constrained rows kept as identity rows,

    A_eff x = m * (A (m * x)) + (1 - m) * x,
    A = sum_k  M (x) ... K (axis k) ... (x) M,

with K and M the dense assembled 1D stiffness and mass matrices
(``pmgbench.fe1d``) and m the free-point mask.  Built from the
configuration's dim, degree and refinements alone, in plain torch matrix
products; it imports nothing of the program under test.  ``dtype`` is the
precision every product runs in: float64 for the check, a lower one for the
control (float32 with TF32 off, or bfloat16).

:meth:`LaplaceReference.solve` gives A_eff^{-1} b exactly, by the fast
diagonalisation method (Lynch, Rice and Thomas, 1964): on the free points
A is the Kronecker sum of the 1D pencil (K_f, M_f), whose generalised
eigenvectors V (V^T M_f V = I, V^T K_f V = diag(lam)) diagonalise it,

    A_f^{-1} = (V (x) V (x) V) diag(1 / (lam_i + lam_j + lam_k)) (V (x) V (x) V)^T,

and the constrained points keep b.

:class:`BlockedLaplaceReference` (``make_blocked``) is the same arithmetic
for grids too large for the whole-grid one's temporaries, as a
multi-card cell's check needs: ``solve_`` works in place on one grid, a
few planes at a time (V^T along the in-plane axes on blocks of axis-0
planes, then V^T along axis 0, the division and V along axis 0 on blocks
of axis-1 columns, then V along the in-plane axes), and ``apply_rows``
gives a block of rows of A_eff x from the planes of x within the band
of K and M around them, which a callable hands it; no N^dim mask is
built.  Its results equal the whole-grid ones to rounding (the sums run
in another order).
"""

from __future__ import annotations

import torch

from pmgbench import fe1d

BLOCK_BYTES = 1 << 28  # a block's float64 bytes, BlockedLaplaceReference


def pencil(K: torch.Tensor, M: torch.Tensor):
    """(V, lam) of the free points' 1D pencil (K_f, M_f), in float64."""
    K, M = (W[1:-1, 1:-1].to(torch.float64) for W in (K, M))
    L = torch.linalg.cholesky(M)
    C = torch.linalg.solve_triangular(
        L, torch.linalg.solve_triangular(L, K, upper=False).T, upper=False)
    lam, Q = torch.linalg.eigh(0.5 * (C + C.T))
    return torch.linalg.solve_triangular(L.T, Q, upper=True), lam


def along(W: torch.Tensor, x: torch.Tensor, axis: int) -> torch.Tensor:
    """W applied along ``axis`` of the grid x."""
    return torch.movedim(torch.tensordot(W, x, dims=([1], [axis])), 0, axis)


class LaplaceReference:
    def __init__(self, config: dict, device, dtype=torch.float64):
        p, r, self.dim = config["degree"], config["refinements"], config["dim"]
        K, M = fe1d.assembled_matrices(p, r)
        m = fe1d.free_mask(p, r)
        self.dtype = dtype
        self.K, self.M = (torch.as_tensor(a, dtype=dtype, device=device)
                          for a in (K, M))
        mask = torch.as_tensor(m, dtype=dtype, device=device)
        self.mask = mask
        for _ in range(self.dim - 1):
            self.mask = self.mask[..., None] * mask
        self.shape = (len(m),) * self.dim

    def _pencil(self):
        """(V, lam) of the free points' 1D pencil, in float64."""
        if not hasattr(self, "_V"):
            self._V, self._lam = pencil(self.K, self.M)
        return self._V, self._lam

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        """A_eff^{-1} b in float64, for a grid (or flat) vector b."""
        V, lam = self._pencil()
        g = b.reshape(self.shape).to(torch.float64)
        inner = (slice(1, -1),) * self.dim
        y = g[inner]
        for ax in range(self.dim):
            y = along(V.T, y, ax)
        den = lam
        for _ in range(self.dim - 1):
            den = den[..., None] + lam
        y = y / den
        for ax in range(self.dim):
            y = along(V, y, ax)
        x = g.clone()
        x[inner] = y
        return x.reshape(b.shape)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """A_eff x in ``dtype`` for a grid (or flat) vector x of any dtype;
        the result has x's shape and dtype."""
        u = x.reshape(self.shape).to(self.dtype) * self.mask
        if self.dim == 2:
            Au = (along(self.K, along(self.M, u, 1), 0)
                  + along(self.M, along(self.K, u, 1), 0))
        else:
            mz, kz = along(self.M, u, 2), along(self.K, u, 2)
            mymz = along(self.M, mz, 1)
            Au = (along(self.K, mymz, 0)
                  + along(self.M, along(self.K, mz, 1)
                          + along(self.M, kz, 1), 0))
        out = self.mask * Au + (1 - self.mask) * x.reshape(self.shape).to(
            self.dtype)
        return out.reshape(x.shape).to(x.dtype)


class BlockedLaplaceReference:
    """A_eff and A_eff^{-1} of :class:`LaplaceReference`, a block of planes
    at a time (module docstring); ``block_bytes`` bounds a block's float64
    bytes."""

    def __init__(self, config: dict, device, dtype=torch.float64,
                 block_bytes: int = BLOCK_BYTES):
        p, r, self.dim = config["degree"], config["refinements"], config["dim"]
        K, M = fe1d.assembled_matrices(p, r)
        m = fe1d.free_mask(p, r)
        self.dtype, self.device = dtype, torch.device(device)
        self.K, self.M, self.mask = (
            torch.as_tensor(a, dtype=dtype, device=device) for a in (K, M, m))
        self.n = len(m)
        self.plane = self.n ** (self.dim - 1)  # entries of an axis-0 plane
        self.rows = max(1, block_bytes // (8 * self.plane))
        # the columns of K and M that each row reaches: [first, last]
        nz = (K != 0) | (M != 0)
        self.first = nz.argmax(1)
        self.last = self.n - 1 - nz[:, ::-1].argmax(1)

    _pencil = LaplaceReference._pencil

    def blocks(self, rows: int | None = None):
        """[i0, i1) of consecutive blocks of axis-0 planes."""
        rows = rows or self.rows
        return [(i, min(i + rows, self.n)) for i in range(0, self.n, rows)]

    def _mask(self, i0: int, i1: int) -> torch.Tensor:
        """The free-point mask of planes [i0, i1)."""
        out = self.mask[i0:i1]
        for _ in range(self.dim - 1):
            out = out[..., None] * self.mask
        return out

    def solve_(self, g: torch.Tensor) -> torch.Tensor:
        """g <- A_eff^{-1} g in place, in float64, for a float64 grid g."""
        V, lam = self._pencil()
        y = g[(slice(1, -1),) * self.dim]
        f = self.n - 2
        cols = max(1, self.rows * self.n // f)
        # V^T along the in-plane axes, a block of axis-0 planes at a time
        for i0, i1 in self.blocks():
            t = y[i0:i1]
            for ax in range(1, self.dim):
                t = along(V.T, t, ax)
            y[i0:i1] = t
        # V^T along axis 0, the division and V along axis 0, a block of
        # axis-1 columns at a time
        for j0 in range(0, f, cols):
            j1 = min(j0 + cols, f)
            den = lam[:, None] + lam[j0:j1]
            for _ in range(self.dim - 2):
                den = den[..., None] + lam
            y[:, j0:j1] = along(V, along(V.T, y[:, j0:j1], 0) / den, 0)
        # V along the in-plane axes
        for i0, i1 in self.blocks():
            t = y[i0:i1]
            for ax in range(1, self.dim):
                t = along(V, t, ax)
            y[i0:i1] = t
        return g

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        """A_eff^{-1} b in float64 on a copy of the grid b."""
        return self.solve_(b.to(torch.float64, copy=True))

    def apply_rows(self, planes, i0: int, i1: int) -> torch.Tensor:
        """Planes [i0, i1) of A_eff x in ``dtype``; ``planes(j0, j1)`` gives
        x's planes [j0, j1) on the reference's device."""
        j0, j1 = int(self.first[i0:i1].min()), int(self.last[i0:i1].max()) + 1
        u = planes(j0, j1).to(self.dtype)
        w = u * self._mask(j0, j1)
        K, M = self.K[i0:i1, j0:j1], self.M[i0:i1, j0:j1]
        if self.dim == 2:
            Au = (along(K, along(self.M, w, 1), 0)
                  + along(M, along(self.K, w, 1), 0))
        else:
            mz, kz = along(self.M, w, 2), along(self.K, w, 2)
            Au = (along(K, along(self.M, mz, 1), 0)
                  + along(M, along(self.K, mz, 1) + along(self.M, kz, 1), 0))
        m = self._mask(i0, i1)
        return m * Au + (1 - m) * u[i0 - j0:i1 - j0]

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """A_eff x of a whole grid x, in ``dtype``, a block at a time; the
        result has x's dtype."""
        return torch.cat([self.apply_rows(lambda a, b: x[a:b], i0, i1)
                          for i0, i1 in self.blocks()]).to(x.dtype)


def make(config: dict, device, dtype=torch.float64) -> LaplaceReference:
    return LaplaceReference(config, device, dtype)


def make_blocked(config: dict, device, dtype=torch.float64,
                 block_bytes: int = BLOCK_BYTES) -> BlockedLaplaceReference:
    return BlockedLaplaceReference(config, device, dtype, block_bytes)
