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
"""

from __future__ import annotations

import torch

from pmgbench import fe1d


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
            K, M = (W[1:-1, 1:-1].to(torch.float64) for W in (self.K, self.M))
            L = torch.linalg.cholesky(M)
            C = torch.linalg.solve_triangular(
                L, torch.linalg.solve_triangular(L, K, upper=False).T,
                upper=False)
            lam, Q = torch.linalg.eigh(0.5 * (C + C.T))
            self._V = torch.linalg.solve_triangular(L.T, Q, upper=True)
            self._lam = lam
        return self._V, self._lam

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        """A_eff^{-1} b in float64, for a grid (or flat) vector b."""
        V, lam = self._pencil()
        g = b.reshape(self.shape).to(torch.float64)
        inner = (slice(1, -1),) * self.dim
        y = g[inner]
        for ax in range(self.dim):
            y = self._axis(V.T, y, ax)
        den = lam
        for _ in range(self.dim - 1):
            den = den[..., None] + lam
        y = y / den
        for ax in range(self.dim):
            y = self._axis(V, y, ax)
        x = g.clone()
        x[inner] = y
        return x.reshape(b.shape)

    def _axis(self, W: torch.Tensor, x: torch.Tensor, axis: int):
        """W applied along ``axis`` of the grid x."""
        return torch.movedim(torch.tensordot(W, x, dims=([1], [axis])),
                             0, axis)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """A_eff x in ``dtype`` for a grid (or flat) vector x of any dtype;
        the result has x's shape and dtype."""
        u = x.reshape(self.shape).to(self.dtype) * self.mask
        if self.dim == 2:
            Au = (self._axis(self.K, self._axis(self.M, u, 1), 0)
                  + self._axis(self.M, self._axis(self.K, u, 1), 0))
        else:
            mz, kz = self._axis(self.M, u, 2), self._axis(self.K, u, 2)
            mymz = self._axis(self.M, mz, 1)
            Au = (self._axis(self.K, mymz, 0)
                  + self._axis(self.M, self._axis(self.K, mz, 1)
                               + self._axis(self.M, kz, 1), 0))
        out = self.mask * Au + (1 - self.mask) * x.reshape(self.shape).to(
            self.dtype)
        return out.reshape(x.shape).to(x.dtype)


def make(config: dict, device, dtype=torch.float64) -> LaplaceReference:
    return LaplaceReference(config, device, dtype)
