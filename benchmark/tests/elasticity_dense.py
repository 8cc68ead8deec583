"""Plain reference of a tiny vector-valued configuration, for the tests:
Q_p linear elasticity -div sigma(u) = f, sigma(u) = mu (grad u + grad u^T)
+ lam (div u) I, on 2^r equal cells per axis of the unit cube, Dirichlet on
the whole boundary, the constrained rows kept as identity rows.

Assembled densely from the 1D matrices of ``pmgbench.fe1d``: K, M and the
gradient matrix C[i, j] = int l_i l_j'.  Block (c, a) of the operator, test
component c against trial component a, is

    a == c:  sum_k alpha_k (x)_d (K if d == k else M),
             alpha_k = 2 mu + lam for k == c, mu otherwise;
    a != c:  mu (x)_d (C if d == c, C^T if d == a, else M)
             + lam (x)_d (C if d == a, C^T if d == c, else M),

from mu int d_c u_a d_a v_c and lam int d_a u_a d_c v_c.  ``solve`` is
``torch.linalg.solve`` on the free DoFs, the constrained ones keeping b.
It imports nothing of the program under test, and holds the whole matrix,
so it serves a few thousand DoFs at most.
"""

from __future__ import annotations

import numpy as np
import torch

from pmgbench import fe1d


def _kron(mats):
    out = np.ones((1, 1))
    for m in mats:
        out = np.kron(out, m)
    return out


class DenseElasticity:
    def __init__(self, config: dict, device, dtype=torch.float64):
        p, r, dim = config["degree"], config["refinements"], config["dim"]
        mu, lam = float(config["mu"]), float(config["lam"])
        K, M = fe1d.assembled_matrices(p, r)
        C = fe1d.assembled_gradient(p, r)
        blocks = [[None] * dim for _ in range(dim)]
        for c in range(dim):
            for a in range(dim):
                if a == c:
                    blocks[c][a] = sum(
                        (2 * mu + lam if k == c else mu)
                        * _kron([K if d == k else M for d in range(dim)])
                        for k in range(dim))
                else:
                    blocks[c][a] = (
                        mu * _kron([C if d == c else C.T if d == a else M
                                    for d in range(dim)])
                        + lam * _kron([C if d == a else C.T if d == c else M
                                       for d in range(dim)]))
        A = np.block(blocks)
        m = _kron([fe1d.free_mask(p, r)[None] for _ in range(dim)])[0]
        m = np.tile(m, dim)
        A = A * m[:, None] * m[None, :] + np.diag(1.0 - m)
        self.shape = (dim,) + (fe1d.n_points(p, r),) * dim
        self.dtype = dtype
        self.A = torch.as_tensor(A, dtype=dtype, device=device)
        self._A64 = torch.as_tensor(A, dtype=torch.float64, device=device)
        self.free = torch.as_tensor(np.flatnonzero(m), device=device)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """A_eff x in ``dtype``; the result has x's shape and dtype."""
        y = self.A @ x.reshape(-1).to(self.dtype)
        return y.reshape(x.shape).to(x.dtype)

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        """A_eff^{-1} b in float64."""
        g = b.reshape(-1).to(torch.float64)
        f = self.free
        x = g.clone()
        x[f] = torch.linalg.solve(self._A64[f][:, f], g[f])
        return x.reshape(b.shape)


def make(config: dict, device, dtype=torch.float64) -> DenseElasticity:
    return DenseElasticity(config, device, dtype)
