"""Plain reference of the elasticity configurations: the vector Q_p linear
elasticity operator in Kronecker form.

The operator of the deal.II tutorial step-8 problem, -div sigma(u) = f,
sigma(u) = mu (grad u + grad u^T) + lam (div u) I, with continuous vector
Q_p elements on 2^r equal cells per axis of the unit cube (or square),
Dirichlet on the whole boundary, the constrained rows kept as identity
rows,

    A_eff x = m * (A (m * x)) + (1 - m) * x,

with m the free-point mask on every component.  Block (c, a) of A, test
component c against trial component a, is a sum of Kronecker chains of the
dense assembled 1D stiffness K, mass M and gradient matrix
C[i, j] = int l_i l_j' (``pmgbench.fe1d``):

    a == c:  sum_k alpha_k (x)_d (K if d == k else M),
             alpha_k = 2 mu + lam for k == c, mu otherwise;
    a != c:  mu (x)_d (C if d == c, C^T if d == a, else M)
             + lam (x)_d (C if d == a, C^T if d == c, else M),

21 chains in 3D (``benchmark/tests/elasticity_dense.py`` assembles the
same blocks densely).  :meth:`ElasticityReference.apply` contracts each
chain axis by axis, the last axis first, sharing the partial products of
equal chain tails and summing the chains of one output component that end
in the same first-axis matrix before that contraction.  No matrix of the
whole operator is formed.  Built from the configuration's dim, degree,
refinements, mu and lam alone, in plain torch; it imports nothing of the
program under test.  Every 1D factor is computed in float64; ``dtype`` is
the precision every product of ``apply`` runs in: float64 for the check,
bfloat16 for the control of a float32 cell.  TF32 is turned off for every
matmul, as the harness does.

:meth:`ElasticityReference.solve` is not a direct solve.  On the free DoFs
it runs CG in float64 on A, preconditioned by the exact inverse of A's
block diagonal P: each diagonal block is a Kronecker sum with weights per
axis, inverted by fast diagonalisation of the free points' 1D pencil
(K_f, M_f), V^T M_f V = I, V^T K_f V = diag(e),

    P_c^{-1} = (V (x) V (x) V) diag(1 / sum_k alpha_k e_{i_k})
               (V (x) V (x) V)^T.

CG stops when the preconditioned residual r^T P^{-1} r has fallen to
(1e-13)^2 of b^T P^{-1} b, and raises if it has not within ``MAX_ITER``
iterations.  The relative error in A's energy norm is then at most
sqrt(kappa(P^{-1} A)) * 1e-13; kappa(P^{-1} A) does not grow with the mesh
(CG takes 29, 30 and 31 iterations at Q3, r = 2, 3 and 4, on the CPU, and
30 at r = 6, 3 x 193^3 DoFs, on the H100, 0.37-0.59 s a solve), where a
stop on the plain residual would carry kappa(A), ~1e5 and more at r = 6.
Even times sqrt(kappa(A)), the bound on the 2-norm error that the check
compares lies decades below a float32 cell's error limit.  The constrained
points keep b.
"""

from __future__ import annotations

import torch

from pmgbench import fe1d

TOL = 1e-13  # the preconditioned residual's fall that ends a solve
MAX_ITER = 200


def _axis(W: torch.Tensor, x: torch.Tensor, axis: int) -> torch.Tensor:
    """W applied along ``axis`` of the grid x."""
    return torch.movedim(torch.tensordot(W, x, dims=([1], [axis])), 0, axis)


def chains(dim: int, mu: float, lam: float) -> list:
    """For each output component c, the chains of its row of blocks as
    (coefficient, trial component a, matrix name along each axis)."""
    out = []
    for c in range(dim):
        row = []
        for a in range(dim):
            if a == c:
                row += [(2 * mu + lam if k == c else mu, a,
                         tuple("K" if d == k else "M" for d in range(dim)))
                        for k in range(dim)]
            else:
                row.append((mu, a, tuple("C" if d == c else "Ct" if d == a
                                         else "M" for d in range(dim))))
                row.append((lam, a, tuple("C" if d == a else "Ct" if d == c
                                          else "M" for d in range(dim))))
        out.append(row)
    return out


def apply_chains(u: torch.Tensor, mats: dict, rows: list) -> torch.Tensor:
    """The rows of blocks of :func:`chains` applied to the [dim, ...] field
    u with the 1D matrices ``mats`` (by name), in u's dtype."""
    dim = u.dim() - 1
    tails = {}

    def tail(a, names):
        """u[a] with names[j] applied along axis dim - len(names) + j (a
        loop, not a recursion: a function that refers to itself would keep
        the cache alive until the cyclic garbage collector runs)."""
        t = u[a]
        for k in range(len(names) - 1, -1, -1):
            if (a, names[k:]) not in tails:
                tails[a, names[k:]] = _axis(mats[names[k]], t,
                                            dim - len(names) + k)
            t = tails[a, names[k:]]
        return t

    out = []
    for row in rows:
        first = {}
        for coef, a, names in row:
            first[names[0]] = (first.get(names[0], 0)
                               + coef * tail(a, names[1:]))
        out.append(sum(_axis(mats[X], t, 0) for X, t in first.items()))
    return torch.stack(out)


class ElasticityReference:
    def __init__(self, config: dict, device, dtype=torch.float64):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        p, r, self.dim = config["degree"], config["refinements"], config["dim"]
        self.mu, self.lam = float(config["mu"]), float(config["lam"])
        K, M = fe1d.assembled_matrices(p, r)
        C = fe1d.assembled_gradient(p, r)
        self.dtype = dtype
        self._mats64 = {name: torch.as_tensor(W, dtype=torch.float64,
                                              device=device)
                        for name, W in (("K", K), ("M", M), ("C", C),
                                        ("Ct", C.T))}
        self.mats = {k: W.to(dtype) for k, W in self._mats64.items()}
        self.rows = chains(self.dim, self.mu, self.lam)
        m = torch.as_tensor(fe1d.free_mask(p, r), dtype=dtype, device=device)
        mask = m
        for _ in range(self.dim - 1):
            mask = mask[..., None] * m
        self.mask = mask
        self.shape = (self.dim,) + (len(m),) * self.dim
        self.iterations = []  # CG's count of each solve

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """A_eff x in ``dtype`` for a [dim, grid] (or flat) vector x of any
        dtype; the result has x's shape and dtype."""
        u = x.reshape(self.shape).to(self.dtype)
        Au = apply_chains(u * self.mask, self.mats, self.rows)
        out = self.mask * Au + (1 - self.mask) * u
        return out.reshape(x.shape).to(x.dtype)

    def _pencil(self):
        """(V, e) of the free points' 1D pencil (K_f, M_f), in float64."""
        if not hasattr(self, "_V"):
            K, M = (self._mats64[k][1:-1, 1:-1] for k in ("K", "M"))
            L = torch.linalg.cholesky(M)
            S = torch.linalg.solve_triangular(
                L, torch.linalg.solve_triangular(L, K, upper=False).T,
                upper=False)
            e, Q = torch.linalg.eigh(0.5 * (S + S.T))
            self._V = torch.linalg.solve_triangular(L.T, Q, upper=True)
            self._e = e
        return self._V, self._e

    def _block_inverse(self, r: torch.Tensor) -> torch.Tensor:
        """P^{-1} r on the free DoFs [dim, free grid]: per component the
        fast diagonalisation of its Kronecker sum, weights alpha_k."""
        V, e = self._pencil()
        out = []
        for c in range(self.dim):
            y = r[c]
            for ax in range(self.dim):
                y = _axis(V.T, y, ax)
            den = 0
            for k in range(self.dim):
                alpha = 2 * self.mu + self.lam if k == c else self.mu
                shape = [1] * self.dim
                shape[k] = -1
                den = den + alpha * e.reshape(shape)
            y = y / den
            for ax in range(self.dim):
                y = _axis(V, y, ax)
            out.append(y)
        return torch.stack(out)

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        """A_eff^{-1} b in float64, for a [dim, grid] (or flat) vector b, by
        block-diagonally preconditioned CG to a preconditioned residual of
        ``TOL`` relative (module docstring)."""
        g = b.reshape(self.shape).to(torch.float64)
        inner = (slice(None),) + (slice(1, -1),) * self.dim
        mats = {k: W[1:-1, 1:-1] for k, W in self._mats64.items()}

        def A(v):
            return apply_chains(v, mats, self.rows)

        f = g[inner]
        x = torch.zeros_like(f)
        r = f.clone()
        z = self._block_inverse(r)
        p = z.clone()
        rz = rz0 = float(torch.vdot(r.reshape(-1), z.reshape(-1)))
        it = 0
        while rz > TOL ** 2 * rz0:
            if it == MAX_ITER:
                raise RuntimeError(f"the reference's CG missed {TOL} in "
                                   f"{MAX_ITER} iterations")
            Ap = A(p)
            alpha = rz / float(torch.vdot(p.reshape(-1), Ap.reshape(-1)))
            x += alpha * p
            r -= alpha * Ap
            z = self._block_inverse(r)
            rz, rz_old = float(torch.vdot(r.reshape(-1), z.reshape(-1))), rz
            p = z + (rz / rz_old) * p
            it += 1
        self.iterations.append(it)
        out = g.clone()
        out[inner] = x
        return out.reshape(b.shape)


def make(config: dict, device, dtype=torch.float64) -> ElasticityReference:
    return ElasticityReference(config, device, dtype)
