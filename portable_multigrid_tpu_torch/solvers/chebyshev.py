"""Chebyshev smoother with CG-Lanczos eigenvalue estimation (torch).

Counterpart of ``portable_multigrid_tpu/solvers/chebyshev.py``: deal.II's
``PreconditionChebyshev`` as the reference configures it (reference:
source/geometric_multigrid/program.cc:259-287) — smoothing range 15,
degree 5 and 10 eig-CG iterations on smoothing levels; range 1e-3, adaptive
degree and eig iterations = m() on the coarsest level (Chebyshev as solver).

Bounds follow deal.II's published rules (beta = 1.2 lambda_max; alpha =
lambda_max / range if range > 1 else min(0.9 lambda_max, lambda_min);
adaptive degree from the Chebyshev error bound).  The eigenvalue estimate
runs Jacobi-preconditioned CG from the same seeded start vector as the JAX
package (``numpy.random.default_rng(42)`` on the host; above 2^25 grid
points ``jax.random.uniform(PRNGKey(42), ...)`` on the device, which
:func:`jax_uniform` reproduces bit for bit), so both packages estimate the
same extremes.

Recurrence scalars are computed in the working dtype with NumPy scalars,
as the JAX package computes them from dtype arrays.  One deliberate
difference: :class:`FusedChebyshev` passes its pair/step coefficients to the
kernels in the working dtype, where the TPU kernels took them in float32.
"""

from __future__ import annotations

import dataclasses
import os
from typing import ClassVar

import numpy as np
import torch


def np_dtype(dtype) -> type:
    """The NumPy scalar type matching a torch float dtype."""
    return {torch.float32: np.float32, torch.float64: np.float64}[dtype]


@dataclasses.dataclass
class Chebyshev:
    """Chebyshev polynomial preconditioner/smoother of a fixed degree on the
    full grid, Jacobi-preconditioned with ``op.inv_diag``."""

    degree: int
    op: object
    theta: float  # (beta + alpha) / 2, rounded to the working dtype
    delta: float  # (beta - alpha) / 2

    def apply(self, b: torch.Tensor) -> torch.Tensor:
        """Return p(P^-1 A) P^-1 b — the preconditioner vmult with x0 = 0."""
        inv_diag = self.op.inv_diag
        dt = np_dtype(b.dtype)
        theta, delta, one, two = dt(self.theta), dt(self.delta), dt(1), dt(2)
        sigma1 = theta / delta
        rho = one / sigma1
        d = (inv_diag * b) / float(theta)
        x = d
        r = b
        for _ in range(1, self.degree):
            r = r - self.op.apply(d)
            rho_new = one / (two * sigma1 - rho)
            d = float(rho_new * rho) * d + float(two * rho_new / delta) * (
                inv_diag * r)
            x = x + d
            rho = rho_new
        return x


@dataclasses.dataclass
class FusedChebyshev:
    """Chebyshev smoother whose recurrence runs in the fused kernels, on
    TRIMMED state (global last planes dropped, constrained entries zero).

    Mathematically :class:`Chebyshev` on the free DoFs.  Each recurrence step
    is one pass of the operator kernel (B.1 in 3D, B.4 in 2D, B.5 for
    elasticity; modes cheb/chebl/chebd/chebdl), or two steps are one pass
    of the B.2 pair kernel when ``op_cheb2`` is set (3D Laplace only); the
    smoothing step's residual seeds the recurrence inside the operator
    kernel (residual3t).  ``op`` is the exact operator of the residuals;
    the recurrence's single steps run on ``op_smooth`` (the bf16-grade
    ``"mxu"`` B.1 of the JAX package's production levels; ``op`` when
    None), and ``state_dtype`` (bfloat16 there; the operator's dtype when
    None) stores the recurrence streams r and d between passes, as in the
    JAX package's ``FusedChebyshev``.  x and every level residual stay in
    the operator's dtype.  ``op_cheb2r`` (B.2's ``cheb2lr`` kernel,
    ``PMG_CHEB2R=1``) lets :meth:`smooth_and_residual` end the smoothing
    step with a pair that also gives the V-cycle's residual.

    On B.5 this is the counterpart of the JAX package's
    ``FusedVectorChebyshev``: the state is a [3, ...] trimmed field and
    ``op.diag_trimmed()`` the [3, ...] diagonal.  One difference: the JAX
    smoother's ``smooth`` and ``residual`` take and return the full grid,
    while here every level keeps trimmed state, as for Poisson."""

    degree: int
    op: object  # ops.cuda_laplace.CudaLaplaceOperator (or its 2D subclass)
    theta: float
    delta: float
    op_cheb2: object = None  # ops.cuda_cheb2.Cheb2Kernel
    op_smooth: object = None  # the recurrence's operator; None: op
    state_dtype: torch.dtype | None = None  # r and d between passes
    op_cheb2r: object = None  # ops.cuda_cheb2.Cheb2RKernel (cheb2lr)
    trimmed_io: ClassVar[bool] = True

    def _scalars(self, dtype):
        dt = np_dtype(dtype)
        return dt(self.theta), dt(self.delta), dt(1), dt(2)

    def _steps(self, r, d, x, x_is_d: bool = False, k0: int = 0, rho=None,
               rout: bool = False):
        """Steps k0 .. degree - 2 of the recurrence from (r, d, x); returns
        x, or with ``rout`` (x, rhs - A x) from ``op_cheb2r`` running the
        last pair (callers see to it that the steps pair up)."""
        theta, delta, one, two = self._scalars(x.dtype)
        sd = self.state_dtype
        if sd is not None:
            # the streams enter in the state dtype (a no-op after residual3t
            # and the pair kernel, which store them so)
            r, d = r.to(sd), d.to(sd)
        op = self.op if self.op_smooth is None else self.op_smooth
        sigma1 = theta / delta
        n = self.degree - 1
        if rho is None:
            rho = one / sigma1
        k = k0
        while k < n:
            rho_new = one / (two * sigma1 - rho)
            c0a = rho_new * rho
            c1a = two * rho_new / delta
            first_d = x_is_d and k == 0
            last = k + 2 == n
            pair = self.op_cheb2r if rout and last else self.op_cheb2
            if pair is not None and k + 1 < n:
                rho2 = one / (two * sigma1 - rho_new)
                scal = tuple(map(float, (c0a, c1a, rho2 * rho_new,
                                         two * rho2 / delta)))
                mode = {(False, False): "cheb2", (False, True): "cheb2l",
                        (True, False): "chebd2", (True, True): "chebd2l"
                        }[(first_d, last)]
                if pair is self.op_cheb2r:
                    mode = "cheb2lr"
                outs = pair.steps2(d, r, None if first_d else x, scal, mode,
                                   sdtype=sd)
                if last:
                    return outs if rout else outs[0]
                r, d, x = outs
                rho = rho2
                k += 2
                continue
            scal = (float(c0a), float(c1a))
            last = k == n - 1
            mode = {(False, False): "cheb", (False, True): "chebl",
                    (True, False): "chebd", (True, True): "chebdl"}[
                (first_d, last)]
            ins = (r,) if first_d else (r, x)
            outs = op.run(mode, d, ins, scal, sdtype=sd)
            if last:
                return outs[0]  # only x' is written on the last step
            r, d, x = outs
            rho = rho_new
            k += 1
        return x

    def _x_from_rhs(self, bt):
        """Full recurrence from the rhs (x0 = d0 = bt / (theta diag)); with
        the pair kernel the entry pair derives d0 in-kernel (cheb2f0)."""
        if self.op_cheb2 is not None and self.degree >= 3:
            theta, delta, one, two = self._scalars(bt.dtype)
            sigma1 = theta / delta
            rho = one / sigma1
            rho1 = one / (two * sigma1 - rho)
            rho2 = one / (two * sigma1 - rho1)
            scal = tuple(map(float, (rho1 * rho, two * rho1 / delta,
                                     rho2 * rho1, two * rho2 / delta, theta)))
            n = self.degree - 1
            mode = "cheb2f0l" if n == 2 else "cheb2f0"
            outs = self.op_cheb2.steps2(bt, None, None, scal, mode,
                                        sdtype=self.state_dtype)
            if n == 2:
                return outs[0]
            r, d, x = outs
            return self._steps(r, d, x, k0=2, rho=rho2)
        d0 = bt / (float(np_dtype(bt.dtype)(self.theta)) * self.op.diag_trimmed())
        return self._steps(bt, d0, d0, x_is_d=True)

    def apply(self, b: torch.Tensor) -> torch.Tensor:
        """Preconditioner vmult with x0 = 0 on a masked trimmed input."""
        return self._x_from_rhs(b)

    def smooth(self, u: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
        """u + Cheb(rhs - A u), the V-cycle smoothing step: the residual,
        d0 and x0 = u + d0 come from one B.1 pass (residual3t)."""
        theta = float(np_dtype(u.dtype)(self.theta))
        r0, d0, x0 = self.op.run("residual3t", u, (rhs,), (theta,),
                                 sdtype=self.state_dtype)
        return self._steps(r0, d0, x0)

    def smooth_and_residual(self, u: torch.Tensor,
                            rhs: torch.Tensor) -> tuple:
        """(u', rhs - A u'), u' = :meth:`smooth` (u, rhs): the V-cycle's
        last pre-smoothing step and the residual it restricts.  With
        ``op_cheb2r`` and a recurrence of an even number n >= 2 of steps
        that pairs up (n == 2, or ``op_cheb2`` for the middle pairs), the
        last pair is one ``cheb2lr`` pass, which gives the residual
        r2 - A d2 at the pair's grade in place of a ``residual1t`` pass
        (the JAX package's ``smooth_and_residual``); otherwise
        :meth:`smooth`, then :meth:`residual`."""
        n = self.degree - 1
        if not (self.op_cheb2r is not None and n >= 2 and n % 2 == 0
                and (n == 2 or self.op_cheb2 is not None)):
            un = self.smooth(u, rhs)
            return un, self.residual(un, rhs)
        theta = float(np_dtype(u.dtype)(self.theta))
        r0, d0, x0 = self.op.run("residual3t", u, (rhs,), (theta,),
                                 sdtype=self.state_dtype)
        return self._steps(r0, d0, x0, rout=True)

    def residual(self, u: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
        """rhs - A u on the free DoFs — one B.1 pass (residual1t)."""
        (r0,) = self.op.run("residual1t", u, (rhs,))
        return r0


# Above this many grid points the start vector is drawn on the operator's
# device, as the JAX package draws it there (its solvers/chebyshev.py:676)
DEVICE_DRAW_POINTS = 2 ** 25
_U32 = 0xFFFFFFFF
_DRAW_CHUNK = 2 ** 24  # values a device draw computes at once
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _pseudo_random_grid(shape) -> np.ndarray:
    rng = np.random.default_rng(42)
    return rng.uniform(-0.5, 0.5, size=shape).astype(np.float64)


def threefry2x32(k1: int, k2: int, x0: torch.Tensor,
                 x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds, JAX's ``threefry2x32_p``) of the
    count pairs (x0, x1) under the key (k1, k2).  uint32 values are held in
    int64 tensors and masked to 32 bits after each addition and shift
    (CUDA has no uint32 shifts in torch)."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _U32
    x1 = (x1 + ks[1]) & _U32
    for i in range(5):
        for rot in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _U32
            x1 = (((x1 << rot) | (x1 >> (32 - rot))) & _U32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _U32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _U32
    return x0, x1


def jax_uniform(shape, dtype, device) -> torch.Tensor:
    """``jax.random.uniform(jax.random.PRNGKey(42), shape, dtype, -0.5,
    0.5)`` bit for bit, drawn on ``device`` in chunks of ``_DRAW_CHUNK``
    values.  It follows JAX's partitionable threefry (the default since
    JAX 0.5): the flat index i of each value is the count pair (i >> 32,
    i & 0xFFFFFFFF) under the key (0, 42); its two hash words are xor-ed
    into 32 random bits (float32) or joined into 64 (float64); the top
    mantissa bits of those make a float in [1, 2), less 1, scaled to
    [-0.5, 0.5) (an exact shift: the span is 1)."""
    n = int(np.prod(shape))
    out = torch.empty(n, dtype=dtype, device=device)
    for start in range(0, n, _DRAW_CHUNK):
        i = torch.arange(start, min(n, start + _DRAW_CHUNK),
                         dtype=torch.int64, device=device)
        b1, b2 = threefry2x32(0, 42, i >> 32, i & _U32)
        if dtype == torch.float32:
            f = (((b1 ^ b2) >> 9) | 0x3F800000).to(torch.int32).view(dtype)
        elif dtype == torch.float64:
            f = ((b1 << 20) | (b2 >> 12) | 0x3FF0000000000000).view(dtype)
        else:
            raise ValueError(f"uniform draws float32 or float64, not {dtype}")
        out[start:start + len(i)] = torch.clamp_min((f - 1.0) - 0.5, -0.5)
    return out.reshape(shape)


def _host_free_mask(op) -> np.ndarray:
    """Host-side free-DoF grid mask from the operator's 1D factors."""
    m1 = op.mask1 if isinstance(op.mask1, tuple) else (op.mask1,) * op.dim
    m = m1[0].detach().cpu().numpy().astype(np.float64)
    for f in m1[1:]:
        m = np.multiply.outer(m, f.detach().cpu().numpy().astype(np.float64))
    return m


def _device_free_mask(op) -> torch.Tensor:
    """The free-DoF grid mask on the operator's device, in its dtype, from
    its 1D factors (a product over the spatial axes, which trail any
    component axis)."""
    m1 = op.mask1 if isinstance(op.mask1, tuple) else (op.mask1,) * op.dim
    m = m1[0]
    for f in m1[1:]:
        m = m[..., None] * f
    return m


def estimate_eigenvalues(op, n_iter: int,
                         v0: torch.Tensor) -> tuple[float, float]:
    """Extreme eigenvalues of P^-1 A (P = the Jacobi preconditioner
    ``op.inv_diag``) via n_iter CG-Lanczos iterations from ``v0``.

    The CG coefficients stay on the device until the loop ends; the
    tridiagonal eigenproblem is solved on the host in float64."""
    idg = op.inv_diag
    dot = lambda a, b: torch.dot(a.reshape(-1), b.reshape(-1))
    r = v0
    z = idg * r
    rz = dot(r, z)
    p = z
    stop = torch.zeros((), dtype=torch.bool, device=v0.device)
    alphas, betas = [], []
    for _ in range(int(n_iter)):
        Ap = op.apply(p)
        pAp = dot(p, Ap)
        bad = stop | (pAp <= 0.0)
        alpha = torch.where(bad, torch.full_like(pAp, float("inf")),
                            rz / torch.where(pAp == 0, torch.ones_like(pAp), pAp))
        r = r - torch.where(bad, torch.zeros_like(alpha), alpha) * Ap
        z = idg * r
        rz_new = dot(r, z)
        beta = torch.where(bad, torch.zeros_like(rz_new),
                           rz_new / torch.where(rz == 0, torch.ones_like(rz), rz))
        p = z + beta * p
        stop = bad | (rz_new <= 1e-300)
        rz = rz_new
        alphas.append(alpha)
        betas.append(beta)
    alphas = torch.stack(alphas).cpu().numpy().astype(np.float64)
    betas = torch.stack(betas).cpu().numpy().astype(np.float64)
    valid = np.isfinite(alphas) & (alphas != 0) & np.isfinite(betas)
    k = int(np.sum(np.cumprod(valid)))  # leading run of valid steps
    if k == 0:
        return 1.0, 1.0
    a = alphas[:k]
    b = betas[:k]
    diag = 1.0 / a
    diag[1:] += b[:-1] / a[:-1]
    off = np.sqrt(np.maximum(b[:-1], 0.0)) / a[:-1]
    T = np.diag(diag)
    if k > 1:
        T += np.diag(off, 1) + np.diag(off, -1)
    ev = np.linalg.eigvalsh(T)
    if not (np.isfinite(ev[0]) and np.isfinite(ev[-1]) and ev[-1] > 0):
        # degenerate estimates fall back to the safe unit interval
        return 1.0, 1.0
    return float(ev[0]), float(ev[-1])


def chebyshev_bounds(
    min_eig: float, max_eig: float, smoothing_range: float, degree: int | None
) -> tuple[float, float, int]:
    """deal.II's interval/degree rules (see module docstring). Returns
    (alpha, beta, degree)."""
    beta = 1.2 * max_eig
    if smoothing_range > 1.0:
        alpha = max_eig / smoothing_range
    else:
        alpha = min(0.9 * max_eig, min_eig)
    # keep the interval non-degenerate on BOTH ends: Lanczos breakdown can
    # report min_eig ~ 0, which would blow the adaptive degree below
    alpha = max(alpha, beta * 1e-6)
    alpha = min(alpha, beta * (1.0 - 1e-8))
    if degree is None:
        actual_range = beta / alpha
        sigma = (1.0 - np.sqrt(1.0 / actual_range)) / (
            1.0 + np.sqrt(1.0 / actual_range)
        )
        eps = smoothing_range
        degree = int(
            1
            + np.log(1.0 / eps + np.sqrt(1.0 / eps**2 - 1.0))
            / np.log(1.0 / max(sigma, 1e-12))
        )
        # sanity cap against a degenerate eigenvalue estimate
        degree = min(max(degree, 1), 512)
    return float(alpha), float(beta), int(degree)


def make_chebyshev(
    op,
    *,
    smoothing_range: float = 15.0,
    degree: int | None = 5,
    eig_cg_n_iterations: int = 10,
    fused: bool = False,
    cheb2=None,
    fused_smoother_op=None,
    state_dtype=None,
    cheb2r=None,
    free_mask=None,
):
    """Set up the smoother for a level operator (eig-CG on the op's device).

    Defaults mirror the reference smoothing levels; pass
    ``smoothing_range=1e-3, degree=None, eig_cg_n_iterations=op.n_dofs`` for
    the coarse-level Chebyshev-as-solver configuration.  The environment's
    ``PMG_EIG_MAX_ITERS`` (default 256, as in the JAX package) caps the
    Lanczos length (eig iterations = m() is an upper bound; the extremes
    settle after tens of steps).  ``fused`` (or a ``fused_smoother_op``)
    builds a :class:`FusedChebyshev` on trimmed state, with ``cheb2`` its
    optional pair kernel, ``cheb2r`` its optional ``cheb2lr`` kernel,
    ``fused_smoother_op`` the recurrence's operator and ``state_dtype`` the
    storage of its streams; the eigenvalue estimate runs on the exact
    ``op``.  ``free_mask`` (an array of ``op.shape``, 1 on free DoFs) masks
    the Lanczos start vector in place of the grid mask of ``op.mask1``, as
    the JAX package's ``free_mask=`` does: the indexed operators of
    ``ops/indexed.py`` act on flat vectors and have no 1D factors."""
    # one draw over the whole field, components included, times the grid
    # mask broadcast over them — the JAX package's start vector: NumPy's on
    # the host, or above DEVICE_DRAW_POINTS jax.random's on the device
    shape = op.shape
    if int(np.prod(shape)) > DEVICE_DRAW_POINTS:
        mask = (_device_free_mask(op) if free_mask is None else
                torch.as_tensor(np.asarray(free_mask, np.float64),
                                dtype=op.dtype, device=op.device))
        v0 = jax_uniform(shape, op.dtype, op.device) * mask
    else:
        mask = (_host_free_mask(op) if free_mask is None
                else np.asarray(free_mask, np.float64))
        v0 = _pseudo_random_grid(shape) * mask
        v0 = torch.as_tensor(v0, dtype=op.dtype, device=op.device)
    cap = int(os.environ.get("PMG_EIG_MAX_ITERS", "256"))
    n_iter = max(1, min(int(eig_cg_n_iterations), int(np.prod(shape)), cap))
    min_eig, max_eig = estimate_eigenvalues(op, n_iter, v0)
    alpha, beta, deg = chebyshev_bounds(min_eig, max_eig, smoothing_range,
                                        degree)
    dt = np_dtype(op.dtype)
    theta = float(dt((beta + alpha) / 2.0))
    delta = float(dt((beta - alpha) / 2.0))
    if fused or fused_smoother_op is not None:
        return FusedChebyshev(degree=deg, op=op, theta=theta, delta=delta,
                              op_cheb2=cheb2, op_smooth=fused_smoother_op,
                              state_dtype=state_dtype, op_cheb2r=cheb2r)
    return Chebyshev(degree=deg, op=op, theta=theta, delta=delta)
