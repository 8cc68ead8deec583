"""The closed loop's right-hand sides, made on the device from the seed.

Solve k of a run solves A x = b_k, b_k the load vector int phi_i f_k of the
source

    f_k = c + sum_j a_kj prod_d sin(pi m_jd x_d),

masked on the Dirichlet boundary: ``c`` and the wave numbers m_j are the
traffic file's (the same for every seed, so that every seed asks for the
same work), the amplitudes a_kj are drawn for each solve, uniform in
[-amplitude, amplitude], from a generator seeded by the run's seed.  Every
term of f_k is a product of functions of one coordinate each, so its load
vector is the outer product of 1D load vectors: the tensor-product
arithmetic of the program's ``assemble_rhs`` (the (p + 1)-point Gauss rule
a cell, axis by axis) applied to each term.  Set-up puts those 1D vectors
on the device (the source basis); a solve's b_k is then one contraction of
its coefficients with them, in float64, cast to the solve's dtype.  f = c
alone (:meth:`SourceStream.constant_rhs`, c = 1) is the reference program's
own source, which the warm-up solves.

A vector-valued configuration (its ``components`` C > 1, as linear
elasticity's C = dim displacements) takes one source a component,

    f_k,c = c + sum_j a_kjc prod_d sin(pi m_jd x_d),

the amplitudes of a solve drawn in one call of shape (C, modes), and b_k of
shape (C,) + grid: component c the scalar b of its own coefficients, on the
same 1D basis and mask.  :meth:`SourceStream.constant_rhs` is then
f = (1, ..., 1).  Without ``components``, or with 1, the stream is the
scalar one above, draw for draw.

A multi-card cell's stream (``devices``, S > 1 cards) builds each b_k as
its S slabs along grid axis 0 (``slabs.py``), slab s on card s, from the
same draws: card s holds the source basis with axis 0 cut to its slab's
planes, and its slab of b_k is the same contraction on those planes.  No
card holds the whole b_k.  Each slab is the whole stream's b_k on those
planes, bit for bit where the contraction's library computes a row as it
does within the whole (the CPU tests check both dtypes), else to the
rounding of float64.
"""

from __future__ import annotations

import numpy as np
import torch

from . import fe1d, slabs


def seed_int(seed: int) -> int:
    """Any whole number as a seed of NumPy's generators."""
    return int(seed) % (1 << 64)


def rhs_shape(config: dict) -> tuple[int, ...]:
    """The shape of a right-hand side of ``config``: (C,) + grid for C > 1
    components, the grid alone for one."""
    grid = (fe1d.n_points(config["degree"], config["refinements"]),
            ) * config["dim"]
    c = int(config.get("components", 1))
    return grid if c == 1 else (c,) + grid


class SourceStream:
    """The right-hand sides of one run: whole grids on ``device``, or, with
    ``devices`` (S > 1 cards, ``device`` the first), lists of S slabs."""

    def __init__(self, traffic: dict, config: dict, dtype, device,
                 seed: int, devices=None):
        src = traffic["source"]
        p, r, dim = config["degree"], config["refinements"], config["dim"]
        modes = [m[:dim] for m in src["modes"]]
        self.constant = float(src["constant"])
        self.amplitude = float(src["amplitude"])
        self.dim, self.dtype, self.device = dim, dtype, device
        self.components = int(config.get("components", 1))
        ones = fe1d.load_vector(p, r, np.ones_like)
        # [axis][term, point]: term 0 the constant, then one per mode
        basis = [np.stack([ones] + [
            fe1d.load_vector(p, r, lambda x, k=m[ax]: np.sin(np.pi * k * x))
            for m in modes]) for ax in range(dim)]
        mask = fe1d.free_mask(p, r)
        self.basis = [torch.as_tensor(b * mask, dtype=torch.float64,
                                      device=device) for b in basis]
        # per slab the basis on its card, axis 0 cut to the slab's planes
        self.slab_basis = None
        if devices is not None:
            self.slab_basis = [
                [torch.as_tensor((b * mask)[:, lo:hi] if ax == 0
                                 else b * mask, dtype=torch.float64,
                                 device=dev) for ax, b in enumerate(basis)]
                for (lo, hi), dev in zip(
                    slabs.bounds(config, len(devices)), devices)]
        self.n_modes = len(modes)
        self._rng = np.random.default_rng(seed_int(seed))
        # [c, a_k1, ...] of every solve drawn; a row of them a component
        # where there are several
        self.coefficients = []

    def next_rhs(self) -> torch.Tensor:
        """b of the next solve of the stream."""
        if self.components == 1:
            a = self._rng.uniform(-self.amplitude, self.amplitude,
                                  self.n_modes)
            self.coefficients.append(np.concatenate([[self.constant], a]))
        else:
            a = self._rng.uniform(-self.amplitude, self.amplitude,
                                  (self.components, self.n_modes))
            self.coefficients.append(np.concatenate(
                [np.full((self.components, 1), self.constant), a], axis=1))
        return self.rhs(len(self.coefficients) - 1)

    def rhs(self, k: int):
        """b of solve k (drawn already), the same tensor (or slabs) every
        call."""
        return self._build(self.coefficients[k])

    def constant_rhs(self):
        """b of f = 1 (on every component), the reference program's
        source."""
        c = torch.zeros(self.n_modes + 1, dtype=torch.float64)
        c[0] = 1.0
        if self.components > 1:
            c = c.expand(self.components, -1)
        return self._build(c)

    def _build(self, coefficients):
        if self.slab_basis is None:
            c = torch.as_tensor(coefficients, dtype=torch.float64,
                                device=self.device)
            return self._combine(c, self.basis)
        return [self._combine(torch.as_tensor(coefficients,
                                              dtype=torch.float64,
                                              device=basis[0].device), basis)
                for basis in self.slab_basis]

    def _combine(self, c: torch.Tensor, basis: list) -> torch.Tensor:
        if c.dim() == 2:
            return torch.stack([self._combine(row, basis) for row in c])
        if self.dim == 2:
            b = torch.einsum("t,tx,ty->xy", c, *basis)
        else:
            yz = torch.einsum("ty,tz->tyz", *basis[1:])
            b = torch.einsum("tx,tyz->xyz", basis[0] * c[:, None], yz)
        return b.to(self.dtype)
