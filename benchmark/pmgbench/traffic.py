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
"""

from __future__ import annotations

import numpy as np
import torch

from . import fe1d


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
    def __init__(self, traffic: dict, config: dict, dtype, device,
                 seed: int):
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

    def rhs(self, k: int) -> torch.Tensor:
        """b of solve k (drawn already), the same tensor every call."""
        c = torch.as_tensor(self.coefficients[k], dtype=torch.float64,
                            device=self.device)
        return self._combine(c)

    def constant_rhs(self) -> torch.Tensor:
        """b of f = 1 (on every component), the reference program's
        source."""
        c = torch.zeros(self.n_modes + 1, dtype=torch.float64,
                        device=self.device)
        c[0] = 1.0
        if self.components > 1:
            c = c.expand(self.components, -1)
        return self._combine(c)

    def _combine(self, c: torch.Tensor) -> torch.Tensor:
        if c.dim() == 2:
            return torch.stack([self._combine(row) for row in c])
        if self.dim == 2:
            b = torch.einsum("t,tx,ty->xy", c, *self.basis)
        else:
            yz = torch.einsum("ty,tz->tyz", *self.basis[1:])
            b = torch.einsum("tx,tyz->xyz", self.basis[0] * c[:, None], yz)
        return b.to(self.dtype)
