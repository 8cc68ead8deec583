"""Build the port's level objects from the JAX package's level state.

The JAX package's operators, transfers and smoothers hold their state as
separable 1D arrays and a few scalars.  Handed over as NumPy arrays (the
caller does ``np.asarray`` on the JAX side, so this module never sees JAX),
they rebuild the port's objects exactly, so a test can run both packages on
identical state and identical Chebyshev bounds:

  * operator: ``mask1``, ``dK1``, ``dM1`` and the assembled 1D ``K1``/``M1``
    (and ``G1``, ``mu``, ``lam`` for elasticity); for the other variants
    ``B``, ``Dco``, ``qmetric``, ``coef``, ``inv_diag_full``,
    ``elem_matrix``, ``Gmat`` and ``wcoef_e`` (``qbanded`` runs on ``B``,
    ``Dco`` and ``coef``: the JAX package's packed blocks of the same
    matrices are not carried over);
  * transfer: ``M1``, ``wmask_f`` and ``mask_c1`` of a ``Transfer``;
  * smoother: ``degree``, ``theta`` and ``delta``, and for a fused one its
    recurrence operator, its ``state_dtype`` and whether it has the
    ``cheb2lr`` kernel (``op_cheb2r``);
  * the sharded solve's levels (:func:`sharded_levels`): the JAX package's
    ``ShardedGeometricPoisson.levels_stacked``, every array with a leading
    shard axis, into the port's per-shard objects on a list of devices;
    and the pencil solve's (:func:`pencil_levels`): its
    ``Sharded2DGeometricPoisson.levels_stacked``, every array with two
    leading (sx, sy) mesh axes; and the sharded elasticity solve's
    (:func:`sharded_elasticity_levels`): its
    ``ShardedElasticity.levels_stacked``;
  * the general-geometry path's indexed operator and transfer
    (:func:`indexed_operator`, :func:`indexed_transfer`): ``l2g``,
    ``metric``, ``B``, ``Dco``, ``mask``, ``inv_diag``; ``l2g_c``,
    ``l2g_f``, ``Mch``, ``w_f``, ``mask_c``.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.cuda_cheb2 import make_cheb2
from .ops.cuda_laplace import (
    CudaLaplaceOperator,
    cuda_laplace_from_factors,
    cuda_laplace_slab_from_factors,
)
from .ops.cuda_elasticity import cuda_elasticity_from_factors
from .ops.cuda_laplace2d import CudaLaplace2D
from .ops.cuda_transfer import (
    CudaTransfer,
    _axis_matrix_1d,
    cuda_transfer_from_matrix,
)
from .ops.elasticity import elasticity_from_factors
from .ops import indexed
from .ops.laplace import LaplaceOperator
from .ops.transfer import Transfer
from .solvers.chebyshev import Chebyshev, FusedChebyshev


def _t(a, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a, np.float64), dtype=dtype,
                           device=device)


def laplace_operator(*, degree: int, n: int, dim: int, mask1,
                     variant: str = "kron", dK1=None, dM1=None, K1=None,
                     M1=None, B=None, Dco=None, qmetric=None, coef=None,
                     inv_diag_full=None, elem_matrix=None, Gmat=None,
                     wcoef_e=None, dtype=torch.float64,
                     device="cpu") -> LaplaceOperator:
    """The plain operator of a variant from its state (1D factors identical
    on every axis); what the variant does not use stays None."""
    def t(a):
        return None if a is None else _t(a, dtype, device)

    def axes(a):
        return None if a is None else (t(a),) * dim

    return LaplaceOperator(
        dim=dim, degree=degree, n=(n,) * dim, mask1=axes(mask1),
        variant=variant, dK1=axes(dK1), dM1=axes(dM1), Kg=axes(K1),
        Mg=axes(M1), B=t(B), Dco=t(Dco), qmetric=t(qmetric), coef=t(coef),
        inv_diag_full=t(inv_diag_full), elem_matrix=t(elem_matrix),
        Gmat=t(Gmat), wcoef_e=t(wcoef_e))


def kernel_operator(*, degree: int, n: int, mask1, dK1, dM1, K1, M1,
                    dim: int = 3, dtype=torch.float64, device="cpu",
                    core: str = "banded") -> CudaLaplaceOperator:
    """The kernel operator from 1D state: B.1 in 3D (``core="mxu"``: its
    bf16 grade), B.4 in 2D."""
    cls = {2: CudaLaplace2D, 3: CudaLaplaceOperator}[dim]
    return cuda_laplace_from_factors(degree, n, mask1, K1, M1, dK1, dM1,
                                     dtype, device, cls=cls, core=core)


def elasticity_operator(*, degree: int, n: int, dim: int, mask1, dK1, dM1, mu,
                        lam, variant: str = "kron", K1=None, M1=None, G1=None,
                        B=None, Dco=None, qmetric=None, elem_matrix=None,
                        kernel: bool = False, dtype=torch.float64,
                        device="cpu", core: str = "banded"):
    """The elasticity operator from its state: a plain variant, or B.5 (3D,
    from the kron state) with ``kernel`` (``core="mxu"``: its bf16 grade,
    the JAX ``FusedVectorChebyshev``'s ``op_smooth``)."""
    if kernel:
        if dim != 3:
            raise ValueError("B.5 is a 3D operator")
        return cuda_elasticity_from_factors(degree, n, mask1, K1, M1, G1, dK1,
                                            dM1, float(mu), float(lam), dtype,
                                            device, core)
    return elasticity_from_factors(dim=dim, degree=degree, n=n, mu=float(mu),
                                   lam=float(lam), m1=mask1, gK=dK1, gM=dM1,
                                   variant=variant, K1=K1, M1=M1, G1=G1, B=B,
                                   Dco=Dco, qmetric=qmetric,
                                   elem_matrix=elem_matrix, dtype=dtype,
                                   device=device)


def plain_transfer(*, dim: int, n_coarse: int, stride_c: int, stride_f: int,
                   M1, wmask_f, mask_c1, dtype=torch.float64,
                   device="cpu") -> Transfer:
    return Transfer(dim=dim, n_coarse=(n_coarse,) * dim, stride_c=stride_c,
                    stride_f=stride_f, M1=_t(M1, dtype, device),
                    wmask_f=(_t(wmask_f, dtype, device),) * dim,
                    mask_c1=(_t(mask_c1, dtype, device),) * dim)


def kernel_transfer(*, n_coarse: int, stride_c: int, stride_f: int, M1,
                    wmask_f, mask_c1, coarse_trimmed: bool,
                    dtype=torch.float64, device="cpu") -> CudaTransfer:
    """The B.3 kernel transfer (3D) from a ``Transfer``'s 1D state."""
    P = _axis_matrix_1d(np.asarray(M1, np.float64), n_coarse, stride_c,
                        stride_f, np.asarray(wmask_f, np.float64),
                        np.asarray(mask_c1, np.float64))
    return cuda_transfer_from_matrix(P, dtype, device, coarse_trimmed)


def smoother(op, *, degree: int, theta, delta, fused: bool = False,
             op_smooth=None, state_dtype=None, op_cheb2r: bool = False):
    """A Chebyshev smoother with the given bounds: plain on the full grid,
    or fused on trimmed state (with the B.2 pair kernel where the operator
    has one, made from ``op_smooth`` when given).  ``op_smooth`` and
    ``state_dtype`` carry a JAX ``FusedChebyshev``'s (or
    ``FusedVectorChebyshev``'s) recurrence operator (e.g.
    :func:`kernel_operator` with ``core="mxu"``) and its ``state_dtype``
    (``"bf16"`` -> ``torch.bfloat16``); ``op_cheb2r`` True adds the
    ``cheb2lr`` kernel (``make_cheb2(..., rout=True)``) of a JAX
    smoother whose ``op_cheb2r`` is set."""
    theta, delta = float(np.asarray(theta)), float(np.asarray(delta))
    if state_dtype == "bf16":
        state_dtype = torch.bfloat16
    elif state_dtype == "f32":
        state_dtype = None
    if fused:
        pair_op = op if op_smooth is None else op_smooth
        return FusedChebyshev(degree=int(degree), op=op, theta=theta,
                              delta=delta,
                              op_cheb2=make_cheb2(pair_op) if op.pair_kernel
                              else None, op_smooth=op_smooth,
                              state_dtype=state_dtype,
                              op_cheb2r=make_cheb2(pair_op, rout=True)
                              if op_cheb2r else None)
    return Chebyshev(degree=int(degree), op=op, theta=theta, delta=delta)


def _shard_operator(op, s, dtype, device) -> LaplaceOperator:
    """Shard s of a stacked plain ``LaplaceOperator`` (per-axis ``n`` and
    1D factors); s an index, or (i, j) on a pencil mesh."""
    def t(a):
        return None if a is None else _t(np.asarray(a)[s], dtype, device)

    def axes(a):
        return None if a is None else tuple(t(v) for v in a)

    return LaplaceOperator(
        dim=op.dim, degree=op.degree, n=tuple(op.n), mask1=axes(op.mask1),
        variant=op.variant, dK1=axes(op.dK1), dM1=axes(op.dM1),
        Kg=axes(op.Kg), Mg=axes(op.Mg), B=t(op.B), Dco=t(op.Dco),
        qmetric=t(op.qmetric))


def _shard_transfer(tr, s, dtype, device) -> Transfer:
    """Shard s of a stacked ``Transfer`` (s as in :func:`_shard_operator`)."""
    def t(a):
        return _t(np.asarray(a)[s], dtype, device)

    return Transfer(dim=tr.dim, n_coarse=tuple(tr.n_coarse),
                    stride_c=tr.stride_c, stride_f=tr.stride_f, M1=t(tr.M1),
                    wmask_f=tuple(t(v) for v in tr.wmask_f),
                    mask_c1=tuple(t(v) for v in tr.mask_c1))


def _kernel_slabs(stacked, devices, dtype, core: str):
    """The port's B.1 slabs of a JAX ``ShardedPallasLaplace`` level.  The
    JAX kernel's bands are its TPU blocks' matrices, so the 1D matrices come
    from the level's geometry (its degree and cells, the port's assembly);
    the shards' slices of the x mask and diagonal factors are the JAX
    arrays, and its thin rows must agree with the port's."""
    from .fem.mesh import HyperCubeMesh
    from .fem.space import FESpace
    from .ops.laplace import assembled_1d_matrices, diagonal_1d_factors
    from .parallel.poisson import _build_stacked_slab, _partial_assembled_1d
    from .parallel.sharding import ShardedCudaLaplace

    loc = stacked.local
    n_loc, n = loc.n[0], loc.n[1]
    p = loc.degree
    space = FESpace(HyperCubeMesh(3, int(np.log2(n))), p)
    ref = _build_stacked_slab(space, devices, dtype, core)
    K1, M1 = assembled_1d_matrices(space)
    gK, gM = diagonal_1d_factors(space)
    Kp, Mp = _partial_assembled_1d(space, n_loc)
    slabs = []
    for s, dev in enumerate(devices):
        mx, gKx, gMx = (np.asarray(v[0], np.float64)[s]
                        for v in (loc.mask1, loc.dK1, loc.dM1))
        slabs.append(cuda_laplace_slab_from_factors(
            p, n, n_loc, space.free_mask_1d(), K1, M1, gK, gM, mx, Kp, Mp,
            gKx, gMx, dtype, dev, core))
        cols = mx[-(p + 1):]
        for got, want in ((ref.thin_kx[s], np.asarray(stacked.thin_kx)[s]),
                          (ref.thin_mx[s], np.asarray(stacked.thin_mx)[s])):
            if not np.allclose(got.cpu().numpy(), want * cols, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max()):
                raise ValueError("the JAX level's thin rows are not the "
                                 "port's slab rows")
    return ShardedCudaLaplace(local=tuple(slabs), thin_kx=ref.thin_kx,
                              thin_mx=ref.thin_mx, thin_sx=ref.thin_sx)


def sharded_levels(levels, devices, n_replicated: int,
                   dtype=torch.float64) -> tuple:
    """The port's sharded levels (``parallel/``) from the JAX package's
    ``ShardedGeometricPoisson.levels_stacked`` as NumPy arrays with a
    leading shard axis, on ``devices`` (one per shard), the first
    ``n_replicated`` levels replicated: plain operators and transfers from
    their arrays, shard by shard (a replicated level from shard 0's, one
    per device); a ``ShardedPallasLaplace`` level as B.1's slabs
    (:func:`_kernel_slabs`), its fused smoother with B.1's ``mxu`` slabs
    and, where the JAX level has the pair, B.2's ``xext`` kernels; every
    smoother with the JAX level's degree and bounds."""
    from .fem.mesh import HyperCubeMesh
    from .fem.space import FESpace
    from .parallel.poisson import _build_stacked_cheb2
    from .parallel.sharding import (
        GatherTransfer,
        Replicated,
        ShardedFusedChebyshev,
        ShardedLaplaceOperator,
        ShardedTransfer,
        per_device,
    )
    from .solvers.vcycle import MGLevel

    out = []
    for i, lvl in enumerate(levels):
        jop, jsm, jtr = lvl.op, lvl.smoother, lvl.transfer
        fused = type(jsm).__name__ == "ShardedFusedChebyshev"
        if i < n_replicated:
            op = Replicated(per_device(
                lambda dev: _shard_operator(jop, 0, dtype, dev), devices))
        elif type(jop).__name__ == "ShardedPallasLaplace":
            op = _kernel_slabs(jop, devices, dtype, "banded")
        else:
            op = ShardedLaplaceOperator(local=tuple(
                _shard_operator(jop, s, dtype, dev)
                for s, dev in enumerate(devices)))
        theta = float(np.asarray(jsm.theta)[0])
        delta = float(np.asarray(jsm.delta)[0])
        if fused:
            loc = jsm.op_smooth.local
            space = FESpace(HyperCubeMesh(3, int(np.log2(loc.n[1]))),
                            loc.degree)
            smoother = ShardedFusedChebyshev(
                degree=int(jsm.degree), op=op,
                op_smooth=_kernel_slabs(jsm.op_smooth, devices, dtype,
                                        "mxu"),
                theta=theta, delta=delta,
                op_cheb2=None if jsm.op_cheb2 is None
                else _build_stacked_cheb2(space, devices, dtype))
        else:
            smoother = Chebyshev(degree=int(jsm.degree), op=op, theta=theta,
                                 delta=delta)
        if jtr is None:
            tr = None
        elif type(jtr).__name__ == "GatherTransfer":
            tr = GatherTransfer(
                local=per_device(lambda dev: _shard_transfer(
                    jtr.local, 0, dtype, dev), devices),
                slab_stride=int(jtr.slab_stride),
                n_loc_points=int(jtr.n_loc_points))
        elif i < n_replicated:
            tr = Replicated(per_device(
                lambda dev: _shard_transfer(jtr, 0, dtype, dev), devices))
        else:
            tr = ShardedTransfer(local=tuple(
                _shard_transfer(jtr, s, dtype, dev)
                for s, dev in enumerate(devices)))
        out.append(MGLevel(op=op, smoother=smoother, transfer=tr))
    return tuple(out)


def _kernel_pencils(stacked, devices, mesh: tuple, dtype):
    """The port's B.1 pencils of a JAX ``ShardedPallas2DLaplace`` level: as
    :func:`_kernel_slabs`, the 1D matrices from the level's geometry and
    each shard's slices of the x and y masks and diagonal factors the JAX
    arrays; its thin rows must agree with the port's."""
    from .fem.mesh import HyperCubeMesh
    from .fem.space import FESpace
    from .parallel.mesh2d import _build_pencil_kernel

    loc = stacked.local
    p, n = loc.degree, loc.n[2]
    sx, sy = mesh
    space = FESpace(HyperCubeMesh(3, int(np.log2(n))), p)
    sliced = [tuple(tuple(np.asarray(v[ax], np.float64)[s // sy, s % sy]
                          for v in (loc.mask1, loc.dK1, loc.dM1))
                    for ax in (0, 1)) for s in range(sx * sy)]
    op = _build_pencil_kernel(space, mesh, devices, dtype, sliced)
    for s in range(sx * sy):
        for ax, thin in enumerate((op.thin_x, op.thin_y)):
            cols = sliced[s][ax][0][-(p + 1):]
            for got, want in ((thin[s][0], (stacked.thin_kx, stacked.thin_ky)
                               [ax]), (thin[s][1], (stacked.thin_mx,
                                                    stacked.thin_my)[ax])):
                want = np.asarray(want)[s // sy, s % sy]
                if not np.allclose(got.cpu().numpy(), want * cols,
                                   rtol=1e-5, atol=1e-5 * np.abs(want).max()):
                    raise ValueError("the JAX level's thin rows are not the "
                                     "port's pencil rows")
    return op


def pencil_levels(levels, devices, n_replicated: int, mesh_shape: tuple,
                  dtype=torch.float64) -> tuple:
    """The port's pencil levels (``parallel/mesh2d.py``) from the JAX
    package's ``Sharded2DGeometricPoisson.levels_stacked`` as NumPy arrays
    with leading (sx, sy) axes, on ``devices`` (one per shard, row-major
    over the mesh), the first ``n_replicated`` levels replicated: plain
    operators and transfers from their arrays, pencil by pencil (a
    replicated level from pencil (0, 0)'s, one per device); a
    ``ShardedPallas2DLaplace`` level as B.1's pencils
    (:func:`_kernel_pencils`), its pair smoother with B.2's pencil pairs;
    every smoother with the JAX level's degree and bounds."""
    from .fem.mesh import HyperCubeMesh
    from .fem.space import FESpace
    from .parallel.mesh2d import (
        Gather2DTransfer,
        ShardedFused2DChebyshev,
        _build_pencil_cheb2,
    )
    from .parallel.sharding import (
        Replicated,
        ShardedLaplaceOperator,
        ShardedTransfer,
        per_device,
    )
    from .solvers.vcycle import MGLevel

    sx, sy = mesh_shape
    devices = list(devices)[: sx * sy]
    at = [(s // sy, s % sy) for s in range(sx * sy)]
    out = []
    for i, lvl in enumerate(levels):
        jop, jsm, jtr = lvl.op, lvl.smoother, lvl.transfer
        if i < n_replicated:
            op = Replicated(per_device(
                lambda dev: _shard_operator(jop, (0, 0), dtype, dev),
                devices))
        elif type(jop).__name__ == "ShardedPallas2DLaplace":
            op = _kernel_pencils(jop, devices, mesh_shape, dtype)
        else:
            op = ShardedLaplaceOperator(local=tuple(
                _shard_operator(jop, k, dtype, dev)
                for k, dev in zip(at, devices)), mesh=(sx, sy))
        theta = float(np.asarray(jsm.theta)[0, 0])
        delta = float(np.asarray(jsm.delta)[0, 0])
        if type(jsm).__name__ == "ShardedFused2DChebyshev":
            loc = op.local[0]
            space = FESpace(HyperCubeMesh(3, int(np.log2(loc.n))),
                            loc.degree)
            smoother = ShardedFused2DChebyshev(
                degree=int(jsm.degree), op=op,
                op_cheb2=_build_pencil_cheb2(space, mesh_shape, devices,
                                             dtype),
                theta=theta, delta=delta)
        else:
            smoother = Chebyshev(degree=int(jsm.degree), op=op, theta=theta,
                                 delta=delta)
        if jtr is None:
            tr = None
        elif type(jtr).__name__ == "Gather2DTransfer":
            tr = Gather2DTransfer(
                local=per_device(lambda dev: _shard_transfer(
                    jtr.local, (0, 0), dtype, dev), devices),
                mesh=(sx, sy), stride=(int(jtr.stride_x), int(jtr.stride_y)),
                n_points=(int(jtr.nx_pts), int(jtr.ny_pts)))
        elif i < n_replicated:
            tr = Replicated(per_device(
                lambda dev: _shard_transfer(jtr, (0, 0), dtype, dev),
                devices))
        else:
            tr = ShardedTransfer(local=tuple(
                _shard_transfer(jtr, k, dtype, dev)
                for k, dev in zip(at, devices)), mesh=(sx, sy))
        out.append(MGLevel(op=op, smoother=smoother, transfer=tr))
    return tuple(out)


def _level_space(dim: int, n: int, degree: int):
    """The FESpace of a level from its global cells per axis."""
    from .fem.mesh import HyperCubeMesh
    from .fem.space import FESpace

    return FESpace(HyperCubeMesh(dim, int(np.log2(n))), degree)


def _shard_elasticity(jop, devices, dtype):
    """The port's per-shard operators of a stacked JAX ``sumfac``
    ``ElasticityOperator`` level: its arrays shard by shard, the mask
    factors read off each shard's grid mask, the diagonal factors from the
    level's geometry (the JAX level holds the assembled inverse diagonal,
    which each shard's must equal)."""
    from .ops.elasticity import ElasticityOperator
    from .parallel.elasticity import _build_stacked_elasticity

    dim, p = jop.dim, jop.degree
    if jop.variant != "sumfac":
        raise ValueError(f"a sharded elasticity level is 'sumfac', not "
                         f"{jop.variant!r}")
    space = _level_space(dim, jop.n[1], p)
    ref = _build_stacked_elasticity(space, devices, dtype, jop.mu, jop.lam)
    local = []
    for s, dev in enumerate(devices):
        def t(a):
            return _t(np.asarray(a, np.float64)[s], dtype, dev)

        m = np.asarray(jop.mask, np.float64)[s]
        # the factors through a free point: m[:, 1, ...] is free off the
        # x factor's zeros, and plane i is free
        i = int(np.argmax(m[(slice(None),) + (1,) * (dim - 1)]))
        mask1 = [m[(slice(None),) + (1,) * (dim - 1)]]
        for ax in range(1, dim):
            mask1.append(m[tuple(slice(None) if a == ax else i if a == 0
                                 else 1 for a in range(dim))])
        op = ElasticityOperator(
            dim=dim, degree=p, n=tuple(jop.n), mu=float(jop.mu),
            lam=float(jop.lam), variant="sumfac",
            mask1=tuple(_t(v, dtype, dev) for v in mask1),
            dK1=ref.local[s].dK1, dM1=ref.local[s].dM1, B=t(jop.B),
            Dco=t(jop.Dco), qmetric=t(jop.qmetric))
        want = np.asarray(jop.inv_diag, np.float64)[s]
        if not np.allclose(op.inv_diag.cpu().numpy(), want, rtol=1e-6,
                           atol=0):
            raise ValueError("the JAX level's diagonal is not the port's "
                             "shard diagonal")
        local.append(op)
    return local


def _kernel_elasticity_slabs(jop, devices, dtype):
    """The port's B.5 slabs of a JAX ``ShardedPallasElasticity`` level: as
    :func:`_kernel_slabs`, the 1D matrices from the level's geometry, each
    shard's slices of the x mask and diagonal factors the JAX arrays; its
    four thin rows must agree with the port's."""
    from .parallel.elasticity import sharded_cuda_elasticity

    loc = jop.local
    p = loc.degree
    space = _level_space(3, loc.n[1], p)
    slices = [tuple(np.asarray(v[0], np.float64)[s]
                    for v in (loc.mask1, loc.dK1, loc.dM1))
              for s in range(len(devices))]
    op = sharded_cuda_elasticity(space, devices, dtype, loc.mu, loc.lam,
                                 slices)
    for s in range(len(devices)):
        cols = slices[s][0][-(p + 1):]
        for got, want in zip((op.thin_kx, op.thin_mx, op.thin_gx,
                              op.thin_hx),
                             (jop.thin_kx, jop.thin_mx, jop.thin_gx,
                              jop.thin_hx)):
            want = np.asarray(want, np.float64)[s]
            if not np.allclose(got[s].cpu().numpy(), want * cols, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max()):
                raise ValueError("the JAX level's thin rows are not the "
                                 "port's slab rows")
    return op


def sharded_elasticity_levels(levels, devices, dtype=torch.float64) -> tuple:
    """The port's sharded elasticity levels (``parallel/elasticity.py``)
    from the JAX package's ``ShardedElasticity.levels_stacked`` as NumPy
    arrays with a leading shard axis, on ``devices`` (one per shard): a
    stacked ``ElasticityOperator`` level as the plain sharded operator
    (:func:`_shard_elasticity`), a ``ShardedPallasElasticity`` level as
    B.5's slabs (:func:`_kernel_elasticity_slabs`); every smoother a plain
    ``Chebyshev`` with the JAX level's degree and bounds; the transfers
    shard by shard, exchanging along axis 1."""
    from .parallel.sharding import (
        ShardedElasticityOperator,
        ShardedTransfer,
    )
    from .solvers.vcycle import MGLevel

    devices = list(devices)
    out = []
    for lvl in levels:
        jop, jsm, jtr = lvl.op, lvl.smoother, lvl.transfer
        if type(jop).__name__ == "ShardedPallasElasticity":
            op = _kernel_elasticity_slabs(jop, devices, dtype)
        else:
            op = ShardedElasticityOperator(
                local=tuple(_shard_elasticity(jop, devices, dtype)))
        smoother = Chebyshev(degree=int(jsm.degree), op=op,
                             theta=float(np.asarray(jsm.theta)[0]),
                             delta=float(np.asarray(jsm.delta)[0]))
        tr = None if jtr is None else ShardedTransfer(
            local=tuple(_shard_transfer(jtr, s, dtype, dev)
                        for s, dev in enumerate(devices)), halo_axis=1)
        out.append(MGLevel(op=op, smoother=smoother, transfer=tr))
    return tuple(out)


def indexed_operator(jop, device="cpu", dtype=torch.float64):
    """The port's IndexedLaplaceOperator on the arrays of the JAX package's
    (``ops/indexed.py``)."""
    return indexed.indexed_operator(
        jop.dim, jop.degree, jop.n_dofs, np.asarray(jop.l2g),
        np.asarray(jop.metric), np.asarray(jop.B), np.asarray(jop.Dco),
        np.asarray(jop.mask), np.asarray(jop.inv_diag), dtype, device)


def indexed_transfer(jtr, device="cpu", dtype=torch.float64):
    """The port's IndexedTransfer on the arrays of the JAX package's."""
    return indexed.indexed_transfer(
        jtr.n_c, jtr.n_f, np.asarray(jtr.l2g_c), np.asarray(jtr.l2g_f),
        np.asarray(jtr.Mch), np.asarray(jtr.w_f), np.asarray(jtr.mask_c),
        dtype, device)
