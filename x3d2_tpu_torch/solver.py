"""The Incompact3d fractional-step algorithm on PyTorch tensors.

Counterpart of x3d2_tpu.solver (reference solver layer: transeq
src/solver.f90:291-505, vector calculus src/vector_calculus.f90, pressure
correction src/solver.f90:693-739). Fields are Cartesian (nx, ny, nz)
tensors; each compact-operator solve is one matrix contraction
(ops/compact.py).

What runs where: the branch x3d2_tpu takes (solver.py:108-168, :198-205,
:270-282, :523-567), chosen by counterparts of its gates with the same
conditions (``transport_route``, ``parity.slab_supported``,
``parity.pipe3_supported``):
- transeq and transeq_species_all: where transeq_v3_supported's
  conditions hold (ops/transeq_sweep.py transeq_sweep_supported), the
  chains of three sweeps, make_fused_transeq and make_fused_species (at
  most 8 scalars), float32 only (the sweeps' band is truncated at the
  float32 level); else where fused_transeq_supported's hold
  (ops/transeq_dense.py), the dense sweep per direction, summed; else the
  dense operator products, which x3d2_tpu runs as XLA einsums outside any
  kernel, as plain matrix products on either device.
- pressure_correction, in x3d2_tpu's dispatch order: the three-stage
  pipeline (ops/pressure_pipe.py) where pipe3_supported holds and
  X3D2_PIPE3 is not "0", when the pressure is not kept and no
  pre-transformed divergence inputs are given; otherwise where
  slab_pressure_supported holds the slab projection (ops/pressure_slab.py:
  on a periodic x x_div3 or the xdiv sweep's ``divs``, the mid,
  x_gradsub3, or with X3D2_MERGED_X=0 the one-field parity x applies in
  their place; on a wall-bounded x the dense x applies around the mid),
  which with keep_pressure=True also returns the physical pressure, three
  inverse transforms of the spectral solution q as plain matrix products
  (XLA einsums outside any kernel in x3d2_tpu too); elsewhere the
  transform-folded chain of matrix products (x3d2_tpu solver.py:461-491,
  XLA there too) followed by ``u - dpdx``, on either device; with
  another Poisson solve than the matmul one (poisson_method 'fft' or
  'cg') or a stretched y solved by elimination (its stretch_solver), the
  unfused chain divergence_v2p -> the solve -> gradient_p2v (x3d2_tpu
  solver.py:423-435). A stretched y the eigen-resolved matmul solve
  serves keeps the transform-folded chain: no x3d2_tpu kernel gate admits
  a stretched y.
- pressure_grads (the gradients without the correction, for compensated
  stepping), as x3d2_tpu's (solver.py:407-491): where the slab is built
  its x stage and mid with q, then the inverse x stage one field at a
  time without the correction (the parity x apply, or the dense one on a
  wall-bounded x); elsewhere the transform-folded chain.
Kernels run on CUDA tensors and their plain versions on CPU ones. On CUDA
tensors a branch x3d2_tpu runs on a kernel the port lacks raises
NotImplementedError naming it: the port never substitutes plain PyTorch
for a kernel on the card.

On a process mesh (parallel/topo.py make_sharded_step) the solver is a copy
over one rank's blocks (``_sharded``), with x3d2_tpu's sharded branches
(solver.py:206-219, :311-318, :420-431, :529-545): transeq takes the
sharded sweep chain (``_sharded_transeq``, parallel/shard_kernels.py) where
it is built, else in halo mode (``_halo_mode``: operators along sharded
axes applied through halo exchanges, parallel/halo.py) one operator a
product, never row-stacked; the scalars likewise (``_sharded_species``);
gradient_p2v in halo mode one operator a product; pressure_correction the
repencilled projection (``_repencil_pressure``) where it is built. The
projection x3d2_tpu runs otherwise on a sharded mesh, its GSPMD spectral
pressure_grads, raises NotImplementedError (topo.GSPMD_GAP).

The switches x3d2_tpu's solver reads are read where it reads them:
X3D2_PALLAS and X3D2_MATMUL_PRECISION in ``NavierStokes.build``
(solver.py:106, :124-127: "0" takes the einsum paths above on either
device, the dense products and the folded chain; "highest" builds the
sweeps at the W=32 band, ops/compact.py matmul_terms), X3D2_PIPE3,
X3D2_BFLY and X3D2_MERGED_X where the projection is built (X3D2_BFLY=0:
the slab's dense forms, the dense transforms of the mid and the dense x
stage, pallas_poisson.py:588-708; the pipeline keeps its parity splits,
:1593-1604, so it has an operator set of its own then), and
X3D2_MID_SPLIT where the slab's mid runs (``_slab_mid``, solver.py:512:
"1" takes the mid as its two halves, pressure_slab.div_solve and grad,
the counterparts of _div_solve_kernel and _grad_kernel; the pipeline
never reads it).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from .common import DataLoc, resolve_device
from .mesh import Mesh
from .ops.cg_poisson import CGPoisson
from .ops.compact import apply_matrix, matmul_terms
from .ops.dirops import AxisOps, build_all_ops
from .ops.fft_poisson import SpectralPoisson
from .ops.matmul_poisson import MatmulPoisson
from .ops import pressure_slab
from .ops.parity import (build_projection_mats, pipe3_supported, slab_gap,
                         slab_supported)
from .ops.pressure_pipe import make_pressure_pipe
from .ops.species_sweep import make_fused_species
from .ops.transeq_dense import make_transeq_dense, transeq_dense_supported
from .ops.transeq_sweep import (MAX_SPECIES, make_fused_transeq,
                                transeq_sweep_supported)

# why a case with scalars raises on the card: x3d2_tpu takes its species
# sweeps there and the port has not built them
_UNPORTED_SPECIES = ("x3d2_tpu runs its species sweeps here (_species_kernel"
                     "_v3, x3d2_tpu/ops/pallas_kernels.py:1038: the sweeps' "
                     "grids, at most 8 scalars); the port's species kernel "
                     "was not built for this grid")
# the slab's x-stage operators, forward (divergence) and inverse (gradient)
_X_FWD, _X_INV = ("sx", "ix", "ix"), ("gxs", "gxi", "gxi")


def transport_route(solver, shape) -> str:
    """x3d2_tpu's transport branch (solver.py:118-148) on a grid: "sweeps"
    where transeq_v3_supported's conditions hold, else "v1" where
    fused_transeq_supported's hold, else "dense" (its einsum path)."""
    if transeq_sweep_supported(solver, shape):
        return "sweeps"
    if transeq_dense_supported(solver, shape):
        return "v1"
    return "dense"


def projection_route(solver):
    """x3d2_tpu's projection kernels on a grid (solver.py:150-168):
    "pipe3" (with the slab beside it), "slab", or None (the folded chain
    of einsums)."""
    if not slab_supported(solver):
        return None
    return "pipe3" if pipe3_supported(solver) else "slab"


def _bcast(vec: np.ndarray, axis: int, like: torch.Tensor) -> torch.Tensor:
    """Reshape a per-point 1-D factor for broadcasting along `axis`."""
    shape = [1, 1, 1]
    shape[axis] = -1
    return torch.as_tensor(vec, dtype=like.dtype,
                           device=like.device).reshape(shape)


def _halves(t: torch.Tensor, n: int, axis: int):
    """Split a row-stacked operator result into its two (n-long) parts."""
    return t.narrow(axis, 0, n), t.narrow(axis, n, n)


@dataclass(frozen=True)
class NavierStokes:
    """Incompressible Navier-Stokes solver operators (reference solver_t)."""

    mesh: Mesh
    ops: tuple[AxisOps, AxisOps, AxisOps]
    nu: float
    dtype: torch.dtype = torch.float32
    device: torch.device = None
    poisson: Optional[Callable] = None
    nu_species: tuple = ()

    @classmethod
    def build(cls, mesh: Mesh, nu: float, *, dtype=torch.float32,
              schemes: dict | None = None, poisson_method: str = "matmul",
              device=None, nu_species=()) -> "NavierStokes":
        """poisson_method (x3d2_tpu solver.py:69-95): 'matmul' (separable
        real transforms, ops/matmul_poisson.py), 'fft' (the FFT pipeline,
        ops/fft_poisson.py SpectralPoisson) or 'cg' (BiCGStab on the
        discrete div(grad(.)), ops/cg_poisson.py, right-preconditioned by
        the matmul solve, on a uniform twin mesh where the mesh is
        stretched); another raises ValueError. nu_species: one
        diffusivity per passive scalar. Reads X3D2_PALLAS ("0": no kernel
        branch, the einsum paths on either device) and
        X3D2_MATMUL_PRECISION (the sweeps' band: W=32 for "highest"; an
        unknown value raises ValueError) now, as x3d2_tpu's build does;
        the kernel mode is kept as ``_terms``."""
        if poisson_method not in ("matmul", "fft", "cg"):
            raise ValueError(f"unknown poisson_method {poisson_method!r}")
        device = resolve_device(device)
        terms = matmul_terms()
        # x3d2_tpu's switch of all its kernel branches (solver.py:106)
        kernels = os.environ.get("X3D2_PALLAS", "1") != "0"
        ops = build_all_ops(mesh, dtype=dtype, device=device,
                            **(schemes or {}))
        if poisson_method == "matmul":
            poisson = MatmulPoisson(mesh, ops, dtype=dtype, device=device)
        elif poisson_method == "fft":
            poisson = SpectralPoisson(mesh, ops, dtype=dtype, device=device)
        else:
            # the preconditioner: the matmul solve, on the uniform twin of
            # a stretched mesh (x3d2_tpu solver.py:80-95)
            ns0 = cls(mesh=mesh, ops=ops, nu=nu, dtype=dtype, device=device,
                      poisson=None, nu_species=tuple(nu_species))
            if any(mesh.stretched):
                twin = Mesh(mesh.global_vert_dims, mesh.L, mesh.BCs)
                pre = MatmulPoisson(twin, build_all_ops(
                    twin, dtype=dtype, device=device, **(schemes or {})),
                    dtype=dtype, device=device)
            else:
                pre = MatmulPoisson(mesh, ops, dtype=dtype, device=device)
            poisson = CGPoisson(
                lambda p: ns0.divergence_v2p(*ns0.gradient_p2v(p)),
                precond=pre, tol=1e-10 if dtype == torch.float64 else 1e-6)
        ns = cls(mesh=mesh, ops=ops, nu=nu, dtype=dtype, device=device,
                 poisson=poisson, nu_species=tuple(nu_species))
        ns._fused_pressure_mats()
        # the transport x3d2_tpu takes (solver.py:118-148): the sweep
        # chains (float32; a band wider than the kernel's leaves them out,
        # and the card then raises in transeq), the dense sweeps (any
        # dtype: their operators are the exact dense ones), or the dense
        # products
        sweeps = species = v1 = None
        shape = mesh.dims(DataLoc.VERT)
        route = transport_route(ns, shape) if kernels else "dense"
        if route == "sweeps" and dtype == torch.float32:
            try:
                sweeps = make_fused_transeq(ops, nu, shape, device=device,
                                            terms=terms)
                if ns.nu_species and len(ns.nu_species) <= MAX_SPECIES:
                    species = make_fused_species(ops, ns.nu_species, shape,
                                                 device=device, terms=terms)
            except ValueError:
                pass
        elif route == "v1":
            v1 = make_transeq_dense(ops, nu, shape, device=device)
        object.__setattr__(ns, "_terms", terms)
        object.__setattr__(ns, "_transport", route)
        object.__setattr__(ns, "_sweeps", sweeps)
        object.__setattr__(ns, "_v1", v1)
        object.__setattr__(ns, "_species_sweeps", species)
        # both kernel projections over one operator set: _pipe is the
        # pipeline's function, _slab the set the slab's functions take.
        # _projection_gap: why the card cannot run the kernels x3d2_tpu
        # runs here (None where it can, or where x3d2_tpu runs none)
        pipe = slab = gap = None
        proute = projection_route(ns) if kernels else None
        if proute == "pipe3" and os.environ.get("X3D2_PIPE3", "1") == "0":
            # x3d2_tpu builds the slab alone (solver.py:161-168)
            proute = "slab"
        # x3d2_tpu reads X3D2_BFLY where it builds the slab
        # (pallas_poisson.py:589-603, :676): "0" keeps the slab's
        # transforms and x stage dense; its pipeline ignores it
        dense = os.environ.get("X3D2_BFLY", "1") == "0"
        if proute is not None:
            gap = slab_gap(ns)
        if proute is not None and gap is None:
            slab = build_projection_mats(ns, dense)
            if proute == "pipe3":
                pipe = make_pressure_pipe(
                    build_projection_mats(ns) if dense else slab)
        object.__setattr__(ns, "_pipe", pipe)
        object.__setattr__(ns, "_slab", slab)
        object.__setattr__(ns, "_projection_gap", gap)
        # the merged 3-field parity x stage (x_div3, x_gradsub3), or with
        # X3D2_MERGED_X=0 one field a launch (pallas_poisson.py:709-715)
        object.__setattr__(ns, "_merged_x",
                           os.environ.get("X3D2_MERGED_X", "1") != "0")
        return ns

    def transport_gap(self):
        """Why the card cannot run this grid's transport, or None: x3d2_tpu
        takes a sweep kernel here (the sweeps or the dense sweeps) and the
        port has not built it (float32 only; a band wider than the
        kernel's)."""
        if self._transport == "dense" or self._sweeps is not None \
                or self._v1 is not None:
            return None
        return (f"x3d2_tpu runs its banded sweeps here (_transeq_kernel_v3, "
                f"x3d2_tpu/ops/pallas_kernels.py:172); the port's sweep "
                f"kernel takes float32 and operators within its band "
                f"(dtype {self.dtype})")

    def species_gap(self):
        """Why the card cannot run this solver's scalars, or None: x3d2_tpu
        takes its species sweeps here (the sweeps' grids, at most 8
        scalars: solver.py:125-136, :277-279) and the port has not built
        them. Elsewhere both run the per-species einsums (past 8 scalars,
        the v1 and dense transport routes, X3D2_PALLAS=0)."""
        nsp = len(self.nu_species)
        if (0 < nsp <= MAX_SPECIES and self._transport == "sweeps"
                and self._species_sweeps is None):
            return _UNPORTED_SPECIES
        return None

    # ------------------------------------------------------------------
    # transport equation RHS
    # ------------------------------------------------------------------
    def transeq(self, u, v, w):
        """Skew-symmetric momentum RHS (reference transeq_default,
        solver.f90:291-389): the chain of three sweeps or the dense sweeps
        where x3d2_tpu takes its kernels, else the dense operator matrices
        (on the card only where x3d2_tpu runs them as einsums too). The
        direction-aligned
        component uses (der1st, der1st_sym, der2nd); transverse components
        use (der1st_sym, der1st, der2nd_sym) (omp/backend.f90:235-262). The
        6 products u_i*u_j are computed once; dq and d2q share one
        row-stacked product."""
        sharded = getattr(self, "_sharded_transeq", None)
        if sharded is not None:
            return sharded(u, v, w)
        if self._sweeps is not None:
            return self._sweeps(u, v, w)
        if self._v1 is not None:
            return self._v1(u, v, w)
        if u.is_cuda and self.transport_gap() is not None:
            raise NotImplementedError(f"transeq on the card: "
                                      f"{self.transport_gap()}")
        comps = (u, v, w)
        if getattr(self, "_halo_mode", False):
            # sharded axes: one operator a product, each with its own halo
            # exchange (x3d2_tpu solver.py:206-219)
            rhs = [0.0, 0.0, 0.0]
            for axis in range(3):
                o = self.ops[axis]
                for c in range(3):
                    if c == axis:
                        ops = (o.der1st, o.der1st_sym, o.der2nd)
                    else:
                        ops = (o.der1st_sym, o.der1st, o.der2nd_sym)
                    rhs[c] = rhs[c] + self._transeq_component(
                        comps[c], comps[axis], axis, *ops, self.nu)
            return tuple(rhs)
        prods = {}

        def prod(i, j):
            key = (min(i, j), max(i, j))
            if key not in prods:
                prods[key] = comps[key[0]] * comps[key[1]]
            return prods[key]

        rhs = [0.0, 0.0, 0.0]
        for axis in range(3):
            o = self.ops[axis]
            conv = comps[axis]
            corr = o.der2nd.stretch_correct
            cb = (_bcast(corr, axis, u)
                  if corr is not None and np.any(corr) else None)
            for c in range(3):
                q = comps[c]
                if c == axis:
                    op_du, op_dud, op_d2u = o.der1st, o.der1st_sym, o.der2nd
                else:
                    op_du, op_dud, op_d2u = o.der1st_sym, o.der1st, o.der2nd_sym
                M2 = torch.cat([op_du.M, op_d2u.M])
                dq, d2q = _halves(apply_matrix(M2, q, axis), op_du.n_out,
                                  axis)
                dqd = op_dud(prod(c, axis), axis)
                if cb is not None:
                    d2q = d2q + dq * cb
                rhs[c] = rhs[c] - 0.5 * (conv * dq + dqd) + self.nu * d2q
        return tuple(rhs)

    def _transeq_component(self, q, conv, axis, op_du, op_dud, op_d2u, nu):
        """One component's RHS along one axis, one operator a product:
        -0.5 (conv dq + d(q conv)) + nu d2q, with the stretched-mesh
        correction (x3d2_tpu solver.py:170-180)."""
        dq = op_du(q, axis)
        dqd = op_dud(q * conv, axis)
        d2q = op_d2u(q, axis)
        corr = op_d2u.stretch_correct
        if corr is not None and np.any(corr):
            d2q = d2q + dq * _bcast(corr, axis, q)
        return -0.5 * (conv * dq + dqd) + nu * d2q

    def transeq_species(self, phi, u, v, w, nu_s):
        """Species convection-diffusion RHS on the dense operator matrices
        (solver.f90:507-601): the scalar uses (der1st, der1st_sym, der2nd)
        against the velocity component aligned with each direction
        (omp/backend.f90:226-231). x3d2_tpu's per-species einsums
        (solver.py:260-268), which it runs past the species sweeps: on the
        card as plain PyTorch, as the einsum transport."""
        comps = (u, v, w)
        rhs = 0.0
        for axis in range(3):
            o = self.ops[axis]
            conv = comps[axis]
            dq = o.der1st(phi, axis)
            dqd = o.der1st_sym(phi * conv, axis)
            d2q = o.der2nd(phi, axis)
            corr = o.der2nd.stretch_correct
            if corr is not None and np.any(corr):
                d2q = d2q + dq * _bcast(corr, axis, phi)
            rhs = rhs + (-0.5 * (conv * dq + dqd) + nu_s * d2q)
        return rhs

    def transeq_species_all(self, phi, u, v, w):
        """All scalars' RHS from a stacked (nsp, nx, ny, nz) field: the
        species sweep chain (one conv window read shared by the scalars
        per direction) where it is built, else the dense per-species path
        (x3d2_tpu solver.py:270-282: past 8 scalars, off the sweeps'
        grids)."""
        nsp = len(self.nu_species)
        sharded = getattr(self, "_sharded_species", None)
        if sharded is not None:
            out = torch.empty_like(phi)
            sharded(phi.unbind(0), u, v, w, out=out.unbind(0))
            return out
        if self._species_sweeps is not None:
            out = torch.empty_like(phi)
            self._species_sweeps(phi.unbind(0), u, v, w, out=out.unbind(0))
            return out
        return torch.stack([self.transeq_species(phi[i], u, v, w,
                                                 self.nu_species[i])
                            for i in range(nsp)])

    def transeq_with_species(self, u, v, w, phi):
        """Momentum + all-species RHS: (rhs3, stacked species rhs)."""
        return (self.transeq(u, v, w),
                self.transeq_species_all(phi, u, v, w))

    # ------------------------------------------------------------------
    # vector calculus (reference vector_calculus.f90)
    # ------------------------------------------------------------------
    def divergence_v2p(self, u, v, w):
        """div(u) from VERT to CELL grid (vector_calculus.f90:142-246),
        x -> y -> z."""
        ox, oy, oz = self.ops
        du = ox.stagder_v2p(u, 0)
        dv = ox.interpl_v2p(v, 0)
        dw = ox.interpl_v2p(w, 0)
        duv = oy.interpl_v2p(du, 1) + oy.stagder_v2p(dv, 1)
        dw = oy.interpl_v2p(dw, 1)
        return oz.interpl_v2p(duv, 2) + oz.stagder_v2p(dw, 2)

    def gradient_p2v(self, p):
        """grad(p) from CELL to VERT grid (vector_calculus.f90:248-332),
        z -> y -> x; operator pairs sharing an input are row-stacked (in
        halo mode one operator a product, x3d2_tpu solver.py:311-318)."""
        ox, oy, oz = self.ops
        if getattr(self, "_halo_mode", False):
            p_z, dpdz = oz.interpl_p2v(p, 2), oz.stagder_p2v(p, 2)
            p_zy, dpdy = oy.interpl_p2v(p_z, 1), oy.stagder_p2v(p_z, 1)
            dpdz = oy.interpl_p2v(dpdz, 1)
            return (ox.stagder_p2v(p_zy, 0), ox.interpl_p2v(dpdy, 0),
                    ox.interpl_p2v(dpdz, 0))
        Mz = torch.cat([oz.interpl_p2v.M, oz.stagder_p2v.M])
        p_z, dpdz = _halves(apply_matrix(Mz, p, 2), oz.interpl_p2v.n_out, 2)
        My = torch.cat([oy.interpl_p2v.M, oy.stagder_p2v.M])
        p_zy, dpdy = _halves(apply_matrix(My, p_z, 1),
                             oy.interpl_p2v.n_out, 1)
        dpdz = oy.interpl_p2v(dpdz, 1)
        return (ox.stagder_p2v(p_zy, 0), ox.interpl_p2v(dpdy, 0),
                ox.interpl_p2v(dpdz, 0))

    def curl(self, u, v, w):
        """curl at vertices (vector_calculus.f90:40-140)."""
        ox, oy, oz = self.ops
        o_i = oy.der1st(w, 1) - oz.der1st(v, 2)
        o_j = oz.der1st(u, 2) - ox.der1st(w, 0)
        o_k = ox.der1st(v, 0) - oy.der1st(u, 1)
        return o_i, o_j, o_k

    def laplacian(self, f):
        """Laplacian at the field's location (vector_calculus.f90:380-436),
        without the stretched-mesh first-derivative correction."""
        ox, oy, oz = self.ops
        return ox.der2nd(f, 0) + oy.der2nd(f, 1) + oz.der2nd(f, 2)

    # ------------------------------------------------------------------
    # pressure projection
    # ------------------------------------------------------------------
    def _fp_mats64(self):
        """Float64 numpy masters of the transform-folded projection
        matrices: the spectral transforms composed with the staggered
        divergence (Tf @ op) and gradient (op @ Ti) stages per axis; None
        when the Poisson solve is not the matmul one (x3d2_tpu
        solver.py:359-361)."""
        if not isinstance(self.poisson, MatmulPoisson):
            return None
        if "_fp64_cache" in self.__dict__:
            return self._fp64_cache
        po = self.poisson
        f64 = [np.asarray(T, np.float64) for T in po.Tf64]
        i64 = [np.asarray(T, np.float64) for T in po.Ti64]
        ox, oy, oz = self.ops
        d = {}
        d["sx"] = f64[0] @ ox.stagder_v2p.M64
        d["ix"] = f64[0] @ ox.interpl_v2p.M64
        d["sy"] = f64[1] @ oy.stagder_v2p.M64
        d["iy"] = f64[1] @ oy.interpl_v2p.M64
        d["sz"] = f64[2] @ oz.stagder_v2p.M64
        d["iz"] = f64[2] @ oz.interpl_v2p.M64
        d["gz_i"] = oz.interpl_p2v.M64 @ i64[2]
        d["gz_s"] = oz.stagder_p2v.M64 @ i64[2]
        d["gy_i"] = oy.interpl_p2v.M64 @ i64[1]
        d["gy_s"] = oy.stagder_p2v.M64 @ i64[1]
        d["gx_i"] = ox.interpl_p2v.M64 @ i64[0]
        d["gx_s"] = ox.stagder_p2v.M64 @ i64[0]
        d["gz_is"] = np.concatenate([d["gz_i"], d["gz_s"]])
        d["gy_is"] = np.concatenate([d["gy_i"], d["gy_s"]])
        object.__setattr__(self, "_fp64_cache", d)
        return d

    def _fused_pressure_mats(self):
        """Device copies of the folded projection matrices (cached), or
        None with another Poisson solve than the matmul one."""
        if "_fp_cache" in self.__dict__:
            return self._fp_cache
        d64 = self._fp_mats64()
        if d64 is None:
            return None
        d = {k: torch.as_tensor(M, dtype=self.dtype, device=self.device)
             for k, M in d64.items()}
        object.__setattr__(self, "_fp_cache", d)
        return d

    def pressure_grads(self, u, v, w, keep_pressure=True):
        """Pressure-gradient stage of the projection: (dpdx, dpdy, dpdz, p),
        for callers that apply the correction themselves (compensated
        stepping). Where the slab is built, x3d2_tpu's slab branch
        (solver.py:441-457): the x stage and the mid with q, then the
        inverse x stage one field at a time without the correction, the
        parity x apply on a periodic x or the dense x apply on a
        wall-bounded one. Elsewhere the transform-folded chain
        (pressure_grads_folded), or the unfused divergence -> solve ->
        gradient with another Poisson solve or the scan route. p: the
        physical pressure with keep_pressure, else the spectral-basis
        solution q (the unfused chain's p is physical either way). On a
        process mesh x3d2_tpu runs its GSPMD spectral chain here
        (solver.py:420-431) and the port raises NotImplementedError."""
        if getattr(self, "_sharded", False):
            from .parallel.topo import GSPMD_GAP
            raise NotImplementedError(GSPMD_GAP.format(
                what="the spectral pressure_grads (divergence, the Poisson "
                     "transforms across ranks, gradient)"))
        slab = self._slab
        if slab is None:
            if u.is_cuda and self._projection_gap is not None:
                raise NotImplementedError(
                    "the projection on the card: x3d2_tpu runs its slab "
                    f"kernels on this grid; the port lacks "
                    f"{self._projection_gap}")
            if (not isinstance(self.poisson, MatmulPoisson)
                    or self.poisson.stretch_solver is not None):
                # x3d2_tpu solver.py:423-435: divergence, the Poisson
                # solve (not the matmul one, or a stretched y solved by
                # elimination), gradient, each as its own operator chain
                p = self.poisson(self.divergence_v2p(u, v, w))
                return self.gradient_p2v(p) + (p,)
            return self.pressure_grads_folded(u, v, w, keep_pressure)
        q, p_zy, dpdy, dpdz = self._slab_mid(u, v, w)
        grads = self._x_stage(_X_INV, (p_zy, dpdy, dpdz))
        return grads + (self._physical_p(q) if keep_pressure else q,)

    def pressure_grads_folded(self, u, v, w, keep_pressure=True):
        """The transform-folded chain of matrix products (x3d2_tpu
        solver.py:461-491): the divergence taken straight into the
        spectral basis, solved on the diagonal, and the gradient taken
        straight out of it. With keep_pressure the physical pressure is
        reconstructed by the three inverse transforms; otherwise p is the
        spectral-basis solution. Any device: XLA einsums in x3d2_tpu."""
        d = self._fused_pressure_mats()
        po = self.poisson

        def ap(name, t, axis):
            return apply_matrix(d[name], t, axis)

        du = ap("sx", u, 0)
        dv = ap("ix", v, 0)
        dw = ap("ix", w, 0)
        duv = ap("iy", du, 1) + ap("sy", dv, 1)
        dw = ap("iy", dw, 1)
        F = ap("iz", duv, 2) + ap("sz", dw, 2)
        q = F * po.inv_waves
        p_z, dpdz = _halves(ap("gz_is", q, 2), self.ops[2].interpl_p2v.n_out,
                            2)
        p_zy, dpdy = _halves(ap("gy_is", p_z, 1),
                             self.ops[1].interpl_p2v.n_out, 1)
        dpdz = ap("gy_i", dpdz, 1)
        dpdx = ap("gx_s", p_zy, 0)
        dpdy = ap("gx_i", dpdy, 0)
        dpdz = ap("gx_i", dpdz, 0)
        p = q
        if keep_pressure:
            for a in range(3):
                p = apply_matrix(po.Ti[a], p, a)
        return dpdx, dpdy, dpdz, p

    def _physical_p(self, q):
        """The physical pressure from the slab's spectral solution q, whose
        modes are in block-parity order on the periodic axes: the inverse
        transforms with permuted columns."""
        m = self._slab.mats(q.dtype)
        for a, name in enumerate(("ti_x", "ti_y", "ti_z")):
            q = apply_matrix(m[name], q, a)
        return q

    def _x_stage(self, names, fields, s=(None, None, None)):
        """The slab's x stage over three fields: forward (_X_FWD) or
        inverse (_X_INV; with s = (u, v, w) the corrected s - gradient).
        On a periodic x the merged 3-field parity kernel (x_div3, or
        x_gradsub3 with s), or one field a launch with X3D2_MERGED_X=0
        (x3d2_tpu solver.py:506-509, :549-552) and for the gradients
        without the correction (:441-457); on a wall-bounded x the dense x
        apply one field a launch (:506-511, :550-555)."""
        slab = self._slab
        if slab.x_perm is None:
            return tuple(pressure_slab.x_apply(n, f, slab, t)
                         for n, f, t in zip(names, fields, s))
        if self._merged_x and names == _X_FWD:
            return pressure_slab.x_div3(*fields, slab)
        if self._merged_x and s[0] is not None:
            return pressure_slab.x_gradsub3(*fields, *s, slab)
        return tuple(pressure_slab.x_apply_parity(n, f, slab, t)
                     for n, f, t in zip(names, fields, s))

    def _slab_mid(self, u, v, w, want_q=True, divs=None):
        """The slab projection up to the gradient x stage: (q or None,
        p_zy, dpdy, dpdz). `divs` supplies the x-transformed divergence
        inputs (the xdiv sweep's), so the x stage is skipped; without
        want_q the spectral solution is not returned. With X3D2_MID_SPLIT=1,
        read here as x3d2_tpu reads it (solver.py:512-518), the mid runs as
        its two halves, div_solve (q, always formed) then grad."""
        du, dv, dw = (divs if divs is not None
                      else self._x_stage(_X_FWD, (u, v, w)))
        if os.environ.get("X3D2_MID_SPLIT", "0") == "1":
            q = pressure_slab.div_solve(du, dv, dw, self._slab)
            return ((q if want_q else None),) + pressure_slab.grad(
                q, self._slab)
        return pressure_slab.pressure_mid(du, dv, dw, self._slab,
                                          emit_q=want_q)

    def pressure_correction(self, u, v, w, keep_pressure=True, divs=None):
        """Fractional-step projection (solver.f90:693-739): the
        divergence-free velocity and the pseudo-pressure (CELL grid,
        scaled by dt like the reference), in the dispatch order of
        x3d2_tpu (solver.py:523-567). With keep_pressure=False the
        pressure is not formed on the kernel grids and p is None (the
        caller carries its previous pressure, as x3d2_tpu does). `divs`:
        pre-transformed divergence inputs from the xdiv sweep (slab
        projection only). On a process mesh, the repencilled projection
        (x3d2_tpu solver.py:529-533) where it is built."""
        rp = getattr(self, "_repencil_pressure", None)
        if rp is not None:
            if divs is not None:
                raise ValueError("the repencilled projection takes no "
                                 "pre-transformed divergence inputs")
            return rp(u, v, w, keep_pressure)
        if self._pipe is not None and divs is None and not keep_pressure:
            return (*self._pipe(u, v, w), None)
        if self._slab is not None:
            q, p_zy, dpdy, dpdz = self._slab_mid(
                u, v, w, want_q=keep_pressure, divs=divs)
            un, vn, wn = self._x_stage(_X_INV, (p_zy, dpdy, dpdz), (u, v, w))
            return un, vn, wn, (self._physical_p(q) if keep_pressure
                                else None)
        if divs is not None:
            raise ValueError("pre-transformed divergence inputs need the "
                             "slab projection")
        dpdx, dpdy, dpdz, p = self.pressure_grads(
            u, v, w, keep_pressure=keep_pressure)
        return u - dpdx, v - dpdy, w - dpdz, p
