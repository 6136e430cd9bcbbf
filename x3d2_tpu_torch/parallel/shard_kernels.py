"""The sharded kernel paths: the sweeps in their halo form, the x applies
per rank, and the repencilled projection.

Counterpart of x3d2_tpu.parallel.shard_kernels (the reference's DistD2 +
fused kernels over locally owned pencils, cuda/kernels/distributed.f90:
196-685, and the 2DECOMP transposes). Per rank:

- transport (make_sharded_transeq, make_sharded_species): the z, x + acc,
  y + acc sweep chain of the single card on the rank's block; along a
  sharded axis the neighbours' edge planes are exchanged first
  (halo.exchange_halo) and the sweep runs in its halo form (ops/
  transeq_sweep.py: windows from the extended operands, the global
  operator blocks from the rank's block offset), so the result is the
  unsharded sweep's. The exchanged width is the port kernel's band W (16,
  32 in the HIGHEST mode), not x3d2_tpu's 64-plane lane halo; the gate is
  x3d2_tpu's (sharded_transeq_supported), which the port's blocking
  always tiles.
- x applies (wrap_x_ops): x is never sharded, so the dense x operators of
  the halo-mode solver are one dense x apply per rank (the x-apply kernel
  of csrc/x_apply_manual.cu, x3d2_tpu's _x_apply_kernel via its
  PallasXApplyOp).
- projection (make_repencilled_pressure): the one-field forward x applies
  on the rank's block, tiled all-to-alls over y then z into a batch of
  nx / (nproc_y nproc_z) whole (y, z) planes, the mid on that batch with
  its slices of the solve tables (ops/pressure_slab.py make_mid_local; at
  planes past x3d2_tpu's VMEM cap, 1024^2 and up to the tiled gate's
  3968 points along y and 2560 along z, its y/z-tiled mid), the
  all-to-alls back over z then y, and the subtracting inverse x applies.

This module adds no kernel of its own.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..common import DataLoc
from ..ops import pressure_slab
from ..ops.banded import banded_blocks
from ..ops.compact import apply_matrix
from ..ops.operator_apply import apply_dense
from ..ops.parity import build_projection_mats, slab_supported
from ..ops.x_apply_manual import DENSE, pack
from ..ops.species_sweep import make_species_sweep
from ..ops.transeq_sweep import (V3_BAND_TOL, V3_FREE, geometry,
                                 make_transeq_sweep)
from .halo import OP_NAMES, exchange_halo
from .topo import field_spec


def _axis_shards(solver, pmesh):
    """Per spatial axis (number of shards, mesh axis or None), and the
    VERT extents."""
    dims = solver.mesh.dims(DataLoc.VERT)
    spec = field_spec(pmesh, dims)
    return [(pmesh.shape[n] if n else 1, n) for n in spec], dims


def _tpu_halo_w(axis, terms):
    """x3d2_tpu's sweep halo (shard_kernels.py:54-56): its band on the
    non-lane axes, the 64-plane lane halo on z. Its gate reads it."""
    return 64 if axis == 2 else (32 if terms >= 3 else 16)


def sharded_transeq_supported(solver, pmesh, terms=2) -> bool:
    """x3d2_tpu sharded_transeq_v3_supported (shard_kernels.py:59-88):
    uniform square operators whose extent divides the mesh dimension,
    local extents that its blocks tile (128 on z, 64 else; an unsharded
    axis at least a block and two halos long), the other two local
    extents multiples of its in-tile ones, and every operator within its
    band at 1e-6."""
    shards, dims = _axis_shards(solver, pmesh)
    local = tuple(dims[a] // shards[a][0] for a in range(3))
    for axis in range(3):
        o = solver.ops[axis]
        corr = o.der2nd.stretch_correct
        if corr is not None and np.any(corr):
            return False
        if o.der1st.n_out != dims[axis] or o.der1st.n_in != dims[axis]:
            return False
        ns = shards[axis][0]
        if dims[axis] % ns:
            return False
        n = local[axis]
        bs = 128 if axis == 2 else 64
        w = _tpu_halo_w(axis, terms)
        if n % bs or (ns == 1 and n < bs + 2 * w):
            return False
        other = [a for a in range(3) if a != axis]
        t0, t1 = V3_FREE[axis]
        if local[other[0]] % t0 or local[other[1]] % t1:
            return False
        try:
            for op in (o.der1st, o.der1st_sym, o.der2nd, o.der2nd_sym):
                banded_blocks(op, w, bs, tol=V3_BAND_TOL)
        except ValueError:
            return False
    return True


def _chain_parts(solver, pmesh, terms):
    """Per sweep of the chain (z, x + acc, y + acc): (axis, accumulate,
    number of shards, mesh axis), the local extents and the port's band."""
    shards, dims = _axis_shards(solver, pmesh)
    local = tuple(dims[a] // shards[a][0] for a in range(3))
    parts = [(axis, acc) + tuple(shards[axis])
             for axis, acc in ((2, False), (0, True), (1, True))]
    return parts, local, geometry(terms)


def _halo_kw(fields, axis, ns, name, pmesh, bs, w, n_loc):
    """The halo form's arguments on a sharded axis (none elsewhere)."""
    if ns == 1:
        return {}
    return {"exts": exchange_halo(fields, axis, pmesh, name, w),
            "off": pmesh.axis_index(name) * (n_loc // bs)}


def make_sharded_transeq(solver, pmesh, terms=2):
    """fn(u, v, w) -> (r_u, r_v, r_w) over this rank's blocks: the z, x +
    acc, y + acc sweeps (x3d2_tpu make_sharded_transeq_v3,
    shard_kernels.py:105-144), each in its halo form on a sharded axis.
    The x and y sweeps add into the z sweep's partials in place."""
    parts, local, (bs, w) = _chain_parts(solver, pmesh, terms)
    fns = {axis: make_transeq_sweep(solver.ops[axis], solver.nu, axis,
                                    local, accumulate=acc,
                                    device=solver.device, terms=terms,
                                    n_shards=ns)
           for axis, acc, ns, _ in parts}

    def fn(u, v, w_):
        acc = None
        for axis, _, ns, name in parts:
            kw = _halo_kw((u, v, w_), axis, ns, name, pmesh, bs, w,
                          local[axis])
            if acc is None:
                acc = fns[axis](u, v, w_, **kw)
            else:
                acc = fns[axis](u, v, w_, acc=acc, out=acc, **kw)
        return acc

    fn.sweeps = fns
    return fn


def make_sharded_species(solver, pmesh, terms=2):
    """fn(phis, u, v, w, out=None) -> one rhs per scalar over this rank's
    blocks: the species sweeps z, x + acc, y + acc (x3d2_tpu
    make_sharded_species_v3, shard_kernels.py:147-207), the conv and
    scalar halos exchanged per direction on a sharded axis. Raises
    ValueError where the local shards do not tile."""
    parts, local, (bs, w) = _chain_parts(solver, pmesh, terms)
    nus = solver.nu_species
    fns = {axis: make_species_sweep(solver.ops[axis], nus, axis, local,
                                    accumulate=acc, device=solver.device,
                                    terms=terms, n_shards=ns)
           for axis, acc, ns, _ in parts}

    def fn(phis, u, v, w_, out=None):
        phis = tuple(phis)
        comps = (u, v, w_)
        acc = None
        for axis, _, ns, name in parts:
            kw = _halo_kw((comps[axis],) + phis, axis, ns, name, pmesh, bs,
                          w, local[axis])
            if acc is None:
                acc = fns[axis](phis, comps[axis], out=out, **kw)
            else:
                acc = fns[axis](phis, comps[axis], acc=acc, out=acc, **kw)
        return acc

    fn.sweeps = fns
    return fn


class XApplyOp:
    """A CompactOp look-alike whose x apply is one dense x apply on the
    rank's block (x3d2_tpu PallasXApplyOp, shard_kernels.py:223-241): the
    x_apply kernel on CUDA tensors (the operator split and packed for it
    at the first call), the plain product on CPU ones."""

    def __init__(self, op):
        self._op = op
        self._packed = None

    def __getattr__(self, name):
        return getattr(self._op, name)

    def __call__(self, f, axis):
        if axis != 0:
            raise ValueError("x-apply op built for axis 0")
        M = self._op.M
        if f.is_cuda:
            if self._packed is None:
                self._packed = pack(M, DENSE, f.device)
            out = torch.empty((M.shape[0],) + tuple(f.shape[1:]),
                              dtype=f.dtype, device=f.device)
            apply_dense("x_apply", self._packed, f.contiguous(), out)
            return out
        return apply_matrix(M.to(f.dtype), f, 0)


def sharded_x_apply_supported(solver, pmesh, t1=8, t2=128) -> bool:
    """x3d2_tpu sharded_x_apply_supported (shard_kernels.py:244-255):
    every rank's (y, z) block of the VERT and CELL extents tiled by
    (t1, t2)."""
    for loc in (DataLoc.VERT, DataLoc.CELL):
        dims = solver.mesh.dims(loc)
        spec = field_spec(pmesh, dims)
        ny_loc = dims[1] // (pmesh.shape[spec[1]] if spec[1] else 1)
        nz_loc = dims[2] // (pmesh.shape[spec[2]] if spec[2] else 1)
        if ny_loc % t1 or nz_loc % t2:
            return False
    return True


def wrap_x_ops(solver, pmesh):
    """The solver's x operators as per-rank x applies (x3d2_tpu
    wrap_x_ops, shard_kernels.py:380-395)."""
    ox = solver.ops[0]
    return dataclasses.replace(ox, **{k: XApplyOp(getattr(ox, k))
                                      for k in OP_NAMES})


def repencil_supported(solver, pmesh) -> bool:
    """x3d2_tpu repencil_supported (shard_kernels.py:258-280): the slab's
    structural gate (parity.slab_supported), the per-rank x applies'
    tiling, every active mesh axis splitting both the VERT and the CELL
    extents, and nx (CELL) a multiple of the rank count."""
    if not slab_supported(solver):
        return False
    if not sharded_x_apply_supported(solver, pmesh):
        return False
    for loc in (DataLoc.VERT, DataLoc.CELL):
        spec = field_spec(pmesh, solver.mesh.dims(loc))
        for name, ax in (("y", 1), ("z", 2)):
            if pmesh.shape[name] > 1 and spec[ax] != name:
                return False
    return solver.mesh.dims(DataLoc.CELL)[0] % pmesh.size == 0


def _a2a_to_x(f, pmesh):
    """(nx, ny_loc, nz_loc) -> (nx_loc, ny, nz): over y, then over z."""
    for name, concat in (("y", 1), ("z", 2)):
        if pmesh.shape[name] > 1:
            f = pmesh.all_to_all(f, name, 0, concat)
    return f


def _a2a_from_x(f, pmesh):
    """(nx_loc, ny, nz) -> (nx, ny_loc, nz_loc): over z, then over y."""
    for name, split in (("z", 2), ("y", 1)):
        if pmesh.shape[name] > 1:
            f = pmesh.all_to_all(f, name, split, 0)
    return f


def make_repencilled_pressure(solver, pmesh, terms=2):
    """fn(u, v, w, keep_pressure=True) -> (u', v', w', p) on this rank's
    blocks (x3d2_tpu make_repencilled_pressure, shard_kernels.py:283-377):
    the one-field forward x applies (x_pfwd on a periodic x, x_apply
    otherwise), the all-to-alls to an x batch, the mid with q on whole (y,
    z) planes with the batch's table slices at x offset (iy nproc_z + iz)
    nx_loc, the all-to-alls back, the subtracting inverse x applies
    (x_pinv[sub], or x_apply[sub]). The mid is x3d2_tpu's choice
    (shard_kernels.py:307-315): the full-plane mid where its VMEM gate
    holds and X3D2_EINSUM_MID is not "1"; else its y/z-tiled mid (the three
    kernels of pressure_slab.pressure_mid_tiled), where tiled_supported;
    else the plain replay. With keep_pressure the physical pressure: the inverse y and z
    transforms of q on the x batch (whole y and z there; x3d2_tpu
    contracts them across ranks with GSPMD), the all-to-alls back, then
    the inverse x transform. Without it p is None (the caller carries its
    previous pressure, as the single-card step does; x3d2_tpu returns the
    spectral q there).

    Raises NotImplementedError where the mid's y or z is wall-bounded
    (x3d2_tpu's repencil gate, slab_pressure_supported's structure, admits
    neither)."""
    dense = os.environ.get("X3D2_BFLY", "1") == "0"
    po = solver.poisson
    if 1 in po.folded or 2 in po.folded:
        raise NotImplementedError(
            "the repencilled projection over wall-bounded y or z: the "
            "folded branches of _pressure_mid_kernel (x3d2_tpu/ops/"
            "pallas_poisson.py:354) on a mesh, which no gate of x3d2_tpu "
            "reaches")
    pm = build_projection_mats(solver, dense)
    nxc = solver.mesh.dims(DataLoc.CELL)[0]
    nx_loc = nxc // pmesh.size
    mk = pressure_slab.make_mid_local(solver, pm, terms)
    einsum = os.environ.get("X3D2_EINSUM_MID", "0") == "1"
    if pressure_slab.tpu_slab_vmem_ok(solver, terms) and not einsum:
        mid = mk(nx_loc)
    elif mk.tiled_supported and not einsum:
        mid = mk.tiled(nx_loc)
    else:
        mid = mk.einsum(nx_loc)
    off = ((pmesh.axis_index("y") * pmesh.nproc_z + pmesh.axis_index("z"))
           * nx_loc)
    parity = pm.x_perm is not None

    def tables(dtype):
        """This rank's slices of the per-x-mode solve tables."""
        m = pm.mats(dtype)
        return tuple(m[k][off:off + nx_loc] if k in m else None
                     for k in ("k2x", "tx2", "mx"))

    def xs(name, f, s=None):
        if parity:
            return pressure_slab.x_apply_parity(name, f, pm, s)
        return pressure_slab.x_apply(name, f, pm, s)

    def fn(u, v, w_, keep_pressure=True):
        d = [_a2a_to_x(xs(k, f), pmesh) for k, f in
             (("sx", u), ("ix", v), ("ix", w_))]
        q, p_zy, dpdy, dpdz = mid(*d, *tables(u.dtype))
        p_zy, dpdy, dpdz = (_a2a_from_x(t, pmesh)
                            for t in (p_zy, dpdy, dpdz))
        un = xs("gxs", p_zy, u)
        vn = xs("gxi", dpdy, v)
        wn = xs("gxi", dpdz, w_)
        p = None
        if keep_pressure:
            m = pm.mats(q.dtype)
            p = apply_matrix(m["ti_z"], apply_matrix(m["ti_y"], q, 1), 2)
            p = apply_matrix(m["ti_x"], _a2a_from_x(p, pmesh), 0)
        return un, vn, wn, p

    fn.mid = mid
    fn.mats = pm
    fn.x_offset = off
    return fn
