"""Per-axis operator bundles (the reference's dirps_t).

Builds the 8 compact operators per axis exactly as solver allocate_tdsops
does (reference src/solver.f90:214-289), including the Dirichlet->Neumann
override for the midpoint (pressure-grid) operators required by the
spectral Poisson solver (solver.f90:230-245). Counterpart of
x3d2_tpu.ops.dirops.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..common import BC, resolve_device
from ..mesh import Mesh
from .compact import CompactOp, build_op


@dataclass(frozen=True)
class AxisOps:
    """All compact operators for one axis (reference tdsops.f90:51-59)."""

    axis: int
    der1st: CompactOp
    der1st_sym: CompactOp
    der2nd: CompactOp
    der2nd_sym: CompactOp
    stagder_v2p: CompactOp
    stagder_p2v: CompactOp
    interpl_v2p: CompactOp
    interpl_p2v: CompactOp


def build_axis_ops(mesh: Mesh, axis: int, *, der1st_scheme="compact6",
                   der2nd_scheme="compact6", interpl_scheme="classic",
                   stagder_scheme="compact6", c_nu=0.44, nu0_nu=None,
                   dtype=torch.float32, device=None) -> AxisOps:
    device = resolve_device(device)
    g = mesh.geo[axis]
    bc_start, bc_end = mesh.BCs[axis]
    # spectral Poisson pressure grid requires Neumann-compatible midpoint ops
    bc_mp_start = BC.NEUMANN if bc_start == BC.DIRICHLET else bc_start
    bc_mp_end = BC.NEUMANN if bc_end == BC.DIRICHLET else bc_end
    n_vert, n_cell, d = g.n_vert, g.n_cell, g.d

    hv = {}
    if der2nd_scheme == "compact6-hyperviscous":
        hv = dict(c_nu=c_nu, nu0_nu=nu0_nu)
    kw = dict(dtype=dtype, device=device)

    return AxisOps(
        axis=axis,
        der1st=build_op(
            "first-deriv", n_vert, d, der1st_scheme, bc_start, bc_end,
            stretch=g.vert_ds, **kw),
        der1st_sym=build_op(
            "first-deriv", n_vert, d, der1st_scheme, bc_start, bc_end,
            sym=True, stretch=g.vert_ds, **kw),
        der2nd=build_op(
            "second-deriv", n_vert, d, der2nd_scheme, bc_start, bc_end,
            stretch=g.vert_ds2, stretch_correct=g.vert_d2s, **kw, **hv),
        der2nd_sym=build_op(
            "second-deriv", n_vert, d, der2nd_scheme, bc_start, bc_end,
            sym=True, stretch=g.vert_ds2, stretch_correct=g.vert_d2s,
            **kw, **hv),
        stagder_v2p=build_op(
            "stag-deriv", n_cell, d, stagder_scheme, bc_mp_start, bc_mp_end,
            from_to="v2p", stretch=g.midp_ds, **kw),
        stagder_p2v=build_op(
            "stag-deriv", n_vert, d, stagder_scheme, bc_mp_start, bc_mp_end,
            from_to="p2v", stretch=g.vert_ds, **kw),
        interpl_v2p=build_op(
            "interpolate", n_cell, d, interpl_scheme, bc_mp_start, bc_mp_end,
            from_to="v2p", **kw),
        interpl_p2v=build_op(
            "interpolate", n_vert, d, interpl_scheme, bc_mp_start, bc_mp_end,
            from_to="p2v", **kw),
    )


def build_all_ops(mesh: Mesh, device=None, **kw) -> tuple[AxisOps, AxisOps,
                                                            AxisOps]:
    device = resolve_device(device)
    return tuple(build_axis_ops(mesh, a, device=device, **kw)
                 for a in range(3))
