"""Derived-field computation for output: vorticity magnitude, Q-criterion,
vertex-interpolated pressure.

Counterpart of x3d2_tpu.postprocess (reference
src/postprocess/postprocess.f90: all-9 velocity-gradient computation ->
vorticity/Q kernels, compute_derived_fields:21-164; pressure CELL->VERT
interpolation with the 1/dt rescale, compute_pressure_vert:166-197). The
operators are the solver's (``solver.ops[axis]``) applied as plain
PyTorch on the fields' device: x3d2_tpu runs these in XLA, with no Pallas
kernel.
"""

from __future__ import annotations

import torch


def velocity_gradients(solver, u, v, w):
    """All nine velocity gradients at vertices. The reference pairs
    sym/antisym der1st per component exactly as transeq does
    (postprocess.f90:21-164): aligned components use der1st, transverse
    use der1st_sym."""
    g = {}
    comps = {"u": u, "v": v, "w": w}
    for ax, axname in enumerate("xyz"):
        o = solver.ops[ax]
        for ic, cname in enumerate("uvw"):
            op = o.der1st if ic == ax else o.der1st_sym
            g[f"d{cname}d{axname}"] = op(comps[cname], ax)
    return g


def vorticity_magnitude(g):
    """|curl u| from gradients (fieldops.f90:119-142)."""
    wx = g["dwdy"] - g["dvdz"]
    wy = g["dudz"] - g["dwdx"]
    wz = g["dvdx"] - g["dudy"]
    return torch.sqrt(wx * wx + wy * wy + wz * wz)


def q_criterion(g):
    """Q = -0.5*(dudx^2+dvdy^2+dwdz^2) - dudy*dvdx - dudz*dwdx - dvdz*dwdy
    (fieldops.f90:144-168)."""
    return (-0.5 * (g["dudx"] ** 2 + g["dvdy"] ** 2 + g["dwdz"] ** 2)
            - g["dudy"] * g["dvdx"] - g["dudz"] * g["dwdx"]
            - g["dvdz"] * g["dwdy"])


@torch.no_grad()
def pressure_vert(solver, p, dt):
    """Interpolate the CELL pseudo-pressure to vertices and rescale by 1/dt
    to physical pressure (postprocess.f90:166-197). Sweep order z->y->x
    mirrors vector_calculus interpl_c2v (vector_calculus.f90:334-378)."""
    ox, oy, oz = solver.ops
    pz = oz.interpl_p2v(p, 2)
    py = oy.interpl_p2v(pz, 1)
    pv = ox.interpl_p2v(py, 0)
    return pv / dt


def make_derived_fields_fn(solver, dt, want=("vort", "qcrit")):
    """fn(u, v, w, p=None) -> {name: field} for the names of `want` among
    vort, qcrit, pressure."""
    @torch.no_grad()
    def fn(u, v, w, p=None):
        out = {}
        if "vort" in want or "qcrit" in want:
            g = velocity_gradients(solver, u, v, w)
            if "vort" in want:
                out["vort"] = vorticity_magnitude(g)
            if "qcrit" in want:
                out["qcrit"] = q_criterion(g)
        if "pressure" in want and p is not None:
            out["pressure"] = pressure_vert(solver, p, dt)
        return out

    return fn
