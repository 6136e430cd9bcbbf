"""The slab projection: the x-first factoring of the pressure projection,
which also forms the spectral solution q (and from it the physical
pressure) and takes pre-transformed divergence inputs from the xdiv sweep.
The wrappers launch the Hopper operator-apply kernel of
``csrc/pressure_pipe.cu`` (the tiled mid's, those of
``csrc/pressure_mid_tiled.cu``; the one-field x applies', dense and
parity, the split-TF32 x-apply kernel of ``csrc/x_apply_manual.cu``, its
operators packed once per ProjectionMats); the plain PyTorch versions are
beside them.

Counterpart of x3d2_tpu.ops.pallas_poisson.make_pressure_slab
(pallas_poisson.py:553) with make_x_div3 (:1150) and make_x_gradsub3
(:1203), and of their kernels:

    x_div3       _x_parity_fwd3_kernel (:1067)
                 u, v, w -> du = Sx u, dv = Ix v, dw = Ix w
    pressure_mid _pressure_mid_kernel (:354; _div_solve_body :189 and
                 _grad_body :257)
                 du, dv, dw -> [q,] p_zy, dpdy, dpdz per x plane:
                 duv = Iy du + Sy dv, dwm = Iy dw (banded);
                 F = Ty (Iz duv + Sz dwm); q = -F / waves;
                 p_z = Gzi q, dpdz_s = Gzs q; GH = Ti_y [p_z, dpdz_s];
                 p_zy = Giy GH1, dpdy = Gsy GH1, dpdz = Giy GH2
    div_solve    _div_solve_kernel (:327; call :725): the mid's first half,
                 du, dv, dw -> q (X3D2_MID_SPLIT=1, x3d2_tpu solver.py:
                 512-518)
    grad         _grad_kernel (:340; call :738): its second half,
                 q -> p_zy, dpdy, dpdz
    x_gradsub3   _x_parity_gradsub3_kernel (:1106)
                 u - Gxs p_zy, v - Gxi dpdy, w - Gxi dpdz
    x_apply      _x_apply_kernel (:954), make_x_apply (:1258): the dense x
                 stage of a wall-bounded x axis, one field a call, in
                 x3d2_tpu's six calls (solver.py:506-511, :550-555):
                 sx(u), ix(v), ix(w); then with the correction
                 u - gx_s p_zy, v - gx_i dpdy, w - gx_i dpdz; or without
                 it, gx_s p_zy, gx_i dpdy, gx_i dpdz (pressure_grads,
                 solver.py:441-457)
    x_apply_parity  _x_parity_fwd_kernel (:997), _x_parity_inv_kernel
                 (:1025), make_x_apply(parity=...) (:1258-1318): the
                 parity x stage one field a call, where x3d2_tpu takes it
                 (X3D2_MERGED_X=0: sx(u), ix(v), ix(w) and u - gx_s p_zy,
                 ...; and pressure_grads: gx_s p_zy, gx_i dpdy, gx_i dpdz)

Spectral indices are in block-parity order [even modes; odd modes] on
every axis with a parity split, as the TPU kernels keep them, and in
natural order elsewhere; the operator set is the one the pipeline uses
(ops/parity.py), in the stage forms x3d2_tpu's slab takes on the grid
(``parity.Forms``): banded y with the parity y and z transforms, or with
X3D2_BFLY=0 the dense forms (one dense Ty and its inverse, the dense z
matrices, q in natural order, pallas_poisson.py:206-243, :283-310), which
take twice the operations, with the same launches in the same order; and
where y is not banded (a periodic y not a multiple of 64, and a
wall-bounded y, which no gate of x3d2_tpu reaches) the folded y of
_div_solve_body / _grad_body (:238-241, :307-310): the transform-folded
dense iy, sy (ncy, nvy) in one two-source DENSE y launch (Iy du + Sy dv,
Iy dw), the z transforms with the solve in their epilogue, the inverse z
transforms, then gy_i, gy_s (nvy, ncy) in one DENSE y launch of three
jobs: four launches a mid (``stage_name``'s "folded_y"), two a half. Any
extent the gates admit (the template's general instance takes the tails).
The x stage is the parity split on a periodic x (x_div3, x_gradsub3) and
the dense x apply on a wall-bounded one (x_apply). The Nyquist mask of the
TPU kernel (q times 1 - mx Myz) is applied in the solve's epilogue where
the Poisson variant zeros a line (the cylinder's "100" with even ny and
nz: the (ny/2, nz/2) line on every x plane); elsewhere the operator set
carries no mask and the epilogue reads none.

A 512 x 512 plane is 1 MB against 227 KB of shared memory per block, so
the mid is not one whole-plane kernel as on the TPU but six launches of
the operator-apply template (four on the folded y), with the solve in the
epilogue of the forward y transform (of the z transforms on the folded
y); its intermediates, q among them, pass through device memory.
Without ``emit_q`` q is scratch the caller never sees, and the gradient
slabs are bit-identical to the ``emit_q`` call (the same launches). The
two halves (div_solve, grad) are the first three and the last three of
those launches, so the split gives the bits of the merged mid.

The local-batch mid (``make_mid_local``, x3d2_tpu make_mid_local,
pallas_poisson.py:780-937: the mid over one rank's batch of x planes in the
repencilled sharded projection, parallel/shard_kernels.py) is the same six
launches over nx_loc planes, with the solve's per-x-mode tables k2x, tx2
(and mx) passed at run time as that rank's slices, in the order of the x
stage's modes, counted as pressure_mid[q,local]. Its ``einsum`` (x3d2_tpu's
X3D2_EINSUM_MID=1 replay, XLA there) is the plain version on either device.
Its ``tiled`` is x3d2_tpu's y/z-tiled mid (make_mid_local.tiled,
pallas_poisson.py:850-909), which the repencilled projection takes where
whole (y, z) planes exceed the TPU's VMEM (``tiled_supported``; 1024^2
planes):

    pressure_mid[tiled,t1]  _mid_t1_kernel (:413; call :888)
                 a = Ty (Iy du + Sy dv), d = Ty (Iy dw)
    pressure_mid[tiled,t2]  _mid_t2_kernel (:430; call :894)
                 F = Iz a + Sz d; q = -F / waves; p_z = Gzi q,
                 dpdz_s = Gzs q
    pressure_mid[tiled,t3]  _mid_t3_kernel (:468; call :901)
                 GH = Ti_y [p_z | dpdz_s]; p_zy = Giy GH1,
                 dpdy = Gsy GH1, dpdz = Giy GH2

three launches of ``csrc/pressure_mid_tiled.cu`` (one kernel each, on
column tiles of all of y, or row tiles of all of z, held in shared
memory), the mid's results up to the reassociation of the y and z stages
(the forward y transform before the z ones).

A wrapper on CUDA tensors launches the kernel (or raises); on CPU tensors
it runs the plain version. All take the projections' operator set
(``parity.ProjectionMats``), which also carries the block-parity orderings
(x_perm, q_perm, z_perm) and the column-permuted inverse transforms (ti_x,
ti_y, ti_z) that turn q into the physical pressure.
"""

from __future__ import annotations

import ctypes
import os

import torch

from . import x_apply_manual as xm
from .compact import apply_matrix
from .operator_apply import (BANDED, DENSE, PFWD, PINV, SOLVE, SOLVE_PLANE,
                             SUB, apply, apply_dense, count_launch, route)
from .banded import banded_blocks
from .parity import (BBS, BW, WIN, Forms, ProjectionMats, banded_apply,
                     parity_split, parity_split_folded, pfwd, pinv,
                     solve_factor)

# x3d2_tpu's scoped-VMEM cap (pallas_transeq.py:39), which decides between
# its full-plane and its tiled mid; a TPU limit, read here only to take the
# branch x3d2_tpu takes
TPU_VMEM_CAP = 64 * 2 ** 20
_TPU_BAND_TOL = 1e-6        # x3d2_tpu's _BAND_TOL (pallas_kernels.py:143)


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def x_div3_plain(u, v, w, m):
    """(du, dv, dw): the forward x transforms of the divergence inputs."""
    return pfwd(m["sx"], u, 0), pfwd(m["ix"], v, 0), pfwd(m["ix"], w, 0)


def div_solve_plain(du, dv, dw, m, forms=Forms()):
    """q: the y and z divergence stages and the solve, in the stage forms
    ``forms`` (ProjectionMats.forms): banded y then the z transforms and
    the y transform (parity stacks or dense), or on the folded y the
    transform-folded y matrices then the z transforms."""
    fz = pfwd if forms.z == "parity" else apply_matrix
    if forms.y == "folded":
        duv = apply_matrix(m["iy"], du, 1) + apply_matrix(m["sy"], dv, 1)
        dwm = apply_matrix(m["iy"], dw, 1)
        F = fz(m["iz"], duv, 2) + fz(m["sz"], dwm, 2)
    else:
        fy = pfwd if forms.y == "parity" else apply_matrix
        duv = banded_apply(m["biy"], du, 1) + banded_apply(m["bsy"], dv, 1)
        dwm = banded_apply(m["biy"], dw, 1)
        F = fy(m["ty"], fz(m["iz"], duv, 2) + fz(m["sz"], dwm, 2), 1)
    return F * solve_factor(m, tuple(F.shape))


def grad_plain(q, m, forms=Forms()):
    """(p_zy, dpdy, dpdz): the z and y gradient stages (the x gradient
    stage follows in x_gradsub3 or the x applies), in the forms as
    div_solve_plain."""
    iz = pinv if forms.z == "parity" else apply_matrix
    if forms.y == "folded":
        pz, dz = iz(m["gzi"], q, 2), iz(m["gzs"], q, 2)
        return (apply_matrix(m["gyi"], pz, 1), apply_matrix(m["gys"], pz, 1),
                apply_matrix(m["gyi"], dz, 1))
    iy = pinv if forms.y == "parity" else apply_matrix
    gh1 = iy(m["tyi"], iz(m["gzi"], q, 2), 1)
    gh2 = iy(m["tyi"], iz(m["gzs"], q, 2), 1)
    return (banded_apply(m["bgiy"], gh1, 1), banded_apply(m["bgsy"], gh1, 1),
            banded_apply(m["bgiy"], gh2, 1))


def pressure_mid_plain(du, dv, dw, m, emit_q=True, forms=Forms()):
    """(q or None, p_zy, dpdy, dpdz): div_solve_plain, then grad_plain."""
    q = div_solve_plain(du, dv, dw, m, forms)
    return (q if emit_q else None,) + grad_plain(q, m, forms)


def mid_t1_plain(du, dv, dw, m):
    """(a, d): the tiled mid's y stage (_mid_t1_kernel), the banded y
    applies and the forward y transform of each field: a = Ty (Iy du +
    Sy dv), d = Ty (Iy dw)."""
    return (pfwd(m["ty"], banded_apply(m["biy"], du, 1)
                 + banded_apply(m["bsy"], dv, 1), 1),
            pfwd(m["ty"], banded_apply(m["biy"], dw, 1), 1))


def mid_t2_plain(a, d, m):
    """(q, p_z, dpdz_s): the tiled mid's z stage (_mid_t2_kernel), the
    forward z transforms F = Iz a + Sz d, the solve (m's tables: the
    planes' k2x, tx2 and mx) and the inverse z transforms of q."""
    q = (pfwd(m["iz"], a, 2) + pfwd(m["sz"], d, 2)) \
        * solve_factor(m, tuple(a.shape))
    return q, pinv(m["gzi"], q, 2), pinv(m["gzs"], q, 2)


def mid_t3_plain(pz, dz, m):
    """(p_zy, dpdy, dpdz): the tiled mid's last y stage (_mid_t3_kernel),
    the inverse y transform of each field and the banded y applies."""
    gh1, gh2 = pinv(m["tyi"], pz, 1), pinv(m["tyi"], dz, 1)
    return (banded_apply(m["bgiy"], gh1, 1), banded_apply(m["bgsy"], gh1, 1),
            banded_apply(m["bgiy"], gh2, 1))


def pressure_mid_tiled_plain(du, dv, dw, m):
    """(q, p_zy, dpdy, dpdz): the y/z-tiled mid in its stage order, the
    plain version of its three kernels (mid_t1_plain, mid_t2_plain,
    mid_t3_plain). The merged mid transforms along z before y; the results
    agree up to that reassociation."""
    q, pz, dz = mid_t2_plain(*mid_t1_plain(du, dv, dw, m), m)
    return (q,) + mid_t3_plain(pz, dz, m)


def x_gradsub3_plain(p_zy, dpdy, dpdz, u, v, w, m):
    """(u', v', w'): the inverse x transforms and the correction."""
    return (u - pinv(m["gxs"], p_zy, 0), v - pinv(m["gxi"], dpdy, 0),
            w - pinv(m["gxi"], dpdz, 0))


def x_apply_plain(M, f, s=None):
    """M f along x, or s - M f."""
    r = apply_matrix(M, f, 0)
    return r if s is None else s - r


# the parity form of each x-stage operator: forward (physical in, modes out
# in block-parity order) or inverse (modes in, physical out)
_PARITY_FORM = {"sx": PFWD, "ix": PFWD, "gxs": PINV, "gxi": PINV}


def x_apply_parity_plain(name, M, f, s=None):
    """The parity x apply of operator `name` ([Me; Mo] in M), or s minus
    the inverse one."""
    if _PARITY_FORM[name] == PFWD:
        if s is not None:
            raise ValueError("the correction is an inverse-stage fusion")
        return pfwd(M, f, 0)
    r = pinv(M, f, 0)
    return r if s is None else s - r


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _x_div3_cuda(u, v, w, m):
    du, dv, dw = (torch.empty_like(u) for _ in range(3))
    apply("x_div3", PFWD, 0, [([m["sx"]], [u], du, None),
                              ([m["ix"]], [v], dv, None),
                              ([m["ix"]], [w], dw, None)])
    return du, dv, dw


def _forms(pm):
    """The launch forms of the mid's y and z transforms: ((y forward, y
    inverse), (z forward, z inverse))."""
    return tuple((PFWD, PINV) if f == "parity" else (DENSE, DENSE)
                 for f in (pm.forms.y, pm.forms.z))


def _field(shape, like, scratch=None):
    """A field of `shape`: the first dead buffer of that shape in the
    list `scratch` (taken from it), else a new one like `like`."""
    for i, t in enumerate(scratch or ()):
        if tuple(t.shape) == tuple(shape):
            return scratch.pop(i)
    return torch.empty(shape, dtype=like.dtype, device=like.device)


def _div_solve_cuda(du, dv, dw, pm, m, name):
    """The mid's first launches: banded y, the z transforms, the y
    transform with the solve in its epilogue; on the folded y the dense y
    stage (two sources), then the z transforms with the solve in theirs.
    Returns (q, scratch): dead fields the second half may take."""
    (yf, _), (zf, _) = _forms(pm)
    nx, _, nvz = du.shape          # nx: the planes of this batch
    _, ncy, ncz = pm.shape
    mask = (m["myz"], m["mx"]) if "myz" in m else ()
    tabs = (m["tab_a"], m["tab_b"], m["k2x"], m["tx2"]) + mask
    if pm.forms.y == "folded":
        t = [_field((nx, ncy, nvz), du) for _ in range(2)]
        apply(name, DENSE, 1, [([m["iy"], m["sy"]], [du, dv], t[0], None),
                               ([m["iy"]], [dw], t[1], None)])
        q = _field((nx, ncy, ncz), du)
        apply(name, zf, 2, [([m["sz"], m["iz"]], [t[1], t[0]], q, None)],
              epi=SOLVE, tabs=tabs)
        return q, t
    t = [torch.empty_like(du) for _ in range(2)]
    apply(name, BANDED, 1, [([m["biy"], m["bsy"]], [du, dv], t[0], None),
                            ([m["biy"]], [dw], t[1], None)])
    z = _field((nx, ncy, ncz), du)
    apply(name, zf, 2, [([m["sz"], m["iz"]], [t[1], t[0]], z, None)])
    scratch = t[1:]
    q = t[0] if tuple(t[0].shape) == (nx, ncy, ncz) else _field(
        (nx, ncy, ncz), du)
    apply(name, yf, 1, [([m["ty"]], [z], q, None)], epi=SOLVE_PLANE,
          tabs=tabs)
    return q, scratch + [z]


def _grad_cuda(q, pm, m, name, scratch=None):
    """The mid's last launches: the inverse z transforms, the inverse y
    transform, banded y; on the folded y the inverse z transforms, then the
    dense y stage (three jobs). `scratch`: dead fields the results may
    take (a list, taken from)."""
    (_, yi), (_, zi) = _forms(pm)
    nx, ncy, _ = q.shape
    nvy, nvz = pm.vert[1:]
    scratch = list(scratch or ())
    pz, dz = (_field((nx, ncy, nvz), q, scratch) for _ in range(2))
    apply(name, zi, 2, [([m["gzi"]], [q], pz, None),
                        ([m["gzs"]], [q], dz, None)])
    if pm.forms.y == "folded":
        res = [_field((nx, nvy, nvz), q, scratch) for _ in range(3)]
        apply(name, DENSE, 1, [([m["gyi"]], [pz], res[0], None),
                               ([m["gys"]], [pz], res[1], None),
                               ([m["gyi"]], [dz], res[2], None)])
        return tuple(res)
    gh1, gh2 = torch.empty_like(pz), torch.empty_like(pz)
    apply(name, yi, 1, [([m["tyi"]], [pz], gh1, None),
                        ([m["tyi"]], [dz], gh2, None)])
    # p_z and dpdz_s are dead: two of the results take their buffers
    p_zy, dpdy, dpdz = pz, dz, torch.empty_like(pz)
    apply(name, BANDED, 1, [([m["bgiy"]], [gh1], p_zy, None),
                            ([m["bgsy"]], [gh1], dpdy, None),
                            ([m["bgiy"]], [gh2], dpdz, None)])
    return p_zy, dpdy, dpdz


def _pressure_mid_cuda(du, dv, dw, pm, emit_q, m=None, name=None):
    m = m if m is not None else pm.mats(torch.float32)
    name = name or stage_name("pressure_mid", pm, emit_q)
    q, scratch = _div_solve_cuda(du, dv, dw, pm, m, name)
    return ((q if emit_q else None),) + _grad_cuda(q, pm, m, name, scratch)


def _x_gradsub3_cuda(p_zy, dpdy, dpdz, u, v, w, m):
    un, vn, wn = (torch.empty_like(u) for _ in range(3))
    apply("x_gradsub3", PINV, 0, [([m["gxs"]], [p_zy], un, u),
                                  ([m["gxi"]], [dpdy], vn, v),
                                  ([m["gxi"]], [dpdz], wn, w)], epi=SUB)
    return un, vn, wn


def x_div3(u, v, w, pm: ProjectionMats):
    """(u, v, w) -> (du, dv, dw), x modes in block-parity order."""
    if route(u, "x_div3"):
        return _x_div3_cuda(u, v, w, pm.mats(torch.float32))
    return x_div3_plain(u, v, w, pm.mats(u.dtype))


def stage_name(base, pm: ProjectionMats, emit_q=False, local=False):
    """The launch-count name of a mid function over pm: pressure_mid,
    div_solve, grad, with "q" where the mid emits q, "dense" for the
    dense forms, "folded_y" on the folded y (4 launches a mid, not 6) and
    "local" over a local x batch (pressure_mid[q,dense],
    div_solve[dense], pressure_mid[q,folded_y], pressure_mid[q,local],
    ...)."""
    tags = (["q"] if emit_q else []) + (["dense"] if pm.dense else []) \
        + (["folded_y"] if pm.forms.y == "folded" else []) \
        + (["local"] if local else [])
    return base + (f"[{','.join(tags)}]" if tags else "")


def pressure_mid(du, dv, dw, pm: ProjectionMats, emit_q=True):
    """(du, dv, dw) -> (q or None, p_zy, dpdy, dpdz)."""
    if route(du, "pressure_mid"):
        return _pressure_mid_cuda(du, dv, dw, pm, emit_q)
    return pressure_mid_plain(du, dv, dw, pm.mats(du.dtype), emit_q,
                              pm.forms)


def div_solve(du, dv, dw, pm: ProjectionMats):
    """(du, dv, dw) -> q: the mid's first half (_div_solve_kernel),
    counted as div_solve (div_solve[dense] for the dense forms)."""
    if route(du, "div_solve"):
        return _div_solve_cuda(du, dv, dw, pm, pm.mats(torch.float32),
                               stage_name("div_solve", pm))[0]
    return div_solve_plain(du, dv, dw, pm.mats(du.dtype), pm.forms)


def grad(q, pm: ProjectionMats):
    """q -> (p_zy, dpdy, dpdz): the mid's second half (_grad_kernel),
    counted as grad (grad[dense] for the dense forms)."""
    if route(q, "grad"):
        return _grad_cuda(q, pm, pm.mats(torch.float32),
                          stage_name("grad", pm))
    return grad_plain(q, pm.mats(q.dtype), pm.forms)


def x_apply(name, f, pm: ProjectionMats, s=None):
    """The dense x stage: pm's operator `name` (sx, ix, gxs, gxi) applied
    along x of f, or s minus it. Counted as x_apply, x_apply[sub] with s."""
    if route(f, "x_apply"):
        op = pm.packed_x(name)
        out = torch.empty((op.n_out,) + tuple(f.shape[1:]), dtype=f.dtype,
                          device=f.device)
        apply_dense("x_apply" if s is None else "x_apply[sub]", op, f, out, s)
        return out
    return x_apply_plain(pm.mats(f.dtype)[name], f, s)


def x_apply_parity(name, f, pm: ProjectionMats, s=None):
    """The parity x stage, one field: pm's operator `name` applied along x
    of f as a parity split, forward (sx, ix: counted as x_pfwd) or inverse
    (gxs, gxi: x_pinv; s minus it with the subtracting epilogue,
    x_pinv[sub]), in one launch of the split-TF32 x-apply kernel
    (csrc/x_apply_manual.cu, counted in ops/x_apply_manual.py) on the
    operator's parity stack packed once (pm.packed_x)."""
    if pm.x_perm is None:
        raise ValueError("the parity x stage needs a periodic x (x_perm)")
    if _PARITY_FORM[name] == PFWD and s is not None:
        raise ValueError("the correction is an inverse-stage fusion")
    if route(f, "x_apply_parity"):
        stage = ("x_pfwd" if _PARITY_FORM[name] == PFWD
                 else "x_pinv" if s is None else "x_pinv[sub]")
        return xm.launch(stage, pm.packed_x(name), f, s)
    return x_apply_parity_plain(name, pm.mats(f.dtype)[name], f, s)


def x_gradsub3(p_zy, dpdy, dpdz, u, v, w, pm: ProjectionMats):
    """(p_zy, dpdy, dpdz, u, v, w) -> the corrected (u', v', w')."""
    if route(u, "x_gradsub3"):
        return _x_gradsub3_cuda(p_zy, dpdy, dpdz, u, v, w,
                                pm.mats(torch.float32))
    return x_gradsub3_plain(p_zy, dpdy, dpdz, u, v, w, pm.mats(u.dtype))


# ---------------------------------------------------------------------------
# the local-batch mid of the repencilled sharded projection
# ---------------------------------------------------------------------------

def tpu_slab_vmem_ok(solver, terms):
    """x3d2_tpu slab_pressure_supported's VMEM-footprint condition
    (pallas_poisson.py:535-550) at the mode's terms: the merged mid's
    planes, matrix parts, tables and scratch within the TPU's 64 MB cap.
    Where it fails, x3d2_tpu's repencilled projection takes its tiled mid."""
    from ..common import DataLoc
    ncx, ncy, ncz = solver.poisson.nc
    _, nvy, nvz = solver.mesh.dims(DataLoc.VERT)
    planes = 2 * 4 * (6 * nvy * nvz + ncy * ncz)
    mats = 2 * terms * (2 * ncy * nvy + 2 * ncz * nvz
                        + nvz * ncz + 2 * nvy * ncy)
    tables = 3 * 4 * ncy * ncz
    scratch = 4 * 4 * max(ncy * ncz, nvy * nvz)
    return planes + mats + tables + scratch <= TPU_VMEM_CAP


def tiled_mid_supported(solver, terms):
    """x3d2_tpu make_mid_local.tiled_supported (pallas_poisson.py:568-612,
    :833-848): banded y with the parity y and z transforms (periodic y and
    z, X3D2_BFLY not "0"), tiles that divide the plane, and its per-kernel
    VMEM estimate within the cap."""
    from ..common import DataLoc
    po = solver.poisson
    _, ny, nz = po.nc
    _, nvy, nvz = solver.mesh.dims(DataLoc.VERT)
    oy = solver.ops[1]
    bw, bbs = (32 if terms >= 3 else 16), 64
    flip = os.environ.get("X3D2_BFLY", "1") != "0"
    banded_y = (1 not in po.folded and nvy == ny and ny % bbs == 0
                and oy.interpl_v2p.n_out == oy.interpl_v2p.n_in)
    if banded_y:
        try:
            for op in (oy.interpl_v2p, oy.stagder_v2p, oy.interpl_p2v,
                       oy.stagder_p2v):
                banded_blocks(op, bw, bbs, tol=_TPU_BAND_TOL)
        except ValueError:
            banded_y = False
    bfly = banded_y and ny % 16 == 0 and flip
    if bfly:
        try:
            parity_split(ny)
        except ValueError:
            bfly = False
    bfz = 2 not in po.folded and nvz == nz and nz % 16 == 0 and flip
    if bfz:
        d64 = solver._fp_mats64()
        try:
            for k, a in (("iz", 0), ("sz", 0), ("gz_i", 1), ("gz_s", 1)):
                parity_split_folded(d64[k], a)
        except ValueError:
            bfz = False
    return (banded_y and bfly and bfz and nvy == ny and nvz == nz
            and tiled_vmem_ok(ny, nz, terms))


def tiled_vmem_ok(ny, nz, terms):
    """The plane part of x3d2_tpu's tiled gate (pallas_poisson.py:827-848):
    tiles that divide the (ny, nz) plane (y by 8 to 128, z by 128 or 256)
    and its per-kernel VMEM estimate, at the mode's band (16, or 32 at
    terms 3), within the TPU's 64 MB cap."""
    bw, bbs = (32 if terms >= 3 else 16), 64
    ty = next((t for t in (128, 64, 32, 16, 8) if ny % t == 0), None)
    tz = next((t for t in (256, 128) if nz % t == 0), None)
    if ty is None or tz is None:
        return False
    nb = ny // bbs
    by = 2 * terms * nb * bbs * (bbs + 2 * bw)
    tf = 2 * terms * (ny // 2) ** 2
    zp = 4 * terms * (nz // 2) ** 2
    gz = 2 * terms * nz * (nz // 2)
    v1 = 2 * 4 * 5 * ny * tz + 2 * (by + tf) + 6 * 4 * ny * tz
    v2 = (2 * 4 * 5 * ty * nz + 2 * (zp + gz) + 2 * 3 * 4 * ty * nz
          + 6 * 4 * ty * nz)
    v3 = 2 * 4 * 5 * ny * tz + 2 * (tf + by) + 6 * 4 * ny * tz
    return max(v1, v2, v3) <= TPU_VMEM_CAP


def local_tables(m, off, n):
    """The operator set m with the solve's per-x-mode tables cut to the x
    batch [off, off + n) (in the x stage's mode order)."""
    return _local_mats(m, m["k2x"][off:off + n], m["tx2"][off:off + n],
                       m["mx"][off:off + n] if "mx" in m else None)


def _local_mats(m, k2x, tx2, mx):
    """The operator set m with the solve's per-x-mode tables replaced by
    one x batch's slices."""
    lm = dict(m)
    lm["k2x"], lm["tx2"] = k2x, tx2
    if mx is not None:
        lm["mx"] = mx
    return lm


def _table(t):
    """A table slice as the kernel takes it: contiguous, 16-byte aligned."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def pressure_mid_local_plain(du, dv, dw, pm, k2x, tx2, mx=None):
    """(q, p_zy, dpdy, dpdz) of the mid over an x batch whose solve tables
    are the slices k2x, tx2 (mx)."""
    m = _local_mats(pm.mats(du.dtype), k2x.to(du.dtype), tx2.to(du.dtype),
                    None if mx is None else mx.to(du.dtype))
    return pressure_mid_plain(du, dv, dw, m, True, pm.forms)


def pressure_mid_local(du, dv, dw, pm: ProjectionMats, k2x, tx2, mx=None):
    """(du, dv, dw) over a batch of nx_loc x planes -> (q, p_zy, dpdy, dpdz):
    the mid (always with q, as x3d2_tpu's make_mid_local) with the batch's
    solve-table slices. Counted as pressure_mid[q,local] ([q,dense,local]
    for the dense forms)."""
    if route(du, "pressure_mid_local"):
        m = _local_mats(pm.mats(torch.float32), _table(k2x), _table(tx2),
                        None if mx is None else _table(mx))
        name = stage_name("pressure_mid", pm, True, local=True)
        return _pressure_mid_cuda(du, dv, dw, pm, True, m, name)
    return pressure_mid_local_plain(du, dv, dw, pm, k2x, tx2, mx)


# the launch-count names of the tiled mid's kernels, in launch order
TILED_STAGES = ("pressure_mid[tiled,t1]", "pressure_mid[tiled,t2]",
                "pressure_mid[tiled,t3]")
# csrc/pressure_mid_tiled.cu's forms: the wide one (two fields of 16
# columns or rows a block, the operators staged in shared memory) up to
# WIDE_MAXN points along the axis a kernel transforms, the long one (8 or
# 16 a block, the operators read from L2, transposed) past it; threads a
# block, and the shared memory a block may hold on the H100
WIDE_TC, WIDE_MAXN, TILED_NT = 16, 1024, 512
SMEM_MAX = 227 * 1024
_TILED_LIB = None


def tiled_geometry(stage, ny, nz) -> dict:
    """The launch of the tiled mid's kernel `stage` (1-3) on (ny, nz)
    planes: its form ("wide" or "long"), tc (columns of z a block for t1
    and t3, rows of y for t2; the long form's 16 where its threads' 4 rows
    of each half cover the transformed axis, else 8) and the shared memory
    in bytes (the long form's: the staged tile alone). Raises ValueError
    where no form serves the planes."""
    n = nz if stage == 2 else ny
    if ny % BBS or nz % WIDE_TC or ny < BBS:
        raise ValueError(f"the tiled mid takes y a multiple of {BBS} and z "
                         f"of {WIDE_TC}: got {ny} x {nz}")
    if n <= WIDE_MAXN:
        # the staged tile (two fields) and the operator's double-buffered
        # k-steps of 8 rows (a_stage_floats)
        tile = 2 * n * WIDE_TC
        geo = dict(form="wide", tc=WIDE_TC,
                   smem=4 * (tile + 2 * 8 * (n + 4)))
    else:
        fields = 2 if stage == 2 else 1
        for tc in (16, 8):
            smem = 4 * fields * n * tc
            if n // 2 <= TILED_NT * 4 // (tc // 8) and smem <= SMEM_MAX:
                break
        else:
            raise ValueError(f"no form of the tiled mid's t{stage} serves "
                             f"{n} points along {'z' if stage == 2 else 'y'}")
        geo = dict(form="long", tc=tc, smem=smem)
    if (ny if stage == 2 else nz) % geo["tc"]:
        raise ValueError(f"the tiled mid's t{stage} takes {geo['tc']}-point "
                         f"tiles along {'y' if stage == 2 else 'z'}: got "
                         f"{ny} x {nz}")
    return geo


def _tiled_lib():
    """The tiled mid's kernel library, built and typed at first use."""
    global _TILED_LIB
    if _TILED_LIB is None:
        from .. import _build

        so = _build.load("pressure_mid_tiled")
        i, p = ctypes.c_int, ctypes.c_void_p
        so.pressure_mid_tiled_launch.argtypes = [i, i, p, i, i, i, p]
        so.pressure_mid_tiled_launch.restype = i
        so.pressure_mid_tiled_error_string.argtypes = [i]
        so.pressure_mid_tiled_error_string.restype = ctypes.c_char_p
        so.pressure_mid_tiled_geometry.argtypes = [ctypes.POINTER(i)] * 5
        so.pressure_mid_tiled_geometry.restype = i
        geo = [i() for _ in range(5)]
        so.pressure_mid_tiled_geometry(*geo)
        geo = tuple(g.value for g in geo)
        want = (WIDE_TC, BW, BBS, WIDE_MAXN, TILED_NT)
        if geo != want:
            raise RuntimeError(f"pressure_mid_tiled.cu geometry {geo} "
                               f"differs from the wrapper's {want}")
        _TILED_LIB = so
    return _TILED_LIB


def _tap_major(pm: ProjectionMats):
    """The banded y operators (biy, bsy, bgiy, bgsy) as the tiled kernels
    read them: per 64-row block, tap-major, (ny / 64, 128, 64) float32."""
    key = "tap_major"
    if key not in pm._dev:
        m = pm.mats(torch.float32)
        pm._dev[key] = {k: m[k].reshape(-1, BBS, WIN).transpose(1, 2)
                        .contiguous() for k in ("biy", "bsy", "bgiy",
                                                "bgsy")}
    return pm._dev[key]


def _tiled_ops(pm: ProjectionMats, keys, geo):
    """The transforms `keys` of pm as the form of `geo` reads them: [Me;
    Mo] (n, n/2) for the wide form, transposed (n/2, n) for the long one
    (cached on pm)."""
    m = pm.mats(torch.float32)
    if geo["form"] == "wide":
        return [m[k] for k in keys]
    cache = pm._dev.setdefault("tiled_t", {})
    for k in keys:
        if k not in cache:
            cache[k] = m[k].t().contiguous()
    return [cache[k] for k in keys]


def _tiled_launch(stage, tensors, shape, geo):
    """One launch of the tiled mid's kernel `stage` (1-3) in the form of
    `geo` on float32 CUDA tensors (None: a null pointer), its error check
    and its count."""
    for t in tensors:
        if t is not None and (not t.is_cuda or t.dtype != torch.float32
                              or not t.is_contiguous()
                              or t.data_ptr() % 16):
            raise ValueError("the tiled mid takes contiguous, 16-byte "
                             "aligned float32 CUDA tensors")
    ptrs = (ctypes.c_void_p * len(tensors))(
        *[None if t is None else t.data_ptr() for t in tensors])
    dev = tensors[0].device
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _tiled_lib().pressure_mid_tiled_launch(
            stage, 0 if geo["form"] == "wide" else geo["tc"], ptrs, *shape,
            stream)
    if err != 0:
        msg = _tiled_lib().pressure_mid_tiled_error_string(err).decode()
        raise RuntimeError(f"pressure_mid_tiled launch {stage} failed: "
                           f"{msg} ({err})")
    count_launch(TILED_STAGES[stage - 1])


def _tiled_shape(t, stage):
    """The (nx_loc, ny, nz) of the tiled kernels' fields and the launch's
    geometry (tiled_geometry), checked."""
    shape = tuple(t.shape)
    return shape, tiled_geometry(stage, *shape[1:])


def _fields_of(shape, *fields):
    for t in fields:
        if tuple(t.shape) != shape:
            raise ValueError(f"fields of shape {shape}, got "
                             f"{tuple(t.shape)}")


def mid_tiled_t1(du, dv, dw, pm: ProjectionMats):
    """(du, dv, dw) -> (a, d): _mid_t1_kernel, one launch counted as
    pressure_mid[tiled,t1] (mid_t1_plain on CPU tensors)."""
    if not route(du, "mid_tiled_t1"):
        return mid_t1_plain(du, dv, dw, pm.mats(du.dtype))
    shape, geo = _tiled_shape(du, 1)
    _fields_of(shape, dv, dw)
    taps = _tap_major(pm)
    a, d = torch.empty_like(du), torch.empty_like(du)
    _tiled_launch(1, [du, dv, dw, taps["biy"], taps["bsy"]]
                  + _tiled_ops(pm, ("ty",), geo) + [a, d], shape, geo)
    return a, d


def mid_tiled_t2(a, d, pm: ProjectionMats, k2x, tx2, mx=None):
    """(a, d) -> (q, p_z, dpdz_s) with the x batch's table slices k2x, tx2
    (mx): _mid_t2_kernel, one launch counted as pressure_mid[tiled,t2]
    (mid_t2_plain on CPU tensors)."""
    if not route(a, "mid_tiled_t2"):
        m = _local_mats(pm.mats(a.dtype), k2x.to(a.dtype), tx2.to(a.dtype),
                        None if mx is None else mx.to(a.dtype))
        return mid_t2_plain(a, d, m)
    shape, geo = _tiled_shape(a, 2)
    _fields_of(shape, d)
    m = pm.mats(torch.float32)
    q, pz, dz = (torch.empty_like(a) for _ in range(3))
    _tiled_launch(2, [a, d] + _tiled_ops(pm, ("iz", "sz", "gzi", "gzs"), geo)
                  + [m["tab_a"], m["tab_b"], m.get("myz"), _table(k2x),
                     _table(tx2), None if mx is None else _table(mx), q, pz,
                     dz], shape, geo)
    return q, pz, dz


def mid_tiled_t3(pz, dz, pm: ProjectionMats, out=()):
    """(p_z, dpdz_s) -> (p_zy, dpdy, dpdz): _mid_t3_kernel, one launch
    counted as pressure_mid[tiled,t3] (mid_t3_plain on CPU tensors). out:
    up to three buffers of the fields' shape for the results (none may be
    p_z or dpdz_s)."""
    if not route(pz, "mid_tiled_t3"):
        return mid_t3_plain(pz, dz, pm.mats(pz.dtype))
    shape, geo = _tiled_shape(pz, 3)
    _fields_of(shape, dz, *out)
    res = list(out) + [torch.empty_like(pz) for _ in range(3 - len(out))]
    if {t.data_ptr() for t in res} & {pz.data_ptr(), dz.data_ptr()}:
        raise ValueError("the results may not alias p_z or dpdz_s")
    taps = _tap_major(pm)
    _tiled_launch(3, [pz, dz] + _tiled_ops(pm, ("tyi",), geo)
                  + [taps["bgiy"], taps["bgsy"]] + res, shape, geo)
    return tuple(res)


def pressure_mid_tiled_local_plain(du, dv, dw, pm, k2x, tx2, mx=None):
    """(q, p_zy, dpdy, dpdz) of the tiled mid over an x batch whose solve
    tables are the slices k2x, tx2 (mx)."""
    m = _local_mats(pm.mats(du.dtype), k2x.to(du.dtype), tx2.to(du.dtype),
                    None if mx is None else mx.to(du.dtype))
    return pressure_mid_tiled_plain(du, dv, dw, m)


def pressure_mid_tiled(du, dv, dw, pm: ProjectionMats, k2x, tx2, mx=None):
    """(du, dv, dw) over a batch of nx_loc x planes -> (q, p_zy, dpdy,
    dpdz): the y/z-tiled mid with the batch's solve-table slices, its three
    kernels (mid_tiled_t1, _t2, _t3) in turn. The parity forms only, as
    x3d2_tpu's tiled mid (not with X3D2_BFLY=0)."""
    if pm.forms != Forms():
        raise ValueError("the tiled mid takes the parity transforms")
    if not route(du, "pressure_mid_tiled"):
        return pressure_mid_tiled_local_plain(du, dv, dw, pm, k2x, tx2, mx)
    a, d = mid_tiled_t1(du, dv, dw, pm)
    q, pz, dz = mid_tiled_t2(a, d, pm, k2x, tx2, mx)
    # a and d are dead: two of the results take their buffers
    return (q,) + mid_tiled_t3(pz, dz, pm, out=(a, d))


def make_mid_local(solver, pm: ProjectionMats, terms=2):
    """Counterpart of x3d2_tpu make_pressure_slab(...)[4], make_mid_local
    (pallas_poisson.py:780-937): make_mid_local(nx_loc) ->
    mid_local(du, dv, dw, k2x_l, tx2_l, mx_l) -> (q, p_zy, dpdy, dpdz) over
    a local batch of nx_loc x planes (pressure_mid_local). Attributes as
    x3d2_tpu's: ``einsum(nx_loc)``, the plain replay (X3D2_EINSUM_MID=1; on
    either device, as x3d2_tpu runs XLA there); ``tiled(nx_loc)``, the
    y/z-tiled mid (pressure_mid_tiled; ValueError where x3d2_tpu has none:
    not ``tiled_supported``); ``tiled_supported``;
    ``tables``, the solve tables (tab_a, tab_b, myz, k2x, tx2, mx; myz and
    mx None without a Nyquist mask; at the solver's dtype), k2x, tx2 and mx
    in the x stage's mode order; ``ti_x``, ``ti_y``, ``ti_z``, the inverse transforms with
    columns in q's mode order."""

    def check(du, nx_loc):
        if du.shape[0] != nx_loc:
            raise ValueError(f"an x batch of {nx_loc} planes, got "
                             f"{du.shape[0]}")

    def make(nx_loc):
        def mid_local(du, dv, dw, k2x_l, tx2_l, mx_l=None):
            check(du, nx_loc)
            return pressure_mid_local(du, dv, dw, pm, k2x_l, tx2_l, mx_l)
        return mid_local

    def make_einsum(nx_loc):
        def mid_einsum(du, dv, dw, k2x_l, tx2_l, mx_l=None):
            check(du, nx_loc)
            return pressure_mid_local_plain(du, dv, dw, pm, k2x_l, tx2_l,
                                            mx_l)
        return mid_einsum

    def make_tiled(nx_loc):
        if not make.tiled_supported:
            raise ValueError("the tiled mid needs x3d2_tpu's fast path: "
                             "banded y with the parity y and z transforms "
                             "(tiled_mid_supported)")

        def mid_tiled(du, dv, dw, k2x_l, tx2_l, mx_l=None):
            check(du, nx_loc)
            return pressure_mid_tiled(du, dv, dw, pm, k2x_l, tx2_l, mx_l)
        return mid_tiled

    m = pm.mats(solver.dtype)
    make.einsum = make_einsum
    make.tiled = make_tiled
    make.tiled_supported = tiled_mid_supported(solver, terms)
    make.tables = (m["tab_a"], m["tab_b"], m.get("myz"), m["k2x"], m["tx2"],
                   m.get("mx"))
    make.ti_x, make.ti_y, make.ti_z = m["ti_x"], m["ti_y"], m["ti_z"]
    return make
