"""What the two kernel projections share: the parity splits, the banded and
parity applies in plain PyTorch, the solve factor, and the operator set.

Both projections of the port, the three-stage pipeline (pressure_pipe.py)
and the slab projection (pressure_slab.py), factor the same chain
(x3d2_tpu.ops.pallas_poisson): the y interpolation and staggered
derivative band-truncated per block of 64 rows (ops/banded.py, W=32), the
periodic transforms as parity splits (one radix-2 level in matrix form,
half the operations), spectral indices in block-parity order [even modes;
odd modes] with the solve tables permuted to match. They differ only in
the order of the stages, so they consume one operator set,
``ProjectionMats``, built once per solver. The operators are f32 on the
card (no bf16 hi/lo splits: those worked around the TPU matrix unit).

The gates mirror x3d2_tpu's: the slab where slab_pressure_supported's
structural conditions hold (a wall-bounded x axis among them: its x stage
is then the dense transform-folded x apply, x_perm None, and the Poisson
variant may zero a Nyquist line), the pipeline inside that where
pipe3_supported holds (every axis periodic). The kernels serve every
extent those gates admit; the stage forms (``Forms``) are the ones
x3d2_tpu's slab takes on the grid, the transform-folded dense y among them
where y is not banded.

With X3D2_BFLY=0 x3d2_tpu's slab keeps its transforms dense
(make_pressure_slab, pallas_poisson.py:588-635, :657-708): one dense
Ty = real_dft_matrix(ny) and its inverse around the banded y applies, the
dense transform-folded z matrices, the dense x stage, and q in natural
order on every axis (``dense=True`` here: x_perm, q_perm and z_perm None).
Its pipeline keeps the parity splits whatever the switch
(pallas_poisson.py:1593-1604), so a grid with both builds both sets.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..common import DataLoc
from .banded import banded_blocks
from .compact import apply_matrix
from .matmul_poisson import MatmulPoisson, real_dft_matrix

BW = 32                # band half-width of the y operators
BBS = 64               # banded block (rows per output block)
WIN = BBS + 2 * BW     # band window
TILE = 128             # the kernel's output and column tile
# at W=32 the uniform compact interpolation and staggered derivative drop
# entries below 1e-15 of their largest: the band is exact to float64
# rounding (W=16, the TPU's bf16x3 choice, drops 1e-7)
_BAND_TOL = 1e-12
_EPS = 1e-16           # zero-wave guard, as matmul_poisson._EPS


# ---------------------------------------------------------------------------
# parity splits (numpy, float64)
# ---------------------------------------------------------------------------

def parity_split(n):
    """Split of the real DFT T = real_dft_matrix(n) by output parity: with
    h = n/2, Te = T[0::2, :h] and To = T[1::2, :h],

        T x = [Te (x1 + x2); To (x1 - x2)]   (rows in block-parity order)

    and, from row orthogonality, Ti y = [a + b; a - b] with a = Te^T z_e,
    b = To^T z_o, z = w * y. Returns (Te, To, w); raises if the symmetry
    does not hold."""
    h = n // 2
    T = real_dft_matrix(n)
    if (np.abs(T[0::2, :h] - T[0::2, h:]).max() > 1e-9
            or np.abs(T[1::2, :h] + T[1::2, h:]).max() > 1e-9):
        raise ValueError("transform lacks the parity column symmetry")
    TTt = T @ T.T
    if np.abs(TTt - np.diag(np.diag(TTt))).max() > 1e-9 * n:
        raise ValueError("transform rows not orthogonal")
    return T[0::2, :h].copy(), T[1::2, :h].copy(), 1.0 / np.diag(TTt)


def parity_split_folded(M, axis):
    """Parity split of a transform-folded matrix on a periodic axis.

    axis=0 (forward-folded, M = T @ Op): M x = [Me (x1 + x2); Mo (x1 - x2)]
    with Me = M[0::2, :h], Mo = M[1::2, :h], h = n_in/2.
    axis=1 (inverse-folded, M = Op @ Ti): M z = [a + b; a - b] with
    a = Me z_e, b = Mo z_o, Me = M[:h, 0::2], Mo = M[:h, 1::2], h = n_out/2,
    z in block-parity mode order.

    Returns (Me, Mo); raises when the symmetry does not hold."""
    n0, n1 = M.shape
    tol = 1e-9 * np.abs(M).max()
    if axis == 0:
        h = n1 // 2
        if (np.abs(M[0::2, :h] - M[0::2, h:]).max() > tol
                or np.abs(M[1::2, :h] + M[1::2, h:]).max() > tol):
            raise ValueError("no forward parity symmetry")
        return M[0::2, :h].copy(), M[1::2, :h].copy()
    h = n0 // 2
    if (np.abs(M[:h, 0::2] - M[h:, 0::2]).max() > tol
            or np.abs(M[:h, 1::2] + M[h:, 1::2]).max() > tol):
        raise ValueError("no inverse parity symmetry")
    return M[:h, 0::2].copy(), M[:h, 1::2].copy()


def parity_perm(n):
    """Natural index of each block-parity slot: [0, 2, ...; 1, 3, ...]."""
    return np.concatenate([np.arange(0, n, 2), np.arange(1, n, 2)])


# ---------------------------------------------------------------------------
# operators
# ---------------------------------------------------------------------------

def slab_supported(solver) -> bool:
    """Counterpart of x3d2_tpu slab_pressure_supported (pallas_poisson.py:
    515-534), its structural conditions: the uniform spectral Poisson
    solve, and the VERT and CELL y extents multiples of 8, the z extents
    multiples of 128, both CELL extents at least 128. Any axis may be
    wall-bounded (folded). The TPU's VMEM-footprint test has no counterpart
    here: it is a limit of the TPU's scoped memory."""
    po = solver.poisson
    if not isinstance(po, MatmulPoisson) or po.stretch_solver is not None:
        return False
    _, ncy, ncz = po.nc
    _, nvy, nvz = solver.mesh.dims(DataLoc.VERT)
    return (ncy % 8 == 0 and nvy % 8 == 0 and ncz % TILE == 0
            and nvz % TILE == 0 and min(ncy, ncz) >= TILE)


def pipe3_supported(solver) -> bool:
    """Counterpart of x3d2_tpu pipe3_supported (pallas_poisson.py:
    1555-1570): a slab grid with every axis periodic, extents multiples of
    16 (y of 64) and a square y interpolation."""
    if not slab_supported(solver) or solver.poisson.folded:
        return False
    nx, ny, nz = solver.poisson.nc
    oy = solver.ops[1]
    return (tuple(solver.mesh.dims(DataLoc.VERT)) == (nx, ny, nz)
            and nx % 16 == 0 and ny % 16 == 0 and nz % 16 == 0
            and ny % 64 == 0
            and oy.interpl_v2p.n_out == oy.interpl_v2p.n_in)


def x_is_parity(solver) -> bool:
    """Whether the slab's x stage is the parity split (x3d2_tpu
    make_pressure_slab, pallas_poisson.py:681-708: it takes the split where
    the transform-folded x matrices have the half-period symmetry, which a
    periodic x axis of even extent gives, unless X3D2_BFLY is "0") rather
    than the dense x applies (``x_perm`` None there)."""
    d64 = solver._fp_mats64()
    try:
        for name in ("sx", "ix"):
            if d64[name].shape[1] % 2 or d64[name].shape[0] % 2:
                raise ValueError("odd extent")
            parity_split_folded(d64[name], 0)
        for name in ("gx_s", "gx_i"):
            parity_split_folded(d64[name], 1)
    except ValueError:
        return False
    return True


def slab_gap(solver) -> str | None:
    """Why the port's slab kernels cannot serve a grid x3d2_tpu's slab
    gate admits, or None when they can. The port has every branch the gate
    reaches, at every extent it admits (the template's general instance
    takes the extents its 128-tiled one does not): banded y with the parity
    or dense y transforms, the transform-folded dense y of a periodic y
    not tiled by 64, the parity or dense z transforms, and both x stages.
    A wall-bounded y or z is named: no gate of x3d2_tpu reaches it (there
    n_cell = n_vert - 1, so the CELL and VERT extents are never both
    multiples of 8 along y, nor of 128 along z), and its branches,
    _div_solve_body / _grad_body's folded y and dense z
    (x3d2_tpu/ops/pallas_poisson.py:238-241, :307-310), are reached by no
    path of x3d2_tpu; the port's slab builds there when called directly
    (build_projection_mats). The y/z-tiled mid of the sharded projection
    serves every plane its gate admits (pressure_slab.tiled_geometry). The
    transforms kept dense (X3D2_BFLY=0) are served alike."""
    po = solver.poisson
    if 1 in po.folded or 2 in po.folded:
        return ("a wall-bounded y or z on x3d2_tpu's slab gate, which no "
                "gate of x3d2_tpu admits (n_cell = n_vert - 1 along a "
                "wall-bounded axis); the port's slab builds there when "
                "called directly (parity.build_projection_mats)")
    return None


def projection_supported(solver) -> bool:
    """The grids the port's kernel projections serve: x3d2_tpu's slab gate
    holds (slab_supported) and nothing of it is left to port (slab_gap)."""
    return slab_supported(solver) and slab_gap(solver) is None


@dataclass(frozen=True)
class Forms:
    """The mid's y and z stage forms, as x3d2_tpu's make_pressure_slab
    chooses them (pallas_poisson.py:565-603): y "parity" (banded y and the
    parity-split Ty: banded_y and bfly), "dense" (banded y and the dense
    Ty: banded_y, X3D2_BFLY=0) or "folded" (the transform-folded dense iy,
    sy and gy_i, gy_s: not banded_y, a wall-bounded y or a periodic one
    not tiled by 64); z "parity" (bfz) or "dense"."""

    y: str = "parity"
    z: str = "parity"


@dataclass
class ProjectionMats:
    """The projections' operators as float64 numpy masters, with device
    copies per dtype, in the forms ``forms`` names. The y stage: banded
    (stacked (n, WIN) blocks) biy, bsy (divergence), bgiy, bgsy (gradient),
    with the forward y transform ty and the inverse tyi (its row weights
    folded in), as parity stacks [Me; Mo] (y "parity") or dense (y
    "dense"); or (y "folded") the transform-folded dense iy, sy (ncy, nvy)
    and gyi, gys (nvy, ncy). The z stage: iz, sz (forward) and gzi, gzs
    (inverse), parity stacks or dense (ncz, nvz) and (nvz, ncz). The x
    stage: sx, ix (forward) and gxs, gxi (inverse), parity stacks on a
    periodic x, else the dense transform-folded matrices (x_perm None).
    ``dense`` (X3D2_BFLY=0): every transform dense, as in x3d2_tpu. Solve
    tables (in q's mode order): tab_a, tab_b per (y, z) cell column, k2x,
    tx2 per x mode; where the Poisson variant zeros a Nyquist line, its
    indicators myz per (y, z) column and mx per x mode (q is multiplied by
    1 - mx myz). Inverse transforms with columns in the order of q's modes,
    for the physical pressure: ti_x, ti_y, ti_z. x_perm, q_perm, z_perm
    give the natural mode of each slot along x, y, z (None: natural
    order). shape: the CELL extents (q's); vert: the VERT ones (the
    fields'). y64: with the banded y, the y axis' Iy, Sy (forward) and
    Giy, Gsy (inverse) whole, (ny, ny) float64, from which the pipeline
    folds the banded y into its y transforms (ops/pressure_pipe.py
    fold_y; its folded and packed operators are kept in _fold, made
    once)."""

    shape: tuple
    m64: dict
    device: torch.device
    x_perm: np.ndarray | None
    q_perm: np.ndarray | None
    z_perm: np.ndarray | None
    dense: bool = False
    forms: Forms = Forms()
    vert: tuple | None = None
    y64: dict | None = None
    _dev: dict = field(default_factory=dict)
    _packed: dict = field(default_factory=dict)
    _fold: dict = field(default_factory=dict)

    def mats(self, dtype) -> dict:
        if dtype not in self._dev:
            self._dev[dtype] = {
                k: torch.as_tensor(M, dtype=dtype, device=self.device)
                .contiguous() for k, M in self.m64.items()}
        return self._dev[dtype]

    def packed_x(self, name):
        """The x operator `name` (sx, ix, gxs, gxi) split and packed for
        the x-apply kernel (ops/x_apply_manual.py pack, from its float32
        copy), made once: dense, or on a periodic x (x_perm) the parity
        stack [Me; Mo] in its parity form (sx, ix forward; gxs, gxi
        inverse)."""
        if name not in self._packed:
            from .x_apply_manual import DENSE, FWD, INV, pack

            form = DENSE if self.x_perm is None else (
                FWD if name in ("sx", "ix") else INV)
            self._packed[name] = pack(self.mats(torch.float32)[name], form)
        return self._packed[name]


def build_projection_mats(solver, dense=False) -> ProjectionMats:
    """The projections' operators from the solver (x3d2_tpu
    make_pressure_pipe3, pallas_poisson.py:1584-1680, and
    make_pressure_slab, :553-708, :919-936), in the forms x3d2_tpu's slab
    takes on the grid (``Forms``): banded y where y is periodic with
    ny % 64 == 0 and a square interpolation, with the parity y transform
    unless ``dense`` (X3D2_BFLY=0), else the transform-folded dense y; the
    parity z transforms on a periodic z unless ``dense``; the parity x
    stage where the folded x matrices have the half-period symmetry unless
    ``dense``. Any extents, and any boundary conditions of the uniform
    spectral Poisson solve (a wall-bounded y or z, which no x3d2_tpu gate
    reaches, takes the folded y and the dense z); a y operator wider than
    the band at its truncation tolerance takes the folded y, as in
    x3d2_tpu. Raises ValueError on another Poisson solver."""
    po = solver.poisson
    if not isinstance(po, MatmulPoisson) or po.stretch_solver is not None:
        raise ValueError("the projections' operator set needs the uniform "
                         "spectral Poisson solve")
    d64 = solver._fp_mats64()
    oy = solver.ops[1]
    nx, ny, nz = po.nc
    vert = tuple(solver.mesh.dims(DataLoc.VERT))

    def band(op):
        return banded_blocks(op, BW, BBS, tol=_BAND_TOL).reshape(-1, WIN)

    def fwd(M):
        return np.concatenate(parity_split_folded(M, 0))

    def inv(M):
        return np.concatenate(parity_split_folded(M, 1))

    banded_y = (1 not in po.folded and vert[1] == ny and ny % BBS == 0
                and oy.interpl_v2p.n_out == oy.interpl_v2p.n_in)
    bands = {}
    if banded_y:
        # x3d2_tpu takes the folded y where the band check fails
        # (pallas_poisson.py:580-587); the port's check is the stricter
        # (W = 32 at 1e-12 against x3d2_tpu's 1e-6), so the port takes it
        # wherever x3d2_tpu does
        y_ops = (("iy", "biy", oy.interpl_v2p), ("sy", "bsy", oy.stagder_v2p),
                 ("giy", "bgiy", oy.interpl_p2v),
                 ("gsy", "bgsy", oy.stagder_p2v))
        try:
            bands = {k: band(op) for _, k, op in y_ops}
        except ValueError:
            banded_y = False
    y_form = "folded"
    if banded_y:
        y_form = "dense"
        if not dense and ny % 16 == 0:
            try:
                te, to, wvec = parity_split(ny)
                y_form = "parity"
            except ValueError:
                pass
    z_form = "dense"
    if not dense and 2 not in po.folded and vert[2] == nz and nz % 16 == 0:
        try:
            z = {k: f(d64[k]) for k, f in (("iz", fwd), ("sz", fwd),
                                           ("gz_i", inv), ("gz_s", inv))}
            z_form = "parity"
        except ValueError:
            pass
    xp = None if dense or not x_is_parity(solver) else parity_perm(nx)
    xo = xp if xp is not None else np.arange(nx)
    yp = parity_perm(ny) if y_form == "parity" else None
    zp = parity_perm(nz) if z_form == "parity" else None
    yo = yp if yp is not None else np.arange(ny)
    zo = zp if zp is not None else np.arange(nz)
    ti = [np.asarray(T, np.float64) for T in po.Ti64]
    m = {}
    if y_form == "folded":
        # x3d2_tpu's non-banded y (pallas_poisson.py:631-633): the
        # transform-folded matrices, the stacked gy_is as its two halves
        m.update(iy=d64["iy"], sy=d64["sy"], gyi=d64["gy_i"],
                 gys=d64["gy_s"])
    else:
        m.update(bands)
    if y_form == "parity":
        h = ny // 2
        w_perm = np.concatenate([wvec[0::2], wvec[1::2]])
        m.update(ty=np.concatenate([te, to]),
                 tyi=np.concatenate([te.T * w_perm[None, :h],
                                     to.T * w_perm[None, h:]]))
    elif y_form == "dense":
        # x3d2_tpu's banded y without the butterfly (pallas_poisson.py:
        # 627-630): Ty = real_dft_matrix(ny) and its inverse
        m.update(ty=po.Tf64[1], tyi=np.linalg.inv(po.Tf64[1]))
    if z_form == "parity":
        m.update(iz=z["iz"], sz=z["sz"], gzi=z["gz_i"], gzs=z["gz_s"])
    else:
        m.update(iz=d64["iz"], sz=d64["sz"], gzi=d64["gz_i"],
                 gzs=d64["gz_s"])
    m.update(tab_a=np.asarray(po.tab_A)[yo][:, zo].reshape(-1),
             tab_b=np.asarray(po.tab_B)[yo][:, zo].reshape(-1),
             k2x=po.k2_1d[0][xo], tx2=(po.T_1d[0] ** 2)[xo],
             ti_x=ti[0][:, xo], ti_y=ti[1][:, yo], ti_z=ti[2][:, zo])
    if xp is not None:
        m.update(sx=fwd(d64["sx"]), ix=fwd(d64["ix"]),
                 gxs=inv(d64["gx_s"]), gxi=inv(d64["gx_i"]))
    else:
        m.update(sx=d64["sx"], ix=d64["ix"], gxs=d64["gx_s"],
                 gxi=d64["gx_i"])
    if po._zero_idx is not None:
        # the Nyquist-line indicators of x3d2_tpu (pallas_poisson.py:
        # 641-656): the zeroed set is the intersection of the named axes'
        # Nyquist indices
        ind = [np.ones(n) if a not in po._zero_idx
               else (np.arange(n) == n // 2).astype(np.float64)
               for a, n in enumerate((nx, ny, nz))]
        m["mx"] = ind[0][xo]
        m["myz"] = np.outer(ind[1][yo], ind[2][zo]).reshape(-1)
    y64 = ({k: np.asarray(op.M64, np.float64) for k, _, op in y_ops}
           if banded_y else None)
    return ProjectionMats(shape=(nx, ny, nz), m64=m, device=solver.device,
                          x_perm=xp, q_perm=yp, z_perm=zp, dense=dense,
                          forms=Forms(y_form, z_form), vert=vert, y64=y64)


# ---------------------------------------------------------------------------
# plain PyTorch applies
# ---------------------------------------------------------------------------

def banded_apply(Wst, f, axis):
    """Block-banded apply along `axis` (periodic window per block)."""
    n = f.shape[axis]
    nb = n // BBS
    k = torch.arange(WIN, device=f.device)
    b = torch.arange(nb, device=f.device)
    idx = (b[:, None] * BBS - BW + k[None, :]) % n
    fm = f.movedim(axis, 0)
    rest = fm.shape[1:]
    win = fm.reshape(n, -1)[idx]                       # (nb, WIN, lines)
    out = torch.bmm(Wst.reshape(nb, BBS, WIN), win)    # (nb, BBS, lines)
    return out.reshape((n,) + rest).movedim(0, axis)


def pfwd(Mst, f, axis):
    """Forward parity apply: [Me (f1 + f2); Mo (f1 - f2)] along `axis`."""
    h = f.shape[axis] // 2
    ho = Mst.shape[0] // 2
    f1, f2 = f.narrow(axis, 0, h), f.narrow(axis, h, h)
    return torch.cat([apply_matrix(Mst[:ho], f1 + f2, axis),
                      apply_matrix(Mst[ho:], f1 - f2, axis)], axis)


def pinv(Mst, f, axis):
    """Inverse parity apply: [a + b; a - b], a = Me f_e, b = Mo f_o."""
    h = Mst.shape[0] // 2
    a = apply_matrix(Mst[:h], f.narrow(axis, 0, h), axis)
    b = apply_matrix(Mst[h:], f.narrow(axis, h, h), axis)
    return torch.cat([a + b, a - b], axis)


def solve_factor(m, shape):
    """-1/waves with the zero-wave guard, from the separable tables, as an
    (nx, ny, nz) field in the order of q's modes; times 1 - mx myz where
    the Poisson variant zeros a Nyquist line (x3d2_tpu's mask,
    pallas_poisson.py:641-656)."""
    waves = (m["k2x"][:, None] * m["tab_a"][None, :]
             + m["tx2"][:, None] * m["tab_b"][None, :])
    ok = waves.abs() >= _EPS
    inv = torch.where(ok, -1.0 / torch.where(ok, waves, 1.0), 0.0)
    if "myz" in m:
        inv = inv * (1.0 - m["mx"][:, None] * m["myz"][None, :])
    return inv.reshape(shape)
