"""Three-stage pressure projection for ``keep_pressure=False``: the wrappers
of its Hopper kernels and their plain PyTorch versions.

Counterpart of x3d2_tpu.ops.pallas_poisson.make_pressure_pipe3
(pallas_poisson.py:1573) and its kernels:

    A  _pipe_a_kernel (:1378)  u, v, w -> a = Ty Iz Iy u,
                                          e = Ty (Iz Sy v + Sz Iy w)
    B  _pipe_b_kernel (:1405)  a, e    -> q = -(Sx a + Ix e) / waves,
                                          X = Gxs q, Y = Gxi q
    C  _pipe_c_kernel (:1455)  X, Y, u, v, w -> u - Giy Gzi X,
                                          v - Gsy Gzi Y, w - Giy Gzs Y
    C with d2=True (:1523-1552, built :1681-1718; X3D2_D2C=1): stage C and
       the carry, the next step's z transport partials of the corrected
       velocities, r = -1/2 (w' D1 q + D1d (q w')) + nu D2 q for q in
       (u', v', w') (pipe_c_d2; the carried step's chain skips its z sweep,
       ops/transeq_sweep.py make_fused_transeq_ab(skip_d2=True))

The plain versions are x3d2_tpu's: the y interpolation and staggered
derivative band-truncated per block of 64 rows (ops/banded.py, W=32); the
periodic transforms as parity splits (one radix-2 level in matrix form,
half the operations), so spectral indices stay in block-parity order [even
modes; odd modes] between the stages and the solve tables are permuted to
match. The operator set, the splits and the plain applies are shared with
the slab projection (ops/parity.py).

On the card the three stages are two launches each of the split-TF32
tensor-core kernel of ``csrc/x_apply_manual.cu`` (ops/x_apply_manual.py
launch_jobs): A and C a z launch (the transposed form, three jobs) and a y
launch (batched over the x planes); B two x launches, a FWD launch of one
two-source job with the solve in its epilogue (q = solve(Sx a + Ix e),
from the separable tables) and an INV launch of two jobs (Gxs q, Gxi q).
q goes through device memory: x3d2_tpu's kernel holds a (y, z) tile's
whole x extent, but an item's 128 columns of q's nx rows are 256 KB at
nx = 512, past a block's 227 KB. The banded y applies are folded into the y
transforms (``fold_y``): the y operators of every pipeline grid are
circulant (a periodic uniform y), and a circulant C commutes with the
half-period shift, C = [[C11, C12], [C12, C11]] in halves, so

    Ty C = [Me (C11 + C12); Mo (C11 - C12)]   (a forward parity operator)
    C pinv(Me, Mo) = pinv((C11 + C12) Me, (C11 - C12) Mo)

and, the y and z operators commuting (pallas_poisson.py:386-410), A is Iz
u, Iz v, Sz w (z FWD), then a = TyI z1, e = TyS z2 + TyI z3 (y FWD, e one
job of two sources); C is Gzi X, Gzs Y, Gzi Y (z INV), then u - GiT px,
v - GsT pzy, w - GiT dzy (y INV with the subtraction). The same function
as the plain versions' to float64 rounding (the band the fold removes
drops entries below 1e-12 of the largest). Two of pipe_c[d2]'s three
launches run on the operator-apply template of ``csrc/pressure_pipe.cu``
(ops/operator_apply.py).

The carry's plain version is x3d2_tpu's: the sweep's banded blocks of the
z operators at its 128-point blocks and 64-point band in both modes
(zbs, zw; at 64 points the compact-6 operators are exact to float64
rounding). On the card stage C with the carry runs y first (the y and z
operators commute): the inverse y transform of X and Y
(two PINV applies, not stage C's three), the banded Giy, Gsy, Giy, then
``csrc/pipe_c_d2.cu``, whose block owns 32 whole z lines of the three
fields: it applies the inverse parity z transforms, subtracts from u, v,
w, writes u', v', w' once, and runs the carry's z sweep on the lines,
with the circulant z operators' 2W + 1 taps at W = 32 (they drop 4e-14 of
the largest entry beyond it); the separate z sweep's three field reads
leave the step. At nz 256, 384 and 512 the lines stay in shared memory
(the resident form); at every other z extent x3d2_tpu's carry gate admits
(a multiple of 128, at least 256) the streamed form takes nz at run time:
the transform streams its operand through shared memory and the carry
reads the corrected lines back in chunks (``carry_geometry``).

A stage on CUDA tensors launches the kernels (or raises); on CPU tensors it
runs the plain version. The pipeline serves every grid x3d2_tpu's pipe3
serves (pipe3_supported, pallas_poisson.py:1555: all-periodic and uniform,
x and z multiples of 16, y of 64): the tensor-core kernel takes any such
extent (a y of 192 or an x of 320: halves of 96 or 160, the last row tile
part-filled). Its grids have no Nyquist mask (pipe3 refuses a folded
Poisson, pallas_poisson.py:1563-1564): stage B's kernel reads none.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field

import numpy as np
import torch

from ..common import resolve_device
from .banded import banded_blocks
from . import x_apply_manual as xm
from .operator_apply import BANDED, PINV, apply, count_launch, route
from .parity import (Forms, ProjectionMats, banded_apply, pfwd, pinv,
                     solve_factor)
from .transeq_sweep import SweepBlocks, transeq_sweep_plain

# x3d2_tpu's carry blocks (pallas_poisson.py:1683), in both modes, and its
# band truncation tolerance (pallas_kernels.py:143)
ZBS, ZW = 128, 64
_BAND_TOL = 1e-6
# the carry kernel: band half-width, z lines per block; the z extents of
# its resident form (whole lines of three fields in shared memory), and of
# the streamed form the rows of the half a pass and the z outputs a chunk
CARRY_W = 32
CARRY_LINES = 32
RESIDENT_NZ = (256, 384, 512)
STREAM_PASS, STREAM_CHUNK = 128, 128
# shared memory of the streamed form: the larger of A's staged step (2 x 32
# rows of 36 floats) and a chunk's q and w' (2 x (128 + 2 W) rows of 36),
# and the taps
STREAM_SMEM = 4 * (max(2 * 32 * 36, 2 * (STREAM_CHUNK + 2 * CARRY_W) * 36)
                   + 4 * (2 * CARRY_W + 1))
# circulant to float64 rounding (the carry's z operators, the pipeline's
# folded y); the taps beyond CARRY_W, which the carry kernel leaves out,
# far below float32 rounding (the compact-6 operators: 4e-14)
_CIRCULANT_TOL = _TAIL_TOL = 1e-12


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

def pipe_a_plain(u, v, w, m):
    """Stage A in plain PyTorch: (a, e)."""
    p1, p2, p3 = banded_apply(m["biy"], u, 1), \
        banded_apply(m["bsy"], v, 1), banded_apply(m["biy"], w, 1)
    z1 = pfwd(m["iz"], p1, 2)
    z23 = pfwd(m["iz"], p2, 2) + pfwd(m["sz"], p3, 2)
    return pfwd(m["ty"], z1, 1), pfwd(m["ty"], z23, 1)


def pipe_b_plain(a, e, m):
    """Stage B in plain PyTorch: (X, Y)."""
    F = pfwd(m["sx"], a, 0) + pfwd(m["ix"], e, 0)
    q = F * solve_factor(m, tuple(a.shape))
    return pinv(m["gxs"], q, 0), pinv(m["gxi"], q, 0)


def pipe_c_plain(X, Y, u, v, w, m):
    """Stage C in plain PyTorch: (u', v', w')."""
    gx = pinv(m["tyi"], pinv(m["gzi"], X, 2), 1)
    gz = pinv(m["tyi"], pinv(m["gzs"], Y, 2), 1)
    gy = pinv(m["tyi"], pinv(m["gzi"], Y, 2), 1)
    return (u - banded_apply(m["bgiy"], gx, 1),
            v - banded_apply(m["bgsy"], gy, 1),
            w - banded_apply(m["bgiy"], gz, 1))


# ---------------------------------------------------------------------------
# the folded y and the kernel wrappers
# ---------------------------------------------------------------------------

def _circulant_halves(M):
    """(C11 + C12, C11 - C12) of a circulant (n, n) C in halves; raises
    ValueError where C is not circulant within _CIRCULANT_TOL of its
    largest entry."""
    n = M.shape[0]
    circ = np.stack([np.roll(M[0], i) for i in range(n)])
    if M.shape != (n, n) or n % 2 or np.abs(M - circ).max() > \
            _CIRCULANT_TOL * np.abs(M).max():
        raise ValueError("the pipeline folds circulant y operators into its "
                         "y transforms (a periodic uniform y axis)")
    h = n // 2
    return M[:h, :h] + M[:h, h:], M[:h, :h] - M[:h, h:]


def fold_y(pm: ProjectionMats) -> dict:
    """The y operators folded into the parity y transforms, float64, made
    once per operator set from its masters ty = [Me; Mo], tyi = [Me; Mo]
    and the y axis' whole operators (pm.y64): tyI, tyS = [Me (C11 + C12);
    Mo (C11 - C12)] of Ty C for C = Iy, Sy (forward parity stacks); giT,
    gsT = [(C11 + C12) Me; (C11 - C12) Mo] of C Tyi for C = Giy, Gsy
    (inverse). Raises ValueError where the set has no parity y transforms
    and whole y operators, or a y operator is not circulant."""
    if "y" not in pm._fold:
        if pm.forms.y != "parity" or pm.y64 is None:
            raise ValueError(f"the pipeline folds the banded y into the "
                             f"parity y transforms; the operator set's y "
                             f"form is {pm.forms.y}")
        ty, tyi = pm.m64["ty"], pm.m64["tyi"]
        h = ty.shape[0] // 2

        def fwd(C):
            p, m = _circulant_halves(C)
            return np.concatenate([ty[:h] @ p, ty[h:] @ m])

        def inv(C):
            p, m = _circulant_halves(C)
            return np.concatenate([p @ tyi[:h], m @ tyi[h:]])

        y = pm.y64
        pm._fold["y"] = {"tyI": fwd(y["iy"]), "tyS": fwd(y["sy"]),
                         "giT": inv(y["giy"]), "gsT": inv(y["gsy"])}
    return pm._fold["y"]


def tc_ops(pm: ProjectionMats, device) -> dict:
    """The stages' operators split and packed for the tensor-core kernel
    (x_apply_manual.pack, from their float32 values), made once per
    operator set and device: the parity z transforms iz, sz (forward),
    gzi, gzs (inverse), the folded y (fold_y), and the parity x transforms
    sx, ix (forward), gxs, gxi (inverse)."""
    key = ("packed", str(device))
    if key not in pm._fold:
        m, y = pm.m64, fold_y(pm)
        fwd = ("iz", "sz", "tyI", "tyS", "sx", "ix")
        pm._fold[key] = {
            k: xm.pack(M, xm.FWD if k in fwd else xm.INV, device)
            for k, M in (*((k, m[k]) for k in ("iz", "sz", "gzi", "gzs")),
                         *y.items(),
                         *((k, m[k]) for k in ("sx", "ix", "gxs", "gxi")))}
    return pm._fold[key]


def solve_tables(pm: ProjectionMats) -> tuple:
    """Stage B's solve tables, float32 on the set's device: tab_a, tab_b
    per (y, z) mode in q's order, k2x, tx2 per x mode in block-parity
    order (parity.build_projection_mats). Raises ValueError where the set
    has a Nyquist mask (no pipeline grid has one)."""
    m = pm.mats(torch.float32)
    if "myz" in m:
        raise ValueError("the pipeline's solve takes no Nyquist mask")
    return m["tab_a"], m["tab_b"], m["k2x"], m["tx2"]


# the launches of the stages, each on the packed operators of tc_ops

def pipe_a_z(u, v, w, op):
    """Stage A's z launch: (Iz u, Iz v, Sz w)."""
    return xm.launch_jobs("pipe_a", 2, [([op["iz"]], [u], None, None),
                                        ([op["iz"]], [v], None, None),
                                        ([op["sz"]], [w], None, None)])


def pipe_a_y(z1, z2, z3, op):
    """Stage A's y launch: (a, e) = (TyI z1, TyS z2 + TyI z3)."""
    return xm.launch_jobs("pipe_a", 1, [
        ([op["tyI"]], [z1], None, None),
        ([op["tyS"], op["tyI"]], [z2, z3], None, None)])


def pipe_c_z(X, Y, op):
    """Stage C's z launch: (px, dzy, pzy) = (Gzi X, Gzs Y, Gzi Y)."""
    return xm.launch_jobs("pipe_c", 2, [([op["gzi"]], [X], None, None),
                                        ([op["gzs"]], [Y], None, None),
                                        ([op["gzi"]], [Y], None, None)])


def pipe_c_y(px, dzy, pzy, u, v, w, op):
    """Stage C's y launch: (u - GiT px, v - GsT pzy, w - GiT dzy)."""
    return xm.launch_jobs("pipe_c", 1, [([op["giT"]], [px], None, u),
                                        ([op["gsT"]], [pzy], None, v),
                                        ([op["giT"]], [dzy], None, w)])


def pipe_b_x(a, e, op, tabs):
    """Stage B's forward x launch with the solve: q = (Sx a + Ix e) times
    -1 / waves (tabs: solve_tables)."""
    return xm.launch_jobs("pipe_b", 0, [([op["sx"], op["ix"]], [a, e], None,
                                         None)], solve=tabs)[0]


def pipe_b_inv(q, op):
    """Stage B's inverse x launch: (X, Y) = (Gxs q, Gxi q)."""
    return xm.launch_jobs("pipe_b", 0, [([op["gxs"]], [q], None, None),
                                        ([op["gxi"]], [q], None, None)])


def _pipe_a_cuda(u, v, w, pm):
    op = tc_ops(pm, u.device)
    return tuple(pipe_a_y(*pipe_a_z(u, v, w, op), op))


def _pipe_b_cuda(a, e, pm):
    op = tc_ops(pm, a.device)
    return tuple(pipe_b_inv(pipe_b_x(a, e, op, solve_tables(pm)), op))


def _pipe_c_cuda(X, Y, u, v, w, pm):
    op = tc_ops(pm, X.device)
    return tuple(pipe_c_y(*pipe_c_z(X, Y, op), u, v, w, op))


def pipe_a(u, v, w, pm: ProjectionMats):
    """Stage A: (u, v, w) -> (a, e). CUDA tensors launch the kernel (or
    raise); CPU tensors run the plain version."""
    if route(u, "pipe_a"):
        return _pipe_a_cuda(u, v, w, pm)
    return pipe_a_plain(u, v, w, pm.mats(u.dtype))


def pipe_b(a, e, pm: ProjectionMats):
    """Stage B: (a, e) -> (X, Y), the x transforms around the solve."""
    if route(a, "pipe_b"):
        return _pipe_b_cuda(a, e, pm)
    return pipe_b_plain(a, e, pm.mats(a.dtype))


def pipe_c(X, Y, u, v, w, pm: ProjectionMats):
    """Stage C: (X, Y, u, v, w) -> the corrected (u', v', w')."""
    if route(X, "pipe_c"):
        return _pipe_c_cuda(X, Y, u, v, w, pm)
    return pipe_c_plain(X, Y, u, v, w, pm.mats(X.dtype))


# ---------------------------------------------------------------------------
# stage C with the carry (X3D2_D2C=1)
# ---------------------------------------------------------------------------

@dataclass
class CarryMats:
    """The carry's operators: the z sweep's banded blocks at x3d2_tpu's
    (ZBS, ZW) (the plain version's), the circulant taps of D1, D1s, D2,
    D2s at offsets -CARRY_W..CARRY_W (float64, (4, 2 CARRY_W + 1); the
    kernel's), the viscosity, and device copies."""

    blocks: SweepBlocks
    taps: np.ndarray
    nu: float
    device: torch.device
    _dev: dict = field(default_factory=dict)

    def kernel_mats(self, pm: ProjectionMats):
        """(taps, Gzi^T, Gzs^T) for the kernel, float32: the inverse parity
        z operators [Me; Mo] of pm as [Me^T; Mo^T] (nz, nz/2), row k of the
        first half holding column k of Me (cached for the last pm)."""
        def halves_t(M):
            h = M.shape[0] // 2
            return np.concatenate([M[:h].T, M[h:].T])

        if self._dev.get("pm") is not pm:
            self._dev["pm"] = pm
            self._dev["kernel"] = tuple(
                torch.as_tensor(a, dtype=torch.float32,
                                device=self.device).contiguous()
                for a in (self.taps, halves_t(pm.m64["gzi"]),
                          halves_t(pm.m64["gzs"])))
        return self._dev["kernel"]


def build_carry_mats(ops_z, nu, device=None) -> CarryMats:
    """The carry's operators from the z axis' (x3d2_tpu make_pressure_pipe3
    d2_sweep, pallas_poisson.py:1681-1697). Raises ValueError where
    x3d2_tpu does (a z extent not tiled by ZBS or shorter than ZBS + 2 ZW)
    and where the z operators are not circulant (a periodic uniform z, as
    every pipeline grid has) or reach beyond CARRY_W."""
    n = ops_z.der1st.n_out
    if n % ZBS or n < ZBS + 2 * ZW:
        raise ValueError("d2-in-C needs a lane-tileable z extent")

    def bb(op):
        return banded_blocks(op, ZW, ZBS, tol=_BAND_TOL)

    d1, d1s = ops_z.der1st, ops_z.der1st_sym
    d2, d2s = ops_z.der2nd, ops_z.der2nd_sym
    m64 = {"sa": np.concatenate([bb(d1), bb(d2)], axis=1),
           "st": np.concatenate([bb(d1s), bb(d2s)], axis=1),
           "da": bb(d1s), "dt": bb(d1)}
    device = resolve_device(device)
    offs = np.arange(-CARRY_W, CARRY_W + 1)
    far = np.abs(np.arange(n) - n // 2) < n // 2 - CARRY_W
    taps = []
    for op in (d1, d1s, d2, d2s):
        M = op.M64
        scale = np.abs(M).max()
        circ = np.stack([np.roll(M[0], i) for i in range(n)])
        if M.shape != (n, n) or np.abs(M - circ).max() > \
                _CIRCULANT_TOL * scale:
            raise ValueError("the carry kernel needs circulant z operators "
                             "(a periodic uniform z axis)")
        # taps beyond CARRY_W: the ones the kernel leaves out
        if np.abs(M[0][far]).max(initial=0.0) > _TAIL_TOL * scale:
            raise ValueError(f"the z operators reach beyond {CARRY_W} "
                             "points")
        taps.append(M[0][offs % n])
    return CarryMats(
        blocks=SweepBlocks(axis=2, m64=m64, device=device, bs=ZBS, w=ZW),
        taps=np.stack(taps), nu=float(nu), device=device)


def carry_kernel_supported(shape) -> bool:
    """Whether the carry kernel serves the grid: x3d2_tpu's z extents (a
    multiple of ZBS, at least ZBS + 2 ZW: make_pressure_pipe3's d2_sweep
    gate, pallas_poisson.py:1684-1686, which has no upper bound), and the
    lines tiled by its block (every grid of x3d2_tpu's sweeps: x and y
    multiples of 64)."""
    nx, ny, nz = shape
    return (nz % ZBS == 0 and nz >= ZBS + 2 * ZW
            and (nx * ny) % CARRY_LINES == 0)


def carry_geometry(shape) -> dict:
    """The launch of the carry kernel on `shape`: its form ("resident" at
    nz 256, 384, 512, one instance each; "streamed" at every other z
    extent carry_kernel_supported admits, nz at run time), blocks of
    CARRY_LINES lines, the shared memory in bytes, and for the streamed
    form the passes of STREAM_PASS rows of the half and the chunks of
    STREAM_CHUNK carry outputs. Raises ValueError where the kernel does
    not serve the grid."""
    nx, ny, nz = shape
    if not carry_kernel_supported(shape):
        raise ValueError(f"the carry kernel takes z a multiple of {ZBS} of "
                         f"at least {ZBS + 2 * ZW} points and x * y a "
                         f"multiple of {CARRY_LINES}; got {shape}")
    geo = {"blocks": nx * ny // CARRY_LINES, "lines": CARRY_LINES}
    if nz in RESIDENT_NZ:
        # 3 fields x nz z rows of 36 floats (32 lines, padded), the taps
        return dict(geo, form="resident",
                    smem=4 * (3 * nz * 36 + 4 * (2 * CARRY_W + 1)))
    return dict(geo, form="streamed", smem=STREAM_SMEM,
                passes=-(-(nz // 2) // STREAM_PASS),
                chunks=nz // STREAM_CHUNK)


def pipe_c_d2_plain(X, Y, u, v, w, m, carry: CarryMats):
    """Stage C and the carry in plain PyTorch: ((u', v', w'),
    (r_u, r_v, r_w))."""
    new = pipe_c_plain(X, Y, u, v, w, m)
    return new, transeq_sweep_plain(*new, carry.blocks, carry.nu)


_CARRY_LIB = None


def _carry_lib():
    """The carry kernel's library, built and typed at first use."""
    global _CARRY_LIB
    if _CARRY_LIB is None:
        from .. import _build

        so = _build.load("pipe_c_d2")
        i, p = ctypes.c_int, ctypes.c_void_p
        so.pipe_c_d2_launch.argtypes = [p, ctypes.c_float, ctypes.c_longlong,
                                        i, i, p]
        so.pipe_c_d2_launch.restype = i
        so.pipe_c_d2_error_string.argtypes = [i]
        so.pipe_c_d2_error_string.restype = ctypes.c_char_p
        so.pipe_c_d2_geometry.argtypes = [ctypes.POINTER(i)] * 5
        so.pipe_c_d2_geometry.restype = i
        geo = [i() for _ in range(5)]
        so.pipe_c_d2_geometry(*geo)
        want = (CARRY_LINES, CARRY_W, STREAM_PASS, STREAM_CHUNK, STREAM_SMEM)
        if tuple(g.value for g in geo) != want:
            raise RuntimeError("pipe_c_d2.cu geometry "
                               f"{tuple(g.value for g in geo)} differs from "
                               f"the wrapper's {want}")
        _CARRY_LIB = so
    return _CARRY_LIB


def _pipe_c_d2_cuda(X, Y, u, v, w, pm, carry, form=None):
    shape = tuple(X.shape)
    form = form or carry_geometry(shape)["form"]
    m = pm.mats(torch.float32)
    # y first: Tyi X, Tyi Y, then Giy (Tyi X), Gsy (Tyi Y), Giy (Tyi Y)
    gx, gy = torch.empty_like(X), torch.empty_like(X)
    apply("pipe_c[d2]", PINV, 1, [([m["tyi"]], [X], gx, None),
                                  ([m["tyi"]], [Y], gy, None)])
    a = [torch.empty_like(X) for _ in range(3)]
    apply("pipe_c[d2]", BANDED, 1, [([m["bgiy"]], [gx], a[0], None),
                                    ([m["bgsy"]], [gy], a[1], None),
                                    ([m["bgiy"]], [gy], a[2], None)])
    taps, gzi_t, gzs_t = carry.kernel_mats(pm)
    for t in (u, v, w):
        if t.dtype != torch.float32 or tuple(t.shape) != shape \
                or not t.is_contiguous() or t.device != X.device:
            raise ValueError("the carry kernel takes contiguous float32 "
                             f"fields of shape {shape} on {X.device}")
    new = [torch.empty_like(X) for _ in range(3)]
    # gx, gy are dead: two of the partials take their buffers
    rhsp = [gx, gy, torch.empty_like(X)]
    ptrs = [t.data_ptr() for t in a + [u, v, w]] + [
        gzi_t.data_ptr(), gzs_t.data_ptr(), taps.data_ptr()] + [
        t.data_ptr() for t in new + rhsp]
    parr = (ctypes.c_void_p * len(ptrs))(*ptrs)
    stream = torch.cuda.current_stream(X.device).cuda_stream
    with torch.cuda.device(X.device):
        err = _carry_lib().pipe_c_d2_launch(
            parr, carry.nu, shape[0] * shape[1], shape[2],
            int(form == "streamed"), stream)
    if err != 0:
        msg = _carry_lib().pipe_c_d2_error_string(err).decode()
        raise RuntimeError(f"pipe_c_d2 launch failed: {msg} ({err})")
    count_launch("pipe_c[d2]")
    return tuple(new), tuple(rhsp)


def pipe_c_d2(X, Y, u, v, w, pm: ProjectionMats, carry: CarryMats,
              form=None):
    """Stage C with the carry: (X, Y, u, v, w) -> ((u', v', w'), (r_u, r_v,
    r_w)), counted as pipe_c[d2] (3 launches). form: the carry kernel's
    form, carry_geometry's by default ("streamed" also serves the resident
    form's extents, with the same sums in the same order)."""
    if route(X, "pipe_c_d2"):
        return _pipe_c_d2_cuda(X, Y, u, v, w, pm, carry, form)
    return pipe_c_d2_plain(X, Y, u, v, w, pm.mats(X.dtype), carry)


def make_pressure_pipe_d2(pm: ProjectionMats, carry: CarryMats):
    """fn(u, v, w) -> ((u', v', w'), (r_u, r_v, r_w)): the pipeline with
    the carry (x3d2_tpu make_pressure_pipe3(d2_sweep=True))."""

    def fn(u, v, w):
        a, e = pipe_a(u, v, w, pm)
        X, Y = pipe_b(a, e, pm)
        return pipe_c_d2(X, Y, u, v, w, pm, carry)

    fn.mats, fn.carry = pm, carry
    return fn


def make_pressure_pipe(pm: ProjectionMats):
    """fn(u, v, w) -> (u', v', w'): the keep_pressure=False projection as
    the three stages (x3d2_tpu make_pressure_pipe3) over the operator set
    `pm` (parity.build_projection_mats, in the parity forms the pipeline
    takes: on the grids ``parity.pipe3_supported`` admits). Raises
    ValueError where the set has another form (a y operator wider than the
    band: x3d2_tpu's make_pressure_pipe3 raises there too), or where its y
    operators are not circulant (fold_y: every grid pipe3_supported admits
    has them circulant)."""
    if pm.forms != Forms() or pm.x_perm is None:
        raise ValueError(f"the pipeline takes the banded y and the parity "
                         f"transforms, got the forms {pm.forms}")
    fold_y(pm)

    def fn(u, v, w):
        a, e = pipe_a(u, v, w, pm)
        X, Y = pipe_b(a, e, pm)
        return pipe_c(X, Y, u, v, w, pm)

    fn.mats = pm
    return fn
