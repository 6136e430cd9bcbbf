"""Three-stage pressure projection for ``keep_pressure=False``: the wrappers
of the Hopper kernels in ``csrc/pressure_pipe.cu`` and their plain PyTorch
versions.

Counterpart of x3d2_tpu.ops.pallas_poisson.make_pressure_pipe3
(pallas_poisson.py:1573) and its kernels:

    A  _pipe_a_kernel (:1378)  u, v, w -> a = Ty Iz Iy u,
                                          e = Ty (Iz Sy v + Sz Iy w)
    B  _pipe_b_kernel (:1405)  a, e    -> q = -(Sx a + Ix e) / waves,
                                          X = Gxs q, Y = Gxi q
    C  _pipe_c_kernel (:1455)  X, Y, u, v, w -> u - Giy Gzi X,
                                          v - Gsy Gzi Y, w - Giy Gzs Y

The y interpolation and staggered derivative are band-truncated per block
of 64 rows (ops/banded.py, W=32); the periodic transforms use the parity
split (one radix-2 level in matrix form, half the operations), so spectral
indices stay in block-parity order [even modes; odd modes] between the
stages and the solve tables are permuted to match. The operators are f32
(no bf16 hi/lo splits: those worked around the TPU matrix unit).

A stage on CUDA tensors launches the kernel (or raises); on CPU tensors it
runs the plain version. The pipeline serves the all-periodic uniform grid
whose every extent is a multiple of 128 (``pipe_supported``), as
x3d2_tpu's pipe3 serves its periodic-even fast path (pipe3_supported,
pallas_poisson.py:1555).
"""

from __future__ import annotations

import ctypes
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
TILE = 128             # the kernel's output tile along every axis
# at W=32 the uniform compact interpolation and staggered derivative drop
# entries below 1e-15 of their largest: the band is exact to float64
# rounding (W=16, the TPU's bf16x3 choice, drops 1e-7)
_BAND_TOL = 1e-12
_EPS = 1e-16           # zero-wave guard, as matmul_poisson._EPS

# operator forms and epilogues of the kernel template
BANDED, PFWD, PINV = 0, 1, 2
STORE, SUB, SOLVE = 0, 1, 2

# kernel launches per call of each stage
LAUNCHES_PER_CALL = {"pipe_a": 3, "pipe_b": 2, "pipe_c": 3}

# launches of the kernel per stage, counted where it is launched
_LAUNCHES: dict[str, int] = {}


def launch_counts() -> dict[str, int]:
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    _LAUNCHES.clear()


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


# ---------------------------------------------------------------------------
# operators
# ---------------------------------------------------------------------------

def pipe_supported(solver) -> bool:
    """The grids the pipeline serves: the uniform spectral Poisson solve on
    an all-periodic grid (square operators, parity-split transforms on
    every axis) whose extents are multiples of the kernel tile."""
    po = solver.poisson
    if (not isinstance(po, MatmulPoisson) or po.stretch_solver is not None
            or po.folded):
        return False
    nv = tuple(solver.mesh.dims(DataLoc.VERT))
    return nv == tuple(po.nc) and all(n % TILE == 0 for n in nv)


@dataclass
class PipeMats:
    """The pipeline's operators as float64 numpy masters, with device
    copies per dtype. Banded: biy, bsy (stage A), bgiy, bgsy (stage C) as
    stacked (n, WIN) blocks. Forward parity [Me; Mo]: ty, iz, sz (A), sx,
    ix (B). Inverse parity [Me; Mo]: gxs, gxi (B), gzi, gzs, tyi (C; the
    inverse y transform with its row weights folded in). Solve tables
    (block-parity order): tab_a, tab_b per (y, z) column, k2x, tx2 per x
    mode."""

    shape: tuple
    m64: dict
    device: torch.device
    _dev: dict = field(default_factory=dict)

    def mats(self, dtype) -> dict:
        if dtype not in self._dev:
            self._dev[dtype] = {
                k: torch.as_tensor(M, dtype=dtype, device=self.device)
                .contiguous() for k, M in self.m64.items()}
        return self._dev[dtype]


def build_pipe_mats(solver) -> PipeMats:
    """The pipeline's operators from the solver (x3d2_tpu
    make_pressure_pipe3, pallas_poisson.py:1584-1680). Raises ValueError
    outside ``pipe_supported`` or when a y operator's band is wider than W
    at the truncation tolerance."""
    if not pipe_supported(solver):
        raise ValueError("the pressure pipeline needs an all-periodic "
                         f"uniform grid tiled by {TILE}")
    d64 = solver._fp_mats64()
    oy = solver.ops[1]
    po = solver.poisson
    nx, ny, nz = po.nc

    def band(op):
        return banded_blocks(op, BW, BBS, tol=_BAND_TOL).reshape(-1, WIN)

    def fwd(M):
        return np.concatenate(parity_split_folded(M, 0))

    def inv(M):
        return np.concatenate(parity_split_folded(M, 1))

    te, to, wvec = parity_split(ny)
    h = ny // 2
    w_perm = np.concatenate([wvec[0::2], wvec[1::2]])

    def perm(n):
        return np.concatenate([np.arange(0, n, 2), np.arange(1, n, 2)])

    yp, zp, xp = perm(ny), perm(nz), perm(nx)
    m = {
        "biy": band(oy.interpl_v2p), "bsy": band(oy.stagder_v2p),
        "ty": np.concatenate([te, to]),
        "iz": fwd(d64["iz"]), "sz": fwd(d64["sz"]),
        "sx": fwd(d64["sx"]), "ix": fwd(d64["ix"]),
        "gxs": inv(d64["gx_s"]), "gxi": inv(d64["gx_i"]),
        "gzi": inv(d64["gz_i"]), "gzs": inv(d64["gz_s"]),
        "tyi": np.concatenate([te.T * w_perm[None, :h],
                               to.T * w_perm[None, h:]]),
        "bgiy": band(oy.interpl_p2v), "bgsy": band(oy.stagder_p2v),
        "tab_a": np.asarray(po.tab_A)[yp][:, zp].reshape(-1),
        "tab_b": np.asarray(po.tab_B)[yp][:, zp].reshape(-1),
        "k2x": po.k2_1d[0][xp],
        "tx2": (po.T_1d[0] ** 2)[xp],
    }
    return PipeMats(shape=(nx, ny, nz), m64=m, device=solver.device)


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

def _banded(Wst, f, axis):
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


def _pfwd(Mst, f, axis):
    """Forward parity apply: [Me (f1 + f2); Mo (f1 - f2)] along `axis`."""
    h = f.shape[axis] // 2
    ho = Mst.shape[0] // 2
    f1, f2 = f.narrow(axis, 0, h), f.narrow(axis, h, h)
    return torch.cat([apply_matrix(Mst[:ho], f1 + f2, axis),
                      apply_matrix(Mst[ho:], f1 - f2, axis)], axis)


def _pinv(Mst, f, axis):
    """Inverse parity apply: [a + b; a - b], a = Me f_e, b = Mo f_o."""
    h = Mst.shape[0] // 2
    a = apply_matrix(Mst[:h], f.narrow(axis, 0, h), axis)
    b = apply_matrix(Mst[h:], f.narrow(axis, h, h), axis)
    return torch.cat([a + b, a - b], axis)


def _solve_factor(m, shape):
    """-1/waves with the zero-wave guard, from the separable tables."""
    waves = (m["k2x"][:, None] * m["tab_a"][None, :]
             + m["tx2"][:, None] * m["tab_b"][None, :])
    ok = waves.abs() >= _EPS
    inv = torch.where(ok, -1.0 / torch.where(ok, waves, 1.0), 0.0)
    return inv.reshape(shape)


def pipe_a_plain(u, v, w, m):
    """Stage A in plain PyTorch: (a, e)."""
    p1, p2, p3 = _banded(m["biy"], u, 1), _banded(m["bsy"], v, 1), \
        _banded(m["biy"], w, 1)
    z1 = _pfwd(m["iz"], p1, 2)
    z23 = _pfwd(m["iz"], p2, 2) + _pfwd(m["sz"], p3, 2)
    return _pfwd(m["ty"], z1, 1), _pfwd(m["ty"], z23, 1)


def pipe_b_plain(a, e, m):
    """Stage B in plain PyTorch: (X, Y)."""
    F = _pfwd(m["sx"], a, 0) + _pfwd(m["ix"], e, 0)
    q = F * _solve_factor(m, tuple(a.shape))
    return _pinv(m["gxs"], q, 0), _pinv(m["gxi"], q, 0)


def pipe_c_plain(X, Y, u, v, w, m):
    """Stage C in plain PyTorch: (u', v', w')."""
    gx = _pinv(m["tyi"], _pinv(m["gzi"], X, 2), 1)
    gz = _pinv(m["tyi"], _pinv(m["gzs"], Y, 2), 1)
    gy = _pinv(m["tyi"], _pinv(m["gzi"], Y, 2), 1)
    return (u - _banded(m["bgiy"], gx, 1), v - _banded(m["bgsy"], gy, 1),
            w - _banded(m["bgiy"], gz, 1))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_LIB = None


def _lib():
    """The kernel library, built and typed at first use."""
    global _LIB
    if _LIB is None:
        from .. import _build

        lib = _build.load("pressure_pipe")
        i, ll, p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
        lib.pressure_pipe_apply.argtypes = [
            i, i, i, i, p, p, p, i, i, i, i, ll, ll, ll, i, p]
        lib.pressure_pipe_apply.restype = i
        lib.pressure_pipe_error_string.argtypes = [i]
        lib.pressure_pipe_error_string.restype = ctypes.c_char_p
        lib.pressure_pipe_geometry.argtypes = [ctypes.POINTER(i)] * 4
        lib.pressure_pipe_geometry.restype = i
        geo = [i() for _ in range(4)]
        lib.pressure_pipe_geometry(*geo)
        if tuple(g.value for g in geo) != (TILE, BBS, TILE, 8):
            raise RuntimeError("pressure_pipe.cu geometry "
                               f"{tuple(g.value for g in geo)} differs from "
                               f"the wrapper's {(TILE, BBS, TILE, 8)}")
        _LIB = lib
    return _LIB


def _check(t, shape, name):
    if not t.is_cuda or t.dtype != torch.float32:
        raise ValueError(f"{name}: the kernel takes float32 CUDA tensors, "
                         f"got {t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous tensor of shape "
                         f"{tuple(shape)}, got {tuple(t.shape)}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data must be 16-byte aligned")


def _apply(stage, mode, axis, jobs, epi=STORE, tabs=()):
    """One kernel launch applying operators along `axis` of (nx, ny, nz)
    fields. jobs: (mats, fields, out, sub) per field, with 1-2 (mat, field)
    sources summed into `out` (sub: the field it is subtracted from)."""
    shape = tuple(jobs[0][1][0].shape)
    nx, ny, nz = shape
    n = shape[axis]
    if n % TILE or (axis == 2 and (nx * ny) % TILE) \
            or (axis < 2 and nz % TILE):
        raise ValueError(f"shape {shape} is not tiled by {TILE} along "
                         f"axis {axis}")
    trans, batch, ld, pstride, ncols = {
        0: (0, 1, ny * nz, 0, ny * nz),
        1: (0, nx, nz, ny * nz, nz),
        2: (1, 1, nz, 0, nx * ny)}[axis]
    K = WIN if mode == BANDED else n // 2
    mtiles = n // 2 // BBS if mode == PINV else n // TILE
    ptrs, nsrc = [], []
    for mats, fields, out, sub in jobs:
        if not 1 <= len(mats) == len(fields) <= 2:
            raise ValueError("a job takes one or two sources")
        for M in mats:
            _check(M, (n, K), "operator")
        for t in fields + [out] + ([sub] if sub is not None else []):
            _check(t, shape, "field")
        if out.data_ptr() in {t.data_ptr() for t in fields}:
            raise ValueError("the output may not alias an input")
        if (sub is not None) != (epi == SUB):
            raise ValueError("the subtracting epilogue takes one field")
        pad = [None] * (2 - len(mats))
        ptrs += [M.data_ptr() for M in mats] + pad
        ptrs += [t.data_ptr() for t in fields] + pad
        ptrs += [out.data_ptr(), sub.data_ptr() if sub is not None else None]
        nsrc.append(len(mats))
    if (len(tabs) == 4) != (epi == SOLVE):
        raise ValueError("the solve epilogue takes its 4 tables")
    if epi == SOLVE:
        for t, k in zip(tabs, (ny * nz, ny * nz, n, n)):
            _check(t, (k,), "solve table")
    tab_ptrs = [t.data_ptr() for t in tabs] + [None] * (4 - len(tabs))
    parr = (ctypes.c_void_p * len(ptrs))(*ptrs)
    narr = (ctypes.c_int * len(nsrc))(*nsrc)
    tarr = (ctypes.c_void_p * 4)(*tab_ptrs)
    dev = jobs[0][2].device
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _lib().pressure_pipe_apply(
            mode, trans, epi, len(jobs), parr, narr, tarr, batch, K, n, BW,
            ld, pstride, ncols, mtiles, stream)
    if err != 0:
        msg = _lib().pressure_pipe_error_string(err).decode()
        raise RuntimeError(f"pressure_pipe launch failed: {msg} ({err})")
    _LAUNCHES[stage] = _LAUNCHES.get(stage, 0) + 1


def _pipe_a_cuda(u, v, w, m):
    p = [torch.empty_like(u) for _ in range(3)]
    _apply("pipe_a", BANDED, 1, [([m["biy"]], [u], p[0], None),
                                 ([m["bsy"]], [v], p[1], None),
                                 ([m["biy"]], [w], p[2], None)])
    z1, z23 = torch.empty_like(u), torch.empty_like(u)
    _apply("pipe_a", PFWD, 2, [([m["iz"]], [p[0]], z1, None),
                               ([m["iz"], m["sz"]], [p[1], p[2]], z23, None)])
    # p1 and p2 are dead: a and e take their buffers
    _apply("pipe_a", PFWD, 1, [([m["ty"]], [z1], p[0], None),
                               ([m["ty"]], [z23], p[1], None)])
    return p[0], p[1]


def _pipe_b_cuda(a, e, m):
    q = torch.empty_like(a)
    _apply("pipe_b", PFWD, 0, [([m["sx"], m["ix"]], [a, e], q, None)],
           epi=SOLVE, tabs=(m["tab_a"], m["tab_b"], m["k2x"], m["tx2"]))
    X, Y = torch.empty_like(a), torch.empty_like(a)
    _apply("pipe_b", PINV, 0, [([m["gxs"]], [q], X, None),
                               ([m["gxi"]], [q], Y, None)])
    return X, Y


def _pipe_c_cuda(X, Y, u, v, w, m):
    px, dzy, pzy = (torch.empty_like(X) for _ in range(3))
    _apply("pipe_c", PINV, 2, [([m["gzi"]], [X], px, None),
                               ([m["gzs"]], [Y], dzy, None),
                               ([m["gzi"]], [Y], pzy, None)])
    gx, gz, gy = (torch.empty_like(X) for _ in range(3))
    _apply("pipe_c", PINV, 1, [([m["tyi"]], [px], gx, None),
                               ([m["tyi"]], [dzy], gz, None),
                               ([m["tyi"]], [pzy], gy, None)])
    un, vn, wn = (torch.empty_like(u) for _ in range(3))
    _apply("pipe_c", BANDED, 1, [([m["bgiy"]], [gx], un, u),
                                 ([m["bgsy"]], [gy], vn, v),
                                 ([m["bgiy"]], [gz], wn, w)], epi=SUB)
    return un, vn, wn


def _route(t, name):
    """True for CUDA tensors (launch), False for CPU ones (plain)."""
    if t.is_cuda:
        return True
    if t.device.type != "cpu":
        raise ValueError(f"no {name} for device {t.device}")
    return False


def pipe_a(u, v, w, pm: PipeMats):
    """Stage A: (u, v, w) -> (a, e). CUDA tensors launch the kernel (or
    raise); CPU tensors run the plain version."""
    if _route(u, "pipe_a"):
        return _pipe_a_cuda(u, v, w, pm.mats(torch.float32))
    return pipe_a_plain(u, v, w, pm.mats(u.dtype))


def pipe_b(a, e, pm: PipeMats):
    """Stage B: (a, e) -> (X, Y), the x transforms around the solve."""
    if _route(a, "pipe_b"):
        return _pipe_b_cuda(a, e, pm.mats(torch.float32))
    return pipe_b_plain(a, e, pm.mats(a.dtype))


def pipe_c(X, Y, u, v, w, pm: PipeMats):
    """Stage C: (X, Y, u, v, w) -> the corrected (u', v', w')."""
    if _route(X, "pipe_c"):
        return _pipe_c_cuda(X, Y, u, v, w, pm.mats(torch.float32))
    return pipe_c_plain(X, Y, u, v, w, pm.mats(X.dtype))


def make_pressure_pipe(solver):
    """fn(u, v, w) -> (u', v', w'): the keep_pressure=False projection as
    the three stages (x3d2_tpu make_pressure_pipe3). Raises ValueError
    outside ``pipe_supported``."""
    pm = build_pipe_mats(solver)

    def fn(u, v, w):
        a, e = pipe_a(u, v, w, pm)
        X, Y = pipe_b(a, e, pm)
        return pipe_c(X, Y, u, v, w, pm)

    fn.mats = pm
    return fn
