"""The operator-apply kernel of ``csrc/pressure_pipe.cu`` behind its
launcher: what the wrappers of both kernel projections (pressure_pipe.py,
pressure_slab.py) share on the card.

``apply`` is one launch of the kernel template: operators applied along one
axis of (nx, ny, nz) float32 fields in one of three forms (BANDED, PFWD,
PINV), up to three fields a launch and two summed sources a field, with an
epilogue (STORE, SUB, SOLVE after an x apply, SOLVE_PLANE after a y apply
batched over x planes; the solves take the Nyquist mask where the operator
set has one), or the fourth form, DENSE, along y or z: a square dense
operator (the dense forms of the mid, X3D2_BFLY=0). ``apply_dense``
launches DENSE along x: one dense (n_out, n_in) operator, out = M f or
out = s - M f, any extents (the x stage of a wall-bounded x axis, and of
any x with X3D2_BFLY=0). Both check their operands, launch
or raise, and add one to the launch count of the wrapper named in
``stage``; nothing else counts. ``route`` is the wrappers' device switch:
CUDA tensors launch, CPU tensors take the plain version, anything else
raises.
"""

from __future__ import annotations

import ctypes

import torch

from .parity import BBS, BW, TILE, WIN

# operator forms and epilogues of the kernel template
BANDED, PFWD, PINV, DENSE = 0, 1, 2, 3
STORE, SUB, SOLVE, SOLVE_PLANE = 0, 1, 2, 3

# kernel launches per call of each wrapper
LAUNCHES_PER_CALL = {"pipe_a": 3, "pipe_b": 2, "pipe_c": 3,
                     "pipe_c[d2]": 3,
                     "x_div3": 1, "pressure_mid": 6, "pressure_mid[q]": 6,
                     "pressure_mid[dense]": 6, "pressure_mid[q,dense]": 6,
                     "pressure_mid[q,local]": 6,
                     "pressure_mid[q,dense,local]": 6,
                     "div_solve": 3, "grad": 3, "div_solve[dense]": 3,
                     "grad[dense]": 3,
                     "x_gradsub3": 1, "x_apply": 1, "x_apply[sub]": 1,
                     "x_pfwd": 1, "x_pinv": 1, "x_pinv[sub]": 1}

# launches of the kernel per wrapper, counted where it is launched
_LAUNCHES: dict[str, int] = {}


def launch_counts() -> dict[str, int]:
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    _LAUNCHES.clear()


_LIB = None


def lib():
    """The kernel library, built and typed at first use."""
    global _LIB
    if _LIB is None:
        from .. import _build

        so = _build.load("pressure_pipe")
        i, ll, p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
        so.pressure_pipe_apply.argtypes = [
            i, i, i, i, p, p, p, i, i, i, i, i, ll, ll, ll, i, p]
        so.pressure_pipe_apply.restype = i
        so.pressure_pipe_error_string.argtypes = [i]
        so.pressure_pipe_error_string.restype = ctypes.c_char_p
        so.pressure_pipe_geometry.argtypes = [ctypes.POINTER(i)] * 4
        so.pressure_pipe_geometry.restype = i
        geo = [i() for _ in range(4)]
        so.pressure_pipe_geometry(*geo)
        if tuple(g.value for g in geo) != (TILE, BBS, TILE, 8):
            raise RuntimeError("pressure_pipe.cu geometry "
                               f"{tuple(g.value for g in geo)} differs from "
                               f"the wrapper's {(TILE, BBS, TILE, 8)}")
        _LIB = so
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


def apply(stage, mode, axis, jobs, epi=STORE, tabs=()):
    """One kernel launch applying operators along `axis` of (nx, ny, nz)
    fields. jobs: (mats, fields, out, sub) per field, with 1-2 (mat, field)
    sources summed into `out` (sub: the field it is subtracted from).
    tabs: the solve's A, B, k2x, tx2 [, Myz, mx: the Nyquist mask]. DENSE
    takes square (n, n) operators along y or z (along x: apply_dense)."""
    shape = tuple(jobs[0][1][0].shape)
    nx, ny, nz = shape
    n = shape[axis]
    if n % TILE or (axis == 2 and (nx * ny) % TILE) \
            or (axis < 2 and nz % TILE):
        raise ValueError(f"shape {shape} is not tiled by {TILE} along "
                         f"axis {axis}")
    if mode == DENSE and axis == 0:
        raise ValueError("the dense x apply is apply_dense")
    trans, batch, ld, pstride, ncols = {
        0: (0, 1, ny * nz, 0, ny * nz),
        1: (0, nx, nz, ny * nz, nz),
        2: (1, 1, nz, 0, nx * ny)}[axis]
    K = WIN if mode == BANDED else n if mode == DENSE else n // 2
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
    solve = epi in (SOLVE, SOLVE_PLANE)
    if (len(tabs) in (4, 6)) != solve:
        raise ValueError("the solve epilogue takes its 4 tables, 6 with "
                         "the Nyquist mask")
    if (epi == SOLVE and axis != 0) or (epi == SOLVE_PLANE and axis != 1):
        raise ValueError("the solve follows an x apply, or a y apply "
                         "batched over x planes")
    if solve:
        for t, k in zip(tabs, (ny * nz, ny * nz, nx, nx, ny * nz, nx)):
            _check(t, (k,), "solve table")
    _launch(stage, mode, trans, epi, jobs, ptrs, nsrc, tabs, batch, K, n, n,
            ld, pstride, ncols, mtiles)


def apply_dense(stage, M, f, out, sub=None):
    """One DENSE launch along x: out = M f, or out = sub - M f with the
    subtracting epilogue. M (n_out, n_in); f (n_in, ny, nz); out and sub
    (n_out, ny, nz); n_in and n_out any, ny * nz a multiple of 128."""
    n_out, n_in = M.shape
    _, ny, nz = f.shape
    if (ny * nz) % TILE:
        raise ValueError(f"the dense x apply needs ny * nz tiled by {TILE}, "
                         f"got {(ny, nz)}")
    _check(M, (n_out, n_in), "operator")
    _check(f, (n_in, ny, nz), "field")
    for t in (out,) + ((sub,) if sub is not None else ()):
        _check(t, (n_out, ny, nz), "field")
    if out.data_ptr() == f.data_ptr():
        raise ValueError("the output may not alias an input")
    ptrs = [M.data_ptr(), None, f.data_ptr(), None, out.data_ptr(),
            sub.data_ptr() if sub is not None else None]
    _launch(stage, DENSE, 0, SUB if sub is not None else STORE,
            [(None, None, out, None)], ptrs, [1], (), 1, n_in, n_in, n_out,
            ny * nz, 0, ny * nz, -(-n_out // TILE))


def _launch(stage, mode, trans, epi, jobs, ptrs, nsrc, tabs, batch, K, nrow,
            nout, ld, pstride, ncols, mtiles):
    """The launch itself, its error check and its count."""
    tab_ptrs = [t.data_ptr() for t in tabs] + [None] * (6 - len(tabs))
    parr = (ctypes.c_void_p * len(ptrs))(*ptrs)
    narr = (ctypes.c_int * len(nsrc))(*nsrc)
    tarr = (ctypes.c_void_p * 6)(*tab_ptrs)
    dev = jobs[0][2].device
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib().pressure_pipe_apply(
            mode, trans, epi, len(jobs), parr, narr, tarr, batch, K, nrow,
            nout, BW, ld, pstride, ncols, mtiles, stream)
    if err != 0:
        msg = lib().pressure_pipe_error_string(err).decode()
        raise RuntimeError(f"pressure_pipe launch failed: {msg} ({err})")
    count_launch(stage)


def count_launch(stage):
    """One launch of the wrapper named `stage` (also the carry kernel's,
    ops/pressure_pipe.py)."""
    _LAUNCHES[stage] = _LAUNCHES.get(stage, 0) + 1


def route(t, name):
    """True for CUDA tensors (launch), False for CPU ones (plain)."""
    if t.is_cuda:
        return True
    if t.device.type != "cpu":
        raise ValueError(f"no {name} for device {t.device}")
    return False
