"""The operator-apply kernel of ``csrc/pressure_pipe.cu`` behind its
launcher: what the wrappers of both kernel projections (pressure_pipe.py,
pressure_slab.py) share on the card.

``apply`` is one launch of the kernel template: operators applied along one
axis of (nx, ny, nz) float32 fields in one of four forms (BANDED, PFWD,
PINV, and DENSE along y or z: any (n_out, n) operator, rectangular on a
wall-bounded axis), up to three fields a launch and two summed sources a
field (the one-field PFWD and PINV along x, x_pfwd and x_pinv, are the
x-apply kernel's: ops/pressure_slab.py x_apply_parity; so are the
pipeline's three stages: ops/pressure_pipe.py), with an epilogue (STORE,
SUB, SOLVE after a z apply, SOLVE_PLANE after a y apply batched over x
planes; the solves take the Nyquist mask where the operator set has
one). ``apply_dense`` is the dense x apply, out = M f or out = s - M f
(the x stage of a wall-bounded x axis, and of any x with X3D2_BFLY=0):
one launch of the split-TF32 tensor-core kernel of
``csrc/x_apply_manual.cu`` (ops/x_apply_manual.py), not of the template.
``geometry`` computes every template launch's block grid, strides and
instance in one place: the 128-tiled instance where the extents are
multiples of its tiles and the form is one it has (its results and
registers as before), the general instance elsewhere (any extent
x3d2_tpu's gates admit); ``out_rows`` gives the output row of each block
row. Both launchers check their operands, launch or raise, and add one to
the launch count of the wrapper named in ``stage`` (the template's here,
the dense x apply's in ops/x_apply_manual.py); nothing else counts.
``route`` is the wrappers' device switch: CUDA tensors launch, CPU tensors
take the plain version, anything else raises.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from . import x_apply_manual as xm
from .parity import BBS, BW, TILE, WIN

# operator forms and epilogues of the kernel template
BANDED, PFWD, PINV, DENSE = 0, 1, 2, 3
STORE, SUB, SOLVE, SOLVE_PLANE = 0, 1, 2, 3

# kernel launches per call of each wrapper (pipe_a, pipe_b, pipe_c and the
# x applies: the x-apply kernel's, ops/x_apply_manual.py)
LAUNCHES_PER_CALL = {"pipe_a": 2, "pipe_b": 2, "pipe_c": 2,
                     "pipe_c[d2]": 3,
                     "x_div3": 1, "pressure_mid": 6, "pressure_mid[q]": 6,
                     "pressure_mid[dense]": 6, "pressure_mid[q,dense]": 6,
                     "pressure_mid[q,local]": 6,
                     "pressure_mid[q,dense,local]": 6,
                     "div_solve": 3, "grad": 3, "div_solve[dense]": 3,
                     "grad[dense]": 3,
                     "x_gradsub3": 1, "x_apply": 1, "x_apply[sub]": 1}
# the mid on the folded y: the dense y stage, the z transforms (and the
# solve), the inverse z transforms, the dense y stage
for _d in ("", "dense,"):
    LAUNCHES_PER_CALL[f"div_solve[{_d}folded_y]"] = 2
    LAUNCHES_PER_CALL[f"grad[{_d}folded_y]"] = 2
    for _q in ("", "q,"):
        for _l in ("", ",local"):
            LAUNCHES_PER_CALL[f"pressure_mid[{_q}{_d}folded_y{_l}]"] = 4

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
            i, i, i, i, p, p, p, i, i, i, i, i, ll, ll, ll, i, i, ll, ll, i,
            p]
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


# (mode, transposed, epilogue, two sources) of the 128-tiled instances;
# every other launch, and every launch whose extents they do not tile,
# takes the general instance (Geometry.tail)
_TILED = {(BANDED, 0, STORE, False), (PFWD, 0, STORE, False),
          (PFWD, 0, SOLVE_PLANE, False), (PFWD, 1, STORE, False),
          (PINV, 0, STORE, False), (PINV, 0, SUB, False),
          (PINV, 1, STORE, False), (DENSE, 0, STORE, False),
          (DENSE, 0, SOLVE_PLANE, False),
          (DENSE, 1, STORE, False),
          (BANDED, 0, STORE, True), (PFWD, 1, STORE, True),
          (DENSE, 1, STORE, True)}


@dataclass(frozen=True)
class Geometry:
    """One launch of the template: operators (nout, K) applied along
    `axis` of (nx, ny, nz) fields (``shape``, the input's), out of shape
    ``shape_out`` (nout along the axis); nrow: the input's extent along
    it. trans: the contraction runs along the contiguous z; batch: x planes
    a job (y applies); ld, ldo: the input's
    and the output's row strides (transposed: column strides); pstride,
    pstrideo: their plane strides; ncols: columns a plane; cpp: columns of
    one x plane (the solve after a transposed apply). The block grid:
    ntiles column tiles of TILE, mtiles row tiles; tail: the general
    instance (out_rows gives its row mapping)."""

    mode: int
    axis: int
    shape: tuple
    shape_out: tuple
    trans: int
    batch: int
    K: int
    nrow: int
    nout: int
    ld: int
    ldo: int
    pstride: int
    pstrideo: int
    ncols: int
    cpp: int
    mtiles: int
    ntiles: int
    tail: bool


def geometry(mode, axis, shape, nout, K, epi=STORE, two=False) -> Geometry:
    """The launch geometry of operators (nout, K) in form `mode` along
    `axis` of fields of `shape`, computed here once for the launcher and
    the tests. Raises ValueError on what the template does not take."""
    nx, ny, nz = shape
    n = shape[axis]
    out = list(shape)
    out[axis] = nout
    want_k = {BANDED: WIN, PFWD: n // 2, PINV: n // 2, DENSE: n}[mode]
    if K != want_k or (mode == BANDED and (nout != n or n % BBS)) \
            or (mode in (PFWD, PINV) and (n % 2 or nout % 2)):
        raise ValueError(f"form {mode} along axis {axis} of {shape} takes "
                         f"operators with {want_k} columns (BANDED: {n} "
                         f"rows, the parity forms an even count), got "
                         f"({nout}, {K})")
    if (epi == SOLVE and axis != 2) or (epi == SOLVE_PLANE and axis != 1) \
            or (epi == SUB and (axis == 2 or mode != PINV)) \
            or (mode == BANDED and axis == 2) or (mode == DENSE and axis == 0):
        raise ValueError(f"epilogue {epi} with form {mode} along axis {axis}"
                         " is not a form of the template")
    trans = int(axis == 2)
    batch = nx if axis == 1 else 1
    ld, ldo = {0: (ny * nz, ny * nz), 1: (nz, nz), 2: (nz, nout)}[axis]
    pstride, pstrideo = (n * nz, nout * nz) if axis == 1 else (0, 0)
    ncols = {0: ny * nz, 1: nz, 2: nx * ny}[axis]
    if ncols % 4:
        raise ValueError(f"columns in whole float4s: {ncols} along axis "
                         f"{axis} of {shape}")
    fast = (mode, trans, epi, two) in _TILED and ncols % TILE == 0 and {
        BANDED: n % TILE == 0,
        PFWD: n % TILE == 0 and nout == n,
        PINV: (n // 2) % BBS == 0 and nout == n,
        DENSE: (K % 8 == 0 and nout == K and nout % TILE == 0) if trans
        else nout == K,
    }[mode]
    if mode in (PFWD, PINV) and not (fast and mode == PFWD):
        # PINV, and the general PFWD: a block takes BBS rows of each half
        mtiles = -(-(nout // 2) // BBS)
    else:
        mtiles = -(-nout // TILE)
    return Geometry(mode, axis, tuple(shape), tuple(out), trans, batch, K,
                    n, nout, ld, ldo, pstride, pstrideo, ncols, ny, mtiles,
                    -(-ncols // TILE), not fast)


def out_rows(geo: Geometry):
    """The output row each (row tile, group, row) of the blocks writes,
    -1 where the row is masked: (mtiles, 2, BBS) int array. PINV's group g
    holds the a + b (g = 0) and the a - b (g = 1) halves' rows."""
    import numpy as np

    mt = np.arange(geo.mtiles)[:, None, None]
    g = np.arange(2)[None, :, None]
    r = np.arange(BBS)[None, None, :]
    ho = geo.nout // 2
    if geo.mode == PINV or (geo.mode == PFWD and geo.tail):
        rows = g * ho + mt * BBS + r
        ok = mt * BBS + r < ho
    else:
        rows = mt * TILE + g * BBS + r
        ok = rows < geo.nout
    return np.where(ok, rows, -1)


def apply(stage, mode, axis, jobs, epi=STORE, tabs=()):
    """One kernel launch applying operators along `axis` of (nx, ny, nz)
    fields. jobs: (mats, fields, out, sub) per field, with 1-2 (mat, field)
    sources summed into `out` (sub: the field it is subtracted from).
    tabs: the solve's A, B (per (y, z) of the output), k2x, tx2 (per x of
    it) [, Myz, mx: the Nyquist mask]; SOLVE follows a z apply (the x
    solve, pipeline stage B's, is the x-apply kernel's). The operators are
    (n_out, K): BANDED (n, WIN), PFWD and PINV [Me; Mo] (n_out, n/2),
    DENSE along y or z any (n_out, n) (along x: apply_dense); out and sub
    have n_out along the axis."""
    shape = tuple(jobs[0][1][0].shape)
    if mode == DENSE and axis == 0:
        raise ValueError("the dense x apply is apply_dense")
    nout, K = jobs[0][0][0].shape
    two = any(len(j[0]) == 2 for j in jobs)
    geo = geometry(mode, axis, shape, nout, K, epi, two)
    ptrs, nsrc = [], []
    for mats, fields, out, sub in jobs:
        if not 1 <= len(mats) == len(fields) <= 2:
            raise ValueError("a job takes one or two sources")
        for M in mats:
            _check(M, (nout, K), "operator")
        for t in fields:
            _check(t, shape, "field")
        for t in [out] + ([sub] if sub is not None else []):
            _check(t, geo.shape_out, "field")
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
    if solve:
        ox, oy, oz = geo.shape_out
        for t, k in zip(tabs, (oy * oz, oy * oz, ox, ox, oy * oz, ox)):
            _check(t, (k,), "solve table")
    _launch(stage, geo, epi, jobs[0][2].device, ptrs, nsrc, tabs)


def apply_dense(stage, op, f, out, sub=None):
    """The dense x apply: out = M f, or out = sub - M f, in one launch of
    the x-apply kernel (csrc/x_apply_manual.cu), counted as `stage` in
    x_apply_manual's launch counts. op: M (n_out, n_in) packed for it
    (x_apply_manual.pack, made once per operator); f (n_in, ny, nz); out
    and sub (n_out, ny, nz); n_in and n_out any, ny * nz a multiple of
    4."""
    xm.launch(stage, op, f, sub, out=out)


def _launch(stage, geo, epi, dev, ptrs, nsrc, tabs):
    """The launch itself, its error check and its count."""
    tab_ptrs = [t.data_ptr() for t in tabs] + [None] * (6 - len(tabs))
    parr = (ctypes.c_void_p * len(ptrs))(*ptrs)
    narr = (ctypes.c_int * len(nsrc))(*nsrc)
    tarr = (ctypes.c_void_p * 6)(*tab_ptrs)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib().pressure_pipe_apply(
            geo.mode, geo.trans, epi, len(nsrc), parr, narr, tarr, geo.batch,
            geo.K, geo.nrow, geo.nout, BW, geo.ld, geo.pstride, geo.ncols,
            geo.mtiles, int(geo.tail), geo.ldo, geo.pstrideo, geo.cpp,
            stream)
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
