"""Operator applies on the tensor cores: the wrapper of the Hopper kernel
in ``csrc/x_apply_manual.cu``, the host side of its split-TF32 operator,
and its plain PyTorch version.

One kernel serves seven TPU kernels of x3d2_tpu that compute the same
functions, out = M @_a f or out = s - M @_a f (M (n_out, n_in) applied
along one axis a of f), dense or in the parity-split forms, the forward
parity form along x also with the spectral solve in its epilogue:
- the dense x stage, _x_apply_kernel (pallas_poisson.py:954, call :1346):
  ``launch`` in its dense form, through ops/operator_apply.py
  ``apply_dense`` (the slab's ``x_apply``, the sharded ``XApplyOp``),
  counted as x_apply and x_apply[sub];
- the one-field parity x stage of a periodic x, _x_parity_fwd_kernel
  (pallas_poisson.py:997) and _x_parity_inv_kernel (:1025; call :1310):
  ``launch`` in its FWD and INV forms, through ops/pressure_slab.py
  ``x_apply_parity`` (X3D2_MERGED_X=0, pressure_grads, the sharded step),
  counted as x_pfwd, x_pinv and x_pinv[sub];
- the pipeline's stages A and C, _pipe_a_kernel (pallas_poisson.py:1378,
  call :1619) and _pipe_c_kernel (:1455, call :1703): ``launch_jobs``
  along z (the transposed form: the contraction along the contiguous
  axis) and along y (batched over the x planes), two launches a stage of
  up to three jobs, a job summing one or two sources, through
  ops/pressure_pipe.py, counted as pipe_a and pipe_c;
- the pipeline's stage B, _pipe_b_kernel (pallas_poisson.py:1405, call
  :1669): ``launch_jobs`` along x, a FWD launch of one two-source job with
  the solve (``solve=``: q = (Sx a + Ix e) * -1 / waves, the waves from
  the separable tables), then an INV launch of two jobs (Gxs q, Gxi q),
  through ops/pressure_pipe.py, counted as pipe_b;
- the manual-DMA x apply, make_x_apply_manual (pallas_manual.py:62; its
  kernel :114, pl.pallas_call :200): ``make_x_apply_manual(M64, sub,
  parity, slots)`` -> fn(f[, s]), parity "fwd" or "inv" running the
  parity-split forms (x modes in block-parity order) as the slab's x
  stage does; counted as x_apply_manual with its form's tags; S = slots
  2 to 8, 2 to 7 for "fwd" (MAX_SLOTS: its stage holds both halves'
  blocks, 32 KB). No path of the solver calls it, in x3d2_tpu or here:
  tools/prof_manual.py times it.

The kernel's products are split TF32 (three tensor-core products of hi/lo
halves, to float32 accuracy; see the source's head): its results are not
plain float32's bits, and are held to float64. The operator's split
is made here, once per operator (``pack``): hi = RNA(M) and lo = RNA(M -
hi) to TF32 (``split_tf32``, cvt.rna.tf32.f32's rounding), padded to whole
tiles and laid out as the shared-memory image of each (part, row tile, k
chunk) block (``block_index``); the field's split is made in registers.
``geometry`` computes a launch's tiles, items, grid and shared memory,
``item_of`` the (job, plane, column tile, row tile) of each item, and
``out_rows`` the output row each tile row writes (-1 where masked), in
one place for the launcher and the tests.
``tc_model`` is the kernel's arithmetic in numpy float32 (the three
products of the split operands, the sources summed, the solve
``solve_model``).

A function on CUDA tensors launches the kernel (or raises) and adds one
to its launch count; on CPU tensors it runs the plain version
(``x_apply_manual_plain``: the dense product, pfwd and pinv).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from .compact import apply_matrix
from .parity import parity_split_folded, pfwd, pinv

DENSE, FWD, INV = 0, 1, 2
# the kernel's geometry (x_apply_tc_geometry, checked when the library
# loads): plane columns an item, k a chunk, plane columns a field box, the
# most stages, threads a block, the fixed shared memory (barriers and
# alignment), a block's most on an H100, output rows an item by form,
# bytes of an operator block (hi and lo) by form, bytes of a ring stage by
# form (its operator blocks and field blocks; FWD both halves'); then the
# most stages that fit in a block's shared memory, by form
BM, KC, FBOX, MAX_S = 128, 16, 32, 8
NTHR = 384
# jobs a launch, sources a job (launch_jobs)
MAX_JOBS, MAX_SRC = 3, 2
SMEM_FIXED = 2 * 8 * MAX_S + 1024
SMEM_MAX = 232448
TILE_ROWS = {DENSE: 128, FWD: 64, INV: 64}
OP_BYTES = {f: 2 * bn * KC * 4 for f, bn in TILE_ROWS.items()}
STAGE_BYTES = {f: (2 if f == FWD else 1) * (OP_BYTES[f] + BM * KC * 4)
               for f in TILE_ROWS}
MAX_SLOTS = {f: min(MAX_S, (SMEM_MAX - SMEM_FIXED) // b)
             for f, b in STAGE_BYTES.items()}
# launches of the kernel, by name (x_apply, x_apply[sub]; x_pfwd, x_pinv,
# x_pinv[sub]; pipe_a, pipe_b, pipe_c; x_apply_manual, x_apply_manual[sub],
# [fwd], [inv], [inv,sub])
_LAUNCHES: dict[str, int] = {}
_LIB = None
_SMS: dict[int, int] = {}


def launch_counts() -> dict[str, int]:
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    _LAUNCHES.clear()


def lib():
    """The kernel library, built and typed at first use."""
    global _LIB
    if _LIB is None:
        from .. import _build

        so = _build.load("x_apply_manual")
        i, p = ctypes.c_int, ctypes.c_void_p
        so.x_apply_tc_launch_jobs.argtypes = [i, i, i, p, p, i, i,
                                              ctypes.c_longlong, i, i, i, p]
        so.x_apply_tc_launch_jobs.restype = i
        so.x_apply_tc_error_string.argtypes = [i]
        so.x_apply_tc_error_string.restype = ctypes.c_char_p
        so.x_apply_tc_geometry.argtypes = [ctypes.POINTER(i)]
        so.x_apply_tc_geometry.restype = i
        geo = (i * 18)()
        so.x_apply_tc_geometry(geo)
        want = (BM, KC, FBOX, MAX_S, NTHR, SMEM_FIXED, SMEM_MAX) + tuple(
            t[f] for t in (TILE_ROWS, OP_BYTES, STAGE_BYTES)
            for f in (DENSE, FWD, INV)) + (MAX_JOBS, MAX_SRC)
        if tuple(geo) != want:
            raise RuntimeError(f"x_apply_manual.cu geometry {tuple(geo)} "
                               f"differs from the wrapper's {want}")
        _LIB = so
    return _LIB


def stage_name(parity=None, sub=False):
    """The launch-count name of the manual entry: x_apply_manual with its
    form's tags."""
    tags = ([parity] if parity else []) + (["sub"] if sub else [])
    return "x_apply_manual" + (f"[{','.join(tags)}]" if tags else "")


def x_apply_manual_plain(M, f, s=None, parity=None):
    """M @_x f (parity "fwd": [Me; Mo] as pfwd, "inv" as pinv), or s minus
    it: the slab's plain x applies."""
    if parity is None:
        r = apply_matrix(M, f, 0)
    else:
        r = pfwd(M, f, 0) if parity == "fwd" else pinv(M, f, 0)
    return r if s is None else s - r


# -- the operator's split and its packing -----------------------------------

def split_tf32(x):
    """(hi, lo), both TF32 values in float32, x = hi + lo + O(2^-22 |x|):
    hi = RNA(x) and lo = RNA(x - hi), RNA the kernel's cvt.rna.tf32.f32
    (add half a TF32 unit, 0x1000, to the bits, keep the top 19: 10
    mantissa bits, ties away from zero)."""
    x = np.ascontiguousarray(x, dtype=np.float32)

    def rna(v):
        return ((v.view(np.uint32) + np.uint32(0x1000))
                & np.uint32(0xFFFFE000)).view(np.float32)

    hi = rna(x)
    return hi, rna(x - hi)


def block_index(bn):
    """Where element (r, k) of a (bn, KC) operator block lies in the
    kernel's shared-memory image, as a (bn, KC) array of float offsets:
    rows of 16 tf32 (64 bytes), the 16-byte chunk c of row r at chunk c ^
    ((r >> 1) & 3) (the 64-byte swizzle wgmma reads)."""
    r = np.arange(bn)[:, None]
    k = np.arange(KC)[None, :]
    return r * KC + (((k >> 2) ^ ((r >> 1) & 3)) << 2) + (k & 3)


@dataclass(frozen=True)
class XOperator:
    """An operator split and packed for the kernel. form: DENSE (M (n_out,
    K)) or FWD / INV (the parity stack [Me; Mo] (n_out, K), two parts of
    `rows` = n_out / 2); packed: (parts, rtiles, ktiles, 2, bn * KC)
    float32 on its device, hi then lo per block."""

    form: int
    n_out: int
    K: int
    rows: int
    packed: torch.Tensor


def pack(M, form=DENSE, device=None):
    """The kernel's operator from M (a tensor or an array, any float
    type; taken as float32, the values the plain float32 version uses):
    split (split_tf32), zero-padded to whole row tiles and k chunks, and
    laid out block by block (block_index). Made once per operator."""
    if torch.is_tensor(M):
        device = M.device if device is None else device
        M = M.detach().to("cpu", torch.float32).numpy()
    M = np.asarray(M, np.float32)
    n_out, K = M.shape
    if form != DENSE and n_out % 2:
        raise ValueError(f"a parity stack has an even row count, got "
                         f"{M.shape}")
    parts = 1 if form == DENSE else 2
    rows = n_out // parts
    bn = TILE_ROWS[form]
    rt, kt = -(-rows // bn), -(-K // KC)
    padded = np.zeros((parts, rt * bn, kt * KC), np.float32)
    padded[:, :rows, :K] = M.reshape(parts, rows, K)
    hi, lo = split_tf32(padded)
    out = np.empty((parts, rt, kt, 2, bn * KC), np.float32)
    idx = block_index(bn)
    for h, half in enumerate((hi, lo)):
        blocks = half.reshape(parts, rt, bn, kt, KC).transpose(0, 1, 3, 2, 4)
        out[:, :, :, h][..., idx] = blocks
    dev = torch.device("cpu") if device is None else torch.device(device)
    return XOperator(form, n_out, K, rows,
                     torch.as_tensor(out, device=dev).contiguous())


def a_columns(lines=False):
    """The plane column (0 .. BM - 1 of the item's tile; lines=True: the
    line of the z layout's item) that each consumer thread's A rows hold,
    as the kernel assigns them: (256, 2), [t, h] the column of wgmma row
    gid + 8 h of thread t's warp (gid = (t & 31) >> 2): warpgroup t >> 7
    takes the field boxes 2 (t >> 7) and 2 (t >> 7) + 1, warp w = (t >> 5)
    & 3 of it 16 columns of box 2 (t >> 7) + (w >> 1). In the x and y
    layouts the column 4 a + (gid & 3) of the box with a = 2 (w & 1) + h +
    4 (gid >> 2): in the box's 128-byte swizzled rows the 32 lanes of each
    fragment load then read 32 banks. In the z layout the box's line 16 (w
    & 1) + gid + 8 h: wgmma's own row order, whose 8 lines a fragment load
    meet 8 distinct 16-byte bank groups in the 64-byte swizzled lines. The
    sums are stored to the same columns (lines)."""
    t = np.arange(256)
    gid, w = (t & 31) >> 2, (t >> 5) & 3
    box = 2 * (t >> 7) + w // 2
    h = np.arange(2)[None, :]
    if lines:
        return box[:, None] * FBOX + (16 * (w & 1) + gid)[:, None] + 8 * h
    a = (2 * (w & 1) + 4 * (gid >> 2))[:, None] + h
    return box[:, None] * FBOX + 4 * a + (gid & 3)[:, None]


# -- the launch geometry -----------------------------------------------------

@dataclass(frozen=True)
class Geometry:
    """One launch: form, output rows a part (rows), contraction K, plane
    columns ncols (the z layout: lines); bn output rows of a part an item,
    rtiles row tiles a part, ktiles k chunks (K padded to kpad), ctiles
    column tiles of BM a plane, nitems work items (FWD and INV: both halves
    an item) over njobs jobs of nplanes planes, grid blocks, smem bytes of
    dynamic shared memory at `slots` stages; lines: the z layout (the
    contraction along the contiguous axis); solve: FWD's epilogue is the
    spectral solve (its four tables follow the jobs' pointers)."""

    form: int
    rows: int
    K: int
    ncols: int
    bn: int
    rtiles: int
    ktiles: int
    kpad: int
    ctiles: int
    nitems: int
    grid: int
    slots: int
    smem: int
    njobs: int = 1
    nplanes: int = 1
    lines: bool = False
    solve: bool = False


@functools.lru_cache(maxsize=512)
def geometry(form, n_out, K, ncols, sms, slots=4, njobs=1, nplanes=1,
             lines=False, sub=False, solve=False) -> Geometry:
    """The launch geometry of an operator (n_out, K) in form `form` over
    ncols plane columns of nplanes planes (lines=True: ncols lines of the z
    layout) for njobs jobs on `sms` SMs at `slots` stages (2 to
    MAX_SLOTS[form]: 8, FWD 7); sub: with the subtraction (DENSE and INV
    in the x and y layouts); solve: with the solve (FWD in the x layout,
    one plane). Raises ValueError on what the kernel does not take."""
    if form not in (DENSE, FWD, INV):
        raise ValueError(f"no form {form}")
    if n_out < 1 or K < 1 or (form != DENSE and n_out % 2):
        raise ValueError(f"operator ({n_out}, {K}) does not fit form {form}")
    if not 1 <= njobs <= MAX_JOBS or nplanes < 1 or (lines and nplanes != 1):
        raise ValueError(f"1 to {MAX_JOBS} jobs a launch, planes only along "
                         f"x and y: got {njobs} jobs of {nplanes} planes")
    if lines:
        # the field's lines and the output's in whole 16-byte rows of the
        # tensor map, the output's pairs of rows whole
        if form == DENSE or K % 2 or (n_out // 2) % 2 or ncols < 1 or sub:
            raise ValueError(f"the z layout takes the parity forms with K "
                             f"and the half even and no subtraction, got "
                             f"form {form}, ({n_out}, {K}), sub={sub}")
    elif ncols < 4 or ncols % 4:
        raise ValueError(f"the kernel takes plane columns in a multiple of "
                         f"4, got {ncols}")
    if sub and form == FWD:
        raise ValueError("the subtraction is an inverse-stage fusion")
    if solve and (form != FWD or lines or nplanes != 1 or sub):
        raise ValueError(f"the solve follows the FWD form along x, got form "
                         f"{form}, lines={lines}, {nplanes} planes, "
                         f"sub={sub}")
    if not 2 <= slots <= MAX_SLOTS[form]:
        raise ValueError(f"form {form} takes 2 to {MAX_SLOTS[form]} stages "
                         f"({STAGE_BYTES[form]} bytes each), got {slots}")
    rows = n_out if form == DENSE else n_out // 2
    bn = TILE_ROWS[form]
    rtiles, ktiles, ctiles = -(-rows // bn), -(-K // KC), -(-ncols // BM)
    nitems = njobs * nplanes * ctiles * rtiles
    if nitems >= 2 ** 31:
        raise ValueError(f"{nitems} items past the kernel's count")
    return Geometry(form, rows, K, ncols, bn, rtiles, ktiles, ktiles * KC,
                    ctiles, nitems, min(sms, nitems), slots,
                    slots * STAGE_BYTES[form] + SMEM_FIXED, njobs, nplanes,
                    lines, bool(solve))


def item_of(geo: Geometry, it):
    """(job, plane, column tile, row tile) of item `it` (an int or an
    array), as the kernel walks them: the row tile fastest, then the
    column tile, the plane, the job."""
    per_job = geo.nplanes * geo.ctiles * geo.rtiles
    job, r = np.divmod(it, per_job)
    r, rt = np.divmod(r, geo.rtiles)
    plane, ct = np.divmod(r, geo.ctiles)
    return job, plane, ct, rt


def out_rows(geo: Geometry):
    """The output row each (group, row tile, tile row) writes, -1 where
    the row is masked: (2, rtiles, bn) int array (DENSE: group 1 all -1).
    FWD: group h the half h (E, O); INV: group 0 the a + b rows, group 1
    the a - b rows."""
    g = np.arange(2)[:, None, None]
    rt = np.arange(geo.rtiles)[None, :, None]
    n = np.arange(geo.bn)[None, None, :]
    row = rt * geo.bn + n
    ok = (row < geo.rows) & ((g == 0) | (geo.form != DENSE))
    return np.where(ok, g * geo.rows + row, -1)


def tc_model(M, f, s=None, parity=None, solve=None):
    """The kernel's arithmetic in numpy float32: both operands split
    (split_tf32; FWD forms f1 +/- f2 first, in float32), out = A_lo B_hi +
    A_hi B_lo + A_hi B_hi, each product a float32 matrix product, summed
    in that order; INV sums a and b apart, then a + b and a - b. M
    (n_out, K) float32 (the parity stack [Me; Mo]); f (n_in, ny, nz). M
    and f may be sequences of one job's sources, their results summed in
    float32 in order. solve: (tab_a, tab_b, k2x, tx2) with parity "fwd",
    the solve epilogue (solve_model) on the sum."""
    Ms = list(M) if isinstance(M, (list, tuple)) else [M]
    fs = list(f) if isinstance(f, (list, tuple)) else [f]
    if solve is not None and (parity != "fwd" or s is not None):
        raise ValueError("the solve follows the FWD form")

    def prod(Mp, A):
        mh, ml = split_tf32(Mp)
        ah, al = split_tf32(A)
        return (mh @ al + ml @ ah) + mh @ ah

    def one(M, f):
        M = np.asarray(M, np.float32)
        f2 = np.asarray(f, np.float32).reshape(f.shape[0], -1)
        if parity is None:
            return prod(M, f2)
        h, ho = f2.shape[0] // 2, M.shape[0] // 2
        if parity == "fwd":
            return np.concatenate([prod(M[:ho], f2[:h] + f2[h:]),
                                   prod(M[ho:], f2[:h] - f2[h:])])
        a, b = prod(M[:ho], f2[:h]), prod(M[ho:], f2[h:])
        return np.concatenate([a + b, a - b])

    r = one(Ms[0], fs[0])
    for Mi, fi in zip(Ms[1:], fs[1:]):
        r = r + one(Mi, fi)
    if solve is not None:
        r = solve_model(r, *solve)
    r = r.reshape((np.shape(Ms[0])[0],) + tuple(fs[0].shape[1:]))
    return r if s is None else np.asarray(s, np.float32) - r


def solve_model(F, tab_a, tab_b, k2x, tx2):
    """The solve epilogue in numpy float32: F (n_out, ...) times -1 /
    waves, waves = k2x[r] tab_a[c] + tx2[r] tab_b[c] for output row r and
    plane column c (0 where |waves| < 1e-16), as x3d2_tpu's _pipe_b_kernel
    (pallas_poisson.py:1440-1443) computes it (the kernel may contract
    the sum into a fused multiply-add: one rounding less)."""
    F = np.asarray(F, np.float32)
    A, B, kx, tx = (np.asarray(t, np.float32).reshape(-1)
                    for t in (tab_a, tab_b, k2x, tx2))
    waves = kx[:, None] * A[None, :] + tx[:, None] * B[None, :]
    ok = np.abs(waves) >= np.float32(1e-16)
    fac = np.where(ok, np.float32(-1) / np.where(ok, waves, np.float32(1)),
                   np.float32(0))
    return (F.reshape(F.shape[0], -1) * fac).reshape(F.shape)


# -- the launch --------------------------------------------------------------

def _check(t, name, dev):
    if not t.is_cuda:
        raise ValueError(f"{name}: the x-apply kernel runs on CUDA tensors, "
                         f"got {t.device}")
    if t.device != dev or t.dtype != torch.float32 \
            or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel takes a contiguous, 16-byte "
                         f"aligned float32 tensor on {dev}, got {t.dtype} "
                         f"on {t.device}")


def _sm_count(dev):
    """The SM count of device dev, read once."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def _overlap(a, b):
    return a.data_ptr() < b.data_ptr() + 4 * b.numel() \
        and b.data_ptr() < a.data_ptr() + 4 * a.numel()


def launch(stage, op: XOperator, f, s=None, out=None, slots=4):
    """One launch on CUDA tensors, counted as `stage`: out = M f (or s - M
    f; FWD and INV the parity forms) along x, with op the packed operator
    (pack). f (n_in, ny, nz): n_in = K (DENSE) or 2 K; out and s (n_out,
    ny, nz); out made here unless given, never overlapping f. Raises on
    what the kernel does not take (shapes, an aliased output, then devices
    and types), and when the launch fails."""
    return launch_jobs(stage, 0, [([op], [f], out, s)], slots)[0]


def launch_jobs(stage, axis, jobs, slots=4, solve=None):
    """One launch on CUDA tensors, counted as `stage`, of up to MAX_JOBS
    jobs along `axis` of (nx, ny, nz) fields: a job (ops, fields, out, s)
    sums the applies of its 1 to MAX_SRC sources, the packed operators
    `ops` (pack; one form and size a launch) along the axis of `fields`,
    into out, or subtracts the sum from s (the INV and DENSE forms along x
    and y; all jobs or none). Along x one plane of ny nz columns, along y
    nx planes of nz columns, along z (the parity forms) nx ny lines; n_in
    = K (DENSE) or 2 K along the axis, out and s n_out along it. The
    sources of a job sum in one chain of k chunks, the first source's
    first. solve: (tab_a, tab_b, k2x, tx2), float32 vectors of ny nz, ny
    nz, n_out and n_out on the fields' device: the FWD form along x
    without s multiplies each output (x mode r, column c) by -1 / (k2x[r]
    tab_a[c] + tx2[r] tab_b[c]), 0 where that is below 1e-16 in magnitude.
    out made here where None, overlapping no field and no other output.
    Returns the outputs. Raises on what the kernel does not take (shapes,
    an aliased output, the solve's form, axis and tables, then devices
    and types), and when the launch fails."""
    if not 1 <= len(jobs) <= MAX_JOBS:
        raise ValueError(f"1 to {MAX_JOBS} jobs a launch and 1 to "
                         f"{MAX_SRC} (operator, field) sources a job")
    op0 = jobs[0][0][0] if jobs[0][0] else None
    if not isinstance(op0, XOperator):
        raise TypeError("the kernel takes the packed operator (pack)")
    form, n_out, K = op0.form, op0.n_out, op0.K
    sub = jobs[0][3] is not None
    shape = jobs[0][1][0].shape
    want = list(shape)
    want[axis] = n_out
    want = tuple(want)
    fit = len(shape) == 3 and shape[axis] == (K if form == DENSE else 2 * K)
    fields, given = [], []
    for ops, fs, out, s in jobs:
        for op in ops:
            if not isinstance(op, XOperator):
                raise TypeError("the kernel takes the packed operator (pack)")
        if form == FWD and s is not None:
            raise ValueError("the subtraction is an inverse-stage fusion")
        if not 1 <= len(ops) == len(fs) <= MAX_SRC:
            raise ValueError(f"1 to {MAX_JOBS} jobs a launch and 1 to "
                             f"{MAX_SRC} (operator, field) sources a job")
        for op in ops:
            if op.form != form or op.n_out != n_out or op.K != K:
                raise ValueError("the operators of a launch take one form "
                                 "and size")
        if (s is not None) != sub:
            raise ValueError("the subtraction takes all jobs of a launch or "
                             "none")
        if axis == 2 and s is not None:
            raise ValueError("the z layout takes no subtraction")
        for f in fs:
            fit = fit and f.shape == shape
        for t in (out, s):
            fit = fit and (t is None or t.shape == want)
        fields += fs
        if out is not None:
            given.append(out)
    if not fit:
        raise ValueError(f"operator ({n_out}, {K}) of form {form} does not "
                         f"fit the field {tuple(shape)} and the output {want} "
                         f"along axis {axis}")
    for i, o in enumerate(given):
        if any(_overlap(o, t) for t in fields + given[:i]):
            raise ValueError("the output may not alias the field or another "
                             "output")
    dev = fields[0].device
    tabs = [] if solve is None else _solve_tables(solve, form, axis, sub,
                                                  shape, n_out, dev)
    outs, ptrs = [], []
    pad = [None] * MAX_SRC
    for ops, fs, out, s in jobs:
        if out is None:
            out = torch.empty(want, dtype=fields[0].dtype, device=dev)
        outs.append(out)
        for op in ops:
            _check(op.packed, "packed operator", dev)
        for f in fs:
            _check(f, "field", dev)
        _check(out, "output", dev)
        if s is not None:
            _check(s, "s", dev)
        n = MAX_SRC - len(ops)
        ptrs += [op.packed.data_ptr() for op in ops] + pad[:n] \
            + [f.data_ptr() for f in fs] + pad[:n] \
            + [None if s is None else s.data_ptr(), out.data_ptr()]
    for t in tabs:
        _check(t, "solve table", dev)
    nx, ny, nz = shape
    ncols, nplanes = ((ny * nz, 1), (nz, nx), (nx * ny, 1))[axis]
    geo = geometry(form, n_out, K, ncols, _sm_count(dev), slots, len(jobs),
                   nplanes, axis == 2, sub, solve is not None)
    _launch(stage, geo, dev, ptrs + [t.data_ptr() for t in tabs])
    return outs


def _solve_tables(solve, form, axis, sub, shape, n_out, dev):
    """The solve's four tables, checked: the FWD form along x without s;
    float32 vectors of ny nz (tab_a, tab_b) and n_out (k2x, tx2) on the
    fields' device."""
    if form != FWD or axis != 0 or sub:
        raise ValueError(f"the solve follows the FWD form along x without "
                         f"s, got form {form} along axis {axis}, sub={sub}")
    if len(solve) != 4:
        raise ValueError("the solve takes four tables: tab_a, tab_b, k2x, "
                         "tx2")
    lens = (shape[1] * shape[2],) * 2 + (n_out,) * 2
    for name, t, n in zip(("tab_a", "tab_b", "k2x", "tx2"), solve, lens):
        if not torch.is_tensor(t) or t.dim() != 1 or t.numel() != n:
            raise ValueError(f"solve table {name}: a vector of {n} values, "
                             f"got {getattr(t, 'shape', type(t))}")
        if t.dtype != torch.float32 or t.device != dev:
            raise ValueError(f"solve table {name}: float32 on {dev}, got "
                             f"{t.dtype} on {t.device}")
    return list(solve)


def _launch(stage, geo: Geometry, dev, ptrs):
    """The launch itself, its error check and its count. ptrs: the jobs'
    pointers, then with the solve its four tables'."""
    idx = torch.cuda.current_device() if dev.index is None else dev.index
    n = len(ptrs) - (4 if geo.solve else 0)
    tabs = (ctypes.c_void_p * 4)(*ptrs[n:]) if geo.solve else None
    # the raw handle: a Stream object costs the host several µs a launch
    args = (geo.form, int(geo.lines), geo.njobs,
            (ctypes.c_void_p * n)(*ptrs[:n]), tabs, geo.rows, geo.K,
            geo.ncols, geo.nplanes, geo.slots, geo.grid,
            torch._C._cuda_getCurrentRawStream(idx))
    if idx == torch.cuda.current_device():
        err = lib().x_apply_tc_launch_jobs(*args)
    else:
        with torch.cuda.device(dev):
            err = lib().x_apply_tc_launch_jobs(*args)
    if err != 0:
        msg = lib().x_apply_tc_error_string(err).decode()
        raise RuntimeError(f"x-apply kernel launch failed: {msg} ({err})")
    _LAUNCHES[stage] = _LAUNCHES.get(stage, 0) + 1


def x_apply_manual(M, f, s=None, parity=None, slots=4, packed=None):
    """One launch on CUDA tensors (M float32: dense (n_out, n_in), or the
    parity stack [Me; Mo] (n_out, n_in / 2); the kernel takes it packed,
    made here unless given); the plain version on CPU ones. slots: the
    pipeline's stages, S (2 to MAX_SLOTS[form])."""
    if not f.is_cuda:
        if f.device.type != "cpu":
            raise ValueError(f"no x_apply_manual for device {f.device}")
        return x_apply_manual_plain(M.to(f.dtype), f, s, parity)
    form = {None: DENSE, "fwd": FWD, "inv": INV}[parity]
    if packed is None:
        packed = pack(M, form, f.device)
    if packed.form != form:
        raise ValueError(f"operator packed for form {packed.form}, not "
                         f"{parity}")
    return launch(stage_name(parity, s is not None), packed, f, s,
                  slots=slots)


def make_x_apply_manual(M64, sub=False, parity=None, slots=4, device=None):
    """fn(f[, s]) = M @_x f [or s - M @_x f with sub], M64 the (n_out,
    n_in) float64 operator (parity: its parity split, built here, as
    x3d2_tpu's make_x_apply_manual builds it). fn.op(dtype): the operator
    (the parity stack [Me; Mo]) as the plain version takes it; the kernel
    takes it packed (pack), made at the first CUDA call. slots: the
    kernel's stages, S = 2 to 8, 2 to 7 with parity "fwd" (MAX_SLOTS)."""
    from ..common import resolve_device

    M64 = np.asarray(M64, np.float64)
    n_out, n_in = M64.shape
    if parity is not None and (n_in % 2 or n_out % 2):
        raise ValueError("parity x-apply needs even extents")
    if parity == "fwd" and sub:
        raise ValueError("sub is an inverse-stage fusion")
    form = {None: DENSE, "fwd": FWD, "inv": INV}[parity]
    if not 2 <= slots <= MAX_SLOTS[form]:
        raise ValueError(f"parity {parity} takes 2 to {MAX_SLOTS[form]} "
                         f"stages, got {slots}")
    if parity is not None:
        M64 = np.concatenate(parity_split_folded(
            M64, 0 if parity == "fwd" else 1))
    device = resolve_device(device)
    mats = {}

    def op(dtype):
        if dtype not in mats:
            mats[dtype] = torch.as_tensor(M64, dtype=dtype,
                                          device=device).contiguous()
        return mats[dtype]

    def fn(f, s=None):
        if (s is not None) != sub:
            raise ValueError(f"built with sub={sub}")
        if not f.is_cuda:
            return x_apply_manual(op(f.dtype), f, s, parity, slots)
        if "packed" not in mats:
            mats["packed"] = pack(op(torch.float32), form)
        return x_apply_manual(op(torch.float32), f, s, parity, slots,
                              mats["packed"])

    fn.op = op
    return fn
