"""The x apply on the tensor cores: the wrapper of the Hopper kernel in
``csrc/x_apply_manual.cu``, the host side of its split-TF32 operator, and
its plain PyTorch version.

One kernel serves four TPU kernels of x3d2_tpu that compute the same
functions, out = M @_x f or out = s - M @_x f (M (n_out, n_in), f (n_in,
ny, nz)), dense or in the parity-split forms:
- the dense x stage, _x_apply_kernel (pallas_poisson.py:954, call :1346):
  ``launch`` in its dense form, through ops/operator_apply.py
  ``apply_dense`` (the slab's ``x_apply``, the sharded ``XApplyOp``),
  counted as x_apply and x_apply[sub];
- the one-field parity x stage of a periodic x, _x_parity_fwd_kernel
  (pallas_poisson.py:997) and _x_parity_inv_kernel (:1025; call :1310):
  ``launch`` in its FWD and INV forms, through ops/pressure_slab.py
  ``x_apply_parity`` (X3D2_MERGED_X=0, pressure_grads, the sharded step),
  counted as x_pfwd, x_pinv and x_pinv[sub];
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
and ``out_rows`` the output row each tile row writes (-1 where masked), in
one place for the launcher and the tests.
``tc_model`` is the kernel's arithmetic in numpy float32 (the three
products of the split operands).

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
SMEM_FIXED = 2 * 8 * MAX_S + 1024
SMEM_MAX = 232448
TILE_ROWS = {DENSE: 128, FWD: 64, INV: 64}
OP_BYTES = {f: 2 * bn * KC * 4 for f, bn in TILE_ROWS.items()}
STAGE_BYTES = {f: (2 if f == FWD else 1) * (OP_BYTES[f] + BM * KC * 4)
               for f in TILE_ROWS}
MAX_SLOTS = {f: min(MAX_S, (SMEM_MAX - SMEM_FIXED) // b)
             for f, b in STAGE_BYTES.items()}
# launches of the kernel, by name (x_apply, x_apply[sub]; x_pfwd, x_pinv,
# x_pinv[sub]; x_apply_manual, x_apply_manual[sub], [fwd], [inv],
# [inv,sub])
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
        so.x_apply_tc_launch.argtypes = [i, p, p, p, p, i, i,
                                         ctypes.c_longlong, i, i, p]
        so.x_apply_tc_launch.restype = i
        so.x_apply_tc_error_string.argtypes = [i]
        so.x_apply_tc_error_string.restype = ctypes.c_char_p
        so.x_apply_tc_geometry.argtypes = [ctypes.POINTER(i)]
        so.x_apply_tc_geometry.restype = i
        geo = (i * 16)()
        so.x_apply_tc_geometry(geo)
        want = (BM, KC, FBOX, MAX_S, NTHR, SMEM_FIXED, SMEM_MAX) + tuple(
            t[f] for t in (TILE_ROWS, OP_BYTES, STAGE_BYTES)
            for f in (DENSE, FWD, INV))
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


def a_columns():
    """The plane column (0 .. BM - 1 of the item's tile) that each
    consumer thread's A rows hold, as the kernel assigns them: (256, 2),
    [t, h] the column of wgmma row gid + 8 h of thread t's warp (gid = (t &
    31) >> 2): warpgroup t >> 7 takes the field boxes 2 (t >> 7) and 2 (t
    >> 7) + 1, warp w = (t >> 5) & 3 of it 16 columns of box 2 (t >> 7) + (w
    >> 1), the column 4 a + (gid & 3) of the box with a = 2 (w & 1) + h + 4
    (gid >> 2); in the box's 128-byte swizzled rows the 32 lanes of each
    fragment load then read 32 banks. The sums are stored to the same
    columns."""
    t = np.arange(256)
    gid, w = (t & 31) >> 2, (t >> 5) & 3
    box = 2 * (t >> 7) + w // 2
    a = (2 * (w & 1) + 4 * (gid >> 2))[:, None] + np.arange(2)[None, :]
    return box[:, None] * FBOX + 4 * a + (gid & 3)[:, None]


# -- the launch geometry -----------------------------------------------------

@dataclass(frozen=True)
class Geometry:
    """One launch: form, output rows a part (rows), contraction K, plane
    columns ncols; bn output rows of a part an item, rtiles row tiles a
    part, ktiles k chunks (K padded to kpad), ctiles column tiles of BM,
    nitems work items (FWD and INV: both halves an item), grid blocks,
    smem bytes of dynamic shared memory at `slots` stages."""

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


@functools.lru_cache(maxsize=512)
def geometry(form, n_out, K, ncols, sms, slots=4) -> Geometry:
    """The launch geometry of an operator (n_out, K) in form `form` over
    ncols plane columns on `sms` SMs at `slots` stages (2 to
    MAX_SLOTS[form]: 8, FWD 7). Raises ValueError on what the kernel does
    not take."""
    if form not in (DENSE, FWD, INV):
        raise ValueError(f"no form {form}")
    if n_out < 1 or K < 1 or (form != DENSE and n_out % 2):
        raise ValueError(f"operator ({n_out}, {K}) does not fit form {form}")
    if ncols < 4 or ncols % 4:
        raise ValueError(f"the kernel takes ny * nz a multiple of 4, got "
                         f"{ncols}")
    if not 2 <= slots <= MAX_SLOTS[form]:
        raise ValueError(f"form {form} takes 2 to {MAX_SLOTS[form]} stages "
                         f"({STAGE_BYTES[form]} bytes each), got {slots}")
    rows = n_out if form == DENSE else n_out // 2
    bn = TILE_ROWS[form]
    rtiles, ktiles, ctiles = -(-rows // bn), -(-K // KC), -(-ncols // BM)
    nitems = ctiles * rtiles
    if nitems >= 2 ** 31:
        raise ValueError(f"{nitems} items past the kernel's count")
    return Geometry(form, rows, K, ncols, bn, rtiles, ktiles, ktiles * KC,
                    ctiles, nitems, min(sms, nitems), slots,
                    slots * STAGE_BYTES[form] + SMEM_FIXED)


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


def tc_model(M, f, s=None, parity=None):
    """The kernel's arithmetic in numpy float32: both operands split
    (split_tf32; FWD forms f1 +/- f2 first, in float32), out = A_lo B_hi +
    A_hi B_lo + A_hi B_hi, each product a float32 matrix product, summed
    in that order; INV sums a and b apart, then a + b and a - b. M
    (n_out, K) float32 (the parity stack [Me; Mo]); f (n_in, ny, nz)."""
    M = np.asarray(M, np.float32)
    f = np.asarray(f, np.float32)
    f2 = f.reshape(f.shape[0], -1)

    def prod(Mp, A):
        mh, ml = split_tf32(Mp)
        ah, al = split_tf32(A)
        return (mh @ al + ml @ ah) + mh @ ah

    if parity is None:
        r = prod(M, f2)
    else:
        h, ho = f2.shape[0] // 2, M.shape[0] // 2
        if parity == "fwd":
            r = np.concatenate([prod(M[:ho], f2[:h] + f2[h:]),
                                prod(M[ho:], f2[:h] - f2[h:])])
        else:
            a, b = prod(M[:ho], f2[:h]), prod(M[ho:], f2[h:])
            r = np.concatenate([a + b, a - b])
    r = r.reshape((M.shape[0],) + f.shape[1:])
    return r if s is None else np.asarray(s, np.float32) - r


# -- the launch --------------------------------------------------------------

def _check(t, name, dev):
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


def launch(stage, op: XOperator, f, s=None, out=None, slots=4):
    """One launch on CUDA tensors, counted as `stage`: out = M f (or s - M
    f; FWD and INV the parity forms) with op the packed operator (pack).
    f (n_in, ny, nz): n_in = K (DENSE) or 2 K; out and s (n_out, ny, nz);
    out made here unless given, never overlapping f. Raises on what the
    kernel does not take (shapes, an aliased output, then devices and
    types), and when the launch fails."""
    if not isinstance(op, XOperator):
        raise TypeError("the kernel takes the packed operator (pack)")
    if op.form == FWD and s is not None:
        raise ValueError("the subtraction is an inverse-stage fusion")
    n_in, ny, nz = f.shape
    want = (op.n_out, ny, nz)
    if n_in != (op.K if op.form == DENSE else 2 * op.K) \
            or any(t is not None and tuple(t.shape) != want
                   for t in (s, out)):
        raise ValueError(f"operator ({op.n_out}, {op.K}) of form {op.form} "
                         f"does not fit the field {tuple(f.shape)} and the "
                         f"output {want}")
    if out is not None and out.data_ptr() < f.data_ptr() + 4 * f.numel() \
            and f.data_ptr() < out.data_ptr() + 4 * out.numel():
        raise ValueError("the output may not alias the field")
    dev = f.device
    if not f.is_cuda:
        raise ValueError(f"the x-apply kernel runs on CUDA tensors, got "
                         f"{dev}")
    if out is None:
        out = torch.empty(want, dtype=f.dtype, device=dev)
    for t, name in ((op.packed, "packed operator"), (f, "field"),
                    (out, "output"), (s, "s")):
        if t is not None:
            _check(t, name, dev)
    geo = geometry(op.form, op.n_out, op.K, ny * nz, _sm_count(dev), slots)
    idx = torch.cuda.current_device() if dev.index is None else dev.index
    # the raw handle: a Stream object costs the host several µs a launch
    args = (op.form, op.packed.data_ptr(), f.data_ptr(),
            s.data_ptr() if s is not None else None, out.data_ptr(),
            geo.rows, op.K, geo.ncols, slots, geo.grid,
            torch._C._cuda_getCurrentRawStream(idx))
    if idx == torch.cuda.current_device():
        err = lib().x_apply_tc_launch(*args)
    else:
        with torch.cuda.device(dev):
            err = lib().x_apply_tc_launch(*args)
    if err != 0:
        msg = lib().x_apply_tc_error_string(err).decode()
        raise RuntimeError(f"x-apply kernel launch failed: {msg} ({err})")
    _LAUNCHES[stage] = _LAUNCHES.get(stage, 0) + 1
    return out


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
