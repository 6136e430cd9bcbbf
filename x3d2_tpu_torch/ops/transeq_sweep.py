"""Directional transport sweeps over banded operator blocks, with the
fused time update: the wrapper of the Hopper kernel
``csrc/transeq_sweep.cuh`` and its plain PyTorch version.

Counterpart of the sweeps of x3d2_tpu.ops.pallas_kernels: the z sweep
``_pencil_kernel`` (pallas_kernels.py:671), the accumulating x sweep and
the accumulating y sweep with the AB or RK epilogue, both
``_transeq_kernel_v3`` (pallas_kernels.py:172). For one sweep axis and each
component q of (u, v, w), with conv the component aligned with the axis:

    r = -1/2 (conv * D1 q + D1d (q * conv)) + nu * D2 q   [+ acc]

and with the update (``dtc`` given) also rhs = r and
u' = base + dtc0 * r + sum_j dtc_{j+1} * old_j, where base is u itself
(the AB update, olds = the derivative history; and the first RK substage)
or the RK step-initial field f0 (``base``; pallas_kernels.py:195-200,
:304-326), olds then the earlier stage derivatives with a nonzero
coefficient. The xdiv variant (the x sweep
with the AB epilogue; pallas_kernels.py:202-211, :327-364) also emits the
projection's forward x transforms of the updated velocities, du = Sx u',
dv = Ix v', dw = Ix w' as parity splits with the modes in block-parity
order, so the slab projection skips its x_div3 (ops/pressure_slab.py).

Reduced precision (x3d2_tpu's olds_dtype and acc_dtype, X3D2_BF16_OLDS and
X3D2_BF16_ACC; pallas_kernels.py:304-326, :448-460, :567-640): a bfloat16
history (the olds; the rhs is then stored rounded to bfloat16 and u' gains
the error feedback dtc4 * (r - bf16(r)), dtc4 = dt * future_coeff_sum) and
bfloat16 partials (``acc_dtype``: the accumulate input, and the output of a
sweep without the update). Arithmetic is float32 (the inputs' dtype in the
plain version): a bfloat16 stream is widened when read and rounded to
nearest even when written.

The operators are band-truncated per output block of BS points (window
BS + 2W, periodic wrap; ops/banded.py). The geometry follows x3d2_tpu's
mode (``terms``, X3D2_MATMUL_PRECISION; GEOMETRY): by default every axis
uses BS=64, W=16 (the TPU's z blocking, 128/64, is a lane rule, and W=16
passes the truncation check at 1e-6 for the uniform compact6 operators);
in the HIGHEST mode (terms=3) W=32, x3d2_tpu's band on its non-lane axes
(pallas_kernels.py:484, :747, :1131), here on every axis, with BS=32 so
that the window stays 96 wide: the truncation falls to float32 epsilon
(pallas_kernels.py:24-25, :480-483). Each geometry is its own library
(``transeq_sweep.cu``, ``transeq_sweep_w32.cu``), both with the
reduced-precision instances. The operators are f32 (no bf16 hi/lo splits: those worked
around the TPU matrix unit), and the kernel accumulates in f32 FMA.

The halo form (x3d2_tpu's halo_ext sweeps, make_transeq_dir_v3(...,
n_shards > 1), pallas_kernels.py:238-252, :404-427, :556-630; the sharded
chain of parallel/shard_kernels.py): u, v, w are one rank's shard along
the sweep axis, ``exts`` the halo-extended operands (the shard between the
previous rank's last W planes and the next rank's first W planes, n + 2W
along the axis; W the port's band, 16 or 32, not x3d2_tpu's 64-plane lane
halo), the windows are read from them without a wrap, and the operator
blocks are the global stack's from block ``off`` (the rank's position on
the axis times its nb blocks), so a non-periodic axis' closure rows land on
the ranks that own them. Partial sweeps only, as in x3d2_tpu (its halo
sweeps take no update).

Two bodies of the kernel serve a CUDA launch (``tc_route``). At the
default mode's geometry the tensor-core body (transeq_sweep_tc_kernel,
library ``transeq_sweep_tc.cu``) takes every sweep of an axis whose
operators are circulant (a uniform periodic one) but the xdiv variant and
the halo form: split-TF32 wgmma products of each 16-row slice of an
output block with the 48 window columns of its band (``SweepBlocks.tc``,
packed when the blocks are built: the three images a pairing that every
slice and block repeats; ``tc_model`` is its arithmetic in float32 on the
CPU; ``tc_writes`` its walk of the outputs). Its results are held to
float64 (3-4e-7 of max |plain f64|), not plain float32's bits. The SIMT
body takes the HIGHEST mode's W = 32, the halo form, the xdiv variant
(its own kernel), and the axes whose operators the packer refuses (a
non-periodic axis: its closure rows differ from slice to slice). Launches
of either are counted by variant name (``launch_counts``), the
tensor-core body's also in ``tc_launch_counts``.

``transeq_sweep`` launches the kernel for CUDA tensors (or raises) and
runs ``transeq_sweep_plain`` for CPU tensors only.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field

import numpy as np
import torch

from ..common import resolve_device
from ..time_integrators import TimeIntegrator
from .banded import banded_blocks
from .parity import parity_split_folded, pfwd

# (output points per block along the sweep axis, band half-width) by
# x3d2_tpu's kernel terms (ops/compact.py matmul_terms), and the library
# built at each band
GEOMETRY = {2: (64, 16), 3: (32, 32)}
_LIB_NAME = {16: "transeq_sweep", 32: "transeq_sweep_w32"}
BS, W = GEOMETRY[2]   # the default mode's
TL = 64        # lines per kernel tile
_BAND_TOL = 1e-6      # x3d2_tpu's (pallas_kernels.py:143), both modes
# the xdiv kernel keeps n / 4 accumulators a thread in registers across the
# x blocks of a line tile: it is built for the sizes the step takes it at
# (cases/base.py: max(dims) <= 256)
XDIV_MAX_N = 256
_EQUAL_BLOCKS_TOL = 1e-12   # SweepBlocks.require_equal_blocks
MAX_SPECIES = 8   # scalars per species launch (ops/species_sweep.py)
# the RK substage updates the kernel is built with, (history fields,
# separate base): the rows of the RK1-4 tableaus (make_fused_transeq_rk),
# on the y sweep that ends the chain
RK_INSTANCES = {(0, False), (0, True), (2, True), (3, True)}

# launches of the kernel per variant name, counted where it is launched;
# those of the tensor-core body (tc_route) also in _TC_LAUNCHES
_LAUNCHES: dict[str, int] = {}
_TC_LAUNCHES: dict[str, int] = {}


def variant_name(axis: int, accumulate: bool, nolds: int,
                 xdiv: bool = False, upd: bool | None = None,
                 base_sep: bool = False, olds_bf16: bool = False,
                 acc_bf16: bool = False, w: int = W,
                 halo: bool = False) -> str:
    """The kernel instance's name. upd (default: nolds > 0) is the fused
    update; an update with history and the sweep's own base is the AB one
    (``ab<k>``), the others are the RK substage updates (``rk<nolds>``, and
    ``f0`` where the base is the step-initial field). ``bf16olds``,
    ``bf16acc``: the bfloat16 history, the bfloat16 partials; ``halo``: the
    halo form of a sharded axis; ``w32``: the HIGHEST mode's band (w, the
    band half-width)."""
    if upd is None:
        upd = nolds > 0
    tags = ["xyz"[axis]] + (["acc"] if accumulate else [])
    if upd and (base_sep or not nolds):
        tags += [f"rk{nolds}"] + (["f0"] if base_sep else [])
    elif upd:
        tags.append(f"ab{nolds + 1}")
    tags += (["xdiv"] if xdiv else []) + (["bf16olds"] if olds_bf16 else []) \
        + (["bf16acc"] if acc_bf16 else []) + (["halo"] if halo else []) \
        + ([f"w{w}"] if w != W else [])
    return "transeq_sweep[" + ",".join(tags) + "]"


def geometry(terms: int) -> tuple[int, int]:
    """(BS, W) of x3d2_tpu's kernel terms (2: the default mode, 3: HIGHEST)."""
    if terms not in GEOMETRY:
        raise ValueError(f"kernel terms {terms}: one of {sorted(GEOMETRY)}")
    return GEOMETRY[terms]


def _check_prec_instance(axis, accumulate, upd, nolds, base_sep, xdiv,
                         olds_bf16, acc_bf16):
    """Raise ValueError for a reduced-precision variant the kernel is not
    built with. Built: those of the fused AB chains (x3d2_tpu
    make_fused_transeq_ab_v3, pallas_kernels.py:862-941): the partial
    sweeps with bfloat16 partials (z without accumulate, x and y with), and
    the AB update (history, the sweep's own base) of the y sweep or of the
    xdiv sweep with a bfloat16 history, partials or both; at both bands
    (W=16, and W=32 in the HIGHEST mode)."""
    if not (olds_bf16 or acc_bf16):
        return
    if upd:
        ok = nolds > 0 and not base_sep and (axis == 1 or xdiv)
    else:
        ok = not olds_bf16 and accumulate == (axis != 2)
    if not ok:
        raise ValueError(
            f"no reduced-precision sweep on axis {axis} with accumulate="
            f"{accumulate}, update={upd}, history={nolds}, separate base="
            f"{base_sep}, xdiv={xdiv}, bfloat16 history={olds_bf16}, "
            f"bfloat16 partials={acc_bf16}: the kernel is built with the "
            "fused AB chains' variants")


def _check_rk_instance(axis, nolds, base_sep):
    """Raise ValueError for an RK update (no history, or a separate base)
    the kernel is not built with."""
    if axis != 1 or (nolds, base_sep) not in RK_INSTANCES:
        raise ValueError(f"the RK update is built on the y sweep for "
                         f"(nolds, base_sep) in {sorted(RK_INSTANCES)}, not "
                         f"({nolds}, {base_sep}) on axis {axis}")


def launch_counts() -> dict[str, int]:
    return dict(_LAUNCHES)


def tc_launch_counts() -> dict[str, int]:
    """The launches of launch_counts() that ran the tensor-core body."""
    return dict(_TC_LAUNCHES)


def reset_launch_counts() -> None:
    _LAUNCHES.clear()
    _TC_LAUNCHES.clear()


@dataclass
class SweepBlocks:
    """Banded operator blocks of one axis: sa = [D1; D2] and st = [D1s; D2s]
    as (nb, 2BS, WIN), da = D1s and dt = D1 as (nb, BS, WIN) at the block
    geometry (bs, w); float64 numpy masters plus device copies per
    dtype. tc: the blocks packed for the tensor-core body (SweepTC), or
    None where the packer refuses them (tc_refusal says why: another
    geometry, or operators that are not circulant); decided once, here,
    and the route of every launch (tc_route)."""

    axis: int
    m64: dict
    device: torch.device
    bs: int = BS
    w: int = W
    _dev: dict = field(default_factory=dict)
    tc: SweepTC | None = field(init=False, default=None)
    tc_refusal: str | None = field(init=False, default=None)

    def __post_init__(self):
        try:
            self.tc = _tc_pack(self)
        except ValueError as e:
            self.tc_refusal = str(e)

    @property
    def nb(self) -> int:
        return self.m64["sa"].shape[0]

    def require_equal_blocks(self):
        """Raise ValueError unless every block has the operators of block
        0, as on a uniform periodic axis (to float64 rounding): the xdiv
        kernel stages block 0 for all of them."""
        if "equal" not in self._dev:
            self._dev["equal"] = all(
                np.abs(M - M[:1]).max() <= _EQUAL_BLOCKS_TOL * np.abs(M).max()
                for M in self.m64.values())
        if not self._dev["equal"]:
            raise ValueError("the xdiv sweep needs equal operator blocks "
                             "(a uniform periodic x axis)")

    def mats(self, dtype):
        """(sa, st, da, dt) on the device at `dtype` (cached)."""
        if dtype not in self._dev:
            self._dev[dtype] = tuple(
                torch.as_tensor(self.m64[k], dtype=dtype, device=self.device)
                for k in ("sa", "st", "da", "dt"))
        return self._dev[dtype]


def build_sweep_blocks(ops_axis, axis, device=None, terms=2) -> SweepBlocks:
    """Banded blocks of one axis' transport operators at the geometry of
    `terms` (the pairings of x3d2_tpu make_transeq_dir_v3,
    pallas_kernels.py:508-513), checked at x3d2_tpu's truncation tolerance
    (raises ValueError beyond it)."""
    bs, w = geometry(terms)

    def bb(op):
        return banded_blocks(op, w, bs, tol=_BAND_TOL)

    d1, d1s = ops_axis.der1st, ops_axis.der1st_sym
    d2, d2s = ops_axis.der2nd, ops_axis.der2nd_sym
    m64 = {"sa": np.concatenate([bb(d1), bb(d2)], axis=1),
           "st": np.concatenate([bb(d1s), bb(d2s)], axis=1),
           "da": bb(d1s), "dt": bb(d1)}
    return SweepBlocks(axis=axis, m64=m64, device=resolve_device(device),
                       bs=bs, w=w)


# ---------------------------------------------------------------------------
# the tensor-core body's operators (transeq_sweep_tc_kernel)
# ---------------------------------------------------------------------------

# the tensor-core body's geometry (transeq_sweep_tc_geometry, checked when
# the library loads): output rows a block, band, rows a slice, window
# columns a chunk, threads, floats of an image, images a pairing (a
# slice's chunks), bytes of a window stage (three windows of 96 x 64
# floats), window stages, the launch's dynamic shared memory
TC_BS, TC_W, TC_SL, TC_KC, TC_NTHR = 64, 16, 16, 16, 256
TC_IMG = 2 * 2 * TC_SL * TC_KC + 2 * TC_SL * TC_KC
TC_SLICE_CHUNKS = 3               # a slice's band: chunks s .. s + 2
TC_STAGE_BYTES = 3 * (TC_BS + 2 * TC_W) * TL * 4
TC_STAGES = 2
TC_SMEM = 1024 + 8 * TC_IMG * TC_SLICE_CHUNKS + TC_STAGES * TC_STAGE_BYTES
TC_NSL = TC_BS // TC_SL           # slices a block
TC_NCH = (TC_BS + 2 * TC_W) // TC_KC   # chunks a window
# the pairings' stacks: (S, D) of the aligned and the transverse component
_PAIRINGS = (("sa", "da"), ("st", "dt"))


@dataclass
class SweepTC:
    """An axis' operator blocks packed for the tensor-core body. Slice s of
    an output block (its 16 rows) takes window chunks s .. s + 2 (16
    columns each); image j of a pairing holds the slices' rows over their
    chunk j, the same for every slice and output block of a uniform
    periodic axis (tc_pack checks it): the rows of [S1; S2] (32 x 16) and
    of D (16 x 16) split to TF32 hi and lo (split_tf32), each laid out as
    wgmma reads it (block_index). images (2, 3, TC_IMG) float32 (pairing 0
    the aligned component's sa / da, 1 the transverse ones' st / dt);
    dropped: the largest entry the slices leave out, relative to its
    operator's largest. Device copies per device (``on``)."""

    images: np.ndarray
    dropped: float
    _dev: dict = field(default_factory=dict)

    def on(self, device):
        """The images on `device` (cached)."""
        key = str(device)
        if key not in self._dev:
            self._dev[key] = torch.as_tensor(self.images,
                                             device=device).contiguous()
        return self._dev[key]

    def parts(self, pairing, img):
        """(S hi, S lo, D hi, D lo) of an image, unpacked: (32, 16) and
        (16, 16) float32."""
        x = self.images[pairing, img]
        return tuple(x[cut][idx] for cut, idx in _image_layout())


def _image_layout():
    """Where an image's four parts lie: (slice of the image, block_index
    of the part's rows) for S hi, S lo, D hi, D lo."""
    from .x_apply_manual import block_index

    n2, n1 = 2 * TC_SL * TC_KC, TC_SL * TC_KC
    i2, i1 = block_index(2 * TC_SL), block_index(TC_SL)
    return ((slice(0, n2), i2), (slice(n2, 2 * n2), i2),
            (slice(2 * n2, 2 * n2 + n1), i1), (slice(2 * n2 + n1, None), i1))


def _operator_rows(m64):
    """Each operator's rows in the stacks: (stack key, row offset); the
    [S1; S2] stacks hold two operators."""
    bs = m64["da"].shape[1]
    return [("sa", 0), ("sa", bs), ("st", 0), ("st", bs), ("da", 0),
            ("dt", 0)]


def _image(m, pairing, j):
    """Image j of a pairing from the float64 stacks (block 0's slice 0 over
    window chunk j): float32 (TC_IMG,)."""
    from .x_apply_manual import split_tf32

    bs = m["da"].shape[1]
    S, D = (m[k][0] for k in _PAIRINGS[pairing])
    rows, cols = slice(0, TC_SL), slice(TC_KC * j, TC_KC * (j + 1))
    parts = split_tf32(np.concatenate([S[rows, cols], S[bs:][rows, cols]])) \
        + split_tf32(D[rows, cols])
    out = np.empty(TC_IMG, np.float32)
    for (cut, idx), part in zip(_image_layout(), parts):
        out[cut][idx] = part
    return out


def tc_pack(blocks: SweepBlocks) -> SweepTC:
    """The operator blocks packed for the tensor-core body (SweepTC,
    packed when the blocks were built). Raises ValueError off the default
    mode's geometry; where a slice's rows hold an entry above the band
    tolerance (x3d2_tpu's 1e-6 of its operator's largest) outside the
    slice's three chunks (closure rows reaching past the band); and where
    the slices' or the blocks' rows over their chunks differ by more than
    float64 rounding (1e-12 of the largest entry: an operator that is not
    circulant, as a non-periodic axis' closure rows make it). The launches
    of such blocks take the SIMT body (tc_route)."""
    if blocks.tc is None:
        raise ValueError(blocks.tc_refusal)
    return blocks.tc


def _tc_pack(blocks):
    if (blocks.bs, blocks.w) != (TC_BS, TC_W):
        raise ValueError(f"the tensor-core sweep is built at BS={TC_BS}, "
                         f"W={TC_W}, not ({blocks.bs}, {blocks.w})")
    m = blocks.m64
    nb = blocks.nb
    band = np.zeros((TC_NSL, TC_NCH), bool)
    for s in range(TC_NSL):
        band[s, s:s + TC_SLICE_CHUNKS] = True
    dropped = 0.0
    for key, r0 in _operator_rows(m):
        P = np.abs(m[key][:, r0:r0 + blocks.bs]).reshape(
            nb, TC_NSL, TC_SL, TC_NCH, TC_KC)
        out = np.where(band[None, :, None, :, None], 0.0, P).max() / P.max()
        if out > _BAND_TOL:
            raise ValueError(
                f"an entry of {out:.1e} of its operator's largest lies "
                f"outside its slice's band of {TC_SLICE_CHUNKS} chunks: the "
                f"tensor-core sweep does not take this operator")
        dropped = max(dropped, out)
    # every slice of every block against slice 0 of block 0, chunk by chunk
    for key in ("sa", "st", "da", "dt"):
        M = m[key]
        scale = np.abs(M).max()
        for part in range(M.shape[1] // blocks.bs):
            R = M[:, part * blocks.bs:(part + 1) * blocks.bs]
            ref = R[0, :TC_SL, :TC_SLICE_CHUNKS * TC_KC]
            for s in range(TC_NSL):
                cut = R[:, TC_SL * s:TC_SL * (s + 1),
                        TC_KC * s:TC_KC * (s + TC_SLICE_CHUNKS)]
                if np.abs(cut - ref).max() > _EQUAL_BLOCKS_TOL * scale:
                    raise ValueError(
                        "the slices' operator rows differ (the operator is "
                        "not circulant): the tensor-core sweep does not "
                        "take it")
    images = np.stack([[_image(m, p, j) for j in range(TC_SLICE_CHUNKS)]
                       for p in range(2)])
    return SweepTC(images=images, dropped=float(dropped))


def tc_model(u, v, w_, blocks: SweepBlocks, nu, acc=None, olds=None,
             dtc=None, base=None, acc_dtype=None):
    """The tensor-core body's arithmetic in float32 on the CPU, as
    transeq_sweep_plain's results: for every slice and chunk of its band
    the three products of the split operands (A the window of q, or of q
    conv, split as the kernel splits it: hi = RNA(x), lo = x - hi
    truncated to TF32; B the packed images) summed in float32 and added to
    the slice's sums (the tensor cores' own sums over the band round
    otherwise: a model of the kernel, not its bits); then the combine, the
    accumulate and the update at float32."""
    from .x_apply_manual import split_tf32

    pk = tc_pack(blocks)
    axis, bs, w = blocks.axis, blocks.bs, blocks.w
    comps = tuple(t.to(torch.float32) for t in (u, v, w_))

    def split_a(x):
        # the kernel's split of the field: hi = RNA(x), lo = x - hi, which
        # the tensor cores truncate to TF32
        hi = split_tf32(x)[0]
        lo = ((x - hi).view(np.uint32) & np.uint32(0xFFFFE000)).view(
            np.float32)
        return hi, lo

    shape = tuple(u.shape)
    nb = shape[axis] // bs
    win = [_windows(q, axis, nb, bs, w).numpy() for q in comps]
    cw = win[axis]
    conv = cw[:, w:w + bs]
    parts = [[pk.parts(p, j) for j in range(TC_SLICE_CHUNKS)]
             for p in range(2)]
    outs = []
    for c in range(3):
        p = 0 if c == axis else 1
        qh, ql = split_a(win[c])
        ph, pl = split_a(win[c] * cw)
        sd = np.zeros((nb, 2 * bs, cw.shape[2]), np.float32)
        dd = np.zeros((nb, bs, cw.shape[2]), np.float32)
        for s in range(TC_NSL):
            rows = slice(TC_SL * s, TC_SL * (s + 1))
            for j in range(TC_SLICE_CHUNKS):
                shi, slo, dhi, dlo = parts[p][j]
                ks = slice(TC_KC * (s + j), TC_KC * (s + j + 1))
                a_h, a_l = qh[:, ks], ql[:, ks]
                ps = shi @ a_l + slo @ a_h + shi @ a_h
                a_h, a_l = ph[:, ks], pl[:, ks]
                pd = dhi @ a_l + dlo @ a_h + dhi @ a_h
                sd[:, rows] += ps[:, :TC_SL]
                sd[:, bs:][:, rows] += ps[:, TC_SL:]
                dd[:, rows] += pd
        r = (np.float32(-0.5) * (conv * sd[:, :bs] + dd)
             + np.float32(nu) * sd[:, bs:])
        outs.append(_field(torch.from_numpy(r), shape, axis))
    return _finish(comps, outs, acc, olds, dtc, base, acc_dtype)


@dataclass
class XdivMats:
    """The xdiv variant's transforms: the parity splits [Me; Mo] (n, n/2)
    of the transform-folded Sx (for u) and Ix (for v, w) as float64 numpy
    masters, with device copies per dtype. For the kernel they are cut per
    x block and transposed, (nb, BS, n) float32: row k of block b holds
    column (b mod nb/2) * BS + k of [Me; Mo], the Mo part negated for the
    blocks of the second half of x (the sign of u'1 - u'2)."""

    m64: dict
    device: torch.device
    bs: int = BS
    _dev: dict = field(default_factory=dict)

    def mats(self, dtype):
        """(sx, ix) stacked parity splits on the device at `dtype`."""
        if dtype not in self._dev:
            self._dev[dtype] = tuple(
                torch.as_tensor(self.m64[k], dtype=dtype, device=self.device)
                for k in ("sx", "ix"))
        return self._dev[dtype]

    def kernel_mats(self):
        """(sx, ix) in the kernel's per-block layout, float32."""
        if "kernel" not in self._dev:
            out = []
            for k in ("sx", "ix"):
                M = self.m64[k]
                n, h = M.shape
                bs = self.bs
                nbh = h // bs
                sign = np.where(np.arange(n) < h, 1.0, -1.0)[:, None]
                blocks = [(M[:, (b % nbh) * bs:(b % nbh + 1) * bs]
                           * (1.0 if b < nbh else sign)).T
                          for b in range(2 * nbh)]
                out.append(torch.as_tensor(
                    np.stack(blocks), dtype=torch.float32,
                    device=self.device).contiguous())
            self._dev["kernel"] = tuple(out)
        return self._dev["kernel"]


def build_xdiv_mats(sx64, ix64, n, device=None, bs=BS) -> XdivMats:
    """The xdiv transforms from the transform-folded x-stage divergence
    matrices, cut for x blocks of `bs` points. Raises ValueError where
    x3d2_tpu does (pallas_kernels.py:520-536): an odd count of its 64-point
    blocks (its block in both modes), transforms that are not (n, n), no
    parity symmetry; and beyond the size the kernel is built for."""
    if n % (2 * BS) or n % (2 * bs):
        raise ValueError("xdiv fusion needs an even block count")
    if n > XDIV_MAX_N:
        raise ValueError(f"the xdiv sweep serves n <= {XDIV_MAX_N} along "
                         f"x, got {n}")
    m64 = {}
    for key, M64 in (("sx", sx64), ("ix", ix64)):
        M64 = np.asarray(M64, np.float64)
        if M64.shape != (n, n):
            raise ValueError("xdiv transforms must be (n, n)")
        m64[key] = np.concatenate(parity_split_folded(M64, 0))
    return XdivMats(m64=m64, device=resolve_device(device), bs=bs)


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

def _windows(q, axis, nb, bs, w):
    """(nb, bs+2w, lines) windows of `q` along `axis`, periodic wrap."""
    n = q.shape[axis]
    k = torch.arange(bs + 2 * w, device=q.device)
    b = torch.arange(nb, device=q.device)
    idx = (b[:, None] * bs - w + k[None, :]) % n
    return q.movedim(axis, 0).reshape(n, -1)[idx]


def _ext_windows(ext, axis, nb, bs, w):
    """(nb, bs+2w, lines) windows of a halo-extended operand along `axis`
    (the window of block b starts at b*bs; no wrap)."""
    k = torch.arange(bs + 2 * w, device=ext.device)
    b = torch.arange(nb, device=ext.device)
    idx = b[:, None] * bs + k[None, :]
    return ext.movedim(axis, 0).reshape(ext.shape[axis], -1)[idx]


def window_source(blocks, shape, exts=None, off=0):
    """(windows of field i, the selection of operator blocks, nb) for the
    plain sweeps: win(q, i) gives the periodic windows of q, and all blocks
    are taken; with `exts` (the halo form) the windows of the extended
    operand exts[i], and the nb blocks from `off`."""
    axis, bs, w = blocks.axis, blocks.bs, blocks.w
    nb = shape[axis] // bs
    if exts is None:
        return (lambda q, i: _windows(q, axis, nb, bs, w)), slice(None), nb
    return (lambda q, i: _ext_windows(exts[i], axis, nb, bs, w)), \
        slice(off, off + nb), nb


def _field(y, shape, axis):
    """Inverse of the windows' layout: (nb, bs, lines) -> field."""
    moved = (shape[axis],) + tuple(s for a, s in enumerate(shape)
                                   if a != axis)
    return y.reshape(moved).movedim(0, axis)


def transeq_sweep_plain(u, v, w_, blocks: SweepBlocks, nu, acc=None,
                        olds=None, dtc=None, xdiv: XdivMats | None = None,
                        base=None, acc_dtype=None, exts=None, off=0):
    """The sweep's function in plain PyTorch, at the inputs' dtype: gather
    the windows with periodic indices, then batched products with the
    blocks. Returns (r_u, r_v, r_w), or ((u', v', w'), (rhs_u, rhs_v,
    rhs_w)) when `dtc` is given (olds: per-field history tuples; base: the
    update's base fields, default u, v, w), and with `xdiv` also (du, dv,
    dw), the forward parity x applies of u', v', w'. A bfloat16 acc or
    history is widened to the inputs' dtype before any arithmetic; without
    the update r is stored at `acc_dtype` (default the inputs' dtype); with
    a bfloat16 history rhs is stored at bfloat16 and u' gains the error
    feedback dtc[4] * (r - bf16(r)). With `exts` (the halo form: the
    extended operands of u, v, w; `blocks` the global stack) the windows
    come from them and the blocks from `off`."""
    axis = blocks.axis
    dtype = u.dtype
    comps = (u, v, w_)
    shape = tuple(u.shape)
    win, sel, _ = window_source(blocks, shape, exts, off)
    sa, st, da, dt = (m[sel] for m in blocks.mats(dtype))
    bs, w = blocks.bs, blocks.w
    cw = win(comps[axis], axis)
    conv = cw[:, w:w + bs]
    outs = []
    for c in range(3):
        qw = cw if c == axis else win(comps[c], c)
        S, D = (sa, da) if c == axis else (st, dt)
        both = torch.bmm(S, qw)
        dqd = torch.bmm(D, qw * cw)
        r = -0.5 * (conv * both[:, :bs] + dqd) + nu * both[:, bs:]
        outs.append(_field(r, shape, axis))
    return _finish(comps, outs, acc, olds, dtc, base, acc_dtype,
                   xdiv=xdiv)


def _finish(comps, outs, acc, olds, dtc, base, acc_dtype, xdiv=None):
    """The sweep's results from its combines r (per component, before the
    accumulate): the accumulate, and with `dtc` the time update (as
    transeq_sweep_plain documents)."""
    dtype = comps[0].dtype
    if acc is not None:
        outs = [r + a.to(dtype) for r, a in zip(outs, acc)]
    if dtc is None:
        return tuple(r.to(acc_dtype or dtype) for r in outs)
    hist = olds if olds is not None else ((), (), ())
    reduced = bool(hist[0]) and hist[0][0].dtype != dtype
    stored = [r.to(hist[0][0].dtype) if reduced else r for r in outs]
    new = []
    for c in range(3):
        un = (comps if base is None else base)[c] + dtc[0] * outs[c]
        for j, o in enumerate(hist[c]):
            un = un + dtc[1 + j] * o.to(dtype)
        if reduced:
            un = un + dtc[4] * (outs[c] - stored[c].to(dtype))
        new.append(un)
    if xdiv is None:
        return tuple(new), tuple(stored)
    sx, ix = xdiv.mats(dtype)
    divs = (pfwd(sx, new[0], 0), pfwd(ix, new[1], 0), pfwd(ix, new[2], 0))
    return tuple(new), tuple(stored), divs


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------

_LIBS: dict = {}


def _lib(w=W):
    """The kernel library of band half-width w, built and typed at first
    use."""
    if w not in _LIBS:
        from .. import _build

        lib = _build.load(_LIB_NAME[w])
        i, p = ctypes.c_int, ctypes.c_void_p
        lib.transeq_sweep_launch.argtypes = [
            i, i, i, i, i, i, i, i, p, i, i, i, ctypes.c_float, p, i, p]
        lib.transeq_sweep_launch.restype = i
        lib.species_sweep_launch.argtypes = [i, i, i, i, p, i, i, i, p, i,
                                             p]
        lib.species_sweep_launch.restype = i
        lib.transeq_sweep_error_string.argtypes = [i]
        lib.transeq_sweep_error_string.restype = ctypes.c_char_p
        lib.transeq_sweep_geometry.argtypes = [ctypes.POINTER(i)] * 5
        lib.transeq_sweep_geometry.restype = i
        geo = [i() for _ in range(5)]
        lib.transeq_sweep_geometry(*geo)
        geo = tuple(g.value for g in geo)
        bs = next(b for b, ww in GEOMETRY.values() if ww == w)
        want = (bs, w, TL, XDIV_MAX_N // bs, MAX_SPECIES)
        if geo != want:
            raise RuntimeError(f"{_LIB_NAME[w]}.cu geometry {geo} differs "
                               f"from the wrapper's {want}")
        _LIBS[w] = lib
    return _LIBS[w]


def _tc_lib():
    """The tensor-core body's library (csrc/transeq_sweep_tc.cu), built
    and typed at first use."""
    if "tc" not in _LIBS:
        from .. import _build

        lib = _build.load("transeq_sweep_tc")
        i, p = ctypes.c_int, ctypes.c_void_p
        lib.transeq_sweep_tc_launch.argtypes = [
            i, i, i, i, i, i, p, i, i, i, ctypes.c_float, p, i, p]
        lib.transeq_sweep_tc_launch.restype = i
        lib.transeq_sweep_error_string.argtypes = [i]
        lib.transeq_sweep_error_string.restype = ctypes.c_char_p
        lib.transeq_sweep_tc_geometry.argtypes = [ctypes.POINTER(i)]
        lib.transeq_sweep_tc_geometry.restype = i
        g = (i * 10)()
        lib.transeq_sweep_tc_geometry(g)
        want = (TC_BS, TC_W, TC_SL, TC_KC, TC_NTHR, TC_IMG, TC_SLICE_CHUNKS,
                TC_STAGE_BYTES, TC_STAGES, TC_SMEM)
        if tuple(g) != want:
            raise RuntimeError(f"transeq_sweep_tc.cu geometry {tuple(g)} "
                               f"differs from the wrapper's {want}")
        _LIBS["tc"] = lib
    return _LIBS["tc"]


def sweep_shape_ok(shape, axis, bs=BS, w=W, halo=False) -> bool:
    """The kernel's tiling rules for one sweep axis at the geometry (bs,
    w); with `halo` for a shard of the halo form (a block at least, and the
    W planes a neighbour takes)."""
    n0, n1, n2 = shape
    n = shape[axis]
    return (n % bs == 0 and n >= (max(bs, w) if halo else bs + 2 * w)
            and n2 % TL == 0 and (n0 * n1) % TL == 0)


def check_exts(exts, shape, axis, w, nb_loc, nb_glob, off):
    """Raise ValueError unless `exts` are halo-extended operands of `shape`
    (n + 2w along `axis`) and the shard's blocks [off, off + nb_loc) are
    blocks of the global stack of nb_glob at a shard boundary."""
    want = list(shape)
    want[axis] += 2 * w
    for e in exts:
        if tuple(e.shape) != tuple(want):
            raise ValueError(f"a halo-extended operand is {tuple(want)}, got "
                             f"{tuple(e.shape)}")
    if not 0 <= off <= nb_glob - nb_loc or off % nb_loc:
        raise ValueError(f"block offset {off} of {nb_loc} blocks outside the "
                         f"global stack of {nb_glob}")


def launch_error(err, w=W) -> str:
    """The CUDA error string of a launch's return code."""
    return _lib(w).transeq_sweep_error_string(err).decode()


def _check(t, shape, name, dtype=torch.float32):
    if not t.is_cuda or t.dtype != dtype:
        raise ValueError(f"{name}: the kernel takes {dtype} CUDA tensors "
                         f"here, got {t.dtype} on {t.device}")
    if tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous tensor of shape {shape},"
                         f" got {tuple(t.shape)}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data must be 16-byte aligned")


def _reduced(dtype, what):
    """Whether a stream's dtype is the reduced one (bfloat16)."""
    if dtype in (None, torch.float32):
        return False
    if dtype != torch.bfloat16:
        raise ValueError(f"the sweep kernel stores {what} as float32 or "
                         f"bfloat16, not {dtype}")
    return True


def tc_route(blocks, xdiv=None, halo=False) -> bool:
    """Whether a sweep launches the tensor-core body: blocks it packs (the
    default mode's geometry, circulant operators: SweepBlocks.tc), neither
    the halo form nor the xdiv variant. The rest launch the SIMT body: the
    HIGHEST mode's W = 32, the halo form, the xdiv variant and the axes
    whose operators are not circulant (a non-periodic one)."""
    return blocks.tc is not None and xdiv is None and not halo


def grid_of(shape, axis, sms, bs=BS, xdiv=False) -> int:
    """Blocks per output block (the xdiv kernel: blocks in all), one block
    an SM."""
    lines = shape[0] * shape[1] * shape[2] // shape[axis]
    nb = shape[axis] // bs
    return max(1, min(lines // TL, sms if xdiv else sms // nb))


def tc_writes(shape, axis, sms):
    """The flat output index each (block, tile, component's slice, thread,
    element) of a tensor-core launch writes, as the kernel walks them:
    grid (grid_of, nb); block (x, b) takes tiles x, x + grid_x, ...;
    warpgroup g slices 2 g, 2 g + 1; thread element e = 4 j + 2 ci + q at
    (line 16 w + gid + 8 ci, block row 16 s + 8 j + 2 tig + q). A 1-D int64
    array (one component's writes; the three are alike)."""
    n0, n1, n2 = shape
    n = shape[axis]
    nb = n // TC_BS
    grid_x = grid_of(shape, axis, sms)
    ntiles = shape[0] * shape[1] * shape[2] // n // TL
    out = []
    t_ = np.arange(TC_NTHR)
    wg, w = t_ >> 7, (t_ >> 5) & 3
    gid, tig = (t_ & 31) >> 2, t_ & 3
    e = np.arange(8)
    ci, q, j = (e >> 1) & 1, e & 1, e >> 2
    line = (16 * w + gid)[:, None] + 8 * ci[None, :]
    for x in range(grid_x):
        for t in range(x, ntiles, grid_x):
            if axis == 0:
                base, ls, ss = t * TL, 1, n1 * n2
            elif axis == 1:
                per = n2 // TL
                base, ls, ss = (t // per) * n1 * n2 + (t % per) * TL, 1, n2
            else:
                base, ls, ss = t * TL * n2, n2, 1
            for b in range(nb):
                for h in range(2):
                    s = 2 * wg + h
                    row = b * TC_BS + (16 * s + 2 * tig)[:, None] \
                        + 8 * j[None, :] + q[None, :]
                    out.append((base + line * ls + row * ss).ravel())
    return np.concatenate(out)


def _launch(u, v, w_, blocks, nu, acc, olds, dtc, out, xdiv=None,
            base=None, acc_dtype=None, exts=None, off=0):
    axis = blocks.axis
    bs, w = blocks.bs, blocks.w
    shape = tuple(u.shape)
    halo = exts is not None
    if len(shape) != 3 or not sweep_shape_ok(shape, axis, bs, w, halo):
        raise ValueError(f"shape {shape} is not tileable by the sweep "
                         f"kernel along axis {axis}")
    upd = dtc is not None
    if halo and (upd or xdiv is not None or acc_dtype is not None
                 or axis == 0):
        raise ValueError("the halo form is a float32 partial sweep of a "
                         "sharded axis (y or z), without an update")
    olds = olds if upd and olds is not None else ((), (), ())
    nolds = len(olds[0])
    if upd and acc is None:
        raise ValueError("the fused-update sweep accumulates: pass acc")
    if base is not None and not upd:
        raise ValueError("a separate base needs the update (dtc)")
    if nolds > 3:
        raise ValueError("the kernel takes at most 3 history fields")
    if upd and (base is not None or not nolds):
        _check_rk_instance(axis, nolds, base is not None)
    if xdiv is not None and (axis != 0 or not nolds or base is not None):
        raise ValueError("the xdiv variant is the x sweep with the AB "
                         "update and at least one history field")
    pdt = acc_dtype or torch.float32      # the partials' dtype
    hdt = olds[0][0].dtype if nolds else torch.float32
    olds_bf16, acc_bf16 = _reduced(hdt, "the history"), \
        _reduced(pdt, "the partials")
    _check_prec_instance(axis, acc is not None, upd, nolds, base is not None,
                         xdiv is not None, olds_bf16, acc_bf16)
    for i, t in enumerate([u, v, w_] + list(base or ())):
        _check(t, shape, f"input {i}")
    for t in acc or ():
        _check(t, shape, "acc", pdt)
    for t in (o for c in range(3) for o in olds[c]):
        _check(t, shape, "history", hdt)
    mats = blocks.mats(torch.float32)
    if mats[0].device != u.device:
        raise ValueError("operator blocks and fields are on different devices")
    nb = shape[axis] // bs
    if halo:
        check_exts(exts, shape, axis, w, nb, blocks.nb, off)
        for t in exts:
            _check(t, tuple(t.shape), "halo-extended operand")
        mats = tuple(m[off:off + nb] for m in mats)
    elif blocks.nb != nb:
        raise ValueError(f"{blocks.nb} operator blocks for {nb} of the field")
    # outputs: u' (float32) and rhs (at the history's dtype) with the
    # update, else r at the partials' dtype
    odts = [torch.float32] * 3 + [hdt] * 3 if upd else [pdt] * 3
    if out is None:
        outs = [torch.empty_like(u, dtype=d) for d in odts]
    else:
        outs = list(out[0]) + list(out[1]) if upd else list(out)
        if len(outs) != len(odts):
            raise ValueError(f"out must hold {len(odts)} tensors")
        fields = {t.data_ptr() for t in (u, v, w_)}
        bases = {t.data_ptr() for t in base} if base is not None else set()
        for t, d in zip(outs, odts):
            _check(t, shape, "out", d)
            if t.data_ptr() in fields:
                raise ValueError("out may not alias u, v or w: the kernel "
                                 "reads their windows around every point")
            if t.data_ptr() in bases:
                raise ValueError("out may not alias the base: the RK "
                                 "substages after this one read it")
    if olds_bf16 and len(list(dtc)) != 5:
        raise ValueError("a bfloat16 history needs the 5-entry row (the 5th: "
                         "the error feedback, TimeIntegrator.ab_row(..., "
                         "feedback=True))")
    name = variant_name(axis, acc is not None, nolds, xdiv is not None, upd,
                        base is not None, olds_bf16, acc_bf16, w, halo)
    # the streams' pointers: acc, old[j][c] (j-major), out, rhs; the base
    null = None
    streams = [t.data_ptr() for t in acc] if acc is not None else [null] * 3
    old_ptrs = [null] * 9
    for c in range(3):
        for j, o in enumerate(olds[c]):
            old_ptrs[3 * j + c] = o.data_ptr()
    streams += old_ptrs + [t.data_ptr() for t in outs[:3]]
    streams += [t.data_ptr() for t in outs[3:]] if upd else [null] * 3
    base_ptrs = [t.data_ptr() for t in base] if base is not None \
        else [null] * 3
    co = list(dtc) if upd else []
    carr = (ctypes.c_float * 5)(*(co + [0.0] * (5 - len(co))))
    sms = torch.cuda.get_device_properties(u.device).multi_processor_count
    stream = torch.cuda.current_stream(u.device).cuda_stream
    prec = (1 if olds_bf16 else 0) | (2 if acc_bf16 else 0)
    flags = (axis, int(acc is not None), nolds, int(upd), int(base is not None))
    if tc_route(blocks, xdiv, halo):
        img = blocks.tc.on(u.device)
        ptrs = [t.data_ptr() for t in (u, v, w_, img)] + streams + base_ptrs
        lib = _tc_lib()
        with torch.cuda.device(u.device):
            err = lib.transeq_sweep_tc_launch(
                *flags, prec, (ctypes.c_void_p * len(ptrs))(*ptrs), *shape,
                float(nu), carr, grid_of(shape, axis, sms), stream)
        if err != 0:
            raise RuntimeError(
                f"transeq_sweep (tensor cores) launch failed: "
                f"{lib.transeq_sweep_error_string(err).decode()} ({err})")
        _LAUNCHES[name] = _LAUNCHES.get(name, 0) + 1
        _TC_LAUNCHES[name] = _TC_LAUNCHES.get(name, 0) + 1
        return (tuple(outs[:3]), tuple(outs[3:])) if upd else tuple(outs)
    ptrs = [t.data_ptr() for t in (exts if halo else (u, v, w_))]
    ptrs += [m.data_ptr() for m in mats] + streams
    divs = None
    if xdiv is not None:
        blocks.require_equal_blocks()
        if xdiv.bs != bs:
            raise ValueError(f"xdiv transforms cut for {xdiv.bs}-point "
                             f"blocks, the sweep's are {bs}")
        xm = xdiv.kernel_mats()
        for M in xm:
            _check(M, (nb, bs, shape[0]), "xdiv transform")
        divs = [torch.empty_like(u) for _ in range(3)]
        ptrs += [M.data_ptr() for M in xm] + [t.data_ptr() for t in divs]
    else:
        ptrs += [null] * 5
    ptrs += base_ptrs
    parr = (ctypes.c_void_p * len(ptrs))(*ptrs)
    # blocks per x block; the xdiv kernel's blocks own all of x
    grid_x = grid_of(shape, axis, sms, bs, xdiv is not None)
    with torch.cuda.device(u.device):
        err = _lib(w).transeq_sweep_launch(
            *flags, int(xdiv is not None), prec, int(halo), parr, *shape,
            float(nu), carr, grid_x, stream)
    if err != 0:
        raise RuntimeError(f"transeq_sweep launch failed: "
                           f"{launch_error(err, w)} ({err})")
    _LAUNCHES[name] = _LAUNCHES.get(name, 0) + 1
    if xdiv is not None:
        return tuple(outs[:3]), tuple(outs[3:]), tuple(divs)
    if upd:
        return tuple(outs[:3]), tuple(outs[3:])
    return tuple(outs)


def transeq_sweep(u, v, w_, blocks: SweepBlocks, nu, acc=None, olds=None,
                  dtc=None, out=None, xdiv: XdivMats | None = None,
                  base=None, acc_dtype=None, exts=None, off=0):
    """One direction sweep: -> (r_u, r_v, r_w), or with `dtc` (the
    dt-scaled update row, host floats; 5 entries with a bfloat16 history,
    the 5th the error feedback) -> ((u', v', w'), (rhs_u, rhs_v, rhs_w)),
    and with `xdiv` -> (..., ..., (du, dv, dw)). `base`: the update's base
    fields where they are not u, v, w (the RK step-initial fields).
    `acc_dtype`: the partials' dtype (float32 or bfloat16), of `acc` and,
    without the update, of r; the history's dtype is that of `olds`, and
    rhs is stored at it. `out` names the tensors to write (in place): 3
    tensors, or ((u'x3), (rhs x3)) with `dtc` (du, dv, dw are always new
    tensors). An output may alias `acc` or the history at its dtype (each
    point reads them before it writes), never u, v, w or the base. `exts`,
    `off`: the halo form (the extended operands of u, v, w; `blocks` the
    global stack, from block `off`).

    CUDA tensors launch the kernel (or raise); CPU tensors run the plain
    version."""
    if u.is_cuda:
        return _launch(u, v, w_, blocks, nu, acc, olds, dtc, out, xdiv, base,
                       acc_dtype, exts, off)
    if u.device.type != "cpu":
        raise ValueError(f"no transeq sweep for device {u.device}")
    if exts is not None:
        check_exts(exts, tuple(u.shape), blocks.axis, blocks.w,
                   u.shape[blocks.axis] // blocks.bs, blocks.nb, off)
    res = transeq_sweep_plain(u, v, w_, blocks, nu, acc=acc, olds=olds,
                              dtc=dtc, xdiv=xdiv, base=base,
                              acc_dtype=acc_dtype, exts=exts, off=off)
    if out is None:
        return res
    flat_res = list(res[0]) + list(res[1]) if dtc is not None else list(res)
    flat_out = list(out[0]) + list(out[1]) if dtc is not None else list(out)
    for o, r in zip(flat_out, flat_res):
        if o.dtype != r.dtype:
            raise ValueError(f"out: {o.dtype} where the sweep writes "
                             f"{r.dtype}")
        o.copy_(r)
    if xdiv is not None:
        return tuple(flat_out[:3]), tuple(flat_out[3:]), res[2]
    return (tuple(flat_out[:3]), tuple(flat_out[3:])) if dtc is not None \
        else tuple(flat_out)


def make_transeq_sweep(ops_axis, nu, axis, shape, accumulate=False, nolds=0,
                       device=None, xdiv_mats=None, upd=None, base_sep=False,
                       olds_dtype=None, acc_dtype=None, terms=2,
                       n_shards=1):
    """One direction sweep as a function, the counterpart of
    make_transeq_dir_v3 / make_pencil_sweep:
    fn(u, v, w[, acc][, olds, dtc][, out][, base]) -> as transeq_sweep.
    upd (default: nolds > 0) fuses the time update; base_sep takes its base
    from `base` (the RK substages after the first). With
    xdiv_mats=(sx64, ix64), the transform-folded x-stage divergence
    matrices, the sweep is the xdiv variant (raises ValueError as
    build_xdiv_mats does, off the AB-fused x sweep, and when the operator
    blocks along x differ). olds_dtype, acc_dtype: bfloat16 for the
    reduced history and partials (None: the state's dtype), where the
    kernel is built with them (_check_prec_instance). terms: x3d2_tpu's
    kernel mode, 2 (default) or 3 (HIGHEST: the W=32 band). n_shards > 1:
    the halo form over a shard (`shape` the shard's, the operators the
    global axis' of n_shards times its extent), x3d2_tpu's n_shards;
    fn(u, v, w[, acc], exts=, off=) with the extended operands and the
    shard's block offset (partial sweeps only, as in x3d2_tpu)."""
    if upd is None:
        upd = nolds > 0
    halo = n_shards > 1
    if halo and (upd or nolds or base_sep or xdiv_mats is not None
                 or acc_dtype is not None or olds_dtype is not None):
        raise ValueError("fused-update sweeps must be single-shard "
                         "(x3d2_tpu rule); the halo form is a float32 "
                         "partial sweep")
    if halo and ops_axis.der1st.n_in != shape[axis] * n_shards:
        raise ValueError("local extent * n_shards must match the global "
                         "operator size")
    if (upd or nolds) and not accumulate:
        raise ValueError("fused-update sweeps accumulate (x3d2_tpu rule)")
    if (nolds or base_sep) and not upd:
        raise ValueError("history and a separate base need the update")
    if upd and (base_sep or not nolds):
        _check_rk_instance(axis, nolds, base_sep)
    bs, w = geometry(terms)
    _check_prec_instance(axis, accumulate, upd, nolds, base_sep,
                         xdiv_mats is not None,
                         _reduced(olds_dtype, "the history"),
                         _reduced(acc_dtype, "the partials"))
    if not sweep_shape_ok(tuple(shape), axis, bs, w, halo):
        raise ValueError(f"shape {shape} not tileable along axis {axis}")
    xdiv = None
    if xdiv_mats is not None:
        if axis != 0 or not nolds:
            raise ValueError("xdiv fusion needs the AB-fused axis-0 sweep")
        xdiv = build_xdiv_mats(*xdiv_mats, shape[0], device=device, bs=bs)
    blocks = build_sweep_blocks(ops_axis, axis, device=device, terms=terms)
    if xdiv is not None:
        blocks.require_equal_blocks()

    def fn(u, v, w_, acc=None, olds=None, dtc=None, out=None, base=None,
           exts=None, off=None):
        if (accumulate != (acc is not None) or upd != (dtc is not None)
                or base_sep != (base is not None)
                or halo != (exts is not None) or halo != (off is not None)):
            raise ValueError("arguments do not match the sweep variant")
        if nolds and any(len(o) != nolds for o in olds):
            raise ValueError(f"need {nolds} history fields per component")
        if nolds and olds[0][0].dtype != (olds_dtype or u.dtype):
            raise ValueError(f"the history is {olds[0][0].dtype}, the sweep "
                             f"takes {olds_dtype or u.dtype}")
        return transeq_sweep(u, v, w_, blocks, nu, acc=acc, olds=olds,
                             dtc=dtc, out=out, xdiv=xdiv, base=base,
                             acc_dtype=acc_dtype, exts=exts,
                             off=int(off or 0))

    fn.blocks = blocks
    fn.xdiv = xdiv
    return fn


def make_fused_transeq(solver_ops, nu, shape, device=None, terms=2):
    """The full transport RHS in one chain of three sweeps (x3d2_tpu
    make_fused_transeq_v3, pallas_kernels.py:811-836): z sweep ->
    accumulating x sweep -> accumulating y sweep, at the geometry of
    `terms` (x3d2_tpu's kernel mode).

        fn(u, v, w) -> (r_u, r_v, r_w) summed over the directions

    The chain allocates only the z sweep's partials; the x and y sweeps add
    into them in place."""
    device = resolve_device(device)
    kw = dict(device=device, terms=terms)
    d2 = make_transeq_sweep(solver_ops[2], nu, 2, shape, **kw)
    d0 = make_transeq_sweep(solver_ops[0], nu, 0, shape, accumulate=True,
                            **kw)
    d1 = make_transeq_sweep(solver_ops[1], nu, 1, shape, accumulate=True,
                            **kw)

    def fn(u, v, w_):
        acc = d2(u, v, w_)
        acc = d0(u, v, w_, acc=acc, out=acc)
        return d1(u, v, w_, acc=acc, out=acc)

    fn.sweeps = (d2, d0, d1)
    return fn


def make_fused_transeq_rk(solver_ops, nu, shape, order, device=None,
                          terms=2):
    """Transport + Runge-Kutta substage update in one chain per substage
    (x3d2_tpu make_fused_transeq_rk, pallas_kernels.py:944-995): z sweep ->
    accumulating x sweep -> accumulating y sweep with the substage update
    in its epilogue, at the geometry of `terms`. Returns the per-substage
    functions

        stage_fns[i](u, v, w, f0, ks, dtc) -> ((u', v', w'), rhs)

    u, v, w: the substage's entry velocities; f0: the step-initial fields
    (the base of every substage after the first, whose base is u, v, w);
    ks: the stage derivatives so far (per substage a 3-tuple), of which the
    ones with a nonzero coefficient in this substage's tableau row
    (stage.prev_nz) are read; dtc: TimeIntegrator.rk_row, the dt-scaled row
    [fresh, those...] as host floats. rhs is this substage's derivative;
    it is written over the z sweep's partials, u' into new tensors (never
    over u, v, w or f0)."""
    device = resolve_device(device)
    ti = TimeIntegrator(f"RK{order}")
    kw = dict(device=device, terms=terms)
    d2 = make_transeq_sweep(solver_ops[2], nu, 2, shape, **kw)
    d0 = make_transeq_sweep(solver_ops[0], nu, 0, shape, accumulate=True,
                            **kw)
    stage_fns = []
    for istage in range(order):
        prev_nz = ti.rk_prev(istage)
        d1 = make_transeq_sweep(solver_ops[1], nu, 1, shape, accumulate=True,
                                nolds=len(prev_nz), upd=True,
                                base_sep=istage > 0, **kw)

        def stage(u, v, w_, f0, ks, dtc, d1=d1, prev_nz=prev_nz,
                  istage=istage):
            acc = d2(u, v, w_)
            acc = d0(u, v, w_, acc=acc, out=acc)
            olds = tuple(tuple(ks[j][c] for j in prev_nz) for c in range(3))
            new = tuple(torch.empty_like(u) for _ in range(3))
            return d1(u, v, w_, acc=acc, olds=olds, dtc=dtc, out=(new, acc),
                      base=None if istage == 0 else tuple(f0))

        stage.prev_nz = prev_nz
        stage.sweeps = (d2, d0, d1)
        stage_fns.append(stage)
    return stage_fns


def make_fused_transeq_ab(solver_ops, nu, shape, nolds, device=None,
                          xdiv=None, olds_dtype=None, acc_dtype=None, terms=2,
                          skip_d2=False):
    """Transport + Adams-Bashforth update in one chain of three sweeps
    (x3d2_tpu make_fused_transeq_ab_v3, pallas_kernels.py:862, chain at
    :936-939): z sweep -> accumulating x sweep -> accumulating y sweep with
    the AB update in its epilogue.

        fn(u, v, w, olds, dtc) -> ((u', v', w'), (rhs_u, rhs_v, rhs_w))

    With xdiv=(sx64, ix64), the projection's transform-folded x-stage
    divergence matrices, the chain reorders to z sweep -> accumulating y
    sweep -> accumulating x sweep with the AB update, which also emits the
    x-transformed divergence inputs (chain at pallas_kernels.py:901-919):

        fn(u, v, w, olds, dtc) -> ((u', v', w'), rhs, (du, dv, dw))

    and raises ValueError where the shapes or the parity symmetry do not
    allow it (make_transeq_sweep).

    `olds` holds per-field (nolds,) history tuples, newest first; `dtc` the
    dt-scaled coefficient row (host floats; with olds_dtype the 5-entry row
    with the error feedback). The rhs outputs, at the history's dtype, are
    the new history heads. olds_dtype, acc_dtype: bfloat16 for the reduced
    history (X3D2_BF16_OLDS) and partials (X3D2_BF16_ACC), None for the
    state's float32. Like x3d2_tpu's aliasing (pallas_kernels.py:567-594)
    the chain allocates only the z sweep's partials: the x sweep adds into
    them in place, and the final sweep writes its two outputs over the two
    buffers that are dead after it and have the outputs' dtypes: rhs over
    the partials and u' over the OLDEST history buffers, which the rotation
    drops (all float32); with a bfloat16 history alone rhs over the oldest
    history and u' over the partials; with bfloat16 partials alone u' over
    the oldest history and rhs into new tensors; with both rhs over the
    partials and u' into new tensors. The caller's olds tuples are
    therefore consumed. terms: x3d2_tpu's kernel mode (3: the W=32 band,
    with the reduced history and partials as at W=16).

    With skip_d2 (the d2-in-C carry, X3D2_D2C=1; x3d2_tpu's skip_d2,
    pallas_kernels.py:892-896, :929-934) the chain runs no z sweep: it
    takes the z partials the previous projection carried,

        fn(u, v, w, olds, dtc, acc0) -> ((u', v', w'), rhs)

    the x sweep adds into acc0 in place, and the final sweep's buffers are
    final_out's with acc0 in the z sweep's partials' place. skip_d2 raises
    ValueError with acc_dtype or xdiv, as x3d2_tpu does."""
    device = resolve_device(device)
    if skip_d2 and acc_dtype is not None:
        # the carry comes from the projection at the state's precision
        raise ValueError("skip_d2 and acc_dtype are exclusive")
    if skip_d2 and xdiv is not None:
        raise ValueError("skip_d2 and xdiv are exclusive chains")
    olds_red = _reduced(olds_dtype, "the history")
    acc_red = _reduced(acc_dtype, "the partials")
    kw = dict(device=device, acc_dtype=acc_dtype, terms=terms)
    d2 = (None if skip_d2
          else make_transeq_sweep(solver_ops[2], nu, 2, shape, **kw))

    def final_out(acc, olds, like):
        """(u' buffers, rhs buffers) of the final sweep."""
        oldest = tuple(o[-1] for o in olds)
        if not acc_red:
            return (acc, oldest) if olds_red else (oldest, acc)
        fresh = tuple(torch.empty_like(like) for _ in range(3))
        return (fresh, acc) if olds_red else (oldest, fresh)

    if xdiv is not None:
        d0x = make_transeq_sweep(solver_ops[0], nu, 0, shape,
                                 accumulate=True, nolds=nolds, xdiv_mats=xdiv,
                                 olds_dtype=olds_dtype, **kw)
        d1p = make_transeq_sweep(solver_ops[1], nu, 1, shape,
                                 accumulate=True, **kw)

        def fnx(u, v, w_, olds, dtc):
            acc = d2(u, v, w_)
            acc = d1p(u, v, w_, acc=acc, out=acc)
            return d0x(u, v, w_, acc=acc, olds=olds, dtc=dtc,
                       out=final_out(acc, olds, u))

        fnx.sweeps = (d2, d1p, d0x)
        return fnx
    d0 = make_transeq_sweep(solver_ops[0], nu, 0, shape, accumulate=True,
                            **kw)
    d1 = make_transeq_sweep(solver_ops[1], nu, 1, shape, accumulate=True,
                            nolds=nolds, olds_dtype=olds_dtype, **kw)

    if skip_d2:
        def fns(u, v, w_, olds, dtc, acc0):
            acc = d0(u, v, w_, acc=tuple(acc0), out=tuple(acc0))
            return d1(u, v, w_, acc=acc, olds=olds, dtc=dtc,
                      out=final_out(acc, olds, u))

        fns.sweeps = (d0, d1)
        return fns

    def fn(u, v, w_, olds, dtc):
        acc = d2(u, v, w_)
        acc = d0(u, v, w_, acc=acc, out=acc)
        return d1(u, v, w_, acc=acc, olds=olds, dtc=dtc,
                  out=final_out(acc, olds, u))

    fn.sweeps = (d2, d0, d1)
    return fn


# x3d2_tpu's v3 sweep geometry (pallas_kernels.py:137-143, :998-1022): the
# block and band half-width per axis (the z sweep runs on the TPU's lanes),
# the in-tile extents of the two other axes, the band truncation tolerance
V3_BLOCK = {0: (64, 16), 1: (64, 16), 2: (128, 64)}
V3_FREE = {0: (16, 128), 1: (16, 128), 2: (8, 128)}
V3_BAND_TOL = 1e-6


def transeq_sweep_supported(solver, shape) -> bool:
    """Counterpart of x3d2_tpu transeq_v3_supported (pallas_kernels.py:
    998-1022), with its conditions: a uniform mesh, square operators, per
    axis an extent that is a multiple of the block and at least a block
    and two bands long (the z rule: n >= 128 + 2 * 64 = 256), the other
    two extents multiples of the in-tile ones, and every operator within
    its band at the truncation tolerance. The port keeps x3d2_tpu's choice
    (its own kernel tiles more: 64-point blocks and W=16 on every axis,
    or 32-point blocks and W=32 in the HIGHEST mode, sweep_shape_ok, which
    these conditions imply). Like x3d2_tpu's gate it does not depend on the
    mode. The kernel is float32: the solver takes the sweeps for float32
    only."""
    shape = tuple(shape)
    for axis in range(3):
        o = solver.ops[axis]
        corr = o.der2nd.stretch_correct
        if corr is not None and np.any(corr):
            return False
        n = shape[axis]
        bs, w = V3_BLOCK[axis]
        if n % bs or n < bs + 2 * w:
            return False
        other = [a for a in range(3) if a != axis]
        t0, t1 = V3_FREE[axis]
        if shape[other[0]] % t0 or shape[other[1]] % t1:
            return False
        if o.der1st.n_out != n or o.der1st.n_in != n:
            return False
        try:
            for op in (o.der1st, o.der1st_sym, o.der2nd, o.der2nd_sym):
                banded_blocks(op, w, bs, tol=V3_BAND_TOL)
        except ValueError:
            return False
        if not sweep_shape_ok(shape, axis):
            return False
    return True
