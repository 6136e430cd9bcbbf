"""The one-field parity x applies (x_pfwd, x_pinv, x_pinv[sub]) on the
split-TF32 x-apply kernel (csrc/x_apply_manual.cu, its FWD and INV forms,
launched by ops/pressure_slab.py x_apply_parity), on the CPU: what the
kernel takes, and a model of its arithmetic against float64 and x3d2_tpu.

- (a) ProjectionMats.packed_x packs a periodic x's operators (sx, ix
  forward; gxs, gxi inverse) as parity stacks [Me; Mo] in their parity
  forms, at nx = 128 and at a tail x (nx = 320, halves of 160), and
  unpacked they are the split of pm.mats(float32); a dense x (X3D2_BFLY=0)
  keeps the dense form.
- (b) The kernel's FWD item reads f1 and f2 once and sums E = Me (f1 +
  f2) and O = Mo (f1 - f2) in two sets of sums. A float32 walk of the
  kernel's items and chunks over the packed operator (each chunk's three
  products of the split operands in float32, added to the item's sums in
  float32) is bit-equal to the walk of the two-item FWD it replaces (E
  and O in items of their own), so the arithmetic of every output, and
  tc_model, are unchanged. On the slab's operators at nx = 128 the walk
  and tc_model are within 4e-7 * scale of float64 (the kernel's limit on
  the card; scale = max |float64|) and within 3e-5 * scale of x3d2_tpu's
  make_x_apply(parity=..., interpret=True) (its bf16-split terms=2
  products reach about 1e-5 of float64) for fwd, inv and inv + sub.
- (c) geometry: the one-read FWD items (a column tile and a row tile,
  both halves), their 32 KB stage and the stage counts that fit (FWD 2 to
  7); a walk of the items writes every output element once for every even
  x the parity gate admits up to 4096 points; shared memory within
  SMEM_MAX at S = 2 to 6; ny * nz a multiple of 4 wherever make_x_apply's
  tiling admits (ny, nz).
- (d) CPU tensors take the plain version, and no launch is counted in
  either launch counter (x_apply_manual's, operator_apply's).
"""

import math

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax
import jax.numpy as jnp

from x3d2_tpu.ops.pallas_poisson import make_x_apply

from x3d2_tpu_torch.common import BC, env_set
from x3d2_tpu_torch.mesh import Mesh
from x3d2_tpu_torch.ops import operator_apply as oa
from x3d2_tpu_torch.ops import pressure_slab as sl
from x3d2_tpu_torch.ops import x_apply_manual as xm
from x3d2_tpu_torch.solver import NavierStokes

torch.set_num_threads(1)
threadpool_limits(1, user_api="blas")

PER = ((BC.PERIODIC, BC.PERIODIC),) * 3
CUT = (8, 128)          # y, z of the fields: x3d2_tpu's smallest x tile
JNAME = {"sx": "sx", "ix": "ix", "gxs": "gx_s", "gxi": "gx_i"}
TC_LIM = 4e-7           # the split-TF32 kernel's limit against float64


def _solver(nx, dense=False):
    """The solver of a periodic nx x 128 x 128 box (the slab's least y
    and z; the x operators depend on nx alone)."""
    with env_set({"X3D2_BFLY": "0"} if dense else {}):
        return NavierStokes.build(Mesh((nx, 128, 128), (2 * math.pi,) * 3,
                                       PER), 1 / 1600, dtype=torch.float64,
                                  device="cpu")


@pytest.fixture(scope="module")
def slab128():
    return _solver(128)


def _unpack(op):
    """The packed operator back as (parts, 2, rows padded, K padded)."""
    P = op.packed.numpy()
    parts, rt, kt, _, _ = P.shape
    bn = xm.TILE_ROWS[op.form]
    blocks = P[..., xm.block_index(bn).ravel()].reshape(
        parts, rt, kt, 2, bn, xm.KC)
    return blocks.transpose(0, 3, 1, 4, 2, 5).reshape(
        parts, 2, rt * bn, kt * xm.KC)


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return np.abs(np.asarray(got, np.float64) - want).max() \
        / np.abs(want).max()


# -- (a) the slab's operators packed in their parity forms ------------------

@pytest.mark.parametrize("nx", [128, 320])
def test_packed_x_parity_forms_round_trip(nx):
    ns = _solver(nx)
    pm = ns._slab
    assert pm.x_perm is not None
    for name in ("sx", "ix", "gxs", "gxi"):
        op = pm.packed_x(name)
        assert pm.packed_x(name) is op            # made once
        M = pm.mats(torch.float32)[name].numpy()
        assert op.form == (xm.FWD if name in ("sx", "ix") else xm.INV)
        assert (op.n_out, op.K, op.rows) == (nx, nx // 2, nx // 2)
        full = _unpack(op)
        hi, lo = xm.split_tf32(M)
        for p in range(2):
            half = slice(p * op.rows, (p + 1) * op.rows)
            np.testing.assert_array_equal(full[p, 0, :op.rows, :op.K],
                                          hi[half])
            np.testing.assert_array_equal(full[p, 1, :op.rows, :op.K],
                                          lo[half])
        assert not full[:, :, op.rows:].any()
        assert not full[:, :, :, op.K:].any()
        # hi + lo is the float32 operator within 2^-21 of each entry
        np.testing.assert_array_less(
            np.abs(hi.astype(np.float64) + lo - M),
            2.0 ** -21 * np.abs(M) + 1e-300)


def test_packed_x_dense_x_keeps_the_dense_form():
    pm = _solver(128, dense=True)._slab
    assert pm.x_perm is None
    for name in ("sx", "gxs"):
        op = pm.packed_x(name)
        assert op.form == xm.DENSE and op.n_out == op.K == 128
        full = _unpack(op)
        hi, _ = xm.split_tf32(pm.mats(torch.float32)[name].numpy())
        np.testing.assert_array_equal(full[0, 0], hi)


# -- (b) the FWD item's arithmetic -------------------------------------------

def _item_walk(op, f, s=None, one_read=True, slots=4):
    """The kernel's items and chunks in float32 over the packed operator:
    per chunk the split field chunk (K masked; FWD s = f1 + f2 and d = f1 -
    f2 in float32) and the operator's block, P = (A_lo B_hi + A_hi B_lo) +
    A_hi B_hi in float32, added to the item's sums in float32; INV sums a
    and b apart, then a + b and a - b. one_read: FWD's items take both
    halves (the kernel); else one half an item, re-reading f1 and f2 (the
    FWD it replaces)."""
    n_in, ny, nz = f.shape
    nc = ny * nz
    geo = xm.geometry(op.form, op.n_out, op.K, nc, 132, slots)
    f2 = f.reshape(n_in, nc).astype(np.float32)
    P = op.packed.numpy()
    idx = xm.block_index(geo.bn).ravel()
    rows = xm.out_rows(geo)
    out = np.zeros((op.n_out, nc), np.float32)
    hits = np.zeros((op.n_out, nc), int)
    halves = ([(0, 1)] if one_read else [(0,), (1,)]) \
        if op.form == xm.FWD else [(0,)]
    for it in range(geo.nitems):
        ct, rt = divmod(it, geo.rtiles)
        cols = np.arange(ct * xm.BM, min((ct + 1) * xm.BM, nc))
        for hs in halves:
            sums = {}
            for src in range(2 if op.form == xm.INV else 1):
                for kc in range(geo.ktiles):
                    k = kc * xm.KC + np.arange(xm.KC)
                    ok = (k < op.K)[:, None]
                    kk = np.where(k < op.K, k, 0)
                    if op.form == xm.FWD:
                        a1, a2 = f2[kk][:, cols], f2[kk + op.K][:, cols]
                        srcs = {0: a1 + a2, 1: a1 - a2}
                    else:
                        srcs = {src: f2[kk + src * op.K][:, cols]}
                    for h in (hs if op.form == xm.FWD else (src,)):
                        A = np.where(ok, srcs[h], np.float32(0)).T
                        ah, al = xm.split_tf32(A)
                        blk = P[h, rt, kc][:, idx].reshape(2, geo.bn, xm.KC)
                        bh, bl = blk[0].T, blk[1].T
                        p = (al @ bh + ah @ bl) + ah @ bh
                        sums[h] = p if kc == 0 and h not in sums \
                            else sums[h] + p
            if op.form == xm.INV:
                groups = {0: sums[0] + sums[1], 1: sums[0] - sums[1]}
            elif op.form == xm.FWD:
                groups = {h: sums[h] for h in hs}
            else:
                groups = {0: sums[0]}
            for g, vals in groups.items():
                for n in range(geo.bn):
                    row = rows[g, rt, n]
                    if row >= 0:
                        out[row, cols] = vals[:, n]
                        hits[row, cols] += 1
    assert (hits == 1).all()
    out = out.reshape((op.n_out, ny, nz))
    return out if s is None else np.asarray(s, np.float32) - out


@pytest.mark.parametrize("name,sub", [("sx", False), ("gxs", False),
                                      ("gxi", True)],
                         ids=["fwd-sx", "inv-gxs", "inv-sub-gxi"])
def test_item_model_vs_float64_and_x3d2_tpu(slab128, name, sub):
    pm = slab128._slab
    op = pm.packed_x(name)
    rng = np.random.default_rng(11)
    f = rng.standard_normal((128,) + CUT).astype(np.float32)
    s = rng.standard_normal((128,) + CUT).astype(np.float32) if sub else None
    model = _item_walk(op, f, s)
    if op.form == xm.FWD:
        # the one-read item's bits are the two-item FWD's
        np.testing.assert_array_equal(model, _item_walk(op, f, s, False))
    M32 = pm.mats(torch.float32)[name].numpy()
    parity = "fwd" if op.form == xm.FWD else "inv"
    tcm = xm.tc_model(M32, f, s, parity)
    ref = sl.x_apply_parity_plain(
        name, pm.mats(torch.float64)[name],
        torch.from_numpy(f.astype(np.float64)),
        None if s is None else torch.from_numpy(s.astype(np.float64))
    ).numpy()
    plain32 = sl.x_apply_parity_plain(
        name, pm.mats(torch.float32)[name], torch.from_numpy(f),
        None if s is None else torch.from_numpy(s)).numpy()
    e_walk, e_tc, e_plain = (_rel(x, ref) for x in (model, tcm, plain32))
    print(f"{name}{' sub' if sub else ''}: walk vs f64 {e_walk:.2e}, "
          f"tc_model {e_tc:.2e}, plain f32 {e_plain:.2e}")
    assert e_walk <= TC_LIM and e_tc <= TC_LIM
    fn = make_x_apply(slab128._fp_mats64()[JNAME[name]], terms=2, sub=sub,
                      interpret=True, parity=parity)
    want = np.asarray(fn(*(jnp.asarray(a) for a in ((f,) if s is None
                                                     else (f, s)))))
    assert _rel(model, want) <= 3e-5 and _rel(tcm, want) <= 3e-5


def test_item_model_at_the_tail_x():
    """At nx = 320 (halves of 160: 3 row tiles, 10 chunks, the last row
    tile and chunk part-filled) the one-read FWD item's bits are the
    two-item FWD's, on columns that end inside a tile."""
    pm = _solver(320)._slab
    op = pm.packed_x("ix")
    rng = np.random.default_rng(12)
    f = rng.standard_normal((320, 4, 36)).astype(np.float32)
    got = _item_walk(op, f)
    np.testing.assert_array_equal(got, _item_walk(op, f, one_read=False))
    ref = sl.x_apply_parity_plain(
        "ix", pm.mats(torch.float64)["ix"],
        torch.from_numpy(f.astype(np.float64))).numpy()
    assert _rel(got, ref) <= TC_LIM


# -- (c) the launch geometry ----------------------------------------------

@pytest.mark.parametrize("form", [xm.FWD, xm.INV], ids=["fwd", "inv"])
def test_geometry_parity_items_and_choices(form):
    """The paths' shapes: one item a (column tile, row tile) with both
    halves; the stage holds both halves' operator blocks and field blocks
    (FWD) or one of each (INV), so FWD's 32 KB stage fits 2 to 7 times and
    INV's 2 to 8."""
    for nx, ncols in ((512, 512 * 512), (128, 128 * 256), (128, 128 * 128),
                      (512, 256 * 256), (128, 512 * 512), (320, 256 * 384),
                      (128, 64 * 128), (128, 8 * 128)):
        geo = xm.geometry(form, nx, nx // 2, ncols, 132)
        assert geo.ctiles == -(-ncols // xm.BM)
        assert geo.nitems == geo.ctiles * geo.rtiles
        assert geo.grid == min(132, geo.nitems)
        assert geo.rtiles == -(-(nx // 2) // 64) and geo.bn == 64
        parts = 2 if form == xm.FWD else 1
        stage = parts * (xm.OP_BYTES[form] + xm.BM * xm.KC * 4)
        assert xm.STAGE_BYTES[form] == stage
        assert geo.smem == 4 * stage + xm.SMEM_FIXED
    # the stage of the one-read FWD item: both halves' operator and field
    # blocks, 32 KB; 8 of them are past the card
    assert xm.STAGE_BYTES[xm.FWD] == 32768
    top = 7 if form == xm.FWD else 8
    assert xm.MAX_SLOTS[form] == top
    assert xm.geometry(form, 512, 256, 512 * 512, 132, top).smem \
        <= xm.SMEM_MAX
    if form == xm.FWD:
        assert 8 * 32768 + xm.SMEM_FIXED > xm.SMEM_MAX
        with pytest.raises(ValueError, match="2 to 7 stages"):
            xm.geometry(form, 512, 256, 512 * 512, 132, 8)
        with pytest.raises(ValueError, match="2 to 7 stages"):
            xm.make_x_apply_manual(np.eye(16), parity="fwd", slots=8,
                                   device="cpu")


def _coverage(geo, n_out, ncols):
    """How many times the kernel's items write each output element: per
    consumer warpgroup g, the tile rows of the item's row tile and its 64
    of the item's 128 columns, in units of 64 columns (ncols a multiple of
    64); (n_out, ncols / 64) counts."""
    rows_all = xm.out_rows(geo)                       # (2, rtiles, bn)
    units = np.arange(ncols // 64) * 64
    total = np.zeros((n_out, ncols // 64), np.int32)
    r = rows_all.ravel()
    rcount = np.bincount(r[r >= 0], minlength=n_out)
    for g in range(2):
        ccount = np.zeros(ncols // 64, np.int32)
        for ct in range(geo.ctiles):
            lo = ct * xm.BM + 64 * g
            ccount[(units >= lo) & (units < lo + 64)] += 1
        # the items are every (column tile, row tile): rows and columns
        # are written independently
        total += np.outer(rcount, ccount)
    return total


def test_geometry_walk_writes_each_output_once():
    """Every even x up to 4096 points (the parity gate: even halves), on
    the least plane x3d2_tpu's tiling admits (8 x 128) and at every 64th x
    on 128 x 256; shared memory within SMEM_MAX at S = 2 to 6 at every
    one."""
    for nx in range(2, 4097, 2):
        for ncols in ((8 * 128, 128 * 256) if nx % 64 == 0
                      else (8 * 128,)):
            for form in (xm.FWD, xm.INV):
                for slots in range(2, 7):
                    geo = xm.geometry(form, nx, nx // 2, ncols, 132, slots)
                    assert geo.smem <= xm.SMEM_MAX
                cov = _coverage(geo, nx, ncols)
                assert cov.min() == 1 and cov.max() == 1, (nx, ncols, form)


@pytest.mark.parametrize("ny,nz", [(8, 128), (16, 256), (24, 384), (8, 96),
                                   (4, 128), (12, 128), (8, 130)])
def test_tiling_gate_gives_whole_float4s(slab128, ny, nz):
    """Where x3d2_tpu's make_x_apply tiling (ny % 8, nz % 128) admits the
    plane, ny * nz is a multiple of 4, as the kernel takes it (no runtime
    branch for it); where it refuses, the kernel is never asked."""
    fn = make_x_apply(slab128._fp_mats64()["sx"], terms=2, interpret=True,
                      parity="fwd")
    shape = jax.ShapeDtypeStruct((128, ny, nz), jnp.float32)
    try:
        jax.eval_shape(fn, shape)
        admitted = True
    except ValueError as e:
        assert "tiling" in str(e)
        admitted = False
    assert admitted == (ny % 8 == 0 and nz % 128 == 0)
    if admitted:
        assert (ny * nz) % 4 == 0
        xm.geometry(xm.FWD, 128, 64, ny * nz, 132)


# -- (d) CPU tensors ------------------------------------------------------

@pytest.mark.parametrize("name,sub", [("sx", False), ("gxi", False),
                                      ("gxs", True)])
def test_cpu_takes_the_plain_version(name, sub):
    pm = _solver(128)._slab
    rng = np.random.default_rng(13)
    f = torch.from_numpy(rng.standard_normal((128,) + CUT))
    s = torch.from_numpy(rng.standard_normal((128,) + CUT)) if sub else None
    xm.reset_launch_counts()
    oa.reset_launch_counts()
    got = sl.x_apply_parity(name, f, pm, s)
    want = sl.x_apply_parity_plain(name, pm.mats(torch.float64)[name], f, s)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert xm.launch_counts() == {} and oa.launch_counts() == {}
    assert pm._packed == {}
