"""The split-TF32 x-apply kernel's host side (ops/x_apply_manual.py), on
the CPU: what the kernel in csrc/x_apply_manual.cu takes, and a model of
its arithmetic against float64 and against x3d2_tpu.

- (a) split_tf32 emulates cvt.rna.tf32.f32 (bits + 0x1000, masked with
  0xFFFFE000): hi keeps 10 mantissa bits, rounded to nearest with ties
  away from zero (against a float64 rounding of its own); lo is the
  remainder so rounded; hi + lo is M within 2^-21 of |M|.
- The packed operator: the 64-byte swizzle of each block is CuTe's
  Swizzle<2, 4, 3> on byte addresses; unpacked, it is the split of the
  zero-padded operator. The consumers' A rows (a_columns) hold every
  column of the tile once, and their fragment loads read 32 distinct
  banks of the field's 128-byte swizzled boxes.
- (b) tc_model, the three float32 products of the split operands, at the
  x operators the paths use, on fields cut in y and z: the cylinder's sx,
  ix (512 <- 513) and gxs, gxi (513 <- 512, also with the subtraction),
  X3D2_BFLY=0's at 128 and 256: within 3e-5 * scale of float64 (its
  error over plain float32's printed), and within 2e-4 * scale of
  x3d2_tpu's make_x_apply in interpret mode (the bound of
  tests/test_torch_manual_xapply.py); the parity forms on that file's
  circulant operators.
- (c) The launcher's geometry on the path shapes and on ragged shapes:
  every output row written once, K padded to whole chunks, the items,
  grid and shared memory; a Python walk of the kernel's items and chunks
  over the packed operator (its row and column masks, the K mask of the
  A fragments, the parity halves and sources) gives the float64 product
  of the split operands at ragged shapes. Refusals: shapes, an aliased
  output, the device, the stage count, ny * nz not a multiple of 4.
- (d) CPU tensors take the plain version and count no launch.
"""

import math

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax.numpy as jnp

from x3d2_tpu.ops.pallas_poisson import make_x_apply

from x3d2_tpu_torch.common import BC, env_set
from x3d2_tpu_torch.mesh import Mesh
from x3d2_tpu_torch.ops import operator_apply as oa
from x3d2_tpu_torch.ops import pressure_slab as sl
from x3d2_tpu_torch.ops import x_apply_manual as xm
from x3d2_tpu_torch.ops.matmul_poisson import real_dft_matrix
from x3d2_tpu_torch.ops.parity import parity_split_folded
from x3d2_tpu_torch.parallel.shard_kernels import XApplyOp
from x3d2_tpu_torch.solver import NavierStokes

torch.set_num_threads(1)
threadpool_limits(1, user_api="blas")

CUT = (8, 128)          # y, z of the fields: x3d2_tpu's smallest x tile
CYL_BCS = ((BC.DIRICHLET, BC.DIRICHLET),) + ((BC.PERIODIC, BC.PERIODIC),) * 2
PER = ((BC.PERIODIC, BC.PERIODIC),) * 3


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _rna_ref(x):
    """Round float32 x to 11 significant bits, ties away from zero, in
    float64 arithmetic (normal numbers)."""
    x = np.asarray(x, np.float64)
    m, e = np.frexp(np.abs(x))            # |x| = m 2^e, m in [0.5, 1)
    r = np.floor(m * 2.0 ** 11 + 0.5)     # 11 bits: 1 implicit + 10
    return (np.sign(x) * np.ldexp(r, e - 11)).astype(np.float32)


def test_split_tf32_emulates_cvt_rna():
    one = np.float32(1.0)
    cases = {1 + 2.0 ** -11: 1 + 2.0 ** -10,        # a tie: away from 0
             -(1 + 2.0 ** -11): -(1 + 2.0 ** -10),
             1 + 2.0 ** -12: 1.0, 1 + 3 * 2.0 ** -12: 1 + 2.0 ** -10,
             2.0 - 2.0 ** -12: 2.0, 0.0: 0.0}
    for x, want in cases.items():
        hi, _ = xm.split_tf32(np.array([x], np.float32))
        assert hi[0] == np.float32(want), (x, hi[0], want)
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(200000)
         * 10.0 ** rng.uniform(-6, 6, 200000)).astype(np.float32)
    hi, lo = xm.split_tf32(x)
    assert not (_bits(hi) & 0x1FFF).any() and not (_bits(lo) & 0x1FFF).any()
    np.testing.assert_array_equal(hi, _rna_ref(x))
    np.testing.assert_array_equal(lo, _rna_ref(x - hi))
    x64, h64, l64 = (a.astype(np.float64) for a in (x, hi, lo))
    assert np.all(np.abs(x64 - h64) <= 2.0 ** -11 * np.abs(x64))
    assert np.all(np.abs(h64 + l64 - x64) <= 2.0 ** -21 * np.abs(x64))
    assert xm.split_tf32(one)[1] == 0


@pytest.mark.parametrize("bn", [64, 128])
def test_block_index_is_the_64_byte_swizzle(bn):
    idx = xm.block_index(bn)
    np.testing.assert_array_equal(np.sort(idx.ravel()), np.arange(bn * xm.KC))
    r, k = np.meshgrid(np.arange(bn), np.arange(xm.KC), indexing="ij")
    u = r * 64 + k * 4                      # the unswizzled byte offset
    np.testing.assert_array_equal(4 * idx, u ^ ((u >> 3) & 0x30))
    # each row stays within its own 64 bytes
    np.testing.assert_array_equal(idx // xm.KC, r)


def test_a_columns_cover_the_tile_and_every_bank():
    """The consumers' A rows hold each column of the tile once (per k
    column: the 4 tig lanes of a group share their rows), and each of the 8
    fragment loads of a chunk reads 32 distinct banks of the TMA's
    128-byte swizzled box rows (chunk a of row k at a ^ (k & 7))."""
    cols = xm.a_columns()
    t = np.arange(256)
    tig = t & 3
    np.testing.assert_array_equal(np.sort(cols[tig == 0].ravel()),
                                  np.arange(xm.BM))
    for warp in range(8):
        lanes = np.arange(32) + 32 * warp
        for step in range(2):
            for i in range(4):
                kk = step * 8 + (lanes & 3) + (i >> 1) * 4
                c = cols[lanes, i & 1] % xm.FBOX
                bank = (((c >> 2) ^ (kk & 7)) * 4 + (c & 3)) % 32
                assert len(set(bank)) == 32, (warp, step, i)


def _unpack(op):
    """The packed operator back as (parts, 2, rows padded, K padded)."""
    P = op.packed.numpy()
    parts, rt, kt, _, _ = P.shape
    bn = xm.TILE_ROWS[op.form]
    blocks = P[..., xm.block_index(bn).ravel()].reshape(
        parts, rt, kt, 2, bn, xm.KC)
    return blocks.transpose(0, 3, 1, 4, 2, 5).reshape(
        parts, 2, rt * bn, kt * xm.KC)


@pytest.mark.parametrize("form,shape", [
    (xm.DENSE, (201, 199)), (xm.DENSE, (512, 513)), (xm.FWD, (202, 99)),
    (xm.INV, (198, 101)), (xm.INV, (512, 256))],
    ids=["dense-ragged", "dense-513", "fwd-ragged", "inv-ragged", "inv-512"])
def test_pack_round_trip(form, shape):
    rng = np.random.default_rng(1)
    M = rng.standard_normal(shape)
    op = xm.pack(M, form)
    parts = 1 if form == xm.DENSE else 2
    rows, K = shape[0] // parts, shape[1]
    assert (op.n_out, op.K, op.rows) == (shape[0], K, rows)
    full = _unpack(op)
    hi, lo = xm.split_tf32(M.astype(np.float32))
    for p in range(parts):
        np.testing.assert_array_equal(full[p, 0, :rows, :K],
                                      hi[p * rows:(p + 1) * rows])
        np.testing.assert_array_equal(full[p, 1, :rows, :K],
                                      lo[p * rows:(p + 1) * rows])
    assert not full[:, :, rows:].any() and not full[:, :, :, K:].any()
    assert full.shape[2] % xm.TILE_ROWS[form] == 0
    assert full.shape[3] % xm.KC == 0 and full.shape[3] - K < xm.KC


# -- (b) the model of the arithmetic ----------------------------------------

@pytest.fixture(scope="module")
def path_ops():
    """{label: (name, M64)}: the cylinder's x operators (513 points) and
    X3D2_BFLY=0's dense ones at 128 and 256."""
    out = {}
    ns = NavierStokes.build(Mesh((513, 128, 128), (20.0, 10.0, 2.5),
                                 CYL_BCS), 1 / 300, dtype=torch.float64,
                            device="cpu")
    assert ns._slab.x_perm is None
    for name in ("sx", "ix", "gxs", "gxi"):
        out[f"cyl-{name}"] = (name, ns._slab.m64[name])
    for n in (128, 256):
        with env_set({"X3D2_BFLY": "0"}):
            ns = NavierStokes.build(Mesh((n, 128, 128), (2 * math.pi,) * 3,
                                         PER), 1 / 1600, dtype=torch.float64,
                                    device="cpu")
        assert ns._slab.dense and ns._slab.x_perm is None
        for name in ("sx", "gxi"):
            out[f"bfly0-{n}-{name}"] = (name, ns._slab.m64[name])
    return out


PATH_CASES = [("cyl-sx", False), ("cyl-ix", False), ("cyl-gxs", False),
              ("cyl-gxi", True), ("cyl-gxs", True), ("bfly0-128-sx", False),
              ("bfly0-128-gxi", True), ("bfly0-256-sx", False),
              ("bfly0-256-gxi", True)]


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return np.abs(np.asarray(got, np.float64) - want).max() \
        / np.abs(want).max()


@pytest.mark.parametrize("label,sub", PATH_CASES,
                         ids=[f"{a}{'-sub' if b else ''}"
                              for a, b in PATH_CASES])
def test_model_on_path_operators(path_ops, label, sub):
    _, M64 = path_ops[label]
    n_out, n_in = M64.shape
    rng = np.random.default_rng(n_in + n_out + sub)
    f = rng.standard_normal((n_in,) + CUT)
    s = rng.standard_normal((n_out,) + CUT) if sub else None
    ref = np.tensordot(M64, f, axes=([1], [0]))
    if sub:
        ref = s - ref
    M32, f32 = M64.astype(np.float32), f.astype(np.float32)
    s32 = None if s is None else s.astype(np.float32)
    model = xm.tc_model(M32, f32, s32)
    plain = xm.x_apply_manual_plain(torch.from_numpy(M32),
                                    torch.from_numpy(f32),
                                    None if s32 is None
                                    else torch.from_numpy(s32)).numpy()
    e_model, e_plain = _rel(model, ref), _rel(plain, ref)
    print(f"{label}{' sub' if sub else ''}: model vs f64 {e_model:.2e}, "
          f"plain f32 {e_plain:.2e}, ratio {e_model / e_plain:.2f}")
    assert model.dtype == np.float32 and e_model <= 3e-5
    fn = make_x_apply(M64, terms=2, sub=sub, interpret=True)
    want = fn(*(jnp.asarray(a) for a in ((f32,) if s32 is None
                                         else (f32, s32))))
    assert _rel(model, np.asarray(want)) <= 2e-4


def _circulant(n=32, seed=0):
    """tests/test_torch_manual_xapply.py's forward- and inverse-folded
    circulant operators."""
    rng = np.random.default_rng(seed)
    Op = np.zeros((n, n))
    for k, c in zip(range(-2, 3), rng.standard_normal(5)):
        Op += c * np.roll(np.eye(n), k, axis=1)
    T = real_dft_matrix(n)
    return T @ Op, Op @ np.linalg.inv(T)


@pytest.mark.parametrize("parity,sub", [("fwd", False), ("inv", False),
                                        ("inv", True)],
                         ids=["fwd", "inv", "inv-sub"])
def test_model_parity_forms(parity, sub):
    Mf, Mi = _circulant()
    M = Mf if parity == "fwd" else Mi
    st = np.concatenate(parity_split_folded(M, 0 if parity == "fwd" else 1))
    rng = np.random.default_rng(7)
    f = rng.standard_normal((32, 16, 256))
    s = rng.standard_normal((32, 16, 256)) if sub else None
    ref = xm.x_apply_manual_plain(
        torch.from_numpy(st), torch.from_numpy(f),
        None if s is None else torch.from_numpy(s), parity).numpy()
    model = xm.tc_model(st.astype(np.float32), f.astype(np.float32),
                        None if s is None else s.astype(np.float32), parity)
    assert _rel(model, ref) <= 3e-5


# -- (c) the launch geometry and the kernel's walk -------------------------

GEO_CASES = [  # form, n_out, K, ncols: the paths' launches, then ragged
    (xm.DENSE, 512, 512, 512 * 512), (xm.DENSE, 512, 513, 256 * 128),
    (xm.DENSE, 513, 512, 256 * 128), (xm.DENSE, 128, 128, 128 * 256),
    (xm.DENSE, 128, 128, 128 * 128), (xm.DENSE, 64, 65, 128 * 128),
    (xm.DENSE, 65, 64, 128 * 128), (xm.FWD, 512, 256, 512 * 512),
    (xm.INV, 512, 256, 512 * 512), (xm.DENSE, 201, 199, 36 * 20),
    (xm.FWD, 202, 99, 12 * 12), (xm.INV, 198, 101, 12 * 12)]


@pytest.mark.parametrize("form,n_out,K,ncols", GEO_CASES)
def test_geometry(form, n_out, K, ncols):
    for slots in range(2, xm.MAX_S + 1):
        # every stage count where the ring fits: to MAX_S, but to 7 for
        # FWD's 32 KB stage (both halves' blocks); always to 6
        if xm.STAGE_BYTES[form] * slots + xm.SMEM_FIXED > xm.SMEM_MAX:
            assert slots > 6 and slots > xm.MAX_SLOTS[form]
            with pytest.raises(ValueError, match="stages"):
                xm.geometry(form, n_out, K, ncols, 132, slots)
            continue
        geo = xm.geometry(form, n_out, K, ncols, 132, slots)
        assert geo.smem <= xm.SMEM_MAX
    geo = xm.geometry(form, n_out, K, ncols, 132)
    rows = xm.out_rows(geo)
    written = np.sort(rows[rows >= 0])
    np.testing.assert_array_equal(written, np.arange(n_out))
    assert geo.rows == (n_out if form == xm.DENSE else n_out // 2)
    assert geo.kpad % xm.KC == 0 and 0 <= geo.kpad - K < xm.KC
    assert geo.ctiles * xm.BM >= ncols > (geo.ctiles - 1) * xm.BM
    # an item: a column tile and a row tile (FWD and INV: of both halves)
    assert geo.nitems == geo.ctiles * geo.rtiles
    assert geo.grid == min(132, geo.nitems)
    op = xm.pack(np.ones((n_out, K)), form)
    assert op.packed.shape == ((1 if form == xm.DENSE else 2), geo.rtiles,
                               geo.ktiles, 2, geo.bn * xm.KC)


def _walk(op, f, s=None):
    """The kernel's items and chunks in Python, in float64: per item the
    split field tile (K masked; FWD f1 +/- f2), the packed operator's
    blocks, A_lo B_hi + A_hi B_lo + A_hi B_hi per chunk; the outputs
    through out_rows and the column mask. Returns (out, times each output
    was written)."""
    n_in, ny, nz = f.shape
    nc = ny * nz
    geo = xm.geometry(op.form, op.n_out, op.K, nc, 7)
    f2 = f.reshape(n_in, nc).astype(np.float32)
    P = op.packed.numpy()
    inv_idx = xm.block_index(geo.bn).ravel()
    out = np.zeros((op.n_out, nc))
    hits = np.zeros((op.n_out, nc), int)
    rows = xm.out_rows(geo)
    for it, h in ((it, h) for it in range(geo.nitems)
                  for h in range(2 if op.form == xm.FWD else 1)):
        # an item: a column tile and a row tile; FWD computes both halves
        ct, rt = divmod(it, geo.rtiles)
        c0 = ct * xm.BM
        cols = np.arange(c0, min(c0 + xm.BM, nc))
        acc = []
        for src in range(2 if op.form == xm.INV else 1):
            part = h if op.form == xm.FWD else src
            d = np.zeros((len(cols), geo.bn))
            for kc in range(geo.ktiles):
                k = kc * xm.KC + np.arange(xm.KC)
                ok = k < op.K
                kk = np.where(ok, k, 0)
                if op.form == xm.DENSE:
                    A = f2[kk][:, cols]
                elif op.form == xm.FWD:
                    A = f2[kk][:, cols] + (1 if h == 0 else -1) \
                        * f2[kk + op.K][:, cols]
                else:
                    A = f2[kk + src * op.K][:, cols]
                A = np.where(ok[:, None], A, 0).astype(np.float32).T
                ah, al = (a.astype(np.float64) for a in xm.split_tf32(A))
                blk = P[part, rt, kc][:, inv_idx].reshape(2, geo.bn, xm.KC)
                bh, bl = blk[0].T.astype(np.float64), blk[1].T.astype(
                    np.float64)
                d += al @ bh + ah @ bl + ah @ bh
            acc.append(d)
        groups = [acc[0]] if op.form != xm.INV else [acc[0] + acc[1],
                                                     acc[0] - acc[1]]
        for g, vals in enumerate(groups):
            gg = h if op.form == xm.FWD else g
            for n in range(geo.bn):
                row = rows[gg, rt, n]
                if row >= 0:
                    out[row, cols] = vals[:, n]
                    hits[row, cols] += 1
    out = out.reshape((op.n_out, ny, nz))
    return (out if s is None else s - out), hits


@pytest.mark.parametrize("parity,sub,mshape,fshape", [
    (None, False, (201, 199), (199, 36, 20)),
    (None, True, (65, 64), (64, 4, 33 * 4)),
    ("fwd", False, (202, 99), (198, 12, 12)),
    ("inv", True, (198, 101), (202, 12, 12))],
    ids=["dense", "dense-sub", "fwd", "inv-sub"])
def test_kernel_walk_at_ragged_shapes(parity, sub, mshape, fshape):
    rng = np.random.default_rng(3)
    M = (rng.standard_normal(mshape) / math.sqrt(mshape[1])).astype(
        np.float32)
    f = rng.standard_normal(fshape).astype(np.float32)
    s = rng.standard_normal((mshape[0],) + fshape[1:]) if sub else None
    form = {None: xm.DENSE, "fwd": xm.FWD, "inv": xm.INV}[parity]
    got, hits = _walk(xm.pack(M, form), f, s)
    assert (hits == 1).all()
    # the float64 product of the split operands, by whole matrices
    mh, ml = (a.astype(np.float64) for a in xm.split_tf32(M))

    def prod(lo_rows, A):
        ah, al = (a.astype(np.float64) for a in xm.split_tf32(A))
        return mh[lo_rows] @ al + ml[lo_rows] @ ah + mh[lo_rows] @ ah

    f2 = f.reshape(fshape[0], -1)
    if parity is None:
        want = prod(slice(None), f2)
    else:
        h, ho = fshape[0] // 2, mshape[0] // 2
        top, bot = slice(0, ho), slice(ho, None)
        if parity == "fwd":
            want = np.concatenate([prod(top, f2[:h] + f2[h:]),
                                   prod(bot, f2[:h] - f2[h:])])
        else:
            a, b = prod(top, f2[:h]), prod(bot, f2[h:])
            want = np.concatenate([a + b, a - b])
    want = want.reshape(got.shape)
    if sub:
        want = s - want
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    # and the kernel's float32 model is that within float32 rounding
    model = xm.tc_model(M, f, None if s is None else s.astype(np.float32),
                        parity)
    assert _rel(model, want) <= 1e-6


def test_refusals():
    with pytest.raises(ValueError, match="multiple of 4"):
        xm.geometry(xm.DENSE, 16, 16, 30, 132)
    with pytest.raises(ValueError, match="stages"):
        xm.geometry(xm.DENSE, 16, 16, 32, 132, slots=1)
    with pytest.raises(ValueError, match="stages"):
        xm.geometry(xm.FWD, 16, 8, 32, 132, slots=xm.MAX_S + 1)
    with pytest.raises(ValueError, match="does not fit"):
        xm.geometry(xm.INV, 15, 8, 32, 132)
    with pytest.raises(ValueError, match="even"):
        xm.pack(np.ones((15, 8)), xm.FWD)
    op = xm.pack(np.ones((16, 12)), xm.DENSE)
    f = torch.zeros((12, 4, 8))
    with pytest.raises(TypeError, match="packed"):
        xm.launch("x", torch.ones((16, 12)), f)
    with pytest.raises(ValueError, match="does not fit"):
        xm.launch("x", op, torch.zeros((13, 4, 8)))
    with pytest.raises(ValueError, match="does not fit"):
        xm.launch("x", op, f, s=torch.zeros((16, 4, 4)))
    with pytest.raises(ValueError, match="does not fit"):
        xm.launch("x", op, f, out=torch.zeros((15, 4, 8)))
    sq = xm.pack(np.ones((12, 12)), xm.DENSE)
    with pytest.raises(ValueError, match="alias"):
        xm.launch("x", sq, f, out=f)
    base = torch.zeros(800)
    with pytest.raises(ValueError, match="alias"):
        xm.launch("x", sq, base[:384].view(12, 4, 8),
                  out=base[100:484].view(12, 4, 8))
    with pytest.raises(ValueError, match="CUDA tensors"):
        xm.launch("x", op, f)
    with pytest.raises(ValueError, match="CUDA tensors"):
        oa.apply_dense("x_apply", op, f, torch.zeros((16, 4, 8)))
    with pytest.raises(ValueError, match="inverse-stage"):
        xm.launch("x", xm.pack(np.ones((16, 8)), xm.FWD), f,
                  s=torch.zeros((16, 4, 8)))
    assert xm.launch_counts() == {}


# -- (d) CPU tensors: the plain version, no launch --------------------------

def test_cpu_takes_the_plain_version(path_ops):
    xm.reset_launch_counts()
    oa.reset_launch_counts()
    _, M64 = path_ops["cyl-sx"]
    rng = np.random.default_rng(5)
    f = torch.from_numpy(rng.standard_normal((513,) + CUT))
    want = torch.from_numpy(np.tensordot(M64, f.numpy(), axes=([1], [0])))
    M = torch.from_numpy(M64)
    tol = 1e-12 * float(want.abs().max())
    torch.testing.assert_close(xm.x_apply_manual(M, f), want, rtol=0,
                               atol=tol)
    fn = xm.make_x_apply_manual(M64, device="cpu")
    torch.testing.assert_close(fn(f), want, rtol=0, atol=tol)
    op = XApplyOp(type("Op", (), {"M": M})())
    torch.testing.assert_close(op(f, 0), want, rtol=0, atol=tol)
    assert op._packed is None
    ns = NavierStokes.build(Mesh((17, 128, 128), (20.0, 10.0, 2.5),
                                 CYL_BCS), 1 / 300, dtype=torch.float64,
                            device="cpu")
    pm = ns._slab
    g = torch.from_numpy(rng.standard_normal((17, 128, 128)))
    want = torch.from_numpy(np.tensordot(pm.m64["sx"], g.numpy(),
                                         axes=([1], [0])))
    torch.testing.assert_close(sl.x_apply("sx", g, pm), want, rtol=0,
                               atol=1e-12 * float(want.abs().max()))
    assert pm._packed == {}
    assert xm.launch_counts() == {} and oa.launch_counts() == {}
