"""The tensor-core momentum sweep's host side (ops/transeq_sweep.py:
tc_pack, tc_model, tc_writes, the route), on the CPU: what the kernel
transeq_sweep_tc_kernel in csrc/transeq_sweep.cuh takes, and a model of
its arithmetic against float64 and against x3d2_tpu.

- (a) The packer against the dense blocks of build_sweep_blocks, at
  several grid and axis sizes: slice s keeps chunks s .. s + 2 (every row
  its +/- W taps), every entry above the band tolerance (x3d2_tpu's 1e-6
  of its operator's largest, the one the blocks are held to) lies in a
  kept chunk, and what is dropped is at least W + 1 points off the
  diagonal; a uniform periodic axis packs one image set (3 images a
  pairing) that every slice and block repeats; the hi / lo images are
  split_tf32 of the kept float32 entries. A non-periodic operator whose
  closure rows reach past the band, and a periodic one that is not
  circulant, are refused with a message, and their launches take the SIMT
  body.
- (b) tc_model, the kernel's arithmetic in float32 (each chunk's three
  products of the split operands summed, then added to the slice's sums),
  for the main path's instances and every other instance of the body, at
  (128, 128, 256) and on a cut of PX (320 x 256 x 384): within 5e-7 of
  max |plain float64| (u' with a bfloat16 history folded with dtc4
  RNE(rhs), as chip_smoke.py does; bfloat16 outputs within one bfloat16
  ulp of plain float32's plus that limit); the fused AB3 chain of the model within 3e-5 *
  scale of x3d2_tpu's make_fused_transeq_ab_v3 in interpret mode on the
  same numpy inputs.
- (c) The launch geometry: tc_writes, the kernel's walk of blocks, tiles,
  slices, threads and elements, writes each output once; at the paths'
  sizes every shape sweep_shape_ok admits packs and takes the
  tensor-core body.
- (d) CPU tensors take the plain version and count no launch. A solver
  with a non-periodic axis of 512 points takes the sweeps; that axis'
  launches go to the SIMT body (its closure rows are not circulant), the
  periodic axes' to the tensor-core body, through the wrapper's launch
  with the libraries stood in for.
"""

import contextlib

from types import SimpleNamespace

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax.numpy as jnp

from x3d2_tpu.common import BC as JBC
from x3d2_tpu.mesh import Mesh as JMesh
from x3d2_tpu.ops.pallas_kernels import make_fused_transeq_ab_v3
from x3d2_tpu.solver import NavierStokes as JNavierStokes

from x3d2_tpu_torch.common import BC
from x3d2_tpu_torch.mesh import Mesh
from x3d2_tpu_torch.ops import transeq_sweep as ts
from x3d2_tpu_torch.ops.banded import banded_blocks
from x3d2_tpu_torch.ops.x_apply_manual import split_tf32
from x3d2_tpu_torch.solver import NavierStokes
from x3d2_tpu_torch.time_integrators import TimeIntegrator

# one thread for torch and for numpy's BLAS: the suite runs several workers
# on one machine, and multi-threaded BLAS calls in each of them, spinning on
# oversubscribed cores, made these tests many times slower there
torch.set_num_threads(1)
threadpool_limits(1, user_api="blas")

SHAPE = (128, 128, 256)
PX = (320, 256, 384)
L = (2 * np.pi,) * 3
PER = ((BC.PERIODIC, BC.PERIODIC),) * 3
NU = 1 / 1600
DT = 1e-3
BF = torch.bfloat16
# the model against plain float64, relative to max |plain f64| (the
# x-apply kernel's 3-4e-7 and the slices' dropped taps, <= 1.9e-7 of an
# operator's largest entry for compact6's D1 at W + 1 = 17 points)
MODEL_LIM = 5e-7


def _ns(shape):
    return NavierStokes.build(Mesh(shape, L, PER), NU, device="cpu")


@pytest.fixture(scope="module")
def ns():
    return _ns(SHAPE)


@pytest.fixture(scope="module")
def ns_px():
    return _ns(PX)


def _rng(seed):
    return np.random.default_rng(seed)


def _fields(rng, shape, k, scale=1.0):
    return tuple(torch.from_numpy((scale * rng.standard_normal(shape))
                                  .astype(np.float32)) for _ in range(k))


# ---------------------------------------------------------------------------
# (a) the packer
# ---------------------------------------------------------------------------

def _operators(m64, bs):
    """The dense (nb, bs, 96) blocks of each operator in the stacks."""
    return [m64["sa"][:, :bs], m64["sa"][:, bs:], m64["st"][:, :bs],
            m64["st"][:, bs:], m64["da"], m64["dt"]]


def _check_pack(blocks, tol=ts._BAND_TOL):
    """The packed images against the dense blocks: every entry above tol
    of its operator's largest lies in its slice's chunks s .. s + 2, and
    the images split block 0's slice 0, whose rows every slice of every
    block repeats over its chunks."""
    pk = ts.tc_pack(blocks)
    m, bs, nb = blocks.m64, blocks.bs, blocks.nb
    for P in _operators(m, bs):
        big = np.abs(P) > tol * np.abs(P).max()
        for b in range(nb):
            for s in range(ts.TC_NSL):
                cols = np.flatnonzero(big[b, 16 * s:16 * s + 16].any(0))
                assert cols.min() >= 16 * s and cols.max() < 16 * (s + 3)
    for j in range(ts.TC_SLICE_CHUNKS):
        for p, (sk, dk) in enumerate(ts._PAIRINGS):
            got = pk.parts(p, j)
            for b in range(nb):
                for s in range(ts.TC_NSL):
                    S, D = m[sk][b], m[dk][b]
                    rows = slice(16 * s, 16 * s + 16)
                    cols = slice(16 * (s + j), 16 * (s + j + 1))
                    sb = np.concatenate([S[rows, cols], S[bs:][rows, cols]])
                    if b == s == 0:
                        want = split_tf32(sb) + split_tf32(D[rows, cols])
                        assert all(np.array_equal(g, w)
                                   for g, w in zip(got, want))
                    # TF32 halves whose sum is this slice's own entries
                    for hi, lo, e in ((got[0], got[1], sb),
                                      (got[2], got[3], D[rows, cols])):
                        assert not (hi.view(np.uint32) & 0x1FFF).any()
                        assert np.abs(hi.astype(np.float64) + lo - e
                                      ).max() <= 2e-7 * np.abs(e).max()
    return pk


@pytest.mark.parametrize("n", [128, 192, 256, 320, 384, 512, 640])
def test_pack_uniform_periodic_axes(n):
    """One image set for a uniform periodic axis of every size the paths
    give along a sweep (128 the smallest it tiles); the drop stays under the
    band tolerance and is the +/- W + 1 taps the blocks drop at their
    edges (1.9e-7 of D1's largest for compact6)."""
    ops = _ns((n, 64, 64)).ops[0]
    blocks = ts.build_sweep_blocks(ops, 0, device="cpu")
    pk = _check_pack(blocks)
    assert pk.images.shape == (2, ts.TC_SLICE_CHUNKS, ts.TC_IMG)
    assert 1e-7 < pk.dropped < ts._BAND_TOL


def _fake_blocks(M, periodic=True):
    """SweepBlocks of one operator M (n, n) standing for all four."""
    op = SimpleNamespace(M64=M, periodic=periodic)
    bb = banded_blocks(op, ts.TC_W, ts.TC_BS, tol=ts._BAND_TOL)
    m64 = {"sa": np.concatenate([bb, bb], axis=1),
           "st": np.concatenate([bb, bb], axis=1), "da": bb, "dt": bb}
    return ts.SweepBlocks(axis=0, m64=m64, device=torch.device("cpu"))


def _banded(n, rng, periodic):
    """A non-circulant operator within the band: a 7-point stencil with
    random entries, every row its own (cut at the ends where not
    periodic)."""
    M = np.zeros((n, n))
    r = np.arange(n)
    for d in range(-3, 4):
        c = r + d
        ok = slice(None) if periodic else (c >= 0) & (c < n)
        M[r[ok], (c % n)[ok]] = rng.standard_normal(n)[ok]
    return M


def test_pack_refuses_closure_rows_and_non_circulant():
    """A closure row of a non-periodic axis reaching past its slice's band
    (40 points off the diagonal, in the block's window), and a periodic
    operator whose rows differ, are refused with a message (their launches
    on the card take the SIMT body: tc_route); the CPU route keeps its
    plain version."""
    rng = _rng(1)
    n = 256
    M = _banded(n, rng, periodic=False)
    M[1, 41] = 0.5           # block 0, slice 0: window column 57, chunk 3
    blocks = _fake_blocks(M, periodic=False)
    with pytest.raises(ValueError, match="outside its slice's band"):
        ts.tc_pack(blocks)
    with pytest.raises(ValueError, match="outside its slice's band"):
        ts.tc_pack(blocks)       # the refusal is kept, not packed again
    assert not ts.tc_route(blocks)
    f = _fields(rng, (n, 4, 64), 3)
    want = ts.transeq_sweep_plain(*f, blocks, NU)
    assert all(torch.equal(g, w) for g, w in
               zip(ts.transeq_sweep(*f, blocks, NU), want))
    blocks = _fake_blocks(_banded(n, rng, periodic=True))
    with pytest.raises(ValueError, match="not circulant"):
        ts.tc_pack(blocks)
    assert not ts.tc_route(blocks)
    # a circulant operator of the same stencil is taken
    C = np.zeros((n, n))
    for d, x in zip(range(-3, 4), rng.standard_normal(7)):
        C[np.arange(n), (np.arange(n) + d) % n] = x
    blocks = _fake_blocks(C)
    assert _check_pack(blocks).dropped == 0.0 and ts.tc_route(blocks)


def test_pack_refuses_other_geometries(ns):
    blocks = ts.build_sweep_blocks(ns.ops[0], 0, device="cpu", terms=3)
    with pytest.raises(ValueError, match="BS=64, W=16"):
        ts.tc_pack(blocks)
    assert not ts.tc_route(blocks)


# ---------------------------------------------------------------------------
# (b) the model of the kernel's arithmetic
# ---------------------------------------------------------------------------

AB = TimeIntegrator("AB3")
RK3, RK4 = TimeIntegrator("RK3"), TimeIntegrator("RK4")

# (label, axis, keywords: acc, nolds, dtc, base, bf16 history, bf16
# partials); the main path's three first
VARIANTS = [
    ("z", 2, {}),
    ("x,acc", 0, {"acc": True}),
    ("y,acc,ab3", 1, {"acc": True, "nolds": 2, "dtc": AB.ab_row(3, DT)}),
    ("y,acc", 1, {"acc": True}),
    ("z,acc", 2, {"acc": True}),
    ("x,acc,ab2", 0, {"acc": True, "nolds": 1, "dtc": AB.ab_row(2, DT)}),
    ("y,acc,ab4", 1, {"acc": True, "nolds": 3,
                      "dtc": TimeIntegrator("AB4").ab_row(4, DT)}),
    ("y,acc,rk0", 1, {"acc": True, "nolds": 0, "dtc": RK3.rk_row(0, DT)}),
    ("y,acc,rk0,f0", 1, {"acc": True, "nolds": 0, "dtc": RK3.rk_row(1, DT),
                         "base": True}),
    ("y,acc,rk2,f0", 1, {"acc": True, "nolds": 2, "dtc": RK3.rk_row(2, DT),
                         "base": True}),
    ("y,acc,rk3,f0", 1, {"acc": True, "nolds": 3, "dtc": RK4.rk_row(3, DT),
                         "base": True}),
    ("z,bf16acc", 2, {"bacc": True}),
    ("x,acc,bf16acc", 0, {"acc": True, "bacc": True}),
    ("y,acc,bf16acc", 1, {"acc": True, "bacc": True}),
    ("y,acc,ab3,bf16olds", 1, {"acc": True, "nolds": 2, "bolds": True,
                               "dtc": AB.ab_row(3, DT, feedback=True)}),
    ("y,acc,ab3,bf16acc", 1, {"acc": True, "nolds": 2, "bacc": True,
                              "dtc": AB.ab_row(3, DT)}),
    ("y,acc,ab3,bf16olds,bf16acc", 1, {"acc": True, "nolds": 2,
                                       "bolds": True, "bacc": True,
                                       "dtc": AB.ab_row(3, DT,
                                                        feedback=True)}),
]


def _inputs(kw, shape, rng):
    """(u, v, w), and the keywords of transeq_sweep for a variant."""
    u, v, w = _fields(rng, shape, 3)
    args = {}
    adt = BF if kw.get("bacc") else None
    if kw.get("acc"):
        acc = _fields(rng, shape, 3, 100.0)
        args["acc"] = tuple(a.to(adt) for a in acc) if adt else acc
    if "dtc" in kw:
        hdt = BF if kw.get("bolds") else torch.float32
        args["olds"] = tuple(
            tuple(o.to(hdt) for o in _fields(rng, shape, kw["nolds"], 100.0))
            for _ in range(3))
        args["dtc"] = kw["dtc"]
    if kw.get("base"):
        args["base"] = _fields(rng, shape, 3)
    if adt:
        args["acc_dtype"] = adt
    return (u, v, w), args


def _flat(res):
    return list(res[0]) + list(res[1]) if isinstance(res[0], tuple) \
        else list(res)


def _to64(args):
    def cv(t):
        if isinstance(t, tuple):
            return tuple(cv(x) for x in t)
        return t.double() if torch.is_tensor(t) and t.dtype == torch.float32 \
            else t
    return {k: cv(v) for k, v in args.items()}


def _fold(outs, args):
    """u' with a bfloat16 history plus dtc4 RNE(rhs): free of the rounding
    of rhs, which model and float64 may take to neighbouring values; the
    bfloat16 outputs apart."""
    if "dtc" not in args:
        f32 = [o for o in outs if o.dtype != BF]
        return f32, [o for o in outs if o.dtype == BF]
    new, rhs = outs[:3], outs[3:]
    if rhs[0].dtype != BF:
        return list(new) + list(rhs), []
    d4 = args["dtc"][4]
    return [q + d4 * r.to(q.dtype) for q, r in zip(new, rhs)], list(rhs)


def _check_model(blocks, fields, args, label):
    got = _flat(ts.tc_model(*fields, blocks, NU, **args))
    p32 = _flat(ts.transeq_sweep_plain(*fields, blocks, NU, **args))
    p64 = _flat(ts.transeq_sweep_plain(*(f.double() for f in fields),
                                       blocks, NU, **_to64(args)))
    g32, g16 = _fold(got, args)
    w64, _ = _fold(p64, args)
    _, w16 = _fold(p32, args)
    for g, w in zip(g32, w64):
        rel = float((g.double() - w).abs().max() / w.abs().max())
        assert rel <= MODEL_LIM, f"{label}: model vs plain f64 {rel:.2e}"
    for g, w in zip(g16, w16):
        # one bfloat16 ulp of plain float32's rounding, plus the float32
        # limit (near zero the float32 difference exceeds the ulp)
        w = w.float()
        ulp = torch.ldexp(torch.ones_like(w), torch.frexp(w)[1] - 8)
        lim = ulp + MODEL_LIM * w.abs().max()
        assert bool(((g.float() - w).abs() <= lim).all()), label


@pytest.mark.parametrize("label,axis,kw", VARIANTS,
                         ids=[v[0] for v in VARIANTS])
def test_model_matches_float64(ns, label, axis, kw):
    blocks = ts.build_sweep_blocks(ns.ops[axis], axis, device="cpu")
    fields, args = _inputs(kw, SHAPE, _rng(10 + VARIANTS.index(
        (label, axis, kw))))
    _check_model(blocks, fields, args, label)


# the main path's instances on cuts of PX: the sweep axis whole (x 320: five
# blocks; y 256; z 384: six), the other extents cut to a few tiles
PX_CUTS = {0: (320, 16, 64), 1: (4, 256, 64), 2: (16, 8, 384)}


@pytest.mark.parametrize("label,axis,kw", VARIANTS[:3],
                         ids=[v[0] for v in VARIANTS[:3]])
def test_model_matches_float64_px(ns_px, label, axis, kw):
    blocks = ts.build_sweep_blocks(ns_px.ops[axis], axis, device="cpu")
    assert ts.sweep_shape_ok(PX_CUTS[axis], axis)
    fields, args = _inputs(kw, PX_CUTS[axis], _rng(30 + axis))
    _check_model(blocks, fields, args, label)


def test_model_chain_matches_x3d2_tpu_interpret(ns):
    """The fused AB3 chain z -> x + acc -> y + acc + AB3 of the model
    against x3d2_tpu's make_fused_transeq_ab_v3 in interpret mode, on the
    same numpy inputs: 3e-5 * scale (tests/test_pallas_v3.py:63)."""
    rng = _rng(5)
    u, v, w = (rng.standard_normal(SHAPE).astype(np.float32)
               for _ in range(3))
    holds = [[(0.05 * rng.standard_normal(SHAPE)).astype(np.float32)
              for _ in range(2)] for _ in range(3)]
    row = AB.ab_row(3, DT)
    jns = JNavierStokes.build(JMesh(SHAPE, L, ((JBC.PERIODIC,
                                                JBC.PERIODIC),) * 3),
                              NU, dtype=jnp.float32)
    jfn = make_fused_transeq_ab_v3(jns.ops, NU, SHAPE, nolds=2,
                                   interpret=True)
    (jn, jr) = jfn(*(jnp.asarray(a) for a in (u, v, w)),
                   tuple(tuple(jnp.asarray(x) for x in p) for p in holds),
                   jnp.asarray(row, jnp.float32))
    f = tuple(torch.from_numpy(a) for a in (u, v, w))
    blocks = [ts.build_sweep_blocks(ns.ops[a], a, device="cpu")
              for a in range(3)]
    acc = ts.tc_model(*f, blocks[2], NU)
    acc = ts.tc_model(*f, blocks[0], NU, acc=acc)
    olds = tuple(tuple(torch.from_numpy(x) for x in p) for p in holds)
    new, rhs = ts.tc_model(*f, blocks[1], NU, acc=acc, olds=olds, dtc=row)
    for g, e in zip(list(new) + list(rhs), list(jn) + list(jr)):
        e = np.asarray(e)
        err = np.abs(g.numpy() - e).max()
        assert err <= 3e-5 * np.abs(e).max(), f"{err:.2e}"


# ---------------------------------------------------------------------------
# (c) the launch geometry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,axis", [
    (SHAPE, 0), (SHAPE, 1), (SHAPE, 2), ((320, 8, 64), 0),
    ((4, 192, 128), 1), ((2, 32, 384), 2), ((128, 2, 64), 0)])
@pytest.mark.parametrize("sms", [132, 16])
def test_writes_each_output_once(shape, axis, sms):
    assert ts.sweep_shape_ok(shape, axis)
    idx = ts.tc_writes(shape, axis, sms)
    n = shape[0] * shape[1] * shape[2]
    assert idx.size == n
    assert np.array_equal(np.bincount(idx, minlength=n), np.ones(n, int))


# the paths' grids (chip_smoke.py): 512^3, 256^3, 128 x 128 x 256, 128^3,
# PX, PY, YD, the carry's 128 x 128 x 640 and DZ's 512 x 512 x 1024
PATH_SHAPES = [(512,) * 3, (256,) * 3, SHAPE, (128,) * 3, PX,
               (384, 192, 384), (256, 200, 256), (128, 128, 640),
               (512, 512, 1024)]


@pytest.mark.parametrize("shape", PATH_SHAPES,
                         ids=["x".join(map(str, s)) for s in PATH_SHAPES])
def test_paths_shapes_fit(shape):
    """Every axis sweep_shape_ok admits at the paths' sizes is the
    kernel's: n a multiple of 64, at least 96, the lines whole tiles; its
    operators pack (one image set), and the launch's shared memory fits a
    block."""
    assert ts.TC_SMEM <= 232448
    for axis in range(3):
        if not ts.sweep_shape_ok(shape, axis):
            continue
        n = shape[axis]
        assert n % ts.TC_BS == 0 and n >= ts.TC_BS + 2 * ts.TC_W
        ops = _ns(tuple(s if a == axis else 64
                        for a, s in enumerate(shape))).ops[axis]
        blocks = ts.build_sweep_blocks(ops, axis, device="cpu")
        assert ts.tc_route(blocks) and ts.tc_pack(blocks).dropped < 1e-6
        assert ts.grid_of(shape, axis, 132) >= 1


# ---------------------------------------------------------------------------
# (d) the CPU route
# ---------------------------------------------------------------------------

def test_cpu_tensors_take_the_plain_version(ns):
    rng = _rng(7)
    fields, args = _inputs(VARIANTS[2][2], SHAPE, rng)
    blocks = ts.build_sweep_blocks(ns.ops[1], 1, device="cpu")
    assert ts.tc_route(blocks)
    ts.reset_launch_counts()
    got = _flat(ts.transeq_sweep(*fields, blocks, NU, **args))
    want = _flat(ts.transeq_sweep_plain(*fields, blocks, NU, **args))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert ts.launch_counts() == {} and ts.tc_launch_counts() == {}


class _FakeLib:
    """Stands in for a sweep library: records the body each launch asks
    for, launches nothing."""

    def __init__(self, calls):
        self.calls = calls

    def transeq_sweep_tc_launch(self, *args):
        self.calls.append("tc")
        return 0

    def transeq_sweep_launch(self, *args):
        self.calls.append("simt")
        return 0


# a non-periodic x or y axis of 512 points (the Poisson solver takes x
# and y non-periodic, z periodic): (x BCs, y BCs)
NON_PERIODIC = [(BC.DIRICHLET, BC.PERIODIC), (BC.NEUMANN, BC.PERIODIC),
                (BC.PERIODIC, BC.NEUMANN), (BC.DIRICHLET, BC.NEUMANN)]


@pytest.mark.parametrize("bcx, bcy", NON_PERIODIC,
                         ids=[f"{x.name}-{y.name}" for x, y in NON_PERIODIC])
def test_non_periodic_axis_takes_the_simt_body(bcx, bcy, monkeypatch):
    """A solver with a non-periodic axis of 512 points takes the sweeps
    (transport_route, as x3d2_tpu's transeq_v3_supported asks no periodic
    axis); the blocks of that axis are refused by the packer when they are
    built, and each launch of the fused AB3 chain, through the wrapper's
    own launch with the libraries stood in for (and CPU tensors standing
    in for the card's, never written), asks the SIMT body for that axis'
    sweep and the tensor-core body for the periodic ones; only the latter
    count as tensor-core launches."""
    from x3d2_tpu_torch.solver import transport_route

    bcs = ((bcx,) * 2, (bcy,) * 2, (BC.PERIODIC,) * 2)
    shape = (512, 128, 256) if bcx != BC.PERIODIC else (128, 512, 256)
    ns_ = NavierStokes.build(Mesh(shape, L, bcs), NU, device="cpu")
    assert transport_route(ns_, shape) == "sweeps"
    periodic = [b == BC.PERIODIC for b in (bcx, bcy, BC.PERIODIC)]
    fn = ts.make_fused_transeq_ab(ns_.ops, NU, shape, 2, device="cpu")
    for sweep in fn.sweeps:
        blocks = sweep.blocks
        assert ts.tc_route(blocks) == periodic[blocks.axis]
        if not periodic[blocks.axis]:
            assert "not circulant" in blocks.tc_refusal
    calls = []
    monkeypatch.setattr(ts, "_lib", lambda w=ts.W: _FakeLib(calls))
    monkeypatch.setattr(ts, "_tc_lib", lambda: _FakeLib(calls))
    monkeypatch.setattr(ts, "_check", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: SimpleNamespace(multi_processor_count=132))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())

    def empty():
        return torch.empty(shape)

    u, v, w = empty(), empty(), empty()
    olds = tuple((empty(), empty()) for _ in range(3))
    ts.reset_launch_counts()
    d2, d0, d1 = fn.sweeps
    acc = ts._launch(u, v, w, d2.blocks, NU, None, None, None, None)
    acc = ts._launch(u, v, w, d0.blocks, NU, acc, None, None, acc)
    ts._launch(u, v, w, d1.blocks, NU, acc, olds, AB.ab_row(3, DT),
               (tuple(o[-1] for o in olds), acc))
    want = ["tc" if periodic[a] else "simt" for a in (2, 0, 1)]
    assert calls == want
    names = [ts.variant_name(2, False, 0), ts.variant_name(0, True, 0),
             ts.variant_name(1, True, 2)]
    assert ts.launch_counts() == {k: 1 for k in names}
    assert ts.tc_launch_counts() == {k: 1 for k, b in zip(names, want)
                                     if b == "tc"}
    ts.reset_launch_counts()
