"""The pipeline's stages A and C on the split-TF32 tensor-core kernel
(csrc/x_apply_manual.cu: a z launch in its transposed form and a y launch
batched over the x planes, ops/pressure_pipe.py), on the CPU: the folded
operators, a model of the kernel's arithmetic against float64 and
x3d2_tpu, the launch geometry, and the CPU route.

- (a) The y operators folded into the y transforms (pressure_pipe.fold_y:
  Ty C = [Me (C11 + C12); Mo (C11 - C12)], C Tyi = pinv((C11 + C12) Me,
  (C11 - C12) Mo) for the circulant Iy, Sy, Giy, Gsy), applied after the z
  transforms in float64, match pipe_a_plain and pipe_c_plain (the banded
  y, x3d2_tpu's order) to 1e-13 of the output's max (measured below
  5e-15) at 128^3 and at cuts of PX (320 x 256 x 384) and PY (384 x 192 x
  384) to 16 x planes (the stages act along y and z alone).
- (b) A y operator that is not circulant is refused (fold_y, and the
  pipeline's build); so is an operator set without the parity y.
- (c) A float32 model of the kernel's launches (each k chunk's three
  products of the split operands, from the packed operators' blocks,
  added to the sums in float32, a two-source job's chunks continuing one
  chain, INV's a then b chunks) through stages A and C is within 4e-7 of
  max |float64| (the kernel's limit on the card) at 128^3, at the PY cut
  (y halves of 96: a part-filled row tile) and at a z of 144 (halves of
  72: a part-filled k chunk), and within 3e-6 * scale (tests/
  test_torch_pipe.py's bound) of x3d2_tpu's make_pressure_pipe3 stages in
  interpret mode (terms=3) at 128^3.
- (d) The launch geometry (x_apply_manual.geometry, item_of, out_rows,
  a_columns) of every launch of stages A and C writes each output element
  once: a walk of the items at small grids, and the items' structure at
  512^3, PX, PY, 128^3 and 128 x 128 x 144; the refusals of launch_jobs.
- (e) CPU tensors take the plain version and count no launch in either
  counter, and nothing is packed.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax.numpy as jnp

from x3d2_tpu.common import BC as JBC
from x3d2_tpu.mesh import Mesh as JMesh
from x3d2_tpu.ops.pallas_poisson import make_pressure_pipe3
from x3d2_tpu.solver import NavierStokes as JNavierStokes

from x3d2_tpu_torch.common import BC
from x3d2_tpu_torch.mesh import Mesh
from x3d2_tpu_torch.ops import operator_apply as oa
from x3d2_tpu_torch.ops import pressure_pipe as pp
from x3d2_tpu_torch.ops import x_apply_manual as xm
from x3d2_tpu_torch.ops.parity import build_projection_mats, pfwd, pinv
from x3d2_tpu_torch.solver import NavierStokes

torch.set_num_threads(1)
threadpool_limits(1, user_api="blas")

L = (2 * np.pi,) * 3
NU = 1 / 1600
PER = ((BC.PERIODIC, BC.PERIODIC),) * 3
JPER = ((JBC.PERIODIC, JBC.PERIODIC),) * 3
CUBE = (128, 128, 128)
PX_CUT = (16, 256, 384)
PY_CUT = (16, 192, 384)
Z_HALF = (16, 128, 144)
TC_LIM = 4e-7           # the split-TF32 kernel's limit against float64


def _pm(dims, dtype=torch.float64):
    ns = NavierStokes.build(Mesh(dims, L, PER), NU, dtype=dtype,
                            device="cpu")
    return build_projection_mats(ns)


def _fields(dims, n, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(dims).astype(dtype) for _ in range(n)]


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return np.abs(np.asarray(got, np.float64) - want).max() \
        / np.abs(want).max()


def _folded64(pm, u, v, w, X, Y):
    """Stages A and C with the folded y, in float64, as the kernel's
    launches order them: z transforms, then the folded y."""
    m = pm.mats(torch.float64)
    F = {k: torch.from_numpy(M) for k, M in pp.fold_y(pm).items()}
    z1, z2, z3 = pfwd(m["iz"], u, 2), pfwd(m["iz"], v, 2), pfwd(m["sz"], w, 2)
    a = pfwd(F["tyI"], z1, 1)
    e = pfwd(F["tyS"], z2, 1) + pfwd(F["tyI"], z3, 1)
    px, dzy, pzy = pinv(m["gzi"], X, 2), pinv(m["gzs"], Y, 2), \
        pinv(m["gzi"], Y, 2)
    c = (u - pinv(F["giT"], px, 1), v - pinv(F["gsT"], pzy, 1),
         w - pinv(F["giT"], dzy, 1))
    return (a, e), c


# -- (a) the fold ------------------------------------------------------------

@pytest.mark.parametrize("dims", [CUBE, PX_CUT, PY_CUT],
                         ids=["128", "px-cut", "py-cut"])
def test_folded_operators_match_the_plain_stages_f64(dims):
    pm = _pm(dims)
    m = pm.mats(torch.float64)
    u, v, w, X, Y = (torch.from_numpy(a) for a in _fields(dims, 5, 1))
    (a, e), c = _folded64(pm, u, v, w, X, Y)
    want_ae = pp.pipe_a_plain(u, v, w, m)
    want_c = pp.pipe_c_plain(X, Y, u, v, w, m)
    for got, want in zip((a, e) + c, want_ae + want_c):
        assert _rel(got.numpy(), want.numpy()) < 1e-13
    # the folded operators are parity stacks of the transforms' size
    ny = dims[1]
    for k, M in pp.fold_y(pm).items():
        assert M.shape == (ny, ny // 2), k
    assert pp.fold_y(pm) is pp.fold_y(pm)          # made once


# -- (b) the refusals --------------------------------------------------------

def test_fold_refuses_a_non_circulant_y():
    pm = _pm((16, 128, 128))
    y64 = dict(pm.y64)
    iy = y64["iy"].copy()
    iy[5, 7] += 1e-6 * np.abs(iy).max()
    y64["iy"] = iy
    bad = dataclasses.replace(pm, y64=y64, _dev={}, _packed={}, _fold={})
    with pytest.raises(ValueError, match="circulant"):
        pp.fold_y(bad)
    with pytest.raises(ValueError, match="circulant"):
        pp.make_pressure_pipe(bad)
    # within the tolerance it folds
    iy[5, 7] -= 1e-6 * np.abs(iy).max()
    iy[5, 7] += 1e-14 * np.abs(iy).max()
    pp.fold_y(dataclasses.replace(pm, y64=y64, _dev={}, _packed={},
                                  _fold={}))
    # no whole y operators, or no parity y transforms: nothing to fold
    with pytest.raises(ValueError, match="parity y"):
        pp.fold_y(dataclasses.replace(pm, y64=None, _fold={}))
    # X3D2_BFLY=0's dense y transforms
    dense = build_projection_mats(NavierStokes.build(
        Mesh((16, 128, 128), L, PER), NU, dtype=torch.float64,
        device="cpu"), dense=True)
    assert dense.forms.y == "dense"
    with pytest.raises(ValueError, match="parity y"):
        pp.fold_y(dense)


# -- (c) the kernel's arithmetic ---------------------------------------------

def _unpack(op):
    """A packed operator back as (parts, 2, rows padded, K padded)."""
    P = op.packed.numpy()
    parts, rt, kt, _, _ = P.shape
    bn = xm.TILE_ROWS[op.form]
    blocks = P[..., xm.block_index(bn).ravel()].reshape(
        parts, rt, kt, 2, bn, xm.KC)
    return blocks.transpose(0, 3, 1, 4, 2, 5).reshape(
        parts, 2, rt * bn, kt * xm.KC)


def _columns(f, axis):
    """The field as the kernel's items see it: (planes, n_in, columns),
    the contraction along the middle axis (y: nx planes of nz columns; z:
    one plane of nx ny lines)."""
    if axis == 1:
        return f
    return f.reshape(1, -1, f.shape[2]).transpose(0, 2, 1)


def _launch_model(axis, jobs):
    """One launch of the kernel in float32 over packed operators: per job,
    its sources' k chunks in order (INV: a source's a chunks, then its b
    chunks), each chunk's P = (A_lo B_hi + A_hi B_lo) + A_hi B_hi of the
    split field chunk (k past K masked; FWD s = f1 + f2 and d = f1 - f2 in
    float32) and the operator's split block, added to the sums in
    float32. jobs: (ops, fields, s) with numpy float32 (nx, ny, nz)
    fields; returns the outputs."""
    outs = []
    for ops, fields, s in jobs:
        form, K, rows = ops[0].form, ops[0].K, ops[0].rows
        sums = {}
        for op, f in zip(ops, fields):
            B = _unpack(op)
            V = _columns(f.astype(np.float32), axis)
            for h in ((0, 1) if form == xm.INV else (0,)):
                for kc in range(-(-K // xm.KC)):
                    k = kc * xm.KC + np.arange(xm.KC)
                    ok = (k < K)[None, :, None]
                    kk = np.where(k < K, k, 0)
                    if form == xm.FWD:
                        f1, f2 = V[:, kk], V[:, kk + K]
                        srcs = {0: f1 + f2, 1: f1 - f2}
                    else:
                        srcs = {h: V[:, kk + h * K]}
                    for part, A in srcs.items():
                        A = np.where(ok, A, np.float32(0)).transpose(0, 2, 1)
                        ah, al = xm.split_tf32(A)
                        ah, al = ah.reshape(A.shape), al.reshape(A.shape)
                        bh = B[part, 0, :, kc * xm.KC:(kc + 1) * xm.KC].T
                        bl = B[part, 1, :, kc * xm.KC:(kc + 1) * xm.KC].T
                        p = (al @ bh + ah @ bl) + ah @ bh
                        sums[part] = p if part not in sums else sums[part] + p
        if form == xm.INV:
            halves = (sums[0] + sums[1], sums[0] - sums[1])
        else:
            halves = (sums[0], sums[1])
        r = np.concatenate([x[..., :rows] for x in halves], axis=-1)
        # (planes, columns, n_out) back to the field's layout
        shape = list(fields[0].shape)
        shape[axis] = 2 * rows
        r = (r.transpose(0, 2, 1) if axis == 1 else r.reshape(shape))
        r = r.reshape(shape)
        outs.append(r if s is None else s.astype(np.float32) - r)
    return outs


def _model_stages(pm, u, v, w, X, Y):
    """Stages A and C as the kernel's four launches, in the float32 model,
    on the operators the card packs (pressure_pipe.tc_ops)."""
    op = pp.tc_ops(pm, "cpu")
    z1, z2, z3 = _launch_model(2, [([op["iz"]], [u], None),
                                   ([op["iz"]], [v], None),
                                   ([op["sz"]], [w], None)])
    a, e = _launch_model(1, [([op["tyI"]], [z1], None),
                             ([op["tyS"], op["tyI"]], [z2, z3], None)])
    px, dzy, pzy = _launch_model(2, [([op["gzi"]], [X], None),
                                     ([op["gzs"]], [Y], None),
                                     ([op["gzi"]], [Y], None)])
    c = _launch_model(1, [([op["giT"]], [px], u), ([op["gsT"]], [pzy], v),
                          ([op["giT"]], [dzy], w)])
    return (a, e), tuple(c)


@pytest.mark.parametrize("dims", [CUBE, PY_CUT, Z_HALF],
                         ids=["128", "py-cut", "z-half-72"])
def test_launch_model_vs_float64(dims):
    pm = _pm(dims)
    m = pm.mats(torch.float64)
    f = _fields(dims, 5, 2)
    (a, e), c = _model_stages(pm, *(x.astype(np.float32) for x in f))
    t = [torch.from_numpy(x.astype(np.float32).astype(np.float64))
         for x in f]
    want_ae = pp.pipe_a_plain(*t[:3], m)
    want_c = pp.pipe_c_plain(t[3], t[4], *t[:3], m)
    errs = [_rel(g, x.numpy()) for g, x in zip((a, e) + c,
                                                want_ae + want_c)]
    print(dims, " ".join(f"{x:.2e}" for x in errs))
    assert max(errs) <= TC_LIM


@pytest.fixture(scope="module")
def jax_pipe():
    jns = JNavierStokes.build(JMesh(CUBE, L, JPER), NU, dtype=jnp.float32)
    return make_pressure_pipe3(jns, terms=3, interpret=True)


@pytest.mark.parametrize("stage", ["a", "c"])
def test_launch_model_vs_x3d2_tpu_pipe3(jax_pipe, stage):
    pm = _pm(CUBE, torch.float32)
    f = _fields(CUBE, 5, 3, np.float32)
    ae, c = _model_stages(pm, *f)
    if stage == "a":
        got, want = ae, jax_pipe.a_fn(*(jnp.asarray(x) for x in f[:3]))
    else:
        got, want = c, jax_pipe.c_fn(*(jnp.asarray(x) for x in f[3:] + f[:3]))
    assert len(got) == len(want)
    for g, e in zip(got, want):
        e = np.asarray(e)
        assert np.abs(g - e).max() < 3e-6 * np.abs(e).max()


# -- (d) the launch geometry -------------------------------------------------

def _record(pm, dims):
    """The geometry of stages A and C's launches over pm on fields of
    `dims`, recorded instead of launched."""
    seen = []
    real = (xm._launch, xm._check, xm._sm_count)
    xm._launch = lambda stage, geo, dev, ptrs: seen.append((stage, geo))
    xm._check = lambda t, name, dev: None
    xm._sm_count = lambda dev: 132
    try:
        u = torch.empty(dims)
        pp._pipe_a_cuda(u, u, u, pm)
        pp._pipe_c_cuda(u, u, u, u, u, pm)
    finally:
        xm._launch, xm._check, xm._sm_count = real
    return seen


def _walk(geo, n_out):
    """Each output element's writes by a walk of the launch's items:
    (njobs, nplanes, n_out, ncols) counts."""
    hits = np.zeros((geo.njobs, geo.nplanes, n_out, geo.ncols), np.int32)
    rows = xm.out_rows(geo)
    cols = xm.a_columns(geo.lines)            # (256, 2): a quad's columns
    for it in range(geo.nitems):
        job, plane, ct, rt = xm.item_of(geo, it)
        c = ct * xm.BM + np.unique(cols)
        c = c[c < geo.ncols]
        r = rows[:, rt].ravel()
        r = r[r >= 0]
        hits[job, plane][np.ix_(r, c)] += 1
    return hits


@pytest.mark.parametrize("dims", [(8, 192, 144), (8, 128, 384)],
                         ids=["8x192x144", "8x128x384"])
def test_launch_walk_writes_each_output_once(dims):
    pm = _pm(dims)
    seen = _record(pm, dims)
    assert [(s, g.lines, g.njobs, g.form) for s, g in seen] == [
        ("pipe_a", True, 3, xm.FWD), ("pipe_a", False, 2, xm.FWD),
        ("pipe_c", True, 3, xm.INV), ("pipe_c", False, 3, xm.INV)]
    for _, geo in seen:
        n = dims[2] if geo.lines else dims[1]
        assert (geo.rows, geo.K) == (n // 2, n // 2)
        assert (geo.ncols, geo.nplanes) == ((dims[0] * dims[1], 1)
                                            if geo.lines
                                            else (dims[2], dims[0]))
        hits = _walk(geo, n)
        assert hits.min() == 1 and hits.max() == 1


@pytest.mark.parametrize("dims", [(512,) * 3, (320, 256, 384),
                                  (384, 192, 384), CUBE, (128, 128, 144)],
                         ids=["512", "px", "py", "128", "z-half-72"])
def test_launch_geometry_at_the_paths_sizes(dims):
    """The items are every (job, plane, column tile, row tile) once, the
    row tiles' rows every output row once and a quad's columns every
    column of a tile once; each launch's shared memory fits."""
    pm = _pm(dims, torch.float32)
    seen = _record(pm, dims)
    assert len(seen) == 4
    for stage, geo in seen:
        job, plane, ct, rt = xm.item_of(geo, np.arange(geo.nitems))
        keys = ((job * geo.nplanes + plane) * geo.ctiles + ct) \
            * geo.rtiles + rt
        np.testing.assert_array_equal(np.sort(keys), np.arange(geo.nitems))
        n = dims[2] if geo.lines else dims[1]
        rows = xm.out_rows(geo)
        np.testing.assert_array_equal(np.sort(rows[rows >= 0]),
                                      np.arange(n))
        np.testing.assert_array_equal(
            np.bincount(xm.a_columns(geo.lines).ravel(), minlength=xm.BM),
            np.full(xm.BM, 4))
        assert geo.ctiles * xm.BM >= geo.ncols > (geo.ctiles - 1) * xm.BM
        assert geo.smem <= xm.SMEM_MAX and geo.grid == min(132, geo.nitems)
        assert geo.ktiles == -(-(n // 2) // xm.KC)


def test_launch_jobs_refusals():
    fwd = xm.pack(np.ones((16, 8)), xm.FWD)
    inv = xm.pack(np.ones((16, 8)), xm.INV)
    f = torch.zeros((4, 8, 16))
    with pytest.raises(TypeError, match="packed"):
        xm.launch_jobs("x", 2, [([np.ones((16, 8))], [f], None, None)])
    with pytest.raises(ValueError, match="inverse-stage"):
        xm.launch_jobs("x", 2, [([fwd], [f], None, f)])
    with pytest.raises(ValueError, match="1 to 3 jobs"):
        xm.launch_jobs("x", 2, [([fwd], [f], None, None)] * 4)
    with pytest.raises(ValueError, match="1 to 3 jobs"):
        xm.launch_jobs("x", 2, [([fwd] * 3, [f] * 3, None, None)])
    with pytest.raises(ValueError, match="one form and size"):
        xm.launch_jobs("x", 2, [([fwd], [f], None, None),
                                ([inv], [f], None, None)])
    with pytest.raises(ValueError, match="all jobs"):
        xm.launch_jobs("x", 2, [([inv], [f], None, None),
                                ([inv], [f], None, torch.zeros(4, 8, 16))])
    with pytest.raises(ValueError, match="does not fit"):
        xm.launch_jobs("x", 1, [([fwd], [f], None, None)])
    out = torch.zeros((4, 8, 16))
    with pytest.raises(ValueError, match="alias"):
        xm.launch_jobs("x", 2, [([fwd], [f], out, None),
                                ([fwd], [torch.zeros(4, 8, 16)], out, None)])
    with pytest.raises(ValueError, match="CUDA tensors"):
        xm.launch_jobs("x", 2, [([fwd], [f], None, None)])
    with pytest.raises(ValueError, match="z layout"):
        xm.geometry(xm.DENSE, 16, 16, 64, 132, lines=True)
    with pytest.raises(ValueError, match="z layout"):
        xm.geometry(xm.FWD, 14, 7, 64, 132, lines=True)
    with pytest.raises(ValueError, match="planes"):
        xm.geometry(xm.FWD, 16, 8, 64, 132, nplanes=2, lines=True)
    with pytest.raises(ValueError, match="z layout"):
        xm.launch_jobs("x", 2, [([inv], [f], None, torch.zeros(4, 8, 16))])
    with pytest.raises(ValueError, match="z layout"):
        xm.geometry(xm.INV, 16, 8, 64, 132, lines=True, sub=True)
    with pytest.raises(ValueError, match="inverse-stage"):
        xm.geometry(xm.FWD, 16, 8, 64, 132, sub=True)
    assert xm.launch_counts() == {}


# -- (e) CPU tensors -----------------------------------------------------------

def test_cpu_takes_the_plain_version():
    ns = NavierStokes.build(Mesh(CUBE, L, PER), NU, dtype=torch.float32,
                            device="cpu")
    pm = ns._pipe.mats
    u, v, w, X, Y = (torch.from_numpy(a) for a in
                     _fields(CUBE, 5, 4, np.float32))
    xm.reset_launch_counts()
    oa.reset_launch_counts()
    m = pm.mats(torch.float32)
    got_a = pp.pipe_a(u, v, w, pm)
    got_c = pp.pipe_c(X, Y, u, v, w, pm)
    for g, e in zip(got_a + got_c, pp.pipe_a_plain(u, v, w, m)
                    + pp.pipe_c_plain(X, Y, u, v, w, m)):
        assert torch.equal(g, e)
    assert xm.launch_counts() == {} and oa.launch_counts() == {}
    assert not any(isinstance(k, tuple) for k in pm._fold)
    assert pm._packed == {}
    assert oa.LAUNCHES_PER_CALL["pipe_a"] == oa.LAUNCHES_PER_CALL["pipe_c"] \
        == 2
    assert math.isfinite(float(got_a[0].abs().max()))
