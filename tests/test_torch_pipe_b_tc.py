"""The pipeline's stage B on the split-TF32 tensor-core kernel
(csrc/x_apply_manual.cu: an x FWD launch of one two-source job with the
solve in its epilogue, then an x INV launch of two jobs,
ops/pressure_pipe.py pipe_b_x, pipe_b_inv), on the CPU: a model of the
kernel's arithmetic against float64 and x3d2_tpu, the launch geometry,
the refusals, and the CPU route.

- (a) A float32 model of the two launches (each k chunk's, INV each k
  step's, three products of the split operands from the packed
  operators' blocks, added to the
  sums in float32, the job's two sources in one chain; the solve,
  x_apply_manual.solve_model, on the FWD launch's sums) against plain
  float64 pipe_b_plain at 128^3, at a PX cut (x = 320: halves of 160, a
  part-filled row tile; y and z cut to 64 x 32, since the stage acts
  along x alone) and at an x of 144 (halves of 72: a part-filled k chunk
  and row tile). The limit is the larger of 4e-7 (the kernel's limit on
  the card) and twice plain float32's own distance to float64 on these
  inputs: the solve divides by k^2, so on white noise the float32
  rounding of every mode lands on the k = 1 modes that carry max |X| and
  max |Y|, for the plain version and the kernel alike. x_apply_manual's
  tc_model (whole-K products, the sources summed, the solve) is held to
  the same limit.
- (b) The same model against x3d2_tpu's make_pressure_pipe3(terms=3).b_fn
  in interpret mode at 128^3, within 3e-6 * scale (stages A and C's
  bound, test_torch_pipe_tc.py).
- (c) The launch geometry: stage B records ("pipe_b", x layout, 1 job,
  FWD with the solve) and ("pipe_b", x layout, 2 jobs, INV); a walk of the
  items writes every output element once at small grids, and the items'
  structure holds at 512^3, PX, PY and 128^3.
- (d) launch_jobs' and geometry's refusals of the solve; the template
  refuses the x solve it no longer has.
- (e) CPU tensors take the plain version, count no launch and pack
  nothing.
"""

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
from x3d2_tpu_torch.solver import NavierStokes

from test_torch_pipe_tc import _fields, _pm, _rel, _unpack, _walk

torch.set_num_threads(1)
threadpool_limits(1, user_api="blas")

L = (2 * np.pi,) * 3
NU = 1 / 1600
PER = ((BC.PERIODIC, BC.PERIODIC),) * 3
JPER = ((JBC.PERIODIC, JBC.PERIODIC),) * 3
CUBE = (128, 128, 128)
PX_CUT = (320, 64, 32)
X_HALF = (144, 64, 32)
TC_LIM = 4e-7           # the split-TF32 kernel's limit against float64


# -- (a) the kernel's arithmetic ---------------------------------------------

def _x_launch(jobs, solve=None):
    """One x launch of the kernel in float32 over packed operators: per
    job (ops, fields), its sources' k chunks in order (INV: a source's a
    chunks, then its b chunks), each chunk's P = (A_lo B_hi + A_hi B_lo) +
    A_hi B_hi of the split field chunk (k past K masked; FWD s = f1 + f2
    and d = f1 - f2 in float32; INV the P of each k step of 8 summed) and
    the operator's split block, added to the sums in float32; with solve
    (the four tables) the FWD sums times their modes' -1 / waves. Returns
    the outputs, (n_out, ny, nz)."""
    outs = []
    for ops, fields in jobs:
        form, K, rows = ops[0].form, ops[0].K, ops[0].rows
        sums = {}
        for op, f in zip(ops, fields):
            B = _unpack(op)
            V = np.asarray(f, np.float32).reshape(f.shape[0], -1)
            for h in ((0, 1) if form == xm.INV else (0,)):
                for kc in range(-(-K // xm.KC)):
                    k = kc * xm.KC + np.arange(xm.KC)
                    ok = (k < K)[:, None]
                    kk = np.where(k < K, k, 0)
                    if form == xm.FWD:
                        srcs = {0: V[kk] + V[kk + K], 1: V[kk] - V[kk + K]}
                    else:
                        srcs = {h: V[kk + h * K]}
                    blk = slice(kc * xm.KC, (kc + 1) * xm.KC)
                    for part, A in srcs.items():
                        ah, al = xm.split_tf32(
                            np.where(ok, A, np.float32(0)).T)
                        bh, bl = B[part, 0, :, blk].T, B[part, 1, :, blk].T
                        steps = ((slice(0, 8), slice(8, 16))
                                 if form == xm.INV else (slice(0, 16),))
                        p = sum((al[:, t] @ bh[t] + ah[:, t] @ bl[t])
                                + ah[:, t] @ bh[t] for t in steps)
                        sums[part] = p if part not in sums else sums[part] + p
        halves = ((sums[0] + sums[1], sums[0] - sums[1])
                  if form == xm.INV else (sums[0], sums[1]))
        r = np.concatenate([x[:, :rows] for x in halves], axis=1).T
        if solve is not None:
            r = xm.solve_model(r, *solve)
        outs.append(r.reshape((2 * rows,) + tuple(fields[0].shape[1:])))
    return outs


def _tables(pm):
    return [t.numpy() for t in pp.solve_tables(pm)]


def _model_b(pm, a, e):
    """Stage B as the kernel's two launches, in the float32 model, on the
    operators and tables the card takes (pressure_pipe.tc_ops,
    solve_tables): (X, Y)."""
    op = pp.tc_ops(pm, "cpu")
    q, = _x_launch([([op["sx"], op["ix"]], [a, e])], _tables(pm))
    return tuple(_x_launch([([op["gxs"]], [q]), ([op["gxi"]], [q])]))


def _tc_model_b(pm, a, e):
    """Stage B through x_apply_manual.tc_model: the FWD job of two
    sources with the solve, then the two INV applies."""
    m = pm.mats(torch.float32)
    sx, ix, gxs, gxi = (m[k].numpy() for k in ("sx", "ix", "gxs", "gxi"))
    q = xm.tc_model([sx, ix], [a, e], parity="fwd", solve=_tables(pm))
    return (xm.tc_model(gxs, q, parity="inv"),
            xm.tc_model(gxi, q, parity="inv"))


@pytest.mark.parametrize("dims", [CUBE, PX_CUT, X_HALF],
                         ids=["128", "px-cut", "x-half-72"])
def test_launch_model_vs_float64(dims):
    pm = _pm(dims)
    a, e = _fields(dims, 2, 5, np.float32)
    want = pp.pipe_b_plain(*(torch.from_numpy(x.astype(np.float64))
                             for x in (a, e)), pm.mats(torch.float64))
    p32 = pp.pipe_b_plain(torch.from_numpy(a), torch.from_numpy(e),
                          pm.mats(torch.float32))
    own = max(_rel(p.numpy(), w.numpy()) for p, w in zip(p32, want))
    lim = max(TC_LIM, 2 * own)
    errs = [_rel(g, w.numpy()) for g, w in zip(_model_b(pm, a, e), want)]
    tc = [_rel(g, w.numpy()) for g, w in zip(_tc_model_b(pm, a, e), want)]
    print(dims, f"plain32 {own:.2e} model {max(errs):.2e} tc_model "
                f"{max(tc):.2e} limit {lim:.2e}")
    assert max(errs) <= lim and max(tc) <= lim


@pytest.fixture(scope="module")
def jax_pipe():
    jns = JNavierStokes.build(JMesh(CUBE, L, JPER), NU, dtype=jnp.float32)
    return make_pressure_pipe3(jns, terms=3, interpret=True)


def test_launch_model_vs_x3d2_tpu_pipe3(jax_pipe):
    pm = _pm(CUBE, torch.float32)
    a, e = _fields(CUBE, 2, 6, np.float32)
    got = _model_b(pm, a, e)
    want = jax_pipe.b_fn(jnp.asarray(a), jnp.asarray(e))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(g - w).max() < 3e-6 * np.abs(w).max()


# -- (c) the launch geometry -------------------------------------------------

def _record(pm, dims):
    """The geometry of stage B's launches over pm on fields of `dims`,
    recorded instead of launched."""
    seen = []
    real = (xm._launch, xm._check, xm._sm_count)
    xm._launch = lambda stage, geo, dev, ptrs: seen.append((stage, geo,
                                                            len(ptrs)))
    xm._check = lambda t, name, dev: None
    xm._sm_count = lambda dev: 132
    try:
        u = torch.empty(dims)
        pp._pipe_b_cuda(u, u, pm)
    finally:
        xm._launch, xm._check, xm._sm_count = real
    return seen


@pytest.mark.parametrize("dims", [(144, 64, 16), (32, 64, 16)],
                         ids=["144x64x16", "32x64x16"])
def test_launch_walk_writes_each_output_once(dims):
    pm = _pm(dims)
    seen = _record(pm, dims)
    # the jobs' pointers (2 MAX_SRC + 2 a job), and the FWD launch's four
    # tables after them
    assert [(s, g.lines, g.njobs, g.form, g.solve, n) for s, g, n in seen] \
        == [("pipe_b", False, 1, xm.FWD, True, 6 + 4),
            ("pipe_b", False, 2, xm.INV, False, 12)]
    for _, geo, _ in seen:
        assert (geo.rows, geo.K) == (dims[0] // 2, dims[0] // 2)
        assert (geo.ncols, geo.nplanes) == (dims[1] * dims[2], 1)
        hits = _walk(geo, dims[0])
        assert hits.min() == 1 and hits.max() == 1


@pytest.mark.parametrize("dims", [(512,) * 3, (320, 256, 384),
                                  (384, 192, 384), CUBE],
                         ids=["512", "px", "py", "128"])
def test_launch_geometry_at_the_paths_sizes(dims):
    """The items are every (job, column tile, row tile) once, the row
    tiles' rows every x mode once and a quad's columns every column of a
    tile once; each launch's shared memory fits."""
    pm = _pm(dims, torch.float32)
    seen = _record(pm, dims)
    assert [(g.form, g.njobs, g.solve) for _, g, _ in seen] == [
        (xm.FWD, 1, True), (xm.INV, 2, False)]
    for _, geo, _ in seen:
        job, plane, ct, rt = xm.item_of(geo, np.arange(geo.nitems))
        keys = (job * geo.ctiles + ct) * geo.rtiles + rt
        np.testing.assert_array_equal(np.sort(keys), np.arange(geo.nitems))
        assert not plane.any()
        rows = xm.out_rows(geo)
        np.testing.assert_array_equal(np.sort(rows[rows >= 0]),
                                      np.arange(dims[0]))
        np.testing.assert_array_equal(
            np.bincount(xm.a_columns(False).ravel(), minlength=xm.BM),
            np.full(xm.BM, 4))
        assert geo.ctiles == math.ceil(dims[1] * dims[2] / xm.BM)
        assert geo.smem <= xm.SMEM_MAX and geo.grid == min(132, geo.nitems)
        assert geo.ktiles == -(-(dims[0] // 2) // xm.KC)


# -- (d) the refusals ----------------------------------------------------------

def test_solve_refusals():
    nx, ny, nz = 16, 4, 8
    fwd = xm.pack(np.ones((nx, nx // 2)), xm.FWD)
    inv = xm.pack(np.ones((nx, nx // 2)), xm.INV)
    dense = xm.pack(np.ones((nx, nx)), xm.DENSE)
    f = torch.zeros((nx, ny, nz))
    tabs = (torch.ones(ny * nz), torch.ones(ny * nz), torch.ones(nx),
            torch.ones(nx))

    def go(op, axis=0, field=f, s=None, solve=tabs):
        xm.launch_jobs("x", axis, [([op], [field], None, s)], solve=solve)

    for op in (inv, dense):
        with pytest.raises(ValueError, match="FWD form along x"):
            go(op)
    # FWD along y and z, on fields that fit those axes
    with pytest.raises(ValueError, match="FWD form along x"):
        go(fwd, 1, torch.zeros((ny, nx, nz)))
    with pytest.raises(ValueError, match="FWD form along x"):
        go(fwd, 2, torch.zeros((ny, nz, nx)))
    with pytest.raises(ValueError, match="inverse-stage"):
        go(fwd, s=torch.zeros((nx, ny, nz)))
    with pytest.raises(ValueError, match="four tables"):
        go(fwd, solve=tabs[:3])
    for i, n in ((0, ny * nz + 1), (1, ny * nz - 4), (2, nx - 1),
                 (3, ny * nz)):
        bad = list(tabs)
        bad[i] = torch.ones(n)
        with pytest.raises(ValueError, match="vector of"):
            go(fwd, solve=bad)
    bad = list(tabs)
    bad[1] = torch.ones((ny, nz))
    with pytest.raises(ValueError, match="vector of"):
        go(fwd, solve=bad)
    bad[1] = np.ones(ny * nz, np.float32)
    with pytest.raises(ValueError, match="vector of"):
        go(fwd, solve=bad)
    bad[1] = torch.ones(ny * nz, dtype=torch.float64)
    with pytest.raises(ValueError, match="float32"):
        go(fwd, solve=bad)
    bad[1] = torch.ones(ny * nz, device="meta")
    with pytest.raises(ValueError, match="float32 on"):
        go(fwd, solve=bad)
    # right tables, fields on the CPU: the kernel runs on CUDA tensors
    with pytest.raises(ValueError, match="CUDA tensors"):
        go(fwd)
    with pytest.raises(ValueError, match="FWD form along x"):
        xm.geometry(xm.INV, 16, 8, 64, 132, solve=True)
    with pytest.raises(ValueError, match="FWD form along x"):
        xm.geometry(xm.FWD, 16, 8, 64, 132, lines=True, solve=True)
    with pytest.raises(ValueError, match="FWD form along x"):
        xm.geometry(xm.FWD, 16, 8, 64, 132, nplanes=2, solve=True)
    with pytest.raises(ValueError, match="inverse-stage"):
        xm.geometry(xm.FWD, 16, 8, 64, 132, sub=True, solve=True)
    with pytest.raises(ValueError, match="the solve follows"):
        xm.tc_model(np.ones((nx, nx // 2)), np.ones((nx, ny, nz)),
                    parity="inv", solve=[t.numpy() for t in tabs])
    # the template no longer takes the solve after an x apply
    with pytest.raises(ValueError, match="not a form of the template"):
        oa.geometry(oa.PFWD, 0, (nx, ny, nz), nx, nx // 2, oa.SOLVE, True)
    assert xm.geometry(xm.FWD, 16, 8, 64, 132, solve=True).solve
    assert xm.launch_counts() == {}


def test_pipe_b_refuses_a_nyquist_mask():
    pm = _pm((16, 64, 16), torch.float32)
    pm.mats(torch.float32)["myz"] = torch.zeros(64 * 16)
    with pytest.raises(ValueError, match="Nyquist"):
        pp.solve_tables(pm)


# -- (e) CPU tensors -----------------------------------------------------------

def test_cpu_takes_the_plain_version():
    ns = NavierStokes.build(Mesh(CUBE, L, PER), NU, dtype=torch.float32,
                            device="cpu")
    pm = ns._pipe.mats
    a, e = (torch.from_numpy(x) for x in _fields(CUBE, 2, 7, np.float32))
    xm.reset_launch_counts()
    oa.reset_launch_counts()
    got = pp.pipe_b(a, e, pm)
    want = pp.pipe_b_plain(a, e, pm.mats(torch.float32))
    assert len(got) == 2
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert xm.launch_counts() == {} and oa.launch_counts() == {}
    assert not any(isinstance(k, tuple) for k in pm._fold)
    assert pm._packed == {}
    assert oa.LAUNCHES_PER_CALL["pipe_b"] == 2
    assert math.isfinite(float(got[0].abs().max()))
