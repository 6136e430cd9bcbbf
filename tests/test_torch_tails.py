"""The port's kernel projections at the extents x3d2_tpu's gates admit past
the template's 128-point tiles, on the CPU (the pipeline, the projection in
float64 and whole steps: test_torch_tails_steps.py).

- The routes: on the grids whose x or y is not a multiple of 128 (or whose
  periodic y is not a multiple of 64) the port builds the transport and
  projection branches x3d2_tpu's gates choose, the slab's y form (banded y
  with the parity transforms, or the transform-folded dense y) and x stage
  as x3d2_tpu's slab takes them, and records no projection gap.
- The launch geometry (operator_apply.geometry) of every launch the
  wrappers make at those extents: the 128-tiled instance where it tiles the
  launch, the general one elsewhere, and each output row written once; the
  pipeline's stages A and C, a z and a y launch each of the tensor-core
  kernel (x_apply_manual.geometry), each output element written once.
- The slab in float32 vs x3d2_tpu's make_pressure_slab(terms=3) in
  interpret mode, 2e-4 * scale (the bound of tests/test_pallas_poisson.py),
  where each function meets a tail: x_div3 and x_gradsub3 at an x tail
  (144 x 128 x 128), the mid with and without q at a banded y tail (16 x
  192 x 128), the mid and its halves div_solve and grad on the folded y
  (16 x 136 x 128); x is cut to 16 where the tail is along y, since
  x3d2_tpu's interpret mode is the cost.
- A y operator that fails the band check (made to fail by a zero
  truncation tolerance on both sides, at 16 x 192 x 128): x3d2_tpu's slab
  takes the folded y there and its pipeline refuses the grid; so does the
  port, and its projection on that y in float64 matches x3d2_tpu's operator
  path to 1e-10 * scale.
- The slab built directly on a wall-bounded y (16 x 129 x 128, which no
  gate of x3d2_tpu reaches): the mid vs x3d2_tpu's make_pressure_slab in
  interpret mode (it builds there), and in float64 vs the port's own
  folded chain, 1e-10 * scale.
"""

import math

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax.numpy as jnp

from x3d2_tpu.common import BC as JBC
from x3d2_tpu.mesh import Mesh as JMesh
from x3d2_tpu.ops import pallas_poisson
from x3d2_tpu.ops.pallas_kernels import transeq_v3_supported
from x3d2_tpu.ops.pallas_poisson import (make_pressure_pipe3,
                                         make_pressure_slab,
                                         slab_pressure_supported)
from x3d2_tpu.ops.pallas_poisson import pipe3_supported as j_pipe3
from x3d2_tpu.ops.pallas_transeq import fused_transeq_supported
from x3d2_tpu.solver import NavierStokes as JNavierStokes

from x3d2_tpu_torch.common import BC
from x3d2_tpu_torch.mesh import Mesh
from x3d2_tpu_torch.ops import operator_apply as oa
from x3d2_tpu_torch.ops import parity
from x3d2_tpu_torch.ops import pressure_pipe as pp
from x3d2_tpu_torch.ops import pressure_slab as sl
from x3d2_tpu_torch.ops import x_apply_manual as xm
from x3d2_tpu_torch.ops.parity import build_projection_mats
from x3d2_tpu_torch.solver import NavierStokes, projection_route

# one thread for torch and for numpy's BLAS, as the other port tests
torch.set_num_threads(1)
threadpool_limits(1, user_api="blas")

L = (2 * np.pi,) * 3
NU = 1 / 1600
PER = ((BC.PERIODIC, BC.PERIODIC),) * 3
JPER = ((JBC.PERIODIC, JBC.PERIODIC),) * 3
WALL_Y = ((BC.PERIODIC, BC.PERIODIC), (BC.DIRICHLET, BC.DIRICHLET),
          (BC.PERIODIC, BC.PERIODIC))
JWALL_Y = ((JBC.PERIODIC, JBC.PERIODIC), (JBC.DIRICHLET, JBC.DIRICHLET),
           (JBC.PERIODIC, JBC.PERIODIC))
X_TAIL, Y_TAIL, Y_FOLD = (144, 128, 128), (128, 192, 128), (128, 136, 128)
# the y tails of the interpret-mode comparisons, x cut to 16 (x3d2_tpu's
# interpret mode is their cost; the tail is along y)
Y_TAIL_S, Y_FOLD_S = (16, 192, 128), (16, 136, 128)
WALL_DIMS = (16, 129, 128)

# the grids of the tails: (projection, slab y form); the transport and the
# rest are x3d2_tpu's, read off its gates
ROUTES = {(320, 256, 384): ("pipe3", "parity"),
          (384, 192, 384): ("pipe3", "parity"),
          (256, 200, 256): ("slab", "folded"),
          (192, 128, 128): ("pipe3", "parity"),
          (144, 192, 128): ("pipe3", "parity"),
          (128, 136, 128): ("slab", "folded")}


def _port(shape, dtype=torch.float32, bcs=PER):
    return NavierStokes.build(Mesh(shape, L, bcs), NU, dtype=dtype,
                              device="cpu")


def _jax(shape, dtype=jnp.float32, bcs=JPER):
    return JNavierStokes.build(JMesh(shape, L, bcs), NU, dtype=dtype)


def _fields(shape, n, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(dtype) for _ in range(n)]


def _close(got, want, tol):
    got = [g for g in got if g is not None]
    assert len(got) == len(want)
    for g, e in zip(got, want):
        e = np.asarray(e)
        assert g.shape == e.shape
        err = np.abs(g.numpy() - e).max()
        assert err < tol * np.abs(e).max(), f"{err:.2e}"


@pytest.mark.parametrize("dims", list(ROUTES), ids=lambda d: "x".join(
    map(str, d)))
def test_routes_match_x3d2_tpu(dims):
    ns, jns = _port(dims), _jax(dims)
    want_t = ("sweeps" if transeq_v3_supported(jns, dims)
              else "v1" if fused_transeq_supported(jns, dims) else "dense")
    assert slab_pressure_supported(jns)
    want_p = "pipe3" if j_pipe3(jns) else "slab"
    jslab = make_pressure_slab(jns, terms=3, interpret=True)[3]
    assert (ns._transport, projection_route(ns)) == (want_t, want_p)
    assert ns._projection_gap is None and ns.transport_gap() is None
    assert (want_p, ns._slab.forms.y) == ROUTES[dims]
    assert (ns._pipe is not None) == (want_p == "pipe3")
    for got, want in ((ns._slab.x_perm, jslab.x_perm),
                      (ns._slab.q_perm, jslab.q_perm),
                      (ns._slab.z_perm, jslab.z_perm)):
        assert (got is None) == (want is None)
        if want is not None:
            np.testing.assert_array_equal(got, want)


def _launches(pm, pipe):
    """The geometry of every launch the kernel wrappers make over pm: the
    slab's functions (the mid also over a local x batch) and the
    pipeline's stages, recorded instead of launched: the template's
    (operator_apply.Geometry) and the tensor-core kernel's (stages A and
    C: x_apply_manual.Geometry)."""
    seen = []

    def record(stage, geo, epi, dev, ptrs, nsrc, tabs):
        seen.append((stage, geo))

    def record_tc(stage, geo, dev, ptrs):
        seen.append((stage, geo))

    real = (oa._launch, oa._check, xm._launch, xm._check, xm._sm_count)
    oa._launch = record
    oa._check = lambda t, shape, name: None
    xm._launch = record_tc
    xm._check = lambda t, name, dev: None
    xm._sm_count = lambda dev: 132
    try:
        m = pm.mats(torch.float32)
        u = torch.zeros(pm.vert)
        if pm.x_perm is not None:
            sl._x_div3_cuda(u, u, u, m)
            sl._x_gradsub3_cuda(u, u, u, u, u, u, m)
        sl._pressure_mid_cuda(u, u, u, pm, True)
        # the local mid over a batch of a quarter of the x planes (the
        # sharded projection's), with its table slices
        b = u[:u.shape[0] // 4]
        sl._pressure_mid_cuda(b, b, b, pm, True,
                              sl.local_tables(m, 0, b.shape[0]),
                              sl.stage_name("pressure_mid", pm, True,
                                            local=True))
        if pipe:
            pp._pipe_a_cuda(u, u, u, pm)
            pp._pipe_b_cuda(u, u, pm)
            pp._pipe_c_cuda(u, u, u, u, u, pm)
    finally:
        (oa._launch, oa._check, xm._launch, xm._check, xm._sm_count) = real
    return seen


def _tc_writes_once(geo):
    """The tensor-core kernel's items (x_apply_manual.item_of) are every
    (job, plane, column tile, row tile) once, the row tiles' rows
    (out_rows) every output row once, and the consumers' columns
    (a_columns) every column of a tile once a quad: so every output element
    is written once."""
    job, plane, ct, rt = xm.item_of(geo, np.arange(geo.nitems))
    keys = ((job * geo.nplanes + plane) * geo.ctiles + ct) * geo.rtiles + rt
    np.testing.assert_array_equal(np.sort(keys), np.arange(geo.nitems))
    assert job.max() == geo.njobs - 1
    rows = xm.out_rows(geo)
    written = np.sort(rows[rows >= 0])
    n_out = geo.rows * (1 if geo.form == xm.DENSE else 2)
    np.testing.assert_array_equal(written, np.arange(n_out))
    # each column held by the 4 threads of a quad (their tile rows 2 tig,
    # 2 tig + 1 of each 8)
    np.testing.assert_array_equal(
        np.bincount(xm.a_columns(geo.lines).ravel(), minlength=xm.BM),
        np.full(xm.BM, 4))
    assert geo.ctiles == math.ceil(geo.ncols / xm.BM)


@pytest.mark.parametrize("dims,bcs", [((512,) * 3, PER), (X_TAIL, PER),
                                      (Y_TAIL, PER), (Y_FOLD, PER),
                                      (WALL_DIMS, WALL_Y)],
                         ids=["512", "x-tail", "y-tail", "y-folded",
                              "wall-y"])
def test_launch_geometry(dims, bcs):
    """Every launch's tiles cover its output rows once, the column tiles
    its columns; the 128-tiled instance takes exactly the launches whose
    extents it tiles (at 512^3 all of them)."""
    ns = _port(dims, bcs=bcs)
    pm = ns._slab or build_projection_mats(ns)
    seen = _launches(pm, ns._pipe is not None)
    assert seen
    tc = [(stage, geo) for stage, geo in seen
          if isinstance(geo, xm.Geometry)]
    # stages A and C: a z launch and a y launch each; stage B two x
    # launches
    assert [(s, g.lines, g.njobs) for s, g in tc] == (
        [("pipe_a", True, 3), ("pipe_a", False, 2), ("pipe_b", False, 1),
         ("pipe_b", False, 2), ("pipe_c", True, 3),
         ("pipe_c", False, 3)] if ns._pipe is not None else [])
    for stage, geo in tc:
        _tc_writes_once(geo)
    for stage, geo in seen:
        if isinstance(geo, xm.Geometry):
            continue
        rows = oa.out_rows(geo)
        assert rows.shape == (geo.mtiles, 2, oa.BBS)
        written = np.sort(rows[rows >= 0])
        np.testing.assert_array_equal(written, np.arange(geo.nout))
        assert geo.ntiles == math.ceil(geo.ncols / oa.TILE)
        n = geo.shape[geo.axis]
        tiled = geo.ncols % oa.TILE == 0 and (
            (geo.mode == oa.BANDED and n % oa.TILE == 0)
            or (geo.mode == oa.PFWD and n % oa.TILE == 0)
            or (geo.mode == oa.PINV and (n // 2) % oa.BBS == 0)
            or (geo.mode == oa.DENSE and not geo.trans
                and (geo.nout == geo.K or geo.batch == 1))
            or (geo.mode == oa.DENSE and geo.trans and geo.nout == geo.K
                and geo.K % oa.TILE == 0))
        if geo.tail:
            # the general instance: the launches the tiled one cannot
            # take, and the forms it lacks (the folded y's two-source dense
            # y stage, the solve after the z apply, rectangular dense y)
            assert not tiled or "folded_y" in stage
        else:
            assert tiled
        if dims == (512,) * 3:
            assert not geo.tail
    assert any(g.tail for _, g in seen if not isinstance(g, xm.Geometry)) \
        == (dims != (512,) * 3)


@pytest.fixture(scope="module")
def jslabs():
    return {dims: make_pressure_slab(_jax(dims), terms=3, interpret=True)
            for dims in (X_TAIL, Y_TAIL_S, Y_FOLD_S)}


@pytest.mark.parametrize("dims,stage", [
    (X_TAIL, "div3"), (X_TAIL, "gradsub3"), (Y_TAIL_S, "mid"),
    (Y_FOLD_S, "mid"), (Y_FOLD_S, "halves")],
    ids=["x-tail-div3", "x-tail-gradsub3", "y-tail-mid", "y-folded-mid",
         "y-folded-halves"])
def test_slab_matches_x3d2_tpu(jslabs, dims, stage):
    ns = _port(dims)
    pm = ns._slab
    xk, div_fn, grad_fn, mid_fn = (jslabs[dims][2], jslabs[dims][0],
                                   jslabs[dims][1], jslabs[dims][3])
    n = 6 if stage == "gradsub3" else 3
    f = _fields(dims, n, seed=len(stage) + dims[1])
    t = [torch.from_numpy(a) for a in f]
    j = [jnp.asarray(a) for a in f]
    if stage == "div3":
        _close(sl.x_div3(*t, pm), xk["div3"](*j), 2e-4)
    elif stage == "gradsub3":
        _close(sl.x_gradsub3(*t, pm), xk["gradsub3"](*j), 2e-4)
    elif stage == "mid":
        got = sl.pressure_mid(*t, pm, emit_q=True)
        _close(got, mid_fn(*j), 2e-4)
        no_q = sl.pressure_mid(*t, pm, emit_q=False)
        assert no_q[0] is None
        assert all(torch.equal(a, b) for a, b in zip(got[1:], no_q[1:]))
    else:
        q = sl.div_solve(*t, pm)
        _close([q], [div_fn(*j)], 2e-4)
        _close(sl.grad(q, pm), grad_fn(jnp.asarray(q.numpy())), 2e-4)


def test_band_check_failure_takes_the_folded_y(monkeypatch):
    """x3d2_tpu's slab takes the folded y where its band check fails
    (pallas_poisson.py:580-587), and its pipeline raises there; the port
    chooses alike."""
    dims = (16, 192, 128)
    jns, jns64 = _jax(dims), _jax(dims, jnp.float64)
    monkeypatch.setattr(pallas_poisson, "_BAND_TOL", 0.0)
    monkeypatch.setattr(parity, "_BAND_TOL", 0.0)
    with pytest.raises(ValueError):
        make_pressure_pipe3(jns, terms=3, interpret=True)
    with pytest.raises(ValueError):
        _port(dims)   # the pipeline's route
    jmid = make_pressure_slab(jns, terms=3, interpret=True)[3]
    monkeypatch.setenv("X3D2_PIPE3", "0")
    ns = _port(dims, torch.float64)
    assert ns._projection_gap is None
    assert ns._slab.forms.y == "folded" and ns._pipe is None
    for got, want in ((ns._slab.x_perm, jmid.x_perm),
                      (ns._slab.q_perm, jmid.q_perm),
                      (ns._slab.z_perm, jmid.z_perm)):
        assert (got is None) == (want is None)
    f = _fields(dims, 3, seed=13, dtype=np.float64)
    got = ns.pressure_correction(*(torch.from_numpy(a) for a in f),
                                 keep_pressure=True)
    want = jns64.pressure_correction(*(jnp.asarray(a) for a in f),
                                     keep_pressure=True)
    _close(got, want, 1e-10)


def test_wall_bounded_y_slab():
    """No gate of x3d2_tpu reaches a wall-bounded y (n_cell = n_vert - 1
    along it), but the port's slab builds there: the folded y with the
    rectangular dense y operators."""
    ns = _port(WALL_DIMS, bcs=WALL_Y)
    assert ns._slab is None and ns._projection_gap is None
    pm = build_projection_mats(ns)
    assert pm.forms.y == "folded" and pm.x_perm is not None
    assert sl.stage_name("pressure_mid", pm, True) \
        == "pressure_mid[q,folded_y]"
    jmid = make_pressure_slab(_jax(WALL_DIMS, bcs=JWALL_Y), terms=3,
                              interpret=True)[3]
    f = _fields(WALL_DIMS, 3, seed=11)
    got = sl.pressure_mid(*(torch.from_numpy(a) for a in f), pm)
    assert tuple(got[0].shape) == (16, 128, 128)
    _close(got, jmid(*(jnp.asarray(a) for a in f)), 2e-4)
    # float64: x stage, mid, x stage against the port's folded chain
    ns64 = _port(WALL_DIMS, torch.float64, WALL_Y)
    pm64 = build_projection_mats(ns64)
    u, v, w = (torch.from_numpy(a) for a in _fields(WALL_DIMS, 3, 12,
                                                    np.float64))
    d = sl.x_div3(u, v, w, pm64)
    _, p_zy, dpdy, dpdz = sl.pressure_mid(*d, pm64)
    grads = [sl.x_apply_parity(k, g, pm64) for k, g in
             (("gxs", p_zy), ("gxi", dpdy), ("gxi", dpdz))]
    want = ns64.pressure_grads_folded(u, v, w, keep_pressure=False)[:3]
    _close(grads, [t.numpy() for t in want], 1e-10)
