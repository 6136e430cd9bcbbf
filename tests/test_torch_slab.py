"""The port's slab projection against x3d2_tpu's, on the CPU at 128^3.

- x_div3, the mid (with and without q) and x_gradsub3 in float32 vs the
  x3d2_tpu kernels of make_pressure_slab run in interpret mode (terms=3,
  the mode with the same W=32 band), on the same numpy inputs: 2e-4 *
  scale, the bound of tests/test_pallas_poisson.py (the reference's bf16
  split noise). This pins the block-parity orderings of du, dv, dw, of q
  and of the gradient slabs.
- The same three in float64 vs x3d2_tpu's float64 operator path (its
  transform-folded matrices, permuted to the block-parity order): 1e-10 *
  scale (the band at W=32 drops entries below 1e-15; measured 1e-13).
- pressure_correction(keep_pressure=True) in float64 equals x3d2_tpu's in
  u, v, w and the physical p to 1e-10; the slab and the pipeline of the
  port agree to 1e-11; the divergence after the slab projection stays
  below 1e-10, the bound of tests/test_poisson.py.
- The dispatch order of x3d2_tpu (solver.py:523-567): the pipeline only
  without kept pressure and without `divs`, else the slab; `divs` skip
  x_div3.
- CPU tensors take the plain versions and count no launch.
"""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax.numpy as jnp

from x3d2_tpu.common import BC as JBC
from x3d2_tpu.mesh import Mesh as JMesh
from x3d2_tpu.ops.compact import apply_matrix as j_apply_matrix
from x3d2_tpu.ops.pallas_poisson import make_pressure_slab
from x3d2_tpu.solver import NavierStokes as JNavierStokes

from x3d2_tpu_torch.common import BC
from x3d2_tpu_torch.mesh import Mesh
from x3d2_tpu_torch.ops import operator_apply as oa
from x3d2_tpu_torch.ops import pressure_slab as sl
from x3d2_tpu_torch.ops.parity import projection_supported
from x3d2_tpu_torch.solver import NavierStokes

# one thread for torch and for numpy's BLAS: the suite runs several workers
# on one machine, and multi-threaded BLAS calls in each of them, spinning on
# oversubscribed cores, made these tests many times slower there
torch.set_num_threads(1)
threadpool_limits(1, user_api="blas")


SHAPE = (128, 128, 128)
L = (2 * np.pi,) * 3
NU = 1 / 1600
PER = ((BC.PERIODIC, BC.PERIODIC),) * 3
JPER = ((JBC.PERIODIC, JBC.PERIODIC),) * 3


def _build(dtype, shape=SHAPE, bcs=PER):
    return NavierStokes.build(Mesh(shape, L, bcs), NU, dtype=dtype,
                              device="cpu")


def _fields(n, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(SHAPE).astype(dtype) for _ in range(n)]


def _close(got, want, tol):
    assert len(got) == len(want)
    for g, e in zip(got, want):
        e = np.asarray(e)
        err = np.abs(g.numpy() - e).max()
        assert err < tol * np.abs(e).max(), f"{err:.2e}"


@pytest.fixture(scope="module")
def jax_slab():
    jns = JNavierStokes.build(JMesh(SHAPE, L, JPER), NU, dtype=jnp.float32)
    return make_pressure_slab(jns, terms=3, interpret=True)


@pytest.fixture(scope="module")
def solver32():
    return _build(torch.float32)


@pytest.fixture(scope="module")
def solver64():
    return _build(torch.float64)


@pytest.fixture(scope="module")
def jsolver64():
    return JNavierStokes.build(JMesh(SHAPE, L, JPER), NU, dtype=jnp.float64)


def test_slab_supported(solver32):
    assert projection_supported(solver32) and solver32._slab is not None
    assert solver32._slab is solver32._pipe.mats   # one operator set
    small = _build(torch.float32, (32, 32, 32))   # not tiled by 128
    assert not projection_supported(small) and small._slab is None
    neu = ((BC.NEUMANN, BC.NEUMANN),) + PER[1:]
    assert not projection_supported(_build(torch.float32, (33, 32, 32), neu))


@pytest.mark.parametrize("stage,nin", [("div3", 3), ("mid", 3),
                                       ("mid_no_q", 3), ("gradsub3", 6)])
def test_stage_matches_x3d2_tpu_slab(jax_slab, solver32, stage, nin):
    f = _fields(nin, seed={"div3": 1, "mid": 2, "mid_no_q": 2,
                           "gradsub3": 3}[stage])
    slab = solver32._slab
    t = [torch.from_numpy(a) for a in f]
    j = [jnp.asarray(a) for a in f]
    xk, mid_fn = jax_slab[2], jax_slab[3]
    if stage == "div3":
        got, want = sl.x_div3(*t, slab), xk["div3"](*j)
    elif stage == "mid":
        got, want = sl.pressure_mid(*t, slab, emit_q=True), mid_fn(*j)
    elif stage == "mid_no_q":
        got = sl.pressure_mid(*t, slab, emit_q=False)
        assert got[0] is None
        got, want = got[1:], mid_fn.no_q(*j)
    else:
        got, want = sl.x_gradsub3(*t, slab), xk["gradsub3"](*j)
    _close(got, want, 2e-4)


@pytest.mark.parametrize("stage", ["div3", "mid", "gradsub3"])
def test_stage_matches_x3d2_tpu_f64_operators(solver64, jsolver64, stage):
    slab = solver64._slab
    d = jsolver64._fused_pressure_mats()
    xp, yp, zp = slab.x_perm, slab.q_perm, slab.z_perm
    f = _fields(6, seed=4, dtype=np.float64)
    t = [torch.from_numpy(a) for a in f]
    j = [jnp.asarray(a) for a in f]

    def ap(name, a, axis):
        return np.asarray(j_apply_matrix(d[name], a, axis))

    if stage == "div3":
        got = sl.x_div3(*t[:3], slab)
        want = [ap("sx", j[0], 0)[xp], ap("ix", j[1], 0)[xp],
                ap("ix", j[2], 0)[xp]]
    elif stage == "mid":
        # inputs: x-spectral fields in block-parity order, as div3 gives
        got = sl.pressure_mid(*t[:3], slab, emit_q=True)
        inv_x = np.argsort(xp)
        du, dv, dw = (jnp.asarray(a[inv_x]) for a in f[:3])
        duv = ap("iy", du, 1) + ap("sy", dv, 1)
        F = ap("iz", duv, 2) + ap("sz", ap("iy", dw, 1), 2)
        q = F * np.asarray(jsolver64.poisson.inv_waves)
        both = ap("gz_is", q, 2)
        nz = SHAPE[2]
        p_z, dpdz = both[:, :, :nz], both[:, :, nz:]
        both = ap("gy_is", p_z, 1)
        ny = SHAPE[1]
        want = [q[xp][:, yp][:, :, zp], both[xp, :ny], both[xp, ny:],
                ap("gy_i", dpdz, 1)[xp]]
    else:
        got = sl.x_gradsub3(*t, slab)
        inv_x = np.argsort(xp)
        want = [f[3] - ap("gx_s", jnp.asarray(f[0][inv_x]), 0),
                f[4] - ap("gx_i", jnp.asarray(f[1][inv_x]), 0),
                f[5] - ap("gx_i", jnp.asarray(f[2][inv_x]), 0)]
    _close(got, want, 1e-10)


def test_mid_no_q_equals_mid(solver32):
    t = [torch.from_numpy(a) for a in _fields(3, seed=7)]
    full = solver32._slab_mid(*t, want_q=True)
    noq = solver32._slab_mid(*t, want_q=False)
    assert full[0] is not None and noq[0] is None
    for a, b in zip(full[1:], noq[1:]):
        assert torch.equal(a, b)


def test_keep_pressure_projection_matches_x3d2_tpu_f64(solver64, jsolver64):
    f = _fields(3, seed=5, dtype=np.float64)
    got = solver64.pressure_correction(*(torch.from_numpy(a) for a in f),
                                       keep_pressure=True)
    want = jsolver64.pressure_correction(*(jnp.asarray(a) for a in f),
                                         keep_pressure=True)
    _close(got, want, 1e-10)
    u, v, w = got[:3]
    assert float(solver64.divergence_v2p(u, v, w).abs().max()) < 1e-10


def test_slab_and_pipe_agree_f64(solver64):
    t = [torch.from_numpy(a) for a in _fields(3, seed=6, dtype=np.float64)]
    slab = solver64.pressure_correction(*t, keep_pressure=True)
    pipe = solver64.pressure_correction(*t, keep_pressure=False)
    assert pipe[3] is None
    for a, b in zip(slab[:3], pipe[:3]):
        assert float((a - b).abs().max()) < 1e-11 * float(b.abs().max())


@pytest.mark.parametrize("keep,with_divs,want", [
    (False, False, ["pipe"]),
    (True, False, ["div3", "mid:q", "gradsub3"]),
    (False, True, ["mid", "gradsub3"]),
    (True, True, ["mid:q", "gradsub3"]),
])
def test_dispatch_order(monkeypatch, keep, with_divs, want):
    ns = _build(torch.float32)
    calls = []
    pipe, slab = ns._pipe, ns._slab

    def spy_pipe(u, v, w):
        calls.append("pipe")
        return pipe(u, v, w)

    object.__setattr__(ns, "_pipe", spy_pipe)
    div3, mid, gradsub3 = sl.x_div3, sl.pressure_mid, sl.x_gradsub3
    monkeypatch.setattr(sl, "x_div3",
                        lambda *a: (calls.append("div3"), div3(*a))[1])
    monkeypatch.setattr(sl, "pressure_mid", lambda *a, emit_q=True: (
        calls.append("mid:q" if emit_q else "mid"), mid(*a, emit_q=emit_q))[1])
    monkeypatch.setattr(sl, "x_gradsub3", lambda *a: (
        calls.append("gradsub3"), gradsub3(*a))[1])
    t = [torch.from_numpy(a) for a in _fields(3, seed=8)]
    divs = div3(*t, slab) if with_divs else None
    out = ns.pressure_correction(*t, keep_pressure=keep, divs=divs)
    assert calls == want
    assert (out[3] is not None) == keep
    # every route is the same projection
    ref = ns.pressure_grads(*t, keep_pressure=keep)
    for g, f, e in zip(out[:3], t, ref[:3]):
        assert float((g - (f - e)).abs().max()) < 1e-5 * float(f.abs().max())


def test_divs_need_the_slab():
    ns = _build(torch.float32, (32, 32, 32))
    f = torch.zeros((32, 32, 32))
    with pytest.raises(ValueError, match="slab"):
        ns.pressure_correction(f, f, f, keep_pressure=False, divs=(f, f, f))


def test_cpu_slab_never_counts_launches(solver32):
    oa.reset_launch_counts()
    f = torch.zeros(SHAPE)
    slab = solver32._slab
    mid = sl.pressure_mid(*sl.x_div3(f, f, f, slab), slab)
    out = sl.x_gradsub3(*mid[1:], f, f, f, slab)
    assert len(out) == 3 and oa.launch_counts() == {}
    m = torch.empty(SHAPE, device="meta")
    with pytest.raises(ValueError, match="no x_div3"):
        sl.x_div3(m, m, m, slab)
