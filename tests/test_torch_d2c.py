"""The d2-in-C carry (X3D2_D2C=1) in the port against x3d2_tpu, on the CPU.

- Stage C with the carry: pipe_c_d2's plain version against x3d2_tpu's
  make_pressure_pipe3(terms=3, interpret=True, d2_sweep=True).c_fn at
  (128, 128, 256), float32 on the same numpy inputs: u', v', w' and the
  carried partials within 3e-6 * scale, tests/test_torch_pipe.py's bound
  for the stages (both sides carry float32 rounding of dot products up to
  256 long; the carry's band, 64 at 128-point blocks, is the same).
- The carry against the float64 operator path's z transport (the dense
  compact operators, solver.transeq's z terms) on the same u', v', w':
  5e-7 * scale, the bound of x3d2_tpu's HIGHEST mode
  (tests/test_pallas_v3.py:114), which the carry is held to in both modes.
- The chain without its z sweep (make_fused_transeq_ab(skip_d2=True))
  against x3d2_tpu's make_fused_transeq_ab_v3(skip_d2=True,
  interpret=True) at (128, 128, 256), float32: 3e-5 * scale, the bound of
  tests/test_torch_transeq.py's chains; its buffers: the x sweep adds into
  the carried partials, rhs goes over them and u' over the oldest history;
  skip_d2 with bfloat16 partials or with xdiv raises ValueError, as
  x3d2_tpu's.
- The carried steps in float64 (plain versions, (128, 128, 256), 2 AB
  steps from a divergence-free white-noise field) against the port's main
  path (the chain with its z sweep and the pipeline without the carry):
  they differ only by the z band of the carried step (64 against the
  sweep's 16, whose truncation is 1.9e-7 of D1's largest entry, about 40
  at nz = 256: ~1e-5 of max |q| in D1 q, a few 1e-4 in a rhs of noise of
  amplitude ~5, times dt (23/12)), bounded by 1e-7 * max |u| (measured
  9.2e-9 over the 2 steps).
- TGVCase with X3D2_D2C=1 (float32, plain versions, 2 steps): the state
  carries the partials, the steps take the carry (no z sweep after the
  boot one), run(state=...) makes the partials anew from u, v, w (a state
  with wrong ones steps as the main path does: within 1e-6 of max |u|,
  float32 rounding); state_from_numpy / state_to_numpy carry them.
- CPU tensors take the plain versions and count no launch; the carry's
  build raises where x3d2_tpu's does; the kernel serves 640, 1024 and 2048
  points along z (its streamed form) and refuses what both refuse.
"""


import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax.numpy as jnp

from x3d2_tpu.common import BC as JBC
from x3d2_tpu.mesh import Mesh as JMesh
from x3d2_tpu.ops.pallas_kernels import make_fused_transeq_ab_v3
from x3d2_tpu.ops.pallas_poisson import make_pressure_pipe3
from x3d2_tpu.solver import NavierStokes as JNavierStokes

from x3d2_tpu_torch.cases import SolverParams, TGVCase
from x3d2_tpu_torch.common import BC
from x3d2_tpu_torch.convert import state_from_numpy, state_to_numpy
from x3d2_tpu_torch.mesh import Mesh
from x3d2_tpu_torch.ops import operator_apply as oa
from x3d2_tpu_torch.ops import pressure_pipe as pp
from x3d2_tpu_torch.ops import transeq_sweep as ts
from x3d2_tpu_torch.solver import NavierStokes
from x3d2_tpu_torch.time_integrators import TimeIntegrator

# one thread for torch and for numpy's BLAS: the suite runs several workers
# on one machine, and multi-threaded BLAS calls in each of them, spinning on
# oversubscribed cores, made these tests many times slower there
torch.set_num_threads(1)
threadpool_limits(1, user_api="blas")

SHAPE = (128, 128, 256)
L = (2 * np.pi,) * 3
NU = 1 / 1600
DT = 1e-3
PER = ((BC.PERIODIC, BC.PERIODIC),) * 3
JPER = ((JBC.PERIODIC, JBC.PERIODIC),) * 3
SWITCHES = ("X3D2_D2C", "X3D2_XDIV_FUSED", "X3D2_BF16_ACC", "X3D2_BFLY",
            "X3D2_MATMUL_PRECISION")


@pytest.fixture(autouse=True)
def _clean_switches(monkeypatch):
    for k in SWITCHES:
        monkeypatch.delenv(k, raising=False)


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
def solver32():
    return NavierStokes.build(Mesh(SHAPE, L, PER), NU, device="cpu")


@pytest.fixture(scope="module")
def carry(solver32):
    return pp.build_carry_mats(solver32.ops[2], NU, device="cpu")


def test_pipe_c_d2_matches_x3d2_tpu(solver32, carry):
    jns = JNavierStokes.build(JMesh(SHAPE, L, JPER), NU, dtype=jnp.float32)
    jpipe = make_pressure_pipe3(jns, terms=3, interpret=True, d2_sweep=True)
    f = _fields(5, seed=21)
    got = pp.pipe_c_d2(*(torch.from_numpy(a) for a in f),
                       solver32._pipe.mats, carry)
    want = jpipe.c_fn(*(jnp.asarray(a) for a in f))
    _close(got[0] + got[1], want, 3e-6)


def _z_transport64(ns64, u, v, w):
    """The z terms of solver.transeq on the dense float64 operators."""
    o = ns64.ops[2]
    out = []
    for c, q in enumerate((u, v, w)):
        du, dud, d2u = ((o.der1st, o.der1st_sym, o.der2nd) if c == 2
                        else (o.der1st_sym, o.der1st, o.der2nd_sym))
        out.append(-0.5 * (w * du(q, 2) + dud(q * w, 2)) + NU * d2u(q, 2))
    return out


def test_carry_matches_the_f64_operators(solver32, carry):
    ns64 = NavierStokes.build(Mesh(SHAPE, L, PER), NU, dtype=torch.float64,
                              device="cpu")
    f = [torch.from_numpy(a) for a in _fields(5, seed=22)]
    new, rhsp = pp.pipe_c_d2(*f, solver32._pipe.mats, carry)
    want = _z_transport64(ns64, *(t.double() for t in new))
    for g, e in zip(rhsp, want):
        err = float((g.double() - e).abs().max())
        assert err <= 5e-7 * float(e.abs().max()), f"{err:.2e}"


def test_carry_taps_are_the_operators(carry, solver32):
    """The kernel's 2W + 1 taps per operator are row 0 of the circulant
    operator around the diagonal; beyond them nothing above 1e-12."""
    o = solver32.ops[2]
    n = SHAPE[2]
    offs = np.arange(-pp.CARRY_W, pp.CARRY_W + 1)
    for row, op in zip(carry.taps, (o.der1st, o.der1st_sym, o.der2nd,
                                    o.der2nd_sym)):
        M = op.M64
        for i in (0, 37, n - 1):
            np.testing.assert_allclose(row, M[i][(i + offs) % n], rtol=0,
                                       atol=1e-12 * np.abs(M).max())
    # an extent x3d2_tpu's carry gate refuses (nz < 256) is refused by both
    small = (128, 128, 128)
    with pytest.raises(ValueError, match="lane-tileable"):
        ns = NavierStokes.build(Mesh(small, L, PER), NU, device="cpu")
        pp.build_carry_mats(ns.ops[2], NU, device="cpu")
    jns = JNavierStokes.build(JMesh(small, L, JPER), NU, dtype=jnp.float32)
    with pytest.raises(ValueError, match="lane-tileable"):
        make_pressure_pipe3(jns, terms=2, d2_sweep=True)
    assert not pp.carry_kernel_supported(small)
    assert pp.carry_kernel_supported((512, 512, 512))
    assert pp.carry_kernel_supported(SHAPE)
    # the resident form's z extents: 256, 384 (the x-tail grid 320 x 256 x
    # 384 of x3d2_tpu's sweep chain) and 512; the streamed form past them,
    # at every extent x3d2_tpu's gate admits
    assert pp.carry_kernel_supported((320, 256, 384))
    for nz in (640, 1024, 2048):
        assert pp.carry_kernel_supported((128, 128, nz))
        assert pp.carry_geometry((128, 128, nz))["form"] == "streamed"


def _ab_inputs(seed):
    f = _fields(9, seed)
    return f[:3], ((f[3], f[4]), (f[5], f[6]), (f[7], f[8]))


def test_skip_d2_chain_matches_x3d2_tpu(solver32):
    fields, olds = _ab_inputs(23)
    acc0 = [a * 10 for a in _fields(3, seed=24)]
    jns = JNavierStokes.build(JMesh(SHAPE, L, JPER), NU, dtype=jnp.float32)
    jchain = make_fused_transeq_ab_v3(jns.ops, NU, SHAPE, nolds=2,
                                      interpret=True, terms=3, skip_d2=True)
    dtc = TimeIntegrator("AB3").ab_row(3, DT)
    want = jchain(*(jnp.asarray(f) for f in fields),
                  tuple(tuple(jnp.asarray(o) for o in per) for per in olds),
                  jnp.asarray(dtc, jnp.float32),
                  tuple(jnp.asarray(a) for a in acc0))
    chain = ts.make_fused_transeq_ab(solver32.ops, NU, SHAPE, 2,
                                     device="cpu", skip_d2=True)
    t_olds = tuple(tuple(torch.from_numpy(o.copy()) for o in per)
                   for per in olds)
    t_acc = tuple(torch.from_numpy(a.copy()) for a in acc0)
    oldest = [per[-1].data_ptr() for per in t_olds]
    got = chain(*(torch.from_numpy(f) for f in fields), t_olds, dtc, t_acc)
    assert len(got) == len(want) == 2
    for gs, es in zip(got, want):
        _close(gs, es, 3e-5)
    assert [t.data_ptr() for t in got[0]] == oldest
    assert [t.data_ptr() for t in got[1]] == [a.data_ptr() for a in t_acc]
    assert [s.blocks.axis for s in chain.sweeps] == [0, 1]   # no z sweep


def test_skip_d2_exclusions(solver32):
    d64 = solver32._fp_mats64()
    with pytest.raises(ValueError, match="acc_dtype"):
        ts.make_fused_transeq_ab(solver32.ops, NU, SHAPE, 2, device="cpu",
                                 skip_d2=True, acc_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="xdiv"):
        ts.make_fused_transeq_ab(solver32.ops, NU, SHAPE, 2, device="cpu",
                                 skip_d2=True,
                                 xdiv=(d64["sx"], d64["ix"]))


def test_carried_steps_match_the_main_path_f64():
    """Two AB3 steps in float64 on the plain versions: the main path
    (z, x, y sweeps and the pipeline) against the carried one (a boot z
    sweep, then x, y sweeps from the carried partials and the pipeline
    with the carry)."""
    ns = NavierStokes.build(Mesh(SHAPE, L, PER), NU, dtype=torch.float64,
                            device="cpu")
    pm = ns._pipe.mats
    carry = pp.build_carry_mats(ns.ops[2], NU, device="cpu")
    chain = ts.make_fused_transeq_ab(ns.ops, NU, SHAPE, 2, device="cpu")
    nod2 = ts.make_fused_transeq_ab(ns.ops, NU, SHAPE, 2, device="cpu",
                                    skip_d2=True)
    pipe = pp.make_pressure_pipe(pm)
    pipe_d2 = pp.make_pressure_pipe_d2(pm, carry)
    ti = TimeIntegrator("AB3")
    f0 = [torch.from_numpy(a) for a in _fields(3, 25, np.float64)]
    f0 = list(pipe(*f0))   # a divergence-free start

    def run(carried):
        f = [t.clone() for t in f0]
        olds = tuple((torch.zeros_like(t), torch.zeros_like(t)) for t in f)
        rhsp = chain.sweeps[0](*f) if carried else None
        for istep in (1, 2):
            dtc = ti.ab_row(istep, DT)
            if carried:
                mom, rhs = nod2(*f, olds, dtc, rhsp)
                f, rhsp = pipe_d2(*mom)
            else:
                mom, rhs = chain(*f, olds, dtc)
                f = pipe(*mom)
            olds = tuple((r,) + tuple(o[:-1]) for r, o in zip(rhs, olds))
        return f

    main, carried = run(False), run(True)
    scale = max(float(t.abs().max()) for t in main)
    diff = max(float((a - b).abs().max()) for a, b in zip(main, carried))
    assert 0 < diff <= 1e-7 * scale, f"{diff:.2e}"


def _tgv(keep_pressure=False):
    return TGVCase(Mesh(SHAPE, L, PER), SolverParams(dt=DT),
                   dtype=torch.float32, device="cpu", monitor_path=None,
                   verbose=False, keep_pressure=keep_pressure)


def test_tgv_d2c_case(monkeypatch):
    monkeypatch.setenv("X3D2_XDIV_FUSED", "0")
    # no monitoring rows: n_output past the run, fresh=False
    main = _tgv().run(n_iters=2, n_output=100, fresh=False)
    monkeypatch.setenv("X3D2_D2C", "1")
    case = _tgv()
    assert case._pipe_d2c is not None and not case._ab_is_xdiv
    boots, calls = [], []
    boot, pipe = case._d2_boot, case._pipe_d2c
    case._d2_boot = lambda *a: (boots.append(1), boot(*a))[1]
    case._pipe_d2c = lambda *a: (calls.append(1), pipe(*a))[1]
    state = case.initial_state()
    assert len(boots) == 1 and len(state["rhsp"]) == 3
    # a state entering the loop gets its partials made anew from u, v, w
    state["rhsp"] = tuple(torch.full_like(r, 1e3) for r in state["rhsp"])
    out = case.run(n_iters=2, state=state, n_output=100, fresh=False)
    assert len(boots) == 2 and len(calls) == 2 and "rhsp" in out
    scale = max(float(main[k].abs().max()) for k in "uvw")
    for k in "uvw":
        err = float((out[k] - main[k]).abs().max())
        assert err <= 1e-6 * scale, f"{k} {err:.2e}"
    # the handover carries the partials
    np_state = state_to_numpy(out)
    back = state_from_numpy(np_state, device="cpu")
    assert len(np_state["rhsp"]) == 3
    assert all(torch.equal(a, b) for a, b in zip(back["rhsp"], out["rhsp"]))


def test_d2c_keep_pressure_carries_nothing(monkeypatch):
    monkeypatch.setenv("X3D2_XDIV_FUSED", "0")
    monkeypatch.setenv("X3D2_D2C", "1")
    case = _tgv(keep_pressure=True)
    assert case._pipe_d2c is not None
    assert "rhsp" not in case.initial_state()


def test_cpu_carry_never_counts_launches(solver32, carry):
    oa.reset_launch_counts()
    f = torch.zeros(SHAPE)
    new, rhsp = pp.pipe_c_d2(f, f, f, f, f, solver32._pipe.mats, carry)
    assert len(new) == len(rhsp) == 3 and oa.launch_counts() == {}
    m = torch.empty(SHAPE, device="meta")
    with pytest.raises(ValueError, match="no pipe_c_d2"):
        pp.pipe_c_d2(m, m, m, m, m, solver32._pipe.mats, carry)
    assert oa.LAUNCHES_PER_CALL["pipe_c[d2]"] == 3
