"""Runge-Kutta stepping in the port against x3d2_tpu, on the same numpy
inputs.

- The tableau plumbing: rk_prev (the earlier stage derivatives a fused
  update reads) equals x3d2_tpu's make_fused_transeq_rk stage.prev_nz for
  RK1-4, and rk_substage equals x3d2_tpu's in float64, bit for bit.
- The RK sweep epilogue's plain version (the y sweep with the substage
  update: the sweep's own base at the first substage, the step-initial
  fields f0 after it) at (128, 128, 256), float32:
  - each instance, (history fields, separate base) = (0, own), (0, f0),
    (2, f0), (3, f0), against the float64 dense transeq and the substage
    update in float64: 1e-5 on u' (as tests/test_fused_ab.py:61) and
    3e-5 * scale on rhs (tests/test_pallas_v3.py:63);
  - the RK3 substage chains against x3d2_tpu's make_fused_transeq_rk in
    interpret mode (terms=3), one substage of each kind: 3e-5 * scale.
  The chain without an update (solver.transeq on the sweeps) against the
  same float64 transeq: 3e-5 * scale.
- Whole TGV steps in float64 on 32^3 (x3d2_tpu's XLA path; the port's
  unfused RK step): RK2, RK3, RK4 over 2 steps, to 1e-10; an RK3 state
  handed over from x3d2_tpu continues exactly (1e-12).
- TGV (128, 128, 256) float32 RK3, one step on the CPU: the fused RK
  chain (plain versions) and, with X3D2_FUSED_RK=0, the unfused branch
  (transeq on the sweep chain, rk_substage) each match x3d2_tpu's einsum
  step to 1e-5 in u, v, w.
"""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax
import jax.numpy as jnp

from x3d2_tpu.cases import SolverParams as JSolverParams
from x3d2_tpu.cases import TGVCase as JTGVCase
from x3d2_tpu.common import BC as JBC
from x3d2_tpu.mesh import Mesh as JMesh
from x3d2_tpu.solver import NavierStokes as JNavierStokes
from x3d2_tpu.time_integrators import TimeIntegrator as JTimeIntegrator

from x3d2_tpu_torch.cases import SolverParams, TGVCase
from x3d2_tpu_torch.common import BC
from x3d2_tpu_torch.convert import state_from_numpy, state_to_numpy
from x3d2_tpu_torch.mesh import Mesh
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


def test_rk_tableau_rows_match_x3d2_tpu():
    from x3d2_tpu.ops.pallas_kernels import make_fused_transeq_rk as jrk

    jmesh = JMesh(SHAPE, L, ((JBC.PERIODIC, JBC.PERIODIC),) * 3)
    jns = JNavierStokes.build(jmesh, NU, dtype=jnp.float32)
    rng = np.random.default_rng(5)
    for order in range(1, 5):
        ti = TimeIntegrator(f"RK{order}")
        stages = jrk(jns.ops, NU, SHAPE, order, interpret=True)
        assert [ti.rk_prev(i) for i in range(order)] == \
            [s.prev_nz for s in stages]
        # every row's update as x3d2_tpu's rk_substage, in float64
        f0 = tuple(rng.standard_normal((4, 5)) for _ in range(2))
        ks = [tuple(rng.standard_normal((4, 5)) for _ in range(2))
              for _ in range(order)]
        jti = JTimeIntegrator(f"RK{order}")
        for i in range(order):
            got = ti.rk_substage(tuple(map(torch.from_numpy, f0)),
                                 [tuple(map(torch.from_numpy, k))
                                  for k in ks[:i + 1]], i, DT)
            want = jti.rk_substage(tuple(map(jnp.asarray, f0)),
                                   [tuple(map(jnp.asarray, k))
                                    for k in ks[:i + 1]], i, DT)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            row = ti.rk_row(i, DT, torch.float64)
            assert len(row) == 1 + len(ti.rk_prev(i)) and row[0] != 0.0


@pytest.fixture(scope="module")
def setup():
    mesh = Mesh(SHAPE, L, ((BC.PERIODIC, BC.PERIODIC),) * 3)
    ns = NavierStokes.build(mesh, NU, dtype=torch.float32, device="cpu")
    X, Y, Z = mesh.coord_grids(0)
    rng = np.random.default_rng(4)
    u = np.sin(X) * np.cos(Y) * np.cos(Z)
    v = -np.cos(X) * np.sin(Y) * np.cos(Z)
    w = 0.1 * np.sin(X + 2 * Y) * np.cos(Z)
    fields = tuple(np.asarray(f, np.float32) for f in (u, v, w))
    # the step-initial fields, and earlier stage derivatives of RK size
    f0 = tuple((f + 1e-3 * rng.standard_normal(SHAPE)).astype(np.float32)
               for f in fields)
    ks = [tuple((0.1 * rng.standard_normal(SHAPE)).astype(np.float32)
                for _ in range(3)) for _ in range(3)]
    jmesh = JMesh(SHAPE, L, ((JBC.PERIODIC, JBC.PERIODIC),) * 3)
    jns = JNavierStokes.build(jmesh, NU, dtype=jnp.float64)
    rhs64 = tuple(np.asarray(r) for r in jns.transeq(
        *(jnp.asarray(f, jnp.float64) for f in fields)))
    return ns, fields, f0, ks, rhs64


def _t(arrays):
    return tuple(torch.from_numpy(a.copy()) for a in arrays)


def test_transeq_chain_matches_f64(setup):
    ns, fields, _, _, rhs64 = setup
    assert ns._sweeps is not None
    got = ns.transeq(*_t(fields))
    for g, e in zip(got, rhs64):
        err = np.abs(g.numpy() - e).max()
        assert err < 3e-5 * np.abs(e).max(), f"{err:.2e}"


@pytest.mark.parametrize("nolds,base_sep", sorted(ts.RK_INSTANCES))
def test_rk_sweep_plain_matches_f64(setup, nolds, base_sep):
    ns, fields, f0, ks, rhs64 = setup
    d2 = ts.make_transeq_sweep(ns.ops[2], NU, 2, SHAPE, device="cpu")
    d0 = ts.make_transeq_sweep(ns.ops[0], NU, 0, SHAPE, accumulate=True,
                               device="cpu")
    d1 = ts.make_transeq_sweep(ns.ops[1], NU, 1, SHAPE, accumulate=True,
                               nolds=nolds, upd=True, base_sep=base_sep,
                               device="cpu")
    dtc = [0.5 * DT] + [0.25 * DT * (j + 1) for j in range(nolds)]
    f = _t(fields)
    acc = d0(*f, acc=d2(*f))
    olds = tuple(tuple(torch.from_numpy(ks[j][c]) for j in range(nolds))
                 for c in range(3))
    base = _t(f0) if base_sep else None
    new, rhs = d1(*f, acc=acc, olds=olds, dtc=dtc, base=base)
    for c in range(3):
        want = (f0 if base_sep else fields)[c].astype(np.float64) \
            + dtc[0] * rhs64[c]
        for j in range(nolds):
            want = want + dtc[1 + j] * ks[j][c].astype(np.float64)
        err = np.abs(new[c].numpy() - want).max()
        assert err < 1e-5, f"u'[{c}]: {err:.2e}"
        err = np.abs(rhs[c].numpy() - rhs64[c]).max()
        assert err < 3e-5 * np.abs(rhs64[c]).max(), f"rhs[{c}]: {err:.2e}"
    assert ts.variant_name(1, True, nolds, upd=True, base_sep=base_sep) \
        == "transeq_sweep[y,acc,rk%d%s]" % (nolds, ",f0" if base_sep else "")


@pytest.fixture(scope="module")
def rk3_stages(setup):
    """The port's RK3 substage chains (plain versions) and x3d2_tpu's in
    interpret mode, terms=3."""
    from x3d2_tpu.ops.pallas_kernels import make_fused_transeq_rk as jrk

    ns = setup[0]
    jmesh = JMesh(SHAPE, L, ((JBC.PERIODIC, JBC.PERIODIC),) * 3)
    jns = JNavierStokes.build(jmesh, NU, dtype=jnp.float32)
    return (ts.make_fused_transeq_rk(ns.ops, NU, SHAPE, 3, device="cpu"),
            jrk(jns.ops, NU, SHAPE, 3, interpret=True, terms=3))


@pytest.mark.parametrize("istage", [0, 1, 2])
def test_rk3_substage_matches_x3d2_tpu_kernel_chain(setup, rk3_stages,
                                                    istage):
    """Substage 0: the (0, own) update; 1: (0, f0); 2: (2, f0)."""
    _, fields, f0, ks, _ = setup
    stages, jstages = rk3_stages
    ti = TimeIntegrator("RK3")
    dtc = ti.rk_row(istage, DT)
    got = stages[istage](*_t(fields), _t(f0), [_t(k) for k in ks[:istage]],
                         dtc)
    jks = [tuple(jnp.asarray(a) for a in k) for k in ks[:istage]]
    jrow = jnp.asarray(dtc + [0.0] * (4 - len(dtc)), jnp.float32)
    want = jstages[istage](*(jnp.asarray(a) for a in fields),
                           tuple(jnp.asarray(a) for a in f0), jks, jrow)
    assert len(stages[istage].prev_nz) == (2 if istage == 2 else 0)
    for gs, es in zip(got, want):
        for g, e in zip(gs, es):
            e = np.asarray(e)
            err = np.abs(g.numpy() - e).max()
            assert err < 3e-5 * np.abs(e).max(), f"{err:.2e}"


def test_rk_variant_rules(setup):
    """The RK update is built on the y sweep for the tableaus' rows; u'
    never goes over u, v, w or the base."""
    ns = setup[0]
    with pytest.raises(ValueError, match="RK update"):
        ts.make_transeq_sweep(ns.ops[0], NU, 0, SHAPE, accumulate=True,
                              upd=True, device="cpu")
    with pytest.raises(ValueError, match="RK update"):
        ts.make_transeq_sweep(ns.ops[1], NU, 1, SHAPE, accumulate=True,
                              nolds=1, upd=True, base_sep=True, device="cpu")
    with pytest.raises(ValueError, match="need the update"):
        ts.make_transeq_sweep(ns.ops[1], NU, 1, SHAPE, accumulate=True,
                              base_sep=True, device="cpu")
    assert ts.variant_name(1, True, 2) == "transeq_sweep[y,acc,ab3]"


# ---------------------------------------------------------------------------
# whole steps
# ---------------------------------------------------------------------------

def _cases(shape, time_intg, tdtype, jdtype):
    mesh = Mesh(shape, L, ((BC.PERIODIC, BC.PERIODIC),) * 3)
    jmesh = JMesh(shape, L, ((JBC.PERIODIC, JBC.PERIODIC),) * 3)
    kw = dict(monitor_path=None, verbose=False, keep_pressure=False)
    case = TGVCase(mesh, SolverParams(Re=1600, time_intg=time_intg, dt=DT),
                   dtype=tdtype, device="cpu", **kw)
    jcase = JTGVCase(jmesh, JSolverParams(Re=1600, time_intg=time_intg,
                                          dt=DT), dtype=jdtype, **kw)
    return case, jcase


@pytest.mark.parametrize("time_intg", ["RK2", "RK3", "RK4"])
def test_tgv_rk_matches_f64(time_intg):
    case, jcase = _cases((32,) * 3, time_intg, torch.float64, jnp.float64)
    assert case._fused_rk is None   # float64, below the kernel's tiles
    s = case.run(n_iters=2, n_output=1)
    js = jcase.run(n_iters=2, n_output=1)
    for k in ("u", "v", "w"):
        np.testing.assert_allclose(s[k].numpy(), np.asarray(js[k]), rtol=0,
                                   atol=1e-10)
    np.testing.assert_allclose(np.array(case.monitor.rows)[:, 4],
                               np.array(jcase.monitor.rows)[:, 4],
                               rtol=1e-12, atol=0)
    assert s["olds"] == ((), (), ())


def test_rk_state_handover_from_x3d2_tpu_continues_exactly():
    case, jcase = _cases((32,) * 3, "RK3", torch.float64, jnp.float64)
    js = jcase.run(n_iters=2)
    assert "olds" not in js   # x3d2_tpu's RK state carries no history
    handed = {k: np.asarray(js[k]) for k in ("u", "v", "w", "p")}
    handed["istep"] = int(js["istep"])
    js = jcase.run(n_iters=2, state=js)
    s = state_from_numpy(handed, device="cpu")
    assert s["olds"] == ((), (), ())
    got = state_to_numpy(case.run(n_iters=2, state=s))
    js = jax.device_get(js)
    assert got["istep"] == int(js["istep"]) == 5
    for k in ("u", "v", "w"):
        np.testing.assert_allclose(got[k], np.asarray(js[k]), rtol=0,
                                   atol=1e-12)


@pytest.fixture(scope="module")
def einsum_rk3_step():
    """x3d2_tpu's float32 einsum RK3 step at (128, 128, 256), from TGV."""
    _, jcase = _cases(SHAPE, "RK3", torch.float32, jnp.float32)
    js = jcase._step(jcase.initial_state())
    return {k: np.asarray(js[k]) for k in ("u", "v", "w")}


def _one_step_matches(case, want):
    s = case.step(case.initial_state())
    assert s["istep"] == 2
    for k in ("u", "v", "w"):
        err = np.abs(s[k].numpy() - want[k]).max()
        assert err < 1e-5, f"{k}: {err:.2e}"


def test_tgv_fused_rk3_matches_einsum_step_f32(einsum_rk3_step, monkeypatch):
    monkeypatch.delenv("X3D2_FUSED_RK", raising=False)
    case, _ = _cases(SHAPE, "RK3", torch.float32, jnp.float32)
    assert case._fused_rk is not None and len(case._fused_rk) == 3
    calls = []
    object.__setattr__(case.solver, "transeq", lambda *a: calls.append(1))
    _one_step_matches(case, einsum_rk3_step)
    assert calls == []   # the fused chains, not transeq


def test_tgv_unfused_rk3_switch_matches_einsum_step_f32(einsum_rk3_step,
                                                        monkeypatch):
    monkeypatch.setenv("X3D2_FUSED_RK", "0")
    case, _ = _cases(SHAPE, "RK3", torch.float32, jnp.float32)
    assert case._fused_rk is None and case.solver._sweeps is not None
    calls = []
    inner = case.solver.transeq
    object.__setattr__(case.solver, "transeq",
                       lambda *a: (calls.append(1), inner(*a))[1])
    _one_step_matches(case, einsum_rk3_step)
    assert len(calls) == 3   # one transeq per substage
