"""The AB step's accuracy mode in the port against x3d2_tpu, on the CPU:
Kahan-compensated state accumulation (SolverParams(compensated=True)),
and the slab branch of pressure_grads it takes its gradients from.

- kahan_add and ab_step_compensated (float32 and float64, a float32 or
  bfloat16 history) on the same numpy inputs as x3d2_tpu's: bit-equal
  fields and compensation (the same operations in the same order, no
  contraction on either side).
- Kahan summation does what it is for: 1 + 1000 x 1e-8 in float32 reaches
  1 + 1e-5 within one float32 rounding, where the plain sum stays at 1; the
  same trajectory as x3d2_tpu's kahan_add.
- pressure_grads on a slab grid takes x3d2_tpu's slab branch
  (solver.py:441-457): the x stage and the mid with q, then three
  one-field inverse parity x applies without the correction; float64
  against the transform-folded chain and x3d2_tpu's pressure_grads:
  1e-10 * scale.
- Compensated TGV 128^3 float64 (the slab grid), 3 steps, against
  x3d2_tpu's compensated einsum step: u, v, w within 1e-10 * scale (two
  float64 orders of the same algebra), the compensation within 4 float64
  roundings of max |u| (both are rounding errors of additions whose
  operands differ in the last bits).
- Compensated TGV 32^3 float64 with two scalars and a bfloat16 history
  against x3d2_tpu, and a compensated state handed over after 3 steps and
  continued 3 in the port: 1e-12 * scale.
- The cylinder (17, 128, 128) compensated, float64, 3 steps: x3d2_tpu's
  u, v, w within 1e-10 * scale; the gradients from the dense x applies
  without the correction; the compensation entering the projection's
  Kahan add is exactly 0 on the inflow plane (apply_bc writes it) and in
  the body (the mask zeroes it), as x3d2_tpu zeroes it where a hook
  changed a point (cases/base.py:353-361), and nonzero elsewhere.
- Branches: compensated AB steps unfused, compensated RK takes the
  unfused RK branch without a compensation, as x3d2_tpu.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax.numpy as jnp

from x3d2_tpu import time_integrators as jti_mod
from x3d2_tpu.cases import CylinderCase as JCylinderCase
from x3d2_tpu.cases import SolverParams as JSolverParams
from x3d2_tpu.cases import TGVCase as JTGVCase
from x3d2_tpu.common import BC as JBC
from x3d2_tpu.config import Config as JConfig
from x3d2_tpu.mesh import Mesh as JMesh

from x3d2_tpu_torch import config, ibm
from x3d2_tpu_torch import time_integrators as ti_mod
from x3d2_tpu_torch.cases import CylinderCase, SolverParams, TGVCase
from x3d2_tpu_torch.cases import base as case_base
from x3d2_tpu_torch.common import BC
from x3d2_tpu_torch.convert import state_from_numpy, state_to_numpy
from x3d2_tpu_torch.mesh import Mesh
from x3d2_tpu_torch.ops import pressure_slab as sl

# one thread for torch and for numpy's BLAS: the suite runs several workers
# on one machine, and multi-threaded BLAS calls in each of them, spinning on
# oversubscribed cores, made these tests many times slower there
torch.set_num_threads(1)
threadpool_limits(1, user_api="blas")

ROOT = Path(__file__).resolve().parents[1]
CYL_EXAMPLE = ROOT / "examples" / "cylinder" / "input.x3d"
L = (2 * np.pi,) * 3
PER = ((BC.PERIODIC, BC.PERIODIC),) * 3
JPER = ((JBC.PERIODIC, JBC.PERIODIC),) * 3
BF = torch.bfloat16
EPS64 = np.finfo(np.float64).eps


@pytest.fixture(autouse=True)
def _clean_switches(monkeypatch):
    for k in ("X3D2_BF16_OLDS", "X3D2_BF16_ACC", "X3D2_FUSED_AB",
              "X3D2_XDIV_FUSED", "X3D2_MERGED_X", "X3D2_PIPE3",
              "X3D2_FUSED_RK"):
        monkeypatch.delenv(k, raising=False)


def _rel(a, b):
    b = np.asarray(b)
    return np.abs(np.asarray(a) - b).max() / np.abs(b).max()


def _tgv(shape, dtype, jdtype, **prm):
    p = dict(Re=1600, time_intg="AB3", dt=1e-3, compensated=True) | prm
    kw = dict(monitor_path=None, verbose=False, keep_pressure=False)
    return (TGVCase(Mesh(shape, L, PER), SolverParams(**p), dtype=dtype,
                    device="cpu", **kw),
            JTGVCase(JMesh(shape, L, JPER), JSolverParams(**p),
                     dtype=jdtype, **kw))


# ---------------------------------------------------------------------------
# the integrator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_kahan_add_matches_x3d2_tpu(dtype):
    rng = np.random.default_rng(0)
    x, inc, c = (rng.standard_normal(1000).astype(dtype) * s
                 for s in (1.0, 1e-4, 1e-9))
    t, c2 = ti_mod.kahan_add(*(torch.from_numpy(a) for a in (x, inc, c)))
    jt, jc2 = jti_mod.kahan_add(*(jnp.asarray(a) for a in (x, inc, c)))
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(c2.numpy(), np.asarray(jc2))


def test_kahan_recovers_what_plain_float32_drops():
    x = torch.ones(4)
    c = torch.zeros(4)
    plain = torch.ones(4)
    jx, jc = jnp.ones(4, jnp.float32), jnp.zeros(4, jnp.float32)
    inc = 1e-8
    for _ in range(1000):
        x, c = ti_mod.kahan_add(x, torch.full((4,), inc), c)
        jx, jc = jti_mod.kahan_add(jx, jnp.full((4,), inc, jnp.float32), jc)
        plain = plain + inc
    assert torch.equal(plain, torch.ones(4))   # each 1e-8 is below 1 ulp
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    assert abs(float(x[0]) - (1 + 1e-5)) <= np.finfo(np.float32).eps


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("hist", ["state", "bfloat16"])
@pytest.mark.parametrize("istep", [1, 3])
def test_ab_step_compensated_matches_x3d2_tpu(dtype, hist, istep):
    rng = np.random.default_rng(1)
    shape = (8, 8, 8)
    f, r, c = ([rng.standard_normal(shape).astype(dtype) * s
                for _ in range(2)] for s in (1.0, 1.0, 1e-8))
    olds = [[(0.5 * rng.standard_normal(shape)).astype(dtype)
             for _ in range(2)] for _ in range(2)]
    jdt = jnp.bfloat16 if hist == "bfloat16" else None
    tdt = BF if hist == "bfloat16" else None
    dt = 1e-3
    jf, jo, jc = jti_mod.TimeIntegrator("AB3").ab_step_compensated(
        tuple(jnp.asarray(a) for a in f),
        tuple(tuple(jnp.asarray(o, jdt or o.dtype) for o in p)
              for p in olds),
        tuple(jnp.asarray(a) for a in c), jnp.asarray(istep),
        tuple(jnp.asarray(a) for a in r), dt)
    tf, to, tc = ti_mod.TimeIntegrator("AB3").ab_step_compensated(
        tuple(torch.from_numpy(a) for a in f),
        tuple(tuple(torch.from_numpy(o).to(tdt or torch.from_numpy(o).dtype)
                    for o in p) for p in olds),
        tuple(torch.from_numpy(a) for a in c), istep,
        tuple(torch.from_numpy(a) for a in r), dt)
    for a, b in zip(tf + tc, jf + jc):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for pa, pb in zip(to, jo):
        for a, b in zip(pa, pb):
            assert a.dtype == (tdt or a.dtype)
            np.testing.assert_array_equal(a.float().numpy(),
                                          np.asarray(b, np.float32))


# ---------------------------------------------------------------------------
# pressure_grads' slab branch
# ---------------------------------------------------------------------------

def test_pressure_grads_takes_the_slab_branch(monkeypatch):
    shape = (128,) * 3
    case, jcase = _tgv(shape, torch.float64, jnp.float64)
    ns = case.solver
    assert ns._slab is not None and ns._slab.x_perm is not None
    rng = np.random.default_rng(2)
    t = [rng.standard_normal(shape) for _ in range(3)]
    calls = []
    for fn in ("x_div3", "x_apply_parity", "x_apply", "x_gradsub3"):
        inner = getattr(sl, fn)
        monkeypatch.setattr(sl, fn, lambda *a, _f=inner, _n=fn, **k: (
            calls.append((_n, a[0], len(a) > 3 and a[3] is not None)
                         if isinstance(a[0], str) else (_n, None, False)),
            _f(*a, **k))[1])
    mid = sl.pressure_mid
    monkeypatch.setattr(sl, "pressure_mid", lambda *a, emit_q=True: (
        calls.append(("pressure_mid", emit_q, False)),
        mid(*a, emit_q=emit_q))[1])
    got = ns.pressure_grads(*(torch.from_numpy(a) for a in t),
                            keep_pressure=True)
    monkeypatch.undo()
    assert calls == [("x_div3", None, False), ("pressure_mid", True, False),
                     ("x_apply_parity", "gxs", False),
                     ("x_apply_parity", "gxi", False),
                     ("x_apply_parity", "gxi", False)]
    folded = ns.pressure_grads_folded(*(torch.from_numpy(a) for a in t),
                                      keep_pressure=True)
    want = jcase.solver.pressure_grads(*(jnp.asarray(a) for a in t),
                                       keep_pressure=True)
    for g, f, j in zip(got, folded, want):
        assert _rel(g.numpy(), f.numpy()) <= 1e-10
        assert _rel(g.numpy(), j) <= 1e-10
    # without keep_pressure p is the spectral solution q, in block-parity
    # order on the periodic axes: the folded chain's q permuted
    q = ns.pressure_grads(*(torch.from_numpy(a) for a in t),
                          keep_pressure=False)[3]
    qf = ns.pressure_grads_folded(*(torch.from_numpy(a) for a in t),
                                  keep_pressure=False)[3]
    pm = ns._slab
    qf = qf[pm.x_perm][:, pm.q_perm][:, :, pm.z_perm]
    assert _rel(q.numpy(), qf.numpy()) <= 1e-10


# ---------------------------------------------------------------------------
# compensated cases
# ---------------------------------------------------------------------------

def test_compensated_tgv_matches_x3d2_tpu_f64():
    shape = (128,) * 3
    case, jcase = _tgv(shape, torch.float64, jnp.float64)
    assert case._fused_ab is None and case.solver._slab is not None
    s, js = case.initial_state(), jcase.initial_state()
    assert [c.dtype for c in s["comp"]] == [torch.float64] * 3
    for _ in range(3):
        s, js = case.step(s), jcase._step(js)
    scale = np.abs(np.asarray(js["u"])).max()
    for k in ("u", "v", "w"):
        assert _rel(s[k].numpy(), js[k]) <= 1e-10, k
    for c, jc in zip(s["comp"], js["comp"]):
        assert np.abs(c.numpy() - np.asarray(jc)).max() <= 4 * EPS64 * scale


def test_compensated_species_bf16_history_and_handover(monkeypatch):
    """Two scalars and a bfloat16 history (the compensation covers phi as
    x3d2_tpu's does), 32^3 float64: x3d2_tpu's 6 steps against its 3
    continued by the port from the handed-over state (comp and the
    history as float32 arrays)."""
    monkeypatch.setenv("X3D2_BF16_OLDS", "1")
    case, jcase = _tgv((32,) * 3, torch.float64, jnp.float64, n_species=2,
                       pr_species=(0.7, 1.0))
    js = jcase.initial_state()
    for _ in range(3):
        js = jcase._step(js)
    handed = {k: np.asarray(js[k]) for k in ("u", "v", "w", "p", "istep",
                                             "phi")}
    handed["olds"] = tuple(tuple(np.asarray(o.astype(jnp.float32))
                                 for o in p) for p in js["olds"])
    handed["comp"] = tuple(np.asarray(c) for c in js["comp"])
    s = state_from_numpy(handed, device="cpu", olds_dtype=case._olds_dtype)
    assert len(s["comp"]) == 4 and s["comp"][3].shape == (2, 32, 32, 32)
    for _ in range(3):
        s, js = case.step(s), jcase._step(js)
    out = state_to_numpy(s)
    for k in ("u", "v", "w", "phi"):
        assert _rel(out[k], js[k]) <= 1e-12, k
    assert [o.dtype for p in s["olds"] for o in p] == [BF] * 8
    scale = np.abs(np.asarray(js["u"])).max()
    for c, jc in zip(out["comp"], js["comp"]):
        assert np.abs(c - np.asarray(jc)).max() <= 4 * EPS64 * scale


def test_compensated_cylinder_matches_x3d2_tpu_f64(monkeypatch):
    shape = (17, 128, 128)
    dom = (20.0, 10.0, 2.5)
    bcs = ((BC.DIRICHLET, BC.DIRICHLET),) + ((BC.PERIODIC, BC.PERIODIC),) * 2
    jbcs = ((JBC.DIRICHLET, JBC.DIRICHLET),) \
        + ((JBC.PERIODIC, JBC.PERIODIC),) * 2
    cfg = config.Config.from_file(str(CYL_EXAMPLE))
    jcfg = JConfig.from_file(str(CYL_EXAMPLE))
    for c in (cfg, jcfg):
        c.cylinder.inlet_noise = (0.0, 0.0, 0.0)
        c.solver.compensated = True
    mask = ibm.cylinder_mask(Mesh(shape, dom, bcs))
    kw = dict(monitor_path=None, verbose=False, keep_pressure=False, seed=3)
    case = CylinderCase(Mesh(shape, dom, bcs), cfg.solver,
                        dtype=torch.float64, device="cpu",
                        case_cfg=cfg.cylinder, ibm_mask=mask, **kw)
    jcase = JCylinderCase(JMesh(shape, dom, jbcs), jcfg.solver,
                          dtype=jnp.float64, case_cfg=jcfg.cylinder,
                          ibm_mask=mask, **kw)
    assert case.solver._slab.x_perm is None and case._fused_ab is None
    js = jcase.initial_state()
    s = state_from_numpy({k: np.asarray(js[k]) for k in
                          ("u", "v", "w", "p", "istep")}
                         | {"olds": tuple(tuple(np.asarray(o) for o in p)
                                          for p in js["olds"]),
                            "comp": tuple(np.asarray(c)
                                          for c in js["comp"])},
                         device="cpu", seed=3)
    seen, xcalls = [], []
    inner = case_base.kahan_add
    monkeypatch.setattr(case_base, "kahan_add", lambda x, inc, c: (
        seen.append(c.clone()), inner(x, inc, c))[1])
    x_apply = sl.x_apply
    monkeypatch.setattr(sl, "x_apply", lambda name, f, pm, s_=None: (
        xcalls.append((name, s_ is not None)), x_apply(name, f, pm, s_))[1])
    for _ in range(3):
        s, js = case.step(s), jcase._step(js)
    monkeypatch.undo()
    for k in ("u", "v", "w"):
        assert _rel(s[k].numpy(), js[k]) <= 1e-10, k
    scale = np.abs(np.asarray(js["u"])).max()
    for c, jc in zip(s["comp"], js["comp"]):
        assert np.abs(c.numpy() - np.asarray(jc)).max() <= 4 * EPS64 * scale
    # per step: sx, ix, ix, then the gradients without the correction
    assert xcalls == [("sx", False), ("ix", False), ("ix", False),
                      ("gxs", False), ("gxi", False), ("gxi", False)] * 3
    # the projection's Kahan adds of the last two steps (u, v, w each):
    # the compensation a hook overwrote is 0, the rest carries roundings
    solid = torch.from_numpy(mask == 0)
    for cu in seen[3::3]:
        assert float(cu[0].abs().max()) == 0.0          # inflow plane
        assert float(cu[solid].abs().max()) == 0.0      # the body
        assert float(cu[1:-1][~solid[1:-1]].abs().max()) > 0.0


def test_compensated_branches():
    """Compensated AB steps unfused with a compensation per field (also
    where the fused chains are built); compensated RK takes the unfused RK
    branch and carries none (x3d2_tpu cases/base.py:131-135, :218-222,
    :316-325)."""
    shape = (128, 128, 256)
    ab, _ = _tgv(shape, torch.float32, jnp.float32)
    assert ab._fused_ab is None and ab.solver._sweeps is not None
    assert len(ab.initial_state()["comp"]) == 3
    rk, _ = _tgv(shape, torch.float32, jnp.float32, time_intg="RK3")
    assert rk._fused_rk is None and rk.solver._sweeps is not None
    assert "comp" not in rk.initial_state()
