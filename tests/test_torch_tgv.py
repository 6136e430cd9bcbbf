"""The port's slice as a whole: Taylor-Green AB3 against x3d2_tpu.

- 32^3 float64, 20 steps (unfused path: dense transeq + ab_step): the KE
  and enstrophy series agree to 1e-12 relative (the same float64 algebra,
  summed in another order).
- (128, 128, 256) float32, 3 steps: the port takes the xdiv sweep chain
  and the slab projection, as x3d2_tpu does at max(dims) <= 256 on its
  kernels (plain versions on the CPU), and with X3D2_XDIV_FUSED=0 the z,
  x, y chain and the pressure pipeline; x3d2_tpu runs its einsum step;
  <= 1e-5 on u, v, w, as tests/test_fused_ab.py:61.
- 128^3 float64 with keep_pressure=True, 4 steps: the slab projection
  forms the physical pressure. KE and enstrophy agree to 1e-12 relative, p
  to 1e-10 * scale; a keep_pressure=True state handed over from x3d2_tpu
  after 2 steps continues to the same u, v, w (1e-12) and p (1e-10).
- A state handed over from x3d2_tpu after 3 steps and continued 3 steps in
  the port matches x3d2_tpu's own 6 steps to 1e-12 (float64, 32^3): the AB
  history crosses intact.
"""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax
import jax.numpy as jnp

from x3d2_tpu.common import BC as JBC
from x3d2_tpu.mesh import Mesh as JMesh
from x3d2_tpu.cases import SolverParams as JSolverParams
from x3d2_tpu.cases import TGVCase as JTGVCase

from x3d2_tpu_torch.common import BC
from x3d2_tpu_torch.mesh import Mesh
from x3d2_tpu_torch.cases import SolverParams, TGVCase
from x3d2_tpu_torch.convert import state_from_numpy, state_to_numpy
from x3d2_tpu_torch.ops import pressure_slab

# one thread for torch and for numpy's BLAS: the suite runs several workers
# on one machine, and multi-threaded BLAS calls in each of them, spinning on
# oversubscribed cores, made these tests many times slower there
torch.set_num_threads(1)
threadpool_limits(1, user_api="blas")


L = (2 * np.pi,) * 3


def _cases(shape, tdtype, jdtype, keep_pressure=False):
    mesh = Mesh(shape, L, ((BC.PERIODIC, BC.PERIODIC),) * 3)
    jmesh = JMesh(shape, L, ((JBC.PERIODIC, JBC.PERIODIC),) * 3)
    kw = dict(monitor_path=None, verbose=False, keep_pressure=keep_pressure)
    case = TGVCase(mesh, SolverParams(Re=1600, time_intg="AB3", dt=1e-3),
                   dtype=tdtype, device="cpu", **kw)
    jcase = JTGVCase(jmesh, JSolverParams(Re=1600, time_intg="AB3",
                                          dt=1e-3), dtype=jdtype, **kw)
    return case, jcase


def _jax_to_numpy(state):
    return {"u": np.asarray(state["u"]), "v": np.asarray(state["v"]),
            "w": np.asarray(state["w"]), "p": np.asarray(state["p"]),
            "istep": int(state["istep"]),
            "olds": tuple(tuple(np.asarray(o) for o in per)
                          for per in state["olds"])}


def test_tgv_series_match_f64():
    case, jcase = _cases((32,) * 3, torch.float64, jnp.float64)
    assert case._fused_ab is None   # 32 is below the sweep kernel's tiles
    case.run(n_iters=20, n_output=1)
    jcase.run(n_iters=20, n_output=1)
    got = np.array(case.monitor.rows)
    want = np.array(jcase.monitor.rows)
    assert got.shape == want.shape == (21, 5)
    for col in (1, 4):   # enstrophy, ke
        np.testing.assert_allclose(got[:, col], want[:, col], rtol=1e-12,
                                   atol=0)


_EINSUM_3_STEPS = {}


def _three_steps_match(case, jcase):
    s = case.initial_state()
    for _ in range(3):   # AB3 startup rows istep 1, 2, 3
        s = case.step(s)
    # x3d2_tpu's einsum step reads no X3D2_XDIV_FUSED: one run of it serves
    # both chains of the port
    if not _EINSUM_3_STEPS:
        js = jcase.initial_state()
        for _ in range(3):
            js = jcase._step(js)
        _EINSUM_3_STEPS.update({k: np.asarray(js[k]) for k in "uvw"})
    for k in ("u", "v", "w"):
        err = np.abs(s[k].numpy() - _EINSUM_3_STEPS[k]).max()
        assert err < 1e-5, f"{k}: {err:.2e}"


def test_tgv_fused_path_matches_einsum_step_f32(monkeypatch):
    monkeypatch.delenv("X3D2_XDIV_FUSED", raising=False)
    case, jcase = _cases((128, 128, 256), torch.float32, jnp.float32)
    assert case._fused_ab is not None and case.solver._pipe is not None
    # max(dims) <= 256: the xdiv chain feeds the slab projection
    assert case._ab_is_xdiv and case.solver._slab is not None
    calls = []
    mid = pressure_slab.pressure_mid
    monkeypatch.setattr(pressure_slab, "pressure_mid", lambda *a, **k: (
        calls.append(k), mid(*a, **k))[1])
    _three_steps_match(case, jcase)
    assert calls == [{"emit_q": False}] * 3


def test_tgv_xdiv_switch_off_takes_pipeline_f32(monkeypatch):
    monkeypatch.setenv("X3D2_XDIV_FUSED", "0")
    case, jcase = _cases((128, 128, 256), torch.float32, jnp.float32)
    assert case._fused_ab is not None and not case._ab_is_xdiv
    calls = []
    pipe = case.solver._pipe
    object.__setattr__(case.solver, "_pipe",
                       lambda *a: (calls.append(1), pipe(*a))[1])
    _three_steps_match(case, jcase)
    assert len(calls) == 3


def test_unported_switches_still_raise(monkeypatch):
    # X3D2_PIPE3 routes between ported branches (tests/test_torch_bf16.py),
    # and the mid cut at q is ported too (the name is from when it
    # raised). X3D2_MID_SPLIT is read where the slab's mid runs, as
    # x3d2_tpu reads it (solver.py:512): a grid without the slab runs as
    # without it, and the slab grid's mid takes the two halves, with the
    # merged mid's bits
    monkeypatch.setenv("X3D2_MID_SPLIT", "1")
    case, _ = _cases((32,) * 3, torch.float64, jnp.float64)
    assert case.solver._slab is None
    case.run(n_iters=1, n_output=1)
    case, _ = _cases((128, 128, 256), torch.float32, jnp.float32,
                     keep_pressure=True)
    rng = np.random.default_rng(6)
    f = [torch.from_numpy(rng.standard_normal((128, 128, 256))
                          .astype(np.float32)) for _ in range(3)]
    split = case.solver.pressure_correction(*f)
    monkeypatch.delenv("X3D2_MID_SPLIT")
    merged = case.solver.pressure_correction(*f)
    assert all(torch.equal(a, b) for a, b in zip(split, merged))


@pytest.fixture(scope="module")
def keep_pressure_runs():
    """x3d2_tpu's float64 128^3 run with keep_pressure=True: the state
    after 2 steps (numpy) and after 4, with the monitoring rows."""
    case, jcase = _cases((128,) * 3, torch.float64, jnp.float64,
                         keep_pressure=True)
    js = jcase.run(n_iters=2, n_output=1)
    handed = _jax_to_numpy(js)
    js = jcase.run(n_iters=2, state=js, n_output=1)
    return case, handed, _jax_to_numpy(js), np.array(jcase.monitor.rows)


def test_tgv_keep_pressure_matches_f64(keep_pressure_runs):
    case, _, want, rows = keep_pressure_runs
    assert case._fused_ab is None and case.solver._slab is not None
    s = case.run(n_iters=4, n_output=1)
    got = np.array(case.monitor.rows)
    assert got.shape == rows.shape == (5, 5)
    for col in (1, 4):   # enstrophy, ke
        np.testing.assert_allclose(got[:, col], rows[:, col], rtol=1e-12,
                                   atol=0)
    p = s["p"].numpy()
    assert np.abs(want["p"]).max() > 0
    np.testing.assert_allclose(p, want["p"], rtol=0,
                               atol=1e-10 * np.abs(want["p"]).max())


def test_keep_pressure_state_handover_continues_exactly(keep_pressure_runs):
    case, handed, want, _ = keep_pressure_runs
    s = state_from_numpy(handed, device="cpu")
    assert s["istep"] == 3 and float(s["p"].abs().max()) > 0
    got = state_to_numpy(case.run(n_iters=2, state=s))
    assert got["istep"] == want["istep"] == 5
    for k in ("u", "v", "w"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-12)
    np.testing.assert_allclose(got["p"], want["p"], rtol=0,
                               atol=1e-10 * np.abs(want["p"]).max())


def test_state_handover_from_x3d2_tpu_continues_exactly():
    case, jcase = _cases((32,) * 3, torch.float64, jnp.float64)
    js = jcase.run(n_iters=3)
    handed = _jax_to_numpy(js)
    js = jcase.run(n_iters=3, state=js)
    s = state_from_numpy(handed, device="cpu")
    assert s["istep"] == 4 and len(s["olds"][0]) == 2
    s = case.run(n_iters=3, state=s)
    got = state_to_numpy(s)
    want = _jax_to_numpy(jax.device_get(js))
    assert got["istep"] == want["istep"] == 7
    for k in ("u", "v", "w"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-12)
    for per_g, per_w in zip(got["olds"], want["olds"]):
        for g, w in zip(per_g, per_w):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-12)
