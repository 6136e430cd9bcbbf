"""The port's slice as a whole: Taylor-Green AB3 against x3d2_tpu.

- 32^3 float64, 20 steps (unfused path: dense transeq + ab_step): the KE
  and enstrophy series agree to 1e-12 relative (the same float64 algebra,
  summed in another order).
- (128, 128, 256) float32, 3 steps: the port takes its fused sweep chain
  and its pressure pipeline (plain versions on the CPU), x3d2_tpu its
  einsum step; <= 1e-5 on u, v, w, as tests/test_fused_ab.py:61.
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

# one thread for torch and for numpy's BLAS: the suite runs several workers
# on one machine, and multi-threaded BLAS calls in each of them, spinning on
# oversubscribed cores, made these tests many times slower there
torch.set_num_threads(1)
threadpool_limits(1, user_api="blas")


L = (2 * np.pi,) * 3


def _cases(shape, tdtype, jdtype):
    mesh = Mesh(shape, L, ((BC.PERIODIC, BC.PERIODIC),) * 3)
    jmesh = JMesh(shape, L, ((JBC.PERIODIC, JBC.PERIODIC),) * 3)
    kw = dict(monitor_path=None, verbose=False, keep_pressure=False)
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


def test_tgv_fused_path_matches_einsum_step_f32():
    shape = (128, 128, 256)
    case, jcase = _cases(shape, torch.float32, jnp.float32)
    assert case._fused_ab is not None and case.solver._pipe is not None
    s = case.initial_state()
    js = jcase.initial_state()
    for _ in range(3):   # AB3 startup rows istep 1, 2, 3
        s = case.step(s)
        js = jcase._step(js)
    for k in ("u", "v", "w"):
        err = np.abs(s[k].numpy() - np.asarray(js[k])).max()
        assert err < 1e-5, f"{k}: {err:.2e}"


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
