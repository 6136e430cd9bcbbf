"""The dense transport sweep (x3d2_tpu's v1 kernel) and the port's branch
choice against x3d2_tpu, on the CPU.

- The plain version of each direction against x3d2_tpu's
  make_fused_transeq (pallas_transeq.py:124) in interpret mode, float64 at
  (32, 128, 128), bs=16: <= 1e-11 * scale, the bound of
  tests/test_pallas_transeq.py:52.
- The branch choice: over the grids of the port's driven paths and the
  cylinder's, the transport (sweeps / dense sweeps / dense products) and
  the projection (pipeline / slab with a parity or a dense x stage / the
  folded chain) the port takes equal what x3d2_tpu's gates give
  (transeq_v3_supported, fused_transeq_supported, slab_pressure_supported,
  pipe3_supported, the slab's x_perm); the step's chain on the grids of
  the earlier paths (512^3 z, x, y; 256^3 and (128, 128, 256) the xdiv
  chain) is unchanged, and at 128^3 the step is the unfused AB one.
- TGV 128^3 AB3 float64, 3 steps from one numpy state: the port (dense
  sweeps, the pipeline's plain versions, ab_step) against x3d2_tpu (its
  einsum step on the CPU): <= 1e-10 relative in u, v, w.
- CPU tensors take the plain version and count no launch; another device
  raises.
"""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax.numpy as jnp

from x3d2_tpu.cases import SolverParams as JSolverParams
from x3d2_tpu.cases import TGVCase as JTGVCase
from x3d2_tpu.common import BC as JBC
from x3d2_tpu.mesh import Mesh as JMesh
from x3d2_tpu.ops.pallas_kernels import transeq_v3_supported
from x3d2_tpu.ops.pallas_poisson import (make_pressure_slab,
                                         pipe3_supported as j_pipe3,
                                         slab_pressure_supported)
from x3d2_tpu.ops.pallas_transeq import (fused_transeq_supported,
                                         make_fused_transeq)
from x3d2_tpu.solver import NavierStokes as JNavierStokes

from x3d2_tpu_torch.cases import SolverParams, TGVCase
from x3d2_tpu_torch.common import BC
from x3d2_tpu_torch.convert import state_from_numpy
from x3d2_tpu_torch.mesh import Mesh
from x3d2_tpu_torch.ops import transeq_dense as td
from x3d2_tpu_torch.ops.dirops import build_axis_ops
from x3d2_tpu_torch.solver import NavierStokes, projection_route

# one thread for torch and for numpy's BLAS: the suite runs several workers
# on one machine, and multi-threaded BLAS calls in each of them, spinning on
# oversubscribed cores, made these tests many times slower there
torch.set_num_threads(1)
threadpool_limits(1, user_api="blas")

L = (2 * np.pi,) * 3
NU = 1 / 1600
PER = ((BC.PERIODIC, BC.PERIODIC),) * 3
JPER = ((JBC.PERIODIC, JBC.PERIODIC),) * 3
CYL = ((BC.DIRICHLET, BC.DIRICHLET),) + PER[1:]
JCYL = ((JBC.DIRICHLET, JBC.DIRICHLET),) + JPER[1:]
L_CYL = (20.0, 10.0, 2.5)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_plain_matches_x3d2_tpu_v1_f64(axis):
    shape = (32, 128, 128)
    mesh = Mesh(shape, L, PER)
    ops = build_axis_ops(mesh, axis, dtype=torch.float64, device="cpu")
    mats = td.build_dense_mats(ops, NU, axis, device="cpu")
    rng = np.random.default_rng(axis)
    comps = [rng.standard_normal(shape) for _ in range(3)]
    got = td.transeq_dense(*(torch.from_numpy(c) for c in comps), mats)
    jns = JNavierStokes.build(JMesh(shape, L, JPER), NU, dtype=jnp.float64)
    fn = make_fused_transeq(jns.ops[axis], NU, axis, shape, bs=16,
                            interpret=True)
    want = fn(*(jnp.asarray(c) for c in comps))
    for g, w in zip(got, want):
        w = np.asarray(w)
        err = np.abs(g.numpy() - w).max() / np.abs(w).max()
        assert err <= 1e-11, err


def test_sum_and_device_rules():
    """make_transeq_dense sums the three directions; CPU tensors count no
    launch; a device that is neither CPU nor CUDA raises."""
    shape = (32, 128, 128)
    ns = NavierStokes.build(Mesh(shape, L, PER), NU, dtype=torch.float64,
                            device="cpu")
    assert ns._transport == "v1" and ns._v1 is not None
    rng = np.random.default_rng(7)
    comps = [torch.from_numpy(rng.standard_normal(shape)) for _ in range(3)]
    td.reset_launch_counts()
    got = ns.transeq(*comps)
    assert td.launch_counts() == {}
    parts = [td.transeq_dense_plain(*comps, m) for m in ns._v1.mats]
    for c in range(3):
        assert torch.equal(got[c], parts[0][c] + parts[1][c] + parts[2][c])
    m = torch.empty(shape, device="meta")
    with pytest.raises(ValueError, match="no dense transport sweep"):
        td.transeq_dense(m, m, m, ns._v1.mats[0])


# (vertex grid, boundary conditions, domain)
GRIDS = {
    "128^3": ((128,) * 3, PER, JPER, L),
    "256x256x128": ((256, 256, 128), PER, JPER, L),
    "128x128x256": ((128, 128, 256), PER, JPER, L),
    "256^3": ((256,) * 3, PER, JPER, L),
    "512^3": ((512,) * 3, PER, JPER, L),
    "cylinder 513x256x128": ((513, 256, 128), CYL, JCYL, L_CYL),
    "cylinder 257x128x32": ((257, 128, 32), CYL, JCYL, L_CYL),
    "cylinder 65x128x128": ((65, 128, 128), CYL, JCYL, L_CYL),
    "cylinder 17x128x128": ((17, 128, 128), CYL, JCYL, L_CYL),
}
# what the earlier slices' paths and this slice's take (transport,
# projection, x stage)
EXPECTED = {
    "128^3": ("v1", "pipe3", "parity"),
    "256x256x128": ("v1", "pipe3", "parity"),
    "128x128x256": ("sweeps", "pipe3", "parity"),
    "256^3": ("sweeps", "pipe3", "parity"),
    "512^3": ("sweeps", "pipe3", "parity"),
    "cylinder 513x256x128": ("dense", "slab", "dense"),
    "cylinder 257x128x32": ("dense", None, None),
    "cylinder 65x128x128": ("dense", "slab", "dense"),
    "cylinder 17x128x128": ("dense", "slab", "dense"),
}


@pytest.mark.parametrize("name", list(GRIDS))
def test_branch_choice_matches_x3d2_tpu(name):
    shape, bcs, jbcs, dom = GRIDS[name]
    ns = NavierStokes.build(Mesh(shape, dom, bcs), NU, dtype=torch.float32,
                            device="cpu")
    jns = JNavierStokes.build(JMesh(shape, dom, jbcs), NU,
                              dtype=jnp.float32)
    want_t = ("sweeps" if transeq_v3_supported(jns, shape)
              else "v1" if fused_transeq_supported(jns, shape) else "dense")
    want_p = None
    want_x = None
    if slab_pressure_supported(jns):
        want_p = "pipe3" if j_pipe3(jns) else "slab"
        slab = make_pressure_slab(jns, terms=3, interpret=True)
        want_x = "parity" if slab[3].x_perm is not None else "dense"
    got_x = None
    if ns._slab is not None:
        got_x = "parity" if ns._slab.x_perm is not None else "dense"
        if want_x == "parity":
            np.testing.assert_array_equal(ns._slab.x_perm,
                                          slab[3].x_perm)
    got = (ns._transport, projection_route(ns), got_x)
    assert got == (want_t, want_p, want_x) == EXPECTED[name]
    assert ns._projection_gap is None and ns.transport_gap() is None
    assert (ns._sweeps is not None) == (want_t == "sweeps")
    assert (ns._v1 is not None) == (want_t == "v1")
    assert (ns._pipe is not None) == (want_p == "pipe3")


@pytest.mark.parametrize("shape,chain", [((512,) * 3, "zxy"),
                                         ((256,) * 3, "xdiv"),
                                         ((128, 128, 256), "xdiv"),
                                         ((256, 256, 128), "unfused"),
                                         ((128,) * 3, "unfused")])
def test_step_chain_by_grid(shape, chain):
    """The AB3 step's branch, keep_pressure=False: the earlier paths keep
    their chains; on the dense-sweep grids x3d2_tpu's fused AB gate (its v3
    sweeps) fails and the step is the unfused one, with the pipeline."""
    case = TGVCase(Mesh(shape, L, PER), SolverParams(dt=1e-3),
                   dtype=torch.float32, monitor_path=None, verbose=False,
                   keep_pressure=False, device="cpu")
    took = ("unfused" if case._fused_ab is None
            else "xdiv" if case._ab_is_xdiv else "zxy")
    assert took == chain
    assert case.solver._pipe is not None


def test_tgv_128_matches_x3d2_tpu_f64():
    shape = (128,) * 3
    params = dict(Re=1600, time_intg="AB3", dt=1e-3)
    kw = dict(monitor_path=None, verbose=False, keep_pressure=False)
    case = TGVCase(Mesh(shape, L, PER), SolverParams(**params),
                   dtype=torch.float64, device="cpu", **kw)
    jcase = JTGVCase(JMesh(shape, L, JPER), JSolverParams(**params),
                     dtype=jnp.float64, **kw)
    assert case.solver._v1 is not None and case._fused_ab is None
    js = jcase.initial_state()
    s = state_from_numpy({k: np.asarray(js[k]) for k in
                          ("u", "v", "w", "p", "istep")}
                         | {"olds": tuple(tuple(np.asarray(o) for o in per)
                                          for per in js["olds"])},
                         device="cpu")
    for _ in range(3):
        s = case.step(s)
        js = jcase._step(js)
    for k in ("u", "v", "w"):
        want = np.asarray(js[k])
        err = np.abs(s[k].numpy() - want).max() / np.abs(want).max()
        assert err <= 1e-10, f"{k}: {err:.2e}"
