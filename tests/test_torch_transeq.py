"""The transport sweeps' plain versions against float64 references, at the
smallest shape the sweeps tile, (128, 128, 256), float32 on the CPU.

- Each sweep vs the dense float64 operator RHS: <= 3e-5 * scale, the
  bound x3d2_tpu holds its default-mode kernels to
  (tests/test_pallas_v3.py:63); here it covers f32 rounding and the band
  truncation at 1e-6 of the largest operator entry.
- The fused transport + AB chain vs x3d2_tpu's dense transeq followed by
  TimeIntegrator.ab_step, for the startup rows istep 1, 2, 3: <= 1e-5,
  as tests/test_fused_ab.py:52-61. The reference runs in float64, so the
  difference is the port's own f32 error.
"""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax.numpy as jnp

from x3d2_tpu.common import BC as JBC
from x3d2_tpu.mesh import Mesh as JMesh
from x3d2_tpu.solver import NavierStokes as JNavierStokes
from x3d2_tpu.time_integrators import TimeIntegrator as JTimeIntegrator

from x3d2_tpu_torch.common import BC, DataLoc
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


@pytest.fixture(scope="module")
def setup():
    mesh = Mesh(SHAPE, L, ((BC.PERIODIC, BC.PERIODIC),) * 3)
    ns = NavierStokes.build(mesh, NU, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(0)
    comps = tuple(rng.standard_normal(SHAPE).astype(np.float32)
                  for _ in range(3))
    return mesh, ns, comps


def _dir_reference64(ns, comps, axis):
    """Dense float64 RHS of one direction (as tests/test_pallas_v3.py)."""
    o = ns.ops[axis]
    c64 = [np.asarray(q, np.float64) for q in comps]
    conv = c64[axis]
    out = []
    for c in range(3):
        if c == axis:
            d1, dd, d2 = o.der1st, o.der1st_sym, o.der2nd
        else:
            d1, dd, d2 = o.der1st_sym, o.der1st, o.der2nd_sym

        def ap(M, f):
            return np.moveaxis(np.tensordot(M, f, axes=([1], [axis])), 0,
                               axis)

        q = c64[c]
        out.append(-0.5 * (conv * ap(d1.M64, q) + ap(dd.M64, q * conv))
                   + NU * ap(d2.M64, q))
    return out


def test_supported(setup):
    _, ns, _ = setup
    assert ts.transeq_sweep_supported(ns, SHAPE)
    assert not ts.transeq_sweep_supported(ns, (32, 32, 32))


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_sweep_plain_matches_f64(setup, axis):
    _, ns, comps = setup
    fn = ts.make_transeq_sweep(ns.ops[axis], NU, axis, SHAPE, device="cpu")
    got = fn(*(torch.from_numpy(q) for q in comps))
    for g, want in zip(got, _dir_reference64(ns, comps, axis)):
        scale = np.abs(want).max()
        err = np.abs(g.numpy().astype(np.float64) - want).max()
        assert err < 3e-5 * scale, f"{err:.2e} vs {scale:.2e}"


@pytest.fixture(scope="module")
def ab_inputs(setup):
    mesh, _, _ = setup
    X, Y, Z = mesh.coord_grids(DataLoc.VERT)
    u = np.sin(X) * np.cos(Y) * np.cos(Z)
    v = -np.cos(X) * np.sin(Y) * np.cos(Z)
    w = 0.1 * np.sin(X + 2 * Y) * np.cos(Z)
    rng = np.random.default_rng(1)
    fields = tuple(np.asarray(f, np.float32) for f in (u, v, w))
    olds = tuple(tuple((0.1 * rng.standard_normal(SHAPE)).astype(np.float32)
                       for _ in range(2)) for _ in range(3))
    jmesh = JMesh(SHAPE, L, ((JBC.PERIODIC, JBC.PERIODIC),) * 3)
    jns = JNavierStokes.build(jmesh, NU, dtype=jnp.float64)
    jf = tuple(jnp.asarray(f, jnp.float64) for f in fields)
    jrhs = jns.transeq(*jf)
    return fields, olds, jf, jrhs


@pytest.mark.parametrize("istep", [1, 2, 3])
def test_fused_ab_chain_matches_transeq_ab_step(setup, ab_inputs, istep):
    _, ns, _ = setup
    fields, olds, jf, jrhs = ab_inputs
    ti = TimeIntegrator("AB3")
    chain = ts.make_fused_transeq_ab(ns.ops, NU, SHAPE, ti.nolds,
                                     device="cpu")
    t_olds = tuple(tuple(torch.from_numpy(o.copy()) for o in per)
                   for per in olds)
    (un, vn, wn), rhs = chain(*(torch.from_numpy(f) for f in fields),
                              t_olds, ti.ab_row(istep, DT))
    jolds = tuple(tuple(jnp.asarray(o, jnp.float64) for o in per)
                  for per in olds)
    want, _ = JTimeIntegrator("AB3").ab_step(jf, jolds, istep, jrhs, DT)
    for g, e in zip((un, vn, wn), want):
        err = np.abs(g.numpy() - np.asarray(e)).max()
        assert err < 1e-5, f"u': {err:.2e}"
    for g, e in zip(rhs, jrhs):
        e = np.asarray(e)
        err = np.abs(g.numpy() - e).max()
        assert err < 1e-5 * np.abs(e).max(), f"rhs: {err:.2e}"
    # the chain wrote u' over the oldest history buffers (the rotation
    # drops them), as x3d2_tpu's aliasing does
    assert all(t_olds[c][-1] is o for c, o in enumerate((un, vn, wn)))


def test_cpu_sweeps_never_count_launches(setup):
    _, ns, comps = setup
    ts.reset_launch_counts()
    fn = ts.make_transeq_sweep(ns.ops[2], NU, 2, SHAPE, device="cpu")
    fn(*(torch.from_numpy(q) for q in comps))
    assert ts.launch_counts() == {}
