"""The port's projection against x3d2_tpu's, in float64 on the CPU.

Both packages run the same transform-folded matrix chain, so the
corrected velocity agrees to 1e-12 (rounding of O(1) values through ~7
contractions of 32 terms). The spectral solve is exactly consistent with
the compact div/grad, so the divergence after projection and the
div(grad(solve(f))) roundtrip reach 1e-10, the bound of
tests/test_poisson.py.
"""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax.numpy as jnp

from x3d2_tpu.common import BC as JBC
from x3d2_tpu.mesh import Mesh as JMesh
from x3d2_tpu.solver import NavierStokes as JNavierStokes

from x3d2_tpu_torch.common import BC, DataLoc
from x3d2_tpu_torch.mesh import Mesh
from x3d2_tpu_torch.solver import NavierStokes

# one thread for torch and for numpy's BLAS: the suite runs several workers
# on one machine, and multi-threaded BLAS calls in each of them, spinning on
# oversubscribed cores, made these tests many times slower there
torch.set_num_threads(1)
threadpool_limits(1, user_api="blas")


N = 32
L = (2 * np.pi,) * 3
PER = ((BC.PERIODIC, BC.PERIODIC),) * 3


@pytest.fixture(scope="module")
def solvers():
    mesh = Mesh((N,) * 3, L, PER)
    jmesh = JMesh((N,) * 3, L, ((JBC.PERIODIC, JBC.PERIODIC),) * 3)
    return (NavierStokes.build(mesh, 1 / 1600, dtype=torch.float64,
                               device="cpu"),
            JNavierStokes.build(jmesh, 1 / 1600, dtype=jnp.float64))


def _fields(seed=3):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((N,) * 3) for _ in range(3))


@pytest.mark.parametrize("keep_pressure", [False, True])
def test_pressure_correction_matches(solvers, keep_pressure):
    ns, jns = solvers
    f = _fields()
    got = ns.pressure_correction(*(torch.from_numpy(a) for a in f),
                                 keep_pressure=keep_pressure)
    want = jns.pressure_correction(*(jnp.asarray(a) for a in f),
                                   keep_pressure=keep_pressure)
    for g, e in zip(got, want):
        e = np.asarray(e)
        np.testing.assert_allclose(g.numpy(), e, rtol=0,
                                   atol=1e-12 * max(1.0, np.abs(e).max()))


def test_divergence_free_after_projection(solvers):
    ns, _ = solvers
    u, v, w, _ = ns.pressure_correction(
        *(torch.from_numpy(a) for a in _fields(4)), keep_pressure=False)
    assert float(ns.divergence_v2p(u, v, w).abs().max()) < 1e-10


@pytest.mark.parametrize("bcs_x,bcs_y", [
    (BC.PERIODIC, BC.PERIODIC),    # 000
    (BC.PERIODIC, BC.NEUMANN),     # 010
    (BC.NEUMANN, BC.PERIODIC),     # 100
    (BC.NEUMANN, BC.NEUMANN),      # 110
])
def test_matmul_poisson_roundtrip(bcs_x, bcs_y):
    bcs = ((bcs_x, bcs_x), (bcs_y, bcs_y), (BC.PERIODIC, BC.PERIODIC))
    nv = (N if bcs_x == BC.PERIODIC else N + 1,
          N if bcs_y == BC.PERIODIC else N + 1, N)
    mesh = Mesh(nv, L, bcs)
    ns = NavierStokes.build(mesh, 1.0, dtype=torch.float64, device="cpu")
    X, Y, Z = mesh.coord_grids(DataLoc.CELL)
    px, py = bcs_x == BC.PERIODIC, bcs_y == BC.PERIODIC
    for mx, my, mz in ((1, 1, 1), (2, 1, 3), (5, 3, 7)):
        fx = np.cos((2 if px else 1) * np.pi * mx * X / L[0])
        fy = np.cos((2 if py else 1) * np.pi * my * Y / L[1])
        f = fx * fy * np.cos(2 * np.pi * mz * Z / L[2])
        f = f - f.mean()
        p = ns.poisson(torch.from_numpy(f))
        err = ns.divergence_v2p(*ns.gradient_p2v(p)).numpy() - f
        err -= err.mean()
        assert np.abs(err).max() < 1e-10, (mx, my, mz)
