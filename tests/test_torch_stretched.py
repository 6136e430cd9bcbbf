"""The stretched-y Poisson solve (x3d2_tpu_torch/ops/stretched_poisson.py and
the stretched branch of ops/matmul_poisson.py) against x3d2_tpu's, float64
on the CPU, on tests/test_stretched.py's mesh (32 x 33 x 32, walls in y,
beta 0.259065151) for the three stretchings.

- The numpy assembly (build_stretch_matrices, extract_pencils,
  eigen_resolve, factorize) on the same inputs, and the matmul solve's
  folded transforms and diagonal tables, against x3d2_tpu's: 1e-13 of the
  largest entry (the same float64 code; eigen_resolve's LAPACK calls run
  with one BLAS thread in both, so only the order of the folds' matrix
  products differs).
- The div(grad(solve f)) roundtrip on the eigen route and on the scan route
  (X3D2_STRETCH_EIG=0, read when the solver is built): 1e-10, the JAX
  test's own bound (tests/test_stretched.py:45), on its smooth field and
  on the divergence of a random velocity field (a field in the operator's
  range: white noise is not, its (Nyquist x, Nyquist z) line has no
  solution).
- Eigen against scan on white noise, up to the gauge constant: 1e-9 of the
  largest value (tests/test_stretched.py:100).
- The port's poisson(f) and pressure_correction (velocities and physical
  pressure) against x3d2_tpu's on both routes: 1e-12 of the largest value
  (the same float64 algebra in another order).
- Both routes run the unfused or the transform-folded chain with no
  kernel gate: _projection_gap is None, so the card does not raise.
"""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax.numpy as jnp

from x3d2_tpu.common import BC as JBC
from x3d2_tpu.mesh import Mesh as JMesh
from x3d2_tpu.ops import stretched_poisson as jsp
from x3d2_tpu.solver import NavierStokes as JNavierStokes

from x3d2_tpu_torch.common import BC, DataLoc
from x3d2_tpu_torch.mesh import Mesh
from x3d2_tpu_torch.ops import stretched_poisson as sp
from x3d2_tpu_torch.ops.fft_poisson import _interp_transfer, wave_numbers
from x3d2_tpu_torch.solver import NavierStokes

torch.set_num_threads(1)
threadpool_limits(1, user_api="blas")

DIMS = (32, 33, 32)
L = (4.0, 2.0, 2.0)
BETA = 0.259065151
STRETCHINGS = ["top-bottom", "centred", "bottom"]
ROUTES = ["eigen", "scan"]


def _bcs(B):
    return ((B.PERIODIC, B.PERIODIC), (B.DIRICHLET, B.DIRICHLET),
            (B.PERIODIC, B.PERIODIC))


def _meshes(stretching, dims=DIMS):
    kw = dict(stretching=("uniform", stretching, "uniform"),
              beta=(1.0, BETA, 1.0))
    return Mesh(dims, L, _bcs(BC), **kw), JMesh(dims, L, _bcs(JBC), **kw)


def _build(stretching, route, monkeypatch, dims=DIMS):
    if route == "scan":
        monkeypatch.setenv("X3D2_STRETCH_EIG", "0")
    m, jm = _meshes(stretching, dims)
    ns = NavierStokes.build(m, 1.0, dtype=torch.float64, device="cpu")
    jns = JNavierStokes.build(jm, nu=1.0, dtype=jnp.float64)
    monkeypatch.delenv("X3D2_STRETCH_EIG", raising=False)
    po = ns.poisson
    assert (po.stretch_solver is None) == (route == "eigen")
    assert po.stretch_resolved == (route == "eigen")
    assert (jns.poisson.stretch_solver is None) == (route == "eigen")
    return m, ns, jns


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _tables(ns):
    """The inputs x3d2_tpu's MatmulPoisson passes the assembly
    (matmul_poisson.py:106-114): transfer functions T, k1, k2 per axis."""
    m = ns.mesh
    tabs = [wave_numbers(m.global_cell_dims[a], m.L[a], m.d[a],
                         m.periodic[a], o.stagder_v2p.a, o.stagder_v2p.b,
                         o.stagder_v2p.alpha) for a, o in enumerate(ns.ops)]
    T = [_interp_transfer(o.interpl_v2p, tabs[a][2], m.d[a])
         for a, o in enumerate(ns.ops)]
    return T, [t[3] for t in tabs], [t[4] for t in tabs]


@pytest.mark.parametrize("stretching", STRETCHINGS)
def test_assembly_matches_x3d2_tpu(stretching, monkeypatch):
    m, ns, jns = _build(stretching, "eigen", monkeypatch)
    T, k1, k2 = _tables(ns)
    g = m.geo[1]
    nx, ny, nz = m.global_cell_dims
    args = (nx, ny, nz, T[0], T[1], T[2], k1[0], k1[1], k1[2], k2[0], k2[2],
            m.L[1], g.alpha, g.beta, g.stretching)
    a_sets, offs, inc = sp.build_stretch_matrices(*args)
    j_sets, joffs, jinc = jsp.build_stretch_matrices(*args)
    assert (offs, inc) == (joffs, jinc) == (([0], 1) if stretching == "bottom"
                                            else ([0, 1], 2))
    for A, J in zip(a_sets, j_sets):
        assert _rel(A, J) <= 1e-13
        fa, fj = sp.factorize(A), jsp.factorize(J)
        for k in fj:
            assert _rel(fa[k], fj[k]) <= 1e-13, k
    pargs = (ny, T[1], k1[1], m.L[1], g.alpha, g.beta, g.stretching)
    for (d, B), (jd, jB) in zip(sp.extract_pencils(*pargs)[0],
                                jsp.extract_pencils(*pargs)[0]):
        assert _rel(d, jd) <= 1e-13 and _rel(B, jB) <= 1e-13
    for x, jx in zip(sp.eigen_resolve(*pargs), jsp.eigen_resolve(*pargs)):
        assert _rel(x, jx) <= 1e-13
    po, jpo = ns.poisson, jns.poisson
    for a in range(3):
        assert _rel(po.Tf64[a], jpo.Tf64[a]) <= 1e-13
        assert _rel(po.Ti64[a], jpo.Ti64[a]) <= 1e-13
    assert _rel(po.tab_A, jpo.tab_A) <= 1e-13
    assert _rel(po.tab_B, jpo.tab_B) <= 1e-13
    # the eigen route keeps the transform-folded projection, with no
    # kernel gate on a wall-bounded y of 33 points
    assert ns._fp_mats64() is not None
    assert ns._slab is None and ns._pipe is None
    assert ns._projection_gap is None


def _smooth(m):
    X, Y, Z = m.coord_grids(DataLoc.CELL)
    f = (np.cos(2 * np.pi * X / 4.0) * np.cos(np.pi * Y / 2.0)
         * np.cos(2 * np.pi * Z / 2.0) + 0.3 * np.cos(4 * np.pi * X / 4.0))
    f = np.broadcast_to(f, m.dims(DataLoc.CELL)).copy()
    return f - f.mean()


def _velocity(m, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(m.dims(DataLoc.VERT)))
            for _ in range(3)]


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("stretching", STRETCHINGS)
def test_roundtrip(stretching, route, monkeypatch):
    m, ns, _ = _build(stretching, route, monkeypatch)
    div = ns.divergence_v2p(*_velocity(m, 5)).numpy()
    for f in (_smooth(m), div - div.mean()):
        p = ns.poisson(torch.from_numpy(f))
        err = ns.divergence_v2p(*ns.gradient_p2v(p)).numpy() - f
        err -= err.mean()
        assert np.abs(err).max() < 1e-10, np.abs(err).max()


@pytest.mark.parametrize("stretching", STRETCHINGS)
def test_eigen_matches_scan(stretching, monkeypatch):
    m, ns_e, _ = _build(stretching, "eigen", monkeypatch)
    _, ns_s, _ = _build(stretching, "scan", monkeypatch)
    f = np.random.default_rng(7).standard_normal(m.dims(DataLoc.CELL))
    f = torch.from_numpy(f - f.mean())
    p_e, p_s = ns_e.poisson(f).numpy(), ns_s.poisson(f).numpy()
    d = p_e - p_s
    d -= d.mean()   # the gauge mode's constant only
    assert np.abs(d).max() < 1e-9 * max(np.abs(p_s).max(), 1.0)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("stretching", STRETCHINGS)
def test_poisson_and_projection_match_x3d2_tpu(stretching, route,
                                               monkeypatch):
    m, ns, jns = _build(stretching, route, monkeypatch)
    f = np.random.default_rng(3).standard_normal(m.dims(DataLoc.CELL))
    f -= f.mean()
    assert _rel(ns.poisson(torch.from_numpy(f)).numpy(),
                jns.poisson(jnp.asarray(f))) <= 1e-12
    vel = _velocity(m, 11)
    got = ns.pressure_correction(*vel, keep_pressure=True)
    want = jns.pressure_correction(*(jnp.asarray(t.numpy()) for t in vel),
                                   keep_pressure=True)
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) <= 1e-12
    # the same gradients through pressure_grads (compensated stepping)
    grads = ns.pressure_grads(*vel, keep_pressure=True)
    jgrads = jns.pressure_grads(*(jnp.asarray(t.numpy()) for t in vel),
                                keep_pressure=True)
    for g, w in zip(grads, jgrads):
        assert _rel(g.numpy(), w) <= 1e-12
