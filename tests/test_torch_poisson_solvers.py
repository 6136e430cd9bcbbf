"""The alternative Poisson solvers against x3d2_tpu's, float64 on the CPU:
SpectralPoisson (x3d2_tpu_torch/ops/fft_poisson.py, torch.fft) and
CGPoisson (ops/cg_poisson.py, right-preconditioned BiCGStab), and
NavierStokes.build's poisson_method.

- SpectralPoisson on variants 000, 010, 100, 110 (16-cell axes, walls
  folded) and on a stretched 010 (top-bottom and bottom, 16 x 33 x 16)
  against x3d2_tpu's on white noise: 1e-12 of the largest value (the same
  float64 algebra; pocketfft in both on the CPU). On the uniform variants it
  equals the matmul solve on that noise to 1e-10 of the largest value, and
  its div(grad) roundtrip on products of cosines the boundary conditions
  admit meets 1e-10 (tests/test_poisson.py:104-136, its bound).
- CGPoisson, uniform (32^3 periodic, tests/test_cg_poisson.py's mesh) and
  stretched (top-bottom, bottom; 16 x 33 x 16, beta 0.5, as
  tests/test_cg_poisson.py:38-55), on that test's smooth field: the
  iteration counts within 1 of x3d2_tpu's (counted through its
  lax.while_loop run as a Python loop), the solutions within 1e-9 of the
  largest value (both stop at a 1e-10 relative residual, so rounding moves
  the stopping point and the solution at that level), the roundtrip's
  residual within 1e-10 of the field in the 2-norm (the stopping rule's
  own guarantee: its largest entry may reach 1e-10 times the square root
  of the point count, and 'bottom' reads 2.3e-10 there).
- build('fft' | 'cg') builds (no transform-folded matrices, no kernel
  gate; the projection runs divergence -> solve -> gradient), its
  pressure_correction equals x3d2_tpu's (1e-12 for fft, 1e-9 for cg); an
  unknown method raises ValueError; with no GPU and no device the solvers'
  constructors raise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from x3d2_tpu.common import BC as JBC
from x3d2_tpu.mesh import Mesh as JMesh
from x3d2_tpu.solver import NavierStokes as JNavierStokes

from x3d2_tpu_torch.common import BC, DataLoc
from x3d2_tpu_torch.mesh import Mesh
from x3d2_tpu_torch.ops.fft_poisson import SpectralPoisson
from x3d2_tpu_torch.ops.stretched_poisson import StretchedYSolver
from x3d2_tpu_torch.solver import NavierStokes

torch.set_num_threads(1)
threadpool_limits(1, user_api="blas")

VARIANTS = {"000": (True, True, True), "010": (True, False, True),
            "100": (False, True, True), "110": (False, False, True)}


def _meshes(per, dims=None, L=(4.0, 2.0, 2.0), stretching="uniform",
            beta=1.0):
    dims = dims or tuple(16 if p else 17 for p in per)

    def bcs(B):
        return tuple((B.PERIODIC, B.PERIODIC) if p
                     else (B.DIRICHLET, B.DIRICHLET) for p in per)

    kw = dict(stretching=("uniform", stretching, "uniform"),
              beta=(1.0, beta, 1.0))
    return Mesh(dims, L, bcs(BC), **kw), JMesh(dims, L, bcs(JBC), **kw)


def _solvers(method, **mesh_kw):
    m, jm = _meshes(**mesh_kw)
    return (m, NavierStokes.build(m, 1.0, dtype=torch.float64, device="cpu",
                                  poisson_method=method),
            JNavierStokes.build(jm, nu=1.0, dtype=jnp.float64,
                                poisson_method=method))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _demeaned(x):
    x = np.asarray(x, np.float64)
    return x - x.mean()


def _velocity(m, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(m.dims(DataLoc.VERT)))
            for _ in range(3)]


def _roundtrip(ns, f):
    p = ns.poisson(torch.from_numpy(f))
    err = ns.divergence_v2p(*ns.gradient_p2v(p)).numpy() - f
    return np.abs(err - err.mean()).max()


SPECTRAL = {**{v: dict(per=per) for v, per in VARIANTS.items()},
            "010-top-bottom": dict(per=VARIANTS["010"], dims=(16, 33, 16),
                                   stretching="top-bottom", beta=0.259065151),
            "010-bottom": dict(per=VARIANTS["010"], dims=(16, 33, 16),
                               stretching="bottom", beta=0.259065151)}


@pytest.mark.parametrize("name", sorted(SPECTRAL))
def test_spectral_matches_x3d2_tpu(name):
    m, ns, jns = _solvers("fft", **SPECTRAL[name])
    po = ns.poisson
    assert isinstance(po, SpectralPoisson)
    assert po.variant == name[:3] == jns.poisson.variant
    assert isinstance(po.stretch_solver, StretchedYSolver) == ("-" in name)
    assert ns._fp_mats64() is None and ns._fused_pressure_mats() is None
    assert ns._slab is None and ns._pipe is None
    assert ns._projection_gap is None
    f = _demeaned(np.random.default_rng(2).standard_normal(
        m.dims(DataLoc.CELL)))
    assert _rel(po(torch.from_numpy(f)).numpy(),
                jns.poisson(jnp.asarray(f))) <= 1e-12
    for modes in [(1, 1, 1), (2, 3, 1), (5, 7, 3), (7, 15, 8)]:
        assert _roundtrip(ns, _modes(m, modes)) < 1e-10, modes
    if "-" not in name:
        # the FFT pipeline and the separable matmul solve are one solve
        mm = NavierStokes.build(m, 1.0, dtype=torch.float64, device="cpu")
        assert _rel(_demeaned(po(torch.from_numpy(f)).numpy()),
                    _demeaned(mm.poisson(torch.from_numpy(f)).numpy())
                    ) <= 1e-10


def _modes(m, modes):
    """A product of cosines each axis' boundary conditions admit
    (tests/test_poisson.py:119-126), mean-free."""
    f = 1.0
    for a, (g, k) in enumerate(zip(m.coord_grids(DataLoc.CELL), modes)):
        f = f * np.cos((2 if m.periodic[a] else 1) * np.pi * k * g / m.L[a])
    return _demeaned(np.broadcast_to(f, m.dims(DataLoc.CELL)))


def _smooth(m):
    X, Y, Z = m.coord_grids(DataLoc.CELL)
    f = (np.cos(2 * np.pi * X / m.L[0]) * np.cos(np.pi * Y / m.L[1])
         * np.cos(2 * np.pi * Z / m.L[2]))
    return _demeaned(np.broadcast_to(f, m.dims(DataLoc.CELL)))


CG = {"uniform": dict(per=(True, True, True), dims=(32, 32, 32),
                      L=(2 * np.pi,) * 3),
      "top-bottom": dict(per=VARIANTS["010"], dims=(16, 33, 16),
                         stretching="top-bottom", beta=0.5),
      "bottom": dict(per=VARIANTS["010"], dims=(16, 33, 16),
                     stretching="bottom", beta=0.5)}


def _counted_while_loop(counts):
    """jax.lax.while_loop as a Python loop that records its trip count."""
    def loop(cond, body, init):
        c, n = init, 0
        while bool(cond(c)):
            c, n = body(c), n + 1
        counts.append(n)
        return c
    return loop


@pytest.mark.parametrize("name", sorted(CG))
def test_cg_matches_x3d2_tpu(name, monkeypatch):
    m, ns, jns = _solvers("cg", **CG[name])
    f = _smooth(m)
    p = ns.poisson(torch.from_numpy(f)).numpy()
    counts = []
    monkeypatch.setattr(jax.lax, "while_loop", _counted_while_loop(counts))
    jp = np.asarray(jns.poisson(jnp.asarray(f)))
    its = ns.poisson.iterations
    assert abs(its - counts[0]) <= 1, (its, counts)
    assert (its == 1) == (name == "uniform") and its < ns.poisson.max_iters
    assert _rel(_demeaned(p), _demeaned(jp)) <= 1e-9
    # the roundtrip to the stopping rule: the residual's 2-norm within
    # tol = 1e-10 of the field's
    lap = ns.divergence_v2p(*ns.gradient_p2v(torch.from_numpy(p))).numpy()
    assert np.linalg.norm(_demeaned(lap - f)) <= 1e-10 * np.linalg.norm(f)
    if name == "uniform":
        # a perfect preconditioner: the matmul solve itself
        mm = NavierStokes.build(m, 1.0, dtype=torch.float64, device="cpu")
        assert _rel(_demeaned(p), _demeaned(
            mm.poisson(torch.from_numpy(f)).numpy())) <= 1e-10


@pytest.mark.parametrize("method, tol", [("fft", 1e-12), ("cg", 1e-9)])
def test_projection_matches_x3d2_tpu(method, tol):
    m, ns, jns = _solvers(method, **CG["top-bottom"])
    assert ns._fp_mats64() is None and ns._projection_gap is None
    vel = _velocity(m, 9)
    got = ns.pressure_correction(*vel, keep_pressure=True)
    want = jns.pressure_correction(*(jnp.asarray(t.numpy()) for t in vel),
                                   keep_pressure=True)
    for g, w in zip(got[:3], want[:3]):
        assert _rel(g.numpy(), w) <= tol
    assert _rel(_demeaned(got[3].numpy()), _demeaned(want[3])) <= tol


def test_unknown_method_and_default_device():
    m, _ = _meshes(VARIANTS["010"])
    with pytest.raises(ValueError, match="unknown poisson_method"):
        NavierStokes.build(m, 1.0, dtype=torch.float64, device="cpu",
                           poisson_method="multigrid")
    if torch.cuda.is_available():
        return
    ns = NavierStokes.build(m, 1.0, dtype=torch.float64, device="cpu")
    for method in ("fft", "cg"):
        with pytest.raises(RuntimeError, match="cuda"):
            NavierStokes.build(m, 1.0, poisson_method=method)
    with pytest.raises(RuntimeError, match="cuda"):
        SpectralPoisson(m, ns.ops)
