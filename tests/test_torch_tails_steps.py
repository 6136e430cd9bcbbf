"""The port's projections at the extents x3d2_tpu's gates admit past the
kernel template's 128-point tiles, on the CPU: the pipeline against
x3d2_tpu's, the projections in float64, whole steps (the slab's functions,
the routes and the launch geometry: test_torch_tails.py).

- The pipeline's three stages at an x tail (144 x 128 x 128) and a banded
  y tail (192 rows in three blocks of 64; 16 x 192 x 128, the x extent cut
  since x3d2_tpu's interpret mode is the cost) vs
  make_pressure_pipe3(terms=3) in interpret mode on the same inputs: 3e-6 *
  scale, the bound of tests/test_torch_pipe.py.
- The projection in float64 vs x3d2_tpu's float64 operator path, 1e-10 *
  scale as tests/test_torch_slab.py: with the physical pressure on the
  folded y (128 x 136 x 128), and at the x and y tails (144 x 128 x 128,
  16 x 192 x 128) both with it (the slab: x_div3, the mid with q,
  x_gradsub3) and without it (the pipeline); the divergence after it below
  1e-10.
- Three TGV steps with keep_pressure=True (the slab, at an x and a y tail:
  144 x 192 x 128) in float64 vs x3d2_tpu's: u, v, w and p to 1e-12 * scale,
  the tolerance of tests/test_torch_tgv.py's float64 runs.
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
from x3d2_tpu.ops.pallas_poisson import make_pressure_pipe3
from x3d2_tpu.solver import NavierStokes as JNavierStokes

from x3d2_tpu_torch.cases import SolverParams, TGVCase
from x3d2_tpu_torch.common import BC
from x3d2_tpu_torch.mesh import Mesh
from x3d2_tpu_torch.ops import pressure_pipe as pp
from x3d2_tpu_torch.solver import NavierStokes

# one thread for torch and for numpy's BLAS, as the other port tests
torch.set_num_threads(1)
threadpool_limits(1, user_api="blas")

L = (2 * np.pi,) * 3
NU = 1 / 1600
PER = ((BC.PERIODIC, BC.PERIODIC),) * 3
JPER = ((JBC.PERIODIC, JBC.PERIODIC),) * 3
X_TAIL, Y_FOLD = (144, 128, 128), (128, 136, 128)
# the y tail of the comparisons but the whole steps' (x cut to 16)
Y_TAIL_S = (16, 192, 128)


def _port(shape, dtype=torch.float32):
    return NavierStokes.build(Mesh(shape, L, PER), NU, dtype=dtype,
                              device="cpu")


def _jax(shape, dtype=jnp.float32):
    return JNavierStokes.build(JMesh(shape, L, JPER), NU, dtype=dtype)


def _fields(shape, n, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(dtype) for _ in range(n)]


def _close(got, want, tol):
    assert len(got) == len(want)
    for g, e in zip(got, want):
        e = np.asarray(e)
        assert g.shape == e.shape
        err = np.abs(g.numpy() - e).max()
        assert err < tol * np.abs(e).max(), f"{err:.2e}"


@pytest.mark.parametrize("dims", [X_TAIL, Y_TAIL_S],
                         ids=["x-tail", "y-tail"])
def test_pipe_matches_x3d2_tpu(dims):
    pm = _port(dims)._pipe.mats
    jp = make_pressure_pipe3(_jax(dims), terms=3, interpret=True)
    for stage in "abc":
        n = {"a": 3, "b": 2, "c": 5}[stage]
        f = _fields(dims, n, seed=ord(stage))
        port = {"a": pp.pipe_a, "b": pp.pipe_b, "c": pp.pipe_c}[stage]
        got = port(*(torch.from_numpy(a) for a in f), pm)
        _close(got, getattr(jp, f"{stage}_fn")(*(jnp.asarray(a) for a in f)),
               3e-6)


def test_folded_y_projection_matches_x3d2_tpu_f64():
    ns, jns = _port(Y_FOLD, torch.float64), _jax(Y_FOLD, jnp.float64)
    assert ns._slab.forms.y == "folded"
    f = _fields(Y_FOLD, 3, seed=5, dtype=np.float64)
    got = ns.pressure_correction(*(torch.from_numpy(a) for a in f),
                                 keep_pressure=True)
    want = jns.pressure_correction(*(jnp.asarray(a) for a in f),
                                   keep_pressure=True)
    _close(got, want, 1e-10)
    assert float(ns.divergence_v2p(*got[:3]).abs().max()) < 1e-10


@pytest.mark.parametrize("dims", [X_TAIL, Y_TAIL_S],
                         ids=["x-tail", "y-tail"])
def test_tail_projections_match_x3d2_tpu_f64(dims):
    """The slab (keep_pressure=True) and the pipeline (False) in float64."""
    ns, jns = _port(dims, torch.float64), _jax(dims, jnp.float64)
    assert ns._pipe is not None and ns._slab.forms.y == "parity"
    f = _fields(dims, 3, seed=7, dtype=np.float64)
    for keep in (True, False):
        got = ns.pressure_correction(*(torch.from_numpy(a) for a in f),
                                     keep_pressure=keep)
        want = jns.pressure_correction(*(jnp.asarray(a) for a in f),
                                       keep_pressure=keep)
        n = 4 if keep else 3   # without p the port returns None for it
        _close(got[:n], want[:n], 1e-10)
        assert float(ns.divergence_v2p(*got[:3]).abs().max()) < 1e-10


def test_tgv_steps_match_x3d2_tpu_f64():
    dims = (144, 192, 128)
    kw = dict(monitor_path=None, verbose=False, keep_pressure=True)
    case = TGVCase(Mesh(dims, L, PER), SolverParams(Re=1600, dt=1e-3),
                   dtype=torch.float64, device="cpu", **kw)
    jcase = JTGVCase(JMesh(dims, L, JPER), JSolverParams(Re=1600, dt=1e-3),
                     dtype=jnp.float64, **kw)
    assert case.solver._slab is not None and case.solver._slab.x_perm \
        is not None
    s, js = case.initial_state(), jcase.initial_state()
    for _ in range(3):   # AB3 startup rows istep 1, 2, 3
        s, js = case.step(s), jcase._step(js)
    for k in "uvwp":
        want = np.asarray(js[k])
        err = np.abs(s[k].numpy() - want).max()
        assert err < 1e-12 * np.abs(want).max(), f"{k}: {err:.2e}"
