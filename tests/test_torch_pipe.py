"""The port's three-stage pressure pipeline against x3d2_tpu's, on the CPU.

- Each stage's plain version vs x3d2_tpu's pipe3 kernel of the same stage
  (make_pressure_pipe3 in interpret mode, terms=3, the bf16x6 mode with
  the same W=32 band), float32 at 128^3 on the same numpy inputs. The
  stages meet at the same intermediates (a, e; X, Y; u', v', w') in the
  same block-parity orderings. The bound is 3e-6 * scale: both sides carry
  float32 rounding of dot products 64 to 128 long (measured 5e-7).
- The whole pipeline in float64 vs x3d2_tpu's transform-folded projection:
  1e-12 * scale (the band at W=32 drops entries below 1e-15; measured
  2e-13), and the divergence after it stays below 1e-10, the bound of
  tests/test_poisson.py.
- CPU tensors take the plain versions and count no launch.
"""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax.numpy as jnp

from x3d2_tpu.common import BC as JBC
from x3d2_tpu.mesh import Mesh as JMesh
from x3d2_tpu.ops.pallas_poisson import make_pressure_pipe3
from x3d2_tpu.solver import NavierStokes as JNavierStokes

from x3d2_tpu_torch.common import BC
from x3d2_tpu_torch.mesh import Mesh
from x3d2_tpu_torch.ops import operator_apply as oa
from x3d2_tpu_torch.ops import pressure_pipe as pp
from x3d2_tpu_torch.ops.parity import projection_supported
from x3d2_tpu_torch.solver import NavierStokes

# one thread for torch and for numpy's BLAS: the suite runs several workers
# on one machine, and multi-threaded BLAS calls in each of them, spinning on
# oversubscribed cores, made these tests many times slower there
torch.set_num_threads(1)
threadpool_limits(1, user_api="blas")


SHAPE = (128, 128, 128)
L = (2 * np.pi,) * 3
NU = 1 / 1600
PER = ((BC.PERIODIC, BC.PERIODIC),) * 3
JPER = ((JBC.PERIODIC, JBC.PERIODIC),) * 3


def _build(dtype, shape=SHAPE, bcs=PER):
    return NavierStokes.build(Mesh(shape, L, bcs), NU, dtype=dtype,
                              device="cpu")


def _fields(n, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(SHAPE).astype(dtype) for _ in range(n)]


@pytest.fixture(scope="module")
def jax_pipe():
    jns = JNavierStokes.build(JMesh(SHAPE, L, JPER), NU, dtype=jnp.float32)
    return make_pressure_pipe3(jns, terms=3, interpret=True)


@pytest.fixture(scope="module")
def solver32():
    return _build(torch.float32)


@pytest.fixture(scope="module")
def mats(solver32):
    return solver32._pipe.mats


def test_pipe_supported(solver32):
    assert projection_supported(solver32)
    small = _build(torch.float32, (32, 32, 32))   # not tiled by 128
    assert not projection_supported(small) and small._pipe is None
    neu = ((BC.NEUMANN, BC.NEUMANN),) + PER[1:]
    assert not projection_supported(_build(torch.float32, (33, 32, 32), neu))


@pytest.mark.parametrize("stage,nin", [("a", 3), ("b", 2), ("c", 5)])
def test_stage_matches_x3d2_tpu_pipe3(jax_pipe, mats, stage, nin):
    f = _fields(nin, seed={"a": 1, "b": 2, "c": 3}[stage])
    port = {"a": pp.pipe_a, "b": pp.pipe_b, "c": pp.pipe_c}[stage]
    ref = getattr(jax_pipe, f"{stage}_fn")
    got = port(*(torch.from_numpy(a) for a in f), mats)
    want = ref(*(jnp.asarray(a) for a in f))
    assert len(got) == len(want)
    for g, e in zip(got, want):
        e = np.asarray(e)
        err = np.abs(g.numpy() - e).max()
        assert err < 3e-6 * np.abs(e).max(), f"{err:.2e}"


def test_pipeline_matches_x3d2_tpu_projection_f64():
    ns = _build(torch.float64)
    jns = JNavierStokes.build(JMesh(SHAPE, L, JPER), NU, dtype=jnp.float64)
    f = _fields(3, seed=4, dtype=np.float64)
    u, v, w, p = ns.pressure_correction(*(torch.from_numpy(a) for a in f),
                                        keep_pressure=False)
    assert p is None   # the pipeline forms no pressure, as x3d2_tpu's
    want = jns.pressure_correction(*(jnp.asarray(a) for a in f),
                                   keep_pressure=False)
    for g, e in zip((u, v, w), want[:3]):
        e = np.asarray(e)
        np.testing.assert_allclose(g.numpy(), e, rtol=0,
                                   atol=1e-12 * np.abs(e).max())
    assert float(ns.divergence_v2p(u, v, w).abs().max()) < 1e-10


def test_cpu_pipe_never_counts_launches(mats):
    oa.reset_launch_counts()
    f = torch.zeros(SHAPE)
    out = pp.pipe_c(*pp.pipe_b(*pp.pipe_a(f, f, f, mats), mats), f, f, f,
                    mats)
    assert len(out) == 3 and oa.launch_counts() == {}
    m = torch.empty(SHAPE, device="meta")
    with pytest.raises(ValueError, match="no pipe_a"):
        pp.pipe_a(m, m, m, mats)
