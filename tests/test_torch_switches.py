"""The switches x3d2_tpu's solver and case read, read by the port where
x3d2_tpu reads them, on the CPU against x3d2_tpu's branches (built with
its backend reported as a TPU; nothing of it is run):

- X3D2_MID_SPLIT=1 takes the mid's two halves (div_solve, grad) where
  the slab's mid runs (the xdiv chain's projection, keep_pressure=True,
  pressure_grads), with the bits of the merged mid, and not on the
  pipeline, which never reads it;
- X3D2_PALLAS=0 takes the dense transport and the transform-folded
  projection, as x3d2_tpu builds no kernel branch;
- X3D2_CHUNK=0 or 1 runs the same steps;
- an unknown X3D2_MATMUL_PRECISION raises ValueError, as x3d2_tpu's
  lookup raises KeyError.
"""

import contextlib

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax
import jax.numpy as jnp

from x3d2_tpu.cases import SolverParams as JSolverParams
from x3d2_tpu.cases import TGVCase as JTGVCase
from x3d2_tpu.common import BC as JBC
from x3d2_tpu.mesh import Mesh as JMesh
from x3d2_tpu.ops import compact as jcompact
from x3d2_tpu.solver import NavierStokes as JNavierStokes

from x3d2_tpu_torch.cases import SolverParams, TGVCase
from x3d2_tpu_torch.common import BC
from x3d2_tpu_torch.mesh import Mesh
from x3d2_tpu_torch.solver import NavierStokes

# one thread for torch and for numpy's BLAS: the suite runs several workers
# on one machine, and multi-threaded BLAS calls in each of them, spinning on
# oversubscribed cores, made these tests many times slower there
torch.set_num_threads(1)
threadpool_limits(1, user_api="blas")

SHAPE = (128, 128, 256)
L = (2 * np.pi,) * 3
PER = ((BC.PERIODIC, BC.PERIODIC),) * 3
JPER = ((JBC.PERIODIC, JBC.PERIODIC),) * 3
NU = 1 / 1600
DT = 1e-3
SWITCHES = ("X3D2_BF16_OLDS", "X3D2_BF16_ACC", "X3D2_FUSED_AB",
            "X3D2_XDIV_FUSED", "X3D2_MERGED_X", "X3D2_PIPE3", "X3D2_BFLY",
            "X3D2_D2C", "X3D2_FUSED_RK", "X3D2_MID_SPLIT", "X3D2_PALLAS",
            "X3D2_CHUNK", "X3D2_MATMUL_PRECISION")


@pytest.fixture(autouse=True)
def _clean_switches(monkeypatch):
    for k in SWITCHES:
        monkeypatch.delenv(k, raising=False)


@contextlib.contextmanager
def _tpu_gates():
    """x3d2_tpu builds its kernel branches only on a TPU backend with no
    other default device (solver.py:106-110); report one while it builds."""
    real = jax.default_backend
    device = jax.config.jax_default_device
    jax.default_backend = lambda: "tpu"
    jax.config.update("jax_default_device", None)
    try:
        yield
    finally:
        jax.default_backend = real
        jax.config.update("jax_default_device", device)


def test_mid_split_raises_where_the_slab_mid_runs(monkeypatch):
    """X3D2_MID_SPLIT=1 is read in the slab's mid (x3d2_tpu solver.py:512):
    the xdiv chain's projection, keep_pressure=True and pressure_grads take
    the halves, div_solve then grad (the name is from when the port
    raised there), with the merged mid's bits; the pipeline
    (X3D2_XDIV_FUSED=0, keep_pressure=False) never reads it and runs, as
    in x3d2_tpu, which builds both there."""
    from x3d2_tpu_torch.ops import pressure_slab as sl
    ns = NavierStokes.build(Mesh(SHAPE, L, PER), NU, device="cpu")
    rng = np.random.default_rng(3)
    u, v, w = (torch.from_numpy(rng.standard_normal(SHAPE)
                                .astype(np.float32)) for _ in range(3))
    calls = []
    for half in ("div_solve", "grad"):
        inner = getattr(sl, half)
        monkeypatch.setattr(sl, half, lambda *a, _f=inner, _h=half: (
            calls.append(_h), _f(*a))[1])
    divs = ns._x_stage(("sx", "ix", "ix"), (u, v, w))
    merged = [ns.pressure_correction(u, v, w, keep_pressure=keep,
                                      divs=None if keep else divs)
              for keep in (True, False)] + [ns.pressure_grads(u, v, w)]
    assert calls == []
    monkeypatch.setenv("X3D2_MID_SPLIT", "1")
    split = [ns.pressure_correction(u, v, w, keep_pressure=keep,
                                     divs=None if keep else divs)
             for keep in (True, False)] + [ns.pressure_grads(u, v, w)]
    assert calls == ["div_solve", "grad"] * 3
    for a, b in zip(merged, split):
        for x, y in zip(a, b):
            assert (x is None and y is None) or torch.equal(x, y)
    out = ns.pressure_correction(u, v, w, keep_pressure=False)
    assert ns._pipe is not None and out[3] is None
    assert calls == ["div_solve", "grad"] * 3
    monkeypatch.delenv("X3D2_MID_SPLIT")
    ref = ns.pressure_correction(u, v, w, keep_pressure=False)
    for a, b in zip(out[:3], ref[:3]):
        assert torch.equal(a, b)
    with _tpu_gates():
        jns = JNavierStokes.build(JMesh(SHAPE, L, JPER), NU,
                                  dtype=jnp.float32)
    assert jns._slab_pressure is not None and jns._pipe_pressure is not None


def test_pallas_off_takes_the_einsum_paths(monkeypatch):
    """X3D2_PALLAS=0 (x3d2_tpu solver.py:106): no kernel branch on either
    device, the dense transport products and the transform-folded
    projection, the unfused AB step; equal to the default build's dense
    and folded functions on the same inputs."""
    monkeypatch.setenv("X3D2_PALLAS", "0")
    kw = dict(monitor_path=None, verbose=False, keep_pressure=False)
    case = TGVCase(Mesh(SHAPE, L, PER), SolverParams(dt=DT),
                   dtype=torch.float32, device="cpu", **kw)
    with _tpu_gates():
        jcase = JTGVCase(JMesh(SHAPE, L, JPER), JSolverParams(dt=DT),
                         dtype=jnp.float32, **kw)
    ns = case.solver
    assert ns._transport == "dense" and ns._sweeps is None
    assert ns._v1 is None and ns._slab is None and ns._pipe is None
    assert ns._projection_gap is None and ns.transport_gap() is None
    assert case._fused_ab is None
    assert getattr(jcase.solver, "_transeq_v3", None) is None
    assert getattr(jcase.solver, "_slab_pressure", None) is None
    assert jcase._fused_ab is None
    rng = np.random.default_rng(4)
    u, v, w = (torch.from_numpy(rng.standard_normal(SHAPE)
                                .astype(np.float32)) for _ in range(3))
    got = ns.pressure_correction(u, v, w, keep_pressure=True)
    grads = ns.pressure_grads_folded(u, v, w, keep_pressure=True)
    for g, f, d in zip(got[:3], (u, v, w), grads[:3]):
        assert torch.equal(g, f - d)
    assert torch.equal(got[3], grads[3])


def test_chunk_is_accepted(monkeypatch):
    """X3D2_CHUNK chains the steps between outputs into one dispatch or
    not in x3d2_tpu (cases/base.py:566): the same steps. The port's run
    dispatches per step at any value, to the same state."""
    kw = dict(monitor_path=None, verbose=False, device="cpu")
    states = []
    for val in ("0", "1", None):
        if val is None:
            monkeypatch.delenv("X3D2_CHUNK", raising=False)
        else:
            monkeypatch.setenv("X3D2_CHUNK", val)
        case = TGVCase(Mesh((32,) * 3, L, PER), SolverParams(dt=DT),
                       dtype=torch.float64, **kw)
        states.append(case.run(n_iters=3, n_output=2))
    for s in states[1:]:
        for k in ("u", "v", "w"):
            assert torch.equal(s[k], states[0][k])


@pytest.mark.parametrize("value", ["HIGHEST", "bf16x6", ""])
def test_unknown_precision_raises(monkeypatch, value):
    """Another value than x3d2_tpu's three raises when the solver is built
    (x3d2_tpu: KeyError at import, ops/compact.py:58)."""
    monkeypatch.setenv("X3D2_MATMUL_PRECISION", value)
    with pytest.raises(ValueError, match="X3D2_MATMUL_PRECISION"):
        NavierStokes.build(Mesh((32,) * 3, L, PER), NU, device="cpu")
    with pytest.raises(KeyError):
        jcompact._PRECISIONS[value]
    for ok in ("default", "high", "highest"):
        monkeypatch.setenv("X3D2_MATMUL_PRECISION", ok)
        ns = NavierStokes.build(Mesh((32,) * 3, L, PER), NU, device="cpu")
        assert ns._terms == (3 if ok == "highest" else 2)
        assert ok in jcompact._PRECISIONS
