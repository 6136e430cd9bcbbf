"""The d2-in-C carry (X3D2_D2C=1) past nz = 512, in the port against
x3d2_tpu, on the CPU.

- The carry kernel's rule and launch geometry (ops/pressure_pipe.py
  carry_kernel_supported, carry_geometry: plain Python) at 128 x 128 x nz
  for nz = 256 ... 4096 in steps of 128: every one served, the resident
  form at 256, 384 and 512, the streamed form elsewhere, in 55 KB of shared
  memory; refused where x3d2_tpu's carry gate refuses (make_pressure_pipe3
  d2_sweep, pallas_poisson.py:1684-1686: nz a multiple of 128 and at least
  256; its sweeps take no other z) and where x * y is no multiple of the
  block's 32 lines.
- The whole case gate at 128 x 128 x nz against x3d2_tpu's (cases/base.py:
  182-211, built with its backend reported as a TPU): at nz = 256, 640 and
  1024 both build the carry; at 1664 x3d2_tpu builds no pipeline (its slab
  gate's VMEM estimate, a limit of the TPU's scoped memory, stops it past
  1536 on these planes: its structural slab gate holds), the port, which
  takes no such limit over (ops/parity.py slab_supported), builds the
  pipeline and the carry, and the kernel serves it. The port's case raises
  nowhere for X3D2_D2C=1. (x3d2_tpu's case at these planes costs seconds
  to build, more as nz grows, so the test takes a few extents of each
  regime; its slab gate's estimate, held here at 1664, grows with nz^2.)
- pipe_c_d2_plain against x3d2_tpu's make_pressure_pipe3(terms=3,
  interpret=True, d2_sweep=True).c_fn at 16 x 128 x 640 (x cut to the
  smallest pipe3 takes, 16; the carry is along z), float32 on the same
  numpy inputs: 3e-6 * scale, tests/test_torch_d2c.py's bound at 256.
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
from x3d2_tpu.ops.pallas_poisson import (make_pressure_pipe3,
                                         slab_pressure_supported)
from x3d2_tpu.solver import NavierStokes as JNavierStokes

from x3d2_tpu_torch.cases import SolverParams, TGVCase
from x3d2_tpu_torch.common import BC, env_set
from x3d2_tpu_torch.mesh import Mesh
from x3d2_tpu_torch.ops import pressure_pipe as pp
from x3d2_tpu_torch.solver import NavierStokes

torch.set_num_threads(1)
threadpool_limits(1, user_api="blas")

L = (2 * np.pi,) * 3
NU = 1 / 1600
PER = ((BC.PERIODIC, BC.PERIODIC),) * 3
JPER = ((JBC.PERIODIC, JBC.PERIODIC),) * 3
CARRY_ENV = {"X3D2_D2C": "1", "X3D2_XDIV_FUSED": "0"}


@contextlib.contextmanager
def _tpu_gates():
    """x3d2_tpu builds its kernel branches only on a TPU backend with no
    other default device (solver.py:106-110); report one while its case is
    built (building runs no kernel)."""
    real = jax.default_backend
    device = jax.config.jax_default_device
    jax.default_backend = lambda: "tpu"
    jax.config.update("jax_default_device", None)
    try:
        yield
    finally:
        jax.default_backend = real
        jax.config.update("jax_default_device", device)


@pytest.mark.parametrize("nz", range(256, 4097, 128))
def test_carry_rule_and_geometry(nz):
    shape = (128, 128, nz)
    assert pp.carry_kernel_supported(shape)
    geo = pp.carry_geometry(shape)
    assert geo["blocks"] * geo["lines"] == 128 * 128
    assert geo["form"] == ("resident" if nz in (256, 384, 512)
                           else "streamed")
    assert geo["smem"] <= 227 * 1024
    if geo["form"] == "streamed":
        assert geo["smem"] == pp.STREAM_SMEM < 56 * 1024
        assert geo["passes"] * pp.STREAM_PASS >= nz // 2
        assert geo["chunks"] * pp.STREAM_CHUNK == nz


@pytest.mark.parametrize("shape", [(128, 128, 128), (128, 128, 192),
                                   (128, 128, 320), (128, 128, 4160),
                                   (8, 2, 256)])
def test_carry_refused_where_x3d2_tpu_refuses(shape):
    """Below 256 points, off a multiple of 128 (x3d2_tpu's carry and sweep
    gates), and on x * y lines no block of 32 tiles."""
    assert not pp.carry_kernel_supported(shape)
    with pytest.raises(ValueError, match="carry kernel takes"):
        pp.carry_geometry(shape)


@pytest.mark.parametrize("nz,x3d2_tpu_builds", [(256, True), (640, True),
                                                 (1024, True),
                                                 (1664, False)])
def test_case_gate_matches_x3d2_tpu(nz, x3d2_tpu_builds):
    shape = (128, 128, nz)
    prm = dict(Re=1600, time_intg="AB3", dt=1e-3)
    kw = dict(monitor_path=None, verbose=False, keep_pressure=False)
    with env_set(CARRY_ENV):
        case = TGVCase(Mesh(shape, L, PER), SolverParams(**prm),
                       device="cpu", **kw)
        with _tpu_gates():
            jcase = JTGVCase(JMesh(shape, L, JPER), JSolverParams(**prm),
                             dtype=jnp.float32, **kw)
    assert (jcase._pipe_d2c is not None) == x3d2_tpu_builds
    assert case._pipe_d2c is not None
    assert pp.carry_geometry(shape)["form"] in ("resident", "streamed")
    if not x3d2_tpu_builds:
        # x3d2_tpu's reason: its slab's VMEM estimate alone
        assert getattr(jcase.solver, "_pipe_pressure", None) is None
        assert not slab_pressure_supported(jcase.solver)
        assert slab_pressure_supported(jcase.solver, structure_only=True)
        assert jcase._fused_ab is not None


def test_pipe_c_d2_matches_x3d2_tpu_at_640():
    shape = (16, 128, 640)
    ns = NavierStokes.build(Mesh(shape, L, PER), NU, device="cpu")
    carry = pp.build_carry_mats(ns.ops[2], NU, device="cpu")
    jns = JNavierStokes.build(JMesh(shape, L, JPER), NU, dtype=jnp.float32)
    jpipe = make_pressure_pipe3(jns, terms=3, interpret=True, d2_sweep=True)
    rng = np.random.default_rng(31)
    f = [rng.standard_normal(shape).astype(np.float32) for _ in range(5)]
    got = pp.pipe_c_d2(*(torch.from_numpy(a) for a in f), ns._pipe.mats,
                       carry)
    want = jpipe.c_fn(*(jnp.asarray(a) for a in f))
    assert len(got[0] + got[1]) == len(want) == 6
    for g, e in zip(got[0] + got[1], want):
        e = np.asarray(e)
        err = np.abs(g.numpy() - e).max()
        assert err < 3e-6 * np.abs(e).max(), f"{err:.2e}"
