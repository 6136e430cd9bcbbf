"""The y/z-tiled mid past 1024 points along y or z (the kernels' long form),
in the port against x3d2_tpu, on the CPU.

- The launch geometry (ops/pressure_slab.py tiled_geometry: plain Python)
  of each of the three kernels on every plane x3d2_tpu's tiled gate admits
  (tiled_vmem_ok: y a multiple of 64 from 128 to 4096, z of 128 from 128
  to 4096, at terms 2 and 3): a form that fits the H100's 227 KB of shared
  memory a block, the wide one up to 1024 points along the axis the kernel
  transforms, the long one past it, with threads for every row. The gate
  reaches 3968 points along y and 2560 along z at terms 2.
- The plain tiled mid (pressure_mid_tiled_plain, float64) against
  x3d2_tpu's interpret-mode make_mid_local(...).tiled on a batch of 2
  planes of 128 x ny x nz (the x planes the waves fill most), on plane
  waves (tests/test_torch_tiled_mid.py's inputs): x3d2_tpu's bf16x3 splits
  at terms 2 within 2e-3 (tests/test_torch_tiled_mid.py holds them to 2e-4
  at 128-point transforms, where they read 6.7e-5; at 2048-long y
  transforms they read 6.6e-4 from float64 here), its bf16x6 at terms 3
  within 3e-5, the port's float32 tiled mid within 3e-5; at 2048 x 256 and
  256 x 2048, terms 2 and 3; 256 x 2048 at terms 3 is past x3d2_tpu's
  tiled gate, and both refuse it.
- make_repencilled_pressure at 128 x 2048 x 256 and 128 x 256 x 2048 on
  (2, 2) at terms 2 builds and takes the tiled mid (the full-plane mid
  fails x3d2_tpu's VMEM gate there; tests/test_torch_tiled_mid.py builds
  the 2048^2 one).
"""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax.numpy as jnp

from x3d2_tpu.common import BC as JBC
from x3d2_tpu.mesh import Mesh as JMesh
from x3d2_tpu.ops import pallas_poisson as jpp
from x3d2_tpu.solver import NavierStokes as JNavierStokes

from x3d2_tpu_torch.common import BC, DataLoc, env_set
from x3d2_tpu_torch.mesh import Mesh
from x3d2_tpu_torch.ops import pressure_slab as sl
from x3d2_tpu_torch.ops.parity import build_projection_mats
from x3d2_tpu_torch.parallel import shard_kernels as psk
from x3d2_tpu_torch.parallel.topo import ProcessMesh
from x3d2_tpu_torch.solver import NavierStokes

torch.set_num_threads(1)
threadpool_limits(1, user_api="blas")

L = (2 * np.pi,) * 3
PER = ((BC.PERIODIC, BC.PERIODIC),) * 3
JPER = ((JBC.PERIODIC, JBC.PERIODIC),) * 3
NU = 1 / 1600
LIMIT = {2: 2e-3, 3: 3e-5}
BATCH = 2


@pytest.fixture(autouse=True)
def _clean_switches(monkeypatch):
    for k in ("X3D2_BFLY", "X3D2_EINSUM_MID", "X3D2_PALLAS",
              "X3D2_MATMUL_PRECISION"):
        monkeypatch.delenv(k, raising=False)


def _admitted(terms):
    return [(ny, nz) for ny in range(128, 4097, 64)
            for nz in range(128, 4097, 128) if sl.tiled_vmem_ok(ny, nz,
                                                                terms)]


@pytest.mark.parametrize("terms", [2, 3])
def test_tiled_geometry_serves_every_admitted_plane(terms):
    planes = _admitted(terms)
    assert max(ny for ny, _ in planes) == (3968 if terms == 2 else 3328)
    assert max(nz for _, nz in planes) == (2560 if terms == 2 else 2048)
    assert ((2048, 2048) in planes) == (terms == 2)
    for ny, nz in planes:
        for stage in (1, 2, 3):
            geo = sl.tiled_geometry(stage, ny, nz)
            n = nz if stage == 2 else ny
            assert geo["form"] == ("wide" if n <= sl.WIDE_MAXN else "long")
            assert geo["smem"] <= sl.SMEM_MAX
            # the long form's threads: 4 rows of each half, 8 columns
            if geo["form"] == "long":
                assert n // 2 <= sl.TILED_NT * 4 // (geo["tc"] // 8)
            assert (ny if stage == 2 else nz) % geo["tc"] == 0


def test_tiled_geometry_forms():
    wide = sl.tiled_geometry(1, 1024, 1024)
    assert wide == {"form": "wide", "tc": 16, "smem": 196864}
    assert sl.tiled_geometry(1, 2048, 2048)["tc"] == 16
    assert sl.tiled_geometry(3, 3968, 128)["tc"] == 8
    assert sl.tiled_geometry(2, 2048, 1664)["tc"] == 16
    assert sl.tiled_geometry(2, 2048, 2560)["tc"] == 8
    with pytest.raises(ValueError, match="multiple of 64"):
        sl.tiled_geometry(1, 200, 256)


@pytest.fixture(scope="module", params=[(2048, 256), (256, 2048)],
                ids=["2048x256", "256x2048"])
def planes(request):
    """(port solver, its operator set, x3d2_tpu solver) at 128 x ny x nz,
    float32, without kernel branches (only their operators are used); one
    build of each a plane, most of this file's time."""
    dims = (128,) + request.param
    with env_set({"X3D2_PALLAS": "0"}):
        ns = NavierStokes.build(Mesh(dims, L, PER), NU, device="cpu")
        jns = JNavierStokes.build(JMesh(dims, L, JPER), NU,
                                  dtype=jnp.float32)
    return ns, build_projection_mats(ns), jns


def _waves(ns, pm):
    """The mid's inputs from plane waves (chip_smoke.py wave_fields): the
    x stage's transforms of them, float64, and the x batch of BATCH planes
    that holds the most of them (the waves fill a few x modes)."""
    X, Y, Z = (torch.as_tensor(g, dtype=torch.float64)
               for g in ns.mesh.coord_grids(DataLoc.VERT))
    k = 12
    u = (torch.sin(X) * torch.cos(k * Y) * torch.cos(Z)
         + 0.5 * torch.cos(2 * X + (k - 1) * Y))
    v = (torch.cos(X) * torch.sin(k * Y) * torch.cos(2 * Z)
         + 0.3 * torch.sin((k - 2) * Y + Z))
    w = (torch.cos(2 * X) * torch.cos((k - 1) * Y) * torch.sin(Z)
         + 0.2 * torch.sin(X + k * Y + 2 * Z))
    d = sl.x_div3_plain(u, v, w, pm.mats(torch.float64))
    del X, Y, Z, u, v, w
    energy = sum(t.abs().amax(dim=(1, 2)) for t in d)
    off = min(int(energy.argmax()), d[0].shape[0] - BATCH)
    return [t[off:off + BATCH].contiguous().numpy() for t in d], off


def _rel(got, want):
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / np.abs(want).max())


@pytest.mark.parametrize("terms", [2, 3])
def test_long_planes_match_x3d2_tpu(planes, terms):
    ns, pm, jns = planes
    plane = tuple(ns.mesh.dims(DataLoc.VERT)[1:])
    assert any(sl.tiled_geometry(s, *plane)["form"] == "long"
               for s in (1, 2, 3))
    jmk = jpp.make_pressure_slab(jns, terms=terms, interpret=True)[4]
    mk = sl.make_mid_local(ns, pm, terms)
    assert mk.tiled_supported == jmk.tiled_supported \
        == sl.tiled_vmem_ok(*plane, terms)
    if not mk.tiled_supported:
        # 256 x 2048 at terms 3: past x3d2_tpu's estimate (73 MB against
        # 64); both refuse the tiled mid
        assert plane == (256, 2048) and terms == 3
        for make in (mk.tiled, jmk.tiled):
            with pytest.raises(ValueError, match="tiled mid"):
                make(BATCH)
        return
    d, off = _waves(ns, pm)
    m64 = sl.local_tables(pm.mats(torch.float64), off, BATCH)
    want = [t.numpy() for t in sl.pressure_mid_tiled_plain(
        *(torch.as_tensor(x) for x in d), m64)]
    got_j = jmk.tiled(BATCH)(*(jnp.asarray(x, jnp.float32) for x in d),
                             *(t[off:off + BATCH] for t in jmk.tables[3:6]))
    m32 = pm.mats(torch.float32)
    got = mk.tiled(BATCH)(
        *(torch.as_tensor(x, dtype=torch.float32) for x in d),
        m32["k2x"][off:off + BATCH], m32["tx2"][off:off + BATCH])
    assert len(got) == len(got_j) == 4
    for g, gj, e in zip(got, got_j, want):
        assert _rel(gj, e) < LIMIT[terms]
        assert _rel(g.numpy(), e) < 3e-5


def test_terms3_refuses_what_x3d2_tpu_refuses():
    """256 x 2048 is past x3d2_tpu's tiled gate at terms 3 (its estimate,
    73 MB against 64): both refuse the tiled mid there."""
    assert sl.tiled_vmem_ok(256, 2048, 2)
    assert not sl.tiled_vmem_ok(256, 2048, 3)


def test_repencilled_projection_takes_the_long_tiled_mid(planes):
    ns = planes[0]
    pmesh = ProcessMesh(2, 2)
    assert psk.repencil_supported(ns, pmesh)
    assert not sl.tpu_slab_vmem_ok(ns, 2)
    assert sl.tiled_mid_supported(ns, 2)
    fn = psk.make_repencilled_pressure(ns, pmesh, terms=2)
    assert fn.mid.__name__ == "mid_tiled"
