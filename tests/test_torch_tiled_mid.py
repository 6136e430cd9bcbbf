"""The y/z-tiled mid (x3d2_tpu's _mid_t1/_t2/_t3_kernel, make_mid_local
.tiled) in the port against x3d2_tpu, on the CPU: the plain version of the
three kernels (pressure_slab.pressure_mid_tiled_plain), and the sharded step
that takes it.

- At x3d2_tpu's own tiled-mid grid, (16, 128, 128) (tests/
  test_pallas_poisson.py:161-184), on the x-transformed plane waves of
  chip_smoke.py's mid rows (wavenumber about 12 in y): x3d2_tpu's
  make_pressure_slab(terms, interpret=True)[4].tiled(16) with its tables,
  against the port's float64 tiled form. The bounds are the mid's, not the
  sweeps' (3e-5 and 5e-7 of tests/test_pallas_v3.py:63, :114): the solve
  divides by k^2 and the banded y derivative differentiates its result, so
  a float32 evaluation of the mid reaches ~2e-6 of max |out| here (the
  port's own float32 plain version: 1.9e-6), and x3d2_tpu's bf16x3 splits
  with its W = 16 band 6.7e-5 (terms 2; held to 2e-4, the bound the port's
  other mid tests hold x3d2_tpu's mid to), its bf16x6 ones 1.1e-6 (terms
  3; held to 3e-5, chip_smoke.py's mid against plain float64). The port's
  float32 tiled mid (make_mid_local(...).tiled) is held to that 3e-5 too.
- In float64 the tiled form is the merged mid (pressure_mid_plain) up to
  reassociation, 1e-12 * scale (measured 5e-15), on white noise, over the
  whole x range and over one rank's x batch with its table slices.
- At 2048^2 planes, past the kernels' wide form (1024 points along y or
  z), where x3d2_tpu's gates still give the repencilled projection its
  tiled mid, the projection builds with the tiled mid in the kernels' long
  form (tests/test_torch_tiled_long.py holds that form's plane sizes).
- The sharded step with the tiled mid: TGV 64 x 128 x 256 AB3 float64 on a
  (2, 2) mesh, 3 steps, keep_pressure=False, on spawned gloo ranks, the
  full-plane mid's VMEM gate forced closed inside the rank function (as
  x3d2_tpu's own tests/test_shard_kernels.py:301-341 forces its gate; no
  switch in the package), so the repencilled projection takes the tiled
  mid. Against x3d2_tpu's make_sharded_step with its gate forced closed
  the same way (its tiled mid, it checks, and its per-rank x applies in
  interpret mode, with bf16x3 splits even in float64): 2e-5 * max |u|
  (measured 7.8e-6; x3d2_tpu's sharded step is as far from its own
  single-device float64 step with its full-plane mid, 7.8e-6, and its
  tiled and full-plane sharded steps differ by 3.1e-6: its kernels'
  bf16x3 rounding, not the mid's form). Against x3d2_tpu's single-device
  float64 step (its einsums): 1e-12 * max |u| (measured 2.9e-15), as
  tests/test_torch_sharding.py holds the full-plane mid at this grid.
"""

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
from x3d2_tpu.ops import pallas_poisson as jpp
from x3d2_tpu.parallel import make_device_mesh, make_sharded_step
from x3d2_tpu.solver import NavierStokes as JNavierStokes

from x3d2_tpu_torch.common import BC, DataLoc, env_set
from x3d2_tpu_torch.mesh import Mesh
from x3d2_tpu_torch.ops import pressure_slab as sl
from x3d2_tpu_torch.ops.parity import build_projection_mats
from x3d2_tpu_torch.parallel import shard_kernels as psk
from x3d2_tpu_torch.parallel.multihost import spawn
from x3d2_tpu_torch.parallel.topo import ProcessMesh
from x3d2_tpu_torch.solver import NavierStokes
from x3d2_tpu_torch.tools.tiled_level import tiled_ranks

torch.set_num_threads(1)
threadpool_limits(1, user_api="blas")

DIMS = (16, 128, 128)
L = (2 * np.pi,) * 3
PER = ((BC.PERIODIC, BC.PERIODIC),) * 3
JPER = ((JBC.PERIODIC, JBC.PERIODIC),) * 3
NU = 1 / 1600
# x3d2_tpu's tiled mid against the port's float64 one, by kernel terms
LIMIT = {2: 2e-4, 3: 3e-5}


@pytest.fixture(autouse=True)
def _clean_switches(monkeypatch):
    for k in ("X3D2_BFLY", "X3D2_EINSUM_MID", "X3D2_PALLAS",
              "X3D2_MATMUL_PRECISION", "X3D2_FUSED_AB", "X3D2_MERGED_X"):
        monkeypatch.delenv(k, raising=False)


@pytest.fixture(scope="module")
def solvers():
    """(port solver, its operator set, x3d2_tpu solver), float32, without
    kernel branches (only their operators are used)."""
    with env_set({"X3D2_PALLAS": "0"}):
        ns = NavierStokes.build(Mesh(DIMS, L, PER), NU, device="cpu")
        jns = JNavierStokes.build(JMesh(DIMS, L, JPER), NU,
                                  dtype=jnp.float32)
    return ns, build_projection_mats(ns), jns


def _waves(ns, pm):
    """The mid's inputs from plane waves (chip_smoke.py wave_fields): the
    x stage's transforms of them, float64 numpy."""
    X, Y, Z = (torch.as_tensor(g, dtype=torch.float64)
               for g in ns.mesh.coord_grids(DataLoc.VERT))
    k = 12
    u = (torch.sin(X) * torch.cos(k * Y) * torch.cos(Z)
         + 0.5 * torch.cos(2 * X + (k - 1) * Y))
    v = (torch.cos(X) * torch.sin(k * Y) * torch.cos(2 * Z)
         + 0.3 * torch.sin((k - 2) * Y + Z))
    w = (torch.cos(2 * X) * torch.cos((k - 1) * Y) * torch.sin(Z)
         + 0.2 * torch.sin(X + k * Y + 2 * Z))
    return [t.numpy() for t in sl.x_div3_plain(u, v, w,
                                               pm.mats(torch.float64))]


def _rel(got, want):
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / np.abs(want).max())


@pytest.mark.parametrize("terms", [2, 3])
def test_tiled_plain_matches_x3d2_tpu(solvers, terms):
    ns, pm, jns = solvers
    d = _waves(ns, pm)
    m64 = pm.mats(torch.float64)
    want = [t.numpy() for t in sl.pressure_mid_tiled_plain(
        *(torch.as_tensor(x) for x in d), m64)]
    jmk = jpp.make_pressure_slab(jns, terms=terms, interpret=True)[4]
    assert jmk.tiled_supported and sl.tiled_mid_supported(ns, terms)
    got_j = jmk.tiled(DIMS[0])(*(jnp.asarray(x, jnp.float32) for x in d),
                               *jmk.tables[3:6])
    mk = sl.make_mid_local(ns, pm, terms)
    assert mk.tiled_supported
    m32 = pm.mats(torch.float32)
    got = mk.tiled(DIMS[0])(*(torch.as_tensor(x, dtype=torch.float32)
                              for x in d), m32["k2x"], m32["tx2"])
    assert len(got) == len(got_j) == 4
    for g, gj, e in zip(got, got_j, want):
        assert g.dtype == torch.float32
        assert _rel(gj, e) < LIMIT[terms]
        assert _rel(g.numpy(), e) < 3e-5
    # the tables x3d2_tpu's tiled mid reads are the port's
    for a, b in zip(jmk.tables[3:5], (m32["k2x"], m32["tx2"])):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("batch", [False, True], ids=["whole", "batch"])
def test_tiled_is_the_merged_mid_in_float64(solvers, batch):
    """Reassociation only: the tiled order transforms along y before z."""
    ns, pm, _ = solvers
    rng = np.random.default_rng(61)
    d = [torch.as_tensor(rng.standard_normal(DIMS)) for _ in range(3)]
    m64 = pm.mats(torch.float64)
    want = sl.pressure_mid_plain(*d, m64)
    if not batch:
        got = sl.pressure_mid_tiled_plain(*d, m64)
        for g, e in zip(got, want):
            assert _rel(g.numpy(), e.numpy()) < 1e-12
        # the three kernels' wrappers take their plain stages on the CPU
        q, pz, dz = sl.mid_tiled_t2(*sl.mid_tiled_t1(*d, pm), pm,
                                    m64["k2x"], m64["tx2"])
        staged = (q,) + sl.mid_tiled_t3(pz, dz, pm)
        assert all(torch.equal(a, b) for a, b in zip(staged, got))
        return
    off, n = 8, 4
    got = sl.make_mid_local(ns, pm).tiled(n)(
        *(x[off:off + n] for x in d), m64["k2x"][off:off + n],
        m64["tx2"][off:off + n])
    for g, e in zip(got, want):
        assert _rel(g.numpy(), e.numpy()[off:off + n]) < 1e-12
    with pytest.raises(ValueError, match="batch of 4"):
        sl.make_mid_local(ns, pm).tiled(4)(*d, m64["k2x"], m64["tx2"])


def test_planes_past_the_kernels_raise():
    """At 2048^2 planes x3d2_tpu's gates give the repencilled projection its
    tiled mid at terms 2 (the full-plane mid fails its VMEM gate, the tiled
    one's per-kernel estimate holds: the port's copies of the gates, held
    against x3d2_tpu's in tests/test_torch_shard_kernels.py
    test_gates_match_x3d2_tpu, where building x3d2_tpu's solver at this
    size would cost a minute). The port's kernels once stopped at 1024
    points and the projection raised here (the name is from then); their
    long form serves these planes, so the projection builds and takes the
    tiled mid, each of its three kernels in the long form."""
    dims = (128, 2048, 2048)
    with env_set({"X3D2_PALLAS": "0"}):
        ns = NavierStokes.build(Mesh(dims, L, PER), NU, device="cpu")
    pmesh = ProcessMesh(2, 2)
    assert psk.repencil_supported(ns, pmesh)
    assert not sl.tpu_slab_vmem_ok(ns, 2)
    assert sl.tiled_mid_supported(ns, 2)
    assert all(sl.tiled_geometry(s, *dims[1:])["form"] == "long"
               for s in (1, 2, 3))
    fn = psk.make_repencilled_pressure(ns, pmesh, terms=2)
    assert fn.mid.__name__ == "mid_tiled"


# ---------------------------------------------------------------------------
# the sharded step with the tiled mid
# ---------------------------------------------------------------------------

SHARD_DIMS = (64, 128, 256)
STEPS = 3


def _x3d2_tpu_sharded(monkeypatch):
    """x3d2_tpu's sharded TGV float64 step on a (2, 2) device mesh with its
    VMEM gate closed (as its tests/test_shard_kernels.py:326-329 closes it):
    u, v, w after STEPS steps, and the number of tiled-mid traces."""
    orig = jpp.slab_pressure_supported
    traced = []
    t1 = jpp._mid_t1_kernel

    def closed(ns_, terms=3, structure_only=False):
        return structure_only and orig(ns_, terms, structure_only=True)

    def spy(*refs, **kw):
        traced.append(1)
        return t1(*refs, **kw)

    case = JTGVCase(JMesh(SHARD_DIMS, L, JPER),
                    JSolverParams(Re=1600.0, time_intg="AB3", dt=1e-3),
                    dtype=jnp.float64, monitor_path=None, verbose=False,
                    keep_pressure=False)
    monkeypatch.setattr(jpp, "slab_pressure_supported", closed)
    monkeypatch.setattr(jpp, "_mid_t1_kernel", spy)
    step, st = make_sharded_step(case, make_device_mesh(2, 2))
    for _ in range(STEPS):
        st = step(st)
    return {k: np.asarray(st[k]) for k in ("u", "v", "w")}, len(traced)


def _x3d2_tpu_single():
    case = JTGVCase(JMesh(SHARD_DIMS, L, JPER),
                    JSolverParams(Re=1600.0, time_intg="AB3", dt=1e-3),
                    dtype=jnp.float64, monitor_path=None, verbose=False)
    st = case.initial_state()
    for _ in range(STEPS):
        st = case._step(st)
    return {k: np.asarray(st[k]) for k in ("u", "v", "w")}


def test_sharded_step_with_the_tiled_mid(tmp_path, monkeypatch):
    spec = {"dims": SHARD_DIMS, "mesh": (2, 2), "dtype": "float64",
            "device": "cpu", "steps": STEPS}
    res = spawn(tiled_ranks, 4, ([spec],), workdir=str(tmp_path))
    ranks = [r[0] for r in res]
    for r in ranks:
        assert r["solver"]["_repencil_pressure"] and r["mid"] == "mid_tiled"
    got = ranks[0]["state"]
    sharded, traced = _x3d2_tpu_sharded(monkeypatch)
    assert traced
    single = _x3d2_tpu_single()
    scale = np.abs(single["u"]).max()
    for k in ("u", "v", "w"):
        assert np.abs(got[k] - sharded[k]).max() < 2e-5 * scale, k
        assert np.abs(got[k] - single[k]).max() < 1e-12 * scale, k
