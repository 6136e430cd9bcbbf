"""The port's sharded step on torch.distributed ranks against x3d2_tpu,
on the CPU: gloo ranks spawned on this host (a FileStore under the test's
temporary directory, no port), float64, the plain versions of the kernels.

- TGV AB3 at (128, 256, 256) on a (2, 2) mesh, where the sharded sweeps
  (halo form on y and z) and the repencilled projection are both active,
  3 steps, against x3d2_tpu's single-device TGVCase step: u, v, w within
  2e-8 * max |u|. The sharded sweeps' band (W = 16, truncating 1e-6 of the
  operators' largest entry, the kernels') stands where x3d2_tpu's
  single-device CPU step takes the dense operators: measured 2.9e-9 after
  3 steps; the limit is about 7x that, where x3d2_tpu's own
  sharded-vs-single check (tests/test_sharding.py:42-45, its
  interpret-mode kernels against itself) is 1e-13.
- The same at 64 x 128 x 256 on (2, 2), x3d2_tpu's tier-2 configuration,
  where the local x extent fails the sharded sweep gate and the transeq
  is the halo-mode operator path (halo applies, w = 48 in float64, and the
  per-rank x applies): 1e-12 * max |u| (measured 2.9e-15).
- The branches the single-device step opens beyond the main one, on one
  spawn of the same (2, 2) ranks: keep_pressure=True (the physical
  pressure from q by the inverse y and z transforms on the x batch, the
  all-to-alls back and the inverse x transform) at 64 x 128 x 256, u, v, w
  and p against x3d2_tpu's p; X3D2_BFLY=0 (the dense x applies and the
  dense local mid) at the same size; RK3 unfused (X3D2_FUSED_RK=0, the
  sweeps' RK substages, the update elementwise) with keep_pressure=True at
  128 x 256 x 256, one step (three substages), against x3d2_tpu's RK3.
- The monitor's KE, enstrophy and div_u_max, reduced over the ranks,
  against the single-process monitor on the gathered fields (1e-12
  relative; div_u_max, of order 1e-13, to 1e-13 absolute).
- convert's round trip: x3d2_tpu's initial state (numpy) to the ranks'
  blocks and gathered back, bit for bit.
- The raises: an x-decomposed mesh; a sharded grid without the
  repencilled projection (x3d2_tpu's GSPMD spectral pressure_grads);
  compensated stepping under make_sharded_step (the fused RK step runs on
  gathered fields: tests/test_torch_sharded_io.py).
"""

import math
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
from threadpoolctl import threadpool_limits

import jax
import jax.numpy as jnp

from x3d2_tpu.cases import SolverParams as JSolverParams
from x3d2_tpu.cases import TGVCase as JTGVCase
from x3d2_tpu.common import BC as JBC
from x3d2_tpu.mesh import Mesh as JMesh

from x3d2_tpu_torch.cases import SolverParams, TGVCase
from x3d2_tpu_torch.common import BC
from x3d2_tpu_torch.io.monitoring import make_observables_fn
from x3d2_tpu_torch.mesh import Mesh
from x3d2_tpu_torch.parallel import make_process_mesh, make_sharded_step
from x3d2_tpu_torch.parallel.multihost import maybe_init_distributed
from x3d2_tpu_torch.parallel.topo import ProcessMesh, field_spec, local_slices
from x3d2_tpu_torch.tools import shard_run

torch.set_num_threads(1)
threadpool_limits(1, user_api="blas")

L = (2 * math.pi,) * 3
PER = ((BC.PERIODIC, BC.PERIODIC),) * 3
JPER = ((JBC.PERIODIC, JBC.PERIODIC),) * 3
STEPS = 3


@pytest.fixture(autouse=True)
def _clean_switches(monkeypatch):
    for k in ("X3D2_FUSED_AB", "X3D2_FUSED_RK", "X3D2_PALLAS", "X3D2_BFLY",
              "X3D2_EINSUM_MID", "X3D2_MATMUL_PRECISION", "X3D2_D2C"):
        monkeypatch.delenv(k, raising=False)


def _x3d2_tpu(dims, steps=STEPS, time_intg="AB3", **kw):
    """x3d2_tpu's single-device TGV float64 (keep_pressure, its default):
    (initial state, state after `steps`) as numpy."""
    case = JTGVCase(JMesh(dims, L, JPER),
                    JSolverParams(Re=1600.0, time_intg=time_intg, dt=1e-3,
                                  **kw),
                    dtype=jnp.float64, monitor_path=None, verbose=False)
    st = case.initial_state()
    st0 = jax.tree_util.tree_map(np.asarray, {k: v for k, v in st.items()
                                              if k != "key"})
    for _ in range(steps):
        st = case._step(st)
    return st0, {k: np.asarray(st[k]) for k in ("u", "v", "w", "p")
                 + (("phi",) if "phi" in st else ())}


def _spawn(dims, mesh, tmp, **spec):
    return shard_run.run({"dims": dims, "mesh": mesh, "dtype": "float64",
                          "device": "cpu", **spec}, workdir=str(tmp))


@pytest.fixture(scope="module")
def kernels_2x2(tmp_path_factory):
    dims = (128, 256, 256)
    st0, ref = _x3d2_tpu(dims)
    res = _spawn(dims, (2, 2), tmp_path_factory.mktemp("ranks"),
                 steps=STEPS)
    return dims, ref, res


@pytest.fixture(scope="module")
def ref_halo():
    return _x3d2_tpu((64, 128, 256))[1]


@pytest.fixture(scope="module")
def halo_2x2(tmp_path_factory, ref_halo):
    dims = (64, 128, 256)
    res = _spawn(dims, (2, 2), tmp_path_factory.mktemp("ranks"),
                 steps=STEPS)
    return dims, ref_halo, res


# the other branches, one spawn: (spec, x3d2_tpu's reference of it)
MODES = {
    "keep_pressure": {"dims": (64, 128, 256), "steps": STEPS,
                      "keep_pressure": True},
    "dense": {"dims": (64, 128, 256), "steps": STEPS,
              "env": {"X3D2_BFLY": "0"}},
    "rk3": {"dims": (128, 256, 256), "steps": 1, "time_intg": "RK3",
            "keep_pressure": True, "env": {"X3D2_FUSED_RK": "0"}},
}


@pytest.fixture(scope="module")
def modes_2x2(tmp_path_factory, ref_halo):
    specs = [{"mesh": (2, 2), "dtype": "float64", "device": "cpu", **spec}
             for spec in MODES.values()]
    res = shard_run.run_many(specs, workdir=str(tmp_path_factory.mktemp(
        "ranks")))
    refs = {"keep_pressure": ref_halo, "dense": ref_halo,
            "rk3": _x3d2_tpu((128, 256, 256), steps=1, time_intg="RK3")[1]}
    return {name: (refs[name], r) for name, r in zip(MODES, res)}


def _err(res, ref, names=("u", "v", "w")):
    """The largest difference of the velocities over max |u|, and of p over
    max |p|."""
    got = res[0]["state"]
    scale = {k: np.abs(ref["p" if k == "p" else "u"]).max() for k in names}
    return max(np.abs(got[k] - ref[k]).max() / scale[k] for k in names)


def test_sharded_step_with_kernels(kernels_2x2):
    dims, ref, res = kernels_2x2
    assert res[0]["solver"] == {"_sharded_transeq": True,
                                "_sharded_species": False,
                                "_repencil_pressure": True,
                                "_halo_mode": True}
    assert _err(res, ref) < 2e-8


def test_sharded_step_halo_mode(halo_2x2):
    dims, ref, res = halo_2x2
    assert res[0]["solver"] == {"_sharded_transeq": False,
                                "_sharded_species": False,
                                "_repencil_pressure": True,
                                "_halo_mode": True}
    assert _err(res, ref) < 1e-12


@pytest.mark.parametrize("mode,sweeps,dense,limit,p_limit", [
    ("keep_pressure", False, False, 1e-14, 1e-12),
    ("dense", False, True, 1e-14, None),
    ("rk3", True, False, 7e-9, 8e-7)], ids=list(MODES))
def test_sharded_step_modes(modes_2x2, mode, sweeps, dense, limit, p_limit):
    """u, v, w within `limit` of max |u|, and the kept pressure within
    `p_limit` of max |p|. Measured: keep_pressure 2.9e-15 and p 2.2e-13;
    dense 6.7e-16; rk3 9.4e-10 and p 1.16e-7, the sharded sweeps' band
    (W = 16) where x3d2_tpu's step takes the dense operators: p is of the
    order of the right-hand side, which the band moves by ~1e-7, while u
    moves by dt times that. The sharded step's p differs from the port's
    own single-card float64 step, which also takes the dense operators
    there, by the same 1.16e-7, and at 64 x 128 x 256, where the transeq
    is the operator path in both, by 2.2e-13."""
    ref, res = modes_2x2[mode]
    assert res[0]["solver"] == {"_sharded_transeq": sweeps,
                                "_sharded_species": False,
                                "_repencil_pressure": True,
                                "_halo_mode": True}
    assert res[0]["dense_mid"] is dense
    assert _err(res, ref) < limit
    if p_limit is not None:
        assert _err(res, ref, ("p",)) < p_limit


@pytest.mark.parametrize("which", ["kernels_2x2", "halo_2x2"])
def test_monitor_is_global(which, request):
    dims, _, res = request.getfixturevalue(which)
    st = res[0]["state"]
    solver = TGVCase(Mesh(dims, L, PER), SolverParams(), dtype=torch.float64,
                     monitor_path=None, verbose=False, device="cpu").solver
    want = {k: float(v) for k, v in make_observables_fn(solver)(
        *(torch.as_tensor(st[k]) for k in ("u", "v", "w"))).items()}
    for r in res:
        got = r["obs"]
        for k in ("ke", "enstrophy"):
            assert abs(got[k] - want[k]) <= 1e-12 * abs(want[k]), k
        assert abs(got["div_u_max"] - want["div_u_max"]) <= 1e-13
        assert got == res[0]["obs"]


def test_convert_round_trip(tmp_path):
    dims = (64, 128, 256)
    st0, _ = _x3d2_tpu(dims, steps=0)
    res = _spawn(dims, (2, 2), tmp_path, steps=0, state=st0)
    got = res[0]["state"]
    for k in ("u", "v", "w", "p"):
        assert got[k].dtype == st0[k].dtype
        np.testing.assert_array_equal(got[k], st0[k])


def test_single_process_is_a_no_op(monkeypatch):
    """As x3d2_tpu's maybe_init_distributed: one process initialises no
    group; a rendezvous without a world of more than one process, or a
    world without this process's rank, raises."""
    for k in ("WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert maybe_init_distributed() is False
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="world size"):
        maybe_init_distributed(init_method="file:///nonexistent/store")
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(ValueError, match="RANK"):
        maybe_init_distributed()
    assert not dist.is_initialized()


@pytest.mark.parametrize("mesh,shape", [((2, 2), (4, 8, 8)),
                                        ((1, 4), (4, 8, 8)),
                                        ((2, 4), (2, 4, 6))],
                         ids=["2x2", "1x4", "2x4-z-whole"])
def test_local_slices_partition(mesh, shape):
    """The ranks' blocks cover the field, each point once; an axis whose
    extent does not divide its mesh dimension stays whole on every rank
    (x3d2_tpu's field_spec), so its points are held once per rank along
    that mesh axis."""
    pmesh = ProcessMesh(*mesh)
    spec = field_spec(pmesh, shape)
    copies = math.prod(pmesh.shape[n] for n in ("y", "z") if n not in spec)
    count = np.zeros(shape, int)
    for r in range(pmesh.size):
        count[local_slices(pmesh, shape, r)] += 1
    assert (count == copies).all()
    assert spec == ((None, "y", None) if shape == (2, 4, 6)
                    else (None, "y", "z"))


def test_raises_x_mesh():
    with pytest.raises(NotImplementedError, match="x-decomposed"):
        make_process_mesh(1, 1, nproc_x=2)


def _case(dims, **kw):
    return TGVCase(Mesh(dims, L, PER), SolverParams(**kw),
                   dtype=torch.float64, monitor_path=None, verbose=False,
                   keep_pressure=False, device="cpu")


def test_raises_without_repencil():
    """(64, 128, 128) on (2, 2): the local z extent (64) fails the per-rank
    x applies' tiling, so x3d2_tpu has no repencilled projection there and
    projects with its GSPMD spectral chain. Building the step needs no
    exchange; the projection raises before any."""
    pmesh = ProcessMesh(2, 2, device=torch.device("cpu"))
    case = _case((64, 128, 128))
    step, st = make_sharded_step(case, pmesh)
    solver = case._sharded_solver
    assert solver._halo_mode
    assert getattr(solver, "_repencil_pressure", None) is None
    with pytest.raises(NotImplementedError, match="GSPMD"):
        solver.pressure_correction(st["u"], st["v"], st["w"],
                                   keep_pressure=False)


@pytest.mark.parametrize("kw,match", [
    ({"compensated": True}, "compensated")], ids=["compensated"])
def test_raises_step_branches(kw, match):
    pmesh = ProcessMesh(2, 2, device=torch.device("cpu"))
    case = _case((64, 128, 256), **kw)
    with pytest.raises(NotImplementedError, match=match):
        make_sharded_step(case, pmesh)
