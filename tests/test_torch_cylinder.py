"""The cylinder case (x inflow/outflow, IBM) and the slab's dense x stage
against x3d2_tpu, on the CPU at (17, 128, 128): a Dirichlet x of 16 cells,
the smallest y and z the slab tiles.

- ibm: cylinder_mask, load_mask (.npy, .npz) and get_mask equal
  x3d2_tpu's.
- The dense x apply's plain version, with and without the subtraction, vs
  x3d2_tpu's make_x_apply(M64, terms=2, interpret=True) in float32: <=
  2e-4 * scale, the bound of tests/test_pallas_poisson.py:50-54; in
  float64 vs the float64 operator: <= 1e-12 * scale.
- The port's slab projection with the dense x stage vs x3d2_tpu's
  transform-folded chain (pressure_grads) in float64, both keep_pressure
  modes: u, v, w and p within 1e-10 * scale; the solve tables, the
  Nyquist indicators among them, equal those of x3d2_tpu's slab.
- The Nyquist line: where the Poisson variant zeros it ("100" with even ny
  and nz: the (ny/2, nz/2) line on every x plane), the solve factor is 0
  there even where the wave tables do not vanish.
- CylinderCase AB3 float64, 3 steps from x3d2_tpu's initial state with the
  same mask and inlet_noise = 0: u, v, w within 1e-10 * scale.
- config.py builds examples/cylinder/input.x3d, and a channel and a generic
  case on its mesh.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax.numpy as jnp

from x3d2_tpu import ibm as jibm
from x3d2_tpu.cases import CylinderCase as JCylinderCase
from x3d2_tpu.common import BC as JBC
from x3d2_tpu.config import Config as JConfig
from x3d2_tpu.mesh import Mesh as JMesh
from x3d2_tpu.ops.pallas_poisson import make_pressure_slab, make_x_apply
from x3d2_tpu.solver import NavierStokes as JNavierStokes

from x3d2_tpu_torch import config, ibm
from x3d2_tpu_torch.cases import ChannelCase, CylinderCase, GenericCase
from x3d2_tpu_torch.common import BC
from x3d2_tpu_torch.convert import state_from_numpy, state_to_numpy
from x3d2_tpu_torch.mesh import Mesh
from x3d2_tpu_torch.ops import operator_apply as oa
from x3d2_tpu_torch.ops import pressure_slab as sl
from x3d2_tpu_torch.ops.parity import solve_factor
from x3d2_tpu_torch.solver import NavierStokes

# one thread for torch and for numpy's BLAS: the suite runs several workers
# on one machine, and multi-threaded BLAS calls in each of them, spinning on
# oversubscribed cores, made these tests many times slower there
torch.set_num_threads(1)
threadpool_limits(1, user_api="blas")

ROOT = Path(__file__).resolve().parents[1]
EXAMPLE = ROOT / "examples" / "cylinder" / "input.x3d"
SHAPE = (17, 128, 128)
L = (20.0, 10.0, 2.5)
BCS = ((BC.DIRICHLET, BC.DIRICHLET),) + ((BC.PERIODIC, BC.PERIODIC),) * 2
JBCS = ((JBC.DIRICHLET, JBC.DIRICHLET),) + ((JBC.PERIODIC, JBC.PERIODIC),) * 2
NU = 1 / 300


def _mesh():
    return Mesh(SHAPE, L, BCS)


def _jmesh():
    return JMesh(SHAPE, L, JBCS)


def _fields(shape, n, dtype=np.float64, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(dtype) for _ in range(n)]


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


@pytest.fixture(scope="module")
def solver64():
    return NavierStokes.build(_mesh(), NU, dtype=torch.float64, device="cpu")


@pytest.fixture(scope="module")
def jsolver64():
    return JNavierStokes.build(_jmesh(), NU, dtype=jnp.float64)


def test_ibm_masks_match_x3d2_tpu(tmp_path):
    mesh, jmesh = _mesh(), _jmesh()
    got = ibm.cylinder_mask(mesh)
    np.testing.assert_array_equal(got, jibm.cylinder_mask(jmesh))
    assert 0 < got.sum() < got.size
    np.testing.assert_array_equal(
        ibm.cylinder_mask(mesh, center_xy=(8.0, 4.0), radius=1.0, axis=2),
        jibm.cylinder_mask(jmesh, center_xy=(8.0, 4.0), radius=1.0, axis=2))
    assert ibm.default_mask_path(mesh) == jibm.default_mask_path(jmesh)
    ep = (np.arange(got.size).reshape(got.shape) % 3 > 0).astype(float)
    np.save(tmp_path / "m.npy", ep)
    np.savez(tmp_path / "m.npz", ep=ep)
    for name in ("m.npy", "m.npz"):
        path = str(tmp_path / name)
        np.testing.assert_array_equal(ibm.load_mask(path, mesh),
                                      jibm.load_mask(path, jmesh))
        np.testing.assert_array_equal(ibm.get_mask(mesh, path), ep)
    np.testing.assert_array_equal(
        ibm.get_mask(mesh, str(tmp_path / "absent.npy")), got)
    with pytest.raises(ValueError, match="vert dims"):
        ibm.load_mask(path, Mesh((33, 128, 128), L, BCS))


@pytest.mark.parametrize("name,sub", [("sx", False), ("ix", False),
                                      ("gxs", True), ("gxi", True)])
def test_x_apply_plain_matches_x3d2_tpu(solver64, name, sub):
    slab = solver64._slab
    assert slab is not None and slab.x_perm is None   # the dense x stage
    M64 = slab.m64[name]
    n_out, n_in = M64.shape
    assert {n_out, n_in} == {16, 17}
    f, s = _fields((n_in,) + SHAPE[1:], 1, seed=1)[0], None
    if sub:
        s = _fields((n_out,) + SHAPE[1:], 1, seed=2)[0]
    # float32 vs x3d2_tpu's kernel in interpret mode
    f32 = [a.astype(np.float32) for a in (f, s) if a is not None]
    got = sl.x_apply(name, *[torch.from_numpy(a) for a in f32[:1]], slab,
                     *[torch.from_numpy(a) for a in f32[1:]])
    fn = make_x_apply(M64, terms=2, sub=sub, interpret=True)
    want = fn(*(jnp.asarray(a) for a in f32))
    assert got.dtype == torch.float32 and got.shape == (n_out,) + SHAPE[1:]
    assert _rel(got.numpy(), want) <= 2e-4
    # float64 vs the float64 operator
    got64 = sl.x_apply(name, torch.from_numpy(f), slab,
                       None if s is None else torch.from_numpy(s))
    ref = np.tensordot(M64, f, axes=([1], [0]))
    if sub:
        ref = s - ref
    assert _rel(got64.numpy(), ref) <= 1e-12


def test_x_apply_cpu_counts_no_launch(solver64):
    oa.reset_launch_counts()
    f = torch.zeros(SHAPE, dtype=torch.float64)
    sl.x_apply("sx", f, solver64._slab)
    assert oa.launch_counts() == {}
    m = torch.empty(SHAPE, device="meta")
    with pytest.raises(ValueError, match="no x_apply"):
        sl.x_apply("sx", m, solver64._slab)


@pytest.mark.parametrize("keep_pressure", [False, True])
def test_slab_dense_x_matches_folded_chain_f64(solver64, jsolver64,
                                               keep_pressure):
    assert solver64._pipe is None   # x is not periodic
    u, v, w = _fields(SHAPE, 3, seed=3)
    got = solver64.pressure_correction(
        *(torch.from_numpy(a) for a in (u, v, w)),
        keep_pressure=keep_pressure)
    grads = jsolver64.pressure_grads(*(jnp.asarray(a) for a in (u, v, w)),
                                     keep_pressure=keep_pressure)
    for g, f, d in zip(got[:3], (u, v, w), grads[:3]):
        assert _rel(g.numpy(), f - np.asarray(d)) <= 1e-10
    if keep_pressure:
        assert _rel(got[3].numpy(), grads[3]) <= 1e-10
    else:
        assert got[3] is None


def test_solve_tables_match_x3d2_tpu_slab(solver64):
    """The folded-x solve tables and the Nyquist indicators equal those
    of x3d2_tpu's make_pressure_slab (natural x order, block-parity y and
    z)."""
    jns32 = JNavierStokes.build(_jmesh(), NU, dtype=jnp.float32)
    tabs = make_pressure_slab(jns32, terms=3, interpret=True)[4].tables
    A, B, Myz, k2x, tx2, mx = (np.asarray(t, np.float64) for t in tabs)
    m = solver64._slab.m64
    ny, nz = SHAPE[1:]
    # x3d2_tpu's tables are float32: the (Nyquist, Nyquist) entry of A,
    # 1e-63 in float64, underflows to 0 there
    np.testing.assert_allclose(m["tab_a"].reshape(ny, nz), A, rtol=1e-6,
                               atol=1e-37)
    np.testing.assert_allclose(m["tab_b"].reshape(ny, nz), B, rtol=1e-6)
    np.testing.assert_allclose(m["k2x"], k2x, rtol=1e-6)
    np.testing.assert_allclose(m["tx2"], tx2, rtol=1e-6)
    np.testing.assert_array_equal(m["myz"].reshape(ny, nz), Myz)
    np.testing.assert_array_equal(m["mx"], mx)
    assert Myz.sum() == 1 and mx.min() == 1   # one line, on every x plane


def test_nyquist_line_is_zeroed(solver64):
    """Energy on exactly the zeroed line: the solve factor with the mask
    keeps nothing of it, and without the mask it would (the wave tables
    made regular on that line, where the compact interpolations' own
    zero otherwise hides the mask behind the zero-wave guard)."""
    pm = solver64._slab
    m = dict(pm.mats(torch.float64))
    ny, nz = SHAPE[1:]
    line = (m["myz"].reshape(ny, nz) > 0)
    # regular waves everywhere: positive tables
    m["tab_a"] = torch.ones_like(m["tab_a"])
    m["tab_b"] = torch.full_like(m["tab_b"], 2.0)
    shape = pm.shape
    F = torch.from_numpy(_fields(shape, 1, seed=4)[0])
    q = F * solve_factor(m, shape)
    assert float(q[:, line].abs().max()) == 0.0
    assert torch.equal(q[:, ~line], (F * solve_factor(
        {k: t for k, t in m.items() if k not in ("myz", "mx")},
        shape))[:, ~line])
    unmasked = F * solve_factor({k: t for k, t in m.items()
                                 if k not in ("myz", "mx")}, shape)
    assert float(unmasked[:, line].abs().min()) > 0


def test_cylinder_steps_match_x3d2_tpu_f64():
    cfg = config.Config.from_file(str(EXAMPLE))
    jcfg = JConfig.from_file(str(EXAMPLE))
    for c in (cfg.cylinder, jcfg.cylinder):
        c.inlet_noise = (0.0, 0.0, 0.0)
    mask = ibm.cylinder_mask(_mesh())
    kw = dict(monitor_path=None, verbose=False, keep_pressure=False, seed=3)
    case = CylinderCase(_mesh(), cfg.solver, dtype=torch.float64,
                        device="cpu", case_cfg=cfg.cylinder, ibm_mask=mask,
                        **kw)
    jcase = JCylinderCase(_jmesh(), jcfg.solver, dtype=jnp.float64,
                          case_cfg=jcfg.cylinder, ibm_mask=mask, **kw)
    assert case.solver._transport == "dense" and case._fused_ab is None
    assert case.solver._slab is not None and case.solver._pipe is None
    js = jcase.initial_state()
    s = state_from_numpy({k: np.asarray(js[k]) for k in
                          ("u", "v", "w", "p", "istep")}
                         | {"olds": tuple(tuple(np.asarray(o) for o in per)
                                          for per in js["olds"])},
                         device="cpu", seed=3)
    for _ in range(3):
        s = case.step(s)
        js = jcase._step(js)
    for k in ("u", "v", "w"):
        assert _rel(s[k].numpy(), js[k]) <= 1e-10, k
    # the inflow plane and the body
    assert abs(float(s["u"][0].mean()) - 1.0) < 0.1
    assert float(s["u"][torch.from_numpy(mask == 0)].abs().max()) < 0.5
    out = state_to_numpy(s)
    assert "rng" not in out and out["istep"] == 4


def test_config_builds_the_example():
    cfg = config.Config.from_file(str(EXAMPLE))
    case = config.make_case(cfg, dtype=torch.float32, monitor_path=None,
                            verbose=False, keep_pressure=False, device="cpu")
    assert isinstance(case, CylinderCase)
    assert case.mesh.dims(0) == (257, 128, 32) and case.params.ibm_on
    assert case.cfg.inlet_noise == (0.0125, 0.0, 0.0)
    assert case.ep is not None and case.ep.shape == (257, 128, 32)
    # x3d2_tpu runs no kernel here: dense transport, the folded chain
    assert case.solver._transport == "dense" and case.solver._slab is None
    assert case.solver._projection_gap is None
    # the channel (refused until its stretched-y Poisson solve was ported)
    # builds on the same input, with &channel_nml's defaults
    cfg.domain.flow_case_name = "channel"
    case = config.make_case(cfg, dtype=torch.float32, monitor_path=None,
                            verbose=False, device="cpu")
    assert isinstance(case, ChannelCase) and case.name == "channel"
    assert case.cfg == config.ChannelConfig()
    cfg.domain.flow_case_name = "generic"
    case = config.make_case(cfg, dtype=torch.float32, monitor_path=None,
                            verbose=False, device="cpu")
    assert isinstance(case, GenericCase) and case.name == "generic"
