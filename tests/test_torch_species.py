"""Passive scalars in the port against x3d2_tpu, on the same numpy inputs.

- The species sweep chain's plain version (z, x + acc, y + acc; float32,
  at (128, 128, 256), the smallest shape the sweeps tile) against
  x3d2_tpu's transeq_species_all on its dense per-species path in float64,
  and against x3d2_tpu's species kernel chain in interpret mode (terms=3):
  3e-5 * scale, the bound x3d2_tpu holds its default-mode kernels to
  (tests/test_pallas_v3.py:63), covering float32 rounding and the band
  truncation. Each direction alone against the float64 operators, too.
- config.py parses every example input to the values x3d2_tpu.config
  gives; the TGV_species example builds its case through it, and two of
  its steps on the CPU (the xdiv chain, the species chain, the slab
  projection, plain versions) match x3d2_tpu's einsum step to 1e-5 in u,
  v, w and phi, as tests/test_fused_ab.py:61.
- Whole TGV steps with two scalars (Pr 0.7 and 1.0) in float64 on 32^3
  (x3d2_tpu's XLA path; the port's unfused step): AB3 over 3 steps, the
  start-up rows, to 1e-10 (the same float64 algebra, summed in another
  order), and a state with phi and the scalars' history handed over from
  x3d2_tpu after 3 steps continues 3 steps to x3d2_tpu's own 6 (1e-12).
- The switches and options still unported raise with scalars too.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax
import jax.numpy as jnp

from x3d2_tpu import config as jconfig
from x3d2_tpu.cases import SolverParams as JSolverParams
from x3d2_tpu.cases import TGVCase as JTGVCase
from x3d2_tpu.common import BC as JBC
from x3d2_tpu.mesh import Mesh as JMesh
from x3d2_tpu.solver import NavierStokes as JNavierStokes

from x3d2_tpu_torch import config
from x3d2_tpu_torch.cases import SolverParams, TGVCase
from x3d2_tpu_torch.common import BC
from x3d2_tpu_torch.convert import state_from_numpy, state_to_numpy
from x3d2_tpu_torch.mesh import Mesh
from x3d2_tpu_torch.ops import species_sweep as sp
from x3d2_tpu_torch.solver import NavierStokes

# one thread for torch and for numpy's BLAS: the suite runs several workers
# on one machine, and multi-threaded BLAS calls in each of them, spinning on
# oversubscribed cores, made these tests many times slower there
torch.set_num_threads(1)
threadpool_limits(1, user_api="blas")


ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = sorted((ROOT / "examples").glob("*/input.x3d"))
SHAPE = (128, 128, 256)
L = (2 * np.pi,) * 3
NU = 1 / 1600
PR = (0.7, 1.0)
NUS = tuple(NU / pr for pr in PR)


@pytest.fixture(scope="module")
def setup():
    mesh = Mesh(SHAPE, L, ((BC.PERIODIC, BC.PERIODIC),) * 3)
    ns = NavierStokes.build(mesh, NU, dtype=torch.float32, device="cpu",
                            nu_species=NUS)
    rng = np.random.default_rng(3)
    comps = tuple(rng.standard_normal(SHAPE).astype(np.float32)
                  for _ in range(3))
    phis = tuple(rng.standard_normal(SHAPE).astype(np.float32)
                 for _ in range(2))
    jmesh = JMesh(SHAPE, L, ((JBC.PERIODIC, JBC.PERIODIC),) * 3)
    jns = JNavierStokes.build(jmesh, NU, dtype=jnp.float64, nu_species=NUS)
    want = np.asarray(jns.transeq_species_all(
        jnp.asarray(np.stack(phis), jnp.float64),
        *(jnp.asarray(q, jnp.float64) for q in comps)))
    return ns, comps, phis, want


def _port_chain(ns, comps, phis):
    assert ns._species_sweeps is not None
    return ns.transeq_species_all(torch.from_numpy(np.stack(phis)),
                                  *(torch.from_numpy(q) for q in comps))


def _assert_close(got, want, tol):
    for s in range(len(want)):
        scale = np.abs(want[s]).max()
        err = np.abs(np.asarray(got[s], np.float64) - want[s]).max()
        assert err < tol * scale, f"scalar {s}: {err:.2e} vs {scale:.2e}"


def test_species_chain_matches_dense_f64(setup):
    ns, comps, phis, want = setup
    got = _port_chain(ns, comps, phis)
    assert got.shape == (2,) + SHAPE and got.dtype == torch.float32
    _assert_close(got.numpy(), want, 3e-5)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_species_sweep_plain_matches_f64(setup, axis):
    """One direction, against the float64 operators (the aligned pairing
    with the velocity component along the axis)."""
    ns, comps, phis, _ = setup
    fn = sp.make_species_sweep(ns.ops[axis], NUS, axis, SHAPE, device="cpu")
    got = fn(tuple(torch.from_numpy(p) for p in phis),
             torch.from_numpy(comps[axis]))
    o = ns.ops[axis]
    conv = comps[axis].astype(np.float64)

    def ap(M, f):
        return np.moveaxis(np.tensordot(M, f, axes=([1], [axis])), 0, axis)

    want = []
    for p, nu_s in zip(phis, NUS):
        q = p.astype(np.float64)
        want.append(-0.5 * (conv * ap(o.der1st.M64, q)
                            + ap(o.der1st_sym.M64, q * conv))
                    + nu_s * ap(o.der2nd.M64, q))
    _assert_close([g.numpy() for g in got], want, 3e-5)


def test_species_chain_matches_x3d2_tpu_kernel_chain(setup):
    """Against x3d2_tpu's species kernels in interpret mode, terms=3 (its
    bf16x6 mode, 5e-7 of float64 in tests/test_species_v3.py)."""
    from x3d2_tpu.ops.pallas_kernels import make_fused_species_v3

    ns, comps, phis, _ = setup
    jmesh = JMesh(SHAPE, L, ((JBC.PERIODIC, JBC.PERIODIC),) * 3)
    jns = JNavierStokes.build(jmesh, NU, dtype=jnp.float32, nu_species=NUS)
    jchain = make_fused_species_v3(jns.ops, NUS, SHAPE, interpret=True,
                                   terms=3)
    want = jchain(tuple(jnp.asarray(p) for p in phis),
                  *(jnp.asarray(q) for q in comps))
    _assert_close(_port_chain(ns, comps, phis).numpy(),
                  [np.asarray(x, np.float64) for x in want], 3e-5)


def test_species_sweep_rules():
    """CPU tensors take the plain version and count no launch; out may
    alias acc; a device that is neither CPU nor CUDA raises; the limits
    of x3d2_tpu's make_species_dir_v3 (:1124-1127)."""
    shape = (128, 128, 128)
    mesh = Mesh(shape, L, ((BC.PERIODIC, BC.PERIODIC),) * 3)
    ns = NavierStokes.build(mesh, NU, device="cpu", nu_species=NUS)
    fn = sp.make_species_sweep(ns.ops[1], NUS, 1, shape, accumulate=True,
                               device="cpu")
    sp.reset_launch_counts()
    z = torch.zeros(shape)
    acc = (torch.ones(shape), torch.full(shape, 2.0))
    out = fn((z, z), z, acc=acc, out=acc)
    assert out[0] is acc[0] and float(out[1].max()) == 2.0
    assert sp.launch_counts() == {}
    assert sp.variant_name(1, True) == "species_sweep[y,acc]"
    m = torch.empty(shape, device="meta")
    with pytest.raises(ValueError, match="no species sweep"):
        sp.species_sweep((m,), m, fn.blocks, NUS[:1])
    with pytest.raises(ValueError, match="no species"):
        sp.make_species_sweep(ns.ops[0], (), 0, shape, device="cpu")
    with pytest.raises(ValueError, match="capped at 8"):
        sp.make_species_sweep(ns.ops[0], (NU,) * 9, 0, shape, device="cpu")
    # more than 8 scalars: no chain; the CPU takes the dense path. The
    # chain is built where x3d2_tpu takes its sweeps: z >= 256 (at 128^3
    # its transport is the dense v1 sweep and its scalars the einsums)
    assert ns._species_sweeps is None and ns._transport == "v1"
    mesh2 = Mesh(SHAPE, L, ((BC.PERIODIC, BC.PERIODIC),) * 3)
    ns2 = NavierStokes.build(mesh2, NU, device="cpu", nu_species=NUS)
    ns9 = NavierStokes.build(mesh2, NU, device="cpu", nu_species=(NU,) * 9)
    assert ns9._species_sweeps is None and ns2._species_sweeps is not None


# ---------------------------------------------------------------------------
# config.py and the example case
# ---------------------------------------------------------------------------

def _as_dict(dc):
    return None if dc is None else dict(vars(dc))


@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.parent.name)
def test_config_parses_examples_as_x3d2_tpu(path):
    got = config.Config.from_file(str(path))
    want = jconfig.Config.from_file(str(path))
    for block in ("domain", "solver", "checkpoint", "stats", "channel",
                  "cylinder"):
        assert _as_dict(getattr(got, block)) == \
            _as_dict(getattr(want, block)), block
    assert isinstance(got.solver, SolverParams)


def test_example_species_case_matches_x3d2_tpu_f32():
    """examples/TGV_species/input.x3d through the port's config.py, at its
    own grid (128, 128, 256), keep_pressure=False: the xdiv chain, the
    species chain and the slab projection (plain versions), 2 steps,
    against x3d2_tpu's einsum step built from its own config.py."""
    path = str(ROOT / "examples" / "TGV_species" / "input.x3d")
    cfg = config.Config.from_file(path)
    assert cfg.solver.n_species == 2 and cfg.solver.pr_species == PR
    kw = dict(monitor_path=None, verbose=False, keep_pressure=False)
    case = TGVCase(Mesh.from_config(cfg.domain), cfg.solver,
                   dtype=torch.float32, device="cpu", **kw)
    assert case.solver.nu_species == pytest.approx(NUS, rel=1e-15)
    assert case._fused_ab is not None and case._ab_is_xdiv
    assert case.solver._species_sweeps is not None
    jcfg = jconfig.Config.from_file(path)
    jcase = JTGVCase(JMesh.from_config(jcfg.domain), jcfg.solver,
                     dtype=jnp.float32, **kw)
    s, js = case.initial_state(), jcase.initial_state()
    for _ in range(2):
        s, js = case.step(s), jcase._step(js)
    for k in ("u", "v", "w", "phi"):
        err = np.abs(s[k].numpy() - np.asarray(js[k])).max()
        assert err < 1e-5, f"{k}: {err:.2e}"
    assert len(s["olds"]) == 4 and s["olds"][3][0].shape == (2,) + SHAPE


# ---------------------------------------------------------------------------
# whole steps in float64, and the state handed over
# ---------------------------------------------------------------------------

def _cases(time_intg="AB3"):
    shape = (32,) * 3
    mesh = Mesh(shape, L, ((BC.PERIODIC, BC.PERIODIC),) * 3)
    jmesh = JMesh(shape, L, ((JBC.PERIODIC, JBC.PERIODIC),) * 3)
    kw = dict(monitor_path=None, verbose=False)
    sp_kw = dict(Re=1600, time_intg=time_intg, dt=1e-3, n_species=2,
                 pr_species=PR)
    case = TGVCase(mesh, SolverParams(**sp_kw), dtype=torch.float64,
                   device="cpu", **kw)
    jcase = JTGVCase(jmesh, JSolverParams(**sp_kw), dtype=jnp.float64, **kw)
    return case, jcase


def _jax_to_numpy(state):
    out = {k: np.asarray(state[k]) for k in ("u", "v", "w", "p", "phi")}
    out["istep"] = int(state["istep"])
    if "olds" in state:
        out["olds"] = tuple(tuple(np.asarray(o) for o in per)
                            for per in state["olds"])
    return out


def test_tgv_species_ab3_matches_f64():
    case, jcase = _cases()
    assert case._fused_ab is None   # 32 is below the sweep kernel's tiles
    s = case.run(n_iters=3, n_output=1)
    js = jcase.run(n_iters=3, n_output=1)
    for k in ("u", "v", "w", "phi"):
        np.testing.assert_allclose(s[k].numpy(), np.asarray(js[k]), rtol=0,
                                   atol=1e-10)
    np.testing.assert_allclose(np.array(case.monitor.rows)[:, 4],
                               np.array(jcase.monitor.rows)[:, 4],
                               rtol=1e-12, atol=0)
    # the scalars diffuse: their variance falls
    phi0 = case.initial_state()["phi"]
    assert float((s["phi"] ** 2).sum()) < float((phi0 ** 2).sum())


def test_species_state_handover_from_x3d2_tpu_continues_exactly():
    case, jcase = _cases()
    js = jcase.run(n_iters=3)
    handed = _jax_to_numpy(js)
    js = jcase.run(n_iters=3, state=js)
    s = state_from_numpy(handed, device="cpu")
    assert s["istep"] == 4 and s["phi"].shape == (2, 32, 32, 32)
    assert len(s["olds"]) == 4 and len(s["olds"][3]) == 2
    got = state_to_numpy(case.run(n_iters=3, state=s))
    want = _jax_to_numpy(jax.device_get(js))
    assert got["istep"] == want["istep"] == 7
    for k in ("u", "v", "w", "phi"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-12)
    for per_g, per_w in zip(got["olds"], want["olds"]):
        for g, w in zip(per_g, per_w):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-12)


def test_unported_options_with_species_raise(monkeypatch):
    # the bfloat16 history, compensated stepping and the mid cut at q are
    # ported (with scalars too: tests/test_torch_bf16.py,
    # test_torch_compensated.py, test_torch_switches.py; the name is from
    # when the cut raised): the cut is read where the slab's mid runs, as
    # x3d2_tpu reads it, and gives the merged mid's bits there; a grid
    # without the slab runs as without it
    monkeypatch.setenv("X3D2_MID_SPLIT", "1")
    case, _ = _cases()
    assert case.solver._slab is None
    ns = NavierStokes.build(Mesh((128, 128, 256), L,
                                 ((BC.PERIODIC, BC.PERIODIC),) * 3),
                            1e-3, device="cpu", nu_species=(1e-3, 1e-3))
    rng = np.random.default_rng(5)
    f = [torch.from_numpy(rng.standard_normal((128, 128, 256))
                          .astype(np.float32)) for _ in range(3)]
    split = ns.pressure_correction(*f, keep_pressure=True)
    monkeypatch.delenv("X3D2_MID_SPLIT")
    merged = ns.pressure_correction(*f, keep_pressure=True)
    assert all(torch.equal(a, b) for a, b in zip(split, merged))
    mesh = Mesh((32,) * 3, L, ((BC.PERIODIC, BC.PERIODIC),) * 3)
    params = SolverParams(n_species=2, pr_species=PR, compensated=True)
    case = TGVCase(mesh, params, device="cpu", monitor_path=None)
    assert len(case.initial_state()["comp"]) == 4
    with pytest.raises(ValueError, match="Prandtl"):
        TGVCase(mesh, SolverParams(n_species=2), device="cpu",
                monitor_path=None)
