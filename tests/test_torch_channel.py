"""The channel case (x3d2_tpu_torch/cases/channel.py) against x3d2_tpu's,
float64 on the CPU at 16 x 17 x 16 (walls in y, 16 cells), Re 4200, dt
5e-3, seed 3.

- Steps: RK3 on a top-bottom, a bottom and a uniform y, and AB3 on a
  top-bottom y, with inlet_noise = 0 (the example's own setting: JAX's key
  and the port's generator draw different wall noise) and the rotation on
  for the first 2 of 4 steps: u, v, w within 1e-10 * max |u| after each
  step (the same float64 algebra in another order; the steps read 1e-15).
  The case stays off the fused chains (its forcings hook), as x3d2_tpu's.
- The hooks: define_bc shifts u by 2/3 - sum(u) / cells (the sum over
  the vertices, as channel.f90:70-78) and draws planes within
  +-inlet_noise; apply_bc stamps them on the y walls; after a few steps
  the bulk is near 2/3.
- Nonzero inlet noise: one seed gives one run bit for bit, another seed
  another; a restart from a checkpoint continues bit for bit (the
  generator's state is in the file).
- Checkpoints across the packages: x3d2_tpu's step-2 file continued 2
  steps in the port equals x3d2_tpu's own 4 steps, and the other way
  (1e-12 of the largest value).
- examples/channel/input.x3d through config.make_case (128 x 65 x 64
  top-bottom, its routes: the dense transport, the eigen-resolved
  transform-folded projection, no kernel gate), with
  poisson_solver_type = 'CG' (BiCGStab); and cut to 16 x 17 x 16 through
  the CLI against x3d2_tpu.__main__.main, with the FFT and the CG solve
  (monitoring rows and checkpoints: tests/test_torch_cli.py's rules; with
  CG to 1e-9 of the largest value, its stopping tolerance's level).
"""

from pathlib import Path

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax.numpy as jnp

from x3d2_tpu.__main__ import main as jmain
from x3d2_tpu.cases import ChannelCase as JChannelCase
from x3d2_tpu.cases import SolverParams as JSolverParams
from x3d2_tpu.common import BC as JBC
from x3d2_tpu.config import CheckpointConfig as JCheckpointConfig
from x3d2_tpu.config import ChannelConfig as JChannelConfig
from x3d2_tpu.config import StatsConfig as JStatsConfig
from x3d2_tpu.io.manager import IOManager as JIOManager
from x3d2_tpu.mesh import Mesh as JMesh

from x3d2_tpu_torch import config
from x3d2_tpu_torch.__main__ import main
from x3d2_tpu_torch.cases import ChannelCase, SolverParams
from x3d2_tpu_torch.common import BC
from x3d2_tpu_torch.config import (ChannelConfig, CheckpointConfig,
                                   StatsConfig)
from x3d2_tpu_torch.io.manager import IOManager
from x3d2_tpu_torch.mesh import Mesh
from x3d2_tpu_torch.ops.cg_poisson import CGPoisson
from test_torch_cli import _rows, _run

torch.set_num_threads(1)
threadpool_limits(1, user_api="blas")

ROOT = Path(__file__).resolve().parent.parent
EXAMPLE = ROOT / "examples" / "channel" / "input.x3d"
DIMS = (16, 17, 16)
L = (4.0, 2.0, 2.0)
NOISE = (0.05, 0.02, 0.03)


def _bcs(B):
    return ((B.PERIODIC, B.PERIODIC), (B.DIRICHLET, B.DIRICHLET),
            (B.PERIODIC, B.PERIODIC))


def _cfg(inlet=(0.0, 0.0, 0.0)):
    return dict(init_noise=(0.125,) * 3, inlet_noise=inlet, rotation=True,
                omega_rot=0.12, n_rotate=2)


def _case(stretching="top-bottom", time_intg="RK3", inlet=(0.0,) * 3,
          seed=3):
    kw = dict(stretching=("uniform", stretching, "uniform"),
              beta=(1.0, 0.259065151, 1.0))
    return ChannelCase(Mesh(DIMS, L, _bcs(BC), **kw),
                       SolverParams(Re=4200.0, time_intg=time_intg, dt=5e-3),
                       dtype=torch.float64, monitor_path=None, verbose=False,
                       device="cpu", seed=seed,
                       case_cfg=ChannelConfig(**_cfg(inlet)))


def _jcase(stretching="top-bottom", time_intg="RK3"):
    kw = dict(stretching=("uniform", stretching, "uniform"),
              beta=(1.0, 0.259065151, 1.0))
    return JChannelCase(JMesh(DIMS, L, _bcs(JBC), **kw),
                        JSolverParams(Re=4200.0, time_intg=time_intg,
                                      dt=5e-3),
                        dtype=jnp.float64, monitor_path=None, verbose=False,
                        seed=3, case_cfg=JChannelConfig(**_cfg()))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("stretching, time_intg", [
    ("top-bottom", "RK3"), ("bottom", "RK3"), ("uniform", "RK3"),
    ("top-bottom", "AB3")])
def test_steps_match_x3d2_tpu(stretching, time_intg):
    case, jcase = _case(stretching, time_intg), _jcase(stretching, time_intg)
    assert case.solver._transport == "dense"
    assert case._fused_ab is None and case._fused_rk is None
    assert case.solver._projection_gap is None
    s, js = case.initial_state(), jcase.initial_state()
    for k in "uvw":
        assert np.array_equal(s[k].numpy(), np.asarray(js[k])), k
    for _ in range(4):
        s, js = case.step(s), jcase._step(js)
        scale = float(np.abs(np.asarray(js["u"])).max())
        for k in "uvw":
            d = np.abs(s[k].numpy() - np.asarray(js[k])).max()
            assert d <= 1e-10 * scale, (k, d / scale)
    assert s["istep"] == 5


def test_hooks_walls_and_bulk():
    case = _case(inlet=NOISE)
    s = case.initial_state()
    f = (s["u"], s["v"], s["w"])
    (u, v, w), planes = case.define_bc(f, s["rng"], 1)
    ncell = np.prod(case.mesh.global_cell_dims)
    # the shift that puts sum(u) / cells at 2/3 (channel.f90:70-78: the
    # sum over the vertices, so after it the sum is 2/3 of the cell count
    # plus the shift times the extra wall plane)
    ub = float(f[0].sum()) / ncell
    assert torch.equal(u, f[0] + (2.0 / 3.0 - f[0].sum() / ncell))
    nvert = np.prod(DIMS)
    assert abs(float(u.sum()) / ncell - (2.0 / 3.0 + (2.0 / 3.0 - ub)
                                          * (nvert - ncell) / ncell)) < 1e-14
    assert v is f[1] and w is f[2]
    assert planes.shape == (3, DIMS[0], 2, DIMS[2])
    for i, a in enumerate(NOISE):
        assert float(planes[i].abs().max()) <= a
        assert float(planes[i].abs().max()) > 0.5 * a
    out = case.apply_bc((u.clone(), v.clone(), w.clone()), planes, 0.0, 1)
    for i, t in enumerate(out):
        assert torch.equal(t[:, 0, :], planes[i, :, 0, :])
        assert torch.equal(t[:, -1, :], planes[i, :, 1, :])
        assert torch.equal(t[:, 1:-1], (u, v, w)[i][:, 1:-1])
    # a few steps: the walls carry the noise and the projection's small
    # gradient update, the bulk stays near 2/3
    s = case.run(n_iters=3, state=s, n_output=10**9)
    assert float(s["v"][:, 0, :].abs().max()) < 0.2
    assert abs(float(s["u"].sum()) / ncell - 2.0 / 3.0) < 0.02


def test_wall_noise_seeded_and_restarts_bit_exact(tmp_path):
    a, b, c = (_case(inlet=NOISE, seed=sd) for sd in (3, 3, 4))
    sa = a.run(n_iters=4, state=a.initial_state(), n_output=10**9)
    sb = b.run(n_iters=4, state=b.initial_state(), n_output=10**9)
    sc = c.run(n_iters=4, state=c.initial_state(), n_output=10**9)
    for k in "uvw":
        assert torch.equal(sa[k], sb[k]), k
    assert not torch.equal(sa["u"], sc["u"])
    prefix = str(tmp_path / "ck")
    snap = dict(snapshot_prefix=str(tmp_path / "snap"))
    d = _case(inlet=NOISE)
    sd = d.run(n_iters=4, state=d.initial_state(), n_output=10**9,
               io_manager=IOManager(d, CheckpointConfig(
                   checkpoint_freq=2, checkpoint_prefix=prefix,
                   keep_checkpoint=True, **snap), StatsConfig()))
    e = _case(inlet=NOISE)
    io = IOManager(e, CheckpointConfig(
        restart_from_checkpoint=True, restart_file=f"{prefix}_000002.npz",
        **snap), StatsConfig())
    se = io.handle_restart(e.initial_state())
    assert se["istep"] == 3
    se = e.run(n_iters=2, state=se, n_output=10**9)
    for k in "uvw":
        assert torch.equal(sd[k], sa[k]) and torch.equal(se[k], sa[k]), k


def test_checkpoints_cross_the_packages(tmp_path):
    tp, jp = str(tmp_path / "t"), str(tmp_path / "j")
    snap = dict(snapshot_prefix=str(tmp_path / "snap"))
    case, jcase = _case(), _jcase()
    st = case.run(n_iters=4, state=case.initial_state(), n_output=10**9,
                  io_manager=IOManager(case, CheckpointConfig(
                      checkpoint_freq=2, checkpoint_prefix=tp,
                      keep_checkpoint=True, **snap), StatsConfig()))
    js = jcase.run(n_iters=4, state=jcase.initial_state(), n_output=10**9,
                   io_manager=JIOManager(jcase, JCheckpointConfig(
                       checkpoint_freq=2, checkpoint_prefix=jp,
                       keep_checkpoint=True, **snap), JStatsConfig()))
    c2 = _case()
    io2 = IOManager(c2, CheckpointConfig(
        restart_from_checkpoint=True, restart_file=f"{jp}_000002.npz",
        **snap), StatsConfig())
    s2 = c2.run(n_iters=2, state=io2.handle_restart(c2.initial_state()),
                n_output=10**9)
    j2 = _jcase()
    jio2 = JIOManager(j2, JCheckpointConfig(
        restart_from_checkpoint=True, restart_file=f"{tp}_000002.npz",
        **snap), JStatsConfig())
    js2 = j2.run(n_iters=2, state=jio2.handle_restart(j2.initial_state()),
                 n_output=10**9)
    for k in "uvw":
        assert _rel(s2[k].numpy(), js[k]) <= 1e-12, k
        assert _rel(js2[k], st[k].numpy()) <= 1e-12, k


def test_example_through_config():
    cfg = config.Config.from_file(str(EXAMPLE))
    case = config.make_case(cfg, dtype=torch.float32, monitor_path=None,
                            verbose=False, device="cpu")
    assert isinstance(case, ChannelCase) and case.name == "channel"
    assert case.mesh.dims(0) == (128, 65, 64)
    assert case.mesh.stretched == (False, True, False)
    assert case.cfg.inlet_noise == (0.0, 0.0, 0.0) and not case.cfg.rotation
    solver = case.solver
    assert solver._transport == "dense" and solver._projection_gap is None
    assert solver._slab is None and solver._pipe is None
    assert solver.poisson.stretch_resolved
    assert solver.poisson.stretch_solver is None
    assert case._fused_rk is None and case.ti.kind == "RK"
    cfg.solver.poisson_solver_type = "CG"
    case = config.make_case(cfg, dtype=torch.float32, monitor_path=None,
                            verbose=False, device="cpu")
    assert isinstance(case.solver.poisson, CGPoisson)
    assert case.solver.poisson.tol == 1e-6


def _cut(text, solver):
    text = text.replace("dims_global = 128, 65, 64",
                        "dims_global = 16, 17, 16")
    text = text.replace("n_iters = 40000", "n_iters = 3")
    text = text.replace("n_output = 100", "n_output = 1")
    text = text.replace("rotation = .false.", "rotation = .true.")
    text = text.replace("omega_rot = 0.0d0", "omega_rot = 0.12d0")
    text = text.replace("n_rotate = 0", "n_rotate = 2")
    text = text.replace("dt = 0.005d0", f"dt = 0.005d0\n"
                        f"poisson_solver_type = '{solver}'")
    return text + """
&checkpoint_params
checkpoint_freq = 3
/End
"""


@pytest.mark.parametrize("solver, rtol", [("FFT", 1e-12), ("CG", 1e-9)])
def test_cli_matches_x3d2_tpu(tmp_path, monkeypatch, capsys, solver, rtol):
    t, j = tmp_path / "t", tmp_path / "j"
    for d in (t, j):
        d.mkdir()
        (d / "input.x3d").write_text(_cut(EXAMPLE.read_text(), solver))
    out = _run(main, t, ["input.x3d", "--dtype", "f64", "--device", "cpu"],
               monkeypatch, capsys)
    assert "Flow case: channel; grid (16, 17, 16); RK3" in out
    _run(jmain, j, ["input.x3d", "--dtype", "f64"], monkeypatch, capsys)
    rt, rj = _rows(t / "monitoring.csv"), _rows(j / "monitoring.csv")
    assert rt.shape == rj.shape == (4, 5)
    for col in (0, 1, 4):   # time, enstrophy, KE
        np.testing.assert_allclose(rt[:, col], rj[:, col], rtol=rtol, atol=0)
    # the divergence columns: the projection's rounding (f64), or CG's
    # stopping level
    assert np.abs(rt[:, 2:4] - rj[:, 2:4]).max() <= max(1e-12, rtol)
    zt = np.load(t / "checkpoint_000003.npz")
    zj = np.load(j / "checkpoint_000003.npz")
    for k in "uvw":
        assert _rel(zt[k], zj[k]) <= rtol, k
