"""Passive scalars off x3d2_tpu's species sweeps, on the card's gates, in the
port against x3d2_tpu, on the CPU.

x3d2_tpu runs its species sweeps (_species_kernel_v3) only on the grids of
its banded sweeps and for at most 8 scalars (solver.py:125-136, :277-279);
elsewhere its per-species einsums (solver.py:260-282): at TGV 128^3 (the v1
route), past 8 scalars, and on the cylinder (the dense route). The port runs
those einsums as plain PyTorch on either device.

- The gate: each case built by the port (NavierStokes.species_gap, the
  condition under which the case raises on the card) and by x3d2_tpu with
  its backend reported as a TPU (as tests/test_torch_bf16.py does), at the
  grids themselves: TGV 128^3 with 2 scalars, the cylinder (17 x 128 x 128,
  tests/test_torch_cylinder.py's grid; every cylinder takes the dense
  route) with 1 scalar, TGV 128 x 128 x 256 with 9 scalars, and with 2
  scalars, where both take the species sweeps.
- The steps in float64 against x3d2_tpu's (its einsums on the CPU): TGV
  128^3 with 2 scalars, 2 AB3 steps, and the cylinder with 1 scalar, 3
  steps, to 1e-10 of max |f| (tests/test_torch_species.py's and
  tests/test_torch_cylinder.py's bound for whole float64 steps); 9 scalars
  at 32 x 32 x 64, 2 steps, to the same bound: the grid only picks the route,
  which the gate test holds at 128 x 128 x 256, and 9 scalars of 128 x 128
  x 256 on the dense path take minutes of one CPU core a step.
"""

import contextlib
from pathlib import Path

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax
import jax.numpy as jnp

from x3d2_tpu import config as jconfig
from x3d2_tpu.cases import CylinderCase as JCylinderCase
from x3d2_tpu.cases import SolverParams as JSolverParams
from x3d2_tpu.cases import TGVCase as JTGVCase
from x3d2_tpu.common import BC as JBC
from x3d2_tpu.mesh import Mesh as JMesh

from x3d2_tpu_torch import config, ibm
from x3d2_tpu_torch.cases import CylinderCase, SolverParams, TGVCase
from x3d2_tpu_torch.common import BC
from x3d2_tpu_torch.convert import state_from_numpy
from x3d2_tpu_torch.mesh import Mesh

torch.set_num_threads(1)
threadpool_limits(1, user_api="blas")

ROOT = Path(__file__).resolve().parents[1]
CYL_EXAMPLE = ROOT / "examples" / "cylinder" / "input.x3d"
L = (2 * np.pi,) * 3
PER = ((BC.PERIODIC, BC.PERIODIC),) * 3
JPER = ((JBC.PERIODIC, JBC.PERIODIC),) * 3
CYL_SHAPE = (17, 128, 128)
CYL_L = (20.0, 10.0, 2.5)
CYL_BCS = ((BC.DIRICHLET, BC.DIRICHLET),) + ((BC.PERIODIC, BC.PERIODIC),) * 2
CYL_JBCS = ((JBC.DIRICHLET, JBC.DIRICHLET),) \
    + ((JBC.PERIODIC, JBC.PERIODIC),) * 2
KW = dict(monitor_path=None, verbose=False, keep_pressure=False)


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


def _cyl_phi(fields, nsp):
    """The scalars of a cylinder run (the case defines none): the
    streamwise velocity's perturbation, one copy a scalar."""
    return np.stack([fields["u"] - 1.0] * nsp)


class _Cyl(CylinderCase):
    def initial_conditions(self):
        f = super().initial_conditions()
        if self.params.n_species:
            f["phi"] = _cyl_phi(f, self.params.n_species)
        return f


class _JCyl(JCylinderCase):
    def initial_conditions(self):
        f = super().initial_conditions()
        if self.params.n_species:
            f["phi"] = _cyl_phi(f, self.params.n_species)
        return f


def _tgv_params(nsp, **kw):
    prm = dict(Re=1600, time_intg="AB3", dt=1e-3, n_species=nsp,
               pr_species=tuple(0.5 + 0.1 * i for i in range(nsp)), **kw)
    return SolverParams(**prm), JSolverParams(**prm)


def _tgv(shape, nsp, dtype, tpu=False):
    prm, jprm = _tgv_params(nsp)
    case = TGVCase(Mesh(shape, L, PER), prm, dtype=dtype, device="cpu", **KW)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    with (_tpu_gates() if tpu else contextlib.nullcontext()):
        jcase = JTGVCase(JMesh(shape, L, JPER), jprm, dtype=jdt, **KW)
    return case, jcase


def _cyl(nsp, dtype, tpu=False):
    cfg = config.Config.from_file(str(CYL_EXAMPLE))
    jcfg = jconfig.Config.from_file(str(CYL_EXAMPLE))
    for c in (cfg, jcfg):
        c.cylinder.inlet_noise = (0.0, 0.0, 0.0)
        c.solver.n_species = nsp
        c.solver.pr_species = (0.7,) * nsp
    mesh = Mesh(CYL_SHAPE, CYL_L, CYL_BCS)
    mask = ibm.cylinder_mask(mesh)
    kw = dict(KW, seed=3, ibm_mask=mask)
    case = _Cyl(mesh, cfg.solver, dtype=dtype, device="cpu",
                case_cfg=cfg.cylinder, **kw)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    with (_tpu_gates() if tpu else contextlib.nullcontext()):
        jcase = _JCyl(JMesh(CYL_SHAPE, CYL_L, CYL_JBCS), jcfg.solver,
                      dtype=jdt, case_cfg=jcfg.cylinder, **kw)
    return case, jcase


def _takes_sweeps(case, jcase):
    """(port, x3d2_tpu): whether the scalars' RHS comes from the species
    sweeps (x3d2_tpu transeq_species_all: _species_v3 built and at most 8
    scalars)."""
    nsp = case.params.n_species
    jsp = getattr(jcase.solver, "_species_v3", None)
    return (case.solver._species_sweeps is not None,
            jsp is not None and 0 < nsp <= 8)


@pytest.mark.parametrize("build,sweeps", [
    (lambda: _tgv((128, 128, 128), 2, torch.float32, tpu=True), False),
    (lambda: _cyl(1, torch.float32, tpu=True), False),
    (lambda: _tgv((128, 128, 256), 9, torch.float32, tpu=True), False),
    (lambda: _tgv((128, 128, 256), 2, torch.float32, tpu=True), True)],
    ids=["tgv128-2", "cylinder-1", "tgv128x128x256-9", "tgv128x128x256-2"])
def test_species_route_on_the_card_gates_matches_x3d2_tpu(build, sweeps):
    case, jcase = build()
    assert _takes_sweeps(case, jcase) == (sweeps, sweeps)
    # the card builds every one of them: no kernel of x3d2_tpu's is missing
    assert case.solver.species_gap() is None
    assert case.solver.transport_gap() is None


def _close(s, js, keys, tol):
    for k in keys:
        want = np.asarray(js[k])
        err = np.abs(s[k].numpy() - want).max()
        assert err <= tol * np.abs(want).max(), f"{k}: {err:.2e}"


def _handover(js, seed=0):
    return state_from_numpy(
        {k: np.asarray(js[k]) for k in ("u", "v", "w", "p", "istep", "phi")}
        | {"olds": tuple(tuple(np.asarray(o) for o in per)
                         for per in js["olds"])}, device="cpu", seed=seed)


@pytest.mark.parametrize("shape,nsp", [((128, 128, 128), 2),
                                       ((32, 32, 64), 9)],
                         ids=["tgv128-2", "tgv-9"])
def test_tgv_scalars_off_the_sweeps_match_x3d2_tpu_f64(shape, nsp):
    case, jcase = _tgv(shape, nsp, torch.float64)
    assert case.solver._species_sweeps is None
    js = jcase.initial_state()
    s = _handover(js)
    for _ in range(2):
        s = case.step(s)
        js = jcase._step(js)
    _close(s, js, ("u", "v", "w", "phi"), 1e-10)


def test_cylinder_scalar_matches_x3d2_tpu_f64():
    case, jcase = _cyl(1, torch.float64)
    assert case.solver._transport == "dense"
    js = jcase.initial_state()
    s = _handover(js, seed=3)
    for _ in range(3):
        s = case.step(s)
        js = jcase._step(js)
    _close(s, js, ("u", "v", "w", "phi"), 1e-10)
    assert np.isfinite(s["phi"].numpy()).all()
