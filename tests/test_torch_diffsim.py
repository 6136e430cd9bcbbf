"""The differentiable and batched step (x3d2_tpu_torch/diffsim.py) against
x3d2_tpu's (x3d2_tpu/diffsim.py, tests/test_diffsim.py), on the CPU.

- TGV 16^3 float64, AB3 and RK3, 5 steps: the gradient of the kinetic
  energy with respect to (u0, v0, w0) along a random direction equals a
  central finite difference to 1e-6 relative (tests/test_diffsim.py:
  30-50), and equals jax.grad of x3d2_tpu's objective on the same numpy
  inputs to 1e-10 (max-abs over max-abs: the same float64 discrete adjoint,
  summed in another order).
- remat (a non-reentrant torch.utils.checkpoint a step) changes values by
  no more than 1e-14 and gradients by no more than 1e-12; ensemble members
  equal single runs bit for bit; with no kernel active
  differentiable_step(case) is case.step; rollout is the step loop, bit
  for bit.
- The fault repaired in cases/base.py: case.step records the graph on a
  branch that runs no kernel (its gradient equals the FD), and raises,
  naming differentiable_step, on a kernel branch (the fused AB chain with
  pipe3 at (128, 128, 256); the cylinder's slab) when a tensor of its
  state requires grad. X3D2_D2C=1 raises NotImplementedError.
- The generator is replayed: the cylinder at (17, 128, 128) in float64,
  RK3 with inlet noise (define_bc draws its planes from the state's
  generator every substage): the gradient through the kernel step (its
  slab's plain versions forward, the einsum twin's vjp backward) equals
  the twin's own to 1e-11, with and without remat; another generator
  state moves the gradient by over 10x that, so a backward or a recompute
  that drew new planes would fail. Members with their own generators
  equal their single runs. After the backward nothing keeps the kernel
  steps' states alive.

The kernel branch's gradient at (128, 128, 256) is in
tests/test_torch_diffsim_kernels.py.
"""

import dataclasses
import gc
import os
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax
import jax.numpy as jnp

from x3d2_tpu import diffsim as jdiffsim
from x3d2_tpu.cases import SolverParams as JSolverParams
from x3d2_tpu.cases import TGVCase as JTGVCase
from x3d2_tpu.common import BC as JBC
from x3d2_tpu.mesh import Mesh as JMesh

from x3d2_tpu_torch import config, diffsim
from x3d2_tpu_torch.cases import CylinderCase, SolverParams, TGVCase
from x3d2_tpu_torch.common import BC, env_set
from x3d2_tpu_torch.mesh import Mesh

# one thread for torch and for numpy's BLAS: the suite runs several workers
# on one machine, and multi-threaded BLAS calls in each of them, spinning on
# oversubscribed cores, made these tests many times slower there
torch.set_num_threads(1)
threadpool_limits(1, user_api="blas")

ROOT = Path(__file__).resolve().parents[1]
CYL_EXAMPLE = ROOT / "examples" / "cylinder" / "input.x3d"
L = (2 * np.pi,) * 3
PERIODIC = ((BC.PERIODIC, BC.PERIODIC),) * 3


def _case(n=16, time_intg="AB3", dtype=torch.float64, shape=None, **kw):
    mesh = Mesh(shape or (n,) * 3, L, PERIODIC)
    params = SolverParams(Re=1600.0, time_intg=time_intg, dt=1e-3)
    return TGVCase(mesh, params, dtype=dtype, monitor_path=None,
                   verbose=False, device="cpu", **kw)


def _jcase(n=16, time_intg="AB3"):
    mesh = JMesh((n,) * 3, L, ((JBC.PERIODIC, JBC.PERIODIC),) * 3)
    params = JSolverParams(Re=1600.0, time_intg=time_intg, dt=1e-3)
    return JTGVCase(mesh, params, dtype=jnp.float64, monitor_path=None,
                    verbose=False)


def _velocity(case):
    s = case.initial_state()
    return [s[k].clone().requires_grad_() for k in ("u", "v", "w")]


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


def _directional_fd(f, x, du, eps=1e-6):
    with torch.no_grad():
        fp = float(f(*[a + eps * d for a, d in zip(x, du)]))
        fm = float(f(*[a - eps * d for a, d in zip(x, du)]))
    return (fp - fm) / (2 * eps)


@pytest.mark.parametrize("time_intg", ["AB3", "RK3"])
def test_adjoint_gradient_matches_fd_and_x3d2_tpu(time_intg):
    case, jcase = _case(time_intg=time_intg), _jcase(time_intg=time_intg)
    assert not diffsim._kernels_active(case)
    js = jcase.initial_state()
    x0 = [np.asarray(js[k]) for k in ("u", "v", "w")]
    x = [torch.from_numpy(a.copy()).requires_grad_() for a in x0]
    f = diffsim.objective(case, diffsim.kinetic_energy, 5)
    grads = torch.autograd.grad(f(*x), x)
    assert all(bool(torch.isfinite(g).all()) for g in grads)

    rng = np.random.default_rng(7)
    du = [torch.from_numpy(rng.standard_normal(a.shape)) for a in x0]
    directional = float(sum((g * d).sum() for g, d in zip(grads, du)))
    fd = _directional_fd(f, x, du)
    assert directional == pytest.approx(fd, rel=1e-6)

    jf = jdiffsim.objective(jcase, jdiffsim.kinetic_energy, 5)
    jgrads = jax.jit(jax.grad(jf, argnums=(0, 1, 2)))(
        *(jnp.asarray(a) for a in x0))
    for k, g, jg in zip("uvw", grads, jgrads):
        assert _rel(g.numpy(), jg) <= 1e-10, k


def test_remat_changes_nothing():
    case = _case()
    outs = []
    for remat in (False, True):
        x = _velocity(case)
        f = diffsim.objective(case, diffsim.kinetic_energy, 3, remat=remat)
        val = f(*x)
        outs.append((float(val.detach()), torch.autograd.grad(val, x)))
    assert outs[0][0] == pytest.approx(outs[1][0], rel=1e-14)
    for a, b in zip(outs[0][1], outs[1][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12,
                                   atol=1e-15)


def _members(case, n=2, seed=3):
    base = case.initial_state()
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        s = case.initial_state()
        for k in ("u", "v", "w"):
            s[k] = base[k] + 1e-3 * torch.from_numpy(
                rng.standard_normal(base[k].shape)).to(base[k].dtype)
        out.append(s)
    return out


def _assert_members_equal(case, members, batched, n_steps, keys):
    for i, m in enumerate(members):
        ref = diffsim.rollout(case, m, n_steps, remat=False)
        for k in keys:
            assert torch.equal(batched[k][i], ref[k]), f"member {i} {k}"
        assert batched["istep"] == ref["istep"]
        if "rng" in ref:
            assert torch.equal(batched["rng"][i].get_state(),
                               ref["rng"].get_state())


def test_ensemble_matches_member_runs():
    case = _case()
    members = _members(case)
    stacked = diffsim.stack_states(members)
    assert stacked["u"].shape == (2, 16, 16, 16)
    assert len(stacked["olds"][0]) == 2
    assert stacked["olds"][0][0].shape == (2, 16, 16, 16)
    batched = diffsim.ensemble_rollout(case, stacked, n_steps=3)
    _assert_members_equal(case, members, batched, 3, ("u", "v", "w", "p"))
    for o, ref in zip(batched["olds"], stacked["olds"]):
        assert o[0].shape == ref[0].shape


def test_differentiable_step_passthrough_without_kernels():
    case = _case()
    assert not diffsim._kernels_active(case)
    assert diffsim.differentiable_step(case) == case.step


def test_rollout_matches_step_loop():
    case = _case()
    s_loop = case.initial_state()
    for _ in range(4):
        s_loop = case.step(s_loop)
    s_roll = diffsim.rollout(case, case.initial_state(), 4, remat=False)
    for k in ("u", "v", "w"):
        assert torch.equal(s_roll[k], s_loop[k]), k
    assert s_roll["istep"] == s_loop["istep"] == 5


def test_case_step_records_the_graph_without_kernels():
    """The fault: case.step ran under torch.no_grad() and cut the graph."""
    case = _case(time_intg="AB3")

    def f(u0, v0, w0):
        s = dict(case.initial_state(), u=u0, v=v0, w=w0)
        for _ in range(3):
            s = case.step(s)
        return diffsim.kinetic_energy(s)

    x = _velocity(case)
    grads = torch.autograd.grad(f(*x), x)
    rng = np.random.default_rng(11)
    du = [torch.from_numpy(rng.standard_normal(x[0].shape))
          for _ in range(3)]
    directional = float(sum((g * d).sum() for g, d in zip(grads, du)))
    assert directional == pytest.approx(_directional_fd(f, x, du), rel=1e-6)
    # without grad mode the same step makes no graph
    with torch.no_grad():
        s = case.step(dict(case.initial_state(), u=x[0]))
    assert not s["u"].requires_grad


def _cylinder(time_intg="RK3", noise=1.0, **kw):
    cfg = config.Config.from_file(str(CYL_EXAMPLE))
    cfg.cylinder.inlet_noise = (noise,) * 3
    mesh = Mesh((17, 128, 128), (20.0, 10.0, 2.5),
                ((BC.DIRICHLET, BC.DIRICHLET),)
                + ((BC.PERIODIC, BC.PERIODIC),) * 2)
    params = dataclasses.replace(cfg.solver, time_intg=time_intg)
    return CylinderCase(mesh, params, dtype=torch.float64, device="cpu",
                        case_cfg=cfg.cylinder, monitor_path=None,
                        verbose=False, keep_pressure=False, seed=3, **kw)


def _kernel_cases():
    with env_set({"X3D2_XDIV_FUSED": "0"}):
        tgv = _case(dtype=torch.float32, shape=(128, 128, 256),
                    keep_pressure=False)
    assert tgv._fused_ab is not None and tgv.solver._pipe is not None
    cyl = _cylinder(time_intg="AB3")
    assert cyl._fused_ab is None and cyl.solver._slab is not None
    return {"fused_ab_pipe3": tgv, "cylinder_slab": cyl}


@pytest.mark.parametrize("name", ["fused_ab_pipe3", "cylinder_slab"])
def test_kernel_step_with_grad_raises(name):
    case = _kernel_cases()[name]
    assert diffsim._kernels_active(case)
    s = case.initial_state()
    s["u"] = s["u"].clone().requires_grad_()
    with pytest.raises(RuntimeError, match="differentiable_step"):
        case.step(s)


def test_d2c_carry_raises():
    with env_set({"X3D2_D2C": "1", "X3D2_XDIV_FUSED": "0"}):
        case = _case(dtype=torch.float32, shape=(128, 128, 256),
                     keep_pressure=False)
    assert case._pipe_d2c is not None
    with pytest.raises(NotImplementedError, match="X3D2_D2C"):
        diffsim.differentiable_step(case)


def test_einsum_twin_inherits_all_but_the_kernels():
    case = _cylinder()
    before = os.environ.get("X3D2_PALLAS")
    step = diffsim.differentiable_step(case)
    assert os.environ.get("X3D2_PALLAS") == before
    assert diffsim.differentiable_step(case) is step   # cached
    twin = step.twin
    assert not diffsim._kernels_active(twin) and twin.device == case.device
    assert torch.equal(twin.ep, case.ep)
    s, t = case.initial_state(), twin.initial_state()
    assert s.keys() == t.keys()
    for k in ("u", "v", "w", "p"):
        assert s[k].shape == t[k].shape and s[k].dtype == t[k].dtype


def _cyl_grad(case, remat, gen=None):
    """d(KE after 2 steps)/d(u0, v0, w0); gen: the seed of another
    generator for the initial state."""
    def f(u0, v0, w0):
        s = dict(case.initial_state(), u=u0, v=v0, w=w0)
        if gen is not None:
            s["rng"] = torch.Generator().manual_seed(gen)
        return diffsim.kinetic_energy(diffsim.rollout(case, s, 2, remat))

    x = _velocity(case)
    return torch.autograd.grad(f(*x), x)


def test_generator_replayed_in_backward_and_remat():
    case = _cylinder()
    assert diffsim._kernels_active(case) and case.ti.kind == "RK"
    twin = diffsim.differentiable_step(case).twin
    ref = _cyl_grad(twin, remat=False)
    tol = 1e-11
    for c, remat in ((case, False), (case, True), (twin, True)):
        for g, r in zip(_cyl_grad(c, remat), ref):
            assert _rel(g.numpy(), r.numpy()) <= tol, (c is case, remat)
    # the test's teeth: planes drawn from another generator state move the
    # gradient far past the tolerance
    other = _cyl_grad(twin, remat=False, gen=99)
    assert _rel(other[0].numpy(), ref[0].numpy()) > 10 * tol


def test_ensemble_members_keep_their_generators():
    case = _cylinder()
    members = _members(case)
    members[1]["rng"] = torch.Generator().manual_seed(17)
    stacked = diffsim.stack_states(members)
    assert stacked["rng"][0] is not members[0]["rng"]
    batched = diffsim.ensemble_rollout(case, stacked, n_steps=2)
    _assert_members_equal(case, members, batched, 2, ("u", "v", "w"))


def test_kernel_step_frees_its_graph_after_backward():
    """The Function's context keeps no tensor of the step (a kept output
    would make a cycle through its grad_fn and hold every step's states:
    15 GiB more a gradient at 512^3 on the card before this was fixed)."""
    case = _cylinder(time_intg="AB3")
    step = diffsim.differentiable_step(case)
    s0 = case.initial_state()
    x = s0["u"].clone().requires_grad_()
    s1 = step(dict(s0, u=x))
    s2 = step(s1)
    refs = [weakref.ref(s1["u"]), weakref.ref(s2["olds"][0][0])]
    ke = diffsim.kinetic_energy(s2)
    torch.autograd.grad(ke, x)
    del s1, s2, ke
    gc.collect()
    assert all(r() is None for r in refs)
