"""differentiable_step on the kernel branch, on the CPU: TGV (128, 128,
256) float32 AB3 with X3D2_XDIV_FUSED=0, the smallest grid on which the
port takes the card's main path (the fused z, x, y sweep chain with the
AB update, then pipe3), here through the kernels' plain versions. As
x3d2_tpu's tests/test_diffsim.py:102-161 on its interpret-mode kernels:

- the forward's outputs are case.step's on the same input (the initial
  state), bit for bit, and that input is intact after the forward and the
  backward (the chain writes over the oldest history buffers, which the
  forward clones);
- the gradient of the kinetic energy after 2 steps with respect to u0,
  through differentiable_step (kernel forward, the einsum twin's vjp
  backward), equals the twin's own gradient to 1e-4 relative (max-abs
  over max-abs; the two forwards differ by the sweeps' float32 band);
- the two forwards are not the same program: their states after a step
  differ, by less than 1e-5 of max |u|.

About 75 s in one thread: a step of either path takes about 6 s here,
its backward about 10.
"""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits
from torch.utils._pytree import tree_leaves

from x3d2_tpu_torch import diffsim
from x3d2_tpu_torch.cases import SolverParams, TGVCase
from x3d2_tpu_torch.common import BC, env_set
from x3d2_tpu_torch.mesh import Mesh

# one thread for torch and for numpy's BLAS: the suite runs several workers
# on one machine, and multi-threaded BLAS calls in each of them, spinning on
# oversubscribed cores, made these tests many times slower there
torch.set_num_threads(1)
threadpool_limits(1, user_api="blas")

SHAPE = (128, 128, 256)


def _tensors(state):
    return [t for t in tree_leaves(state) if isinstance(t, torch.Tensor)]


@pytest.fixture(scope="module")
def runs():
    mesh = Mesh(SHAPE, (2 * np.pi,) * 3, ((BC.PERIODIC, BC.PERIODIC),) * 3)
    params = SolverParams(Re=1600.0, time_intg="AB3", dt=1e-3)
    with env_set({"X3D2_XDIV_FUSED": "0"}):
        case = TGVCase(mesh, params, dtype=torch.float32, monitor_path=None,
                       verbose=False, device="cpu", keep_pressure=False)
    step = diffsim.differentiable_step(case)
    twin = step.twin
    s0 = case.initial_state()
    keep = [t.clone() for t in _tensors(s0)]
    out = {"case": case, "twin": twin}

    def grad(tag, stp):
        """d(KE after 2 steps)/d(u0); the state after the first step kept
        as out[tag]."""
        u0 = s0["u"].clone().requires_grad_()
        s = stp(dict(s0, u=u0))
        out[tag] = s
        g, = torch.autograd.grad(diffsim.kinetic_energy(stp(s)), u0)
        return g

    out["gk"] = grad("s1", step)
    out["intact"] = all(torch.equal(a, b)
                        for a, b in zip(_tensors(s0), keep))
    with torch.no_grad():
        out["s1_ref"] = case.step(dict(s0, olds=tuple(
            tuple(o.clone() for o in per) for per in s0["olds"])))
    out["ge"] = grad("s1_twin", twin.step)
    return out


def test_takes_the_main_path(runs):
    case = runs["case"]
    assert case._fused_ab is not None and not case._ab_is_xdiv
    assert case.solver._pipe is not None
    assert diffsim._kernels_active(case)
    assert not diffsim._kernels_active(runs["twin"])


def test_forward_is_case_step_bit_for_bit(runs):
    got, ref = runs["s1"], runs["s1_ref"]
    assert got.keys() == ref.keys() and got["istep"] == ref["istep"] == 2
    for a, b in zip(_tensors(got), _tensors(ref)):
        assert a.dtype == b.dtype and torch.equal(a.detach(), b)


def test_forward_leaves_its_input_intact(runs):
    assert runs["intact"]


def test_kernel_and_twin_forwards_differ_a_little(runs):
    a, b = runs["s1_ref"]["u"], runs["s1_twin"]["u"].detach()
    err = float((a - b).abs().max() / b.abs().max())
    assert 0 < err < 1e-5, err


def test_gradient_matches_the_twins(runs):
    gk, ge = runs["gk"], runs["ge"]
    assert bool(torch.isfinite(gk).all())
    den = float(ge.abs().max())
    num = float((gk - ge).abs().max())
    assert den > 0 and num / den < 1e-4, (num, den)
