"""The port's manual-pipeline x apply (ops/x_apply_manual.py) against
x3d2_tpu's make_x_apply_manual, on the CPU.

- The plain versions of the four forms (dense, parity "fwd", parity "inv",
  each inverse with and without the subtraction) in float32 vs x3d2_tpu's
  make_x_apply_manual(terms=3) in interpret mode, at the shapes of
  tests/test_manual_xapply.py (32 x 16 x 256, the forward- and
  inverse-folded circulant operators): 2e-4 * scale, the bound of
  tests/test_pallas_poisson.py (x3d2_tpu's bf16 split noise).
- In float64 against the product of the float64 operator: 1e-12 * scale.
- CPU tensors take the plain version and count no launch; another device
  raises; the forms x3d2_tpu refuses are refused.
"""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax.numpy as jnp

from x3d2_tpu.ops.pallas_manual import make_x_apply_manual as j_manual

from x3d2_tpu_torch.ops import x_apply_manual as xm
from x3d2_tpu_torch.ops.matmul_poisson import real_dft_matrix

torch.set_num_threads(1)
threadpool_limits(1, user_api="blas")

N = 32
NY, NZ = 16, 256
FORMS = [(None, False), (None, True), ("fwd", False), ("inv", False),
         ("inv", True)]
IDS = ["dense", "dense-sub", "fwd", "inv", "inv-sub"]


def _mats(seed=0):
    """The forward- and inverse-folded circulant operators of
    tests/test_manual_xapply.py."""
    rng = np.random.default_rng(seed)
    sten = rng.standard_normal(5)
    Op = np.zeros((N, N))
    for k, c in zip(range(-2, 3), sten):
        Op += c * np.roll(np.eye(N), k, axis=1)
    T = real_dft_matrix(N)
    return T @ Op, Op @ np.linalg.inv(T)


def _field(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((N, NY, NZ)).astype(dtype)


def _operator(parity):
    Mf, Mi = _mats()
    return Mi if parity == "inv" else Mf


@pytest.mark.parametrize("parity,sub", FORMS, ids=IDS)
def test_plain_matches_x3d2_tpu(parity, sub):
    M = _operator(parity)
    f, s = _field(1), _field(2)
    port = xm.make_x_apply_manual(M, sub=sub, parity=parity, device="cpu")
    ref = j_manual(M, terms=3, sub=sub, parity=parity, interpret=True)
    got = port(torch.from_numpy(f), torch.from_numpy(s) if sub else None)
    want = np.asarray(ref(*((jnp.asarray(f), jnp.asarray(s)) if sub
                            else (jnp.asarray(f),))))
    assert got.dtype == torch.float32 and got.shape == want.shape
    err = np.abs(got.numpy() - want).max()
    assert err < 2e-4 * np.abs(want).max(), f"{err:.2e}"


@pytest.mark.parametrize("parity,sub", FORMS, ids=IDS)
def test_plain_matches_f64_product(parity, sub):
    """The parity forms are the dense product in block-parity mode order
    (forward: rows [even; odd]; inverse: the input's modes so ordered)."""
    M = _operator(parity)
    f, s = _field(3, np.float64), _field(4, np.float64)
    port = xm.make_x_apply_manual(M, sub=sub, parity=parity, device="cpu")
    got = port(torch.from_numpy(f),
               torch.from_numpy(s) if sub else None).numpy()
    perm = np.concatenate([np.arange(0, N, 2), np.arange(1, N, 2)])
    if parity == "fwd":
        want = np.einsum("ij,jkl->ikl", M, f)[perm]
    elif parity == "inv":
        want = np.einsum("ij,jkl->ikl", M[:, perm], f)
    else:
        want = np.einsum("ij,jkl->ikl", M, f)
    if sub:
        want = s - want
    err = np.abs(got - want).max()
    assert err < 1e-12 * np.abs(want).max(), f"{err:.2e}"


def test_cpu_counts_no_launch_and_refusals():
    xm.reset_launch_counts()
    Mf, _ = _mats()
    f = torch.from_numpy(_field(5))
    assert xm.make_x_apply_manual(Mf, device="cpu")(f).shape == f.shape
    assert xm.launch_counts() == {}
    assert xm.stage_name("inv", True) == "x_apply_manual[inv,sub]"
    with pytest.raises(ValueError, match="no x_apply_manual"):
        xm.x_apply_manual(torch.from_numpy(Mf).float(),
                          torch.empty((N, NY, NZ), device="meta"))
    with pytest.raises(ValueError, match="inverse-stage"):
        xm.make_x_apply_manual(Mf, sub=True, parity="fwd", device="cpu")
    with pytest.raises(ValueError, match="even"):
        xm.make_x_apply_manual(Mf[:, :-1], parity="fwd", device="cpu")
