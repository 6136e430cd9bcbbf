"""The port's host-side operators against x3d2_tpu's.

The resolved matrices M64 come from the same float64 numpy algebra in both
packages, so they must agree to rounding (1e-13 of the largest entry);
the torch contraction in float64 must match the JAX one to 1e-12 (a few
ulps of O(1) results after ~n-term sums).
"""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax.numpy as jnp

from x3d2_tpu.common import BC as JBC
from x3d2_tpu.ops.compact import apply_matrix as j_apply
from x3d2_tpu.ops.compact import build_op as j_build_op
from x3d2_tpu.ops.pallas_transeq import banded_blocks as j_banded_blocks

from x3d2_tpu_torch.common import BC
from x3d2_tpu_torch.ops.banded import banded_blocks
from x3d2_tpu_torch.ops.compact import apply_matrix, build_op

# one thread for torch and for numpy's BLAS: the suite runs several workers
# on one machine, and multi-threaded BLAS calls in each of them, spinning on
# oversubscribed cores, made these tests many times slower there
torch.set_num_threads(1)
threadpool_limits(1, user_api="blas")


N = 32
# (operation, scheme, bc, sym, from_to): the schemes x BCs of
# tests/test_compact_ops.py
SPECS = (
    [("first-deriv", "compact6", bc, sym, None)
     for bc, sym in ((BC.PERIODIC, False), (BC.NEUMANN, False),
                     (BC.NEUMANN, True), (BC.DIRICHLET, False))]
    + [("first-deriv", "compact10_penta", bc, sym, None)
       for bc, sym in ((BC.PERIODIC, False), (BC.NEUMANN, False),
                       (BC.NEUMANN, True), (BC.DIRICHLET, False))]
    + [("second-deriv", "compact6", bc, sym, None)
       for bc, sym in ((BC.PERIODIC, False), (BC.NEUMANN, False),
                       (BC.NEUMANN, True), (BC.DIRICHLET, False))]
    + [("second-deriv", "compact6-hyperviscous", BC.PERIODIC, False, None)]
    + [("stag-deriv", "compact6", bc, False, ft)
       for bc in (BC.PERIODIC, BC.NEUMANN) for ft in ("v2p", "p2v")]
    + [("interpolate", s, bc, False, ft)
       for s in ("classic", "optimised", "aggressive")
       for bc in (BC.PERIODIC, BC.NEUMANN) for ft in ("v2p", "p2v")]
)


def _ops(spec):
    operation, scheme, bc, sym, ft = spec
    periodic = bc == BC.PERIODIC
    n = N - 1 if (ft == "v2p" and not periodic) else N
    dx = 2 * np.pi / (N if periodic else N - 1)
    kw = dict(from_to=ft, sym=sym)
    if scheme == "compact6-hyperviscous":
        kw.update(c_nu=0.44, nu0_nu=4.0)
    mine = build_op(operation, n, dx, scheme, bc, bc, dtype=torch.float64,
                    device="cpu", **kw)
    ref = j_build_op(operation, n, dx, scheme, JBC(int(bc)), JBC(int(bc)),
                     dtype=jnp.float64, **kw)
    return mine, ref


@pytest.mark.parametrize("spec", SPECS,
                         ids=lambda s: f"{s[0]}-{s[1]}-{s[2].name}"
                         f"{'-sym' if s[3] else ''}{'-' + s[4] if s[4] else ''}")
def test_m64_matches_x3d2_tpu(spec):
    mine, ref = _ops(spec)
    scale = np.abs(ref.M64).max()
    np.testing.assert_allclose(mine.M64, ref.M64, rtol=0, atol=1e-13 * scale)
    np.testing.assert_allclose(mine.M.numpy(), ref.M64, rtol=0,
                               atol=1e-13 * scale)
    assert mine.move == ref.move and mine.periodic == ref.periodic


@pytest.mark.parametrize("bc", [BC.PERIODIC, BC.NEUMANN])
@pytest.mark.parametrize("operation,sym", [("first-deriv", False),
                                           ("first-deriv", True),
                                           ("second-deriv", False),
                                           ("second-deriv", True)])
def test_banded_blocks_match(bc, operation, sym):
    n = 128
    dx = 2 * np.pi / n
    mine = build_op(operation, n, dx, "compact6", bc, bc, sym=sym,
                    dtype=torch.float64, device="cpu")
    ref = j_build_op(operation, n, dx, "compact6", JBC(int(bc)),
                     JBC(int(bc)), sym=sym, dtype=jnp.float64)
    got = banded_blocks(mine, 16, 64, tol=1e-6)
    want = j_banded_blocks(ref, 16, 64, tol=1e-6)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("axis,batched", [(0, False), (1, False), (2, False),
                                          (1, True)])
def test_apply_matrix_matches(axis, batched):
    rng = np.random.default_rng(7)
    shape = (12, 10, 14)
    f = rng.standard_normal(((3,) if batched else ()) + shape)
    M = rng.standard_normal((shape[axis] + 2, shape[axis]))
    got = apply_matrix(torch.from_numpy(M), torch.from_numpy(f), axis).numpy()
    want = np.asarray(j_apply(jnp.asarray(M), jnp.asarray(f), axis))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
