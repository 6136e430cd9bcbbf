"""Three-stage pressure projection for ``keep_pressure=False``: the wrappers
of the Hopper kernels in ``csrc/pressure_pipe.cu`` and their plain PyTorch
versions.

Counterpart of x3d2_tpu.ops.pallas_poisson.make_pressure_pipe3
(pallas_poisson.py:1573) and its kernels:

    A  _pipe_a_kernel (:1378)  u, v, w -> a = Ty Iz Iy u,
                                          e = Ty (Iz Sy v + Sz Iy w)
    B  _pipe_b_kernel (:1405)  a, e    -> q = -(Sx a + Ix e) / waves,
                                          X = Gxs q, Y = Gxi q
    C  _pipe_c_kernel (:1455)  X, Y, u, v, w -> u - Giy Gzi X,
                                          v - Gsy Gzi Y, w - Giy Gzs Y

The y interpolation and staggered derivative are band-truncated per block
of 64 rows (ops/banded.py, W=32); the periodic transforms use the parity
split (one radix-2 level in matrix form, half the operations), so spectral
indices stay in block-parity order [even modes; odd modes] between the
stages and the solve tables are permuted to match. The operator set, the
splits and the plain applies are shared with the slab projection
(ops/parity.py); so is the kernel template, behind its launcher
(ops/operator_apply.py).

A stage on CUDA tensors launches the kernel (or raises); on CPU tensors it
runs the plain version. The pipeline serves the all-periodic uniform grid
whose every extent is a multiple of 128 (``parity.projection_supported``), as
x3d2_tpu's pipe3 serves its periodic-even fast path (pipe3_supported,
pallas_poisson.py:1555).
"""

from __future__ import annotations

import torch

from .operator_apply import BANDED, PFWD, PINV, SOLVE, SUB, apply, route
from .parity import ProjectionMats, banded_apply, pfwd, pinv, solve_factor


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

def pipe_a_plain(u, v, w, m):
    """Stage A in plain PyTorch: (a, e)."""
    p1, p2, p3 = banded_apply(m["biy"], u, 1), \
        banded_apply(m["bsy"], v, 1), banded_apply(m["biy"], w, 1)
    z1 = pfwd(m["iz"], p1, 2)
    z23 = pfwd(m["iz"], p2, 2) + pfwd(m["sz"], p3, 2)
    return pfwd(m["ty"], z1, 1), pfwd(m["ty"], z23, 1)


def pipe_b_plain(a, e, m):
    """Stage B in plain PyTorch: (X, Y)."""
    F = pfwd(m["sx"], a, 0) + pfwd(m["ix"], e, 0)
    q = F * solve_factor(m, tuple(a.shape))
    return pinv(m["gxs"], q, 0), pinv(m["gxi"], q, 0)


def pipe_c_plain(X, Y, u, v, w, m):
    """Stage C in plain PyTorch: (u', v', w')."""
    gx = pinv(m["tyi"], pinv(m["gzi"], X, 2), 1)
    gz = pinv(m["tyi"], pinv(m["gzs"], Y, 2), 1)
    gy = pinv(m["tyi"], pinv(m["gzi"], Y, 2), 1)
    return (u - banded_apply(m["bgiy"], gx, 1),
            v - banded_apply(m["bgsy"], gy, 1),
            w - banded_apply(m["bgiy"], gz, 1))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _pipe_a_cuda(u, v, w, m):
    p = [torch.empty_like(u) for _ in range(3)]
    apply("pipe_a", BANDED, 1, [([m["biy"]], [u], p[0], None),
                                ([m["bsy"]], [v], p[1], None),
                                ([m["biy"]], [w], p[2], None)])
    z1, z23 = torch.empty_like(u), torch.empty_like(u)
    # Sz before Iz: one chain sums both sources, and for the low z modes,
    # which carry the solution after the solve, Sz's part is the small one
    apply("pipe_a", PFWD, 2, [([m["iz"]], [p[0]], z1, None),
                              ([m["sz"], m["iz"]], [p[2], p[1]], z23, None)])
    # p1 and p2 are dead: a and e take their buffers
    apply("pipe_a", PFWD, 1, [([m["ty"]], [z1], p[0], None),
                              ([m["ty"]], [z23], p[1], None)])
    return p[0], p[1]


def _pipe_b_cuda(a, e, m):
    q = torch.empty_like(a)
    apply("pipe_b", PFWD, 0, [([m["sx"], m["ix"]], [a, e], q, None)],
          epi=SOLVE, tabs=(m["tab_a"], m["tab_b"], m["k2x"], m["tx2"]))
    X, Y = torch.empty_like(a), torch.empty_like(a)
    apply("pipe_b", PINV, 0, [([m["gxs"]], [q], X, None),
                              ([m["gxi"]], [q], Y, None)])
    return X, Y


def _pipe_c_cuda(X, Y, u, v, w, m):
    px, dzy, pzy = (torch.empty_like(X) for _ in range(3))
    apply("pipe_c", PINV, 2, [([m["gzi"]], [X], px, None),
                              ([m["gzs"]], [Y], dzy, None),
                              ([m["gzi"]], [Y], pzy, None)])
    gx, gz, gy = (torch.empty_like(X) for _ in range(3))
    apply("pipe_c", PINV, 1, [([m["tyi"]], [px], gx, None),
                              ([m["tyi"]], [dzy], gz, None),
                              ([m["tyi"]], [pzy], gy, None)])
    un, vn, wn = (torch.empty_like(u) for _ in range(3))
    apply("pipe_c", BANDED, 1, [([m["bgiy"]], [gx], un, u),
                                ([m["bgsy"]], [gy], vn, v),
                                ([m["bgiy"]], [gz], wn, w)], epi=SUB)
    return un, vn, wn


def pipe_a(u, v, w, pm: ProjectionMats):
    """Stage A: (u, v, w) -> (a, e). CUDA tensors launch the kernel (or
    raise); CPU tensors run the plain version."""
    if route(u, "pipe_a"):
        return _pipe_a_cuda(u, v, w, pm.mats(torch.float32))
    return pipe_a_plain(u, v, w, pm.mats(u.dtype))


def pipe_b(a, e, pm: ProjectionMats):
    """Stage B: (a, e) -> (X, Y), the x transforms around the solve."""
    if route(a, "pipe_b"):
        return _pipe_b_cuda(a, e, pm.mats(torch.float32))
    return pipe_b_plain(a, e, pm.mats(a.dtype))


def pipe_c(X, Y, u, v, w, pm: ProjectionMats):
    """Stage C: (X, Y, u, v, w) -> the corrected (u', v', w')."""
    if route(X, "pipe_c"):
        return _pipe_c_cuda(X, Y, u, v, w, pm.mats(torch.float32))
    return pipe_c_plain(X, Y, u, v, w, pm.mats(X.dtype))


def make_pressure_pipe(pm: ProjectionMats):
    """fn(u, v, w) -> (u', v', w'): the keep_pressure=False projection as
    the three stages (x3d2_tpu make_pressure_pipe3) over the operator set
    `pm` (parity.build_projection_mats, which raises ValueError outside
    ``parity.projection_supported``)."""

    def fn(u, v, w):
        a, e = pipe_a(u, v, w, pm)
        X, Y = pipe_b(a, e, pm)
        return pipe_c(X, Y, u, v, w, pm)

    fn.mats = pm
    return fn
