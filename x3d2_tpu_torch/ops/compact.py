"""Resolved compact-scheme operators applied as tensor contractions.

A compact scheme is an implicit banded system ``A f' = B f`` (schemes.py).
The operator is resolved once at setup,

    M = diag(stretch) @ A^{-1} @ B        (float64 numpy, exact)

and applied along any axis of a Cartesian field as one matrix product.
This is an exact solve of the same system. ``M`` decays exponentially off
the diagonal (diagonal dominance of ``A``), which the banded sweep kernels
exploit (banded.py, transeq_sweep.py).

Counterpart of x3d2_tpu.ops.compact: ``resolve``/``build_op`` stay in
numpy float64 (``M64``); ``CompactOp.M`` is a device tensor.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from . import schemes

# x3d2_tpu's X3D2_MATMUL_PRECISION values (ops/compact.py:53-58) and the
# kernel terms each selects (solver.py:124-127: 3 for HIGHEST, else 2)
_PRECISION_TERMS = {"default": 2, "high": 2, "highest": 3}


def matmul_terms() -> int:
    """The kernel mode X3D2_MATMUL_PRECISION selects, as x3d2_tpu's
    ``terms``: 3 for "highest" (the W = 32 sweep bands), 2 for "high" (the
    default) and "default". Another value raises ValueError, as x3d2_tpu's
    table lookup raises KeyError. Read when called, by NavierStokes.build
    and the case's chain build (x3d2_tpu binds it at import), so a caller
    may set it before building. The einsum paths it sets in x3d2_tpu are
    full float32 products here in every mode (TF32 off, the package's
    import)."""
    val = os.environ.get("X3D2_MATMUL_PRECISION", "high")
    if val not in _PRECISION_TERMS:
        raise ValueError(f"X3D2_MATMUL_PRECISION={val!r}: one of "
                         f"{sorted(_PRECISION_TERMS)}")
    return _PRECISION_TERMS[val]


def apply_matrix(M: torch.Tensor, f: torch.Tensor, axis: int) -> torch.Tensor:
    """Contract operator matrix M (n_out, n_in) with `f` along `axis`, in
    the field's dtype.

    `f` may be (nx, ny, nz) or batched (s, nx, ny, nz); `axis` always
    refers to the spatial axes.
    """
    M = M.to(f.dtype)
    dim = f.ndim - 3 + axis
    if dim == f.ndim - 1:
        return torch.matmul(f, M.T)
    shape = f.shape
    rest = 1
    for s in shape[dim + 1:]:
        rest *= s
    f3 = f.reshape(shape[:dim] + (shape[dim], rest))
    out = torch.matmul(M, f3)
    return out.reshape(shape[:dim] + (M.shape[0],) + shape[dim + 1:])


@dataclass(frozen=True)
class CompactOp:
    """A resolved compact-scheme operator along one grid axis.

    Attributes:
      M: (n_out, n_in) operator matrix in compute dtype (device tensor).
      M64: float64 numpy master copy (banded blocks, tests).
      move: +1 v2p, -1 p2v, 0 colocated.
      stretch_correct: per-point second-derivative correction factors on
        stretched meshes, or None (applied by the caller, solver.transeq).
    """

    M: torch.Tensor
    M64: np.ndarray
    move: int
    periodic: bool
    stretch_correct: np.ndarray | None = None
    # scheme scalars needed by the spectral Poisson solver (waves_set)
    alpha: float = 0.0
    a: float = 0.0
    b: float = 0.0
    c: float = 0.0
    d: float = 0.0

    @property
    def n_out(self) -> int:
        return self.M64.shape[0]

    @property
    def n_in(self) -> int:
        return self.M64.shape[1]

    def __call__(self, f: torch.Tensor, axis: int) -> torch.Tensor:
        return apply_matrix(self.M, f, axis)


def resolve(system: schemes.SchemeSystem, stretch: np.ndarray | None = None,
            stretch_correct: np.ndarray | None = None,
            dtype=torch.float32, device=None) -> CompactOp:
    """Build the resolved operator M = diag(stretch) @ A^-1 @ B."""
    from ..common import resolve_device

    A = system.lhs_dense()
    Bm = system.rhs_dense()
    M = np.linalg.solve(A, Bm)
    if stretch is not None:
        M = np.asarray(stretch)[:, None] * M
    return CompactOp(
        M=torch.as_tensor(M, dtype=dtype, device=resolve_device(device)),
        M64=M,
        move=system.move,
        periodic=system.periodic,
        stretch_correct=(np.asarray(stretch_correct)
                         if stretch_correct is not None else None),
        alpha=system.alpha, a=system.a, b=system.bb, c=system.c, d=system.d,
    )


def build_op(operation: str, n: int, delta: float, scheme: str,
             bc_start: int, bc_end: int, *, from_to: str = None,
             sym: bool = False, stretch: np.ndarray | None = None,
             stretch_correct: np.ndarray | None = None,
             c_nu: float = None, nu0_nu: float = None,
             dtype=torch.float32, device=None) -> CompactOp:
    """One-call equivalent of backend%alloc_tdsops (backend.f90:332-368)."""
    sys_ = schemes.build_system(operation, n, delta, scheme, bc_start, bc_end,
                                from_to=from_to, sym=sym, c_nu=c_nu,
                                nu0_nu=nu0_nu)
    return resolve(sys_, stretch=stretch, stretch_correct=stretch_correct,
                   dtype=dtype, device=device)
