"""Compact finite-difference scheme definitions (numpy copy of
x3d2_tpu.ops.schemes; the port imports nothing of the JAX package).

This is the numerics heart: for each operation (first/second derivative,
midpoint interpolation, staggered derivative) it assembles the implicit
compact-scheme system

    A @ f' = B @ f

as explicit banded matrices in float64 numpy, including all boundary-row
closures (periodic / Neumann-symmetric / Neumann-antisymmetric / Dirichlet).

Functional parity target: the coefficient tables and boundary rows of the
reference's ``tdsops_t`` builders (x3d2 src/tdsops.f90:205-872).
The *solution machinery* is deliberately different: the reference
preprocesses Thomas / DistD2 / pentadiagonal-LU factorisations for
line-marching kernels; this package instead forms the resolved operator
``M = diag(stretch) @ A^{-1} @ B`` once at setup (float64) and applies it
as a matrix contraction or as banded blocks (see compact.py, banded.py). Both are exact solves of the
same system. The diagonal dominance of A makes M's off-diagonal entries
decay exponentially, which is the same property the reference's distributed
algorithm relies on (tdsops.f90:196-201, arXiv:2411.13532); we exploit it to
band-truncate M for sharded application.

All math here is plain numpy float64 and runs once at setup time.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..common import BC

# Stencil geometry: RHS rows use a 9-point window; coefficient position
# p (0-based, 0..8) multiplies input index ``i + p - 4`` for output row i.
# (Matches the reference kernel indexing, omp/kernels/distributed.f90:37-146.)
N_HALO = 4
N_STENCIL = 2 * N_HALO + 1


@dataclass
class SchemeSystem:
    """The assembled implicit system for one operation along one axis.

    ``n_out`` rows; RHS consumes ``n_in`` input points. The LHS is stored as
    the three tridiagonal vectors (plus pentadiagonal extras when needed)
    *before* any factorisation.
    """

    n_out: int
    n_in: int
    periodic: bool
    move: int  # +1 v2p, -1 p2v, 0 colocated
    # LHS tridiagonal rows: sa (sub), b (diag), sc (super)
    sa: np.ndarray = None
    b: np.ndarray = None
    sc: np.ndarray = None
    # RHS stencil rows
    coeffs: np.ndarray = None  # (9,) interior
    coeffs_s: np.ndarray = None  # (4, 9) first 4 rows
    coeffs_e: np.ndarray = None  # (4, 9) last 4 rows (of the n_rhs range)
    n_rhs: int = 0
    # Scalar scheme constants (used by the spectral Poisson wave tables)
    alpha: float = 0.0
    a: float = 0.0
    bb: float = 0.0
    c: float = 0.0
    d: float = 0.0
    # Pentadiagonal LHS (compact10_penta only)
    pentadiag: bool = False
    beta: float = 0.0
    penta_row1_u1: float = 0.0  # A[0,1]
    penta_row1_u2: float = 0.0  # A[0,2]
    penta_row2_diag: float = 1.0
    penta_rowN_l1: float = 0.0  # A[n-1,n-2]
    penta_rowN_l2: float = 0.0  # A[n-1,n-3]
    penta_rowN1_diag: float = 1.0  # A[n-2,n-2]
    penta_rowN_identity: bool = False
    # Ghost-point extension rule for RHS stencil entries that fall outside
    # the domain (used by the pentadiagonal scheme whose near-boundary rows
    # keep the wide interior stencil; see tests/verification/test_omp_penta
    # .f90:47-48,125-128,178-181): None -> out-of-range is an error,
    # 'zero' -> dropped, 'even'/'odd' -> mirror with +/- sign.
    ghost_start: str | None = None
    ghost_end: str | None = None

    def lhs_dense(self) -> np.ndarray:
        """Assemble the dense LHS matrix A (n_out x n_out)."""
        n = self.n_out
        A = np.zeros((n, n))
        if self.pentadiag:
            al, be = self.alpha, self.beta
            for i in range(n):
                A[i, i] = 1.0
                if i - 1 >= 0:
                    A[i, i - 1] = al
                if i + 1 < n:
                    A[i, i + 1] = al
                if i - 2 >= 0:
                    A[i, i - 2] = be
                if i + 2 < n:
                    A[i, i + 2] = be
            if self.periodic:
                # cyclic wrap (reference solves this with SMW rank-4
                # correction, der_penta_periodic; we build it directly)
                A[0, n - 1] = al
                A[0, n - 2] = be
                A[1, n - 1] = be
                A[n - 1, 0] = al
                A[n - 2, 0] = be
                A[n - 1, 1] = be
            else:
                # Boundary-row LHS modifications, mirroring
                # preprocess_penta_dist (tdsops.f90:971-1103)
                A[0, 1] = self.penta_row1_u1
                if n > 2:
                    A[0, 2] = self.penta_row1_u2
                A[1, 1] = self.penta_row2_diag
                A[n - 2, n - 2] = self.penta_rowN1_diag
                if self.penta_rowN_identity:
                    A[n - 1, :] = 0.0
                    A[n - 1, n - 1] = 1.0
                else:
                    A[n - 1, n - 2] = self.penta_rowN_l1
                    A[n - 1, n - 3] = self.penta_rowN_l2
            return A
        for i in range(n):
            A[i, i] = self.b[i]
            if i - 1 >= 0:
                A[i, i - 1] = self.sa[i]
            if i + 1 < n:
                A[i, i + 1] = self.sc[i]
        if self.periodic:
            A[0, n - 1] = self.sa[0]
            A[n - 1, 0] = self.sc[n - 1]
        return A

    def rhs_dense(self) -> np.ndarray:
        """Assemble the dense RHS matrix B (n_out x n_in).

        Row index mapping follows der_univ_dist
        (omp/kernels/distributed.f90:37-146): the first 4 rows use
        coeffs_s, rows n_rhs-4..n_rhs-1 use coeffs_e, everything else the
        interior stencil. Input column = row + position - 4; periodic wraps,
        non-periodic rows must stay in range (their BC closures guarantee
        zero coefficients outside).
        """
        n, m = self.n_out, self.n_in
        B = np.zeros((n, m))
        for i in range(n):
            if self.periodic:
                row = self.coeffs
            elif i < 4:
                row = self.coeffs_s[i]
            elif i >= self.n_rhs - 4:
                row = self.coeffs_e[i - (self.n_rhs - 4)]
            else:
                row = self.coeffs
            for p in range(N_STENCIL):
                cval = row[p]
                if cval == 0.0:
                    continue
                j = i + p - N_HALO
                if self.periodic:
                    j %= m
                elif j < 0:
                    if self.ghost_start == "zero":
                        continue
                    if self.ghost_start in ("even", "odd"):
                        cval = cval if self.ghost_start == "even" else -cval
                        j = -j  # mirror about row 0 (x=0)
                    else:
                        raise ValueError(
                            f"stencil outside domain: row {i} pos {p} -> {j}"
                            f" (n_in={m}); BC closure must zero this entry")
                elif j >= m:
                    if self.ghost_end == "zero":
                        continue
                    if self.ghost_end in ("even", "odd"):
                        cval = cval if self.ghost_end == "even" else -cval
                        j = 2 * (m - 1) - j  # mirror about the last point
                    else:
                        raise ValueError(
                            f"stencil outside domain: row {i} pos {p} -> {j}"
                            f" (n_in={m}); BC closure must zero this entry")
                B[i, j] += cval
        return B


def _init_system(n_out, n_in, periodic, move, n_rhs):
    s = SchemeSystem(n_out=n_out, n_in=n_in, periodic=periodic, move=move)
    s.n_rhs = n_rhs
    s.sa = np.zeros(n_out)
    s.b = np.ones(n_out)
    s.sc = np.zeros(n_out)
    return s


def _broadcast_rows(s: SchemeSystem):
    s.coeffs_s = np.tile(s.coeffs, (4, 1))
    s.coeffs_e = np.tile(s.coeffs, (4, 1))


def deriv_1st(n: int, delta: float, scheme: str, bc_start: int, bc_end: int,
              sym: bool = False) -> SchemeSystem:
    """First derivative on a colocated grid (tdsops.f90:205-405).

    compact6: 6th-order tridiagonal (Lele 1992), alpha=1/3, a=7/9/d, b=1/36/d.
    compact10_penta: 10th-order pentadiagonal (Lele Table 1).
    ``sym`` selects the even-function (cos-type) Neumann closure; the
    antisymmetric closure is the default (odd/sin-type fields).
    """
    periodic = bc_start == BC.PERIODIC and bc_end == BC.PERIODIC
    s = _init_system(n, n, periodic, 0, n)

    if scheme == "compact6":
        alpha = 1.0 / 3.0
        afi = 7.0 / 9.0 / delta
        bfi = 1.0 / 36.0 / delta
        cfi = 0.0
    elif scheme == "compact10_penta":
        s.pentadiag = True
        alpha = 0.5
        s.beta = 1.0 / 20.0
        afi = 17.0 / 24.0 / delta
        bfi = 101.0 / 600.0 / delta
        cfi = 1.0 / 600.0 / delta
    else:
        raise ValueError(f"unknown deriv_1st scheme {scheme!r}")

    s.alpha, s.a, s.bb, s.c = alpha, afi, bfi, cfi
    s.coeffs = np.array([0.0, -cfi, -bfi, -afi, 0.0, afi, bfi, cfi, 0.0])
    _broadcast_rows(s)

    if not s.pentadiag:
        s.sa[:] = alpha
        s.sc[:] = alpha

    # ---- start boundary -----------------------------------------------
    if bc_start == BC.NEUMANN:
        if not s.pentadiag:
            if sym:
                # even-symmetric field: f'(0)=0 (tdsops.f90:281-291)
                s.sa[0] = 0.0
                s.sc[0] = 0.0
                s.coeffs_s[0] = 0.0
                s.coeffs_s[1] = np.array(
                    [0, 0, 0, -afi, -bfi, afi, bfi, 0, 0], dtype=float)
            else:
                # odd-antisymmetric field (tdsops.f90:293-304)
                s.sa[0] = 0.0
                s.sc[0] = 2 * alpha
                s.coeffs_s[0] = np.array(
                    [0, 0, 0, 0, 0, 2 * afi, 2 * bfi, 0, 0], dtype=float)
                s.coeffs_s[1] = np.array(
                    [0, 0, 0, -afi, bfi, afi, bfi, 0, 0], dtype=float)
    elif bc_start == BC.DIRICHLET:
        if not s.pentadiag:
            # 3rd-order one-sided rows (tdsops.f90:306-321)
            s.sa[0] = 0.0
            s.sc[0] = 2.0
            s.coeffs_s[0] = np.array(
                [0, 0, 0, 0, -2.5, 2.0, 0.5, 0, 0]) / delta
            s.sa[1] = 0.25
            s.sc[1] = 0.25
            s.coeffs_s[1] = np.array(
                [0, 0, 0, -0.75, 0.0, 0.75, 0, 0, 0]) / delta
        else:
            # compact one-sided closures, same alpha/beta (tdsops.f90:323-335)
            s.coeffs_s[0] = np.array(
                [0, 0, 0, 0, -529.0 / 240, 71.0 / 20, -9.0 / 4,
                 67.0 / 60, -17.0 / 80]) / delta
            s.coeffs_s[1] = np.array(
                [0, 0, 0, -301.0 / 240, 103.0 / 120, -3.0 / 40,
                 13.0 / 24, -17.0 / 240, 0]) / delta

    # ---- end boundary --------------------------------------------------
    if bc_end == BC.NEUMANN:
        if not s.pentadiag:
            if sym:
                s.sa[n - 1] = 0.0
                s.sc[n - 1] = 0.0
                s.coeffs_e[3] = 0.0
                s.coeffs_e[2] = np.array(
                    [0, 0, -bfi, -afi, bfi, afi, 0, 0, 0], dtype=float)
            else:
                s.sa[n - 1] = 2 * alpha
                s.sc[n - 1] = 0.0
                s.coeffs_e[3] = np.array(
                    [0, 0, -2 * bfi, -2 * afi, 0, 0, 0, 0, 0], dtype=float)
                s.coeffs_e[2] = np.array(
                    [0, 0, -bfi, -afi, -bfi, afi, 0, 0, 0], dtype=float)
    elif bc_end == BC.DIRICHLET:
        if not s.pentadiag:
            s.sa[n - 1] = 2.0
            s.sc[n - 1] = 0.0
            s.coeffs_e[3] = np.array(
                [0, 0, -0.5, -2.0, 2.5, 0, 0, 0, 0]) / delta
            s.sa[n - 2] = 0.25
            s.sc[n - 2] = 0.25
            s.coeffs_e[2] = np.array(
                [0, 0, 0, -0.75, 0.0, 0.75, 0, 0, 0]) / delta
        else:
            s.coeffs_e[3] = np.array(
                [17.0 / 80, -67.0 / 60, 9.0 / 4, -71.0 / 20,
                 529.0 / 240, 0, 0, 0, 0]) / delta
            s.coeffs_e[2] = np.array(
                [0, 17.0 / 240, -13.0 / 24, 3.0 / 40, -103.0 / 120,
                 301.0 / 240, 0, 0, 0]) / delta

    if s.pentadiag:
        _penta_lhs_bc(s, bc_start, bc_end, sym)
        if not s.periodic:
            ghost = {BC.DIRICHLET: "zero",
                     BC.NEUMANN: ("even" if sym else "odd")}
            s.ghost_start = ghost.get(bc_start)
            s.ghost_end = ghost.get(bc_end)
    return s


def _penta_lhs_bc(s: SchemeSystem, bc_start: int, bc_end: int, sym: bool):
    """Pentadiagonal LHS boundary-row modifications.

    Mirrors the system (not the LU) described in preprocess_penta_dist
    (tdsops.f90:971-1103): Neumann ghost extensions modify row 1/2 and the
    mirrored end rows; Dirichlet keeps interior alpha/beta.
    """
    al, be = s.alpha, s.beta
    n = s.n_out
    if s.periodic:
        return
    if bc_start == BC.NEUMANN:
        if sym:
            s.penta_row1_u1 = 0.0
            s.penta_row1_u2 = 0.0
            s.penta_row2_diag = 1.0 - be
        else:
            s.penta_row1_u1 = 2 * al
            s.penta_row1_u2 = 2 * be
            s.penta_row2_diag = 1.0 + be
    else:
        s.penta_row1_u1 = al
        s.penta_row1_u2 = be
        s.penta_row2_diag = 1.0
    if bc_end == BC.NEUMANN:
        s.penta_rowN1_diag = (1.0 - be) if sym else (1.0 + be)
        if sym:
            s.penta_rowN_identity = True
            # Row n: f'_n = 0; also zero its RHS row
            s.coeffs_e[3] = 0.0
        else:
            s.penta_rowN_l1 = 2 * al
            s.penta_rowN_l2 = 2 * be
    else:
        s.penta_rowN1_diag = 1.0
        s.penta_rowN_l1 = al
        s.penta_rowN_l2 = be
    if bc_start == BC.NEUMANN and sym:
        # Row 1: f'_1 = 0 with zero RHS
        s.coeffs_s[0] = 0.0


def deriv_2nd(n: int, delta: float, scheme: str, bc_start: int, bc_end: int,
              sym: bool = False, c_nu: float = None,
              nu0_nu: float = None) -> SchemeSystem:
    """Second derivative on a colocated grid (tdsops.f90:407-618)."""
    periodic = bc_start == BC.PERIODIC and bc_end == BC.PERIODIC
    s = _init_system(n, n, periodic, 0, n)
    d2 = delta * delta

    if scheme == "compact6":
        alpha = 2.0 / 11.0
        asi = 12.0 / 11.0 / d2
        bsi = 3.0 / 44.0 / d2
        csi = 0.0
        dsi = 0.0
    elif scheme == "compact6-hyperviscous":
        # Spectral-viscosity closure (tdsops.f90:443-458; Lamballais et al.)
        if c_nu is None or nu0_nu is None:
            raise ValueError("compact6-hyperviscous requires c_nu and nu0_nu")
        dpis3 = 2.0 * np.pi / 3.0
        xnpi2 = np.pi * np.pi * (1.0 + nu0_nu)
        xmpi2 = dpis3 * dpis3 * (1.0 + c_nu * nu0_nu)
        den = 405.0 * xnpi2 - 640.0 * xmpi2 + 144.0
        alpha = 0.5 - (320.0 * xmpi2 - 1296.0) / den
        asi = -(4329.0 * xnpi2 / 8 - 32.0 * xmpi2
                - 140.0 * xnpi2 * xmpi2 + 286.0) / den / d2
        bsi = (2115.0 * xnpi2 - 1792.0 * xmpi2
               - 280.0 * xnpi2 * xmpi2 + 1328.0) / den / (4.0 * d2)
        csi = -(7695.0 * xnpi2 / 8 + 288.0 * xmpi2
                - 180.0 * xnpi2 * xmpi2 - 2574.0) / den / (9.0 * d2)
        dsi = (198.0 * xnpi2 + 128.0 * xmpi2
               - 40.0 * xnpi2 * xmpi2 - 736.0) / den / (16.0 * d2)
    else:
        raise ValueError(f"unknown deriv_2nd scheme {scheme!r}")

    s.alpha, s.a, s.bb, s.c, s.d = alpha, asi, bsi, csi, dsi
    s.coeffs = np.array([dsi, csi, bsi, asi,
                         -2.0 * (asi + bsi + csi + dsi),
                         asi, bsi, csi, dsi])
    _broadcast_rows(s)
    s.sa[:] = alpha
    s.sc[:] = alpha

    if bc_start == BC.NEUMANN:
        if sym:
            # even field closure (tdsops.f90:487-504)
            s.sa[0] = 0.0
            s.sc[0] = 2 * alpha
            s.coeffs_s[0] = np.array(
                [0, 0, 0, 0, -2 * (asi + bsi + csi + dsi),
                 2 * asi, 2 * bsi, 2 * csi, 2 * dsi])
            s.coeffs_s[1] = np.array(
                [0, 0, 0, asi, -2 * asi - bsi - 2 * csi - 2 * dsi,
                 asi + csi, bsi + dsi, csi, dsi])
            s.coeffs_s[2] = np.array(
                [0, 0, bsi, asi + csi, -2 * asi - 2 * bsi - 2 * csi - dsi,
                 asi, bsi, csi, dsi])
            s.coeffs_s[3] = np.array(
                [0, csi, bsi + dsi, asi, -2 * (asi + bsi + csi + dsi),
                 asi, bsi, csi, dsi])
        else:
            # odd field: f''(0)=0 row (tdsops.f90:506-522)
            s.sa[0] = 0.0
            s.sc[0] = 0.0
            s.coeffs_s[0] = 0.0
            s.coeffs_s[1] = np.array(
                [0, 0, 0, asi, -2 * asi - 3 * bsi - 2 * csi - 2 * dsi,
                 asi - csi, bsi - dsi, csi, dsi])
            s.coeffs_s[2] = np.array(
                [0, 0, bsi, asi - csi, -2 * asi - 2 * bsi - 2 * csi - 3 * dsi,
                 asi, bsi, csi, dsi])
            s.coeffs_s[3] = np.array(
                [0, -csi, bsi - dsi, asi, -2 * (asi + bsi + csi + dsi),
                 asi, bsi, csi, dsi])
    elif bc_start == BC.DIRICHLET:
        # one-sided rows (tdsops.f90:524-548)
        s.sa[0] = 0.0
        s.sc[0] = 11.0
        s.coeffs_s[0] = np.array(
            [0, 0, 0, 0, 13.0, -27.0, 15.0, -1.0, 0]) / d2
        s.sa[1] = 0.1
        s.sc[1] = 0.1
        s.coeffs_s[1] = np.array([0, 0, 0, 1.2, -2.4, 1.2, 0, 0, 0]) / d2
        t1 = 3.0 / 44.0 / d2
        t2 = 12.0 / 11.0 / d2
        s.sa[2] = 2.0 / 11.0
        s.sc[2] = 2.0 / 11.0
        s.coeffs_s[2] = np.array(
            [0, 0, t1, t2, -2.0 * (t1 + t2), t2, t1, 0, 0])
        s.sa[3] = 2.0 / 11.0
        s.sc[3] = 2.0 / 11.0
        s.coeffs_s[3] = s.coeffs_s[2].copy()

    if bc_end == BC.NEUMANN:
        if sym:
            s.sa[n - 1] = 2 * alpha
            s.sc[n - 1] = 0.0
            s.coeffs_e[3] = np.array(
                [2 * dsi, 2 * csi, 2 * bsi, 2 * asi,
                 -2 * (asi + bsi + csi + dsi), 0, 0, 0, 0])
            s.coeffs_e[2] = np.array(
                [dsi, csi, bsi + dsi, asi + csi,
                 -2 * asi - bsi - 2 * csi - 2 * dsi, asi, 0, 0, 0])
            s.coeffs_e[1] = np.array(
                [dsi, csi, bsi, asi, -2 * asi - 2 * bsi - 2 * csi - dsi,
                 asi + csi, bsi, 0, 0])
            s.coeffs_e[0] = np.array(
                [dsi, csi, bsi, asi, -2 * (asi + bsi + csi + dsi),
                 asi, bsi + dsi, csi, 0])
        else:
            s.sa[n - 1] = 0.0
            s.sc[n - 1] = 0.0
            s.coeffs_e[3] = 0.0
            s.coeffs_e[2] = np.array(
                [dsi, csi, bsi - dsi, asi - csi,
                 -2 * asi - 3 * bsi - 2 * csi - 2 * dsi, asi, 0, 0, 0])
            s.coeffs_e[1] = np.array(
                [dsi, csi, bsi, asi, -2 * asi - 2 * bsi - 2 * csi - 3 * dsi,
                 asi - csi, bsi, 0, 0])
            s.coeffs_e[0] = np.array(
                [dsi, csi, bsi, asi, -2 * (asi + bsi + csi + dsi),
                 asi, bsi - dsi, -csi, 0])
    elif bc_end == BC.DIRICHLET:
        s.sa[n - 1] = 11.0
        s.sc[n - 1] = 0.0
        s.coeffs_e[3] = np.array(
            [0, -1.0, 15.0, -27.0, 13.0, 0, 0, 0, 0]) / d2
        s.sa[n - 2] = 0.1
        s.sc[n - 2] = 0.1
        s.coeffs_e[2] = np.array([0, 0, 0, 1.2, -2.4, 1.2, 0, 0, 0]) / d2
        t1 = 3.0 / 44.0 / d2
        t2 = 12.0 / 11.0 / d2
        s.sa[n - 3] = 2.0 / 11.0
        s.sc[n - 3] = 2.0 / 11.0
        s.coeffs_e[1] = np.array(
            [0, 0, t1, t2, -2.0 * (t1 + t2), t2, t1, 0, 0])
        s.sa[n - 4] = 2.0 / 11.0
        s.sc[n - 4] = 2.0 / 11.0
        s.coeffs_e[0] = s.coeffs_e[1].copy()

    return s


def interpl_mid(n: int, scheme: str, from_to: str, bc_start: int,
                bc_end: int) -> SchemeSystem:
    """Midpoint interpolation vertex<->cell (tdsops.f90:620-764).

    v2p: n outputs at cell midpoints; needs n+1 input vertices when the end
    BC is Neumann/Dirichlet (n_rhs = n+1, reference tdsops.f90:114-123).
    """
    periodic = bc_start == BC.PERIODIC and bc_end == BC.PERIODIC
    move = 1 if from_to == "v2p" else -1
    if periodic:
        n_in, n_rhs = n, n
    elif from_to == "v2p":
        n_in, n_rhs = n + 1, n + 1
    else:  # p2v: n vertices out of n-1 cells
        n_in, n_rhs = n - 1, n
    s = _init_system(n, n_in, periodic, move, n_rhs)

    if scheme == "classic":
        alpha = 0.3
        aici, bici, cici, dici = 0.75, 0.05, 0.0, 0.0
    elif scheme == "optimised":
        alpha = 0.461658
        dici = 0.00146508
        aici = (75.0 + 70.0 * alpha - 640.0 * dici) / 128.0
        bici = (-25.0 + 126.0 * alpha + 2304.0 * dici) / 256.0
        cici = (3.0 - 10.0 * alpha - 1280.0 * dici) / 256.0
    elif scheme == "aggressive":
        alpha = 0.49
        aici = (75.0 + 70.0 * alpha) / 128.0
        bici = (-25.0 + 126.0 * alpha) / 256.0
        cici = (3.0 - 10.0 * alpha) / 256.0
        dici = 0.0
    else:
        raise ValueError(f"unknown interpolation scheme {scheme!r}")

    s.alpha, s.a, s.bb, s.c, s.d = alpha, aici, bici, cici, dici
    if from_to == "v2p":
        s.coeffs = np.array(
            [0.0, dici, cici, bici, aici, aici, bici, cici, dici])
    else:
        s.coeffs = np.array(
            [dici, cici, bici, aici, aici, bici, cici, dici, 0.0])
    _broadcast_rows(s)
    s.sa[:] = alpha
    s.sc[:] = alpha

    if bc_start == BC.NEUMANN:
        s.sa[0] = 0.0
        if from_to == "v2p":
            # symmetric closure (tdsops.f90:691-702)
            s.b[0] = 1.0 + alpha
            s.coeffs_s[0] = np.array(
                [0, 0, 0, 0, aici, aici + bici, bici + cici,
                 cici + dici, dici])
            s.coeffs_s[1] = np.array(
                [0, 0, 0, bici, aici + cici, aici + dici, bici, cici, dici])
            s.coeffs_s[2] = np.array(
                [0, 0, cici, bici + dici, aici, aici, bici, cici, dici])
        else:
            # p2v (tdsops.f90:703-718)
            s.sc[0] = 2 * alpha
            s.coeffs_s[0] = np.array(
                [0, 0, 0, 0, 2 * aici, 2 * bici, 2 * cici, 2 * dici, 0])
            s.coeffs_s[1] = np.array(
                [0, 0, 0, aici + bici, aici + cici, bici + dici,
                 cici, dici, 0])
            s.coeffs_s[2] = np.array(
                [0, 0, bici + cici, aici + dici, aici, bici, cici, dici, 0])
            s.coeffs_s[3] = np.array(
                [0, cici + dici, bici, aici, aici, bici, cici, dici, 0])
    elif bc_start == BC.DIRICHLET:
        raise ValueError("Dirichlet BC unsupported for midpoint interpolation"
                         " (reference enforces Neumann, solver.f90:236-245)")

    if bc_end == BC.NEUMANN:
        s.sc[n - 1] = 0.0
        if from_to == "v2p":
            s.b[n - 1] = 1.0 + alpha
            s.coeffs_e[3] = 0.0
            s.coeffs_e[2] = np.array(
                [0, dici, cici + dici, bici + cici, aici + bici,
                 aici, 0, 0, 0])
            s.coeffs_e[1] = np.array(
                [0, dici, cici, bici, aici + dici, aici + cici,
                 bici, 0, 0])
            s.coeffs_e[0] = np.array(
                [0, dici, cici, bici, aici, aici, bici + dici, cici, 0])
        else:
            s.sa[n - 1] = 2 * alpha
            s.coeffs_e[3] = np.array(
                [2 * dici, 2 * cici, 2 * bici, 2 * aici, 0, 0, 0, 0, 0])
            s.coeffs_e[2] = np.array(
                [dici, cici, bici + dici, aici + cici, aici + bici,
                 0, 0, 0, 0])
            s.coeffs_e[1] = np.array(
                [dici, cici, bici, aici, aici + dici, bici + cici, 0, 0, 0])
            s.coeffs_e[0] = np.array(
                [dici, cici, bici, aici, aici, bici, cici + dici, 0, 0])
    elif bc_end == BC.DIRICHLET:
        raise ValueError("Dirichlet BC unsupported for midpoint interpolation")

    return s


def stagder_1st(n: int, delta: float, scheme: str, from_to: str,
                bc_start: int, bc_end: int) -> SchemeSystem:
    """Staggered first derivative vertex<->cell (tdsops.f90:766-872)."""
    periodic = bc_start == BC.PERIODIC and bc_end == BC.PERIODIC
    move = 1 if from_to == "v2p" else -1
    if periodic:
        n_in, n_rhs = n, n
    elif from_to == "v2p":
        n_in, n_rhs = n + 1, n + 1
    else:
        n_in, n_rhs = n - 1, n
    s = _init_system(n, n_in, periodic, move, n_rhs)

    if scheme == "compact6":
        alpha = 9.0 / 62.0
        aci = 63.0 / 62.0 / delta
        bci = 17.0 / 62.0 / 3.0 / delta
    else:
        raise ValueError(f"unknown stagder scheme {scheme!r}")

    s.alpha, s.a, s.bb = alpha, aci, bci
    if from_to == "v2p":
        s.coeffs = np.array([0, 0, 0, -bci, -aci, aci, bci, 0, 0], dtype=float)
    else:
        s.coeffs = np.array([0, 0, -bci, -aci, aci, bci, 0, 0, 0], dtype=float)
    _broadcast_rows(s)
    s.sa[:] = alpha
    s.sc[:] = alpha

    if bc_start == BC.NEUMANN:
        s.sa[0] = 0.0
        if from_to == "v2p":
            # antisymmetric closure (tdsops.f90:824-832)
            s.b[0] = 1.0 + alpha
            s.coeffs_s[0] = np.array(
                [0, 0, 0, 0, -aci - 2 * bci, aci + bci, bci, 0, 0])
            s.coeffs_s[1] = np.array(
                [0, 0, 0, -bci, -aci, aci, bci, 0, 0])
        else:
            # symmetric closure: derivative zero at wall (tdsops.f90:833-840)
            s.sc[0] = 0.0
            s.coeffs_s[0] = 0.0
            s.coeffs_s[1] = np.array(
                [0, 0, 0, -aci - bci, aci, bci, 0, 0, 0])
    elif bc_start == BC.DIRICHLET:
        raise ValueError("Dirichlet BC unsupported for staggered derivative")

    if bc_end == BC.NEUMANN:
        s.sc[n - 1] = 0.0
        if from_to == "v2p":
            s.b[n - 1] = 1.0 + alpha
            s.coeffs_e[3] = 0.0
            s.coeffs_e[2] = np.array(
                [0, 0, 0, -bci, -aci - bci, aci + 2 * bci, 0, 0, 0])
        else:
            s.sa[n - 1] = 0.0
            s.coeffs_e[3] = 0.0
            s.coeffs_e[2] = np.array(
                [0, 0, -bci, -aci, aci + bci, 0, 0, 0, 0])
    elif bc_end == BC.DIRICHLET:
        raise ValueError("Dirichlet BC unsupported for staggered derivative")

    return s


def build_system(operation: str, n: int, delta: float, scheme: str,
                 bc_start: int, bc_end: int, from_to: str = None,
                 sym: bool = False, c_nu: float = None,
                 nu0_nu: float = None) -> SchemeSystem:
    """Factory mirroring tdsops_init's operation dispatch (tdsops.f90:171-182)."""
    if operation == "first-deriv":
        return deriv_1st(n, delta, scheme, bc_start, bc_end, sym)
    if operation == "second-deriv":
        return deriv_2nd(n, delta, scheme, bc_start, bc_end, sym, c_nu, nu0_nu)
    if operation == "interpolate":
        return interpl_mid(n, scheme, from_to, bc_start, bc_end)
    if operation == "stag-deriv":
        return stagder_1st(n, delta, scheme, from_to, bc_start, bc_end)
    raise ValueError(f"unknown operation {operation!r}")
