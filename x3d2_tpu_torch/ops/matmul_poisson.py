"""Spectral Poisson solve as separable real matrix transforms.

The discrete pressure operator div(grad(.)) built from the compact
staggered schemes is diagonalised by a separable real basis -- real DFT
(cos/sin, halfcomplex packing) on periodic axes and shifted-cosine DCT on
non-periodic (Neumann-pressure) axes -- with eigenvalues given by the
reference's modified-wavenumber tables (poisson_fft.f90 waves_set). The
solve is

    p = T_x^-1 T_y^-1 T_z^-1 [ -T_z T_y T_x f / waves ]

Counterpart of x3d2_tpu.ops.matmul_poisson. Transforms and inverses are
built in float64. A stretched y (variant 010 only) takes one of two
routes, chosen when the solver is built by x3d2_tpu's test
(matmul_poisson.py:135-168): unless X3D2_STRETCH_EIG is "0", the
eigen-resolved solve (stretched_poisson.eigen_resolve) folded into the y
transforms and the diagonal tables, so the solve keeps the uniform
structure; where that raises ValueError, or with X3D2_STRETCH_EIG=0, the
pentadiagonal elimination (``stretch_solver``, a StretchedYSolver) in place
of the diagonal.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..common import resolve_device
from ..mesh import Mesh
from .compact import apply_matrix
from .fft_poisson import _interp_transfer, wave_numbers

_EPS = 1e-16


def real_dft_matrix(n: int) -> np.ndarray:
    """Real DFT with halfcomplex packing: rows 0..n/2 are cos(2*pi*k*j/n),
    rows n/2+1..n-1 are sin(2*pi*k*j/n) for k = n-m (so row m pairs with
    the mirrored k2 tables)."""
    j = np.arange(n)
    T = np.zeros((n, n))
    for m in range(n // 2 + 1):
        T[m] = np.cos(2 * np.pi * m * j / n)
    for m in range(n // 2 + 1, n):
        k = n - m
        T[m] = np.sin(2 * np.pi * k * j / n)
    return T


def dct_matrix(n: int) -> np.ndarray:
    """Shifted-cosine basis for Neumann-pressure axes (cell-centred):
    rows cos(pi*k*(j+1/2)/n)."""
    j = np.arange(n) + 0.5
    return np.cos(np.pi * np.arange(n)[:, None] * j[None, :] / n)


class MatmulPoisson:
    """Pressure Poisson solve on the cell grid via separable real
    transforms; supports BC variants 000/010/100/110 and a stretched y."""

    def __init__(self, mesh: Mesh, ops, dtype=torch.float32, device=None):
        self.mesh = mesh
        self.device = resolve_device(device)
        per = mesh.periodic
        variants = {(True, True, True): "000", (True, False, True): "010",
                    (False, True, True): "100", (False, False, True): "110"}
        if per not in variants:
            raise ValueError(
                f"unsupported Poisson BC combination {per} "
                "(reference poisson_fft.f90:174-203 supports 000/010/100/110)")
        self.variant = variants[per]
        if any(mesh.stretched[a] for a in (0, 2)):
            raise ValueError("spectral Poisson does not support x/z "
                             "stretching")
        self.stretched_y = mesh.stretched[1]
        if self.stretched_y and self.variant != "010":
            raise ValueError("stretched y requires the 010 BC combination")

        nx, ny, nz = mesh.global_cell_dims
        self.nc = (nx, ny, nz)
        self.rdtype = dtype
        self.folded = tuple(a for a in range(3) if not per[a])

        # modified-wavenumber tables (full length per axis)
        tabs, T = [], []
        for ax, axops in enumerate(ops):
            st = axops.stagder_v2p
            tabs.append(wave_numbers(self.nc[ax], mesh.L[ax], mesh.d[ax],
                                     per[ax], st.a, st.b, st.alpha))
            T.append(_interp_transfer(ops[ax].interpl_v2p, tabs[ax][2],
                                      mesh.d[ax]))
        k2 = [t[4] for t in tabs]
        k1 = [t[3] for t in tabs]
        self.k2_1d = [np.asarray(k2[a], np.float64) for a in range(3)]
        self.T_1d = [np.asarray(T[a], np.float64) for a in range(3)]

        # Nyquist zero indices for folded variants
        # (process_spectral_010:216 analogue)
        self._zero_idx = None
        if self.folded:
            zero_axes = {"010": (0, 2), "100": (1, 2), "110": (0, 2)}[
                self.variant]
            if all(self.nc[a] % 2 == 0 for a in zero_axes):
                self._zero_idx = zero_axes

        # per-axis transforms + exact inverses (float64 masters feed the
        # transform-folded projection matrices, solver._fp_mats64)
        self.Tf64, self.Ti64 = [], []
        for a in range(3):
            M = dct_matrix(self.nc[a]) if a in self.folded \
                else real_dft_matrix(self.nc[a])
            self.Tf64.append(np.asarray(M, np.float64))
            self.Ti64.append(np.linalg.inv(self.Tf64[a]))

        # separable solve diagonal: waves(ix, iy, iz) = k2x[ix]*A[iy,iz]
        # + Tx[ix]^2*B[iy,iz]
        self.tab_A = np.outer(T[1] ** 2, T[2] ** 2)
        self.tab_B = (np.outer(k2[1], T[2] ** 2)
                      + np.outer(T[1] ** 2, k2[2]))

        # the stretched y (x3d2_tpu matmul_poisson.py:135-168): the solver
        # takes the transform-folded projection unless stretch_solver is set
        self.stretch_solver = None
        self.stretch_resolved = False
        if self.stretched_y:
            from .stretched_poisson import (StretchedYSolver,
                                            build_stretch_matrices,
                                            eigen_resolve)
            g = mesh.geo[1]
            if os.environ.get("X3D2_STRETCH_EIG", "1") != "0":
                try:
                    Fy, Iy, lam = eigen_resolve(
                        ny, T[1], k1[1], mesh.L[1], g.alpha, g.beta,
                        g.stretching)
                    # the eigenbasis change folded into the y transforms:
                    # every consumer composes Tf / Ti, so the stretched
                    # solve has the uniform one's structure
                    self.Tf64[1] = Fy @ self.Tf64[1]
                    self.Ti64[1] = self.Ti64[1] @ Iy
                    self.tab_A = np.broadcast_to(
                        (T[2] ** 2)[None, :], (ny, nz)).copy()
                    self.tab_B = (np.broadcast_to(k2[2][None, :], (ny, nz))
                                  - np.outer(lam, T[2] ** 2))
                    self.stretch_resolved = True
                except ValueError:
                    pass
            if not self.stretch_resolved:
                a_sets, offsets, inc = build_stretch_matrices(
                    nx, ny, nz, T[0], T[1], T[2],
                    k1[0], k1[1], k1[2], k2[0], k2[2],
                    mesh.L[1], g.alpha, g.beta, g.stretching)
                self.stretch_solver = StretchedYSolver(
                    a_sets, a_sets, offsets, inc, dtype=dtype,
                    device=self.device)

        kw = dict(dtype=dtype, device=self.device)
        self.Tf = [torch.as_tensor(M, **kw) for M in self.Tf64]
        self.Ti = [torch.as_tensor(M, **kw) for M in self.Ti64]
        self._inv_cache = None

    def _inv_waves(self) -> torch.Tensor:
        """The solve diagonal -1/waves from the separable tables, with the
        zero-wave guard and the Nyquist-intersection mask (float64 numpy,
        cast once to the compute dtype and cached on the device)."""
        nx = self.nc[0]
        # tables at the working precision, as x3d2_tpu builds them
        wdt = np.float64 if self.rdtype == torch.float64 else np.float32
        k2x = self.k2_1d[0].astype(wdt).reshape(nx, 1, 1)
        tx2 = (self.T_1d[0] ** 2).astype(wdt).reshape(nx, 1, 1)
        waves = (k2x * self.tab_A.astype(wdt)[None]
                 + tx2 * self.tab_B.astype(wdt)[None])
        ok = np.abs(waves) >= _EPS
        inv = np.where(ok, -1.0 / np.where(ok, waves, 1.0), 0.0)
        if self._zero_idx is not None:
            # zero the (Nyquist, Nyquist) INTERSECTION line of the named
            # axes (spectral_processing.f90:216), not whole planes
            hit = np.ones((1, 1, 1))
            for a in self._zero_idx:
                shp = [1, 1, 1]
                shp[a] = self.nc[a]
                idx = np.arange(self.nc[a]).reshape(shp)
                hit = hit * (idx == self.nc[a] // 2)
            inv = inv * (1.0 - hit)
        return torch.as_tensor(inv, dtype=self.rdtype, device=self.device)

    @property
    def inv_waves(self) -> torch.Tensor:
        if self._inv_cache is None:
            self._inv_cache = self._inv_waves()
        return self._inv_cache

    def __call__(self, f: torch.Tensor) -> torch.Tensor:
        F = f
        for a in range(3):
            F = apply_matrix(self.Tf[a], F, a)
        if self.stretch_solver is not None:
            F = self.stretch_solver.solve_packed(F, self.nc[0], self.nc[2])
        else:
            F = F * self.inv_waves
        for a in range(3):
            F = apply_matrix(self.Ti[a], F, a)
        return F
