"""Spectral Poisson solve as separable real matrix transforms.

The discrete pressure operator div(grad(.)) built from the compact
staggered schemes is diagonalised by a separable real basis -- real DFT
(cos/sin, halfcomplex packing) on periodic axes and shifted-cosine DCT on
non-periodic (Neumann-pressure) axes -- with eigenvalues given by the
reference's modified-wavenumber tables (poisson_fft.f90 waves_set). The
solve is

    p = T_x^-1 T_y^-1 T_z^-1 [ -T_z T_y T_x f / waves ]

Counterpart of x3d2_tpu.ops.matmul_poisson. Transforms and inverses are
built in float64; stretched y (the pentadiagonal / eigen-resolved solve)
is not ported yet and raises NotImplementedError.
"""

from __future__ import annotations

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
    transforms; supports BC variants 000/010/100/110 on uniform grids."""

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
        if mesh.stretched[1]:
            raise NotImplementedError(
                "stretched-y Poisson (stretched_poisson.py) is not ported yet")
        # the solver checks this to pick the transform-folded projection
        self.stretch_solver = None

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
        F = F * self.inv_waves
        for a in range(3):
            F = apply_matrix(self.Ti[a], F, a)
        return F
