"""Modified-wavenumber tables of the spectral Poisson solve (numpy).

The numpy part of x3d2_tpu.ops.fft_poisson that MatmulPoisson needs
(matmul_poisson.py). The modified wavenumbers make the spectral solve
exactly consistent with the compact staggered divergence/gradient
operators (Laizet & Lamballais JCP 228 (2009) Sec 4).
"""

from __future__ import annotations

import numpy as np


def wave_numbers(n, L, d, periodic, c_a, c_b, c_alpha):
    """Modified wavenumber tables for one axis (poisson_fft.f90:833-882).

    Returns (a, b, e, k, k2) float64 arrays of length n: e is the
    unmodified wavenumber grid (for transfer functions), k2 the modified
    squared wavenumbers that enter the solve.
    """
    i = np.arange(n, dtype=np.float64)
    if periodic:
        a = np.sin(i * np.pi / n)
        b = np.cos(i * np.pi / n)
        w = 2 * np.pi * i / n
    else:
        a = np.sin(i * np.pi / 2 / n)
        b = np.cos(i * np.pi / 2 / n)
        w = np.pi * i / n
    wp = c_a * 2 * d * np.sin(0.5 * w) + c_b * 2 * d * np.sin(1.5 * w)
    wp = wp / (1.0 + 2 * c_alpha * np.cos(w))
    e = n * w / L
    k = n * wp / L
    k2 = (n * wp / L) ** 2
    if periodic:
        # mirror onto the conjugate modes (poisson_fft.f90:865-869)
        e[n // 2 + 1:] = e[1:n - n // 2][::-1]
        k[n // 2 + 1:] = k[1:n - n // 2][::-1]
        k2[n // 2 + 1:] = k2[1:n - n // 2][::-1]
    return a, b, e, k, k2


def _interp_transfer(op, e, d):
    """Midpoint-interpolation transfer function T(w)=tt/t1 at e*d
    (waves_set, poisson_fft.f90:706-721)."""
    w = e * d
    tt = 2 * (op.a * np.cos(w * 0.5) + op.b * np.cos(w * 1.5)
              + op.c * np.cos(w * 2.5) + op.d * np.cos(w * 3.5))
    t1 = 1.0 + 2 * op.alpha * np.cos(w)
    return tt / t1
