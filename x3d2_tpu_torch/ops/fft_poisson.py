"""FFT-based spectral Poisson solve and its modified-wavenumber tables.

Counterpart of x3d2_tpu.ops.fft_poisson (reference poisson_fft.f90
waves_set:654-831, wave_numbers:833-882; omp/kernels/
spectral_processing.f90 process_spectral_000:7-106, 010:108-283;
cuda/kernels/spectral_processing.f90, the 110 stages :721-1006; the
even-extension folds omp/poisson_fft.f90:237-285). The numpy tables serve
MatmulPoisson (matmul_poisson.py) too. The modified wavenumbers make the
spectral solve exactly consistent with the compact staggered
divergence/gradient operators (Laizet & Lamballais JCP 228 (2009) Sec 4).

``SpectralPoisson`` is x3d2_tpu's FFT pipeline on torch.fft (jnp.fft
there, XLA, no kernel in either package): BC variants 000, 010, 100, 110;
non-periodic axes are folded (even extension) and carry a full complex
spectrum, the r2c axis is a periodic one; the staggered phase shifts and
the folded axes' pair recombination are elementwise; a stretched y goes
through the pentadiagonal solve (stretched_poisson.StretchedYSolver).
"""

from __future__ import annotations

import numpy as np
import torch


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


_EPS = 1e-16


def _sl(t, axis, start, stop=None, step=1):
    """t[start:stop:step] along `axis`."""
    idx = [slice(None)] * t.ndim
    idx[axis] = slice(start, stop, step)
    return t[tuple(idx)]


def fold_even(f, axis):
    """Even-extension reordering of a non-periodic axis for a periodic FFT
    (enforce_periodicity_y, omp/poisson_fft.f90:237-261)."""
    return torch.cat([_sl(f, axis, 0, None, 2),
                      _sl(f, axis, 1, None, 2).flip(axis)], dim=axis)


def unfold_even(f, axis):
    """Inverse of fold_even (undo_periodicity_y,
    omp/poisson_fft.f90:263-285)."""
    n = f.shape[axis]
    half1 = _sl(f, axis, 0, n // 2)
    half2 = _sl(f, axis, n // 2, n).flip(axis)
    return torch.stack([half1, half2], dim=axis + 1).reshape(f.shape)


class SpectralPoisson:
    """Pressure Poisson solve on the cell grid by FFTs; BC variants
    000/010/100/110, a stretched y in 010."""

    def __init__(self, mesh, ops, dtype=torch.float32, device=None):
        from ..common import resolve_device

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
            raise ValueError("FFT Poisson does not support x/z stretching")
        self.stretched_y = mesh.stretched[1]
        if self.stretched_y and self.variant != "010":
            raise ValueError(
                "stretched y requires the 010 BC combination "
                "(reference poisson_fft.f90:181-186)")

        nx, ny, nz = mesh.global_cell_dims
        self.nc = (nx, ny, nz)
        # folded (non-periodic) axes and the r2c axis (a periodic one)
        self.folded = tuple(a for a in range(3) if not per[a])
        self.r2c_axis = {"000": 0, "010": 0, "100": 1, "110": 2}[self.variant]
        for a in self.folded:
            if self.nc[a] % 2:
                raise ValueError(
                    f"folded axis {a} needs an even cell count, "
                    f"got {self.nc[a]}")
        self.rdtype = dtype

        tabs = []
        for ax, axops in enumerate(ops):
            st = axops.stagder_v2p
            tabs.append(wave_numbers(self.nc[ax], mesh.L[ax], mesh.d[ax],
                                     per[ax], st.a, st.b, st.alpha))
        a_, b_, e_, k_, k2_ = zip(*tabs)
        T = [_interp_transfer(ops[ax].interpl_v2p, e_[ax], mesh.d[ax])
             for ax in range(3)]

        # spectral shape: r2c axis halved
        spec = list(self.nc)
        spec[self.r2c_axis] = self.nc[self.r2c_axis] // 2 + 1
        self.spec_shape = tuple(spec)

        def ax3(v, a):
            shape = [1, 1, 1]
            shape[a] = -1
            return torch.as_tensor(np.asarray(v)[:spec[a]].reshape(shape),
                                   dtype=dtype, device=self.device)

        # the separable 1-D tables at the working precision; the waves
        # diagonal is rebuilt from them in the solve
        self._k2b = [ax3(k2_[a], a) for a in range(3)]
        self._Tb = [ax3(T[a], a) for a in range(3)]

        # phase-shift tables (broadcast) and sign-flip vectors; the r2c
        # axis never flips (half spectrum), folded axes use pair
        # recombination
        self.A = [ax3(a_[a], a) for a in range(3)]
        self.B = [ax3(b_[a], a) for a in range(3)]
        self.S = []
        for a in range(3):
            n = self.nc[a]
            if a == self.r2c_axis or a in self.folded:
                s = np.ones(spec[a])
            else:
                s = np.where(np.arange(n) > n // 2, -1.0, 1.0)
            self.S.append(ax3(s, a))

        # stretched y: the pentadiagonal spectral solve in place of the
        # waves division (stretching_matrix, poisson_fft.f90:275-652)
        self.stretch_solver = None
        if self.stretched_y:
            from .stretched_poisson import (StretchedYSolver,
                                            build_stretch_matrices)
            g = mesh.geo[1]
            a_sets, offsets, inc = build_stretch_matrices(
                self.spec_shape[0], ny, nz, T[0], T[1], T[2],
                k_[0], k_[1], k_[2], k2_[0], k2_[2],
                mesh.L[1], g.alpha, g.beta, g.stretching)
            self.stretch_solver = StretchedYSolver(
                a_sets, a_sets, offsets, inc, dtype=dtype,
                device=self.device)

        # post-solve Nyquist zero at (Nyquist, Nyquist) of the two axes
        # each folded variant's kernel names (process_spectral_010:216,
        # process_spectral_110_poisson:883-884)
        if self.folded:
            zero_axes = {"010": (0, 2), "100": (1, 2), "110": (0, 2)}[
                self.variant]
            mask = np.ones(self.spec_shape, dtype=np.float64)
            idx = [slice(None)] * 3
            ok = True
            for a in zero_axes:
                if self.nc[a] % 2:
                    ok = False
                idx[a] = self.nc[a] // 2
            if ok:
                mask[tuple(idx)] = 0.0
            self.zero_mask = torch.as_tensor(mask, dtype=dtype,
                                             device=self.device)

    # -- elementwise shift patterns (literal ports) -----------------------
    def _shift_fwd(self, dr, dc, a):
        """Forward: (r,c) <- (r*b + c*a, c*b - r*a) * flip
        (process_spectral_000:45-64)."""
        A, B, S = self.A[a], self.B[a], self.S[a]
        return (dr * B + dc * A) * S, (dc * B - dr * A) * S

    def _shift_bwd_conj(self, dr, dc, a):
        """000 z-backward pattern (process_spectral_000:78-83)."""
        A, B, S = self.A[a], self.B[a], self.S[a]
        return (dr * B - dc * A) * S, (-dc * B - dr * A) * S

    def _shift_bwd_x000(self, dr, dc, a):
        """000 x-backward pattern (process_spectral_000:93-97)."""
        A, B = self.A[a], self.B[a]
        return dr * B + dc * A, -dc * B + dr * A

    def _shift_bwd(self, dr, dc, a):
        """Folded-variant backward pattern (process_spectral_010:260-274,
        process_spectral_110_z_bw:994-1003)."""
        A, B, S = self.A[a], self.B[a], self.S[a]
        return (dr * B - dc * A) * S, (dc * B + dr * A) * S

    # -- folded-axis pair recombination -----------------------------------
    def _pair(self, dr, dc, a, inverse):
        """Even/odd pair split along folded axis `a`
        (process_spectral_010:166-191; 110_x/y_pair_fw), or its inverse
        (:223-248): every mode but the first with its mirror."""
        A = _sl(self.A[a].expand(dr.shape), a, 1)
        B = _sl(self.B[a].expand(dr.shape), a, 1)
        l_r, l_c = _sl(dr, a, 1), _sl(dc, a, 1)
        r_r, r_c = l_r.flip(a), l_c.flip(a)
        if inverse:
            new_r = l_r * B - l_c * A + r_r * A + r_c * B
            new_c = l_r * A + l_c * B - r_r * B + r_c * A
        else:
            new_r = 0.5 * (l_r * B + l_c * A + r_r * B - r_c * A)
            new_c = 0.5 * (-l_r * A + l_c * B + r_r * A + r_c * B)
        return (torch.cat([_sl(dr, a, 0, 1), new_r], dim=a),
                torch.cat([_sl(dc, a, 0, 1), new_c], dim=a))

    @property
    def waves(self):
        """Spectral-equivalence diagonal rebuilt from the 1-D tables."""
        k2, T = self._k2b, self._Tb
        w = (k2[0] * (T[1] * T[2]) ** 2
             + k2[1] * (T[0] * T[2]) ** 2
             + k2[2] * (T[0] * T[1]) ** 2)
        return w.expand(self.spec_shape)

    @staticmethod
    def _divide(d, w, ok):
        return torch.where(ok, -d / torch.where(ok, w, torch.ones_like(w)),
                           torch.zeros_like(d))

    # ----------------------------------------------------------------------
    def __call__(self, f: torch.Tensor) -> torch.Tensor:
        """Solve the modified-wavenumber Poisson problem; mean-free output."""
        for a in self.folded:
            f = fold_even(f, a)
        ra = self.r2c_axis
        other = [a for a in range(3) if a != ra]
        F = torch.fft.fftn(torch.fft.rfft(f, dim=ra), dim=other)
        dr = F.real.to(self.rdtype)
        dc = F.imag.to(self.rdtype)
        # the inverse FFTs normalise by 1/N (the reference's unnormalised
        # transforms scale here instead)
        if self.variant == "000":
            for a in (2, 1, 0):
                dr, dc = self._shift_fwd(dr, dc, a)
            w = self.waves
            ok = w >= _EPS  # non-abs guard (process_spectral_000:69)
            dr, dc = self._divide(dr, w, ok), self._divide(dc, w, ok)
            dr, dc = self._shift_bwd_conj(dr, dc, 2)
            dr, dc = self._shift_fwd(dr, dc, 1)   # y backward = forward
            dr, dc = self._shift_bwd_x000(dr, dc, 0)
        else:
            # periodic axes: plain forward shifts
            for a in range(3):
                if a not in self.folded:
                    dr, dc = self._shift_fwd(dr, dc, a)
            # folded axes: pair recombination (x before y, 110 kernels)
            for a in self.folded:
                dr, dc = self._pair(dr, dc, a, inverse=False)
            if self.stretch_solver is not None:
                dr, dc = self.stretch_solver(dr, dc, self.nc[0], self.nc[2])
            else:
                w = self.waves
                ok = w.abs() >= _EPS  # abs guards (010 kernel :203)
                dr = self._divide(dr, w, ok) * self.zero_mask
                dc = self._divide(dc, w, ok) * self.zero_mask
            for a in reversed(self.folded):
                dr, dc = self._pair(dr, dc, a, inverse=True)
            for a in range(3):
                if a not in self.folded:
                    dr, dc = self._shift_bwd(dr, dc, a)
        F = torch.fft.ifftn(torch.complex(dr, dc), dim=other)
        # the half spectrum's first and (even n) last planes along the r2c
        # axis enter the c2r transform by their real parts alone, as
        # numpy's and jnp's irfft read them (cuFFT's c2r leaves a
        # non-Hermitian input undefined)
        n = self.nc[ra]
        ends = [0] + ([n // 2] if n % 2 == 0 else [])
        F.imag.index_fill_(ra, torch.tensor(ends, device=F.device), 0.0)
        p = torch.fft.irfft(F, n=n, dim=ra).to(self.rdtype)
        for a in reversed(self.folded):
            p = unfold_even(p, a)
        return p
