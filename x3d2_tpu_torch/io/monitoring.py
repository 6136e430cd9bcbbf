"""Run-time monitoring: enstrophy, divergence, kinetic energy time series.

Counterpart of x3d2_tpu.io.monitoring (reference
src/postprocess/monitoring.f90:46-90): writes ``monitoring.csv`` with the
columns time, enstrophy, div_u_max, div_u_mean and kinetic energy. The
port runs as one process, so it always writes.
"""

from __future__ import annotations

import csv

import torch


def make_observables_fn(solver):
    """Returns fn(u, v, w) -> dict of 0-d tensors."""

    def observables(u, v, w):
        cx, cy, cz = solver.curl(u, v, w)
        enstrophy = 0.5 * ((cx * cx).sum() + (cy * cy).sum()
                           + (cz * cz).sum()) / u.numel()
        adiv = solver.divergence_v2p(u, v, w).abs()
        return {
            "enstrophy": enstrophy,
            "div_u_max": adiv.max(),
            # normalised by the global grid count of the div field's
            # location, as the reference does (omp/backend.f90:803)
            "div_u_mean": adiv.sum() / adiv.numel(),
            "ke": 0.5 * (u * u + v * v + w * w).mean(),
        }

    return torch.no_grad()(observables)


class Monitor:
    """CSV scalar-series writer (reference scalar_series_t)."""

    COLUMNS = ["time", "enstrophy", "div_u_max", "div_u_mean", "ke"]

    def __init__(self, solver, path="monitoring.csv", verbose=True):
        self.fn = make_observables_fn(solver)
        self.path = path
        self.verbose = verbose
        self.rows = []
        self._fh = None
        if path is not None:
            self._fh = open(path, "w", newline="")
            self._csv = csv.writer(self._fh)
            self._csv.writerow(self.COLUMNS)

    def write_step(self, t, u, v, w):
        obs = {k: float(x) for k, x in self.fn(u, v, w).items()}
        row = [t] + [obs[c] for c in self.COLUMNS[1:]]
        self.rows.append(row)
        if self._fh is not None:
            self._csv.writerow(row)
            self._fh.flush()
        if self.verbose:
            print(f"t={t:10.4f} enstrophy={obs['enstrophy']:.8e} "
                  f"div max/mean={obs['div_u_max']:.3e}/"
                  f"{obs['div_u_mean']:.3e} ke={obs['ke']:.8e}")
        return obs

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None
