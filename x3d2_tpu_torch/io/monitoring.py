"""Run-time monitoring: enstrophy, divergence, kinetic energy time series.

Counterpart of x3d2_tpu.io.monitoring (reference
src/postprocess/monitoring.f90:46-90): writes ``monitoring.csv`` with the
columns time, enstrophy, div_u_max, div_u_mean and kinetic energy. On a
process mesh (parallel/topo.py) the observables of the ranks' blocks are
reduced over all ranks (sums and the maximum, over the global point
counts), and only rank 0 opens the file and prints (the reference's
root-rank pattern; x3d2_tpu's process 0).
"""

from __future__ import annotations

import csv
import math

import torch


def make_observables_fn(solver, pmesh=None):
    """Returns fn(u, v, w) -> dict of 0-d tensors; with `pmesh` (a
    parallel.topo.ProcessMesh) over the rank's blocks, reduced over all
    ranks (every rank calls it and gets the global values)."""
    if pmesh is not None:
        from ..common import DataLoc
        from ..parallel.topo import field_spec
        counts, copies = [], []
        for loc in (DataLoc.VERT, DataLoc.CELL):
            dims = solver.mesh.dims(loc)
            counts.append(math.prod(dims))
            # ranks holding the same block (an axis left whole)
            spec = field_spec(pmesh, dims)
            copies.append(math.prod(pmesh.shape[n] for n in ("y", "z")
                                    if n not in spec))
        reps = torch.tensor([copies[0], copies[1], copies[0]],
                            dtype=solver.dtype, device=solver.device)

    def observables(u, v, w):
        cx, cy, cz = solver.curl(u, v, w)
        adiv = solver.divergence_v2p(u, v, w).abs()
        sums = torch.stack([(cx * cx).sum() + (cy * cy).sum()
                            + (cz * cz).sum(), adiv.sum(),
                            (u * u + v * v + w * w).sum()])
        dmax = adiv.max()
        nu_, ndiv = u.numel(), adiv.numel()
        if pmesh is not None:
            import torch.distributed as dist
            sums = pmesh.all_reduce(sums, dist.ReduceOp.SUM) / reps
            dmax = pmesh.all_reduce(dmax.reshape(1), dist.ReduceOp.MAX)[0]
            nu_, ndiv = counts
        return {
            "enstrophy": 0.5 * sums[0] / nu_,
            "div_u_max": dmax,
            # normalised by the global grid count of the div field's
            # location, as the reference does (omp/backend.f90:803)
            "div_u_mean": sums[1] / ndiv,
            "ke": 0.5 * sums[2] / nu_,
        }

    return torch.no_grad()(observables)


class Monitor:
    """CSV scalar-series writer (reference scalar_series_t)."""

    COLUMNS = ["time", "enstrophy", "div_u_max", "div_u_mean", "ke"]

    def __init__(self, solver, path="monitoring.csv", verbose=True):
        self.fn = make_observables_fn(solver)
        from ..parallel.multihost import is_primary
        if not is_primary():
            # one writer: rank 0
            path, verbose = None, False
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
