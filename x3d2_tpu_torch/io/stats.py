"""Online flow statistics: running means via incremental (Welford-style)
updates.

Counterpart of x3d2_tpu.io.stats (reference src/io/stats.f90):
accumulators for u,v,w, u^2,v^2,w^2, uv,uw,vw [, p, phi, phi^2] on the
VERT grid (stats.f90:33-50), update rule mean += (val-mean)/n
(accumulate_mean:61-70), accumulation gated by initstat/istatfreq, derived
u' RMS and Reynolds stresses at write time (write_stats:195-246), state
persisted through checkpoints.

The accumulators live on the fields' device and are updated in place
(x3d2_tpu donates them to its jitted update), with x3d2_tpu's arithmetic
``acc + (val - acc) * inc``, inc = 1 / count in the fields' dtype. The
update is ordered on the device's stream before the next step, which may
write over the step's output buffers. ``write`` derives the RMS and the
stresses on the host with x3d2_tpu's numpy expressions and file names.

On a process mesh (the case's ``pmesh``: a sharded step's working case,
parallel/topo.py) the accumulators hold the rank's blocks, the pressure
mean interpolates p through the case's halo solver, and ``write`` gathers
them (collective: every rank calls it) for rank 0 to write (x3d2_tpu
stats.py:96-129).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..parallel import multihost
from ..postprocess import pressure_vert


MOMENTS = ("umean", "vmean", "wmean", "uumean", "vvmean", "wwmean",
           "uvmean", "uwmean", "vwmean")


def _host(t):
    return t.detach().cpu().numpy()


@torch.no_grad()
def accumulate(acc, u, v, w, count, p=None, phi=None):
    """acc[k] <- acc[k] + (val_k - acc[k]) * (1 / count), in place."""
    npdt = np.dtype(str(u.dtype).removeprefix("torch."))
    inc = float(np.asarray(1.0, npdt) / np.asarray(count, npdt))
    vals = {"umean": lambda: u, "vmean": lambda: v, "wmean": lambda: w,
            "uumean": lambda: u * u, "vvmean": lambda: v * v,
            "wwmean": lambda: w * w, "uvmean": lambda: u * v,
            "uwmean": lambda: u * w, "vwmean": lambda: v * w,
            "pmean": lambda: p, "phimean": lambda: phi,
            "phiphimean": lambda: phi * phi}
    for k, a in acc.items():
        t = torch.sub(vals[k](), a)
        t.mul_(inc)
        a.add_(t)


class StatsManager:
    def __init__(self, case, config, verbose=True):
        self.config = config
        self.case = case
        self.verbose = verbose
        self.sample_count = 0
        self.acc = None
        self.is_active = config.initstat > 0
        self.last_written = -1
        self.pmesh = getattr(case, "pmesh", None)

    def _gathered(self):
        """The accumulators as whole fields on the host (collective on a
        mesh: every rank gathers them in one order, their names')."""
        return {k: _host(multihost.gather_global(self.acc[k], self.pmesh,
                                                 self.case.mesh))
                for k in sorted(self.acc)}

    def _init_acc(self, state):
        self.acc = {k: torch.zeros_like(state["u"]) for k in MOMENTS}
        # pressure mean when the case keeps physical pressure
        # (reference stats.f90:44-45, gated on keep_pressure)
        self._with_p = (getattr(self.case, "keep_pressure", False)
                        and "p" in state)
        if self._with_p:
            self.acc["pmean"] = torch.zeros_like(state["u"])
        # species moments (stats.f90:47-50)
        self._with_phi = "phi" in state
        if self._with_phi:
            self.acc["phimean"] = torch.zeros_like(state["phi"])
            self.acc["phiphimean"] = torch.zeros_like(state["phi"])

    def should_accumulate(self, timestep):
        c = self.config
        return (self.is_active and timestep >= c.initstat
                and timestep % max(1, c.istatfreq) == 0)

    def update(self, state, timestep):
        if not self.should_accumulate(timestep):
            return
        if self.acc is None:
            self._init_acc(state)
        self.sample_count += 1
        p = None
        if self._with_p:
            p = pressure_vert(self.case.solver, state["p"], self.case.dt)
        phi = state["phi"] if self._with_phi else None
        accumulate(self.acc, state["u"], state["v"], state["w"],
                   self.sample_count, p=p, phi=phi)

    def should_write(self, timestep):
        c = self.config
        return (self.is_active and c.istatout > 0 and self.acc is not None
                and timestep % c.istatout == 0
                and timestep != self.last_written)

    def write(self, timestep):
        """Write means + derived RMS/Reynolds stresses
        (stats.f90:231-246)."""
        a = self._gathered()
        out = dict(sample_count=self.sample_count,
                   umean=a["umean"], vmean=a["vmean"], wmean=a["wmean"],
                   uprime=np.sqrt(np.maximum(0, a["uumean"] - a["umean"]**2)),
                   vprime=np.sqrt(np.maximum(0, a["vvmean"] - a["vmean"]**2)),
                   wprime=np.sqrt(np.maximum(0, a["wwmean"] - a["wmean"]**2)),
                   uvmean=a["uvmean"] - a["umean"] * a["vmean"],
                   uwmean=a["uwmean"] - a["umean"] * a["wmean"],
                   vwmean=a["vwmean"] - a["vmean"] * a["wmean"])
        if "pmean" in a:
            out["pmean"] = a["pmean"]
        if "phimean" in a:
            out["phimean"] = a["phimean"]
            out["phiprime"] = np.sqrt(
                np.maximum(0, a["phiphimean"] - a["phimean"] ** 2))
        path = f"{self.config.stats_prefix}_{timestep:06d}.npz"
        self.last_written = timestep
        if not multihost.is_primary():
            return path
        tmp = path + ".tmp"
        with open(tmp, "wb") as fh:
            np.savez(fh, **out)
        os.replace(tmp, path)
        if self.verbose:
            print(f"Statistics written: {path} (samples={self.sample_count})")
        return path

    # -- checkpoint integration ------------------------------------------
    def checkpoint_state(self, gather=True):
        """The accumulators and the sample count as numpy: whole fields
        (gathered on a mesh, collective), or with gather=False the rank's
        blocks (the per-shard checkpoint's)."""
        if self.acc is None:
            return None
        d = (self._gathered() if gather else
             {k: _host(v) for k, v in self.acc.items()})
        d["sample_count"] = np.asarray(self.sample_count)
        return d

    def restore(self, stats_dict):
        if not stats_dict or "sample_count" not in stats_dict:
            return
        # 0-d, or one element (a per-shard checkpoint's, io/sharded.py)
        self.sample_count = int(np.asarray(
            stats_dict["sample_count"]).reshape(()))
        case = self.case
        self.acc = {k: torch.as_tensor(np.array(v), dtype=case.dtype,
                                       device=case.device).contiguous()
                    for k, v in stats_dict.items() if k != "sample_count"}
        self._with_p = "pmean" in self.acc
        self._with_phi = "phimean" in self.acc
