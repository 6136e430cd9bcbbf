"""Turbulent channel flow case (reference src/case/channel.f90).

Counterpart of x3d2_tpu.cases.channel:
- IC: parabolic profile 1-y^2 plus localized noise, zeroed at the y walls
  (channel.f90:134-188), numpy, seeded from the case's seed as in x3d2_tpu
- per-substage bulk-flow correction shifting u so mean(u) = 2/3
  (channel.f90:59-78)
- no-slip y walls stamped with fresh random noise each substage
  (define_BC_channel:80-131 + apply_BC_channel:212-228, Y_FACE planes),
  drawn from the state's torch.Generator
- optional rotation forcing du += -omega*v, dv += omega*u for the first
  n_rotate iterations (forcings_channel:190-205)

The hooks are elementwise PyTorch and one reduction on the case's device
(XLA in x3d2_tpu). Overriding forcings keeps the case off the fused AB and
RK chains (cases/base.py's gates, as x3d2_tpu's). apply_bc writes the two
y walls of the fields of the time update in place (the step consumes its
state).
"""

from __future__ import annotations

import numpy as np
import torch

from ..common import DataLoc
from ..config import ChannelConfig
from .base import BaseCase


class ChannelCase(BaseCase):
    name = "channel"

    @property
    def cfg(self) -> ChannelConfig:
        return self.case_cfg or ChannelConfig()

    def initial_conditions(self):
        X, Y, Z = self.mesh.coord_grids(DataLoc.VERT)
        dims = self.mesh.dims(DataLoc.VERT)
        rng = np.random.default_rng(self.seed)
        # the reference IC reads inlet_noise(3) into all three noise
        # components (channel.f90:153, likely init_noise intended); as in
        # x3d2_tpu, init_noise per the documented intent
        noise = np.asarray(self.cfg.init_noise, dtype=np.float64)
        y = Y - self.mesh.L[1] / 2.0
        um = np.exp(-0.2 * y * y)
        r = [rng.random(dims) for _ in range(3)]
        u = 1.0 - y * y + noise[0] * um * (2 * r[0] - 1.0)
        v = noise[1] * um * (2 * r[1] - 1.0)
        w = noise[2] * um * (2 * r[2] - 1.0)
        u = np.broadcast_to(u, dims).copy()
        v = np.broadcast_to(v, dims).copy()
        w = np.broadcast_to(w, dims).copy()
        for f in (u, v, w):  # no-slip walls (channel.f90:169-174)
            f[:, 0, :] = 0.0
            f[:, -1, :] = 0.0
        return {"u": u, "v": v, "w": w}

    def define_bc(self, fields, rng, istep):
        u, v, w = fields[:3]
        # bulk-flow correction to mean streamwise velocity 2/3
        # (channel.f90:70-78; sum over VERT points / global CELL count)
        ncell = float(np.prod(self.mesh.global_cell_dims))
        ub = u.sum() / ncell
        u = u + (2.0 / 3.0 - ub)
        # fresh random wall noise planes, shape (nx, 2, nz) per component
        nx, ny, nz = u.shape
        noise = torch.as_tensor(self.cfg.inlet_noise, dtype=self.dtype,
                                device=self.device)
        r = torch.rand((3, nx, 2, nz), generator=rng, dtype=self.dtype,
                       device=self.device)
        planes = noise[:, None, None, None] * (2.0 * r - 1.0)
        return (u, v, w) + tuple(fields[3:]), planes

    def forcings(self, rhs, fields, istep):
        cfg = self.cfg
        if not cfg.rotation:
            return rhs
        u, v = fields[0], fields[1]
        # the rotation at the working precision (x3d2_tpu casts it)
        rot = torch.tensor(cfg.omega_rot if istep < cfg.n_rotate else 0.0,
                           dtype=self.dtype, device=self.device)
        du, dv, dw = rhs[:3]
        return (du - rot * v, dv + rot * u) + (dw,) + tuple(rhs[3:])

    def apply_bc(self, fields, planes, gdt, istep):
        for i, f in enumerate(fields[:3]):
            f[:, 0, :] = planes[i, :, 0, :]
            f[:, -1, :] = planes[i, :, 1, :]
        return fields
