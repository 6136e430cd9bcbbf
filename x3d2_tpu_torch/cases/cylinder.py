"""Flow past a cylinder with IBM (reference src/case/cylinder.f90).

Counterpart of x3d2_tpu.cases.cylinder:
- IC: uniform u=1 with localized noise around mid-x (cylinder.f90:56-102),
  numpy, seeded from the case's seed as in x3d2_tpu
- inflow plane Dirichlet with fresh noise each substage
  (define_BC_cylinder:159-219), drawn from the state's torch.Generator
- convective outflow on the right x face:
  u_N ``-=`` c*(u_N - u_{N-1}) - flow_rate_corr with c = uxmax*gdt/dx
  (compute_outflow_params:109-147; field_set_face_from_field X_FACE,
  omp/backend.f90:986-1003)
- cylinder body via the mask IBM (solver body hook, ibm.f90:148-170)

The hooks are elementwise PyTorch and small reductions on the case's
device (XLA in x3d2_tpu). apply_bc writes the two x faces of the fields of
the time update in place (the step consumes its state).
"""

from __future__ import annotations

import numpy as np
import torch

from ..common import DataLoc
from ..config import CylinderConfig
from ..ibm import get_mask
from .base import BaseCase


class CylinderCase(BaseCase):
    name = "cylinder"

    def __init__(self, *args, ibm_mask=None, **kw):
        super().__init__(*args, **kw)
        if self.params.ibm_on:
            mask = ibm_mask if ibm_mask is not None else get_mask(self.mesh)
            self.ep = self._tensor(mask)
        else:
            self.ep = None

    @property
    def cfg(self) -> CylinderConfig:
        return self.case_cfg or CylinderConfig()

    def initial_conditions(self):
        X, Y, Z = self.mesh.coord_grids(DataLoc.VERT)
        dims = self.mesh.dims(DataLoc.VERT)
        rng = np.random.default_rng(self.seed)
        noise = np.asarray(self.cfg.init_noise, dtype=np.float64)
        x = X - self.mesh.L[0] / 2.0
        um = np.exp(-0.2 * x * x)
        r = [rng.random(dims) for _ in range(3)]
        u = 1.0 + noise[0] * um * (2 * r[0] - 1.0)
        v = noise[1] * um * (2 * r[1] - 1.0)
        w = noise[2] * um * (2 * r[2] - 1.0)
        return {"u": np.broadcast_to(u, dims).copy(),
                "v": np.broadcast_to(v, dims).copy(),
                "w": np.broadcast_to(w, dims).copy()}

    def define_bc(self, fields, rng, istep):
        u = fields[0]
        nx, ny, nz = u.shape
        # outflow parameters sampled pre-step (cylinder.f90:172-180):
        # uxmax over the x-slice nx-1 (1-based), flow rates as plane means
        # over the local ny*nz (cylinder.f90:124-143)
        uxmax = u[nx - 2].max()
        ny_nz = float(ny * nz)
        flow_in = u[0].sum() / ny_nz
        flow_out = u[nx - 1].sum() / ny_nz
        # inflow noise planes (ny, nz) per component, amplitude damped by
        # the mid-domain envelope at half_L (define_BC_cylinder:169-170)
        half_L = self.mesh.L[0] / 2.0
        um = float(np.exp(-0.2 * half_L * half_L))
        noise = torch.as_tensor(self.cfg.inlet_noise, dtype=self.dtype,
                                device=self.device)
        r = torch.rand((3, ny, nz), generator=rng, dtype=self.dtype,
                       device=self.device)
        planes = noise[:, None, None] * um * (2.0 * r - 1.0)
        planes[0] += 1.0   # u inflow = 1 + noise
        bc_data = {"planes": planes, "uxmax": uxmax,
                   "flow_rate_diff": flow_in - flow_out,
                   "dx": self.mesh.d[0]}
        return fields, bc_data

    def apply_bc(self, fields, bc, gdt, istep):
        c_end = bc["uxmax"] * gdt / bc["dx"]
        fl = bc["flow_rate_diff"]
        for i, f in enumerate(fields[:3]):
            f[0] = bc["planes"][i]
            f[-1] = f[-1] - c_end * (f[-1] - f[-2]) + fl
        return fields

    def body(self, fields):
        if self.ep is None:
            return fields
        return tuple(f * self.ep for f in fields[:3]) + tuple(fields[3:])
