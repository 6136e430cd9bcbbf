"""Taylor-Green vortex case (reference src/case/tgv.f90).

Analytic IC u = sin(x)cos(y)cos(z), v = -cos(x)sin(y)cos(z), w = 0
(tgv.f90:56-63), each passive scalar starting as a copy of u; fully
periodic box, no BCs or forcings. Counterpart of x3d2_tpu.cases.tgv.
"""

from __future__ import annotations

import numpy as np

from ..common import DataLoc
from .base import BaseCase


class TGVCase(BaseCase):
    name = "tgv"

    def initial_conditions(self):
        X, Y, Z = self.mesh.coord_grids(DataLoc.VERT)
        u = np.sin(X) * np.cos(Y) * np.cos(Z)
        v = -np.cos(X) * np.sin(Y) * np.cos(Z)
        fields = {"u": u, "v": v, "w": np.zeros_like(u)}
        if self.params.n_species:
            fields["phi"] = np.stack([u] * self.params.n_species)
        return fields
