"""Generic freestream template case (reference src/case/generic.f90;
counterpart of x3d2_tpu.cases.generic): uniform u=1 initial condition, no
BC hooks or forcings."""

from __future__ import annotations

import numpy as np

from ..common import DataLoc
from .base import BaseCase


class GenericCase(BaseCase):
    name = "generic"

    def initial_conditions(self):
        dims = self.mesh.dims(DataLoc.VERT)
        return {"u": np.ones(dims), "v": np.zeros(dims),
                "w": np.zeros(dims)}
