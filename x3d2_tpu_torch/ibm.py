"""Immersed boundary method (basic mask IBM, iibm=1); copy of x3d2_tpu.ibm
(numpy only).

Equivalent of reference src/module/ibm.f90: a vertex-centred mask field
``ep`` (1 in fluid, 0 in solid) multiplies the velocity after each time
update, before the pressure correction (ibm.f90:148-170; applied from the
run loop, base_case.f90:286-292).

The reference reads the mask from a pre-generated ADIOS2 file
(``ibm_<nx>x<ny>x<nz>.bp``, ibm.f90:43-146) produced by an external tool.
Here the mask is either loaded from a .npy/.npz file or synthesised
analytically (cylinder_mask mirrors the example generator's
``--cyl r cx cy cz ax ay az`` parameters, examples/cylinder/readme.md:3).
"""

from __future__ import annotations

import os

import numpy as np

from .common import DataLoc
from .mesh import Mesh


def cylinder_mask(mesh: Mesh, center_xy=None, radius=0.5,
                  axis: int = 2) -> np.ndarray:
    """Mask for an infinite cylinder aligned with `axis` (default z).

    center_xy: coordinates of the axis in the two transverse directions
    (defaults to the domain centre in those directions).
    """
    dims = mesh.dims(DataLoc.VERT)
    tr = [a for a in range(3) if a != axis]
    if center_xy is None:
        center_xy = [mesh.L[a] / 2 for a in tr]
    grids = mesh.coord_grids(DataLoc.VERT)
    r2 = ((grids[tr[0]] - center_xy[0]) ** 2
          + (grids[tr[1]] - center_xy[1]) ** 2)
    mask = np.where(r2 < radius**2, 0.0, 1.0)
    return np.broadcast_to(mask, dims).copy()


def load_mask(path: str, mesh: Mesh) -> np.ndarray:
    """Load a vertex mask from .npy/.npz (variable 'ep')."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            mask = z["ep"]
    else:
        mask = np.load(path)
    dims = mesh.dims(DataLoc.VERT)
    if tuple(mask.shape) != tuple(dims):
        raise ValueError(f"IBM mask shape {mask.shape} != vert dims {dims}")
    return np.asarray(mask, dtype=np.float64)


def default_mask_path(mesh: Mesh) -> str:
    """Reference naming: ibm_<nx>x<ny>x<nz> (ibm.f90:52-60), .npy here."""
    nx, ny, nz = mesh.dims(DataLoc.VERT)
    return f"ibm_{nx}x{ny}x{nz}.npy"


def get_mask(mesh: Mesh, path: str | None = None) -> np.ndarray:
    """Load the IBM mask like the reference init (file if present),
    falling back to the example cylinder geometry."""
    path = path or default_mask_path(mesh)
    if os.path.exists(path):
        return load_mask(path, mesh)
    return cylinder_mask(mesh)
