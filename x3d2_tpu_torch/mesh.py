"""Cartesian monobloc mesh: dims, BCs, coordinates, stretching metrics.

Equivalent of the reference's mesh layer (src/mesh.f90, src/mesh_content.f90)
minus the MPI decomposition bookkeeping: the Mesh here is purely *global*
and immutable (copy of x3d2_tpu.mesh). Stretching metric formulas are the analytic
tangent-map of mesh_content.f90:142-253 (Incompact3d stretched-mesh
transform, Laizet & Lamballais JCP 2009).

All arrays here are host-side numpy float64; they feed operator construction
and initial conditions.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .common import BC, AXES, DataLoc, loc_digit

_BC_NAMES = {
    "periodic": BC.PERIODIC,
    "neumann": BC.NEUMANN,
    "dirichlet": BC.DIRICHLET,
}


@dataclass
class AxisGeometry:
    """Per-axis geometry: coordinates and stretching metric arrays."""

    n_vert: int
    n_cell: int
    L: float
    d: float
    stretching: str  # 'uniform' | 'centred' | 'top-bottom' | 'bottom'
    beta: float
    alpha: float = 0.0
    stretched: bool = False
    vert_coords: np.ndarray = None
    midp_coords: np.ndarray = None
    vert_ds: np.ndarray = None
    vert_ds2: np.ndarray = None
    vert_d2s: np.ndarray = None
    midp_ds: np.ndarray = None
    midp_ds2: np.ndarray = None
    midp_d2s: np.ndarray = None


def _axis_geometry(n_vert: int, n_cell: int, L: float, d: float,
                   stretching: str, beta: float) -> AxisGeometry:
    """Coordinates + metric terms; mirrors obtain_coordinates
    (mesh_content.f90:142-253)."""
    g = AxisGeometry(n_vert=n_vert, n_cell=n_cell, L=L, d=d,
                     stretching=stretching, beta=beta)
    iv = np.arange(n_vert, dtype=np.float64)
    im = np.arange(n_cell, dtype=np.float64)
    if stretching == "uniform":
        g.stretched = False
        g.vert_coords = iv * d
        g.midp_coords = (im + 0.5) * d
        g.vert_ds = np.ones(n_vert)
        g.vert_ds2 = np.ones(n_vert)
        g.vert_d2s = np.zeros(n_vert)
        g.midp_ds = np.ones(n_cell)
        g.midp_ds2 = np.ones(n_cell)
        g.midp_d2s = np.zeros(n_cell)
        return g

    g.stretched = True
    L_inf = L / 2.0
    if beta <= np.finfo(np.float64).eps:
        raise ValueError("invalid beta for stretched axis")
    alpha = abs((L_inf - np.sqrt((np.pi * beta) ** 2 + L_inf**2))
                / (2 * beta * L_inf))
    g.alpha = alpha
    r = np.sqrt((alpha * beta + 1) / (alpha * beta))
    const = np.sqrt(beta) / (2 * np.sqrt(alpha) * np.sqrt(alpha * beta + 1))
    s = d / L

    def eta(idx):
        if stretching == "centred":
            return idx * s
        if stretching == "top-bottom":
            return idx * s - 0.5
        if stretching == "bottom":
            return idx * s / 2 - 0.5
        raise ValueError(f"invalid stretching type {stretching!r}")

    def metrics(e):
        coord = (const * np.arctan2(r * np.sin(np.pi * e), np.cos(np.pi * e))
                 * (2 * alpha * beta - np.cos(2 * np.pi * e) + 1)
                 / (np.sin(np.pi * e) ** 2 + alpha * beta)) + np.pi * const
        ds = L * (alpha / np.pi + np.sin(np.pi * e) ** 2 / (np.pi * beta))
        d2s = 2 * np.cos(np.pi * e) * np.sin(np.pi * e) / beta
        return coord, ds, d2s

    g.vert_coords, g.vert_ds, g.vert_d2s = metrics(eta(iv))
    g.midp_coords, g.midp_ds, g.midp_d2s = metrics(eta(im + 0.5))
    g.vert_ds2 = g.vert_ds**2
    g.midp_ds2 = g.midp_ds**2

    if stretching == "centred":
        g.vert_coords -= L_inf
        g.midp_coords -= L_inf
    elif stretching == "bottom":
        g.vert_coords *= 2
        g.midp_coords *= 2
        g.vert_d2s /= 2
        g.midp_d2s /= 2
    return g


@dataclass
class Mesh:
    """Global Cartesian mesh (reference mesh_t, mesh.f90:37-158)."""

    global_vert_dims: tuple[int, int, int]
    L: tuple[float, float, float]
    BCs: tuple  # ((start, end) BC enum) per axis
    stretching: tuple[str, str, str] = ("uniform", "uniform", "uniform")
    beta: tuple[float, float, float] = (1.0, 1.0, 1.0)

    def __post_init__(self):
        self.periodic = tuple(
            self.BCs[a][0] == BC.PERIODIC and self.BCs[a][1] == BC.PERIODIC
            for a in AXES)
        for a in AXES:
            bcs = self.BCs[a]
            if (bcs[0] == BC.PERIODIC) != (bcs[1] == BC.PERIODIC):
                raise ValueError("periodic BC must be set on both sides")
        self.global_cell_dims = tuple(
            self.global_vert_dims[a] - (0 if self.periodic[a] else 1)
            for a in AXES)
        self.d = tuple(self.L[a] / self.global_cell_dims[a] for a in AXES)
        self.geo = [
            _axis_geometry(self.global_vert_dims[a], self.global_cell_dims[a],
                           self.L[a], self.d[a], self.stretching[a],
                           self.beta[a])
            for a in AXES
        ]

    @classmethod
    def from_config(cls, domain) -> "Mesh":
        """Build from a DomainConfig (config.py)."""
        bcs = tuple(
            (_BC_NAMES[domain.BC[a][0]], _BC_NAMES[domain.BC[a][1]])
            for a in AXES)
        return cls(
            global_vert_dims=tuple(domain.dims_global),
            L=tuple(domain.L_global),
            BCs=bcs,
            stretching=tuple(domain.stretching),
            beta=tuple(domain.beta),
        )

    def n(self, axis: int, loc_digit_val: int) -> int:
        """Points along `axis` at vertex (0) or midpoint (1) location."""
        return (self.global_cell_dims[axis] if loc_digit_val
                else self.global_vert_dims[axis])

    def dims(self, loc: int) -> tuple[int, int, int]:
        """Field shape for a given DataLoc (reference mesh.f90:215-249)."""
        return tuple(self.n(a, loc_digit(loc, a)) for a in AXES)

    def coords(self, loc: int, axis: int) -> np.ndarray:
        g = self.geo[axis]
        return g.midp_coords if loc_digit(loc, axis) else g.vert_coords

    def coord_grids(self, loc: int):
        """Broadcastable (X, Y, Z) coordinate arrays for a data location."""
        cs = [self.coords(loc, a) for a in AXES]
        return np.meshgrid(*cs, indexing="ij", sparse=True)

    @property
    def stretched(self) -> tuple[bool, bool, bool]:
        return tuple(g.stretched for g in self.geo)
