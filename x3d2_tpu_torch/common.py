"""Common constants and enums (copy of x3d2_tpu.common).

Re-design of the reference's ``src/common.f90`` (x3d2). Fields are always
stored in Cartesian ``(nx, ny, nz)`` layout, z contiguous, and
per-direction operators take an ``axis`` argument instead of the
reference's direction/reorder enums.

Reference: x3d2 src/common.f90:27-44 (enums), :84-88 (move_data_loc).
"""

from __future__ import annotations

import contextlib
import enum
import os


class BC(enum.IntEnum):
    """Boundary condition types (reference common.f90:38-39)."""

    PERIODIC = 0
    NEUMANN = 1
    DIRICHLET = 2
    HALO = -1  # interior subdomain boundary (sharded axis)


class DataLoc(enum.IntEnum):
    """Staggered-grid data locations (reference common.f90:29-37).

    Encoded as a 3-digit mask: digit d (1-based from the right) is 1 when the
    data is at midpoints along axis d-1, 0 when at vertices.
    """

    VERT = 0  # vertex-centred
    CELL = 111  # cell-centred (midpoint in all three axes)
    X_FACE = 110  # faces normal to X: vertex in x, midpoint in y,z
    Y_FACE = 101  # vertex in y, midpoint in x,z
    Z_FACE = 11  # vertex in z, midpoint in x,y
    X_EDGE = 1  # edges along X: midpoint in x, vertex in y,z
    Y_EDGE = 10
    Z_EDGE = 100
    NULL = -1


AXIS_X, AXIS_Y, AXIS_Z = 0, 1, 2
AXES = (AXIS_X, AXIS_Y, AXIS_Z)


def loc_digit(loc: int, axis: int) -> int:
    """1 if `loc` is midpoint-staggered along `axis`, else 0."""
    if loc < 0:
        raise ValueError("data location unspecified")
    return (loc // 10**axis) % 10


def move_data_loc(loc: int, axis: int, move: int) -> int:
    """Shift a data location vertex<->midpoint along one axis.

    Mirrors reference common.f90:84-88 (with axis 0-based and the digit
    encoding above). ``move`` is +1 for v2p (vertex to midpoint), -1 for p2v.
    """
    d = loc_digit(loc, axis)
    nd = d + move
    if nd not in (0, 1):
        raise ValueError(f"invalid data_loc move: loc={loc} axis={axis} move={move}")
    return loc + move * 10**axis


def resolve_device(device=None):
    """The port's device rule: entry points run on ``cuda`` unless the
    caller names another device (the CPU tests pass ``device="cpu"``).
    With no device given and no GPU present this raises; it never falls
    back to the CPU."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "x3d2_tpu_torch runs on cuda by default and no GPU is "
                "available; pass device='cpu' explicitly to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


@contextlib.contextmanager
def env_set(env):
    """The environment variables in `env` set while the block runs, and
    restored (or removed) after it. The port's switches (X3D2_*) are read
    when a case or a kernel set is built, so set them around the build."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, val in saved.items():
            if val is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = val
