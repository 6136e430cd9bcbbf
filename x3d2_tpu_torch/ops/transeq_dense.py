"""The dense transport sweep (x3d2_tpu's v1 kernel): the wrapper of the
Hopper kernel ``csrc/transeq_dense.cu`` and its plain PyTorch version.

Counterpart of x3d2_tpu.ops.pallas_transeq: ``_kernel`` (pallas_transeq.py:
42), ``make_fused_transeq`` (:124) and ``fused_transeq_supported`` (:183).
For one sweep axis and each component q of (u, v, w), with conv the
component aligned with the axis:

    rhs_q = -1/2 (conv * D1 q + D1d (q * conv)) + nu * D2 q

on the dense (n, n) operator matrices, (D1, D1d, D2) = (der1st,
der1st_sym, der2nd) for the aligned component and (der1st_sym, der1st,
der2nd_sym) for the transverse ones (omp/backend.f90:235-262). x3d2_tpu
takes it on the uniform grids its banded sweeps cannot tile and whose
sweep extents are at most 256 (``transeq_dense_supported``; TGV 128^3
among them: a 128-point z axis is below the banded z sweep's 256), one
call per direction, and sums the three directions outside the kernel
(x3d2_tpu solver.py:201-205): ``make_transeq_dense``.

The kernel takes the operators as D1 and A2 = [-1/2 D1d | nu D2], both
float32 rounded from float64; the plain version applies D1, D1d and D2 as
the formula reads. ``transeq_dense`` launches the kernel for CUDA tensors
(or raises) and runs ``transeq_dense_plain`` for CPU tensors only.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field

import numpy as np
import torch

from ..common import resolve_device
from .compact import apply_matrix

MAX_N = 256   # longest sweep x3d2_tpu's v1 kernel takes
# x3d2_tpu's per-axis in-tile extents of the two non-sweep axes
# (pallas_transeq.py:105-109): the gate's tiling rules
TILES = {0: (8, 128), 1: (4, 128), 2: (4, 128)}
GR, BN = 64, 128   # the kernel's block: sweep points x lines

# launches of the kernel per direction name, counted where it is launched
_LAUNCHES: dict[str, int] = {}


def launch_counts() -> dict[str, int]:
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    _LAUNCHES.clear()


def variant_name(axis: int) -> str:
    return f"transeq_dense[{'xyz'[axis]}]"


def pick_bs(axis: int, n: int):
    """x3d2_tpu's output row block (pallas_transeq.py:112-121): the gate
    needs one (axis 2: 128, or the full extent up to 256; axes 0, 1: the
    largest of 64, 32, 16, 8 that divides n)."""
    if axis == 2:
        return 128 if n % 128 == 0 else (n if n <= MAX_N else None)
    for bs in (64, 32, 16, 8):
        if n % bs == 0:
            return bs
    return None


def transeq_dense_supported(solver, shape) -> bool:
    """Counterpart of x3d2_tpu fused_transeq_supported (pallas_transeq.py:
    183-204), with the same conditions: extents at most 256, a uniform mesh
    (no stretch correction), square operators, and per axis an output row
    block and the in-tile extents of the other two axes. The kernel here
    tiles every grid this admits."""
    shape = tuple(shape)
    if max(shape) > MAX_N:
        return False
    for axis in range(3):
        o = solver.ops[axis]
        corr = o.der2nd.stretch_correct
        if corr is not None and np.any(corr):
            return False
        other = [a for a in range(3) if a != axis]
        t0, t1 = TILES[axis]
        bs = pick_bs(axis, shape[axis])
        if (bs is None or shape[other[0]] % t0 or shape[other[1]] % t1
                or shape[axis] % bs):
            return False
        if o.der1st.n_out != shape[axis] or o.der1st.n_in != shape[axis]:
            return False
    return True


@dataclass
class DenseMats:
    """One axis's operators, float64 numpy masters plus device copies per
    dtype. Plain version: d1a, d1sa, d2a (der1st, der1st_sym, der2nd: the
    aligned component) and d1t, d1st, d2t (der1st_sym, der1st, der2nd_sym:
    the transverse ones). Kernel: d1a, d1t and a2a = [-1/2 der1st_sym | nu
    der2nd], a2t = [-1/2 der1st | nu der2nd_sym]."""

    axis: int
    nu: float
    m64: dict
    device: torch.device
    _dev: dict = field(default_factory=dict)

    @property
    def n(self) -> int:
        return self.m64["d1a"].shape[0]

    def mats(self, dtype) -> dict:
        if dtype not in self._dev:
            self._dev[dtype] = {
                k: torch.as_tensor(M, dtype=dtype, device=self.device)
                .contiguous() for k, M in self.m64.items()}
        return self._dev[dtype]


def build_dense_mats(ops_axis, nu, axis, device=None) -> DenseMats:
    o = ops_axis
    m = {"d1a": o.der1st.M64, "d1sa": o.der1st_sym.M64, "d2a": o.der2nd.M64,
         "d1t": o.der1st_sym.M64, "d1st": o.der1st.M64,
         "d2t": o.der2nd_sym.M64}
    m = {k: np.asarray(v, np.float64) for k, v in m.items()}
    m["a2a"] = np.concatenate([-0.5 * m["d1sa"], nu * m["d2a"]], axis=1)
    m["a2t"] = np.concatenate([-0.5 * m["d1st"], nu * m["d2t"]], axis=1)
    return DenseMats(axis=axis, nu=float(nu), m64=m,
                     device=resolve_device(device))


def transeq_dense_plain(u, v, w, mats: DenseMats):
    """(du, dv, dw): one direction's RHS of the three components."""
    m = mats.mats(u.dtype)
    axis, nu = mats.axis, mats.nu
    comps = (u, v, w)
    conv = comps[axis]
    outs = []
    for c, q in enumerate(comps):
        d1, d1d, d2 = (("d1a", "d1sa", "d2a") if c == axis
                       else ("d1t", "d1st", "d2t"))
        dq = apply_matrix(m[d1], q, axis)
        dqd = apply_matrix(m[d1d], q * conv, axis)
        d2q = apply_matrix(m[d2], q, axis)
        outs.append(-0.5 * (conv * dq + dqd) + nu * d2q)
    return tuple(outs)


_LIB = None


def _lib():
    """The kernel library, built and typed at first use."""
    global _LIB
    if _LIB is None:
        from .. import _build

        lib = _build.load("transeq_dense")
        i, ll, p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
        lib.transeq_dense_launch.argtypes = [i, i, p, p, i, i, ll, ll, ll, p]
        lib.transeq_dense_launch.restype = i
        lib.transeq_dense_error_string.argtypes = [i]
        lib.transeq_dense_error_string.restype = ctypes.c_char_p
        lib.transeq_dense_geometry.argtypes = [ctypes.POINTER(i)] * 3
        lib.transeq_dense_geometry.restype = i
        geo = [i() for _ in range(3)]
        lib.transeq_dense_geometry(*geo)
        if tuple(g.value for g in geo) != (GR, BN, 8):
            raise RuntimeError("transeq_dense.cu geometry "
                               f"{tuple(g.value for g in geo)} differs from "
                               f"the wrapper's {(GR, BN, 8)}")
        _LIB = lib
    return _LIB


def _check(t, shape, name):
    if not t.is_cuda or t.dtype != torch.float32:
        raise ValueError(f"{name}: the kernel takes float32 CUDA tensors, "
                         f"got {t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous tensor of shape "
                         f"{tuple(shape)}, got {tuple(t.shape)}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data must be 16-byte aligned")


def _transeq_dense_cuda(u, v, w, mats: DenseMats):
    shape = tuple(u.shape)
    nx, ny, nz = shape
    axis, n = mats.axis, shape[mats.axis]
    trans, batch, ld, pstride, ncols = {
        0: (0, 1, ny * nz, 0, ny * nz),
        1: (0, nx, nz, ny * nz, nz),
        2: (1, 1, nz, 0, nx * ny)}[axis]
    if ncols % BN or (trans and n % GR) or n != mats.n:
        raise ValueError(f"shape {shape} is not tiled by the dense sweep "
                         f"kernel along axis {axis}")
    m = mats.mats(torch.float32)
    for t in (u, v, w):
        _check(t, shape, "field")
    for k in ("d1a", "d1t"):
        _check(m[k], (n, n), "operator")
    for k in ("a2a", "a2t"):
        _check(m[k], (n, 2 * n), "operator")
    outs = tuple(torch.empty_like(u) for _ in range(3))
    ptrs = []
    for c, (q, out) in enumerate(zip((u, v, w), outs)):
        tag = "a" if c == axis else "t"
        ptrs += [q.data_ptr(), out.data_ptr(), m["d1" + tag].data_ptr(),
                 m["a2" + tag].data_ptr()]
    parr = (ctypes.c_void_p * len(ptrs))(*ptrs)
    conv = (u, v, w)[axis]
    stream = torch.cuda.current_stream(u.device).cuda_stream
    with torch.cuda.device(u.device):
        err = _lib().transeq_dense_launch(trans, 3, parr, conv.data_ptr(),
                                          batch, n, ld, pstride, ncols,
                                          stream)
    if err != 0:
        msg = _lib().transeq_dense_error_string(err).decode()
        raise RuntimeError(f"transeq_dense launch failed: {msg} ({err})")
    name = variant_name(axis)
    _LAUNCHES[name] = _LAUNCHES.get(name, 0) + 1
    return outs


def transeq_dense(u, v, w, mats: DenseMats):
    """One direction's (du, dv, dw): the kernel on CUDA tensors, the plain
    version on CPU tensors."""
    if u.is_cuda:
        return _transeq_dense_cuda(u, v, w, mats)
    if u.device.type != "cpu":
        raise ValueError(f"no dense transport sweep for device {u.device}")
    return transeq_dense_plain(u, v, w, mats)


def make_transeq_dense(solver_ops, nu, shape, device=None):
    """fn(u, v, w) -> (rhs_u, rhs_v, rhs_w): the three directions' dense
    sweeps summed (x3d2_tpu solver.py:201-205); fn.mats holds each axis's
    operators."""
    mats = tuple(build_dense_mats(solver_ops[a], nu, a, device=device)
                 for a in range(3))
    for a in range(3):
        if mats[a].n != tuple(shape)[a]:
            raise ValueError(f"axis {a}: operators of {mats[a].n} points "
                             f"for an extent of {tuple(shape)[a]}")

    def fn(u, v, w):
        outs = [transeq_dense(u, v, w, mats[a]) for a in range(3)]
        return tuple(outs[0][i] + outs[1][i] + outs[2][i] for i in range(3))

    fn.mats = mats
    return fn
