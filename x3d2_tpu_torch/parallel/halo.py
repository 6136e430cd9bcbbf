"""Halo-exchange application of compact operators over a sharded axis.

Counterpart of x3d2_tpu.parallel.halo (the analogue of the reference's
DistD2, src/backend/omp/exec_dist.f90, with its neighbour exchange,
omp/sendrecv.f90:10-36): the resolved operator M = A^-1 B decays
exponentially off the diagonal, so each rank needs only w planes of each
neighbour:

    halo = the previous rank's last w planes and the next rank's first w
           (exchange_halo, cyclic along the mesh axis)
    out  = M_rows[rank] @ concat(left halo, local, right halo)

with the rank's row block of the global float64 operator sliced at set-up,
so the result equals the unsharded apply up to the truncation (below
1e-7 of the largest entry at x3d2_tpu's w). x3d2_tpu runs these applies
as XLA einsums; here they are plain PyTorch on either device.

``exchange_halo`` is the one neighbour exchange of the package (x3d2_tpu's
ppermute): the halo applies here and the sharded sweeps of
parallel/shard_kernels.py use it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ..ops.compact import apply_matrix

OP_NAMES = ("der1st", "der1st_sym", "der2nd", "der2nd_sym", "stagder_v2p",
            "interpl_v2p", "stagder_p2v", "interpl_p2v")


def exchange_halo(fields, axis, pmesh, name, w):
    """The halo-extended operands of `fields` along `axis` (sharded over
    mesh axis `name`): each field between the previous rank's last w
    planes and the next rank's first w planes, n + 2w along the axis
    (x3d2_tpu _exchange_halo, shard_kernels.py:91-104). Every transfer of
    the call is posted in one batch with its own tag, in one order on
    every rank (on a 2-rank axis both neighbours are one rank, and the
    order keeps the two halos apart where tags are not honoured)."""
    with pmesh.clock("halo"):
        return _exchange(fields, axis, pmesh, name, w)


def _exchange(fields, axis, pmesh, name, w):
    prev, nxt = pmesh.neighbours(name)
    group = pmesh.groups[name]
    ops, recvs = [], []
    for i, q in enumerate(fields):
        n = q.shape[axis]
        if n < w:
            raise ValueError(f"a shard of {n} planes cannot give {w}")
        lo = pmesh.to_wire(q.narrow(axis, 0, w))
        hi = pmesh.to_wire(q.narrow(axis, n - w, w))
        left, right = torch.empty_like(hi), torch.empty_like(lo)
        ops += [dist.P2POp(dist.isend, hi, nxt, group, tag=2 * i),
                dist.P2POp(dist.isend, lo, prev, group, tag=2 * i + 1),
                dist.P2POp(dist.irecv, left, prev, group, tag=2 * i),
                dist.P2POp(dist.irecv, right, nxt, group, tag=2 * i + 1)]
        recvs.append((left, right))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return tuple(torch.cat([pmesh.from_wire(left), q, pmesh.from_wire(right)],
                           axis) for q, (left, right) in zip(fields, recvs))


def shard_operator_blocks(op, n_shards, w=32):
    """The global operator's row blocks per shard with their halo columns:
    (n_shards, rows, local + 2w) float64 with periodic wrap (each global
    column kept at its first window position only, where a wide window
    wraps past the whole axis) or zero padding at the ends, as x3d2_tpu's
    (halo.py:42-95); and the largest dropped entry relative to the
    largest. Raises ValueError when w truncates more than 1e-7 of it."""
    M = op.M64
    n_out, n_in = M.shape
    if n_out % n_shards or n_in % n_shards:
        raise ValueError("operator dims must divide the shard count")
    ro, ci = n_out // n_shards, n_in // n_shards
    blocks = np.zeros((n_shards, ro, ci + 2 * w))
    dropped = 0.0
    for s in range(n_shards):
        rows = M[s * ro:(s + 1) * ro]
        cols = np.arange(s * ci - w, (s + 1) * ci + w)
        mask = np.ones(n_in, bool)
        if op.periodic:
            gcols = cols % n_in
            blk = rows[:, gcols].copy()
            seen = set()
            for j, g in enumerate(gcols):
                if g in seen:
                    blk[:, j] = 0.0
                else:
                    seen.add(g)
            blocks[s] = blk
            mask[gcols] = False
        else:
            valid = (cols >= 0) & (cols < n_in)
            blocks[s][:, valid] = rows[:, cols[valid]]
            mask[cols[valid]] = False
        dropped = max(dropped, np.abs(rows[:, mask]).max(initial=0.0))
    scale = np.abs(M).max()
    if dropped > 1e-7 * scale:
        raise ValueError(
            f"halo width {w} too small: truncated operator entries at "
            f"{dropped / scale:.2e} of max (increase w)")
    return blocks, dropped / scale


def halo_width(dtype) -> int:
    """x3d2_tpu's band half-width (halo.py:150-156): 48 planes for
    float64, 32 otherwise."""
    return 48 if dtype == torch.float64 else 32


class HaloCompactOp:
    """A CompactOp along one sharded axis, applied through exchange_halo
    and this rank's row block (x3d2_tpu HaloCompactOp); other attributes
    are the wrapped operator's."""

    def __init__(self, op, pmesh, name, axis, w):
        self._op = op
        self.spatial_axis = axis
        self._pmesh, self._name, self._w = pmesh, name, w
        blocks, self.truncation = shard_operator_blocks(
            op, pmesh.shape[name], w)
        self._blk = torch.as_tensor(blocks[pmesh.axis_index(name)],
                                    dtype=op.M.dtype, device=op.M.device)

    def __getattr__(self, name):
        return getattr(self._op, name)

    def __call__(self, f, axis):
        if axis != self.spatial_axis:
            raise ValueError(f"halo op built for axis {self.spatial_axis}, "
                             f"got {axis}")
        ext = exchange_halo((f,), axis, self._pmesh, self._name, self._w)[0]
        return apply_matrix(self._blk.to(f.dtype), ext, axis)


class GspmdOp:
    """An operator along a sharded axis that x3d2_tpu leaves to GSPMD (no
    halo wrap: shards narrower than the band, a failed truncation check,
    a non-square operator). Applied to whole lines it is the operator;
    applied to a shard it raises NotImplementedError."""

    def __init__(self, op):
        self._op = op

    def __getattr__(self, name):
        return getattr(self._op, name)

    def __call__(self, f, axis):
        if f.shape[axis] != self._op.n_in:
            from .topo import GSPMD_GAP
            raise NotImplementedError(GSPMD_GAP.format(
                what=f"the compact operator along axis {axis} (shards of "
                     f"{f.shape[axis]} of {self._op.n_in} points)"))
        return self._op(f, axis)


def make_halo_axis_ops(axis_ops, pmesh, name, axis, w):
    """The AxisOps bundle with every square operator as a halo apply; the
    non-square ones (a staggered wall-bounded axis) are GSPMD's in
    x3d2_tpu (GspmdOp). Raises ValueError where the band check fails."""
    ops = {k: getattr(axis_ops, k) for k in OP_NAMES}
    return dataclasses.replace(axis_ops, **{
        k: HaloCompactOp(op, pmesh, name, axis, w) if op.n_out == op.n_in
        else GspmdOp(op) for k, op in ops.items()})
