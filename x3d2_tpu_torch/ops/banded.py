"""Band-truncated per-output-block operator slices (numpy).

Counterpart of x3d2_tpu.ops.pallas_transeq.banded_blocks: the blocks the
transport sweep kernels consume (transeq_sweep.py).
"""

from __future__ import annotations

import numpy as np


def banded_blocks(op, w, bs, tol=1e-7):
    """Per-output-block banded weight slices W[b] = M[rows_b, rows_b-w :
    rows_b+bs+w] with periodic wrap / zero padding, shape (nb, bs, bs+2w)
    float64; raises if truncation exceeds `tol` relative to the max entry."""
    M = op.M64
    n = M.shape[0]
    if M.shape[1] != n or n % bs:
        raise ValueError(f"banded blocks need square ops with n % {bs} == 0")
    nb = n // bs
    W = np.zeros((nb, bs, bs + 2 * w))
    dropped = 0.0
    for b in range(nb):
        rows = M[b * bs:(b + 1) * bs]
        cols = np.arange(b * bs - w, (b + 1) * bs + w)
        if op.periodic:
            W[b] = rows[:, cols % n]
            mask = np.ones(n, bool)
            mask[cols % n] = False
        else:
            valid = (cols >= 0) & (cols < n)
            W[b][:, valid] = rows[:, cols[valid]]
            mask = np.ones(n, bool)
            mask[cols[valid]] = False
        dropped = max(dropped, np.abs(rows[:, mask]).max(initial=0.0))
    scale = np.abs(M).max()
    if dropped > tol * scale:
        raise ValueError(f"band w={w} truncates at {dropped / scale:.1e}")
    return W
