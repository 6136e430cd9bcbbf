"""Passive-scalar (species) transport sweeps over banded operator blocks:
the wrapper of the species kernel of ``csrc/transeq_sweep.cuh`` and its
plain PyTorch version.

Counterpart of x3d2_tpu.ops.pallas_kernels ``_species_kernel_v3``
(pallas_kernels.py:1038), ``make_species_dir_v3`` (:1112) and
``make_fused_species_v3`` (:1209); reference transeq_species
(solver.f90:507-601). Along one sweep axis, for each scalar phi_s with its
diffusivity nu_s = nu / Pr_s and conv the velocity component aligned with
the axis (u for x, v for y, w for z):

    r_s = -1/2 (conv * D1 phi_s + D1s (phi_s * conv)) + nu_s * D2 phi_s
          [+ acc_s]

the aligned pairing of the momentum sweep (``SweepBlocks`` sa = [D1; D2],
da = D1s, at the same BS and W: W=32 in x3d2_tpu's HIGHEST mode, as its
species sweep, pallas_kernels.py:1131). One launch serves up to
MAX_SPECIES scalars, so the conv window is read once per tile for all of
them.

The halo form (x3d2_tpu's make_species_dir_v3(..., n_shards > 1),
pallas_kernels.py:1061-1070, the sharded species chain of
parallel/shard_kernels.py) reads the windows of conv and of every scalar
from their halo-extended operands (``exts``: conv's first, then the
scalars'), with the global operator blocks from ``off``, as the momentum
sweep's (ops/transeq_sweep.py).

``species_sweep`` launches the kernel for CUDA tensors (or raises) and
runs ``species_sweep_plain`` for CPU tensors only.
"""

from __future__ import annotations

import ctypes

import torch

from ..common import resolve_device
from . import transeq_sweep as ts
from .transeq_sweep import MAX_SPECIES, TL, W, SweepBlocks

# launches of the kernel per variant name, counted where it is launched
_LAUNCHES: dict[str, int] = {}


def variant_name(axis: int, accumulate: bool, w: int = W,
                 halo: bool = False) -> str:
    """The instance's name; ``halo``: the halo form of a sharded axis;
    ``w32``: the HIGHEST mode's band."""
    return "species_sweep[" + "xyz"[axis] + (",acc" if accumulate else "") \
        + (",halo" if halo else "") + (f",w{w}" if w != W else "") + "]"


def launch_counts() -> dict[str, int]:
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    _LAUNCHES.clear()


def species_sweep_plain(phis, conv, blocks: SweepBlocks, nus, acc=None,
                        exts=None, off=0):
    """The sweep's function in plain PyTorch, at the inputs' dtype: the
    windows of conv are gathered once, each scalar's in turn, then batched
    products with the aligned blocks. Returns one tensor per scalar. With
    `exts` (the halo form: the extended conv, then the scalars) the windows
    come from them and the global blocks from `off`."""
    shape = tuple(conv.shape)
    win, sel, _ = ts.window_source(blocks, shape, exts, off)
    sa, _, da, _ = (m[sel] for m in blocks.mats(conv.dtype))
    bs, w = blocks.bs, blocks.w
    cw = win(conv, 0)
    cmid = cw[:, w:w + bs]
    outs = []
    for s, (phi, nu_s) in enumerate(zip(phis, nus)):
        qw = win(phi, s + 1)
        both = torch.bmm(sa, qw)
        dqd = torch.bmm(da, qw * cw)
        r = -0.5 * (cmid * both[:, :bs] + dqd) + nu_s * both[:, bs:]
        r = ts._field(r, shape, blocks.axis)
        if acc is not None:
            r = r + acc[s]
        outs.append(r)
    return tuple(outs)


def _launch(phis, conv, blocks, nus, acc, out, exts=None, off=0):
    axis = blocks.axis
    bs, w = blocks.bs, blocks.w
    shape = tuple(conv.shape)
    nsp = len(phis)
    halo = exts is not None
    if halo and axis == 0:
        raise ValueError("the halo form serves the sharded axes, y and z")
    if len(shape) != 3 or not ts.sweep_shape_ok(shape, axis, bs, w, halo):
        raise ValueError(f"shape {shape} is not tileable by the sweep "
                         f"kernel along axis {axis}")
    if not 1 <= nsp <= MAX_SPECIES or len(nus) != nsp:
        raise ValueError(f"the species kernel takes 1 to {MAX_SPECIES} "
                         f"scalars with one diffusivity each, got {nsp}")
    ins = [conv] + list(phis) + (list(acc) if acc is not None else [])
    for i, t in enumerate(ins):
        ts._check(t, shape, f"input {i}")
    sa, _, da, _ = blocks.mats(torch.float32)
    if sa.device != conv.device:
        raise ValueError("operator blocks and fields are on different devices")
    nb = shape[axis] // bs
    if halo:
        if len(exts) != nsp + 1:
            raise ValueError("the halo form takes conv's and every scalar's "
                             "extended operand")
        ts.check_exts(exts, shape, axis, w, nb, blocks.nb, off)
        for t in exts:
            ts._check(t, tuple(t.shape), "halo-extended operand")
        sa, da = sa[off:off + nb], da[off:off + nb]
    elif blocks.nb != nb:
        raise ValueError(f"{blocks.nb} operator blocks for {nb} of the field")
    if out is None:
        out = [torch.empty_like(conv) for _ in range(nsp)]
    elif len(out) != nsp:
        raise ValueError(f"out must hold {nsp} tensors")
    windows = {t.data_ptr() for t in [conv] + list(phis)}
    for t in out:
        ts._check(t, shape, "out")
        if t.data_ptr() in windows:
            raise ValueError("out may not alias conv or a scalar: the kernel "
                             "reads their windows around every point")
    pad = [None] * (MAX_SPECIES - nsp)
    src = list(exts) if halo else [conv] + list(phis)
    ptrs = [src[0].data_ptr(), sa.data_ptr(), da.data_ptr()]
    ptrs += [t.data_ptr() for t in src[1:]] + pad
    ptrs += ([t.data_ptr() for t in acc] if acc is not None
             else [None] * nsp) + pad
    ptrs += [t.data_ptr() for t in out] + pad
    parr = (ctypes.c_void_p * len(ptrs))(*ptrs)
    narr = (ctypes.c_float * nsp)(*(float(x) for x in nus))
    lines = shape[0] * shape[1] * shape[2] // shape[axis]
    sms = torch.cuda.get_device_properties(conv.device).multi_processor_count
    grid_x = max(1, min(lines // TL, sms // nb))
    stream = torch.cuda.current_stream(conv.device).cuda_stream
    with torch.cuda.device(conv.device):
        err = ts._lib(w).species_sweep_launch(
            axis, int(acc is not None), int(halo), nsp, parr, *shape, narr,
            grid_x, stream)
    if err != 0:
        raise RuntimeError(f"species_sweep launch failed: "
                           f"{ts.launch_error(err, w)} ({err})")
    name = variant_name(axis, acc is not None, w, halo)
    _LAUNCHES[name] = _LAUNCHES.get(name, 0) + 1
    return tuple(out)


def species_sweep(phis, conv, blocks: SweepBlocks, nus, acc=None, out=None,
                  exts=None, off=0):
    """One direction sweep of the scalars `phis` (a sequence of fields,
    diffusivities `nus`) carried by `conv` -> one rhs per scalar. `out`
    names the tensors to write (in place); an output may alias its `acc`
    (each point reads it before it writes), never conv or a scalar.
    `exts`, `off`: the halo form (the extended conv and scalars; `blocks`
    the global stack, from block `off`).

    CUDA tensors launch the kernel (or raise); CPU tensors run the plain
    version."""
    if conv.is_cuda:
        return _launch(phis, conv, blocks, nus, acc, out, exts, off)
    if conv.device.type != "cpu":
        raise ValueError(f"no species sweep for device {conv.device}")
    if exts is not None:
        ts.check_exts(exts, tuple(conv.shape), blocks.axis, blocks.w,
                      conv.shape[blocks.axis] // blocks.bs, blocks.nb, off)
    res = species_sweep_plain(phis, conv, blocks, nus, acc=acc, exts=exts,
                              off=off)
    if out is None:
        return res
    for o, r in zip(out, res):
        o.copy_(r)
    return tuple(out)


def make_species_sweep(ops_axis, nus, axis, shape, accumulate=False,
                       device=None, terms=2, n_shards=1):
    """One direction sweep as a function, the counterpart of
    make_species_dir_v3: fn(phis, conv[, acc][, out][, exts, off]) -> as
    species_sweep. Raises ValueError where x3d2_tpu does (no scalars, more
    than 8 per launch) and where the kernel does not tile the shape. terms:
    x3d2_tpu's kernel mode (3: the W=32 band). n_shards > 1: the halo form
    over a shard of `shape` (x3d2_tpu's n_shards)."""
    nus = tuple(float(x) for x in nus)
    halo = n_shards > 1
    if not nus:
        raise ValueError("no species")
    if len(nus) > MAX_SPECIES:
        raise ValueError(f"species kernel capped at {MAX_SPECIES} per call")
    if halo and ops_axis.der1st.n_in != shape[axis] * n_shards:
        raise ValueError("local extent * n_shards must match the global "
                         "operator size")
    if not ts.sweep_shape_ok(tuple(shape), axis, *ts.geometry(terms), halo):
        raise ValueError(f"shape {shape} not tileable along axis {axis}")
    blocks = ts.build_sweep_blocks(ops_axis, axis, device=device,
                                   terms=terms)

    def fn(phis, conv, acc=None, out=None, exts=None, off=None):
        if (accumulate != (acc is not None) or len(phis) != len(nus)
                or halo != (exts is not None) or halo != (off is not None)):
            raise ValueError("arguments do not match the sweep variant")
        return species_sweep(phis, conv, blocks, nus, acc=acc, out=out,
                             exts=exts, off=int(off or 0))

    fn.blocks = blocks
    return fn


def make_fused_species(solver_ops, nus, shape, device=None, terms=2):
    """All scalars' transport RHS in one chain of three sweeps (x3d2_tpu
    make_fused_species_v3, pallas_kernels.py:1209-1226): z sweep ->
    accumulating x sweep -> accumulating y sweep.

        fn(phis, u, v, w, out=None) -> one rhs per scalar

    `out` (one tensor per scalar, e.g. the unbound rows of a stacked
    tensor) receives the z sweep's partials; the x and y sweeps add into
    them in place. terms: x3d2_tpu's kernel mode."""
    device = resolve_device(device)
    kw = dict(device=device, terms=terms)
    d2 = make_species_sweep(solver_ops[2], nus, 2, shape, **kw)
    d0 = make_species_sweep(solver_ops[0], nus, 0, shape, accumulate=True,
                            **kw)
    d1 = make_species_sweep(solver_ops[1], nus, 1, shape, accumulate=True,
                            **kw)

    def fn(phis, u, v, w_, out=None):
        phis = tuple(phis)
        acc = d2(phis, w_, out=out)
        acc = d0(phis, u, acc=acc, out=acc)
        return d1(phis, v, acc=acc, out=acc)

    fn.sweeps = (d2, d0, d1)
    return fn
