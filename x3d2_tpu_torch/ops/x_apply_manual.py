"""The x apply with its own multi-stage copy pipeline: the wrapper of the
Hopper kernel in ``csrc/x_apply_manual.cu`` and its plain PyTorch version.

Counterpart of x3d2_tpu.ops.pallas_manual.make_x_apply_manual
(pallas_manual.py:62; its kernel :114, pl.pallas_call :200), the TPU's
gridless x apply driving its own S-slot HBM <-> VMEM pipeline:
``make_x_apply_manual(M64, sub, parity, slots)`` -> fn(f[, s]) = M @_x f,
or s - M @_x f, with M (n_out, n_in) and f (n_in, ny, nz); parity "fwd" or
"inv" runs the parity-split forms (x modes in block-parity order), as the
slab's x stage does. On the card a persistent kernel walks the (y, z)
column tiles and feeds the k-chunks of the operator and of f through an
S-stage shared-memory ring (cp.async); it computes what the template's x
applies (ops/operator_apply.py) compute. No path of the solver calls it,
in x3d2_tpu or here: tools/prof_manual.py times it beside them.

A function on CUDA tensors launches the kernel (or raises) and adds one to
its launch count; on CPU tensors it runs the plain version
(pressure_slab.x_apply_plain, and the parity applies pfwd and pinv that
x_apply_parity_plain takes).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .parity import parity_split_folded, pfwd, pinv
from .pressure_slab import x_apply_plain

DENSE, FWD, INV = 0, 1, 2
# launches of the kernel, by name (x_apply_manual, x_apply_manual[sub],
# x_apply_manual[fwd], x_apply_manual[inv], x_apply_manual[inv,sub])
_LAUNCHES: dict[str, int] = {}
_LIB = None


def launch_counts() -> dict[str, int]:
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    _LAUNCHES.clear()


def lib():
    """The kernel library, built and typed at first use."""
    global _LIB
    if _LIB is None:
        from .. import _build

        so = _build.load("x_apply_manual")
        i, p = ctypes.c_int, ctypes.c_void_p
        so.x_apply_manual_launch.argtypes = [i, p, p, p, p, i, i,
                                             ctypes.c_longlong, i, i, p]
        so.x_apply_manual_launch.restype = i
        so.x_apply_manual_error_string.argtypes = [i]
        so.x_apply_manual_error_string.restype = ctypes.c_char_p
        so.x_apply_manual_geometry.argtypes = [ctypes.POINTER(i)] * 4
        so.x_apply_manual_geometry.restype = i
        geo = [i() for _ in range(4)]
        so.x_apply_manual_geometry(*geo)
        so.geometry = tuple(g.value for g in geo)
        _LIB = so
    return _LIB


def stage_name(parity=None, sub=False):
    """The launch-count name: x_apply_manual with its form's tags."""
    tags = ([parity] if parity else []) + (["sub"] if sub else [])
    return "x_apply_manual" + (f"[{','.join(tags)}]" if tags else "")


def x_apply_manual_plain(M, f, s=None, parity=None):
    """M @_x f (parity "fwd": [Me; Mo] as pfwd, "inv" as pinv), or s minus
    it: the slab's plain x applies."""
    if parity is None:
        return x_apply_plain(M, f, s)
    r = pfwd(M, f, 0) if parity == "fwd" else pinv(M, f, 0)
    return r if s is None else s - r


def _check(t, shape, name):
    if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous() \
            or tuple(t.shape) != tuple(shape) or t.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel takes a contiguous, 16-byte "
                         f"aligned float32 CUDA tensor of shape "
                         f"{tuple(shape)}, got {t.dtype} {tuple(t.shape)} "
                         f"on {t.device}")


def x_apply_manual(M, f, s=None, parity=None, slots=4, Mt=None):
    """One launch on CUDA tensors (M float32: dense (n_out, n_in), or the
    parity stack [Me; Mo] (n_out, n_in / 2); the kernel reads it
    transposed, Mt, made here unless given); the plain version on CPU
    ones. slots: the pipeline's stages, S."""
    if not f.is_cuda:
        if f.device.type != "cpu":
            raise ValueError(f"no x_apply_manual for device {f.device}")
        return x_apply_manual_plain(M.to(f.dtype), f, s, parity)
    form = {None: DENSE, "fwd": FWD, "inv": INV}[parity]
    if form == FWD and s is not None:
        raise ValueError("the subtraction is an inverse-stage fusion")
    n_in, ny, nz = f.shape
    n_out, K = M.shape
    if K != (n_in if form == DENSE else n_in // 2) \
            or (form != DENSE and (n_in % 2 or n_out % 2)):
        raise ValueError(f"operator {tuple(M.shape)} does not fit the "
                         f"form {parity} on {tuple(f.shape)}")
    _, bn, _, max_s = lib().geometry
    if (ny * nz) % bn or not 2 <= slots <= max_s:
        raise ValueError(f"the kernel takes ny * nz a multiple of {bn} and "
                         f"2 to {max_s} stages, got {(ny, nz)}, {slots}")
    Mt = M.t().contiguous() if Mt is None else Mt
    _check(Mt, (K, n_out), "operator, transposed")
    _check(f, (n_in, ny, nz), "field")
    out = torch.empty((n_out, ny, nz), dtype=f.dtype, device=f.device)
    if s is not None:
        _check(s, (n_out, ny, nz), "s")
    grid = torch.cuda.get_device_properties(f.device).multi_processor_count
    stream = torch.cuda.current_stream(f.device).cuda_stream
    with torch.cuda.device(f.device):
        err = lib().x_apply_manual_launch(
            form, Mt.data_ptr(), f.data_ptr(),
            s.data_ptr() if s is not None else None, out.data_ptr(), n_out,
            K, ny * nz, slots, grid, stream)
    if err != 0:
        msg = lib().x_apply_manual_error_string(err).decode()
        raise RuntimeError(f"x_apply_manual launch failed: {msg} ({err})")
    name = stage_name(parity, s is not None)
    _LAUNCHES[name] = _LAUNCHES.get(name, 0) + 1
    return out


def make_x_apply_manual(M64, sub=False, parity=None, slots=4, device=None):
    """fn(f[, s]) = M @_x f [or s - M @_x f with sub], M64 the (n_out,
    n_in) float64 operator (parity: its parity split, built here, as
    x3d2_tpu's make_x_apply_manual builds it). fn.op(dtype): the operator
    (the parity stack [Me; Mo]) as the kernel (float32) or the plain
    version takes it."""
    from ..common import resolve_device

    M64 = np.asarray(M64, np.float64)
    n_out, n_in = M64.shape
    if parity is not None and (n_in % 2 or n_out % 2):
        raise ValueError("parity x-apply needs even extents")
    if parity == "fwd" and sub:
        raise ValueError("sub is an inverse-stage fusion")
    if parity is not None:
        M64 = np.concatenate(parity_split_folded(
            M64, 0 if parity == "fwd" else 1))
    device = resolve_device(device)
    mats = {}

    def op(dtype):
        if dtype not in mats:
            mats[dtype] = torch.as_tensor(M64, dtype=dtype,
                                          device=device).contiguous()
        return mats[dtype]

    def fn(f, s=None):
        if (s is not None) != sub:
            raise ValueError(f"built with sub={sub}")
        if not f.is_cuda:
            return x_apply_manual(op(f.dtype), f, s, parity, slots)
        if "t" not in mats:
            mats["t"] = op(torch.float32).t().contiguous()
        return x_apply_manual(op(torch.float32), f, s, parity, slots,
                              mats["t"])

    fn.op = op
    return fn
