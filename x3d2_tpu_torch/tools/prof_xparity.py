"""The one-field parity x applies (x_pfwd, x_pinv, x_pinv[sub]) on the
card: the split-TF32 x-apply kernel that serves them beside the
operator-apply template's launch of the same function (their kernel
before it) and one torch call, each timed three ways, with the host's
work a launch apart from the device's.

    python3 -m x3d2_tpu_torch.tools.prof_xparity [--dims NX NY NZ ...]
        [--ref DIR] [--iters N]

For each grid (default 512^3, 128x128x256, 128^3, 512x256x256,
128x512x512: the sizes the paths give the applies) it builds the slab's x
operators of a periodic x of NX points (on an NX x 128 x 128 grid: the x
stage's operators depend on NX alone) and random float32 fields, and for
each stage times, by CUDA events and the host clock:
- "single": one call between two events, the host's work inside (the
  median of 10; chip_smoke.py's cuda_ms);
- "device": `iters` calls back to back between two events, per call,
  enqueued while the device sleeps (no host gap between them);
- "host_us": the host clock over `iters` calls enqueued after a
  synchronize, per call (the launches' host work: the checks, the
  geometry, the ctypes call).
It holds the kernel against the plain float64 version (within 4e-7 of
max |plain f64|: the split-TF32 limit) and two launches and S = 2, 3, 4,
6 bit-equal, each S timed back to back. With --ref DIR (a checkout, e.g.
`git archive HEAD x3d2_tpu_torch/csrc | tar -x -C DIR`), DIR's
x_apply_manual.cu is built too and its launches of the same parity
forms, and of the dense form on four dense operators (512 and 128
square, 513 -> 512, 512 -> 513), are held bit for bit against this
checkout's and timed in turns (ref, this, this, ref), with the host's
µs a call of its launch from Python through ctypes ("ref_host_us": DIR
this checkout's csrc gives the C entry's part of "host_us"); it is launched
through its x_apply_tc_launch_jobs where it declares this checkout's, or
that entry without the solve's tables (the builds before the solve; given
no tables here), else through the one-job x_apply_tc_launch of the
builds before the jobs entry (ONE_JOB's arguments, or those and two
launch choices before the stream, given as 0: the operator streamed,
128-column items), and any other declaration is refused. Prints one JSON
line (the card's name and power limit beside the numbers) and exits 1
where a check fails, 2 without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import subprocess
import sys
import time

import numpy as np
import torch

from x3d2_tpu_torch.common import BC
from x3d2_tpu_torch.mesh import Mesh
from x3d2_tpu_torch.ops import pressure_slab as sl
from x3d2_tpu_torch.ops import x_apply_manual as xm
from x3d2_tpu_torch.solver import NavierStokes
from x3d2_tpu_torch.tools.prof_manual import template

SIZES = ((512, 512, 512), (128, 128, 256), (128, 128, 128),
         (512, 256, 256), (128, 512, 512))
STAGES = (("x_pfwd", "sx", False), ("x_pinv", "gxs", False),
          ("x_pinv[sub]", "gxs", True))
TC_LIM = 4e-7
PER = ((BC.PERIODIC, BC.PERIODIC),) * 3


def single_ms(fn, reps=10):
    """The median of `reps` single calls between two events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def device_ms(fn, iters):
    """ms a call over `iters` calls back to back between two events, the
    device held by a sleep while the host enqueues them (so that the
    host's work a launch leaves no gap between them)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        fn()
    host = (time.perf_counter() - t0) / 3
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    # 2e9 cycles a second: the sleep outlasts four times the enqueueing
    torch.cuda._sleep(int(4 * iters * host * 2e9) + 1000000)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def host_us(fn, iters):
    """µs of host time a call, `iters` calls enqueued after a
    synchronize (fewer than the launch queue holds)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / iters * 1e6


def timings(fn, iters):
    return {"single": single_ms(fn), "device": device_ms(fn, iters),
            "host_us": host_us(fn, iters)}


def rel(got, ref):
    return float((got.double() - ref).abs().max() / ref.abs().max())


def x_mats(nx, dev):
    """The slab's operator set of a periodic x of nx points (the x stage's
    operators; y and z cut to 128, the slab's least)."""
    ns = NavierStokes.build(Mesh((nx, 128, 128), (2 * math.pi,) * 3, PER),
                            1 / 1600, device=dev)
    pm = ns._slab
    if pm is None or pm.x_perm is None:
        raise RuntimeError(f"nx = {nx}: no parity x stage")
    return pm


def launch_args(src, name):
    """The argument names of the C function `name` in the source `src`."""
    decl = re.search(rb"int " + name.encode() + rb"\(([^)]*)\)",
                     src.read_bytes())
    return [a.split()[-1].lstrip(b"*") for a in decl.group(1).split(b",")] \
        if decl else []


# the one-job launch of the builds before the jobs entry (the earliest of
# them took the launch choices res and narrow before the stream, given as
# 0)
ONE_JOB = [b"form", b"op", b"f", b"s", b"out", b"rows", b"K", b"ncols",
           b"slots", b"grid", b"stream"]


def ref_lib(ref):
    """(DIR's x_apply_manual library, how to launch it): its
    x_apply_tc_launch_jobs where the source declares it as this checkout
    does ("jobs") or without the solve's tables ("jobs0"), else its
    one-job x_apply_tc_launch (ONE_JOB, or with res and narrow before the
    stream: the extra arguments, 0)."""
    from pathlib import Path

    from x3d2_tpu_torch.tools.template_bits import build

    src = Path(ref) / "x3d2_tpu_torch" / "csrc" / "x_apply_manual.cu"
    jobs = launch_args(src, "x_apply_tc_launch_jobs")
    names = launch_args(src, "x_apply_tc_launch")
    own = launch_args(Path(__file__).resolve().parents[1] / "csrc"
                      / "x_apply_manual.cu", "x_apply_tc_launch_jobs")
    if jobs and jobs == own:
        how = "jobs"
    elif jobs and jobs == [a for a in own if a != b"tabs"]:
        how = "jobs0"
    elif names == ONE_JOB:
        how = ()
    elif names == ONE_JOB[:-1] + [b"res", b"narrow", b"stream"]:
        how = (0, 0)
    else:
        raise RuntimeError(f"{src}: declares x_apply_tc_launch_jobs{jobs} "
                           f"and x_apply_tc_launch{names}, not this "
                           f"checkout's x_apply_tc_launch_jobs{own} nor "
                           f"x_apply_tc_launch{ONE_JOB} (with or without "
                           f"res, narrow)")
    lib, _ = build(src, "ref_x_apply_manual")
    i, p, ll = ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong
    if how in ("jobs", "jobs0"):
        lib.x_apply_tc_launch_jobs.argtypes = [i, i, i, p] + (
            [p] if how == "jobs" else []) + [i, i, ll, i, i, i, p]
        lib.x_apply_tc_launch_jobs.restype = i
    else:
        lib.x_apply_tc_launch.argtypes = [i, p, p, p, p, i, i, ll, i,
                                          i] + [i] * len(how) + [p]
        lib.x_apply_tc_launch.restype = i
    return lib, how


def ref_launch(ref, op, f, s, sms):
    """out = the reference library's launch (S = 4) of packed op on f."""
    lib, how = ref
    out = torch.empty((op.n_out,) + tuple(f.shape[1:]), device=f.device)
    sp = s.data_ptr() if s is not None else None
    ncols = f.shape[1] * f.shape[2]
    stream = torch.cuda.current_stream().cuda_stream
    if how in ("jobs", "jobs0"):
        ptrs = (ctypes.c_void_p * (2 * xm.MAX_SRC + 2))(
            op.packed.data_ptr(), *[None] * (xm.MAX_SRC - 1), f.data_ptr(),
            *[None] * (xm.MAX_SRC - 1), sp, out.data_ptr())
        tabs = (None,) if how == "jobs" else ()
        err = lib.x_apply_tc_launch_jobs(op.form, 0, 1, ptrs, *tabs, op.rows,
                                         op.K, ncols, 1, 4, sms, stream)
    else:
        err = lib.x_apply_tc_launch(op.form, op.packed.data_ptr(),
                                    f.data_ptr(), sp, out.data_ptr(),
                                    op.rows, op.K, ncols, 4, sms, *how,
                                    stream)
    if err:
        raise RuntimeError(f"reference launch failed ({err})")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dims", type=int, nargs=3, action="append")
    ap.add_argument("--ref")
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: prof_xparity times kernels on the card",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ref = ref_lib(args.ref) if args.ref else None
    gen = torch.Generator(device=dev).manual_seed(0)
    ok, out, pms = True, {"card": card[0] if card else None}, {}

    def fail(msg):
        nonlocal ok
        ok = False
        print(f"FAIL: {msg}", flush=True)

    for dims in args.dims or SIZES:
        nx, ny, nz = dims
        if nx not in pms:
            pms[nx] = x_mats(nx, dev)
        pm = pms[nx]
        label = "x".join(map(str, dims))
        f = torch.randn(dims, generator=gen, device=dev)
        s = torch.randn(dims, generator=gen, device=dev)
        eye = torch.eye(nx, dtype=torch.float64, device=dev).unsqueeze(-1)
        for stage, name, sub in STAGES:
            s_ = s if sub else None
            op = pm.packed_x(name)
            M32 = pm.mats(torch.float32)[name]
            parity = "fwd" if stage == "x_pfwd" else "inv"

            def kern(S=4):
                return xm.launch(stage, op, f, s_, slots=S)

            def tmpl():
                return template(M32, f, s_, parity)

            dense = sl.x_apply_parity_plain(
                name, pm.mats(torch.float64)[name], eye).squeeze(-1).float()
            f2 = f.view(nx, -1)

            def call():
                return (torch.matmul(dense, f2) if s_ is None else
                        torch.addmm(s_.view(nx, -1), dense, f2, alpha=-1.0))

            p64 = sl.x_apply_parity_plain(name, pm.mats(torch.float64)[name],
                                          f.double(), None if s_ is None
                                          else s_.double())
            p32 = sl.x_apply_parity_plain(name, M32, f, s_)
            got = sl.x_apply_parity(name, f, pm, s_)
            e64, e32 = rel(got, p64), rel(got, p32.double())
            entry = {"rel64": e64, "rel32": e32,
                     "plain32_rel64": rel(p32, p64),
                     "template_rel64": rel(tmpl(), p64)}
            if not e64 <= TC_LIM:
                fail(f"{stage} {label}: {e64} of plain f64")
            geo = xm.geometry(op.form, op.n_out, op.K, ny * nz, sms)
            entry["geometry"] = {"items": geo.nitems, "smem": geo.smem}
            same = torch.equal(kern(), got)
            # device ms at each S
            by_s = {}
            for S in (2, 3, 6):
                same = same and torch.equal(kern(S), got)
                by_s[f"S={S}"] = device_ms(lambda S=S: kern(S), args.iters)
            entry["device_ms_by_S"] = by_s
            entry["bit_equal_launches_S"] = same
            if not same:
                fail(f"{stage} {label}: launches differ")
            if ref is not None:
                theirs = ref_launch(ref, op, f, s_, sms)
                entry["bit_equal_ref"] = torch.equal(theirs, got)
                if not entry["bit_equal_ref"]:
                    fail(f"{stage} {label}: differs from the reference")
                del theirs
            del got, p32, p64
            entry["kernel"] = timings(kern, args.iters)
            entry["template"] = timings(tmpl, args.iters)
            entry["call"] = timings(call, args.iters)
            if ref is not None:
                t = [device_ms(lambda: ref_launch(ref, op, f, s_, sms),
                               args.iters)]
                t += [device_ms(kern, args.iters), device_ms(kern, args.iters)]
                t.append(device_ms(lambda: ref_launch(ref, op, f, s_, sms),
                                   args.iters))
                entry["turns_ref_this_this_ref"] = t
                entry["ref_host_us"] = host_us(
                    lambda: ref_launch(ref, op, f, s_, sms), args.iters)
            out[f"{stage}@{label}"] = entry
            print(f"[{stage} {label}] " + json.dumps(entry), flush=True)
            del dense
        del f, s
        torch.cuda.empty_cache()
    if ref is not None:
        # the dense form: this checkout's launch bit-equal to the
        # reference's, in turns
        rng = np.random.default_rng(1)
        for n_out, n_in, ny, nz in ((512, 512, 512, 512),
                                    (128, 128, 128, 256),
                                    (512, 513, 256, 128),
                                    (513, 512, 256, 128)):
            M = rng.standard_normal((n_out, n_in)) / math.sqrt(n_in)
            op = xm.pack(M, xm.DENSE, dev)
            f = torch.randn((n_in, ny, nz), generator=gen, device=dev)
            s = torch.randn((n_out, ny, nz), generator=gen, device=dev)
            for s_ in (None, s):
                key = (f"x_apply{'[sub]' if s_ is not None else ''}@"
                       f"{n_out}x{n_in}x{ny}x{nz}")
                mine = xm.launch("x_apply", op, f, s_)
                same = torch.equal(mine, ref_launch(ref, op, f, s_, sms))
                if not same:
                    fail(f"{key}: differs from the reference")
                t = [device_ms(lambda: ref_launch(ref, op, f, s_, sms),
                               args.iters)]
                t += [device_ms(lambda: xm.launch("x_apply", op, f, s_),
                                args.iters) for _ in range(2)]
                t.append(device_ms(lambda: ref_launch(ref, op, f, s_, sms),
                                   args.iters))
                out[key] = {"bit_equal_ref": same,
                            "turns_ref_this_this_ref": t,
                            "host_us": host_us(lambda: xm.launch(
                                "x_apply", op, f, s_), args.iters)}
                print(f"[{key}] " + json.dumps(out[key]), flush=True)
            del f, s, op
            torch.cuda.empty_cache()
    out["ok"] = ok
    print(json.dumps(out), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
