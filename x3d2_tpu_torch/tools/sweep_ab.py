"""The tensor-core momentum sweep (csrc/transeq_sweep_tc.cu) on the card,
in turns against another tree's build of it and against the SIMT body
it replaced on a periodic axis.

    python3 -m x3d2_tpu_torch.tools.sweep_ab [--ref DIR] [--simt]
        [--dims NX NY NZ ...]

For each grid (default 512^3, 320x256x384 and 128x128x256; every axis
periodic) and each sweep of VARIANTS (the main path's z, x + acc and
y + acc + AB3 first; the bfloat16 ones at the first grid only), this
checkout's wrapper (ts.transeq_sweep) launches each body in turns with
this checkout's tensor-core one (other, this, this, other), each turn
the ms a launch over 10 back to back by CUDA events:
- with --ref DIR (a checkout, e.g. `git archive REV x3d2_tpu_torch/csrc
  | tar -x -C DIR`), DIR's transeq_sweep_tc.cu (with its
  transeq_sweep.cuh), built with this checkout's nvcc flags; its
  transeq_sweep_tc_geometry must equal this checkout's, and its outputs
  must be bit-equal to this checkout's;
- with --simt, the SIMT body of this checkout's transeq_sweep.cu (the
  momentum sweep's body before the tensor-core one, unchanged since;
  a non-periodic axis' now), launched on the same blocks with the
  tensor-core route off.
Each body's distance to the plain float32 sweep is printed (relative to
its max; the bfloat16 outputs left out, and u' with a bfloat16 history
carries the error feedback of rhs's rounding, which two bodies may round
to neighbouring values: chip_smoke.py's sweep_fold holds it). Prints the card's name and
power limit, then one line a sweep; exits 1 where --ref's outputs
differ, 2 without a card.
"""

from __future__ import annotations

import argparse
import copy
import ctypes
import hashlib
import math
import subprocess
import sys
from pathlib import Path

import torch

from x3d2_tpu_torch import _build
from x3d2_tpu_torch.common import BC
from x3d2_tpu_torch.mesh import Mesh
from x3d2_tpu_torch.ops import transeq_sweep as ts
from x3d2_tpu_torch.solver import NavierStokes
from x3d2_tpu_torch.time_integrators import TimeIntegrator

NU, DT = 1 / 1600, 1e-3
SHAPES = [(512, 512, 512), (320, 256, 384), (128, 128, 256)]
AB, RK3, RK4 = (TimeIntegrator(s) for s in ("AB3", "RK3", "RK4"))
BF = torch.bfloat16
# (label, axis, keywords: acc, history fields, row, base, bfloat16 history,
# bfloat16 partials); the bfloat16 ones at the first grid only
VARIANTS = [
    ("z", 2, {}), ("x,acc", 0, {"acc": 1}),
    ("y,acc,ab3", 1, {"acc": 1, "olds": 2, "dtc": AB.ab_row(3, DT)}),
    ("y,acc", 1, {"acc": 1}),
    ("y,acc,rk0", 1, {"acc": 1, "olds": 0, "dtc": RK3.rk_row(0, DT)}),
    ("y,acc,rk0,f0", 1, {"acc": 1, "olds": 0, "dtc": RK3.rk_row(1, DT),
                         "base": 1}),
    ("y,acc,rk2,f0", 1, {"acc": 1, "olds": 2, "dtc": RK3.rk_row(2, DT),
                         "base": 1}),
    ("y,acc,rk3,f0", 1, {"acc": 1, "olds": 3, "dtc": RK4.rk_row(3, DT),
                         "base": 1}),
    ("z,bf16acc", 2, {"bacc": 1}),
    ("x,acc,bf16acc", 0, {"acc": 1, "bacc": 1}),
    ("y,acc,ab3,bf16olds", 1, {"acc": 1, "olds": 2, "bolds": 1,
                               "dtc": AB.ab_row(3, DT, feedback=True)}),
    ("y,acc,ab3,bf16olds,bf16acc", 1, {"acc": 1, "olds": 2, "bolds": 1,
                                       "bacc": 1, "dtc": AB.ab_row(
                                           3, DT, feedback=True)}),
]


def ref_lib(ref):
    """DIR's transeq_sweep_tc library, typed as this checkout's."""
    csrc = Path(ref) / "x3d2_tpu_torch" / "csrc"
    src = csrc / "transeq_sweep_tc.cu"
    text = src.read_bytes() + (csrc / "transeq_sweep.cuh").read_bytes()
    so = _build.BUILD_DIR / ("ref_transeq_sweep_tc-"
                             + hashlib.sha256(text).hexdigest()[:16] + ".so")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    r = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                        str(so), str(src)], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{r.stdout}{r.stderr}")
    lib, own = ctypes.CDLL(str(so)), ts._tc_lib()
    for name in ("transeq_sweep_tc_launch", "transeq_sweep_error_string",
                 "transeq_sweep_tc_geometry"):
        getattr(lib, name).argtypes = getattr(own, name).argtypes
        getattr(lib, name).restype = getattr(own, name).restype
    geo = [(ctypes.c_int * 10)() for _ in range(2)]
    lib.transeq_sweep_tc_geometry(geo[0])
    own.transeq_sweep_tc_geometry(geo[1])
    if tuple(geo[0]) != tuple(geo[1]):
        raise RuntimeError(f"{src}: geometry {tuple(geo[0])}, this "
                           f"checkout's {tuple(geo[1])}")
    return lib


def ms(fn, n=10):
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def flat(res):
    return list(res[0]) + list(res[1]) if isinstance(res[0], tuple) \
        else list(res)


def sweep_args(kw, rn):
    """transeq_sweep's keywords for a variant, on fields from rn."""
    adt = BF if kw.get("bacc") else None
    hdt = BF if kw.get("bolds") else torch.float32
    out = {}
    if kw.get("acc"):
        out["acc"] = tuple(rn(100.0).to(adt or torch.float32)
                           for _ in range(3))
    if "dtc" in kw:
        out["olds"] = tuple(tuple(rn(100.0).to(hdt)
                                  for _ in range(kw["olds"]))
                            for _ in range(3))
        out["dtc"] = kw["dtc"]
    if kw.get("base"):
        out["base"] = tuple(rn() for _ in range(3))
    if adt is not None:
        out["acc_dtype"] = adt
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ref")
    ap.add_argument("--simt", action="store_true")
    ap.add_argument("--dims", type=int, nargs=3, action="append")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    # this checkout's libraries, one nvcc each, together
    _build.build_all(["transeq_sweep_tc"]
                     + (["transeq_sweep"] if args.simt else []))
    own = ts._tc_lib()
    ref = ref_lib(args.ref) if args.ref else None
    others = (["ref"] if ref else []) + (["simt"] if args.simt else [])
    dev = torch.device("cuda")
    per = ((BC.PERIODIC, BC.PERIODIC),) * 3
    ok = True
    for k, shape in enumerate([tuple(d) for d in args.dims or SHAPES]):
        ns = NavierStokes.build(Mesh(shape, (2 * math.pi,) * 3, per), NU,
                                device=dev)
        gen = torch.Generator(device=dev).manual_seed(0)

        def rn(scale=1.0):
            return scale * torch.randn(shape, generator=gen, device=dev)

        u, v, w = rn(), rn(), rn()
        for label, axis, kw in VARIANTS:
            if k and (kw.get("bacc") or kw.get("bolds")):
                continue
            kwargs = sweep_args(kw, rn)
            blocks = ts.build_sweep_blocks(ns.ops[axis], axis, device=dev)
            simt = copy.copy(blocks)
            simt.tc = None          # the tensor-core route off

            def run(who):
                ts._LIBS["tc"] = ref if who == "ref" else own
                try:
                    b = simt if who == "simt" else blocks
                    res = flat(ts.transeq_sweep(u, v, w, b, NU, **kwargs))
                    t = ms(lambda: ts.transeq_sweep(u, v, w, b, NU,
                                                    **kwargs))
                finally:
                    ts._LIBS["tc"] = own
                return [r.clone() for r in res], round(t, 4)

            p32 = [t for t in flat(ts.transeq_sweep_plain(
                u, v, w, blocks, NU, **kwargs)) if t.dtype == torch.float32]
            line = [f"{shape} {label}"]
            for other in others:
                turns, outs = {}, {}
                for who in (other, "this", "this", other):
                    outs[who], t = run(who)
                    turns.setdefault(who, []).append(t)
                line.append(f"ms {turns}")
                if other == "ref":
                    same = all(torch.equal(a, b) for a, b in
                               zip(outs["ref"], outs["this"]))
                    ok &= same
                    line.append(f"bit-equal to ref {same}")
                for who in (other, "this") if p32 else ():
                    got = [t for t in outs[who] if t.dtype == torch.float32]
                    rel = max(float((a - b).abs().max() / b.abs().max())
                              for a, b in zip(got, p32))
                    line.append(f"{who} vs plain32 {rel:.2e}")
                del outs
            if not others:
                outs, t = run("this")
                line.append(f"ms {t}")
            print("  ".join(line), flush=True)
            del p32, kwargs
        del ns, u, v, w
        torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
