"""The operator-apply template against another checkout's, on the card:
the same launches, bit for bit, their times side by side, and both builds'
registers and spills per instance.

    python3 -m x3d2_tpu_torch.tools.template_bits REF [--dims NX NY NZ ...]

REF is the root of another checkout of the repository (for example the
parent commit unpacked by `git archive` into a directory .gitignore lists).
Its csrc/pressure_pipe.cu is built with nvcc into build/x3d2_tpu_torch/
(ref_pressure_pipe-<hash>.so) and loaded beside this checkout's. On each
grid (default 512^3 and 128 x 128 x 256: every extent a multiple of the
template's 128, so every launch takes a 128-tiled instance; a grid past
the tiles, such as 320 x 256 x 384, takes the general instances and needs a
reference that has them) x_div3, the mid with q, div_solve, grad,
x_gradsub3 (the pipeline's stages are the x-apply kernel's) and the
template's one-field PFWD and PINV (with the subtraction) along x (the
instances x_div3 and x_gradsub3 share; the one-field x applies of the
solver, x_pfwd and x_pinv, are the x-apply kernel's; the template's are
launched here directly) run on the same random inputs through this
checkout's wrappers twice, launching once this library and once the
reference (a reference whose entry point predates the general instances
takes the arguments it had); the outputs must be equal bit for bit, and
each is timed by CUDA events in turns (reference, this, this, reference).
Prints one JSON line a grid and one for the registers; exits 1 where the
bits differ.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import math
import re
import subprocess
import sys
from pathlib import Path

import torch

from .. import _build
from ..common import BC
from ..mesh import Mesh
from ..ops import operator_apply as oa
from ..ops import pressure_slab as sl
from ..solver import NavierStokes
from .prof_manual import template


def ptxas_registers(log):
    """{instance: "N registers, S bytes spill stores, L bytes spill loads"}
    of the template's instances, from nvcc -Xptxas -v output. Instances are
    named as the 128-tiled ones were named before the general ones joined
    their body: mat_apply_kernel<MODE,TRANS,EPI,TWO> for TAIL 0 (or a
    library with no TAIL argument), mat_apply_tail_kernel<MODE,TRANS,EPI>
    for TAIL 1 (or a library with a kernel of that name), so two builds
    compare instance by instance."""
    regs, spills, inst = {}, {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            k = re.search(r"(mat_apply(?:_tail)?_kernel)I((?:L[ib]\d+E)+)E",
                          m.group(1))
            inst = None
            if k:
                name = k.group(1)
                args = re.findall(r"L[ib](\d+)E", k.group(2))
                if name == "mat_apply_kernel" and len(args) == 5:
                    name = ("mat_apply_tail_kernel" if args[4] == "1"
                            else name)
                    args = args[:3] if args[4] == "1" else args[:4]
                inst = name + "<" + ",".join(args) + ">"
        elif inst and "registers" in line:
            regs[inst] = re.search(r"Used (\d+) registers", line).group(1)
        elif inst and "spill" in line:
            spills[inst] = ", ".join(x.strip() for x in line.split(",")[1:])
    return {k: f"{r} registers, {spills.get(k, 'no spill line')}"
            for k, r in regs.items()}


def build(src, name):
    """nvcc on `src` (the flags of _build) into BUILD_DIR/name-<hash>.so:
    (ctypes library, ptxas log)."""
    text = Path(src).read_bytes()
    so = _build.BUILD_DIR / (name + "-" + hashlib.sha256(text).hexdigest()[
        :16] + ".so")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    r = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                        str(so), str(src)], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{r.stdout}{r.stderr}")
    return ctypes.CDLL(str(so)), r.stdout + r.stderr


def build_ref(ref):
    """The reference's pressure_pipe library: (ctypes library, whether its
    entry point takes the general instance's arguments, ptxas log)."""
    src = Path(ref) / "x3d2_tpu_torch" / "csrc" / "pressure_pipe.cu"
    lib, log = build(src, "ref_pressure_pipe")
    new_args = b"int tail," in src.read_bytes()
    i, ll, p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    lib.pressure_pipe_apply.argtypes = (
        [i, i, i, i, p, p, p, i, i, i, i, i, ll, ll, ll, i]
        + ([i, ll, ll, i] if new_args else []) + [p])
    lib.pressure_pipe_apply.restype = i
    return lib, new_args, log


class _Ref:
    """The reference library behind this checkout's launcher."""

    def __init__(self, lib, new_args, own):
        self.lib, self.new_args, self.own = lib, new_args, own

    def pressure_pipe_apply(self, *a):
        if a[16] and not self.new_args:
            raise RuntimeError("a launch of the general instance, which the "
                               "reference lacks: the grid is not tiled by "
                               "the template")
        return self.lib.pressure_pipe_apply(
            *(a if self.new_args else a[:16] + a[-1:]))

    def pressure_pipe_error_string(self, err):
        return self.own.pressure_pipe_error_string(err)


def functions(ns, dev, gen):
    """(name, fn) pairs: each a closure over random inputs."""
    pm = ns._slab
    dims = tuple(pm.shape)

    def randn():
        return torch.randn(dims, generator=gen, device=dev)

    u, v, w = randn(), randn(), randn()
    m32 = pm.mats(torch.float32)
    d = sl.x_div3(u, v, w, pm)
    q = sl.div_solve(*d, pm)
    g = sl.grad(q, pm)
    return [
        ("x_div3", lambda: sl.x_div3(u, v, w, pm)),
        ("pressure_mid[q]", lambda: sl.pressure_mid(*d, pm)),
        ("div_solve", lambda: (sl.div_solve(*d, pm),)),
        ("grad", lambda: sl.grad(q, pm)),
        ("x_gradsub3", lambda: sl.x_gradsub3(*g, u, v, w, pm)),
        ("x_pfwd", lambda: (template(m32["sx"], u, None, "fwd"),)),
        ("x_pinv[sub]", lambda: (template(m32["gxs"], g[0], u, "inv"),))]


def ms_of(fn, reps=10):
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("ref")
    ap.add_argument("--dims", type=int, nargs=3, action="append")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: template_bits runs on the card",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    own = oa.lib()
    ref, new_args, ref_log = build_ref(args.ref)
    shim = _Ref(ref, new_args, own)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    ok = True
    per = ((BC.PERIODIC, BC.PERIODIC),) * 3
    for dims in args.dims or [(512, 512, 512), (128, 128, 256)]:
        ns = NavierStokes.build(Mesh(tuple(dims), (2 * math.pi,) * 3, per),
                                1 / 1600, device=dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        res = {}
        for name, fn in functions(ns, dev, gen):
            mine = [t for t in fn() if t is not None]
            oa._LIB = shim
            try:
                theirs = [t for t in fn() if t is not None]
                t_ref = [ms_of(fn)]
                oa._LIB = own
                t_own = [ms_of(fn), ms_of(fn)]
                oa._LIB = shim
                t_ref.append(ms_of(fn))
            finally:
                oa._LIB = own
            same = all(torch.equal(x, y) for x, y in zip(mine, theirs))
            ok = ok and same
            res[name] = {"bit_equal": same, "ms": t_own, "ref_ms": t_ref}
            del mine, theirs
        print(json.dumps({"card": card, "dims": list(dims),
                          "functions": res}), flush=True)
        del ns
        torch.cuda.empty_cache()
    _, own_log = build(_build.CSRC / "pressure_pipe.cu", "own_pressure_pipe")
    mine = ptxas_registers(own_log)
    theirs = ptxas_registers(ref_log)
    print(json.dumps({"registers": {k: {"this": mine.get(k),
                                        "ref": theirs.get(k)}
                                    for k in sorted(set(mine) | set(theirs))
                                    }}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
