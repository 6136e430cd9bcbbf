#!/usr/bin/env python3
"""Where the slab projection's mid rounds: each of its kernel launches
against the plain float32 and float64 versions on the same inputs, then the
whole mid over several white-noise seeds.

    python3 -m x3d2_tpu_torch.tools.mid_probe [n | NXxNYxNZ ...] \
        [--dense] [--seeds N]                     (default 512 256, 4 seeds)
    python3 -m x3d2_tpu_torch.tools.mid_probe --tiled [NXxNYxNZ] [--seeds N]
                                   (default 128x3968x128, 4 seeds)

Needs one NVIDIA GPU. Per launch it prints max |kernel - plain32|,
max |kernel - plain64| and max |plain32 - plain64|, each over
max |plain64|: the launches are bit-equal to their plain versions (a
two-source launch, Iy du + Sy dv or Iz . + Sz ., sums each source apart
and adds the two sums, as the plain version does), but the solve, which
differs by a fused multiply-add. Then, per seed and output of the whole
mid, the same three distances as maxima and as root-mean-square values, and
q weighted by its wave factor (the solve's input, mode by mode); last, the
whole mid's time on the card (the median of 10 runs, CUDA events). The chip
smoke run holds the mid on white noise to bounds read off this output. With
--dense the mid's dense forms (X3D2_BFLY=0: the whole mid over the seeds
and its time only). With --tiled the y/z-tiled mid over the x batch a rank
of a (2, 2) mesh holds last (the batch chip_smoke.py's phase 3k holds on
white noise), over the seeds: per seed and output the same distances, the
root-mean-square ratios being those phase 3k holds to 2x.
"""

import math
import sys

import torch

from ..common import BC, env_set
from ..mesh import Mesh
from ..ops import operator_apply as oa
from ..ops import pressure_slab as sl
from ..ops.parity import (banded_apply, build_projection_mats, pfwd, pinv,
                          solve_factor)
from ..solver import NavierStokes

D64 = torch.float64
SEEDS = 4


def dist(a, b, weight=None):
    d = (a.to(D64) - b.to(D64))
    if weight is not None:
        d = d * weight
    return float(d.abs().max()), float(d.pow(2).mean().sqrt())


def probe(shape, dev, dense=False, seeds=SEEDS):
    per = ((BC.PERIODIC, BC.PERIODIC),) * 3
    with env_set({"X3D2_BFLY": "0"} if dense else {}):
        ns = NavierStokes.build(Mesh(shape, (2 * math.pi,) * 3, per),
                                1 / 1600, device=dev)
    pm = ns._slab
    m, M = pm.mats(torch.float32), pm.mats(D64)
    tabs = (m["tab_a"], m["tab_b"], m["k2x"], m["tx2"])
    n = "x".join(map(str, shape)) + (" dense" if dense else "")

    def noise(seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        f = [torch.randn(shape, generator=g, device=dev) for _ in range(3)]
        if dense:
            return tuple(sl.x_apply_plain(m[k], t).contiguous()
                         for k, t in zip(("sx", "ix", "ix"), f))
        return tuple(t.contiguous() for t in sl.x_div3_plain(*f, m))

    def up(*ts):
        return [t.to(D64) for t in ts]

    if not dense:
        sf64 = launches(n, shape, m, M, tabs, noise, up)
    else:
        sf64 = solve_factor(M, tuple(shape))
    # -- the whole mid over seeds
    waves = torch.where(sf64 != 0, 1 / sf64.abs(), torch.zeros_like(sf64))
    del sf64
    for seed in range(1, seeds + 1):
        ins = noise(seed)
        k = sl.pressure_mid(*ins, pm, emit_q=True)
        p32 = sl.pressure_mid_plain(*ins, m, True, pm.forms)
        p64 = sl.pressure_mid_plain(*up(*ins), M, True, pm.forms)
        for name, x, y, z in zip(("q", "p_zy", "dpdy", "dpdz"), k, p32, p64):
            kp, k6, p6 = dist(x, y), dist(x, z), dist(y, z)
            s = float(z.abs().max())
            print(f"[{n}] seed {seed} {name}: max kernel-plain32 "
                  f"{kp[0] / s:.2e} kernel-plain64 {k6[0] / s:.2e} "
                  f"plain32-plain64 {p6[0] / s:.2e} ({kp[0] / p6[0]:.2f}x, "
                  f"{k6[0] / p6[0]:.2f}x); rms {kp[1] / p6[1]:.2f}x, "
                  f"{k6[1] / p6[1]:.2f}x the plain32-plain64 one",
                  flush=True)
        s = float((p64[0] * waves).abs().max())
        print(f"[{n}] seed {seed} q times its wave factor: kernel-plain32 "
              f"{dist(k[0], p32[0], waves)[0] / s:.2e} kernel-plain64 "
              f"{dist(k[0], p64[0], waves)[0] / s:.2e} plain32-plain64 "
              f"{dist(p32[0], p64[0], waves)[0] / s:.2e}", flush=True)
        del k, p32, p64
        if seed == seeds:
            print(f"[{n}] the whole mid: {mid_ms(ins, pm):.3f} ms",
                  flush=True)
        del ins
        torch.cuda.empty_cache()


def probe_tiled(shape, dev, seeds=SEEDS):
    """The tiled mid over x batch [3 n, 4 n), n = nx / 4, on the x_div3 of
    white noise, against its plain float32 and float64 versions, for seeds
    1..seeds."""
    per = ((BC.PERIODIC, BC.PERIODIC),) * 3
    ns = NavierStokes.build(Mesh(shape, (2 * math.pi,) * 3, per),
                            1 / 1600, device=dev)
    if not sl.tiled_mid_supported(ns, 2):
        raise SystemExit(f"{shape}: not a grid of the tiled mid")
    pm = build_projection_mats(ns)
    n_b = shape[0] // 4
    off = 3 * n_b
    m32 = sl.local_tables(pm.mats(torch.float32), off, n_b)
    m64 = sl.local_tables(pm.mats(D64), off, n_b)
    n = "x".join(map(str, (n_b,) + tuple(shape[1:]))) + " tiled"
    for seed in range(1, seeds + 1):
        g = torch.Generator(device=dev).manual_seed(seed)
        f = [torch.randn(shape, generator=g, device=dev) for _ in range(3)]
        ins = tuple(t[off:off + n_b].contiguous()
                    for t in sl.x_div3_plain(*f, pm.mats(torch.float32)))
        del f
        k = sl.pressure_mid_tiled(*ins, pm, m32["k2x"], m32["tx2"],
                                  m32.get("mx"))
        p32 = sl.pressure_mid_tiled_plain(*ins, m32)
        p64 = sl.pressure_mid_tiled_plain(*(t.to(D64) for t in ins), m64)
        for name, x, y, z in zip(("q", "p_zy", "dpdy", "dpdz"), k, p32, p64):
            kp, k6, p6 = dist(x, y), dist(x, z), dist(y, z)
            s = float(z.abs().max())
            print(f"[{n}] seed {seed} {name}: max kernel-plain32 "
                  f"{kp[0] / s:.2e} kernel-plain64 {k6[0] / s:.2e} "
                  f"plain32-plain64 {p6[0] / s:.2e} ({kp[0] / p6[0]:.2f}x, "
                  f"{k6[0] / p6[0]:.2f}x); rms {kp[1] / p6[1]:.2f}x, "
                  f"{k6[1] / p6[1]:.2f}x the plain32-plain64 one",
                  flush=True)
        del ins, k, p32, p64
        torch.cuda.empty_cache()


def mid_ms(ins, pm, reps=10):
    """Median time of the mid with q on `ins`, by CUDA events."""
    sl.pressure_mid(*ins, pm, emit_q=True)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        sl.pressure_mid(*ins, pm, emit_q=True)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[reps // 2]


def launches(n, shape, m, M, tabs, noise, up):
    """The parity mid launch by launch, each on the plain float32 result of
    the one before; returns the float64 solve factor."""

    def show(tag, k, p32, p64):
        s = float(p64.abs().max())
        print(f"[{n}] {tag}: kernel-plain32 {dist(k, p32)[0] / s:.2e}  "
              f"kernel-plain64 {dist(k, p64)[0] / s:.2e}  plain32-plain64 "
              f"{dist(p32, p64)[0] / s:.2e}", flush=True)

    def launch(mode, axis, mats, fields, **kw):
        out = torch.empty_like(fields[0])
        oa.apply("probe", mode, axis, [(mats, fields, out, None)], **kw)
        return out

    # -- launch by launch, each on the plain float32 result of the one before
    du, dv, dw = noise(0)
    p32 = banded_apply(m["biy"], du, 1) + banded_apply(m["bsy"], dv, 1)
    a, b = up(du, dv)
    p64 = banded_apply(M["biy"], a, 1) + banded_apply(M["bsy"], b, 1)
    show("banded y, two sources",
         launch(oa.BANDED, 1, [m["biy"], m["bsy"]], [du, dv]), p32, p64)
    duv = p32.contiguous()
    p32 = banded_apply(m["biy"], dw, 1)
    show("banded y, one source", launch(oa.BANDED, 1, [m["biy"]], [dw]), p32,
         banded_apply(M["biy"], dw.to(D64), 1))
    dwm = p32.contiguous()
    p32 = pfwd(m["iz"], duv, 2) + pfwd(m["sz"], dwm, 2)
    a, b = up(duv, dwm)
    show("forward z, two sources",
         launch(oa.PFWD, 2, [m["sz"], m["iz"]], [dwm, duv]), p32,
         pfwd(M["iz"], a, 2) + pfwd(M["sz"], b, 2))
    zz = p32.contiguous()
    F32, F64 = pfwd(m["ty"], zz, 1), pfwd(M["ty"], zz.to(D64), 1)
    show("forward y", launch(oa.PFWD, 1, [m["ty"]], [zz]), F32, F64)
    sf64 = solve_factor(M, tuple(shape))
    q32 = F32 * solve_factor(m, tuple(shape))
    show("forward y + solve", launch(oa.PFWD, 1, [m["ty"]], [zz],
                                     epi=oa.SOLVE_PLANE, tabs=tabs),
         q32, F64 * sf64)
    q = q32.contiguous()
    p32 = pinv(m["gzi"], q, 2)
    show("inverse z", launch(oa.PINV, 2, [m["gzi"]], [q]), p32,
         pinv(M["gzi"], q.to(D64), 2))
    pz = p32.contiguous()
    p32 = pinv(m["tyi"], pz, 1)
    show("inverse y", launch(oa.PINV, 1, [m["tyi"]], [pz]), p32,
         pinv(M["tyi"], pz.to(D64), 1))
    gh = p32.contiguous()
    show("banded y (gradient)", launch(oa.BANDED, 1, [m["bgsy"]], [gh]),
         banded_apply(m["bgsy"], gh, 1),
         banded_apply(M["bgsy"], gh.to(D64), 1))
    del du, dv, dw, duv, dwm, zz, F32, F64, q32, q, pz, gh, p32, p64, a, b
    return sf64


def main(argv):
    if not torch.cuda.is_available():
        print("mid_probe needs a GPU", file=sys.stderr)
        return 2
    dense = "--dense" in argv
    seeds = SEEDS
    if "--seeds" in argv:
        seeds = int(argv[argv.index("--seeds") + 1])
        argv = argv[:argv.index("--seeds")] + argv[argv.index("--seeds")
                                                    + 2:]
    if "--tiled" in argv:
        sizes = [a for a in argv if not a.startswith("--")] or [
            "128x3968x128"]
        for a in sizes:
            probe_tiled(tuple(int(x) for x in a.split("x")),
                        torch.device("cuda"), seeds)
        return 0
    sizes = [a for a in argv if not a.startswith("--")] or ["512", "256"]
    for a in sizes:
        shape = tuple(int(x) for x in a.split("x"))
        probe(shape * 3 if len(shape) == 1 else shape, torch.device("cuda"),
              dense, seeds)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
