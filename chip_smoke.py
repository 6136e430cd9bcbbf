#!/usr/bin/env python3
"""Smoke run of the PyTorch port (x3d2_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failed check exits non-zero:

1. Device: needs CUDA; prints the card's name and power limit
   (nvidia-smi) and asserts full-float32 matmuls (TF32 off).
2. Build: compiles every kernel source (csrc/transeq_sweep.cu,
   csrc/pressure_pipe.cu) with nvcc for sm_90a, one nvcc per source, all
   started together.
3. Kernel vs plain at 512^3 float32, on the card:
   - every sweep variant of the main path (z; x accumulate; y accumulate +
     AB3 with the steady and a startup coefficient row);
   - each stage of the pressure pipeline (pipe_a, pipe_b, pipe_c), on the
     inputs the previous stage's plain version gives;
   max |kernel - plain f32| <= 1e-5 * scale and max |kernel - plain f64|
   <= 3e-5 * scale (scale = max |plain f64|); kernel and plain times (CUDA
   events, median) beside the bound.
4. Main path: TGV 512^3 AB3 float32, keep_pressure=False, through
   TGVCase.run(n_iters=20), with every launch count set to 0 just before:
   3 sweep launches and the pipeline's 8 launches per step, finite and
   decreasing KE, div_u_max below DIV_LIMIT; then ms/step and the share of
   the step in the sweeps and in the projection.
5. Slice as a whole: TGV (128, 128, 256) AB3 float32, 10 steps on the card
   (kernels) and on the CPU (plain versions): max |du, dv, dw| <= 1e-5, KE
   relative difference <= 1e-6.
6. The kernels line (JSON), the card line, and the result line.

It imports nothing of JAX or of the JAX package.
"""

import json
import math
import subprocess
import sys
import time

NS = 512                    # main-path grid
SMALL = (128, 128, 256)     # whole-slice comparison grid
STEPS = 20
DT = 1e-3
# f32 projection level of div_u_max: the f32 plain path on the CPU reaches
# 7.5e-6, 2.4e-5 and 7.3e-5 at 64^3, 128^3 and 256^3 after two TGV steps
# (about 3x per doubling, the derivative operators' 1/dx growth), so about
# 2e-4 is expected at 512^3
DIV_LIMIT = 1e-3
# H100 SXM data-sheet rates (NVIDIA), dense, at the 700 W limit
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
SWEEP_SOURCE = "x3d2_tpu_torch/csrc/transeq_sweep.cu"
PIPE_SOURCE = "x3d2_tpu_torch/csrc/pressure_pipe.cu"
REPLACES = {2: "x3d2_tpu/ops/pallas_kernels.py:671",
            0: "x3d2_tpu/ops/pallas_kernels.py:172",
            1: "x3d2_tpu/ops/pallas_kernels.py:172",
            "pipe_a": "x3d2_tpu/ops/pallas_poisson.py:1378",
            "pipe_b": "x3d2_tpu/ops/pallas_poisson.py:1405",
            "pipe_c": "x3d2_tpu/ops/pallas_poisson.py:1455"}


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def cuda_ms(fn, reps, torch):
    """Median time of fn() over `reps` runs, by CUDA events."""
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


def sweep_cost(shape, accumulate, nolds, w):
    """(bytes, flops) the sweep function needs: each input field read once
    and each output written once; the band taps each output needs (2w + 1
    per operator: D1, D2 and D1d, for 3 components), the q*conv products,
    the combine, the accumulate and the AB update. The kernel's 96-wide
    block rows (BS + 2W) are its design, not a need of the function."""
    npts = shape[0] * shape[1] * shape[2]
    nin = 3 + (3 if accumulate else 0) + 3 * nolds
    nout = 6 if nolds else 3
    per_pt = 3 * (2 * 3 * (2 * w + 1) + 1 + 5) + (3 if accumulate else 0)
    if nolds:
        per_pt += 3 * (2 + 2 * nolds)
    return 4 * npts * (nin + nout), npts * per_pt


def pipe_cost(stage, shape, w):
    """(bytes, flops) of one pipeline stage: fields read once and written
    once (the operators are under 1% and left out); the parity-split dense
    applies (n/2 multiply-adds per output and one add for the f1 +/- f2 or
    a +/- b combine), the banded applies (2w + 1 taps), the solve (waves,
    reciprocal, scale) and the correction."""
    nx, ny, nz = shape
    npts = nx * ny * nz
    band = 2 * (2 * w + 1) + 0.0
    if stage == "pipe_a":
        # 3 banded y; z: Iz p1, Iz p2 + Sz p3; y: Ty z1, Ty z23
        per_pt = 3 * band + 3 * (nz + 1) + 2 * (ny + 1)
        fields = 3 + 2
    elif stage == "pipe_b":
        # x: Sx a + Ix e, solve; x: Gxs q, Gxi q
        per_pt = 2 * (nx + 1) + 5 + 2 * (nx + 1)
        fields = 2 + 2
    else:
        # z: Gzi X, Gzs Y, Gzi Y; y: 3 inverse transforms; 3 banded y, minus
        per_pt = 3 * (nz + 1) + 3 * (ny + 1) + 3 * band + 3
        fields = 5 + 3
    return 4 * npts * fields, npts * per_pt


def bound(nbytes, flops):
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FP32 * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                 else "operations"), t_bytes, t_ops


def rel_err(got, ref):
    """max |got - ref| and the largest of max|got - ref| / max|ref| over
    the outputs; NaN when any of them is not finite (fails every check)."""
    errs, rels = [], []
    for g, r in zip(got, ref):
        d = float((g.to(r.dtype) - r).abs().max())
        errs.append(d)
        rels.append(d / float(r.abs().max()))
    if not all(math.isfinite(x) for x in errs + rels):
        return math.nan, math.nan
    return max(errs), max(rels)


def main():
    import torch

    # ---- 1. device ------------------------------------------------------
    if not torch.cuda.is_available():
        print("no CUDA device: the chip smoke run needs a GPU",
              file=sys.stderr)
        return 2
    import x3d2_tpu_torch  # noqa: F401  (sets the fp32 matmul policy)
    from x3d2_tpu_torch import _build
    from x3d2_tpu_torch.cases import SolverParams, TGVCase
    from x3d2_tpu_torch.common import BC
    from x3d2_tpu_torch.mesh import Mesh
    from x3d2_tpu_torch.ops import pressure_pipe as pp
    from x3d2_tpu_torch.ops import transeq_sweep as ts
    from x3d2_tpu_torch.solver import NavierStokes
    from x3d2_tpu_torch.time_integrators import TimeIntegrator

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    print(f"[device] {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}; nvidia-smi: {card}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)
    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "TF32 matmuls must be off")
    check(torch.get_float32_matmul_precision() == "highest",
          "float32 matmul precision must be 'highest'")

    # ---- 2. build -------------------------------------------------------
    libs = _build.build_all(["transeq_sweep", "pressure_pipe"])
    ts._lib()
    pp._lib()
    for name, lib in libs.items():
        print(f"[build] {lib.name}: {_build.BUILD_SECONDS[name]:.1f} s",
              flush=True)
        for line in _build.BUILD_LOG.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build {name}] " + line.strip())

    # ---- 3. kernels vs plain at 512^3 ------------------------------------
    shape = (NS,) * 3
    per = ((BC.PERIODIC, BC.PERIODIC),) * 3
    mesh = Mesh(shape, (2 * math.pi,) * 3, per)
    nu = 1.0 / 1600
    ns = NavierStokes.build(mesh, nu, device=dev)
    ops = ns.ops
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(scale=1.0):
        return scale * torch.randn(shape, generator=gen, device=dev)

    def row(name, source, replaces, err, ms, plain_ms, cost):
        b, by, t_bytes, t_ops = bound(*cost)
        rows[name] = {"name": name, "route": "cuda", "source": source,
                      "replaces": replaces, "launches": 0,
                      "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": b, "bound_by": by, "library_ms": None}
        return f"bound {b:.3f} ms ({by}: bytes {t_bytes:.3f}, ops " \
               f"{t_ops:.3f})"

    u, v, w = randn(), randn(), randn()
    acc = tuple(randn(100.0) for _ in range(3))
    olds = tuple(tuple(randn(100.0) for _ in range(2)) for _ in range(3))
    ti = TimeIntegrator("AB3")
    variants = [
        ("z", 2, None, None, None),
        ("x,acc", 0, acc, None, None),
        ("y,acc,ab3 steady", 1, acc, olds, ti.ab_row(3, DT)),
        ("y,acc,ab3 startup", 1, acc, olds, ti.ab_row(1, DT)),
    ]
    rows = {}
    d64 = torch.float64
    for label, axis, a, o, dtc in variants:
        blocks = ts.build_sweep_blocks(ops[axis], axis, device=dev)
        nolds = 2 if dtc is not None else 0

        def kern():
            return ts.transeq_sweep(u, v, w, blocks, nu, acc=a, olds=o,
                                    dtc=dtc)

        def plain():
            return ts.transeq_sweep_plain(u, v, w, blocks, nu, acc=a,
                                          olds=o, dtc=dtc)

        def flat(res):
            return list(res[0]) + list(res[1]) if dtc is not None \
                else list(res)

        got = flat(kern())
        torch.cuda.synchronize()
        err32, rel32 = rel_err(got, flat(plain()))
        _, rel64 = rel_err(got, flat(ts.transeq_sweep_plain(
            u.to(d64), v.to(d64), w.to(d64), blocks, nu,
            acc=None if a is None else tuple(t.to(d64) for t in a),
            olds=None if o is None else tuple(tuple(t.to(d64) for t in p)
                                              for p in o),
            dtc=dtc)))
        del got
        torch.cuda.synchronize()
        ms = cuda_ms(kern, 10, torch)
        plain_ms = cuda_ms(plain, 5, torch)
        name = ts.variant_name(axis, a is not None, nolds)
        if name in rows:   # the startup row: times kept from the steady one
            rows[name]["max_abs_err"] = max(err32, rows[name]["max_abs_err"])
            txt = ""
        else:
            txt = row(name, SWEEP_SOURCE, REPLACES[axis], err32, ms,
                      plain_ms, sweep_cost(shape, a is not None, nolds, ts.W))
        print(f"[sweep {label}] max|k-plain32|={err32:.3e} (rel "
              f"{rel32:.2e} <= 1e-5)  rel vs plain64={rel64:.2e} (<= 3e-5)"
              f"  kernel {ms:.3f} ms  plain {plain_ms:.3f} ms  {txt}",
              flush=True)
        check(rel32 <= 1e-5, f"sweep {label}: kernel vs plain f32 {rel32}")
        check(rel64 <= 3e-5, f"sweep {label}: kernel vs plain f64 {rel64}")
    del acc, olds

    # the pipeline's stages, each on the inputs the previous stage's plain
    # version gives (so kernel and plain see the same tensors)
    pm = ns._pipe.mats
    m32, m64 = pm.mats(torch.float32), pm.mats(d64)
    a_, e_ = pp.pipe_a_plain(u, v, w, m32)
    X_, Y_ = pp.pipe_b_plain(a_, e_, m32)
    stages = [
        ("pipe_a", (u, v, w), pp.pipe_a, pp.pipe_a_plain),
        ("pipe_b", (a_, e_), pp.pipe_b, pp.pipe_b_plain),
        ("pipe_c", (X_, Y_, u, v, w), pp.pipe_c, pp.pipe_c_plain),
    ]
    for name, ins, kern_fn, plain_fn in stages:
        got = kern_fn(*ins, pm)
        torch.cuda.synchronize()
        err32, rel32 = rel_err(got, plain_fn(*ins, m32))
        _, rel64 = rel_err(got, plain_fn(*(t.to(d64) for t in ins), m64))
        del got
        torch.cuda.synchronize()
        ms = cuda_ms(lambda: kern_fn(*ins, pm), 10, torch)
        plain_ms = cuda_ms(lambda: plain_fn(*ins, m32), 5, torch)
        txt = row(name, PIPE_SOURCE, REPLACES[name], err32, ms, plain_ms,
                  pipe_cost(name, shape, pp.BW))
        print(f"[{name}] max|k-plain32|={err32:.3e} (rel {rel32:.2e} <= "
              f"1e-5)  rel vs plain64={rel64:.2e} (<= 3e-5)  kernel "
              f"{ms:.3f} ms  plain {plain_ms:.3f} ms  {txt}", flush=True)
        check(rel32 <= 1e-5, f"{name}: kernel vs plain f32 {rel32}")
        check(rel64 <= 3e-5, f"{name}: kernel vs plain f64 {rel64}")
    # the whole pipeline on the kernels against the other formulation of
    # the same projection, the transform-folded chain (plain PyTorch)
    got = ns._pipe(u, v, w)
    grads = ns.pressure_grads(u, v, w, keep_pressure=False)[:3]
    _, rel = rel_err(got, [f - g for f, g in zip((u, v, w), grads)])
    print(f"[pipe] projection on the kernels vs the folded chain: rel "
          f"{rel:.2e} (<= 1e-5)", flush=True)
    check(rel <= 1e-5, f"pipeline vs folded projection {rel}")
    del u, v, w, a_, e_, X_, Y_, ns, stages, m64, got, grads
    pm._dev.pop(d64, None)
    torch.cuda.empty_cache()

    # ---- 4. main path: TGV 512^3 AB3 ---------------------------------------
    params = SolverParams(Re=1600.0, time_intg="AB3", dt=DT)
    t0 = time.perf_counter()
    case = TGVCase(mesh, params, dtype=torch.float32, monitor_path=None,
                   verbose=False, keep_pressure=False, device=dev)
    check(case._fused_ab is not None, f"{shape} must take the fused sweeps")
    state = case.initial_state()
    torch.cuda.synchronize()
    print(f"[main] TGV {shape} set-up {time.perf_counter() - t0:.1f} s",
          flush=True)
    ts.reset_launch_counts()
    pp.reset_launch_counts()
    state = case.run(n_iters=STEPS, state=state, n_output=1, fresh=True)
    torch.cuda.synchronize()
    counts = {**ts.launch_counts(), **pp.launch_counts()}
    mon = case.monitor.rows
    ke = [r[4] for r in mon]
    ens = [r[1] for r in mon]
    div_max = max(r[2] for r in mon[1:])
    print(f"[main] launches {counts}", flush=True)
    print(f"[main] ke {ke[0]:.10e} -> {ke[-1]:.10e}  enstrophy {ens[0]:.8e}"
          f" -> {ens[-1]:.8e}  div_u_max <= {div_max:.3e} "
          f"(limit {DIV_LIMIT:g})", flush=True)
    want = {name: STEPS * pp.LAUNCHES_PER_CALL.get(name, 1) for name in rows}
    check(counts == want, f"expected launches {want}, got {counts}")
    for name in rows:
        rows[name]["launches"] = counts[name]
    check(all(math.isfinite(x) for x in ke + ens), "non-finite KE/enstrophy")
    check(all(b < a for a, b in zip(ke, ke[1:])), "KE must decrease")
    check(div_max < DIV_LIMIT, f"div_u_max {div_max} >= {DIV_LIMIT}")

    # step time over steps after the first (monitoring off), and the share
    # of the step spent in the sweep chain and in the projection
    times = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = case.step(state)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    step_ms = times[len(times) // 2]
    f = (state["u"], state["v"], state["w"])
    scratch = tuple(tuple(o.clone() for o in p) for p in state["olds"])
    dtc = ti.ab_row(3, DT)
    chain_ms = cuda_ms(lambda: case._fused_ab(*f, scratch, dtc), 10, torch)
    proj_ms = cuda_ms(lambda: case.solver.pressure_correction(
        *f, keep_pressure=False), 10, torch)
    print(f"[main] step {step_ms:.3f} ms (median of 10, host clock)  "
          f"sweeps {chain_ms:.3f} ms ({100 * chain_ms / step_ms:.1f}%)  "
          f"projection {proj_ms:.3f} ms "
          f"({100 * proj_ms / step_ms:.1f}%)", flush=True)
    del case, state, f, scratch
    torch.cuda.empty_cache()

    # ---- 5. slice as a whole: card vs CPU at (128, 128, 256) ---------------
    small = Mesh(SMALL, (2 * math.pi,) * 3, per)
    res = {}
    for d in ("cuda", "cpu"):
        c = TGVCase(small, params, dtype=torch.float32, monitor_path=None,
                    verbose=False, keep_pressure=False, device=d)
        check(c._fused_ab is not None and c.solver._pipe is not None,
              f"{SMALL} must take the fused sweeps and the pipeline")
        s = c.run(n_iters=10, n_output=10)
        res[d] = (s, c.monitor.rows[-1][4])
    du = max(float((res["cuda"][0][k].cpu() - res["cpu"][0][k]).abs().max())
             for k in ("u", "v", "w"))
    ke_rel = abs(res["cuda"][1] - res["cpu"][1]) / abs(res["cpu"][1])
    print(f"[slice] {SMALL} 10 steps card vs CPU: max|du,dv,dw|={du:.3e} "
          f"(<= 1e-5)  KE rel {ke_rel:.3e} (<= 1e-6)", flush=True)
    check(du <= 1e-5, f"card vs CPU velocity difference {du}")
    check(ke_rel <= 1e-6, f"card vs CPU KE difference {ke_rel}")

    # ---- 6. result lines ---------------------------------------------------
    print(json.dumps({"kernels": list(rows.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
