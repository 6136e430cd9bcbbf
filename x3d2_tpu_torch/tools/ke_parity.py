#!/usr/bin/env python3
"""Kinetic-energy curve parity: float32 TGV trajectories on the card
against a float64 one.

    python3 -m x3d2_tpu_torch.tools.ke_parity ref [--dims NX NY NZ]
        [--t-end T] [--device cuda|cpu]
    python3 -m x3d2_tpu_torch.tools.ke_parity run [--compensated] ...
    python3 -m x3d2_tpu_torch.tools.ke_parity report [--ref FILE] ...

The port's counterpart of tools/ke_parity.py: TGV, box 2 pi, Re 1600, AB3,
dt 1e-3, keep_pressure=False, from t = 0 to T (default 14, 14000 steps).

- ``ref``: float64 through the einsum paths (X3D2_PALLAS=0: the dense
  transport products and the transform-folded projection), on the card
  or the CPU.
- ``run``: float32 on the card, on the kernels the case takes, tagged by
  X3D2_MATMUL_PRECISION ("high", the default, or "highest": the W = 32
  sweeps), ``--compensated`` (SolverParams.compensated, Kahan stepping)
  and X3D2_PALLAS=0 (the float32 einsum paths, no kernel):
  ``f32_<precision>[_kahan][_einsum]``.
- ``report``: each saved float32 curve of the grid against the reference
  (``--ref``, default this grid's own ``ref64`` curve): the largest
  |KE - KE_ref| / KE_ref(0) and its time, against the 1e-6 budget.

KE = 0.5 mean(u^2 + v^2 + w^2) is sampled every ``--sample`` steps
(default 20, as the original) and reduced on the host in float64 (a
float32 mean on the card carries ~1e-7 of rounding, the size of what is
measured). Curves are written as ``keparity_<grid>_<tag>.npz`` (steps,
ke, ms_per_step) under ``--out`` (default ``build/keparity``, which git
ignores); ``<grid>`` is the edge of a cubic grid (``128``, the name of
the committed ``validation/keparity_128_ref64.npz``) or NXxNYxNZ.
"""

from __future__ import annotations

import argparse
import glob
import math
import os
import time

import numpy as np
import torch

DT = 1e-3
BUDGET = 1e-6


def grid_label(dims) -> str:
    dims = tuple(int(d) for d in dims)
    return str(dims[0]) if len(set(dims)) == 1 else "x".join(map(str, dims))


def ke_host_f64(state) -> float:
    """KE of the state's velocities, reduced on the host in float64."""
    tot = 0.0
    for k in ("u", "v", "w"):
        a = state[k].detach().to("cpu", torch.float64)
        tot += float((a * a).sum())
    return 0.5 * tot / state["u"].numel()


def run_curve(dims, dtype, compensated, device, t_end, sample=20,
              log=print):
    """The KE curve of TGV at `dims` from t = 0 to t_end: (steps, ke,
    ms per step on the host clock, the case). The switches in the
    environment (X3D2_PALLAS, X3D2_MATMUL_PRECISION, ...) are read when
    the case is built, here."""
    from ..cases import SolverParams, TGVCase
    from ..common import BC
    from ..mesh import Mesh

    mesh = Mesh(tuple(dims), (2 * math.pi,) * 3,
                ((BC.PERIODIC, BC.PERIODIC),) * 3)
    params = SolverParams(Re=1600.0, time_intg="AB3", dt=DT,
                          compensated=compensated)
    case = TGVCase(mesh, params, dtype=dtype, monitor_path=None,
                   verbose=False, keep_pressure=False, device=device)
    state = case.initial_state()
    steps, kes = [0], [ke_host_f64(state)]
    nsteps = int(round(t_end / DT))
    t0 = time.perf_counter()
    for it in range(1, nsteps + 1):
        state = case.step(state)
        if it % sample == 0:
            steps.append(it)
            kes.append(ke_host_f64(state))
            if it % (sample * 50) == 0 or it == nsteps:
                el = time.perf_counter() - t0
                log(f"  step {it}/{nsteps} ke={kes[-1]:.12f} [{el:.1f} s, "
                    f"{el / it * 1e3:.3f} ms/step]")
    if state["u"].is_cuda:
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / max(nsteps, 1) * 1e3
    return np.asarray(steps), np.asarray(kes), ms, case


def compare(steps, ke, ref_steps, ref_ke):
    """(max |KE - KE_ref| / KE_ref(0), its time, samples compared) over
    the samples both curves hold, at the same steps."""
    m = min(len(steps), len(ref_steps))
    if not (np.asarray(steps[:m]) == np.asarray(ref_steps[:m])).all():
        raise ValueError("the curves are sampled at different steps")
    d = np.abs(np.asarray(ke[:m]) - np.asarray(ref_ke[:m]))
    i = int(np.argmax(d))
    return float(d[i] / ref_ke[0]), float(ref_steps[i] * DT), m


def tag_of(compensated: bool) -> str:
    prec = os.environ.get("X3D2_MATMUL_PRECISION", "high")
    return f"f32_{prec}" + ("_kahan" if compensated else "") + (
        "_einsum" if os.environ.get("X3D2_PALLAS", "1") == "0" else "")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="ke_parity")
    ap.add_argument("mode", choices=("ref", "run", "report"))
    ap.add_argument("--dims", type=int, nargs=3, default=(128, 128, 128))
    ap.add_argument("--t-end", type=float, default=14.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--compensated", action="store_true")
    ap.add_argument("--sample", type=int, default=20)
    ap.add_argument("--out", default=os.path.join("build", "keparity"))
    ap.add_argument("--ref", default=None,
                    help="reference curve for report (default: the grid's "
                         "ref64 curve under --out)")
    args = ap.parse_args(argv)
    label = grid_label(args.dims)
    os.makedirs(args.out, exist_ok=True)

    def path(tag):
        return os.path.join(args.out, f"keparity_{label}_{tag}.npz")

    if args.mode in ("ref", "run"):
        if args.mode == "ref":
            os.environ["X3D2_PALLAS"] = "0"
            dtype, comp, tag = torch.float64, False, "ref64"
        else:
            if not args.device.startswith("cuda"):
                raise SystemExit("run: the float32 curve is the card's")
            dtype, comp, tag = torch.float32, args.compensated, \
                tag_of(args.compensated)
        print(f"[{tag}] TGV {label} Re 1600 AB3 dt {DT} to t = "
              f"{args.t_end} on {args.device}", flush=True)
        steps, ke, ms, _ = run_curve(args.dims, dtype, comp, args.device,
                                     args.t_end, args.sample,
                                     log=lambda s: print(s, flush=True))
        np.savez(path(tag), steps=steps, ke=ke, ms_per_step=ms)
        print(f"[{tag}] wrote {path(tag)} ({len(steps)} samples, "
              f"{ms:.3f} ms/step)", flush=True)
        return 0

    ref_file = args.ref or path("ref64")
    ref = np.load(ref_file)
    rs, rke = ref["steps"], ref["ke"]
    print(f"KE-curve parity, TGV {label} Re 1600, against {ref_file} "
          f"(KE_0 = {rke[0]:.6f}, t = [0, {rs[-1] * DT:g}]):")
    print(f"{'variant':>22s} {'max|dKE|/KE0':>14s} {'at t':>7s} "
          f"{'t_end':>6s} {'<= 1e-6':>8s}")
    for f in sorted(glob.glob(path("f32_*"))):
        d = np.load(f)
        rel, t, m = compare(d["steps"], d["ke"], rs, rke)
        tag = os.path.basename(f)[len(f"keparity_{label}_"):-4]
        print(f"{tag:>22s} {rel:14.3e} {t:7.2f} {rs[m - 1] * DT:6.2f} "
              f"{'yes' if rel <= BUDGET else 'no':>8s}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
