#!/usr/bin/env python3
"""Turbulent-channel physics validation of the port.

    python3 -m x3d2_tpu_torch.tools.validate_channel [n_iters] [sample]
        [--grid NX NY NZ] [--dt DT] [--box LX LZ] [--tag SUFFIX]
        [--out DIR] [--budget SECONDS] [--device cuda|cpu]

The port's counterpart of tools/validate_channel.py. It runs the
reference channel configuration (examples/channel/input.x3d: 128 x 65 x 64,
Re 4200 with the bulk velocity held at 2/3, so Re_b = 2800, a top-bottom
stretched y with beta 0.259065151, RK3, dt 5e-3, float32), tripped to
turbulence by a spanwise rotation (omega 0.12) until t = 25 whatever the
dt, on the card (``--device``, default cuda). Every ``sample`` steps of
the second half of the run it accumulates the mean profiles and Reynolds
stresses, and at the end prints:

- the bulk constraint: mean(u) = sum(u) / cells, held at 2/3 every
  substage (case/channel.f90:59-78);
- Re_tau from the mean profile's wall shear (both walls, one-sided
  differences on the stretched grid);
- the centreline-to-bulk ratio U_c / U_b;
- the u'rms peak in wall units;

each beside the same quantity of validation/channel_re4200.csv (x3d2_tpu's
profiles of this configuration, read, never written) and beside Kim, Moin
and Moser's DNS at Re_b = 2800 (Re_tau ~178, U_c/U_b ~1.16, u'rms peak
~2.65). The profiles and the bulk series are written as
``channel_re4200<tag>.csv`` and ``channel_re4200<tag>_bulk.csv`` under
``--out`` (default build/validation, which git ignores).

``--grid`` and ``--dt`` run the same physical configuration on another
grid; ``--box LX LZ`` sets the streamwise and spanwise box (default the
example's 4 x 2 half-heights; ``--box 12.566 4.189 --grid 192 129 128`` is
KMM's box at KMM-grade resolution). ``--budget`` (or the environment's
X3D2_CHANNEL_BUDGET_S, as the original reads it) is a wall budget in
seconds: after the first 2000 steps the run's rate is known, and n_iters
(and with it the averaging half) shrinks, to no fewer than 4000 steps, so
that the run ends inside the budget with averaged statistics.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

NU = 1.0 / 4200.0
BETA = 0.259065151
# Kim, Moin & Moser (1987) at Re_b = 2800
KMM = {"re_tau": 178.0, "uc_ub": 1.16, "urms_peak": 2.65}
_trapezoid = getattr(np, "trapezoid", None) or np.trapz
REFERENCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                         "..", "validation", "channel_re4200.csv")


def summary(y, U, uu):
    """(Re_tau, U_c / U_b, u'rms peak / u_tau) of mean profiles on y in
    [0, 2] (half-height 1)."""
    dudy_b = (U[1] - U[0]) / (y[1] - y[0])
    dudy_t = (U[-2] - U[-1]) / (y[-1] - y[-2])
    u_tau = float(np.sqrt(NU * 0.5 * (abs(dudy_b) + abs(dudy_t))))
    ub = float(_trapezoid(U, y) / 2.0)
    uc = float(U[len(U) // 2])
    return (u_tau / NU, uc / ub,
            float(np.sqrt(max(float(uu.max()), 0.0)) / u_tau), u_tau)


def reference_summary(path=REFERENCE):
    """The same three quantities from a profiles file this tool (or
    tools/validate_channel.py) wrote: Re_tau is y+ at the centreline (y =
    1), U_c / U_b the centreline U+ over the bulk of U+."""
    a = np.loadtxt(path, delimiter=",", skiprows=1)
    y, yplus, uplus, urms = a[:, 0], a[:, 1], a[:, 2], a[:, 3]
    c = len(y) // 2
    return (float(yplus[c]), float(uplus[c] / (_trapezoid(uplus, y) / 2)),
            float(urms.max()))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="validate_channel")
    ap.add_argument("n_iters", nargs="?", type=int, default=40000)
    ap.add_argument("sample", nargs="?", type=int, default=10)
    ap.add_argument("--grid", type=int, nargs=3, default=(128, 65, 64))
    ap.add_argument("--dt", type=float, default=5e-3)
    ap.add_argument("--box", type=float, nargs=2, default=(4.0, 2.0))
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=os.path.join("build", "validation"))
    ap.add_argument("--budget", type=float, default=float(
        os.environ.get("X3D2_CHANNEL_BUDGET_S", "0")))
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)

    from ..cases import ChannelCase, SolverParams
    from ..common import BC, resolve_device
    from ..config import ChannelConfig
    from ..mesh import Mesh

    device = resolve_device(args.device)
    mesh = Mesh(tuple(args.grid), (args.box[0], 2.0, args.box[1]),
                ((BC.PERIODIC, BC.PERIODIC), (BC.DIRICHLET, BC.DIRICHLET),
                 (BC.PERIODIC, BC.PERIODIC)),
                stretching=("uniform", "top-bottom", "uniform"),
                beta=(1.0, BETA, 1.0))
    params = SolverParams(Re=4200.0, time_intg="RK3", dt=args.dt)
    # the transition trip of the reference example: a spanwise rotation
    # until t = 25 for any dt
    case = ChannelCase(mesh, params, dtype=torch.float32, monitor_path=None,
                       verbose=False, keep_pressure=False, device=device,
                       case_cfg=ChannelConfig(
                           init_noise=(0.125,) * 3, inlet_noise=(0.0,) * 3,
                           rotation=True, omega_rot=0.12,
                           n_rotate=int(round(25.0 / args.dt))))
    ncell = float(np.prod(mesh.global_cell_dims))
    card = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"channel {mesh.dims(0)} box {tuple(mesh.L)} Re 4200 RK3 dt "
          f"{args.dt} float32 on {device} ({card}); n_iters {args.n_iters},"
          f" a sample every {args.sample} steps", flush=True)

    def profiles(state):
        u, v, w = state["u"], state["v"], state["w"]
        ax = (0, 2)
        um, vm, wm = u.mean(ax), v.mean(ax), w.mean(ax)
        # the bulk as define_bc measures it: the vertex sum over the cells
        ub = u.sum() / ncell
        return torch.stack([um, vm, wm, (u * u).mean(ax), (v * v).mean(ax),
                            (w * w).mean(ax), (u * v).mean(ax),
                            ub.expand_as(um)])

    n_iters, sample = args.n_iters, args.sample
    warmup = n_iters // 2
    state = case.initial_state()
    acc, nacc, ub_series = None, 0, []
    t0 = time.perf_counter()
    t_first = None
    checked = False
    it = 0
    while it < n_iters:
        state = case.step(state)
        it += 1
        if it == 1:
            case._sync()
            t_first = time.perf_counter()
            print(f"first step done [{t_first - t0:.1f} s]", flush=True)
        if args.budget and not checked and it >= 2000:
            checked = True
            case._sync()
            rate = (time.perf_counter() - t_first) / (it - 1)
            feasible = it + int(max(0.0, args.budget - (
                time.perf_counter() - t0)) / rate)
            if feasible < n_iters:
                n_iters = max(4000, feasible)
                warmup = n_iters // 2
                print(f"budget {args.budget:.0f} s at {rate * 1e3:.2f} "
                      f"ms/step: n_iters rescaled to {n_iters} (t_end "
                      f"{n_iters * args.dt:.0f})", flush=True)
        if it % sample == 0:
            p = profiles(state).double().cpu().numpy()
            ub_series.append((it * args.dt, p[7, 0]))
            if it > warmup:
                acc = p if acc is None else acc + p
                nacc += 1
            if it % (sample * 200) == 0:
                el = time.perf_counter() - t0
                print(f"it={it}/{n_iters} t={it * args.dt:.1f} "
                      f"ub={p[7, 0]:.6f} [{el:.0f} s, "
                      f"{(time.perf_counter() - t_first) / (it - 1) * 1e3:.3f}"
                      f" ms/step]", flush=True)
    case._sync()
    wall = time.perf_counter() - t0
    if not np.isfinite(acc).all():
        raise SystemExit("non-finite statistics")

    P = acc / nacc
    y = np.asarray(mesh.geo[1].vert_coords, np.float64)
    U = P[0]
    uu = P[3] - P[0] ** 2
    vv = P[4] - P[1] ** 2
    ww = P[5] - P[2] ** 2
    uv = P[6] - P[0] * P[1]
    re_tau, uc_ub, urms_peak, u_tau = summary(y, U, uu)

    os.makedirs(args.out, exist_ok=True)
    out = os.path.join(args.out, f"channel_re4200{args.tag}.csv")
    with open(out, "w") as fh:
        fh.write("y,yplus,Uplus,urms_plus,vrms_plus,wrms_plus,uv_plus\n")
        for j in range(len(y)):
            yw = min(y[j], 2.0 - y[j])
            fh.write(f"{y[j]:.6f},{yw * u_tau / NU:.4f},{U[j] / u_tau:.5f},"
                     f"{np.sqrt(max(uu[j], 0)) / u_tau:.5f},"
                     f"{np.sqrt(max(vv[j], 0)) / u_tau:.5f},"
                     f"{np.sqrt(max(ww[j], 0)) / u_tau:.5f},"
                     f"{uv[j] / u_tau ** 2:.5f}\n")
    with open(os.path.join(args.out, f"channel_re4200{args.tag}_bulk.csv"),
              "w") as fh:
        fh.write("t,ub\n")
        for t, ubv in ub_series:
            fh.write(f"{t:.3f},{ubv:.8f}\n")

    ref = reference_summary()
    print(f"\nwrote {out}")
    print(f"steps {n_iters} (t_end {n_iters * args.dt:g}), statistics over "
          f"{nacc} samples of the second half")
    print(f"bulk constraint: mean(u) = {P[7, 0]:.6f} (target 2/3 = "
          f"0.666667)")
    print(f"Re_tau = {re_tau:.1f} (x3d2_tpu's profiles {ref[0]:.1f}; KMM "
          f"Re_b=2800 ~{KMM['re_tau']:g})")
    print(f"U_c/U_b = {uc_ub:.3f} (x3d2_tpu's {ref[1]:.3f}; KMM "
          f"~{KMM['uc_ub']:g})")
    print(f"u'rms peak = {urms_peak:.2f} u_tau (x3d2_tpu's {ref[2]:.2f}; "
          f"KMM ~{KMM['urms_peak']:g})")
    print(f"wall: {wall:.0f} s for {n_iters} steps "
          f"({(time.perf_counter() - t_first) / max(n_iters - 1, 1) * 1e3:.3f}"
          f" ms/step after the first)", flush=True)


if __name__ == "__main__":
    main()
