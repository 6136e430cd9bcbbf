"""ms/step of TGV paths on the card, for one checkout's package.

    python3 -m x3d2_tpu_torch.tools.path_ms [--dims NX NY NZ]
        [--paths main M K HK D R] [--steps N] [--split]

Paths (AB3, Re 1600, dt 1e-3, float32, as chip_smoke.py drives them):
main (keep_pressure=False), M (X3D2_MERGED_X=0, keep_pressure=True: the
one-field x applies x_pfwd and x_pinv[sub]), K (compensated stepping:
pressure_grads' x_pinv), HK (K in the HIGHEST mode,
X3D2_MATMUL_PRECISION=highest), D (X3D2_D2C=1: stage C with the carry),
R (RK3, keep_pressure=False), B (keep_pressure=True: the slab
projection), S (two scalars, Prandtl numbers 0.7 and 1: the species
sweeps), H (X3D2_BF16_OLDS=1: the bfloat16 history). Each path's case is
built with its
switches, stepped 3 times, then timed over N steps (default 10) by the
host clock around each step with the device synchronised; prints one
JSON line: the card's name and power limit, the package's directory, and
per path the median, fastest and slowest ms/step. With --split also the
host's side of a step and of the pipeline's stages, to tell a host-bound
step from a device-bound one: per path "host_ms", the median host time
for case.step to return (enqueued after a synchronize), and "b2b_ms", N
steps enqueued back to back between two synchronizes, per step; and
where the path projects through pipe3, per stage (pipe_a, pipe_b, pipe_c
on the step's fields and the case's own operators) the single call, the
device ms a call back to back and the host µs a call
(tools/prof_xparity.py's timings, 50 calls).

To time another checkout's package (say the parent unpacked by `git
archive` into build/parent), run this file from that checkout's root
with PYTHONPATH=.: `cd build/parent && PYTHONPATH=. python3
../../x3d2_tpu_torch/tools/path_ms.py`; the script needs nothing of its
own checkout. Exits 2 without a card.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import torch

PATHS = {"main": ({}, {}, False),
         "M": ({"X3D2_MERGED_X": "0"}, {}, True),
         "K": ({}, {"compensated": True}, False),
         "HK": ({"X3D2_MATMUL_PRECISION": "highest"}, {"compensated": True},
                False),
         "D": ({"X3D2_D2C": "1"}, {}, False),
         "R": ({}, {"time_intg": "RK3"}, False),
         "B": ({}, {}, True),
         "S": ({}, {"n_species": 2, "pr_species": (0.7, 1.0)}, False),
         "H": ({"X3D2_BF16_OLDS": "1"}, {}, False)}
SWITCHES = ("X3D2_MERGED_X", "X3D2_MATMUL_PRECISION", "X3D2_D2C",
            "X3D2_BF16_OLDS")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dims", type=int, nargs=3, default=[512, 512, 512])
    ap.add_argument("--paths", nargs="+", default=["M", "K", "HK"],
                    choices=sorted(PATHS))
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--split", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: path_ms times steps on the card",
              file=sys.stderr)
        return 2
    import os

    import x3d2_tpu_torch
    from x3d2_tpu_torch.cases import SolverParams, TGVCase
    from x3d2_tpu_torch.common import BC, env_set
    from x3d2_tpu_torch.mesh import Mesh

    for key in SWITCHES:
        os.environ.pop(key, None)
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()
    per = ((BC.PERIODIC, BC.PERIODIC),) * 3
    out = {"card": card[0] if card else None,
           "package": os.path.dirname(x3d2_tpu_torch.__file__),
           "dims": args.dims, "paths": {}}
    for name in args.paths:
        env, kw, keep = PATHS[name]
        with env_set(env):
            case = TGVCase(Mesh(tuple(args.dims), (2 * math.pi,) * 3, per),
                           SolverParams(**{"Re": 1600.0, "time_intg": "AB3",
                                           "dt": 1e-3, **kw}),
                           dtype=torch.float32, monitor_path=None,
                           verbose=False, keep_pressure=keep, device=dev)
            state = case.initial_state()
            for _ in range(3):
                state = case.step(state)
            times = []
            for _ in range(args.steps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state = case.step(state)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            times.sort()
            res = {"median": times[len(times) // 2], "fastest": times[0],
                   "slowest": times[-1]}
            if args.split:
                state, res["host_ms"], res["b2b_ms"] = split(case, state,
                                                             args.steps)
                pipe = case.solver._pipe
                if pipe is not None and "rhsp" not in state:
                    res["stages"] = stages(pipe.mats, state)
        out["paths"][name] = res
        del case, state
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


def split(case, state, steps):
    """(state, median host ms for a step to return, ms a step of `steps`
    steps enqueued back to back)."""
    host = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = case.step(state)
        host.append((time.perf_counter() - t0) * 1e3)
    host.sort()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state = case.step(state)
    torch.cuda.synchronize()
    return state, host[len(host) // 2], \
        (time.perf_counter() - t0) * 1e3 / steps


def stages(pm, state):
    """pipe3's stages on the state's velocity and the operator set pm,
    each timed as tools/prof_xparity.py times a launch."""
    from x3d2_tpu_torch.ops import pressure_pipe as pp
    from x3d2_tpu_torch.tools.prof_xparity import timings

    u, v, w = state["u"], state["v"], state["w"]
    a, e = pp.pipe_a(u, v, w, pm)
    X, Y = pp.pipe_b(a, e, pm)
    return {"pipe_a": timings(lambda: pp.pipe_a(u, v, w, pm), 50),
            "pipe_b": timings(lambda: pp.pipe_b(a, e, pm), 50),
            "pipe_c": timings(lambda: pp.pipe_c(X, Y, u, v, w, pm), 50)}


if __name__ == "__main__":
    sys.exit(main())
