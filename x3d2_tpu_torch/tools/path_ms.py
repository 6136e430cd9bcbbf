"""ms/step of TGV paths on the card, for one checkout's package.

    python3 -m x3d2_tpu_torch.tools.path_ms [--dims NX NY NZ]
        [--paths main M K HK] [--steps N]

Paths (AB3, Re 1600, dt 1e-3, float32, as chip_smoke.py drives them):
main (keep_pressure=False), M (X3D2_MERGED_X=0, keep_pressure=True: the
one-field x applies x_pfwd and x_pinv[sub]), K (compensated stepping:
pressure_grads' x_pinv), HK (K in the HIGHEST mode,
X3D2_MATMUL_PRECISION=highest). Each path's case is built with its
switches, stepped 3 times, then timed over N steps (default 10) by the
host clock around each step with the device synchronised; prints one
JSON line: the card's name and power limit, the package's directory, and
per path the median, fastest and slowest ms/step.

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
                False)}
SWITCHES = ("X3D2_MERGED_X", "X3D2_MATMUL_PRECISION")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dims", type=int, nargs=3, default=[512, 512, 512])
    ap.add_argument("--paths", nargs="+", default=["M", "K", "HK"],
                    choices=sorted(PATHS))
    ap.add_argument("--steps", type=int, default=10)
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
                           SolverParams(Re=1600.0, time_intg="AB3", dt=1e-3,
                                        **kw),
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
        out["paths"][name] = {"median": times[len(times) // 2],
                              "fastest": times[0], "slowest": times[-1]}
        del case, state
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
