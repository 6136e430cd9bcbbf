#!/usr/bin/env python3
"""The divergence the projection leaves in float32 and in float64: a case
from an input file, a few steps at each of several grids, on the CPU with
the plain versions.

    python3 -m x3d2_tpu_torch.tools.div_level INPUT [NX NY NZ ...]
        [--steps N] [--threads T]

Per grid (dims_global overridden; default the input's own) and dtype it
prints div_u_max after each step (monitoring's column) and div_u_mean after
the last. The float32 level is rounding, the float64 one the check that
the projection is exact: the chip smoke run's divergence limits are a few
times the float32 level read off this output at grids below the driven
one, extrapolated (about 3x per halving of the spacing for the smooth
TGV; the cylinder's white inflow-region noise grows faster in y).
"""

import argparse
import time

import torch

from .. import config


def main(argv=None):
    ap = argparse.ArgumentParser(prog="div_level")
    ap.add_argument("input")
    ap.add_argument("dims", type=int, nargs="*",
                    help="grids as NX NY NZ triples")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--threads", type=int, default=2)
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    if len(args.dims) % 3:
        ap.error("grids come as NX NY NZ triples")
    grids = [tuple(args.dims[i:i + 3]) for i in range(0, len(args.dims), 3)]
    for dims in grids or [None]:
        for dtype in (torch.float32, torch.float64):
            cfg = config.Config.from_file(args.input)
            if dims is not None:
                cfg.domain.dims_global = dims
            t0 = time.perf_counter()
            case = config.make_case(cfg, dtype=dtype, monitor_path=None,
                                    verbose=False, keep_pressure=False,
                                    device="cpu")
            case.run(n_iters=args.steps, n_output=1)
            rows = case.monitor.rows
            print(f"{tuple(cfg.domain.dims_global)} {dtype} div_u_max per "
                  f"step {[f'{r[2]:.3e}' for r in rows]} div_u_mean "
                  f"{rows[-1][3]:.3e} ({time.perf_counter() - t0:.1f} s)",
                  flush=True)


if __name__ == "__main__":
    main()
