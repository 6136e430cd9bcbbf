"""CLI entry point: ``python -m x3d2_tpu_torch <input.x3d>``.

Counterpart of x3d2_tpu's main program (x3d2_tpu/__main__.py; reference
src/xcompact.f90:48-133): parse the namelist input, build mesh, solver and
case through ``config.make_case``, restore a checkpoint when the input
asks for it, and run the time loop with checkpoints, snapshots and
statistics (io.IOManager). The physical pressure is formed only where the
output needs it, a ``pressure`` output field or statistics (x3d2_tpu
__main__.py:82-84): on a 512^3 TGV that is the slab projection in place
of the three-stage pipeline.

It runs on ``cuda`` unless ``--device`` names another device (the CPU
tests pass ``--device cpu``); with no GPU and no ``--device`` it raises.
A restart appends to monitoring.csv. One process only: ``--mesh`` and an
``nproc_dir`` above 1 raise NotImplementedError (PARALLEL_GAP).

    python -m x3d2_tpu_torch examples/TGV/input.x3d [--dtype f64]
        [--seed N] [--n-iters N] [--device cpu]
"""

from __future__ import annotations

import argparse
import math

PARALLEL_GAP = (
    "the CLI runs one process: a process mesh (--mesh, or nproc_dir above "
    "1) needs the sharded step under torchrun with per-shard checkpoints "
    "(x3d2_tpu's io/sharded.py), which are not ported (ROADMAP Queue 1, "
    "the parallel item: the CLI on a (y, z) process mesh)")


def main(argv=None):
    parser = argparse.ArgumentParser(prog="x3d2_tpu_torch")
    parser.add_argument("input", help="namelist input file (.x3d)")
    parser.add_argument("--dtype", default="f32", choices=["f32", "f64"])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--n-iters", type=int, default=None,
                        help="override the input file's n_iters "
                             "(smoke runs, partial restarts)")
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; raises when no "
                             "GPU is present and none is given)")
    parser.add_argument("--mesh", type=int, nargs="+", metavar="N",
                        help="a process mesh: not ported (raises)")
    args = parser.parse_args(argv)

    import torch

    from .common import resolve_device
    from .config import Config, make_case
    from .io.manager import IOManager

    cfg = Config.from_file(args.input)
    if args.n_iters is not None:
        cfg.solver.n_iters = args.n_iters
    if args.mesh or math.prod(int(p) for p in cfg.domain.nproc_dir) > 1:
        raise NotImplementedError(PARALLEL_GAP)
    device = resolve_device(args.device)
    dtype = torch.float64 if args.dtype == "f64" else torch.float32
    restart = bool(cfg.checkpoint.restart_from_checkpoint)
    # physical pressure only reconstructed when output requests it
    keep_pressure = (cfg.checkpoint.has_output_field("pressure")
                     or cfg.stats.initstat > 0)
    case = make_case(cfg, dtype, seed=args.seed, keep_pressure=keep_pressure,
                     device=device, monitor_append=restart)
    card = (f" ({torch.cuda.get_device_name(device)})"
            if device.type == "cuda" else "")
    print(f"Flow case: {case.name}; grid {cfg.domain.dims_global}; "
          f"{cfg.solver.time_intg}, dt={cfg.solver.dt}, "
          f"Re={cfg.solver.Re}, device {device}{card}, 1 process")
    io_mgr = IOManager(case, cfg.checkpoint, cfg.stats)
    state = io_mgr.handle_restart(case.initial_state())
    case.run(state=state, io_manager=io_mgr, fresh=not restart)
    case.monitor.close()


if __name__ == "__main__":
    main()
