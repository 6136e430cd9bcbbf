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
A restart appends to monitoring.csv.

On a (y, z) process mesh, ``--mesh NY NZ`` (or ``NX NY NZ`` with NX = 1),
or the input's ``nproc_dir``, one process a rank, started by torchrun
(the env:// rendezvous) or with ``--coordinator host:port`` (a tcp://
rendezvous, RANK and WORLD_SIZE from the environment, and on the card
LOCAL_RANK and LOCAL_WORLD_SIZE, this host's share); distributed with no
mesh given, the rank count is factorised into (y, z) as x3d2_tpu does
(__main__.py:100-106). The transport is chosen before the group exists:
nccl where this host has a card per rank (rank r on cuda:LOCAL_RANK), else
gloo (every rank on cuda:0, or on the CPU). Each rank steps its block
through the sharded step (parallel.make_sharded_step); rank 0 alone
prints and writes the monitoring file, the statistics and the snapshots
(from gathered fields), and every rank writes its shard of a per-shard
checkpoint (io/sharded.py; the global file with ``sharded_io = .false.``).
A restart reads a per-shard checkpoint of any mesh shape, or a global
file, onto the rank's blocks. An x-decomposed mesh (NX > 1) raises
NotImplementedError (X_MESH_GAP), and so does the channel on a mesh: its
stretched y has no repencilled projection (GSPMD_GAP).

    python -m x3d2_tpu_torch examples/TGV/input.x3d [--dtype f64]
        [--seed N] [--n-iters N] [--device cpu] [--mesh NY NZ]
        [--coordinator host:port]
    torchrun --standalone --nproc_per_node 4 -m x3d2_tpu_torch \\
        examples/TGV/input.x3d --mesh 2 2
"""

from __future__ import annotations

import argparse
import math


def _mesh_of(args, cfg):
    """The requested (nproc_y, nproc_z), or None: --mesh, else the input's
    nproc_dir; NX > 1 raises."""
    from .parallel.topo import X_MESH_GAP

    mesh = args.mesh
    if mesh is not None and len(mesh) not in (2, 3):
        raise SystemExit("--mesh takes NY NZ or NX NY NZ")
    npd = tuple(int(p) for p in cfg.domain.nproc_dir)
    if not mesh and math.prod(npd) > 1:
        mesh = npd
    if mesh and len(mesh) == 3:
        if mesh[0] > 1:
            raise NotImplementedError(X_MESH_GAP)
        mesh = mesh[1:]
    return tuple(mesh) if mesh else None


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
                        help="a process mesh: NY NZ (x whole), or NX NY NZ "
                             "with NX = 1; one process a rank")
    parser.add_argument("--coordinator", default=None,
                        help="host:port of rank 0's tcp:// rendezvous "
                             "(RANK and WORLD_SIZE from the environment, "
                             "and on the card LOCAL_RANK and "
                             "LOCAL_WORLD_SIZE); torchrun's env:// without "
                             "it")
    args = parser.parse_args(argv)

    import torch
    import torch.distributed as dist

    from .common import resolve_device
    from .config import Config
    from .parallel import multihost

    cfg = Config.from_file(args.input)
    if args.n_iters is not None:
        cfg.solver.n_iters = args.n_iters
    mesh = _mesh_of(args, cfg)
    device = resolve_device(args.device)
    backend = multihost.transport(device)
    own_group = not dist.is_initialized()
    distributed = multihost.maybe_init_distributed(
        backend, coordinator=args.coordinator)
    try:
        if distributed and mesh is None:
            # the rank count factorised into (y, z) (x3d2_tpu
            # __main__.py:100-106, the reference's nproc_dir fallback)
            n = dist.get_world_size()
            ny = int(math.isqrt(n))
            while n % ny:
                ny -= 1
            mesh = (ny, n // ny)
        if mesh is not None and math.prod(mesh) == 1 and not distributed:
            mesh = None
        if distributed and dist.get_backend() == "nccl":
            device = torch.device("cuda", multihost.local_rank())
        _run(cfg, args, mesh, device, backend if distributed else None)
    finally:
        if distributed and own_group:
            dist.destroy_process_group()


def _run(cfg, args, mesh, device, backend):
    import torch

    from .config import make_case
    from .io.manager import IOManager
    from .parallel import multihost

    primary = multihost.is_primary()
    name = cfg.domain.flow_case_name.lower()
    if mesh is not None and name == "channel":
        from .parallel.topo import GSPMD_GAP
        raise NotImplementedError(GSPMD_GAP.format(
            what="the channel's projection (its stretched y has no "
                 "repencilled projection)"))
    dtype = torch.float64 if args.dtype == "f64" else torch.float32
    restart = bool(cfg.checkpoint.restart_from_checkpoint)
    # physical pressure only reconstructed when output requests it
    keep_pressure = (cfg.checkpoint.has_output_field("pressure")
                     or cfg.stats.initstat > 0)
    case = make_case(cfg, dtype, seed=args.seed, keep_pressure=keep_pressure,
                     device=device, monitor_append=restart, verbose=primary)
    if primary:
        card = (f" ({torch.cuda.get_device_name(device)})"
                if device.type == "cuda" else "")
        procs = ("1 process" if mesh is None else
                 f"{math.prod(mesh)} processes on a {mesh} mesh over "
                 f"{backend}")
        print(f"Flow case: {case.name}; grid {cfg.domain.dims_global}; "
              f"{cfg.solver.time_intg}, dt={cfg.solver.dt}, "
              f"Re={cfg.solver.Re}, device {device}{card}, {procs}",
              flush=True)
    if mesh is None:
        state = case.initial_state()
        run_case = case
    else:
        from .parallel import make_process_mesh, make_sharded_step
        pmesh = make_process_mesh(*mesh, backend=backend, device=device)
        _, state = make_sharded_step(case, pmesh)
        # the working case steps the rank's block, reduces the monitoring
        # over the ranks and carries the mesh to the IO managers
        run_case = case._sharded_case
    io_mgr = IOManager(run_case, cfg.checkpoint, cfg.stats)
    state = io_mgr.handle_restart(state)
    run_case.run(state=state, io_manager=io_mgr, fresh=not restart)
    run_case.monitor.close()


if __name__ == "__main__":
    main()
