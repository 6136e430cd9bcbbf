"""Drive the sharded TGV step on ranks of this host, and report.

    python3 -m x3d2_tpu_torch.tools.shard_run --dims 128 256 256 \\
        --mesh 2 2 --steps 3 [--device cpu|cuda] [--backend gloo|nccl] \\
        [--dtype float64] [--species 2] [--warmup 2]

Spawns nproc_y * nproc_z ranks (parallel/multihost.py spawn), each of which
builds the case (TGVCase, AB3), makes the sharded step
(parallel/topo.py make_sharded_step) and steps it, then gathers u, v, w
(and phi) to rank 0. With --device cuda and gloo every rank runs on the
one card, cuda:0 (the halo planes and all-to-all buffers staged through
host memory); with nccl each rank takes cuda:<rank>. Prints, per rank,
the kernel launches of the timed steps, the ms per step (host clock, the
device synchronised) and the share in the halo exchanges and the
all-to-alls, and the global observables of the last state. The switches
are the environment's (X3D2_MATMUL_PRECISION=highest for the HIGHEST
mode), which the spawned ranks inherit.
"""

from __future__ import annotations

import argparse
import time


def tgv_rank(rank, world, spec):
    """One rank of one sharded TGV run (_tgv_run), its switches (spec's
    env) set while it runs."""
    from ..common import env_set

    with env_set(spec.get("env", {})):
        return _tgv_run(rank, world, spec)


def tgv_ranks(rank, world, specs):
    """One rank of several sharded TGV runs in turn (one process group,
    one start-up): the list of tgv_rank's results."""
    import torch

    out = []
    for spec in specs:
        out.append(tgv_rank(rank, world, spec))
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return out


def _tgv_run(rank, world, spec):
    """One rank of a sharded TGV run: spec holds dims, mesh (nproc_y,
    nproc_z), steps, and optionally dtype ("float32"), device ("cuda"),
    backend ("gloo"), time_intg ("AB3"; "RK3" needs X3D2_FUSED_RK=0 in
    env where the case would fuse it), n_species (0) with pr, env
    (switches, set by tgv_rank), keep_pressure (False), warmup (0: steps
    before the counted and timed ones), gather (True), state (a global
    numpy state to start from, convert.py's structure), reference (False:
    rank 0 then also runs the single-card step, _single_card, and compares
    its gathered state with it, _compare; "own": the single-card step with
    the run's own switches and keep_pressure, for the chains the sharded
    step runs on gathered fields). Returns a dict: the launch counts of the
    counted steps, ms/step, the halo and all-to-all seconds, the
    observables of the last state, the branches taken (and the repencilled
    projection's mid: mid_local, mid_tiled or mid_einsum; the gathered
    chains: the fused RK chain, the carried step), the peak of the rank's
    device memory in GiB (None off the card), the seconds of the run's
    stages (set-up, warm-up, the timed steps, the gather, rank 0's
    reference), and on rank 0 the gathered fields as numpy under "state",
    or with a reference, in their place, the comparison under "compare"."""
    import math

    import torch

    from ..cases import SolverParams, TGVCase
    from ..common import BC
    from ..convert import state_to_numpy_gathered
    from ..mesh import Mesh
    from ..ops import operator_apply as oa
    from ..ops import species_sweep as spm
    from ..ops import transeq_sweep as ts
    from ..ops import x_apply_manual as xm
    from .. import parallel

    t_start = time.perf_counter()
    dtype = getattr(torch, spec.get("dtype", "float32"))
    backend = spec.get("backend", "gloo")
    device = spec.get("device", "cuda")
    if device == "cuda" and backend == "gloo":
        device = "cuda:0"
    pmesh = parallel.make_process_mesh(*spec["mesh"], backend=backend,
                                       device=None if backend == "nccl"
                                       else device)
    nsp = spec.get("n_species", 0)
    params = SolverParams(Re=1600.0, time_intg=spec.get("time_intg", "AB3"),
                          dt=1e-3, n_species=nsp,
                          pr_species=tuple(spec.get("pr", ())))
    mesh = Mesh(tuple(spec["dims"]), (2 * math.pi,) * 3,
                ((BC.PERIODIC, BC.PERIODIC),) * 3)
    case = TGVCase(mesh, params, dtype=dtype, monitor_path=None,
                   verbose=False, keep_pressure=spec.get("keep_pressure",
                                                         False),
                   device=pmesh.device)
    step, st = parallel.make_sharded_step(case, pmesh)
    if "state" in spec:
        # start from a given global state (x3d2_tpu's, as numpy)
        from ..convert import state_from_numpy_sharded
        st = state_from_numpy_sharded(spec["state"], pmesh,
                                      device=pmesh.device)
    on_card = pmesh.device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(pmesh.device)) \
        if on_card else (lambda: None)
    if on_card:
        torch.cuda.reset_peak_memory_stats(pmesh.device)
    sync()
    stages = {"setup": time.perf_counter() - t_start}
    t0 = time.perf_counter()
    for _ in range(spec.get("warmup", 0)):
        st = step(st)
    sync()
    stages["warmup"] = time.perf_counter() - t0
    for mod in (ts, spm, oa, xm):
        mod.reset_launch_counts()
    pmesh.timing = True
    torch.distributed.barrier(group=pmesh.groups["world"])
    t0 = time.perf_counter()
    for _ in range(spec["steps"]):
        st = step(st)
    sync()
    seconds = time.perf_counter() - t0
    steps = max(spec["steps"], 1)
    pmesh.timing = False
    counts = {**ts.launch_counts(), **spm.launch_counts(),
              **oa.launch_counts(), **xm.launch_counts()}
    rp = getattr(case._sharded_solver, "_repencil_pressure", None)
    obs = {k: float(v) for k, v in case._sharded_case.monitor.fn(
        st["u"], st["v"], st["w"]).items()}
    out = {"rank": rank, "counts": counts, "obs": obs,
           "ms_per_step": seconds * 1e3 / steps,
           "comm_ms_per_step": {k: v * 1e3 / steps
                                for k, v in pmesh.comm_seconds.items()},
           "device": str(pmesh.device), "backend": backend,
           "solver": {k: getattr(case._sharded_solver, k, None) is not None
                      for k in ("_sharded_transeq", "_sharded_species",
                                "_repencil_pressure")}
           | {"_halo_mode": bool(case._sharded_solver._halo_mode)},
           "dense_mid": rp is not None and rp.mats.dense,
           "mid": None if rp is None else rp.mid.__name__,
           "gathered": {"fused_rk": case._sharded_case._fused_rk is not None,
                        "d2c": "rhsp" in st},
           "peak_gib": (torch.cuda.max_memory_allocated(pmesh.device) / 2**30
                        if on_card else None),
           "seconds": stages}
    stages["steps"] = seconds
    names = ("u", "v", "w", "p") + (("phi",) if nsp else ())
    if spec.get("gather", True):
        t0 = time.perf_counter()
        g = state_to_numpy_gathered({**{k: st[k] for k in names + ("istep",)},
                                     "olds": ()}, pmesh, mesh)
        if rank == 0:
            out["state"] = {k: g[k] for k in names}
        stages["gather"] = time.perf_counter() - t0
    if spec.get("reference") and rank == 0:
        del step, st, case, rp
        if pmesh.device.type == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ref = _single_card(
            mesh, params, dtype, pmesh.device,
            spec.get("warmup", 0) + spec["steps"],
            tuple(k for k in names
                  if k != "p" or spec.get("keep_pressure", False)),
            own=(spec.get("keep_pressure", False)
                 if spec["reference"] == "own" else None))
        stages["reference"] = time.perf_counter() - t0
        out["compare"] = _compare(out.pop("state"), ref)
    return out


def _compare(got, ref):
    """The gathered state against the reference, as floats: max |got - ref|
    per field of the reference, max |u| of the reference (the scale),
    whether both are finite, the largest max |u|, |v|, |w| of the reference
    and, with p, max |p|."""
    import numpy as np

    out = {"diffs": {k: float(np.abs(got[k] - ref[k]).max()) for k in ref},
           "scale": float(np.abs(ref["u"]).max()),
           "finite": all(bool(np.isfinite(got[k]).all())
                         and bool(np.isfinite(ref[k]).all()) for k in ref),
           "vel_max": max(float(np.abs(ref[k]).max())
                          for k in ("u", "v", "w"))}
    if "p" in ref:
        out["p_max"] = float(np.abs(ref["p"]).max())
    return out


def _single_card(mesh, params, dtype, device, steps, names, own=None):
    """The global state after `steps` single-card steps of the same
    arithmetic as the sharded step (the unfused AB update, the one-field
    parity x stage and the mid with q: X3D2_FUSED_AB=0, X3D2_MERGED_X=0,
    keep_pressure=True; the run's other switches, set by tgv_rank), as
    numpy; with `own` (the run's keep_pressure) the case of the run's own
    switches. Built in a rank's process, so that its host-built operators
    are the ranks' own bits: the float64 transforms from LAPACK differ in
    their last bits with the BLAS thread count."""
    from ..cases import TGVCase
    from ..common import env_set

    env = {} if own is not None else {"X3D2_FUSED_AB": "0",
                                      "X3D2_MERGED_X": "0"}
    with env_set(env):
        case = TGVCase(mesh, params, dtype=dtype, monitor_path=None,
                       verbose=False, keep_pressure=own is None or own,
                       device=device)
        st = case.initial_state()
        for _ in range(steps):
            st = case.step(st)
    return {k: st[k].cpu().numpy() for k in names}


def run(spec, workdir=None, threads=1):
    """Spawn the ranks of spec["mesh"] on this host (gloo, or nccl with
    spec["backend"]) and return their results (tgv_rank)."""
    return run_many([spec], workdir=workdir, threads=threads)[0]


def run_many(specs, workdir=None, threads=1):
    """Several runs on one set of ranks (their meshes of one size and one
    backend): per spec the list of the ranks' results."""
    from ..parallel.multihost import spawn

    worlds = {s["mesh"][0] * s["mesh"][1] for s in specs}
    backends = {s.get("backend", "gloo") for s in specs}
    if len(worlds) != 1 or len(backends) != 1:
        raise ValueError("one rank count and one backend for all runs")
    per_rank = spawn(tgv_ranks, worlds.pop(), (list(specs),),
                     workdir=workdir, backend=backends.pop(),
                     threads=threads)
    return [[r[i] for r in per_rank] for i in range(len(specs))]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dims", type=int, nargs=3, default=(128, 256, 256))
    ap.add_argument("--mesh", type=int, nargs=2, default=(2, 2))
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--warmup", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default="gloo")
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--species", type=int, default=0)
    args = ap.parse_args(argv)
    spec = {"dims": args.dims, "mesh": args.mesh, "steps": args.steps,
            "warmup": args.warmup, "device": args.device,
            "backend": args.backend, "dtype": args.dtype,
            "n_species": args.species, "pr": (0.7, 1.0)[:args.species],
            "gather": False}
    for r in run(spec, threads=None):
        print(f"[rank {r['rank']} {r['device']} {r['backend']}] "
              f"{r['ms_per_step']:.3f} ms/step, halo "
              f"{r['comm_ms_per_step']['halo']:.3f} ms, all-to-all "
              f"{r['comm_ms_per_step']['a2a']:.3f} ms; launches "
              f"{r['counts']}; {r['obs']}")


if __name__ == "__main__":
    main()
