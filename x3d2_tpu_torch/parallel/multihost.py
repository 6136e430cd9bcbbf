"""Multi-process execution: the process group, and a spawn helper.

Counterpart of x3d2_tpu.parallel.multihost (the reference's MPI ranks,
src/mesh.f90:160-194): one process per rank runs the same sharded step
(parallel/topo.py), and ranks exchange halo planes and all-to-all
transposes explicitly over torch.distributed. Host-side output is written
by rank 0 only (io/monitoring.py).

Initialisation reads torchrun's variables, ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` (the ``env://``
rendezvous), or takes them as arguments. A single process is a no-op.
``spawn`` starts `world` ranks on this host, each initialised through a
``FileStore`` in a directory of the caller's (no port to collide on), and
returns what each rank's function returned.
"""

from __future__ import annotations

import os
import traceback

import torch
import torch.distributed as dist

from ..common import env_set


def transport(device) -> str:
    """The backend for ranks whose fields live on `device`: "nccl" where
    the card count covers this host's ranks (LOCAL_WORLD_SIZE; rank on
    cuda:LOCAL_RANK), else "gloo" (on the card, every rank on cuda:0, its
    exchanges staged through host memory). torchrun sets both; a run of
    more than one process on the card without them (a --coordinator
    launch) raises: WORLD_SIZE does not say how many ranks share a host."""
    if torch.device(device).type != "cuda":
        return "gloo"
    if int(os.environ.get("WORLD_SIZE") or 1) > 1 and not (
            "LOCAL_WORLD_SIZE" in os.environ and "LOCAL_RANK" in os.environ):
        raise ValueError("a multi-process run on the card needs this host's "
                         "rank count and this process's place on it: set "
                         "LOCAL_WORLD_SIZE and LOCAL_RANK")
    ranks = int(os.environ.get("LOCAL_WORLD_SIZE") or 1)
    return "nccl" if torch.cuda.device_count() >= ranks > 1 else "gloo"


def maybe_init_distributed(backend="gloo", init_method=None,
                           world_size=None, rank=None, store=None,
                           coordinator=None) -> bool:
    """Initialise the default process group when more than one process is
    configured (arguments, else torchrun's RANK and WORLD_SIZE with the
    env:// rendezvous of MASTER_ADDR and MASTER_PORT; `coordinator`
    "host:port" takes the tcp:// rendezvous there). Returns True when
    running multi-process, False (a no-op) for a single process. An
    explicit rendezvous without a world size or rank raises: N independent
    runs would write over each other's output."""
    if coordinator is not None:
        init_method = f"tcp://{coordinator}"
    explicit = init_method is not None or store is not None
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "0") or 0)
    if rank is None and "RANK" in os.environ:
        rank = int(os.environ["RANK"])
    if world_size <= 1:
        if explicit:
            raise ValueError("a rendezvous was given but the world size is "
                             f"{world_size}: set WORLD_SIZE and RANK")
        return False
    if rank is None:
        raise ValueError(f"a world of {world_size} needs this process's "
                         "rank (RANK)")
    if dist.is_initialized():
        return True
    kw = {"store": store} if store is not None else {
        "init_method": init_method or "env://"}
    dist.init_process_group(backend, world_size=world_size, rank=rank, **kw)
    return True


def local_rank() -> int:
    """This process's rank on its host (torchrun's LOCAL_RANK; else the
    global rank)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() if dist.is_initialized() else 0


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    return process_index() == 0


def gather_global(t, pmesh=None, mesh=None):
    """The whole field of a rank's block `t` (x3d2_tpu gather_global,
    multihost.py:65-76). Collective on a mesh of more than one rank: every
    rank calls it and every rank gets the field (topo.gather_tensor;
    `mesh`, the case's Mesh, gives its global extents). A single process
    gets `t` back untouched."""
    if pmesh is None or pmesh.size == 1:
        return t
    from .topo import gather_tensor, global_shape
    return gather_tensor(pmesh, t, global_shape(pmesh, mesh, tuple(t.shape)))


def _rank_main(rank, world, fn, args, workdir, backend, threads):
    """One spawned rank: the process group through the FileStore, fn, its
    result saved for the parent."""
    if threads:
        torch.set_num_threads(threads)
    os.environ["RANK"], os.environ["WORLD_SIZE"] = str(rank), str(world)
    os.environ["LOCAL_RANK"], os.environ["LOCAL_WORLD_SIZE"] = (str(rank),
                                                                str(world))
    store = dist.FileStore(os.path.join(workdir, "store"), world)
    maybe_init_distributed(backend, store=store, world_size=world, rank=rank)
    try:
        out = fn(rank, world, *args)
        torch.save(out, os.path.join(workdir, f"result-{rank}.pt"))
    except BaseException:
        with open(os.path.join(workdir, f"error-{rank}.txt"), "w") as fh:
            fh.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def spawn(fn, world, args=(), workdir=None, backend="gloo", threads=1):
    """Run fn(rank, world, *args) in `world` new processes on this host,
    each with the default process group initialised (`backend`, through a
    FileStore under `workdir`, which must exist and be empty of a previous
    run's store), and return the list of what each returned. fn and its
    arguments must be picklable (a module-level function). A rank that
    raises fails the call: its traceback is in the RuntimeError.
    `threads`: torch's intra-op and the BLAS threads per rank (None leaves
    the defaults)."""
    import tempfile

    import torch.multiprocessing as mp

    own = workdir is None
    workdir = tempfile.mkdtemp(prefix="x3d2-ranks-") if own else str(workdir)
    # the BLAS of numpy reads its thread count when it loads, in the child
    # before fn runs: the variables are inherited from here
    blas = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")
    try:
        with env_set({k: str(threads) for k in blas} if threads else {}):
            mp.spawn(_rank_main, args=(world, fn, args, workdir, backend,
                                       threads), nprocs=world, join=True)
    except Exception as err:
        msgs = []
        for r in range(world):
            p = os.path.join(workdir, f"error-{r}.txt")
            if os.path.exists(p):
                with open(p) as fh:
                    msgs.append(f"rank {r}:\n{fh.read()}")
        raise RuntimeError("a rank failed:\n" + "\n".join(msgs)) from err
    out = [torch.load(os.path.join(workdir, f"result-{r}.pt"),
                      weights_only=False) for r in range(world)]
    if own:
        import shutil
        shutil.rmtree(workdir, ignore_errors=True)
    return out
