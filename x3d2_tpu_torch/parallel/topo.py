"""Process-mesh decomposition and the sharded step.

Counterpart of x3d2_tpu.parallel.topo (the reference's MPI domain
decomposition, mesh.f90:160-194, with nproc_dir(1) = 1): fields are split
over a (y, z) mesh of processes, x whole, and each rank holds its local
block (nx, ny / nproc_y, nz / nproc_z). Where x3d2_tpu's GSPMD partitioner
inserts the collectives, the port makes them itself over torch.distributed:
the neighbour exchanges of halo planes (parallel/halo.py, the ppermute
counterpart) and the tiled all-to-all transposes of the repencilled
projection (parallel/shard_kernels.py).

Rank r sits at (iy, iz) = divmod(r, nproc_z), the order of x3d2_tpu's
device mesh (devices reshaped to (nproc_y, nproc_z)). Each mesh row and
column has a process group of its own; every rank creates all of them, in
one order.

The transport between ranks is chosen by the caller, never on failure:
"nccl" with one card per rank, or "gloo". gloo takes CPU tensors for the
point-to-point and all-to-all exchanges, so with gloo and CUDA tensors the
halo planes, the all-to-all buffers and the reductions are staged through
host memory (``ProcessMesh.staged``) by the code that exchanges them.

Where x3d2_tpu keeps a single-device kernel chain under its sharded step
and lets GSPMD run it on gathered fields (the fused RK chain, the
d2-in-C carry of X3D2_D2C=1), each rank gathers the fields the chain reads
(gather_tensor), runs the case's own chain on its device and keeps its
block: every rank then holds the whole fields of that chain.

What the port does not cover raises NotImplementedError: an x-decomposed
mesh (nproc_x > 1), and on a sharded mesh any operator or projection that
x3d2_tpu partitions with GSPMD (an axis too narrow for the halo band, the
spectral pressure_grads of compensated stepping or of a grid without the
repencilled projection).
"""

from __future__ import annotations

import copy
import dataclasses
import os
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from ..common import DataLoc, resolve_device

X_MESH_GAP = ("an x-decomposed mesh (nproc_x > 1): x3d2_tpu runs it with "
              "halo x applies and its GSPMD spectral projection "
              "(x3d2_tpu/parallel/topo.py:27-55, :201-205), not ported")
GSPMD_GAP = ("x3d2_tpu partitions {what} with GSPMD on this mesh "
             "(x3d2_tpu/parallel/topo.py:97-137, solver.py:420-431): "
             "collectives the port does not make")
STEP_GAPS = {
    "compensated": ("compensated stepping under make_sharded_step: its "
                    "pressure_grads is x3d2_tpu's GSPMD spectral chain "
                    "(solver.py:420-431), not the repencilled projection"),
}


@dataclass
class ProcessMesh:
    """A (nproc_y, nproc_z) mesh of ranks. Built by make_process_mesh with
    its process groups; ProcessMesh(nproc_y, nproc_z) alone is the layout
    (enough for the gates of shard_kernels)."""

    nproc_y: int
    nproc_z: int
    rank: int = 0
    backend: str = "gloo"
    device: torch.device = None
    groups: dict = field(default_factory=dict)     # "y", "z", "world"
    members: dict = field(default_factory=dict)    # global ranks by place
    # host seconds in the halo exchanges and the all-to-alls, counted
    # while `timing` is on (each then waits for the device first)
    timing: bool = False
    comm_seconds: dict = field(default_factory=lambda: {"halo": 0.0,
                                                        "a2a": 0.0})

    @property
    def shape(self) -> dict:
        return {"y": self.nproc_y, "z": self.nproc_z}

    @property
    def size(self) -> int:
        return self.nproc_y * self.nproc_z

    @property
    def coords(self) -> dict:
        iy, iz = divmod(self.rank, self.nproc_z)
        return {"y": iy, "z": iz}

    def axis_index(self, name) -> int:
        return self.coords[name]

    @property
    def staged(self) -> bool:
        """Whether exchanges pass through host memory: gloo with CUDA
        tensors (gloo's send/recv and all-to-all take CPU tensors)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def to_wire(self, t):
        """t as the transport takes it: with staging a host copy, after
        the device's work on t is done."""
        if not self.staged:
            return t.contiguous()
        torch.cuda.current_stream(t.device).synchronize()
        return t.to("cpu")

    def from_wire(self, t):
        return t.to(self.device) if self.staged else t

    def clock(self, what):
        """A context that adds its host seconds to comm_seconds[what] while
        timing is on."""
        import contextlib
        import time

        if not self.timing:
            return contextlib.nullcontext()

        @contextlib.contextmanager
        def timed():
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            t0 = time.perf_counter()
            yield
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.comm_seconds[what] += time.perf_counter() - t0
        return timed()

    def neighbours(self, name):
        """(previous, next) global rank along mesh axis `name`, cyclic."""
        ranks = self.members[name]
        i = self.axis_index(name)
        return ranks[(i - 1) % len(ranks)], ranks[(i + 1) % len(ranks)]

    def all_reduce(self, t, op):
        """t reduced over all ranks (a new tensor on t's device)."""
        w = self.to_wire(t.clone())
        dist.all_reduce(w, op=op, group=self.groups["world"])
        return self.from_wire(w)

    def all_to_all(self, t, name, split_axis, concat_axis):
        """The tiled all-to-all over mesh axis `name` (x3d2_tpu's
        jax.lax.all_to_all(..., tiled=True)): t split into nproc chunks
        along split_axis, chunk i sent to the i-th rank of the axis, the
        received chunks concatenated along concat_axis in rank order."""
        ns = self.shape[name]
        with self.clock("a2a"):
            inp = self.to_wire(torch.stack(t.chunk(ns, split_axis)))
            out = torch.empty_like(inp)
            dist.all_to_all_single(out, inp, group=self.groups[name])
            out = self.from_wire(out)
        return torch.cat(out.unbind(0), concat_axis)

    def all_gather(self, t):
        """Every rank's t, in rank order."""
        w = self.to_wire(t)
        outs = [torch.empty_like(w) for _ in range(self.size)]
        dist.all_gather(outs, w, group=self.groups["world"])
        return [self.from_wire(o) for o in outs]


def make_process_mesh(nproc_y, nproc_z, backend=None, device=None,
                      nproc_x=1) -> ProcessMesh:
    """The (nproc_y, nproc_z) mesh over the default process group's ranks
    (counterpart of make_device_mesh): the rank's place and one process
    group per mesh row and column and one over all ranks, on `backend`
    ("nccl", one card per rank, device cuda:LOCAL_RANK; or "gloo"; default
    the default group's). device: where this rank's fields live (with
    nccl cuda:LOCAL_RANK, else cuda unless given; entry points default to
    the card). nproc_x > 1 raises NotImplementedError (X_MESH_GAP)."""
    if nproc_x > 1:
        raise NotImplementedError(X_MESH_GAP)
    n = nproc_y * nproc_z
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n:
        raise ValueError(f"a ({nproc_y}, {nproc_z}) mesh needs {n} ranks, "
                         f"the process group has {world}")
    rank = dist.get_rank() if dist.is_initialized() else 0
    backend = backend or (dist.get_backend() if dist.is_initialized()
                          else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: 'nccl' or 'gloo'")
    if backend == "nccl":
        from .multihost import local_rank
        want = torch.device("cuda", local_rank())
        if device is not None and torch.device(device) != want:
            raise ValueError(f"nccl places rank {rank} on {want}")
        device = want
        torch.cuda.set_device(device)
    else:
        device = resolve_device(device)
    pm = ProcessMesh(nproc_y, nproc_z, rank=rank, backend=backend,
                     device=device)
    if not dist.is_initialized():
        return pm
    pm.groups["world"] = dist.new_group(list(range(n)), backend=backend)
    # every rank creates every group, in one order
    for iz in range(nproc_z):
        ranks = [iy * nproc_z + iz for iy in range(nproc_y)]
        g = dist.new_group(ranks, backend=backend)
        if rank in ranks:
            pm.groups["y"], pm.members["y"] = g, ranks
    for iy in range(nproc_y):
        ranks = [iy * nproc_z + iz for iz in range(nproc_z)]
        g = dist.new_group(ranks, backend=backend)
        if rank in ranks:
            pm.groups["z"], pm.members["z"] = g, ranks
    return pm


def field_spec(pmesh: ProcessMesh = None, shape=None) -> tuple:
    """The mesh axis each field axis is split over (None: whole), as
    x3d2_tpu's field_spec: y over "y" and z over "z", except an axis whose
    extent does not divide its mesh dimension, which stays whole."""
    if pmesh is None or shape is None:
        return (None, "y", "z")
    return (None, "y" if shape[-2] % pmesh.nproc_y == 0 else None,
            "z" if shape[-1] % pmesh.nproc_z == 0 else None)


def local_slices(pmesh: ProcessMesh, shape, rank=None) -> tuple:
    """The block of a field of `shape` (leading axes whole) that `rank`
    (default: this rank) holds."""
    spec = field_spec(pmesh, shape)
    iy, iz = divmod(pmesh.rank if rank is None else rank, pmesh.nproc_z)
    sl = [slice(None)] * len(shape)
    for k, name in enumerate(spec):
        a = len(shape) - 3 + k
        if name is not None:
            n = shape[a] // pmesh.shape[name]
            i = iy if name == "y" else iz
            sl[a] = slice(i * n, (i + 1) * n)
    return tuple(sl)


def _map_fields(state, fn):
    out = {}
    for k, v in state.items():
        if k in ("olds", "comp", "rhsp"):
            out[k] = tuple(tuple(fn(o) for o in x) if isinstance(x, tuple)
                           else fn(x) for x in v)
        elif torch.is_tensor(v):
            out[k] = fn(v)
        else:
            out[k] = v
    return out


def shard_state(pmesh: ProcessMesh, state) -> dict:
    """This rank's local state from a global one (every field sliced by
    local_slices; step counter and generator kept)."""
    return _map_fields(
        state, lambda t: t[local_slices(pmesh, tuple(t.shape))].contiguous())


def global_shape(pmesh: ProcessMesh, mesh, local_shape) -> tuple:
    """The global shape of a rank's block of `local_shape` (leading axes
    whole): the block of a field at the VERT or the CELL extents of the
    case's Mesh `mesh`."""
    lead = tuple(local_shape[:-3])
    loc = tuple(local_shape[-3:])
    for loc_ in (DataLoc.VERT, DataLoc.CELL):
        g = tuple(mesh.dims(loc_))
        if tuple(s // pmesh.shape[n] if n else s for s, n in
                 zip(g, field_spec(pmesh, g))) == loc:
            return lead + g
    raise ValueError(f"a local block {loc} of neither the VERT "
                     f"{tuple(mesh.dims(DataLoc.VERT))} nor the CELL "
                     f"{tuple(mesh.dims(DataLoc.CELL))} extents")


def gather_tensor(pmesh: ProcessMesh, t, global_shape):
    """The global tensor from every rank's block of it (on every rank)."""
    parts = pmesh.all_gather(t.contiguous())
    out = torch.empty(global_shape, dtype=t.dtype, device=t.device)
    for r, part in enumerate(parts):
        out[local_slices(pmesh, global_shape, r)] = part
    return out


def gather_state(pmesh: ProcessMesh, local_state, mesh) -> dict:
    """The global state from the ranks' local states (collective: every
    rank calls it, every rank gets it). mesh: the case's Mesh (the global
    VERT and CELL extents)."""
    return _map_fields(local_state, lambda t: gather_tensor(
        pmesh, t, global_shape(pmesh, mesh, tuple(t.shape))))


def make_halo_solver(solver, pmesh: ProcessMesh, w=None):
    """The solver with its compact operators along sharded axes wrapped in
    halo applies (counterpart of x3d2_tpu make_halo_solver, topo.py:97-137:
    one neighbour exchange of w planes per apply). An axis is wrapped
    where its square operators' extent divides the mesh dimension (>1)
    and the shards are at least w wide, and the band truncation check
    passes; on a sharded axis that is not wrapped, the operators x3d2_tpu
    leaves to GSPMD raise NotImplementedError when applied. Returns a copy
    of the solver, with ``_halo_mode`` set where an axis was wrapped; the
    single-device kernel branches are dropped (x3d2_tpu's
    dataclasses.replace drops them too)."""
    from .halo import OP_NAMES, GspmdOp, halo_width, make_halo_axis_ops

    w = w or halo_width(solver.dtype)
    dims = solver.mesh.dims(DataLoc.VERT)
    spec = field_spec(pmesh, dims)
    new_ops, wrapped = [], False
    for axis in range(3):
        o = solver.ops[axis]
        name = {1: "y", 2: "z"}.get(axis)
        ns = pmesh.shape[name] if name else 1
        if name is not None and spec[axis] == name and ns > 1:
            n = o.der1st.n_in
            if o.der1st.n_out == n and n % ns == 0 and n // ns >= w:
                try:
                    new_ops.append(make_halo_axis_ops(o, pmesh, name, axis,
                                                      w))
                    wrapped = True
                    continue
                except ValueError:
                    pass  # band truncation check failed: GSPMD in x3d2_tpu
        if name is not None and ns > 1:
            o = dataclasses.replace(o, **{
                k: GspmdOp(getattr(o, k)) for k in OP_NAMES})
        new_ops.append(o)
    variant = dataclasses.replace(solver, ops=tuple(new_ops))
    for k, val in (("_terms", solver._terms), ("_transport", "dense"),
                   ("_sweeps", None), ("_v1", None),
                   ("_species_sweeps", None), ("_pipe", None),
                   ("_slab", None), ("_projection_gap", None),
                   ("_merged_x", solver._merged_x), ("_sharded", True),
                   ("_halo_mode", wrapped)):
        object.__setattr__(variant, k, val)
    return variant


def make_sharded_step(case, pmesh: ProcessMesh, state=None):
    """The case's step over the process mesh (counterpart of x3d2_tpu
    make_sharded_step, topo.py:140-247): returns (step, local_state), with
    step(local_state) -> the next local state on this rank. The branches
    are x3d2_tpu's: the halo solver (make_halo_solver); the fused AB chain
    dropped (the unfused AB step, its update elementwise); where the local
    shards tile (sharded_transeq_v3_supported at the mode's terms) the
    sharded sweep chain, halo form on the sharded axes, with the scalars'
    (at most 8); in halo mode the x operators as per-rank x applies
    (wrap_x_ops); where repencil_supported holds the repencilled
    projection. With X3D2_PALLAS=0 none of the kernel branches. The chains
    x3d2_tpu keeps single-device and runs on GSPMD-gathered fields run on
    gathered fields here: a fused RK step's substage chains (the
    projection after each stays the sharded one), and with X3D2_D2C=1 the
    whole carried step (the chain without its z sweep and the carry
    pipeline) and its boot z sweep. Compensated stepping raises
    NotImplementedError (STEP_GAPS). The working case (a copy; monitoring
    with global reductions, written by rank 0; ``pmesh`` set) is
    ``case._sharded_case``, its solver ``case._sharded_solver``: its
    ``run`` drives the time loop on the rank's block."""
    from ..io.monitoring import make_observables_fn
    from ..ops.compact import matmul_terms
    from .shard_kernels import (make_repencilled_pressure,
                                make_sharded_species, make_sharded_transeq,
                                repencil_supported, sharded_transeq_supported,
                                sharded_x_apply_supported, wrap_x_ops)

    if case.device != pmesh.device:
        raise ValueError(f"the case is on {case.device}, this rank's "
                         f"fields on {pmesh.device}")
    if case.params.compensated:
        raise NotImplementedError(STEP_GAPS["compensated"])
    if state is None:
        state = case.initial_state()
    solver = case.solver
    halo_solver = make_halo_solver(solver, pmesh)
    orig = case
    case = copy.copy(case)
    case.solver = halo_solver
    case._fused_ab = None
    case._ab_is_xdiv = False
    if os.environ.get("X3D2_PALLAS", "1") != "0":
        terms = matmul_terms()
        if sharded_transeq_supported(solver, pmesh, terms=terms):
            object.__setattr__(halo_solver, "_sharded_transeq",
                               make_sharded_transeq(solver, pmesh,
                                                    terms=terms))
            if solver.nu_species and len(solver.nu_species) <= 8:
                try:
                    object.__setattr__(
                        halo_solver, "_sharded_species",
                        make_sharded_species(solver, pmesh, terms=terms))
                except ValueError:
                    pass  # shard extents not tileable: operator path
        if (halo_solver._halo_mode
                and sharded_x_apply_supported(solver, pmesh)):
            object.__setattr__(
                halo_solver, "ops",
                (wrap_x_ops(solver, pmesh),) + tuple(halo_solver.ops[1:]))
        if repencil_supported(solver, pmesh):
            object.__setattr__(
                halo_solver, "_repencil_pressure",
                make_repencilled_pressure(solver, pmesh, terms=terms))
    # the case's monitor (its file opened by rank 0 alone, io/monitoring.py)
    # with the observables reduced over the ranks
    case.monitor = copy.copy(case.monitor)
    case.monitor.fn = make_observables_fn(halo_solver, pmesh)
    case.pmesh = pmesh
    if case._fused_rk is not None:
        case._fused_rk = tuple(_gathered_stage(stage, pmesh, orig.mesh)
                               for stage in case._fused_rk)
    if case._pipe_d2c is not None and not case.keep_pressure:
        case._step = _gathered_step(orig, pmesh)
        case._d2_boot = _gathered_boot(orig._d2_boot, pmesh, orig.mesh)
    orig._sharded_case = case
    orig._sharded_solver = halo_solver
    return case.step, shard_state(pmesh, state)


def _gathered_stage(stage, pmesh, mesh):
    """A fused RK substage chain (stage(u, v, w, f0, ks, dtc)) on gathered
    fields: u, v, w and f0 gathered (f0's entries that are u, v, w
    reused), the chain run on the whole fields, u' cut to this rank's
    block. The stage derivative stays whole: only the later substages'
    chains read it."""
    shape = tuple(mesh.dims(DataLoc.VERT))

    def run(u, v, w, f0, ks, dtc):
        fields = (u, v, w)
        g = tuple(gather_tensor(pmesh, t, shape) for t in fields)
        g0 = tuple(gi if f is fi else gather_tensor(pmesh, f, shape)
                   for f, fi, gi in zip(f0, fields, g))
        mom, rhs = stage(*g, g0, ks, dtc)
        sl = local_slices(pmesh, shape)
        return tuple(m[sl].contiguous() for m in mom), rhs

    run.prev_nz, run.sweeps = stage.prev_nz, stage.sweeps
    return run


def _gathered_step(orig, pmesh):
    """The carried step of X3D2_D2C=1 on gathered fields: u, v, w, their
    history and the carried z partials gathered, the single-device case's
    own step (its chain without the z sweep, then the carry pipeline) run
    on the whole fields, the new state cut to this rank's block; p is
    carried untouched (the carried step forms none)."""
    mesh = orig.mesh

    def step(state):
        g = gather_state(pmesh, {k: v for k, v in state.items()
                                 if k != "p"}, mesh)
        out = type(orig)._step(orig, dict(g, p=state["p"]))
        p = out.pop("p")
        return dict(shard_state(pmesh, out), p=p)

    return step


def _gathered_boot(boot, pmesh, mesh):
    """The carry's boot z sweep on gathered u, v, w, cut to the block."""
    shape = tuple(mesh.dims(DataLoc.VERT))

    def run(u, v, w):
        out = boot(*(gather_tensor(pmesh, t, shape) for t in (u, v, w)))
        sl = local_slices(pmesh, shape)
        return tuple(o[sl].contiguous() for o in out)

    return run
