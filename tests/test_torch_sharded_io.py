"""The program on a (y, z) process mesh against x3d2_tpu, on the CPU: per-
shard checkpoints (x3d2_tpu_torch/io/sharded.py), ``python -m
x3d2_tpu_torch --mesh`` and the sharded step's gathered chains.

One spawn of four gloo ranks (parallel/multihost.py spawn, a FileStore
under the test's temporary directory) serves every case (_ranks); x3d2_tpu
runs in the pytest process on its 8-device virtual CPU mesh, as
tests/test_sharded_io.py runs it. float64 but in (f).

(a) Across mesh shapes. TGV AB3 at 32 x 128 x 512 (the smallest grid
    whose blocks the sharded step takes on both (2, 2) and (1, 4): the
    per-rank x applies tile a local z of 128) runs 2 steps on (2, 2) with
    a per-shard checkpoint, then 2 more. The checkpoint restores onto (2, 2)
    (steps 3-4 equal the uninterrupted run bit for bit), onto (1, 4) and
    onto one process: the restored state equals the (2, 2) state at step
    2 bit for bit, its history too, and steps 3-4 equal that mesh's own
    continuation of the in-memory step-2 state to 1e-15
    (tests/test_sharded_io.py:75-80's bound; measured: bit for bit). The
    three meshes apply the operators differently (halo blocks on a sharded
    axis, whole lines else): their runs agree to 1e-14 of max |u|
    (measured 2.2e-16 for (1, 4), 1.1e-15 for one process, whose float64
    single-process step takes the dense operators).
(b) No global gather. While the (2, 2) run writes and the (1, 4) and
    (2, 2) ranks restore, gather_global and gather_tensor raise, and every
    field a rank reads from the checkpoint has its block's shape.
(c) x3d2_tpu's files read by the port. x3d2_tpu's write_sharded on its
    (2, 4) device mesh (TGV 16^3 AB3 after 3 steps, with statistics:
    x3d2_tpu writes its sample count as a 0-d chunk, "stats_sample_count@",
    which its own reader cannot parse, int("") in _parse_key; the port
    reads it) restores in the port on (2, 2) and on one process, equal to
    x3d2_tpu's state bit for bit.
(d) The port's files read by x3d2_tpu. (a)'s four shard files restore
    through x3d2_tpu's restore_sharded onto one device, equal to the port's
    gathered state bit for bit; and (e)'s, with statistics (the port
    writes their 0-d sample count as one element, which x3d2_tpu reads).
(e) The CLI on a mesh. main([..., "--mesh", "2", "2", "--device", "cpu",
    "--dtype", "f64"]) on four ranks, each in its own directory, and the
    same input with nproc_dir = 1, 2, 2 and no --mesh, against x3d2_tpu's
    CLI with --mesh 2 2 (tests/test_sharded_io.py:109-138) at 32 x 128 x
    256, AB3, 4 steps, statistics from step 2, a checkpoint every 2 steps,
    vort, qcrit and the pressure in single precision at step 4. x3d2_tpu
    runs with X3D2_PALLAS=0: its interpret-mode kernels on the virtual mesh
    keep its float64 run's divergence at 2.9e-4 (bf16x3 operand splits),
    where the einsum path's reads 2.4e-13. Held: the monitoring rows
    (time, enstrophy, KE to rtol 1e-12; the divergence columns, rounding
    of a divergence-free field, to 1e-13 absolute as test_torch_cli.py
    holds them: measured 1.1e-14); every checkpoint array to 1e-13, absolute for
    arrays of order one (as tests/test_sharded_io.py:132-133), relative
    above (the pressure mean, of order 1/dt); the statistics archive by
    the same rule at test_torch_cli.py's 1e-12 (the RMS by its square; the
    means of w, of order 1e-4 here, fail a rule relative to their own
    size by float64 rounding alone); the snapshot as test_torch_cli.py
    holds it; rank 0 alone prints and writes the
    monitoring file, the statistics, the snapshots and the manifest, and
    each rank its shard file; the nproc_dir run (keep_checkpoint off: once
    every rank's step-4 files are durable, each rank removes its own step-2
    shard file and rank 0 the manifest) is the --mesh run's, its
    monitoring file to the byte. Restarts on the mesh: from the run's
    per-shard checkpoint at step 2 (its checkpoint and statistics archive
    at 4 and monitoring file equal the uninterrupted run's bit for bit and
    to the byte: every rank gathers the restored accumulators in one
    order), and
    from x3d2_tpu's global checkpoint at step 2 (read whole, cut to the
    blocks; its checkpoint at 4 against x3d2_tpu's to 1e-13).
(f) The two step modes that run on gathered fields: fused RK3 and
    X3D2_D2C=1 (with X3D2_XDIV_FUSED=0, which the carry's gate needs below
    257 points), float32, one step at 128 x 128 x 256 on (2, 2) (the
    smallest grid with the float32 sweep chains; the port builds them in
    float32 only). Against the port's single-process step of the same
    arithmetic (RK3: the one-field parity x stage and the mid with q,
    X3D2_MERGED_X=0 keep_pressure=True; D2C: its own case), within
    test_sharded_step_modes' rk3 bound, 7e-9 of max |u| (measured: bit for
    bit), and against x3d2_tpu's float64 step (X3D2_PALLAS=0) within 1e-6
    of max |u|, the float32 bound of chip_smoke.py's phase 9 (measured
    3.1e-7 and 5.8e-7).
"""

import contextlib
import io
import math
import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
from threadpoolctl import threadpool_limits

from x3d2_tpu_torch.cases import SolverParams, TGVCase
from x3d2_tpu_torch.common import BC, DataLoc
from x3d2_tpu_torch.config import CheckpointConfig, StatsConfig
from x3d2_tpu_torch.io import sharded
from x3d2_tpu_torch.io.manager import IOManager
from x3d2_tpu_torch.mesh import Mesh
from x3d2_tpu_torch.parallel import multihost, topo

torch.set_num_threads(1)
threadpool_limits(1, user_api="blas")

L = (2 * math.pi,) * 3
PER = ((BC.PERIODIC, BC.PERIODIC),) * 3
DIMS_A = (32, 128, 512)
DIMS_C = (16, 16, 16)
DIMS_E = (32, 128, 256)
DIMS_F = (128, 128, 256)
D2C_ENV = {"X3D2_D2C": "1", "X3D2_XDIV_FUSED": "0"}

CLI_INPUT = """
&domain_settings
flow_case_name = 'tgv'
L_global = 6.283185307179586d0, 6.283185307179586d0, 6.283185307179586d0
dims_global = 32, 128, 256
nproc_dir = 1, 1, 1
BC_x = 'periodic', 'periodic'
BC_y = 'periodic', 'periodic'
BC_z = 'periodic', 'periodic'
/End

&solver_params
Re = 1600d0
time_intg = 'AB3'
dt = 0.001d0
n_iters = 4
n_output = 1
/End

&checkpoint_params
checkpoint_freq = 2
snapshot_freq = 4
keep_checkpoint = .true.
output_fields = 'vort', 'qcrit', 'pressure'
snapshot_sp = .true.
/End

&stats_params
initstat = 2
istatfreq = 1
istatout = 4
/End
"""
NPROC_INPUT = CLI_INPUT.replace(
    "nproc_dir = 1, 1, 1", "nproc_dir = 1, 2, 2").replace(
    "keep_checkpoint = .true.", "keep_checkpoint = .false.")
CLI_ARGS = ["input.x3d", "--device", "cpu", "--dtype", "f64"]


def _case(dims, dtype=torch.float64, time_intg="AB3"):
    return TGVCase(Mesh(dims, L, PER),
                   SolverParams(Re=1600.0, time_intg=time_intg, dt=1e-3),
                   dtype=dtype, monitor_path=None, verbose=False,
                   keep_pressure=False, device="cpu")


def _ck(prefix, restart=False, path=None):
    return CheckpointConfig(checkpoint_freq=2, keep_checkpoint=True,
                            checkpoint_prefix=str(prefix),
                            restart_from_checkpoint=restart,
                            restart_file=path, sharded_io=True)


# ---------------------------------------------------------------------------
# the ranks (spawned: torch and numpy only)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _no_global(reads):
    """gather_global and gather_tensor raise; every ChunkReader.read_slice
    is recorded in `reads` as (name, the shape it returned)."""
    def poisoned(*a, **kw):
        raise AssertionError("a global field was gathered")
    read = sharded.ChunkReader.read_slice

    def recorded(self, name, index):
        out = read(self, name, index)
        reads.append((name, out.shape))
        return out

    saved = multihost.gather_global, topo.gather_tensor
    multihost.gather_global = topo.gather_tensor = poisoned
    sharded.ChunkReader.read_slice = recorded
    try:
        yield
    finally:
        multihost.gather_global, topo.gather_tensor = saved
        sharded.ChunkReader.read_slice = read


def _gathered(state, pmesh, mesh, olds=False):
    """u, v, w (and the history) of the global state, as numpy."""
    from x3d2_tpu_torch.convert import state_to_numpy_gathered
    g = state_to_numpy_gathered(
        {k: state[k] for k in ("u", "v", "w", "p", "istep")}
        | {"olds": state["olds"] if olds else ()}, pmesh, mesh)
    return {k: g[k] for k in ("u", "v", "w") + (("olds",) if olds else ())}


def _local(pmesh, shape):
    return tuple(s.stop - s.start if s.start is not None else d for s, d in
                 zip(topo.local_slices(pmesh, shape), shape))


def _bits(a, b):
    """Whether two numpy states (u, v, w, and the history where both have
    it) are equal bit for bit."""
    same = all(np.array_equal(a[k], b[k]) for k in ("u", "v", "w"))
    if "olds" in a and "olds" in b:
        same = same and [len(o) for o in a["olds"]] == [
            len(o) for o in b["olds"]] and all(
            np.array_equal(x, y) for p, q in zip(a["olds"], b["olds"])
            for x, y in zip(p, q))
    return same


def _vel_err(got, want):
    scale = np.abs(want["u"]).max()
    return max(np.abs(got[k] - want[k]).max() for k in ("u", "v", "w")
               ) / scale


def _restarts(restored, cont, mem, st2, st4):
    """The numbers of a restore onto another mesh: whether the restored
    state is the step-2 state bit for bit, the largest difference of its
    continuation from the in-memory state's, and its distance to the
    uninterrupted run (of max |u|)."""
    return {"bits": _bits(restored, st2),
            "mem": max(float(np.abs(cont[k] - mem[k]).max())
                       for k in ("u", "v", "w")),
            "err": _vel_err(cont, st4)}


def _across_meshes(rank, tmp):
    """(a), (b): rank 0 returns the step-2 state and the numbers of the
    (2, 2) and (1, 4) restores, rank 3 those of the one-process restore."""
    world = dist.group.WORLD
    pm = topo.make_process_mesh(2, 2, device="cpu")
    case = _case(DIMS_A)
    mesh = case.mesh
    _, st = topo.make_sharded_step(case, pm)
    run_case = case._sharded_case
    prefix = tmp / "a" / "sck"
    prefix.parent.mkdir(exist_ok=True)
    reads = []
    with _no_global(reads):
        st = run_case.run(n_iters=2, state=st, n_output=10**9,
                          io_manager=IOManager(run_case, _ck(prefix)))
    st2 = _gathered(st, pm, mesh, olds=True)
    for _ in range(2):
        st = run_case.step(st)
    st4 = _gathered(st, pm, mesh)
    manifest = f"{prefix}_000002.manifest.npz"

    def restored(pmesh_, case_, tmpl):
        r = []
        with _no_global(r):
            state = IOManager(case_, _ck(prefix, True, manifest)
                              ).handle_restart(tmpl)
        blk = _local(pmesh_, tuple(mesh.dims(DataLoc.VERT)))
        assert r and all(shape == blk for _, shape in r), (blk, r)
        return state

    # (2, 2) again, a fresh case
    case_b = _case(DIMS_A)
    _, tmpl = topo.make_sharded_step(case_b, pm)
    sb = restored(pm, case_b._sharded_case, tmpl)
    for _ in range(2):
        sb = case_b._sharded_case.step(sb)
    same = _bits(_gathered(sb, pm, mesh), st4)
    # (1, 4): the restored state, its continuation, and the continuation
    # of the in-memory step-2 state
    pm14 = topo.make_process_mesh(1, 4, device="cpu")
    case_c = _case(DIMS_A)
    _, tmpl = topo.make_sharded_step(case_c, pm14)
    sc = restored(pm14, case_c._sharded_case, tmpl)
    r14 = _gathered(sc, pm14, mesh, olds=True)
    for _ in range(2):
        sc = case_c._sharded_case.step(sc)
    c14 = _gathered(sc, pm14, mesh)
    from x3d2_tpu_torch.convert import state_from_numpy_sharded
    sm = state_from_numpy_sharded(_resumed(st2, mesh), pm14, device="cpu")
    for _ in range(2):
        sm = case_c._sharded_case.step(sm)
    m14 = _gathered(sm, pm14, mesh)
    out = {}
    if rank == 0:
        out = {"st2": st2, "same": same, "write_reads": reads,
               "1x4": _restarts(r14, c14, m14, st2, st4)}
    if rank == 3:
        out = {"one process": _restarts(*_one_process(manifest, st2), st2,
                                        st4)}
    dist.barrier(world)
    return out


def _one_process(manifest, st2):
    """The checkpoint restored by one process (no mesh), its 2 steps, and
    2 steps of the in-memory state: (restored, continued, in-memory)."""
    from x3d2_tpu_torch.convert import state_from_numpy, state_to_numpy
    case = _case(DIMS_A)
    io_ = IOManager(case, _ck(Path(manifest).parent / "one", True, manifest))
    s = io_.handle_restart(case.initial_state())
    restored = state_to_numpy(s)
    for _ in range(2):
        s = case.step(s)
    m = state_from_numpy(_resumed(st2, case.mesh), device="cpu")
    for _ in range(2):
        m = case.step(m)
    vel = ("u", "v", "w")
    return (restored, {k: s[k].numpy() for k in vel},
            {k: m[k].numpy() for k in vel})


def _resumed(st, mesh):
    """A gathered step-2 state (u, v, w and the history) as a state to
    step on from: the carried p (zero: no pressure is kept) and the step
    counter added."""
    return dict(st, p=np.zeros(mesh.dims(DataLoc.CELL)), istep=3)


def _x3d2_tpu_files(rank, manifest):
    """(c): x3d2_tpu's per-shard checkpoint restored onto (2, 2): the
    rank's blocks and statistics, and the shapes it read."""
    pm = topo.make_process_mesh(2, 2, device="cpu")
    mesh = Mesh(DIMS_C, L, PER)
    blk = _local(pm, DIMS_C)
    z = torch.zeros(blk, dtype=torch.float64)
    tmpl = {"u": z, "v": z, "w": z, "p": z, "istep": 1,
            "olds": ((z, z),) * 3,
            "rng": torch.Generator().manual_seed(0)}
    reads = []
    with _no_global(reads):
        state, ts, t, dt, stats = sharded.restore_sharded(
            manifest, tmpl, pmesh=pm)
    assert all(shape == blk for name, shape in reads
               if not name.endswith("sample_count")), reads
    del mesh
    return {"state": {k: state[k].numpy() for k in ("u", "v", "w")},
            "olds": [[o.numpy() for o in per] for per in state["olds"]],
            "stats": stats, "scalars": (ts, t, dt, state["istep"]),
            "slices": topo.local_slices(pm, DIMS_C)}


def _cli(rank, tmp, jdir):
    """(e): the CLI on four ranks, each in its own directory, with --mesh
    and with nproc_dir; its restarts. Returns each rank's stdout."""
    world = dist.group.WORLD
    from x3d2_tpu_torch.__main__ import main
    outs = {}

    def run(d, text, argv, shared=False):
        # a directory the ranks share gets its input from rank 0 alone, in
        # full before any rank reads it
        if rank == 0 or not shared:
            d.mkdir(parents=True, exist_ok=True)
            (d / "input.x3d").write_text(text)
        dist.barrier(world)
        os.chdir(d)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(argv)
        dist.barrier(world)
        return buf.getvalue()

    outs["mesh"] = run(tmp / "e" / "mesh" / f"rank{rank}", CLI_INPUT,
                       CLI_ARGS + ["--mesh", "2", "2"])
    outs["nproc"] = run(tmp / "e" / "nproc" / f"rank{rank}", NPROC_INPUT,
                        CLI_ARGS)
    # the restart from step 2: every rank's shard file, the manifest and
    # the monitoring rows to step 2 in one directory
    shared = tmp / "e" / "restart"
    shared.mkdir(parents=True, exist_ok=True)
    src = tmp / "e" / "mesh" / f"rank{rank}"
    for f in src.glob("checkpoint_000002.*"):
        shutil.copy(f, shared / f.name)
    if rank == 0:
        rows = (src / "monitoring.csv").read_text().splitlines()[:4]
        (shared / "monitoring.csv").write_text("\n".join(rows) + "\n")
    dist.barrier(world)
    restart = CLI_INPUT.replace(
        "keep_checkpoint = .true.",
        "keep_checkpoint = .true.\nrestart_from_checkpoint = .true.\n"
        "restart_file = 'checkpoint_000002.manifest.npz'")
    outs["restart"] = run(shared, restart, CLI_ARGS + ["--mesh", "2", "2",
                                                       "--n-iters", "2"],
                          shared=True)
    # the restart from x3d2_tpu's global checkpoint at step 2
    from_j = CLI_INPUT.replace(
        "keep_checkpoint = .true.",
        "keep_checkpoint = .true.\nrestart_from_checkpoint = .true.\n"
        f"restart_file = '{jdir}/checkpoint_000002.npz'")
    outs["from_j"] = run(tmp / "e" / "from_j", from_j,
                         CLI_ARGS + ["--mesh", "2", "2", "--n-iters", "2"],
                         shared=True)
    return outs


def _modes(rank):
    """(f): fused RK3 and X3D2_D2C=1 on (2, 2), one step each (gathered
    states on rank 0); the single-process references of the same
    arithmetic on ranks 1 and 2, in parallel."""
    from x3d2_tpu_torch.common import env_set
    from x3d2_tpu_torch.tools import shard_run

    base = {"dims": DIMS_F, "mesh": (2, 2), "dtype": "float32",
            "device": "cpu", "steps": 1}
    specs = {"rk3": dict(base, time_intg="RK3"),
             "d2c": dict(base, env=D2C_ENV)}
    out = {k: shard_run.tgv_rank(rank, 4, s) for k, s in specs.items()}
    out = {k: {"state": v.get("state"), "gathered": v["gathered"],
               "solver": v["solver"]} for k, v in out.items()}
    mesh = Mesh(DIMS_F, L, PER)
    if rank == 1:
        params = SolverParams(Re=1600.0, time_intg="RK3", dt=1e-3)
        out["rk3"]["ref"] = shard_run._single_card(
            mesh, params, torch.float32, torch.device("cpu"), 1,
            ("u", "v", "w"))
    if rank == 2:
        params = SolverParams(Re=1600.0, time_intg="AB3", dt=1e-3)
        with env_set(D2C_ENV):
            out["d2c"]["ref"] = shard_run._single_card(
                mesh, params, torch.float32, torch.device("cpu"), 1,
                ("u", "v", "w"), own=False)
    return out


def _ranks(rank, world, tmp, x_manifest, jdir):
    tmp = Path(tmp)
    cwd = os.getcwd()
    try:
        return {"a": _across_meshes(rank, tmp),
                "c": _x3d2_tpu_files(rank, x_manifest),
                "e": _cli(rank, tmp, jdir),
                "f": _modes(rank)}
    finally:
        os.chdir(cwd)


# ---------------------------------------------------------------------------
# the pytest process: x3d2_tpu, and the spawn
# ---------------------------------------------------------------------------

def _x3d2_tpu_sharded_file(d):
    """x3d2_tpu's per-shard checkpoint of TGV 16^3 AB3 after 3 steps on its
    (2, 4) device mesh, with statistics; returns (manifest, its state and
    statistics as numpy)."""
    import jax

    from x3d2_tpu.cases import SolverParams as JSolverParams
    from x3d2_tpu.cases import TGVCase as JTGVCase
    from x3d2_tpu.common import BC as JBC
    from x3d2_tpu.io.sharded import write_sharded
    from x3d2_tpu.mesh import Mesh as JMesh
    from x3d2_tpu.parallel import make_device_mesh, shard_state

    case = JTGVCase(JMesh(DIMS_C, L, ((JBC.PERIODIC, JBC.PERIODIC),) * 3),
                    JSolverParams(Re=1600.0, time_intg="AB3", dt=1e-2),
                    dtype=jax.numpy.float64, monitor_path=None,
                    verbose=False)
    st = case.initial_state()
    for _ in range(3):
        st = case._step(st)
    rng = np.random.default_rng(20)
    stats = {"umean": rng.standard_normal(DIMS_C),
             "sample_count": np.asarray(3)}
    dmesh = make_device_mesh(2, 4, devices=jax.devices("cpu"))
    sst = shard_state(dmesh, st)
    manifest = write_sharded(str(d / "jck"), 3, sst, 0.03, 1e-2,
                             stats=stats, async_write=False)
    want = {k: np.asarray(st[k]) for k in ("u", "v", "w")}
    want["olds"] = [[np.asarray(o) for o in per] for per in st["olds"]]
    return manifest, want, stats


def _x3d2_tpu_cli(d, monkeypatch):
    from x3d2_tpu.__main__ import main as jmain
    d.mkdir()
    (d / "input.x3d").write_text(CLI_INPUT)
    monkeypatch.chdir(d)
    with monkeypatch.context() as m:
        m.setenv("X3D2_PALLAS", "0")
        with contextlib.redirect_stdout(io.StringIO()):
            jmain(["input.x3d", "--dtype", "f64", "--mesh", "2", "2"])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    store = tmp_path_factory.mktemp("store")
    mp = pytest.MonkeyPatch()
    try:
        for k in ("X3D2_FUSED_AB", "X3D2_FUSED_RK", "X3D2_PALLAS",
                  "X3D2_BFLY", "X3D2_MATMUL_PRECISION", "X3D2_D2C",
                  "X3D2_XDIV_FUSED", "X3D2_MERGED_X"):
            mp.delenv(k, raising=False)
        x_manifest, x_want, x_stats = _x3d2_tpu_sharded_file(tmp)
        _x3d2_tpu_cli(tmp / "j", mp)
        mp.chdir(tmp)
        res = multihost.spawn(_ranks, 4, (str(tmp), x_manifest,
                                          str(tmp / "j")), workdir=store)
    finally:
        mp.undo()
    yield {"tmp": tmp, "res": res, "x": (x_manifest, x_want, x_stats)}
    # the runs' files (about 2 GB) go with the module
    shutil.rmtree(tmp, ignore_errors=True)
    shutil.rmtree(store, ignore_errors=True)


def _same_state(got, want):
    for k in ("u", "v", "w"):
        np.testing.assert_array_equal(got[k], want[k])
    assert len(got["olds"]) == len(want["olds"])
    for a, b in zip(got["olds"], want["olds"]):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


# ---- (a), (b) --------------------------------------------------------------

def test_restart_on_the_same_mesh_is_bit_for_bit(ranks):
    assert ranks["res"][0]["a"]["same"]


@pytest.mark.parametrize("where", ["1x4", "one process"])
def test_restore_across_mesh_shapes(ranks, where):
    got = ranks["res"][0 if where == "1x4" else 3]["a"][where]
    assert got["bits"]
    assert got["mem"] < 1e-15
    assert got["err"] < 1e-14


def test_no_global_field_while_writing_or_restoring(ranks):
    """The poisoned gathers did not fire (the runs returned); the writes
    read nothing, and every restore read blocks only (asserted in the
    ranks); the shard files hold each rank's block alone."""
    a = ranks["res"][0]["a"]
    assert a["write_reads"] == []
    d = ranks["tmp"] / "a"
    files = sorted(d.glob("sck_000002.shards*.npz"))
    assert len(files) == 4 and (d / "sck_000002.manifest.npz").exists()
    pm = topo.ProcessMesh(2, 2)
    for r, f in enumerate(files):
        with np.load(f) as z:
            offs = tuple(s.start or 0
                         for s in topo.local_slices(pm, DIMS_A, r))
            assert f"u@{offs[0]}_{offs[1]}_{offs[2]}" in z.files
            assert all(z[k].shape == (32, 64, 256) for k in z.files)


# ---- (c), (d) --------------------------------------------------------------

def test_x3d2_tpu_files_restore_in_the_port(ranks):
    manifest, want, stats = ranks["x"]
    for r in ranks["res"]:
        c = r["c"]
        sl = c["slices"]
        for k in ("u", "v", "w"):
            np.testing.assert_array_equal(c["state"][k], want[k][sl])
        for got, per in zip(c["olds"], want["olds"]):
            assert len(got) == len(per) == 2
            for x, y in zip(got, per):
                np.testing.assert_array_equal(x, y[sl])
        np.testing.assert_array_equal(c["stats"]["umean"],
                                      stats["umean"][sl])
        assert int(c["stats"]["sample_count"]) == 3
        assert c["scalars"] == (3, 0.03, 1e-2, 4)
    # one process
    z = torch.zeros(DIMS_C, dtype=torch.float64)
    tmpl = {"u": z, "v": z, "w": z, "p": z, "istep": 1,
            "olds": ((z, z),) * 3}
    state, ts, _, _, st = sharded.restore_sharded(manifest, tmpl)
    _same_state({**{k: state[k].numpy() for k in ("u", "v", "w")},
                 "olds": [[o.numpy() for o in per]
                          for per in state["olds"]]}, want)
    np.testing.assert_array_equal(st["umean"], stats["umean"])


def test_port_files_restore_in_x3d2_tpu(ranks):
    import jax.numpy as jnp

    from x3d2_tpu.io.sharded import restore_sharded as jrestore

    a = ranks["res"][0]["a"]
    z = jnp.zeros(DIMS_A, jnp.float64)
    tmpl = {"u": z, "v": z, "w": z, "istep": jnp.asarray(1),
            "olds": ((z, z),) * 3}
    new, ts, t, dt, stats = jrestore(
        str(ranks["tmp"] / "a" / "sck_000002.manifest.npz"), tmpl)
    assert (ts, int(new["istep"])) == (2, 3) and stats == {}
    _same_state({**{k: np.asarray(new[k]) for k in ("u", "v", "w")},
                 "olds": [[np.asarray(o) for o in per]
                          for per in new["olds"]]}, a["st2"])


def test_port_statistics_restore_in_x3d2_tpu(ranks):
    """The CLI's per-shard checkpoint at step 4 (u, v, w, the history and
    the statistics, written by four ranks) through x3d2_tpu's
    restore_sharded: every array the port's own reader gives, the sample
    count (one element: x3d2_tpu's reader cannot parse its own 0-d
    chunk) too."""
    import jax.numpy as jnp

    from x3d2_tpu.io.sharded import restore_sharded as jrestore

    e = ranks["tmp"] / "e"
    port = _merged(e / "mesh", e / "x4", 4)
    z = jnp.zeros(DIMS_E, jnp.float64)
    tmpl = {"u": z, "v": z, "w": z, "istep": jnp.asarray(1),
            "olds": ((z, z),) * 3}
    new, ts, _, _, stats = jrestore(
        str(e / "x4" / "checkpoint_000004.manifest.npz"), tmpl)
    assert ts == 4 and int(np.asarray(stats["sample_count"])[0]) == 3
    for k in ("u", "v", "w"):
        np.testing.assert_array_equal(np.asarray(new[k]), port.read_global(k))
    assert sorted(stats) == sorted(n[len("stats_"):] for n in port.names()
                                   if n.startswith("stats_"))
    for k, v in stats.items():
        np.testing.assert_array_equal(v, port.read_global(f"stats_{k}"))


# ---- (e) -------------------------------------------------------------------

def _rows(path):
    lines = Path(path).read_text().strip().splitlines()
    assert lines[0] == "time,enstrophy,div_u_max,div_u_mean,ke"
    return np.array([[float(x) for x in ln.split(",")] for ln in lines[1:]])


def _same_rows(got, want):
    assert got.shape == want.shape
    for col in (0, 1, 4):
        np.testing.assert_allclose(got[:, col], want[:, col], rtol=1e-12,
                                   atol=0)
    for col in (2, 3):
        assert np.abs(got[:, col] - want[:, col]).max() <= 1e-13


def _merged(run_dir, dest, step):
    """The per-shard checkpoint at `step` of a run whose ranks wrote into
    their own directories, gathered into `dest`: a ChunkReader on it."""
    dest.mkdir(exist_ok=True)
    for f in run_dir.glob(f"rank*/checkpoint_{step:06d}.*"):
        (dest / f.name).symlink_to(f)
    return sharded.ChunkReader(str(dest / f"checkpoint_{step:06d}"
                                          ".manifest.npz"))


def _close(got, want):
    """To 1e-13, absolute for arrays of order one or less (the velocities,
    their history and means, as tests/test_sharded_io.py:132-133 holds its
    CLI checkpoints), relative to the largest value above that (the
    pressure mean, of order 1/dt)."""
    want = np.asarray(want)
    return np.abs(got - want).max() <= 1e-13 * max(1.0, np.abs(want).max())


def _same_stats(a, b):
    """Two statistics archives (as tests/test_torch_io.py's rule, the RMS
    by its square) held by _close at 1e-12: the means of w are of the
    order of 1e-4 here, so relative errors read float64 rounding of
    their cancelling sums scaled up by 1e4."""
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        got, want = a[k], b[k]
        if k.endswith("prime"):
            got, want = got ** 2, want ** 2
        assert np.abs(got - want).max() <= 1e-12 * max(
            1.0, np.abs(want).max()), k


def _same_checkpoint(reader, jpath):
    """Every array of x3d2_tpu's global checkpoint in the port's per-shard
    one (_close)."""
    with np.load(jpath) as z:
        names = reader.names()
        for k in z.files:
            if k in ("key", "timestep", "time", "dt", "n_olds_vars"):
                continue
            if k.startswith("olds_"):
                for j, want in enumerate(z[k]):
                    assert _close(reader.read_global(f"{k}_{j}"), want), \
                        (k, j)
                continue
            assert k in names, k
            assert _close(reader.read_global(k), z[k]), k
        m = reader.manifest
        assert int(m["timestep"]) == int(z["timestep"])
        assert float(m["time"]) == float(z["time"])


def _same_single(a, b):
    """Single-precision snapshot arrays: within one float32 ulp of each
    value plus 1e-12 of max(1, the largest value) (test_torch_cli.py's
    rule, with _close's floor: w is of order 1e-4 here)."""
    assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
    scale = 1e-12 * max(1.0, float(np.abs(b).max()))
    assert (np.abs(a - b) <= np.spacing(np.abs(b)) + scale).all()


def test_cli_on_a_mesh_matches_x3d2_tpu(ranks):
    from test_torch_io import _payloads

    tmp, res = ranks["tmp"], ranks["res"]
    j, run = tmp / "j", tmp / "e" / "mesh"
    r0 = run / "rank0"
    out0 = res[0]["e"]["mesh"]
    assert ("Flow case: tgv; grid (32, 128, 256); AB3" in out0
            and "4 processes on a (2, 2) mesh over gloo" in out0)
    assert out0.count("Checkpoint written (sharded)") == 2
    assert all(r["e"]["mesh"] == "" for r in res[1:])
    _same_rows(_rows(r0 / "monitoring.csv"), _rows(j / "monitoring.csv"))
    for step in (2, 4):
        _same_checkpoint(_merged(run, tmp / "e" / f"ck{step}", step),
                         j / f"checkpoint_{step:06d}.npz")
    _same_stats(np.load(r0 / "statistics_000004.npz"),
                np.load(j / "statistics_000004.npz"))
    snap = "snapshot_out/step_000004.npz"
    with np.load(r0 / snap) as zt, np.load(j / snap) as zj:
        assert sorted(zt.files) == sorted(zj.files)
        for k in zj.files:
            if zj[k].dtype == np.float32:
                _same_single(zt[k], zj[k])
            else:
                assert zt[k] == zj[k], k
    pt, xt = _payloads(r0 / "snapshot_out/step_000004.vti")
    pj, xj = _payloads(j / "snapshot_out/step_000004.vti")
    assert xt == xj and sorted(pt) == sorted(pj)
    for name in pt:
        _same_single(pt[name], pj[name])
    assert (r0 / "snapshot.pvd").read_text() == (j / "snapshot.pvd"
                                                 ).read_text()
    # rank 0 alone writes the monitoring file, statistics, snapshots and
    # the manifest; every rank its shard file
    for r in range(4):
        names = sorted(p.name for p in (run / f"rank{r}").iterdir())
        shards = [f"checkpoint_{s:06d}.shards{r:04d}.npz" for s in (2, 4)]
        if r:
            assert names == sorted(shards + ["input.x3d"]), names
        else:
            assert set(shards) < set(names) and {
                "monitoring.csv", "statistics_000004.npz", "snapshot_out",
                "snapshot.pvd", "checkpoint_000004.manifest.npz"} < set(names)


def test_cli_nproc_dir_is_the_mesh_run(ranks):
    tmp = ranks["tmp"] / "e"
    assert ((tmp / "nproc" / "rank0" / "monitoring.csv").read_text()
            == (tmp / "mesh" / "rank0" / "monitoring.csv").read_text())
    # keep_checkpoint off: the step-2 files are gone from every rank
    for r in range(4):
        assert sorted(p.name for p in (tmp / "nproc" / f"rank{r}").glob(
            "checkpoint_*")) == ([f"checkpoint_000004.manifest.npz"]
                                 if r == 0 else []) + [
            f"checkpoint_000004.shards{r:04d}.npz"]
    a = _merged(tmp / "mesh", tmp / "m4", 4)
    b = _merged(tmp / "nproc", tmp / "n4", 4)
    assert a.names() == b.names()
    for k in a.names():
        np.testing.assert_array_equal(a.read_global(k), b.read_global(k))


def test_cli_restarts_on_a_mesh(ranks):
    tmp, res = ranks["tmp"], ranks["res"]
    e = tmp / "e"
    out0 = res[0]["e"]["restart"]
    assert "Restart from checkpoint_000002.manifest.npz at iteration 2" \
        in out0
    assert ((e / "restart" / "monitoring.csv").read_text()
            == (e / "mesh" / "rank0" / "monitoring.csv").read_text())
    # the statistics archive, gathered from the restored accumulators
    with np.load(e / "restart" / "statistics_000004.npz") as za, \
            np.load(e / "mesh" / "rank0" / "statistics_000004.npz") as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            np.testing.assert_array_equal(za[k], zb[k])
    got = sharded.ChunkReader(str(e / "restart"
                                  / "checkpoint_000004.manifest.npz"))
    want = _merged(e / "mesh", e / "u4", 4)
    assert got.names() == want.names()
    for k in got.names():
        np.testing.assert_array_equal(got.read_global(k),
                                      want.read_global(k))
    # from x3d2_tpu's global file
    assert "Restart from" in res[0]["e"]["from_j"]
    j = tmp / "j"
    _same_checkpoint(sharded.ChunkReader(str(
        e / "from_j" / "checkpoint_000004.manifest.npz")),
        j / "checkpoint_000004.npz")
    _same_rows(_rows(e / "from_j" / "monitoring.csv"),
               _rows(j / "monitoring.csv")[3:])


# ---- (f) -------------------------------------------------------------------

def _x3d2_tpu_step(time_intg):
    import jax.numpy as jnp

    from x3d2_tpu.cases import SolverParams as JSolverParams
    from x3d2_tpu.cases import TGVCase as JTGVCase
    from x3d2_tpu.common import BC as JBC
    from x3d2_tpu.mesh import Mesh as JMesh

    with pytest.MonkeyPatch.context() as m:
        m.setenv("X3D2_PALLAS", "0")
        case = JTGVCase(JMesh(DIMS_F, L, ((JBC.PERIODIC, JBC.PERIODIC),) * 3),
                        JSolverParams(Re=1600.0, time_intg=time_intg,
                                      dt=1e-3),
                        dtype=jnp.float64, monitor_path=None, verbose=False)
        st = case._step(case.initial_state())
    return {k: np.asarray(st[k]) for k in ("u", "v", "w")}


@pytest.mark.parametrize("mode", ["rk3", "d2c"])
def test_gathered_step_modes(ranks, mode):
    res = ranks["res"]
    got = res[0]["f"][mode]
    ref = res[1 if mode == "rk3" else 2]["f"][mode]["ref"]
    assert got["gathered"] == {"fused_rk": mode == "rk3",
                               "d2c": mode == "d2c"}
    assert got["solver"]["_repencil_pressure"]
    assert _vel_err(got["state"], ref) < 7e-9
    want = _x3d2_tpu_step("RK3" if mode == "rk3" else "AB3")
    assert _vel_err(got["state"], want) < 1e-6


# ---- the entry point's rendezvous and transport ------------------------------

def test_coordinator_needs_a_world(monkeypatch):
    """--coordinator host:port is a tcp:// rendezvous: without a world of
    more than one process it raises (N runs would write over each other's
    files), before any group exists."""
    for k in ("WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="world size"):
        multihost.maybe_init_distributed(coordinator="localhost:29555")
    assert not dist.is_initialized()


@pytest.mark.parametrize("device,cards,ranks,want", [
    ("cpu", 4, "4", "gloo"), ("cuda", 1, "4", "gloo"),
    ("cuda", 4, "4", "nccl"), ("cuda", 8, "4", "nccl"),
    ("cuda", 2, "4", "gloo")])
def test_transport_rule(monkeypatch, device, cards, ranks, want):
    """nccl where the host's cards cover its ranks (torchrun's
    LOCAL_WORLD_SIZE), gloo otherwise (every rank on cuda:0) and on the
    CPU: chosen from what the host has, before any group exists."""
    monkeypatch.setenv("LOCAL_WORLD_SIZE", ranks)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert multihost.transport(device) == want


def test_transport_needs_the_host_ranks(monkeypatch):
    """A multi-process run on the card launched without LOCAL_WORLD_SIZE
    and LOCAL_RANK (--coordinator with RANK and WORLD_SIZE alone) raises:
    WORLD_SIZE is not the host's rank count, so neither the backend nor a
    rank's card can be chosen from it. On the CPU it stays gloo."""
    for k in ("LOCAL_WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("WORLD_SIZE", "8")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    with pytest.raises(ValueError, match="LOCAL_WORLD_SIZE"):
        multihost.transport("cuda")
    assert multihost.transport("cpu") == "gloo"
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert multihost.transport("cuda") == "nccl"
