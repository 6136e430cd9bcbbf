"""The port's IO layer against x3d2_tpu's, on the same numpy inputs.

- The native helpers (x3d2_tpu_torch/native/x3d2io.cpp, built with g++
  into build/x3d2_tpu_torch/) against the pure-Python plain versions and
  against x3d2_tpu.io.native's output: the same bytes. The background
  writer renames into place and raises on a failed write; a failed build
  raises.
- vort, qcrit and pressure_vert against x3d2_tpu.postprocess, float64,
  rtol 1e-12 of the largest value (the same float64 operators applied in
  another summation order; test_torch_tgv.py:77 holds the series so).
- The statistics: both packages' StatsManager fed the port's states of a
  TGV run with the pressure kept and two scalars; the accumulators, the
  checkpointed statistics and the written archives agree to 1e-12 of each
  array's largest value (the RMS and the stresses, differences of two
  moments, to 1e-12 of the second moment).
- Restarts in the port are bit for bit: AB3, two scalars, compensated
  stepping, a bfloat16 history, and the statistics through a restart;
  with sharded_io on one process the per-shard files (io/sharded.py)
  restore bit for bit too (tests/test_torch_sharded_io.py holds them on
  meshes and across the packages).
- Checkpoints cross the packages both ways: a file written by one package
  at step 5 and continued 5 steps by the other equals the writer's own
  10 steps to 1e-12 (float64).
- Snapshot files, strided, in float64 and single precision, against
  x3d2_tpu's on the same state: npz keys and arrays (float64 to 1e-12,
  float32 within one ulp plus that: the float32 rounding of float64
  values that agree to 1e-15 may fall either side), the VTK XML with its
  payloads decoded, the .pvd; both packages' readers read both stores, bit for bit
  against the files. The .vtr of a stretched mesh carries the mesh's
  vertex coordinates.
"""

import base64
import io as _io
import os
import struct
import xml.etree.ElementTree as ET
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax.numpy as jnp

from x3d2_tpu import postprocess as jpost
from x3d2_tpu.cases import SolverParams as JSolverParams
from x3d2_tpu.cases import TGVCase as JTGVCase
from x3d2_tpu.common import BC as JBC
from x3d2_tpu.config import CheckpointConfig as JCheckpointConfig
from x3d2_tpu.config import StatsConfig as JStatsConfig
from x3d2_tpu.io import native as jnative
from x3d2_tpu.io.manager import IOManager as JIOManager
from x3d2_tpu.io.reader import SnapshotReader as JSnapshotReader
from x3d2_tpu.io.snapshot import SnapshotManager as JSnapshotManager
from x3d2_tpu.io.stats import StatsManager as JStatsManager
from x3d2_tpu.mesh import Mesh as JMesh

from x3d2_tpu_torch import postprocess
from x3d2_tpu_torch._build import BUILD_DIR
from x3d2_tpu_torch.cases import SolverParams, TGVCase
from x3d2_tpu_torch.common import BC, env_set
from x3d2_tpu_torch.config import CheckpointConfig, StatsConfig
from x3d2_tpu_torch.io import native
from x3d2_tpu_torch.io.manager import IOManager
from x3d2_tpu_torch.io.reader import SnapshotReader, StatsReader
from x3d2_tpu_torch.io.snapshot import SnapshotManager
from x3d2_tpu_torch.io.stats import StatsManager
from x3d2_tpu_torch.mesh import Mesh

# one thread for torch and for numpy's BLAS: the suite runs several workers
# on one machine
torch.set_num_threads(1)
threadpool_limits(1, user_api="blas")

N = (16, 16, 16)
L = (2 * np.pi,) * 3
PER = ((BC.PERIODIC, BC.PERIODIC),) * 3
JPER = ((JBC.PERIODIC, JBC.PERIODIC),) * 3
RTOL = 1e-12


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _params(**kw):
    base = dict(Re=1600.0, time_intg="AB3", dt=1e-2)
    base.update(kw)
    return base


def _case(dtype=torch.float64, keep_pressure=True, **kw):
    return TGVCase(Mesh(N, L, PER), SolverParams(**_params(**kw)),
                   dtype=dtype, monitor_path=None, verbose=False,
                   keep_pressure=keep_pressure, device="cpu")


def _jcase(dtype=jnp.float64, keep_pressure=True, **kw):
    return JTGVCase(JMesh(N, L, JPER), JSolverParams(**_params(**kw)),
                    dtype=dtype, monitor_path=None, verbose=False,
                    keep_pressure=keep_pressure)


def _np(x):
    x = x.detach().cpu() if torch.is_tensor(x) else x
    if torch.is_tensor(x):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


# ---------------------------------------------------------------------------
# the native helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("stride", [(1, 1, 1), (2, 3, 2), (3, 1, 5)])
def test_pack_strided_matches_plain_and_x3d2_tpu(dtype, stride):
    a = np.random.default_rng(0).normal(size=(33, 17, 24)).astype(dtype)
    got = native.pack_strided(a, stride)
    assert got.dtype == np.float32
    assert got.tobytes() == native.pack_strided_plain(a, stride).tobytes()
    assert got.tobytes() == jnative.pack_strided(a, stride).tobytes()


@pytest.mark.parametrize("n", [0, 1, 2, 3, 1000])
def test_vtk_b64_matches_plain_and_x3d2_tpu(n):
    data = np.random.default_rng(n).normal(size=n).astype(np.float32)
    got = native.vtk_b64(data)
    assert got == native.vtk_b64_plain(data) == jnative.vtk_b64(data)


def test_native_library_is_built_into_the_port_build_dir():
    lib = native.build()
    assert lib.parent == BUILD_DIR and lib.name.startswith("libx3d2io-")
    assert native.get_lib()._name == str(lib)


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "x3d2io.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()


def test_async_write_atomic_and_failure_raises(tmp_path):
    rng = np.random.default_rng(1)
    blob = rng.bytes(1 << 20)
    native.async_write(str(tmp_path / "a.bin"), blob)
    buf = _io.BytesIO()
    np.savez(buf, x=np.arange(10.0))
    view = buf.getbuffer()
    native.async_write(str(tmp_path / "b.npz"), view)
    del view
    native.async_flush()
    assert (tmp_path / "a.bin").read_bytes() == blob
    assert np.array_equal(np.load(tmp_path / "b.npz")["x"], np.arange(10.0))
    assert sorted(p.name for p in tmp_path.iterdir()) == ["a.bin", "b.npz"]
    native.write_atomic_plain(str(tmp_path / "c.bin"), blob)
    assert (tmp_path / "c.bin").read_bytes() == blob
    native.async_write(str(tmp_path / "missing" / "d.bin"), blob)
    with pytest.raises(OSError, match="1 background write"):
        native.async_flush()
    native.async_flush()   # the failure is reported once


# ---------------------------------------------------------------------------
# postprocess
# ---------------------------------------------------------------------------

def test_derived_fields_match_x3d2_tpu():
    case, jcase = _case(), _jcase()
    rng = np.random.default_rng(2)
    u, v, w = (rng.normal(size=N) for _ in range(3))
    p = rng.normal(size=case.mesh.dims(111))
    got = postprocess.make_derived_fields_fn(
        case.solver, case.dt, ("vort", "qcrit", "pressure"))(
        *(torch.from_numpy(f) for f in (u, v, w)), torch.from_numpy(p))
    want = jpost.make_derived_fields_fn(
        jcase.solver, jcase.dt, ("vort", "qcrit", "pressure"))(
        *(jnp.asarray(f) for f in (u, v, w)), jnp.asarray(p))
    assert sorted(got) == sorted(want) == ["pressure", "qcrit", "vort"]
    for k in got:
        assert _rel(got[k].numpy(), want[k]) <= RTOL, k
    g = postprocess.velocity_gradients(
        case.solver, *(torch.from_numpy(f) for f in (u, v, w)))
    jg = jpost.velocity_gradients(jcase.solver,
                                  *(jnp.asarray(f) for f in (u, v, w)))
    assert sorted(g) == sorted(jg) and len(g) == 9
    for k in g:
        assert _rel(g[k].numpy(), jg[k]) <= RTOL, k


# ---------------------------------------------------------------------------
# statistics
# ---------------------------------------------------------------------------
def _same_stats(a, b):
    """Two statistics archives: the same keys; the RMS and the stresses,
    differences of two moments (uu - u u, uv - u v) that are small over a
    few samples, to 1e-12 of the second moment (the RMS by its square);
    the rest to 1e-12 of its largest value."""
    assert sorted(a.files) == sorted(b.files)
    stress = {"uvmean": "uv", "uwmean": "uw", "vwmean": "vw"}
    for k in a.files:
        if k.endswith("prime"):
            mean = b[k.replace("prime", "mean")]
            got, want = a[k] ** 2, b[k] ** 2
            second = want + mean ** 2
        elif k in stress:
            got, want = a[k], b[k]
            second = want + b[stress[k][0] + "mean"] * b[stress[k][1] + "mean"]
        else:
            got, want, second = a[k], b[k], b[k]
        err = np.abs(got - want).max() / max(np.abs(second).max(), 1e-300)
        assert err <= RTOL, k


def test_stats_match_x3d2_tpu(tmp_path):
    """Both managers take the port's states of 5 steps (initstat 2,
    istatfreq 1: 4 samples) with p kept and two scalars."""
    kw = dict(n_species=2, pr_species=(0.7, 1.0))
    case, jcase = _case(**kw), _jcase(**kw)
    cfg = dict(initstat=2, istatfreq=1, istatout=5)
    sm = StatsManager(case, StatsConfig(
        stats_prefix=str(tmp_path / "t"), **cfg), verbose=False)
    jsm = JStatsManager(jcase, JStatsConfig(
        stats_prefix=str(tmp_path / "j"), **cfg), verbose=False)
    s = case.initial_state()
    for it in range(1, 6):
        s = case.step(s)
        js = {k: jnp.asarray(_np(s[k])) for k in ("u", "v", "w", "p", "phi")}
        sm.update(s, it)
        jsm.update(js, it)
    assert sm.sample_count == jsm.sample_count == 4
    got, want = sm.checkpoint_state(), jsm.checkpoint_state()
    assert sorted(got) == sorted(want)
    assert {"pmean", "phimean", "phiphimean"} <= set(got)
    for k in got:
        assert _rel(got[k], want[k]) <= RTOL, k
    assert sm.should_write(5) and jsm.should_write(5)
    a = np.load(sm.write(5))
    b = np.load(jsm.write(5))
    _same_stats(a, b)
    r = StatsReader(str(tmp_path / "j")).latest()
    assert all(np.array_equal(r[k], b[k]) for k in b.files)


# ---------------------------------------------------------------------------
# restarts within the port
# ---------------------------------------------------------------------------

RESTARTS = {
    "ab3": (torch.float64, {}, {}),
    "species": (torch.float64, dict(n_species=2, pr_species=(0.7, 1.0)), {}),
    "compensated": (torch.float32, dict(compensated=True), {}),
    "bf16_history": (torch.float32, {}, {"X3D2_BF16_OLDS": "1"}),
}


@pytest.mark.parametrize("name", sorted(RESTARTS))
def test_restart_is_bit_exact(tmp_path, name):
    dtype, kw, env = RESTARTS[name]
    prefix = str(tmp_path / "ck")
    stats = StatsConfig(initstat=2, istatfreq=1)
    with env_set(env):
        a, b = _case(dtype, **kw), _case(dtype, **kw)
    ck = CheckpointConfig(checkpoint_freq=5, checkpoint_prefix=prefix,
                          keep_checkpoint=True,
                          snapshot_prefix=str(tmp_path / "snap"))
    io_a = IOManager(a, ck, stats)
    sa = a.run(n_iters=10, state=a.initial_state(), n_output=10**9,
               io_manager=io_a)
    ck2 = CheckpointConfig(restart_from_checkpoint=True,
                           restart_file=f"{prefix}_000005.npz",
                           checkpoint_prefix=prefix,
                           snapshot_prefix=str(tmp_path / "snap"))
    io_b = IOManager(b, ck2, stats)
    sb = io_b.handle_restart(b.initial_state())
    assert sb["istep"] == 6
    sb = b.run(n_iters=5, state=sb, n_output=10**9, io_manager=io_b)
    if name == "bf16_history":
        assert sa["olds"][0][0].dtype == torch.bfloat16
    keys = [k for k in ("u", "v", "w", "phi") if k in sa]
    for k in keys:
        assert torch.equal(sa[k], sb[k]), k
    for pa, pb in zip(sa["olds"], sb["olds"]):
        assert all(torch.equal(x, y) for x, y in zip(pa, pb))
        assert all(x.dtype == y.dtype for x, y in zip(pa, pb))
    if "comp" in sa:
        assert all(torch.equal(x, y) for x, y in zip(sa["comp"], sb["comp"]))
    assert io_b.stats_mgr.sample_count == io_a.stats_mgr.sample_count == 9
    for k, t in io_a.stats_mgr.acc.items():
        assert torch.equal(t, io_b.stats_mgr.acc[k]), k


def test_checkpoint_cleanup_latest_and_rng(tmp_path):
    prefix = str(tmp_path / "c")
    case = _case()
    ck = CheckpointConfig(checkpoint_freq=2, checkpoint_prefix=prefix,
                          snapshot_prefix=str(tmp_path / "snap"))
    io = IOManager(case, ck, StatsConfig())
    s = case.initial_state()
    torch.rand(7, generator=s["rng"])   # a generator moved on
    s = case.run(n_iters=6, state=s, n_output=10**9, io_manager=io)
    assert sorted(os.listdir(tmp_path)) == ["c_000006.npz", "snap_out"]
    assert io.checkpoint_mgr.latest() == f"{prefix}_000006.npz"
    t = case.initial_state()
    r, ts, tm, dt, st = io.checkpoint_mgr.restore(t)
    assert (ts, r["istep"], st) == (6, 7, {})
    assert tm == pytest.approx(0.06) and dt == 1e-2
    assert torch.equal(r["rng"].get_state(), s["rng"].get_state())
    # sharded_io on one process: x3d2_tpu's per-shard files (one shard),
    # which latest() finds and restore() reads back bit for bit
    sh = IOManager(case, CheckpointConfig(
        checkpoint_freq=1, sharded_io=True, checkpoint_prefix=prefix,
        snapshot_prefix=str(tmp_path / "snap")), StatsConfig())
    path = sh.checkpoint_mgr.write(s, 7, 0.07, 1e-2)
    assert path == f"{prefix}_000007.manifest.npz"
    assert sh.checkpoint_mgr.latest() == path
    assert os.path.exists(f"{prefix}_000007.shards0000.npz")
    r, ts, tm, dt, st = sh.checkpoint_mgr.restore(case.initial_state())
    assert (ts, r["istep"], st, tm, dt) == (7, 8, {}, 0.07, 1e-2)
    for k in ("u", "v", "w"):
        assert torch.equal(r[k], s[k])
    for a, b in zip(r["olds"], s["olds"]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert torch.equal(r["rng"].get_state(), s["rng"].get_state())


# ---------------------------------------------------------------------------
# checkpoints across the packages
# ---------------------------------------------------------------------------

CROSS = {"ab3": {}, "species": dict(n_species=2, pr_species=(0.7, 1.0))}


@pytest.mark.parametrize("name", sorted(CROSS))
def test_checkpoints_cross_the_packages(tmp_path, name):
    """x3d2_tpu's step-5 file continued 5 steps in the port equals
    x3d2_tpu's own 10 steps, and the port's step-5 file continued in
    x3d2_tpu equals the port's own 10 steps (float64, 1e-12)."""
    kw = CROSS[name]
    tp, jp = str(tmp_path / "t"), str(tmp_path / "j")
    snap = dict(snapshot_prefix=str(tmp_path / "snap"))
    case, jcase = _case(**kw), _jcase(**kw)
    st = case.run(n_iters=10, state=case.initial_state(), n_output=10**9,
                  io_manager=IOManager(case, CheckpointConfig(
                      checkpoint_freq=5, checkpoint_prefix=tp,
                      keep_checkpoint=True, **snap), StatsConfig()))
    js = jcase.run(n_iters=10, state=jcase.initial_state(), n_output=10**9,
                   io_manager=JIOManager(jcase, JCheckpointConfig(
                       checkpoint_freq=5, checkpoint_prefix=jp,
                       keep_checkpoint=True, **snap), JStatsConfig()))
    # the port continues x3d2_tpu's file
    c2 = _case(**kw)
    io2 = IOManager(c2, CheckpointConfig(
        restart_from_checkpoint=True, restart_file=f"{jp}_000005.npz",
        **snap), StatsConfig())
    s2 = c2.run(n_iters=5, state=io2.handle_restart(c2.initial_state()),
                n_output=10**9)
    # x3d2_tpu continues the port's file
    j2 = _jcase(**kw)
    jio2 = JIOManager(j2, JCheckpointConfig(
        restart_from_checkpoint=True, restart_file=f"{tp}_000005.npz",
        **snap), JStatsConfig())
    js2 = j2.run(n_iters=5, state=jio2.handle_restart(j2.initial_state()),
                 n_output=10**9)
    for k in [k for k in ("u", "v", "w", "phi") if k in st]:
        assert _rel(_np(s2[k]), js[k]) <= RTOL, k
        assert _rel(js2[k], _np(st[k])) <= RTOL, k
    # the two formats: the same keys but x3d2_tpu's PRNG key and the
    # port's generator state
    zt, zj = np.load(f"{tp}_000010.npz"), np.load(f"{jp}_000010.npz")
    assert set(zt.files) - {"torch_rng_cpu"} == set(zj.files) - {"key"}
    for k in zj.files:
        if k != "key":
            assert zt[k].shape == zj[k].shape and _rel(zt[k], zj[k]) <= RTOL


# ---------------------------------------------------------------------------
# snapshots
# ---------------------------------------------------------------------------

def _payloads(path):
    """{name: float32 array} of a VTK XML file's DataArrays, and the file's
    text with the payloads taken out."""
    root = ET.parse(path).getroot()
    out = {}
    for da in root.iter("DataArray"):
        raw = base64.b64decode(da.text.strip())
        n = struct.unpack("<I", raw[:4])[0]
        out[da.get("Name")] = np.frombuffer(raw[4:4 + n], np.float32)
        da.text = ""
    return out, ET.tostring(root)


def _same_arrays(a, b):
    """float64 to 1e-12 of the largest value; float32 roundings of float64
    values that agree so: within one float32 ulp of each value plus that
    1e-12 (w of the TGV is a few 1e-17 of rounding, whose float32 values
    are many ulps apart)."""
    assert a.dtype == b.dtype and a.shape == b.shape
    scale = RTOL * np.abs(b).max()
    if a.dtype == np.float32:
        assert (np.abs(a - b) <= np.spacing(np.abs(b)) + scale).all()
    else:
        assert np.abs(a - b).max() <= scale


@pytest.mark.parametrize("sp", [True, False], ids=["single", "double"])
def test_snapshots_match_x3d2_tpu(tmp_path, sp):
    fields = ("vort", "qcrit", "pressure")
    case, jcase = _case(), _jcase()
    s = case.initial_state()
    for _ in range(3):
        s = case.step(s)
    js = {k: jnp.asarray(_np(s[k])) for k in ("u", "v", "w", "p")}
    out = {}
    for tag, mgr_cls, cfg_cls, c, st in (
            ("t", SnapshotManager, CheckpointConfig, case, s),
            ("j", JSnapshotManager, JCheckpointConfig, jcase, js)):
        cfg = cfg_cls(snapshot_freq=1, output_stride=(2, 1, 3),
                      snapshot_sp=sp, output_fields=fields,
                      snapshot_prefix=str(tmp_path / tag))
        mgr = mgr_cls(c, cfg, verbose=False)
        for ts in (3, 4):
            mgr.write(st, ts, ts * 1e-2)
        out[tag] = tmp_path / f"{tag}_out"
    for ts in (3, 4):
        zt = np.load(out["t"] / f"step_{ts:06d}.npz")
        zj = np.load(out["j"] / f"step_{ts:06d}.npz")
        assert sorted(zt.files) == sorted(zj.files) == sorted(
            ("u", "v", "w", "time", "timestep") + fields)
        assert zt["u"].shape == (8, 16, 6)
        assert zt["timestep"] == ts and zt["time"] == zj["time"]
        for k in ("u", "v", "w") + fields:
            _same_arrays(zt[k], zj[k])
        pt, xt = _payloads(out["t"] / f"step_{ts:06d}.vti")
        pj, xj = _payloads(out["j"] / f"step_{ts:06d}.vti")
        assert xt == xj and sorted(pt) == sorted(pj)
        for k in pt:
            _same_arrays(pt[k], pj[k])
            assert np.array_equal(
                pt[k], np.transpose(zt[k], (2, 1, 0)).ravel()
                .astype(np.float32))
    pvd_t = (tmp_path / "t.pvd").read_text()
    assert pvd_t.replace(str(tmp_path / "t"), "X") == (
        tmp_path / "j.pvd").read_text().replace(str(tmp_path / "j"), "X")
    # each package's reader on each store, bit for bit against the files
    for store in out.values():
        for reader in (SnapshotReader, JSnapshotReader):
            with reader(str(store)) as r:
                assert r.timesteps == [3, 4]
                assert list(r.times()) == [3e-2, 4e-2]
                for ts in r.timesteps:
                    z = np.load(store / f"step_{ts:06d}.npz")
                    for k in r.fields(ts):
                        assert np.array_equal(r.read(ts, k), z[k]), k
                assert r.series("vort").shape == (2, 8, 16, 6)


def test_vtr_on_a_stretched_mesh(tmp_path):
    """The stretched y of the channel example: the .vtr's coordinates are
    the mesh's vertex coordinates, strided, and the file equals
    x3d2_tpu's."""
    dims, box = (16, 17, 16), (4.0, 2.0, 2.0)
    bcs = ((BC.PERIODIC,) * 2, (BC.DIRICHLET,) * 2, (BC.PERIODIC,) * 2)
    jbcs = ((JBC.PERIODIC,) * 2, (JBC.DIRICHLET,) * 2, (JBC.PERIODIC,) * 2)
    stretch = dict(stretching=("uniform", "top-bottom", "uniform"),
                   beta=(1.0, 0.259065151, 1.0))
    mesh = Mesh(dims, box, bcs, **stretch)
    jmesh = JMesh(dims, box, jbcs, **stretch)
    assert mesh.stretched == (False, True, False)
    rng = np.random.default_rng(3)
    state = {k: rng.normal(size=dims) for k in "uvw"}
    for tag, mgr_cls, cfg_cls, m, st in (
            ("t", SnapshotManager, CheckpointConfig, mesh,
             {k: torch.from_numpy(a) for k, a in state.items()}),
            ("j", JSnapshotManager, JCheckpointConfig, jmesh, state)):
        c = SimpleNamespace(mesh=m, params=SimpleNamespace(n_species=0),
                            dt=1e-2, solver=None)
        cfg = cfg_cls(snapshot_freq=1, output_stride=(1, 2, 1),
                      snapshot_sp=True, snapshot_prefix=str(tmp_path / tag))
        mgr_cls(c, cfg, verbose=False).write(st, 1, 1e-2)
    path = tmp_path / "t_out" / "step_000001.vtr"
    assert not (tmp_path / "t_out" / "step_000001.vti").exists()
    assert path.read_text() == (
        tmp_path / "j_out" / "step_000001.vtr").read_text()
    arrays, _ = _payloads(path)
    for a, name in enumerate("XYZ"):
        want = np.asarray(mesh.geo[a].vert_coords, np.float32)[
            ::(1, 2, 1)[a]]
        assert np.array_equal(arrays[name], want), name
    assert arrays["Y"][0] == 0.0 and arrays["Y"][-1] == np.float32(2.0)
    assert np.array_equal(
        arrays["u"], np.transpose(state["u"][:, ::2], (2, 1, 0)).ravel()
        .astype(np.float32))
