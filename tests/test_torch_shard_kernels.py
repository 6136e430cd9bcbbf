"""The sharded kernel paths' single-rank pieces in the port against
x3d2_tpu, on the CPU (one process, one shard at a time).

- The halo form of the momentum sweep (the plain version of the
  transeq_sweep kernel's halo instances): one shard of (128, 128, 256)
  split in 2 along y (accumulate, as the sharded chain's y sweep) and
  along z (without, as its z sweep), at x3d2_tpu's terms 2 and 3 (the
  port's W = 16 and 32), and along a wall-bounded (Dirichlet) y, which
  x3d2_tpu's gate admits (square operators, closure rows in the first and
  last global blocks). The halo-extended operands are slices of the global
  field, as the neighbour exchange gives them. Held against:
  - the port's unsharded plain sweep of the global field, restricted to
    the shard, in float64: the same operators and windows, 1e-12 * scale;
  - x3d2_tpu's make_transeq_dir_v3(..., n_shards=2, interpret=True) with
    its exts and off: 3e-5 * scale of the float64 plain version at terms 2
    (x3d2_tpu's bf16x3 noise; tests/test_pallas_v3.py:63), 5e-7 at terms
    3 (:114), both sides;
  - the port's float32 plain version at the same limits.
- The species halo form, 2 scalars, along y and z, the same way
  (make_species_dir_v3(..., n_shards=2)).
- The local-batch mid (make_mid_local) over the x batch of rank 2 of
  (64, 128, 256) on a (2, 2) mesh (16 planes at x offset 32, the tables
  sliced there in the x stage's parity order): its plain version (float32)
  against x3d2_tpu's make_pressure_slab(terms=3, interpret=True)[4](16)
  with its sliced tables, at 2e-4 * scale (tests/test_torch_mid_forms.py,
  the reference's bf16 split noise); its einsum form against x3d2_tpu's
  make_mid_local.einsum the same way; in float64 against the whole-x mid
  restricted to the batch (1e-12 * scale).
- The gates (sharded_transeq_supported, sharded_x_apply_supported,
  repencil_supported, the full-plane mid's VMEM gate and tiled_supported)
  against x3d2_tpu's on 512^3 and 1024^3 on (2, 2), (128, 256, 256) on
  (2, 2), (128, 128, 512) on (1, 4), 64 x 128 x 256 on (2, 2) and 32^3 on
  (2, 4); where x3d2_tpu takes its tiled mid (1024^3) the port takes its
  own (tests/test_torch_tiled_mid.py holds it against x3d2_tpu's).
- The halo applies' operator blocks (shard_operator_blocks) against
  x3d2_tpu's, periodic and Dirichlet, and one rank's apply on its
  extended operand against the dense apply (the exchange itself runs in
  tests/test_torch_sharding.py).
"""

import contextlib
import os

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax
import jax.numpy as jnp

from x3d2_tpu.common import BC as JBC
from x3d2_tpu.mesh import Mesh as JMesh
from x3d2_tpu.ops import pallas_kernels as pk
from x3d2_tpu.ops.pallas_poisson import (make_pressure_slab,
                                         slab_pressure_supported)
from x3d2_tpu.parallel import halo as jhalo
from x3d2_tpu.parallel import shard_kernels as jsk
from x3d2_tpu.parallel.topo import make_device_mesh
from x3d2_tpu.solver import NavierStokes as JNavierStokes

from x3d2_tpu_torch.common import BC
from x3d2_tpu_torch.mesh import Mesh
from x3d2_tpu_torch.ops import pressure_slab as sl
from x3d2_tpu_torch.ops import species_sweep as sp
from x3d2_tpu_torch.ops import transeq_sweep as ts
from x3d2_tpu_torch.ops.compact import apply_matrix
from x3d2_tpu_torch.ops.parity import build_projection_mats
from x3d2_tpu_torch.parallel import halo as phalo
from x3d2_tpu_torch.parallel import shard_kernels as psk
from x3d2_tpu_torch.parallel.topo import ProcessMesh
from x3d2_tpu_torch.solver import NavierStokes

# one thread for torch and for numpy's BLAS: the suite runs several workers
# on one machine, and multi-threaded BLAS calls in each of them, spinning on
# oversubscribed cores, made these tests many times slower there
torch.set_num_threads(1)
threadpool_limits(1, user_api="blas")

SHAPE = (128, 128, 256)
L = (2 * np.pi,) * 3
NU = 1 / 1600
NUS = (NU / 0.7, NU)
NS = 2           # shards along the swept axis
SHARD = 1        # the shard held (its block offset is not 0)
LIMIT = {2: 3e-5, 3: 5e-7}


@contextlib.contextmanager
def _env(**env):
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, val in saved.items():
            if val is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = val


@pytest.fixture(autouse=True)
def _clean_switches(monkeypatch):
    for k in ("X3D2_BFLY", "X3D2_EINSUM_MID", "X3D2_PALLAS",
              "X3D2_MATMUL_PRECISION"):
        monkeypatch.delenv(k, raising=False)


def _bcs(wall_y):
    y = (BC.DIRICHLET, BC.DIRICHLET) if wall_y else (BC.PERIODIC,
                                                     BC.PERIODIC)
    jy = (JBC.DIRICHLET, JBC.DIRICHLET) if wall_y else (JBC.PERIODIC,
                                                        JBC.PERIODIC)
    return (((BC.PERIODIC,) * 2, y, (BC.PERIODIC,) * 2),
            ((JBC.PERIODIC,) * 2, jy, (JBC.PERIODIC,) * 2))


_SOLVERS = {}


def _solvers(wall_y=False, shape=SHAPE):
    """(port solver, x3d2_tpu solver), float32, without kernel branches
    (only their operators are used)."""
    key = (wall_y, shape)
    if key not in _SOLVERS:
        bcs, jbcs = _bcs(wall_y)
        with _env(X3D2_PALLAS="0"):
            _SOLVERS[key] = (
                NavierStokes.build(Mesh(shape, L, bcs), NU, device="cpu"),
                JNavierStokes.build(JMesh(shape, L, jbcs), NU,
                                    dtype=jnp.float32))
    return _SOLVERS[key]


def _shard(f, axis, s=SHARD, ns=NS):
    n = f.shape[axis] // ns
    return np.take(f, np.arange(s * n, (s + 1) * n), axis=axis)


def _ext(f, axis, w, s=SHARD, ns=NS):
    """The shard of f between the previous shard's last w planes and the
    next shard's first w (cyclic), as the neighbour exchange gives it."""
    N = f.shape[axis]
    n = N // ns
    idx = np.arange(s * n - w, (s + 1) * n + w) % N
    return np.take(f, idx, axis=axis)


def _t(arrs, dtype=torch.float64):
    return tuple(torch.as_tensor(np.asarray(a), dtype=dtype) for a in arrs)


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return (np.abs(np.asarray(got, np.float64) - want).max()
            / np.abs(want).max())


def _fields(n, seed, shape=SHAPE, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(scale * rng.standard_normal(shape)).astype(np.float32)
            for _ in range(n)]


# ---------------------------------------------------------------------------
# the halo sweeps
# ---------------------------------------------------------------------------

SWEEPS = [(1, 2, False), (2, 2, False), (1, 3, False), (2, 3, False),
          (1, 2, True)]


@pytest.mark.parametrize("axis,terms,wall_y", SWEEPS,
                         ids=[f"{'xyz'[a]}-terms{t}{'-wall' if wy else ''}"
                              for a, t, wy in SWEEPS])
def test_halo_sweep(axis, terms, wall_y):
    ns, jns = _solvers(wall_y)
    acc = axis == 1          # the sharded chain: z, then y + acc
    comps = _fields(3, 10 + axis)
    acc0 = _fields(3, 20 + axis, scale=100.0)
    bs, w = ts.geometry(terms)
    local = list(SHAPE)
    local[axis] //= NS
    nb_loc = local[axis] // bs
    fn = ts.make_transeq_sweep(ns.ops[axis], NU, axis, tuple(local),
                               accumulate=acc, device="cpu", terms=terms,
                               n_shards=NS)
    blocks = fn.blocks
    assert blocks.nb == SHAPE[axis] // bs    # the global stack

    def halo(dtype):
        kw = {"acc": _t([_shard(a, axis) for a in acc0], dtype)} \
            if acc else {}
        return ts.transeq_sweep_plain(
            *_t([_shard(c, axis) for c in comps], dtype), blocks, NU,
            exts=_t([_ext(c, axis, w) for c in comps], dtype),
            off=SHARD * nb_loc, **kw)

    got64 = [g.numpy() for g in halo(torch.float64)]
    # the unsharded plain sweep of the global field, on the shard
    whole = ts.transeq_sweep_plain(*_t(comps), blocks, NU,
                                   acc=_t(acc0) if acc else None)
    for g, e in zip(got64, whole):
        assert _rel(g, _shard(e.numpy(), axis)) < 1e-12
    # the float32 plain version (the kernel's on a CPU tensor), through
    # the sweep function
    kw = {"acc": _t([_shard(a, axis) for a in acc0], torch.float32)} \
        if acc else {}
    got32 = fn(*_t([_shard(c, axis) for c in comps], torch.float32),
               exts=_t([_ext(c, axis, w) for c in comps], torch.float32),
               off=SHARD * nb_loc, **kw)
    for g, e in zip(got32, got64):
        assert _rel(g.numpy(), e) < LIMIT[terms]
    # x3d2_tpu's halo_ext sweep on the same shard, its own halo width
    jw = jsk._halo_w(axis, terms)
    jbs = 128 if axis == 2 else 64
    jfn = pk.make_transeq_dir_v3(jns.ops[axis], NU, axis, tuple(local),
                                 accumulate=acc, interpret=True, terms=terms,
                                 n_shards=NS)
    jkw = {"acc": tuple(jnp.asarray(_shard(a, axis)) for a in acc0)} \
        if acc else {}
    want = jfn(*(jnp.asarray(_shard(c, axis)) for c in comps),
               exts=tuple(jnp.asarray(_ext(c, axis, jw)) for c in comps),
               off=SHARD * (local[axis] // jbs), **jkw)
    for g, e in zip(got64, want):
        assert _rel(np.asarray(e), g) < LIMIT[terms]


@pytest.mark.parametrize("axis", [1, 2], ids=["y", "z"])
def test_species_halo_sweep(axis):
    ns, jns = _solvers()
    acc = axis == 1
    u = _fields(3, 30 + axis)
    phis = _fields(2, 40 + axis)
    acc0 = _fields(2, 50 + axis, scale=100.0)
    bs, w = ts.geometry(2)
    local = list(SHAPE)
    local[axis] //= NS
    fn = sp.make_species_sweep(ns.ops[axis], NUS, axis, tuple(local),
                               accumulate=acc, device="cpu", n_shards=NS)
    conv = u[axis]
    srcs = [conv] + phis

    def halo(dtype):
        kw = {"acc": _t([_shard(a, axis) for a in acc0], dtype)} \
            if acc else {}
        return sp.species_sweep_plain(
            _t([_shard(p, axis) for p in phis], dtype),
            _t([_shard(conv, axis)], dtype)[0], fn.blocks, NUS,
            exts=_t([_ext(f, axis, w) for f in srcs], dtype),
            off=SHARD * (local[axis] // bs), **kw)

    got64 = [g.numpy() for g in halo(torch.float64)]
    whole = sp.species_sweep_plain(_t(phis), _t([conv])[0], fn.blocks, NUS,
                                   acc=_t(acc0) if acc else None)
    for g, e in zip(got64, whole):
        assert _rel(g, _shard(e.numpy(), axis)) < 1e-12
    for g, e in zip(halo(torch.float32), got64):
        assert _rel(g.numpy(), e) < LIMIT[2]
    jw = jsk._halo_w(axis, 2)
    jbs = 128 if axis == 2 else 64
    jfn = pk.make_species_dir_v3(jns.ops[axis], NUS, axis, tuple(local),
                                 accumulate=acc, interpret=True, terms=2,
                                 n_shards=NS)
    jkw = {"acc": tuple(jnp.asarray(_shard(a, axis)) for a in acc0)} \
        if acc else {}
    want = jfn(tuple(jnp.asarray(_shard(p, axis)) for p in phis),
               jnp.asarray(_shard(conv, axis)),
               exts=tuple(jnp.asarray(_ext(f, axis, jw)) for f in srcs),
               off=SHARD * (local[axis] // jbs), **jkw)
    for g, e in zip(got64, want):
        assert _rel(np.asarray(e), g) < LIMIT[2]


def test_halo_sweep_arguments():
    """The halo form takes the extended operands and the block offset, and
    no update; an offset off the global stack raises."""
    ns, _ = _solvers()
    local = (128, 64, 256)
    with pytest.raises(ValueError, match="single-shard"):
        ts.make_transeq_sweep(ns.ops[1], NU, 1, local, accumulate=True,
                              nolds=2, device="cpu", n_shards=2)
    fn = ts.make_transeq_sweep(ns.ops[1], NU, 1, local, device="cpu",
                               n_shards=2)
    u = torch.zeros(local)
    with pytest.raises(ValueError, match="do not match"):
        fn(u, u, u)
    ext = torch.zeros((128, 64 + 2 * ts.W, 256))
    with pytest.raises(ValueError, match="outside the global stack"):
        fn(u, u, u, exts=(ext,) * 3, off=2)
    assert ts.variant_name(1, True, 0, halo=True) == \
        "transeq_sweep[y,acc,halo]"
    assert ts.variant_name(2, False, 0, w=32, halo=True) == \
        "transeq_sweep[z,halo,w32]"
    assert sp.variant_name(2, False, halo=True) == "species_sweep[z,halo]"


# ---------------------------------------------------------------------------
# the local-batch mid
# ---------------------------------------------------------------------------

MID_SHAPE = (64, 128, 256)
NX_LOC = 16
MID_RANK = 2                     # (iy, iz) = (1, 0) on (2, 2)
MID_OFF = (1 * 2 + 0) * NX_LOC


@pytest.fixture(scope="module")
def mids():
    ns, jns = _solvers(shape=MID_SHAPE)
    pm = build_projection_mats(ns)
    mk = sl.make_mid_local(ns, pm, terms=3)
    jmk = make_pressure_slab(jns, terms=3, interpret=True)[4]
    return ns, pm, mk, jmk


def _mid_inputs():
    return _fields(3, 60, shape=(NX_LOC,) + MID_SHAPE[1:])


def _tables(m, dtype=None):
    return tuple(None if t is None else t[MID_OFF:MID_OFF + NX_LOC]
                 for t in (m["k2x"], m["tx2"], m.get("mx")))


@pytest.mark.parametrize("form", ["kernel", "einsum"])
def test_mid_local(mids, form):
    ns, pm, mk, jmk = mids
    d = _mid_inputs()
    mine = (mk if form == "kernel" else mk.einsum)(NX_LOC)
    got = mine(*_t(d, torch.float32), *_tables(pm.mats(torch.float32)))
    theirs = (jmk if form == "kernel" else jmk.einsum)(NX_LOC)
    jt = [jnp.asarray(np.asarray(t)[MID_OFF:MID_OFF + NX_LOC])
          for t in jmk.tables[3:6]]
    want = theirs(*(jnp.asarray(x) for x in d), *jt)
    assert len(got) == len(want) == 4
    for g, e in zip(got, want):
        assert _rel(g.numpy(), np.asarray(e)) < 2e-4


def test_mid_local_is_the_mid_on_a_batch(mids):
    """In float64 the batch's mid, and its tiled form (the reassociated
    stage order of x3d2_tpu's tiled mid), are the whole-x mid's planes of
    that batch (the tables sliced in the x stage's order), and the
    orderings and inverse transforms are x3d2_tpu's."""
    ns, pm, mk, jmk = mids
    d = _fields(3, 61, shape=MID_SHAPE)
    whole = sl.pressure_mid_plain(*_t(d), pm.mats(torch.float64))
    batch = _t([x[MID_OFF:MID_OFF + NX_LOC] for x in d])
    tabs = _tables(pm.mats(torch.float64))
    for mid in (mk(NX_LOC), mk.tiled(NX_LOC)):
        got = mid(*batch, *tabs)
        for g, e in zip(got, whole):
            assert _rel(g.numpy(),
                        e.numpy()[MID_OFF:MID_OFF + NX_LOC]) < 1e-12
    for a, b in ((pm.x_perm, jmk.x_perm), (pm.q_perm, jmk.q_perm),
                 (pm.z_perm, jmk.z_perm)):
        np.testing.assert_array_equal(a, b)
    for name in ("ti_x", "ti_y", "ti_z"):
        np.testing.assert_allclose(getattr(mk, name).numpy(),
                                   np.asarray(getattr(jmk, name)),
                                   rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the gates
# ---------------------------------------------------------------------------

# (grid, mesh, the decisions: sharded sweeps, per-rank x applies,
# repencilled projection, its full-plane mid)
GATES = [((512, 512, 512), (2, 2), (True, True, True, True)),
         ((1024, 1024, 1024), (2, 2), (True, True, True, False)),
         ((128, 256, 256), (2, 2), (True, True, True, True)),
         ((128, 128, 512), (1, 4), (True, True, True, True)),
         ((64, 128, 256), (2, 2), (False, True, True, True)),
         ((32, 32, 32), (2, 4), (False, False, False, None))]


@pytest.mark.parametrize("dims,mesh,want", GATES,
                         ids=[f"{'x'.join(map(str, d))}-{m}"
                              for d, m, _ in GATES])
def test_gates_match_x3d2_tpu(dims, mesh, want):
    ns, jns = _solvers(shape=dims)
    pmesh = ProcessMesh(*mesh)
    dmesh = make_device_mesh(*mesh)
    for terms in (2, 3):
        mine = psk.sharded_transeq_supported(ns, pmesh, terms)
        assert mine == want[0]
        assert mine == jsk.sharded_transeq_v3_supported(jns, dmesh,
                                                        terms=terms)
    assert psk.sharded_x_apply_supported(ns, pmesh) == want[1] == \
        jsk.sharded_x_apply_supported(jns, dmesh)
    rep = psk.repencil_supported(ns, pmesh)
    assert rep == want[2] == jsk.repencil_supported(jns, dmesh)
    if not rep:
        return
    full = sl.tpu_slab_vmem_ok(ns, 2)
    assert full == want[3] == slab_pressure_supported(jns, terms=2)
    tiled = sl.tiled_mid_supported(ns, 2)
    if not full:
        # x3d2_tpu's tiled mid; building the whole slab there is its own
        # cost, so its flag is read only where the choice depends on it
        assert tiled == make_pressure_slab(jns, terms=2,
                                           interpret=True)[4].tiled_supported
        assert tiled
        fn = psk.make_repencilled_pressure(ns, pmesh, terms=2)
        assert fn.mid.__name__ == "mid_tiled"


def test_tiled_mid_raises(monkeypatch):
    """Where the full-plane mid fails x3d2_tpu's VMEM gate and the tiled
    one is supported, the repencilled projection is x3d2_tpu's tiled mid
    (forced at a small grid, as x3d2_tpu's own tests/test_shard_kernels.py
    forces its gate closed), which the port once raised on: it is taken,
    and gives the plain tiled form's result on the rank's batch, within
    1e-12 of the full-plane mid's in float64 (tests/test_torch_tiled_mid.py
    holds both against x3d2_tpu's)."""
    ns, _ = _solvers(shape=MID_SHAPE)
    pmesh = ProcessMesh(2, 2)
    assert psk.repencil_supported(ns, pmesh)
    fn = psk.make_repencilled_pressure(ns, pmesh, terms=2)
    assert fn.x_offset == 0 and fn.mid.__name__ == "mid_local"
    monkeypatch.setattr(sl, "tpu_slab_vmem_ok", lambda solver, terms: False)
    fn_t = psk.make_repencilled_pressure(ns, pmesh, terms=2)
    assert fn_t.mid.__name__ == "mid_tiled"
    m64 = fn_t.mats.mats(torch.float64)
    d = _t(_fields(3, 62, shape=(NX_LOC,) + MID_SHAPE[1:]))
    tabs = (m64["k2x"][:NX_LOC], m64["tx2"][:NX_LOC])
    got = fn_t.mid(*d, *tabs)
    want = sl.pressure_mid_tiled_local_plain(*d, fn_t.mats, *tabs)
    full = fn.mid(*d, *tabs)
    for g, e, f in zip(got, want, full):
        assert torch.equal(g, e)
        assert _rel(g.numpy(), f.numpy()) < 1e-12
    # X3D2_EINSUM_MID=1: the plain replay, as x3d2_tpu's XLA replay
    monkeypatch.setenv("X3D2_EINSUM_MID", "1")
    fn = psk.make_repencilled_pressure(ns, pmesh, terms=2)
    assert fn.mid.__name__ == "mid_einsum"


# ---------------------------------------------------------------------------
# the halo applies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wall", [False, True], ids=["periodic", "wall"])
def test_halo_apply_blocks(wall):
    """The halo applies' row blocks equal x3d2_tpu's, and each rank's
    block on its extended operand gives the dense apply's rows."""
    from x3d2_tpu.ops import build_op as jbuild_op
    from x3d2_tpu_torch.ops.compact import build_op

    n, ns, w = 128, 4, 32
    bc, jbc = ((BC.DIRICHLET, JBC.DIRICHLET) if wall
               else (BC.PERIODIC, JBC.PERIODIC))
    dx = 2 * np.pi / (n - 1 if wall else n)
    for operation in ("first-deriv", "second-deriv"):
        op = build_op(operation, n, dx, "compact6", bc, bc,
                      dtype=torch.float64, device="cpu")
        jop = jbuild_op(operation, n, dx, "compact6", jbc, jbc,
                        dtype=jnp.float64)
        blocks, trunc = phalo.shard_operator_blocks(op, ns, w)
        jblocks, jtrunc = jhalo.shard_operator_blocks(jop, ns, w)
        np.testing.assert_allclose(blocks, np.asarray(jblocks), rtol=0,
                                   atol=1e-12 * np.abs(blocks).max())
        assert abs(trunc - jtrunc) <= 1e-15
        f = np.random.default_rng(5).standard_normal((8, n, 16))
        dense = apply_matrix(op.M, torch.as_tensor(f), 1).numpy()
        for s in range(ns):
            ext = np.take(f, np.arange(s * n // ns - w, (s + 1) * n // ns
                                       + w) % n, axis=1)
            got = apply_matrix(torch.as_tensor(blocks[s]),
                               torch.as_tensor(ext), 1).numpy()
            want = dense[:, s * n // ns:(s + 1) * n // ns]
            assert np.abs(got - want).max() < 1e-11
    assert phalo.halo_width(torch.float64) == jhalo.halo_width(jnp.float64)
    assert phalo.halo_width(torch.float32) == jhalo.halo_width(jnp.float32)
    with pytest.raises(ValueError, match="too small"):
        phalo.shard_operator_blocks(op, ns, 2)
