"""The mid's two halves (X3D2_MID_SPLIT=1) and its dense forms
(X3D2_BFLY=0) in the port against x3d2_tpu, on the CPU.

- The halves' plain versions, div_solve (du, dv, dw -> q) and grad
  (q -> p_zy, dpdy, dpdz), against x3d2_tpu's _div_solve_kernel and
  _grad_kernel (make_pressure_slab(terms=3, interpret=True), slab[0] and
  slab[1]), float32 at 128^3 on the same numpy inputs, with the slab built
  with X3D2_BFLY unset (banded y, parity transforms) and with X3D2_BFLY=0
  (the dense Ty, Ti_y and z forms; q in natural order): 2e-4 * scale, the
  bound of tests/test_pallas_poisson.py (the reference's bf16 split
  noise), as tests/test_torch_slab.py holds the merged mid. The dense mid,
  with and without q, against x3d2_tpu's merged kernel the same way.
- The halves compose to the merged mid bit for bit (the same launches on
  the card, the same operations here), in both forms.
- pressure_correction(keep_pressure=True) and pressure_grads in float64
  under X3D2_BFLY=0 (the dense x stage, the dense mid, the physical p from
  natural-order inverse transforms) against x3d2_tpu's float64 projection:
  1e-10 * scale, and the divergence after it below 1e-10
  (tests/test_poisson.py).
- The branch choice under X3D2_D2C, X3D2_MID_SPLIT and X3D2_BFLY=0 against
  x3d2_tpu's gates, built with its backend reported as a TPU (nothing of
  it runs): the chain, the pipeline, the slab's forms and x stage, the
  carry.
- The launcher takes DENSE along y and z only (x is apply_dense); CPU
  tensors take the plain versions and count no launch.
"""

import contextlib
import functools
import os

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax
import jax.numpy as jnp

from x3d2_tpu.cases import SolverParams as JSolverParams
from x3d2_tpu.cases import TGVCase as JTGVCase
from x3d2_tpu.common import BC as JBC
from x3d2_tpu.mesh import Mesh as JMesh
from x3d2_tpu.ops.pallas_poisson import make_pressure_slab
from x3d2_tpu.solver import NavierStokes as JNavierStokes

from x3d2_tpu_torch.cases import SolverParams, TGVCase
from x3d2_tpu_torch.common import BC
from x3d2_tpu_torch.mesh import Mesh
from x3d2_tpu_torch.ops import operator_apply as oa
from x3d2_tpu_torch.ops import pressure_slab as sl
from x3d2_tpu_torch.solver import NavierStokes

# one thread for torch and for numpy's BLAS: the suite runs several workers
# on one machine, and multi-threaded BLAS calls in each of them, spinning on
# oversubscribed cores, made these tests many times slower there
torch.set_num_threads(1)
threadpool_limits(1, user_api="blas")

SHAPE = (128, 128, 128)
L = (2 * np.pi,) * 3
NU = 1 / 1600
PER = ((BC.PERIODIC, BC.PERIODIC),) * 3
JPER = ((JBC.PERIODIC, JBC.PERIODIC),) * 3
SWITCHES = ("X3D2_BFLY", "X3D2_MID_SPLIT", "X3D2_D2C", "X3D2_XDIV_FUSED",
            "X3D2_PIPE3", "X3D2_MERGED_X", "X3D2_BF16_ACC")


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
    for k in SWITCHES:
        monkeypatch.delenv(k, raising=False)


@contextlib.contextmanager
def _tpu_gates():
    """x3d2_tpu builds its kernel branches only on a TPU backend with no
    other default device (solver.py:106-110); report one while it builds
    (building runs no kernel)."""
    real = jax.default_backend
    device = jax.config.jax_default_device
    jax.default_backend = lambda: "tpu"
    jax.config.update("jax_default_device", None)
    try:
        yield
    finally:
        jax.default_backend = real
        jax.config.update("jax_default_device", device)


def _fields(n, seed, dtype=np.float32, shape=SHAPE):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(dtype) for _ in range(n)]


def _close(got, want, tol):
    assert len(got) == len(want)
    for g, e in zip(got, want):
        e = np.asarray(e)
        err = np.abs(g.numpy() - e).max()
        assert err < tol * np.abs(e).max(), f"{err:.2e}"


@functools.lru_cache(maxsize=None)
def _slab_of(form):
    """(port solver, x3d2_tpu's slab) float32 at 128^3, built with
    X3D2_BFLY unset ("parity") or "0" ("dense")."""
    env = {"X3D2_BFLY": "0"} if form == "dense" else {}
    with _env(**env):
        ns = NavierStokes.build(Mesh(SHAPE, L, PER), NU, device="cpu")
        jns = JNavierStokes.build(JMesh(SHAPE, L, JPER), NU,
                                  dtype=jnp.float32)
        jslab = make_pressure_slab(jns, terms=3, interpret=True)
    return ns, jslab


@pytest.fixture(scope="module", params=["parity", "dense"])
def slabs(request):
    return (request.param,) + _slab_of(request.param)


def test_slab_forms_follow_the_switch(slabs):
    form, ns, jslab = slabs
    pm = ns._slab
    assert pm.dense == (form == "dense")
    for mine, theirs in ((pm.x_perm, jslab[3].x_perm),
                         (pm.q_perm, jslab[3].q_perm),
                         (pm.z_perm, jslab[3].z_perm)):
        assert (mine is None) == (theirs is None)
        if mine is not None:
            assert np.array_equal(mine, theirs)
    # the pipeline keeps its parity splits whatever the switch
    assert not ns._pipe.mats.dense
    assert (ns._pipe.mats is pm) == (form == "parity")


def test_halves_match_x3d2_tpu(slabs):
    _, ns, jslab = slabs
    pm = ns._slab
    f = _fields(3, seed=11)
    q = sl.div_solve(*(torch.from_numpy(a) for a in f), pm)
    _close([q], [jslab[0](*(jnp.asarray(a) for a in f))], 2e-4)
    qin = _fields(1, seed=12)[0]
    got = sl.grad(torch.from_numpy(qin), pm)
    _close(got, jslab[1](jnp.asarray(qin)), 2e-4)


def test_halves_compose_to_the_mid(slabs):
    _, ns, _ = slabs
    pm = ns._slab
    t = [torch.from_numpy(a) for a in _fields(3, seed=13)]
    q = sl.div_solve(*t, pm)
    merged = sl.pressure_mid(*t, pm, emit_q=True)
    assert all(torch.equal(a, b)
               for a, b in zip(merged, (q,) + sl.grad(q, pm)))
    no_q = sl.pressure_mid(*t, pm, emit_q=False)
    assert no_q[0] is None
    assert all(torch.equal(a, b) for a, b in zip(merged[1:], no_q[1:]))


@pytest.mark.parametrize("emit_q", [True, False])
def test_dense_mid_matches_x3d2_tpu(emit_q):
    ns, jslab = _slab_of("dense")
    f = _fields(3, seed=14)
    t = [torch.from_numpy(a) for a in f]
    j = [jnp.asarray(a) for a in f]
    got = sl.pressure_mid(*t, ns._slab, emit_q=emit_q)
    if emit_q:
        _close(got, jslab[3](*j), 2e-4)
    else:
        assert got[0] is None
        _close(got[1:], jslab[3].no_q(*j), 2e-4)


@pytest.mark.parametrize("split", ["0", "1"])
def test_dense_projection_matches_x3d2_tpu_f64(split):
    """keep_pressure=True and pressure_grads in float64 with X3D2_BFLY=0,
    merged or split mid, against x3d2_tpu's float64 projection."""
    with _env(X3D2_BFLY="0", X3D2_MID_SPLIT=split):
        ns = NavierStokes.build(Mesh(SHAPE, L, PER), NU,
                                dtype=torch.float64, device="cpu")
        assert ns._slab.dense
        f = _fields(3, seed=15, dtype=np.float64)
        got = ns.pressure_correction(*(torch.from_numpy(a) for a in f),
                                     keep_pressure=True)
        grads = ns.pressure_grads(*(torch.from_numpy(a) for a in f))
    jns = JNavierStokes.build(JMesh(SHAPE, L, JPER), NU, dtype=jnp.float64)
    want = jns.pressure_correction(*(jnp.asarray(a) for a in f),
                                   keep_pressure=True)
    jgrads = jns.pressure_grads(*(jnp.asarray(a) for a in f))
    for g, e in zip(tuple(got) + tuple(grads), tuple(want) + tuple(jgrads)):
        e = np.asarray(e)
        np.testing.assert_allclose(g.numpy(), e, rtol=0,
                                   atol=1e-10 * np.abs(e).max())
    assert float(ns.divergence_v2p(*got[:3]).abs().max()) < 1e-10


def _branches(shape, env, keep_pressure=False):
    """(port, x3d2_tpu): the AB chain (None, "zxy", "xdiv"), the pipeline
    built, the slab's transforms ("parity", "dense"), its x stage
    ("parity", "dense"), the carry built."""
    with _env(**env):
        kw = dict(monitor_path=None, verbose=False,
                  keep_pressure=keep_pressure)
        case = TGVCase(Mesh(shape, L, PER), SolverParams(dt=1e-3),
                       dtype=torch.float32, device="cpu", **kw)
        with _tpu_gates():
            jcase = JTGVCase(JMesh(shape, L, JPER), JSolverParams(dt=1e-3),
                             dtype=jnp.float32, **kw)
    slab = case.solver._slab
    got = (None if case._fused_ab is None
           else "xdiv" if case._ab_is_xdiv else "zxy",
           case.solver._pipe is not None,
           "dense" if slab.dense else "parity",
           "dense" if slab.x_perm is None else "parity",
           case._pipe_d2c is not None)
    jslab = jcase.solver._slab_pressure
    want = (None if jcase._fused_ab is None
            else "xdiv" if jcase._ab_is_xdiv else "zxy",
            getattr(jcase.solver, "_pipe_pressure", None) is not None,
            "dense" if jslab[3].q_perm is None else "parity",
            "dense" if jslab[3].x_perm is None else "parity",
            jcase._pipe_d2c is not None)
    return got, want


@pytest.mark.parametrize("shape,env,keep,expect", [
    ((128, 128, 256), {"X3D2_BFLY": "0"}, False,
     ("zxy", True, "dense", "dense", False)),
    ((128, 128, 256), {"X3D2_BFLY": "0"}, True,
     ("zxy", True, "dense", "dense", False)),
    ((128, 128, 256), {"X3D2_BFLY": "0", "X3D2_D2C": "1"}, False,
     ("zxy", True, "dense", "dense", True)),
    ((128, 128, 256), {"X3D2_D2C": "1", "X3D2_XDIV_FUSED": "0"}, False,
     ("zxy", True, "parity", "parity", True)),
    ((128, 128, 256), {"X3D2_D2C": "1"}, False,
     ("xdiv", True, "parity", "parity", False)),
    ((128, 128, 256), {"X3D2_MID_SPLIT": "1", "X3D2_BFLY": "0"}, True,
     ("zxy", True, "dense", "dense", False)),
    ((128, 128, 256), {"X3D2_MID_SPLIT": "1"}, False,
     ("xdiv", True, "parity", "parity", False)),
    ((512,) * 3, {"X3D2_D2C": "1"}, False,
     ("zxy", True, "parity", "parity", True)),
])
def test_branch_choice_matches_x3d2_tpu(shape, env, keep, expect):
    got, want = _branches(shape, env, keep)
    assert got == want == expect


def test_launcher_forms_and_cpu_counts():
    ns = NavierStokes.build(Mesh(SHAPE, L, PER), NU, device="cpu")
    f = torch.zeros(SHAPE)
    with pytest.raises(ValueError, match="apply_dense"):
        oa.apply("x", oa.DENSE, 0, [([f], [f], f, None)])
    oa.reset_launch_counts()
    q = sl.div_solve(f, f, f, ns._slab)
    assert len(sl.grad(q, ns._slab)) == 3 and oa.launch_counts() == {}
    m = torch.empty(SHAPE, device="meta")
    with pytest.raises(ValueError, match="no div_solve"):
        sl.div_solve(m, m, m, ns._slab)
    with pytest.raises(ValueError, match="no grad"):
        sl.grad(m, ns._slab)
    assert sl.stage_name("pressure_mid", ns._slab, True) == "pressure_mid[q]"
    with _env(X3D2_BFLY="0"):
        dense = NavierStokes.build(Mesh(SHAPE, L, PER), NU, device="cpu")
    assert sl.stage_name("div_solve", dense._slab) == "div_solve[dense]"
    assert sl.stage_name("pressure_mid", dense._slab,
                         True) == "pressure_mid[q,dense]"
    for name in ("div_solve", "grad", "div_solve[dense]", "grad[dense]"):
        assert oa.LAUNCHES_PER_CALL[name] == 3
