"""x3d2_tpu's HIGHEST mode (X3D2_MATMUL_PRECISION=highest, its kernels at
terms = 3) in the port against x3d2_tpu, on the CPU, and the switches
read where x3d2_tpu reads them.

- The W = 32 sweeps' plain versions (the kernels' on a CPU tensor) at
  (128, 128, 256), the smallest grid the sweeps tile, float32: z; x
  accumulate; y accumulate + AB3; y accumulate with the RK substage
  updates (the RK1-4 rows); the xdiv sweep; the species sweeps of two
  scalars. Each against the dense float64 operator path (and the float64
  update, and a float64 parity apply of u') at 5e-7 * scale, the bound
  x3d2_tpu holds its HIGHEST kernels to (tests/test_pallas_v3.py:95-115);
  the xdiv sweep's x-transformed divergence inputs, the projection's
  transforms of u', at the projection's 3e-5 * scale (a 128-term dense
  transform of white noise: its float32 rounding alone reaches ~1e-6).
- The plain directions against x3d2_tpu's make_transeq_dir_v3(...,
  terms=3, interpret=True): 1e-6 * scale, the sum of both sides' 5e-7
  bounds to float64.
- The branch choice under X3D2_MATMUL_PRECISION=highest on every grid a
  driven path uses, against x3d2_tpu's gates built with its backend
  reported as a TPU (nothing is run): the same transport, fused chains,
  pipeline and slab; x3d2_tpu's band on its non-lane axes is 32, the
  port's on every axis. A bfloat16 history or partials on the fused AB
  chain (and the carry's chain, X3D2_D2C=1) build from the W = 32
  reduced-precision instances and step.
- TGV (128, 128, 256) compensated in the HIGHEST mode against x3d2_tpu's
  compensated einsum step: float64, 1 step, at test_torch_compensated's
  tolerances (u, v, w within 1e-10 * scale, the compensation within 4
  float64 roundings of max |u|); float32, 2 steps, where the port runs its
  W = 32 sweeps (plain versions) and x3d2_tpu its HIGHEST einsums, within 1e-5
  (two float32 evaluations of the same steps: the card-vs-CPU limit of
  chip_smoke.py phase 8).

The switches read where x3d2_tpu reads them: tests/test_torch_switches.py.
"""

import contextlib

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
from x3d2_tpu.ops import compact as jcompact
from x3d2_tpu.ops import pallas_kernels as pk
from x3d2_tpu.solver import NavierStokes as JNavierStokes

from x3d2_tpu_torch.cases import SolverParams, TGVCase
from x3d2_tpu_torch.common import BC
from x3d2_tpu_torch.mesh import Mesh
from x3d2_tpu_torch.ops import species_sweep as sp
from x3d2_tpu_torch.ops import transeq_sweep as ts
from x3d2_tpu_torch.ops.parity import pfwd
from x3d2_tpu_torch.solver import NavierStokes
from x3d2_tpu_torch.time_integrators import TimeIntegrator

# one thread for torch and for numpy's BLAS: the suite runs several workers
# on one machine, and multi-threaded BLAS calls in each of them, spinning on
# oversubscribed cores, made these tests many times slower there
torch.set_num_threads(1)
threadpool_limits(1, user_api="blas")

SHAPE = (128, 128, 256)
L = (2 * np.pi,) * 3
PER = ((BC.PERIODIC, BC.PERIODIC),) * 3
JPER = ((JBC.PERIODIC, JBC.PERIODIC),) * 3
NU = 1 / 1600
DT = 1e-3
NUS = (NU / 0.7, NU)
EPS64 = np.finfo(np.float64).eps
SWITCHES = ("X3D2_BF16_OLDS", "X3D2_BF16_ACC", "X3D2_FUSED_AB",
            "X3D2_XDIV_FUSED", "X3D2_MERGED_X", "X3D2_PIPE3", "X3D2_BFLY",
            "X3D2_D2C", "X3D2_FUSED_RK", "X3D2_MID_SPLIT", "X3D2_PALLAS",
            "X3D2_CHUNK", "X3D2_MATMUL_PRECISION")


@pytest.fixture(autouse=True)
def _clean_switches(monkeypatch):
    for k in SWITCHES:
        monkeypatch.delenv(k, raising=False)


@pytest.fixture(scope="module")
def setup():
    """The port's operators at SHAPE, random float32 fields and the dense
    float64 direction RHS of each axis (as tests/test_pallas_v3.py)."""
    ns = NavierStokes.build(Mesh(SHAPE, L, PER), NU, device="cpu")
    rng = np.random.default_rng(0)
    comps = tuple(rng.standard_normal(SHAPE).astype(np.float32)
                  for _ in range(3))
    acc = tuple((100 * rng.standard_normal(SHAPE)).astype(np.float32)
                for _ in range(3))
    olds = tuple(tuple((100 * rng.standard_normal(SHAPE)).astype(np.float32)
                       for _ in range(3)) for _ in range(3))
    f0 = tuple(rng.standard_normal(SHAPE).astype(np.float32)
               for _ in range(3))
    phis = tuple(rng.standard_normal(SHAPE).astype(np.float32)
                 for _ in range(2))
    ref = {a: _dir_reference64(ns, comps, a) for a in range(3)}
    return ns, comps, acc, olds, f0, phis, ref


def _ap(M, f, axis):
    return np.moveaxis(np.tensordot(M, f, axes=([1], [axis])), 0, axis)


def _dir_reference64(ns, comps, axis):
    """Dense float64 RHS of one direction, per component."""
    o = ns.ops[axis]
    c64 = [np.asarray(q, np.float64) for q in comps]
    conv = c64[axis]
    out = []
    for c in range(3):
        if c == axis:
            d1, dd, d2 = o.der1st, o.der1st_sym, o.der2nd
        else:
            d1, dd, d2 = o.der1st_sym, o.der1st, o.der2nd_sym
        q = c64[c]
        out.append(-0.5 * (conv * _ap(d1.M64, q, axis)
                           + _ap(dd.M64, q * conv, axis))
                   + NU * _ap(d2.M64, q, axis))
    return out


def _species_reference64(ns, phi, conv, axis, nu_s):
    o = ns.ops[axis]
    phi, conv = np.asarray(phi, np.float64), np.asarray(conv, np.float64)
    return (-0.5 * (conv * _ap(o.der1st.M64, phi, axis)
                    + _ap(o.der1st_sym.M64, phi * conv, axis))
            + nu_s * _ap(o.der2nd.M64, phi, axis))


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / np.abs(want).max())


def _t(arrs):
    if isinstance(arrs, np.ndarray):
        return torch.from_numpy(arrs)
    return tuple(_t(a) for a in arrs)


# ---------------------------------------------------------------------------
# the W = 32 sweeps (plain versions) against float64
# ---------------------------------------------------------------------------

def _rk_rows():
    """(label, history fields, separate base, dt-scaled row) of the RK1-4
    tableaus' y-sweep updates the kernel is built with."""
    out = []
    for order in (3, 4):
        ti = TimeIntegrator(f"RK{order}")
        for istage in range(order):
            prev = ti.rk_prev(istage)
            key = (len(prev), istage > 0)
            if key in ts.RK_INSTANCES and key not in [o[1:3] for o in out]:
                out.append((f"RK{order} substage {istage}", len(prev),
                            istage > 0, ti.rk_row(istage, DT)))
    return out


@pytest.mark.parametrize("variant", ["z", "x,acc", "y,acc",
                                     "y,acc,ab3 steady", "y,acc,ab3 startup"]
                         + [r[0] for r in _rk_rows()])
def test_w32_sweep_matches_f64(setup, variant):
    ns, comps, acc, olds, f0, _, ref = setup
    ti = TimeIntegrator("AB3")
    axis = {"z": 2, "x": 0}.get(variant.split(",")[0], 1)
    blocks = ts.build_sweep_blocks(ns.ops[axis], axis, device="cpu",
                                   terms=3)
    assert (blocks.bs, blocks.w) == (32, 32)
    a = _t(acc) if "acc" in variant or variant.startswith("RK") else None
    r64 = [r + (np.asarray(x, np.float64) if a is not None else 0.0)
           for r, x in zip(ref[axis], acc)]
    if variant in ("z", "x,acc", "y,acc"):
        got = ts.transeq_sweep_plain(*_t(comps), blocks, NU, acc=a)
        for g, w in zip(got, r64):
            assert _rel(g.numpy(), w) <= 5e-7
        return
    if variant.startswith("RK"):
        _, nolds, sep, dtc = next(r for r in _rk_rows() if r[0] == variant)
        hist = tuple(tuple(olds[j][c] for j in range(nolds))
                     for c in range(3))
        base = f0 if sep else comps
    else:
        dtc = ti.ab_row(3 if "steady" in variant else 1, DT)
        hist = tuple(tuple(olds[j][c] for j in range(2)) for c in range(3))
        base, sep = comps, False
    new, rhs = ts.transeq_sweep_plain(*_t(comps), blocks, NU, acc=a,
                                      olds=_t(hist), dtc=dtc,
                                      base=_t(f0) if sep else None)
    for c in range(3):
        un64 = np.asarray(base[c], np.float64) + dtc[0] * r64[c]
        for j, o in enumerate(hist[c]):
            un64 = un64 + dtc[1 + j] * np.asarray(o, np.float64)
        assert _rel(rhs[c].numpy(), r64[c]) <= 5e-7
        assert _rel(new[c].numpy(), un64) <= 5e-7


def test_w32_xdiv_sweep_matches_f64(setup):
    """The xdiv sweep at W = 32: u' and rhs at 5e-7 * scale; du, dv, dw,
    the forward parity x applies of u', at the projection's 3e-5 * scale
    against a float64 apply of the float64 u'."""
    ns, comps, acc, olds, _, _, ref = setup
    d64 = ns._fp_mats64()
    xm = ts.build_xdiv_mats(d64["sx"], d64["ix"], SHAPE[0], device="cpu",
                            bs=32)
    blocks = ts.build_sweep_blocks(ns.ops[0], 0, device="cpu", terms=3)
    dtc = TimeIntegrator("AB3").ab_row(3, DT)
    hist = tuple(tuple(olds[j][c] for j in range(2)) for c in range(3))
    new, rhs, divs = ts.transeq_sweep_plain(*_t(comps), blocks, NU,
                                            acc=_t(acc), olds=_t(hist),
                                            dtc=dtc, xdiv=xm)
    sx, ix = xm.mats(torch.float64)
    for c in range(3):
        r64 = ref[0][c] + np.asarray(acc[c], np.float64)
        un64 = np.asarray(comps[c], np.float64) + dtc[0] * r64 + sum(
            dtc[1 + j] * np.asarray(o, np.float64)
            for j, o in enumerate(hist[c]))
        assert _rel(rhs[c].numpy(), r64) <= 5e-7
        assert _rel(new[c].numpy(), un64) <= 5e-7
        div64 = pfwd(sx if c == 0 else ix, torch.from_numpy(un64), 0)
        assert _rel(divs[c].numpy(), div64.numpy()) <= 3e-5


@pytest.mark.parametrize("axis", [2, 0, 1])
def test_w32_species_sweep_matches_f64(setup, axis):
    ns, comps, acc, _, _, phis, _ = setup
    blocks = ts.build_sweep_blocks(ns.ops[axis], axis, device="cpu",
                                   terms=3)
    a = None if axis == 2 else _t(acc[:2])
    got = sp.species_sweep_plain(_t(phis), _t(comps[axis]), blocks, NUS,
                                 acc=a)
    for s, g in enumerate(got):
        want = _species_reference64(ns, phis[s], comps[axis], axis, NUS[s])
        if a is not None:
            want = want + np.asarray(acc[s], np.float64)
        assert _rel(g.numpy(), want) <= 5e-7


@pytest.mark.parametrize("axis", [2, 0, 1])
def test_w32_sweep_matches_x3d2_tpu_highest(setup, axis):
    """The plain direction at W = 32 against x3d2_tpu's terms=3 kernel in
    interpret mode (w = 32, or 64 on its lane axis z)."""
    ns, comps, *_ = setup
    jns = JNavierStokes.build(JMesh(SHAPE, L, JPER), NU, dtype=jnp.float32)
    fn = pk.make_transeq_dir_v3(jns.ops[axis], NU, axis, SHAPE,
                                interpret=True, terms=3)
    want = fn(*(jnp.asarray(c) for c in comps))
    blocks = ts.build_sweep_blocks(ns.ops[axis], axis, device="cpu",
                                   terms=3)
    got = ts.transeq_sweep_plain(*_t(comps), blocks, NU)
    for g, w in zip(got, want):
        assert _rel(g.numpy(), np.asarray(w, np.float64)) <= 1e-6


# ---------------------------------------------------------------------------
# the branches under X3D2_MATMUL_PRECISION=highest, against x3d2_tpu's
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _tpu_highest(monkeypatch):
    """x3d2_tpu's gates as on a TPU (solver.py:106-110), in the HIGHEST
    mode: its PRECISION is bound at import (ops/compact.py:58), so the
    module's value is set; each banded block it builds is recorded as
    (w, bs)."""
    real = jax.default_backend
    device = jax.config.jax_default_device
    bands = []
    inner = pk.banded_blocks
    monkeypatch.setattr(jcompact, "PRECISION", jax.lax.Precision.HIGHEST)
    monkeypatch.setattr(pk, "banded_blocks", lambda op, w, bs, **k: (
        bands.append((w, bs)), inner(op, w, bs, **k))[1])
    jax.default_backend = lambda: "tpu"
    jax.config.update("jax_default_device", None)
    try:
        yield bands
    finally:
        jax.default_backend = real
        jax.config.update("jax_default_device", device)


def _port_widths(case):
    """The band half-widths of every sweep chain the port's case built."""
    fns = []
    for chain in (case.solver._sweeps, case.solver._species_sweeps,
                  case._fused_ab):
        if chain is not None:
            fns += list(chain.sweeps)
    for stage in case._fused_rk or ():
        fns += list(stage.sweeps)
    return {f.blocks.w for f in fns}


@pytest.mark.parametrize("shape,prm,keep", [
    (SHAPE, {}, False), (SHAPE, {}, True), (SHAPE, {"compensated": True},
                                            False),
    (SHAPE, {"time_intg": "RK3"}, False),
    (SHAPE, {"time_intg": "RK3", "n_species": 2, "pr_species": (0.7, 1.0)},
     False),
    ((256,) * 3, {}, False), ((512,) * 3, {}, False),
    ((512,) * 3, {"time_intg": "RK4"}, False), ((128,) * 3, {}, False)])
def test_branch_choice_under_highest_matches_x3d2_tpu(monkeypatch, shape,
                                                      prm, keep):
    monkeypatch.setenv("X3D2_MATMUL_PRECISION", "highest")
    p = dict(Re=1600, dt=DT) | prm
    kw = dict(monitor_path=None, verbose=False, keep_pressure=keep)
    case = TGVCase(Mesh(shape, L, PER), SolverParams(**p),
                   dtype=torch.float32, device="cpu", **kw)
    with _tpu_highest(monkeypatch) as bands:
        jcase = JTGVCase(JMesh(shape, L, JPER), JSolverParams(**p),
                         dtype=jnp.float32, **kw)
    js = jcase.solver
    jslab = getattr(js, "_slab_pressure", None)
    got = (case.solver._transport, case._fused_ab is not None,
           case._ab_is_xdiv, case._fused_rk is not None,
           case.solver._species_sweeps is not None,
           case.solver._pipe is not None, case.solver._slab is not None)
    want = ("sweeps" if getattr(js, "_transeq_v3", None) is not None
            else "v1" if getattr(js, "_pallas_transeq", None) is not None
            else "dense",
            jcase._fused_ab is not None,
            getattr(jcase, "_ab_is_xdiv", False),
            jcase._fused_rk is not None,
            getattr(js, "_species_v3", None) is not None,
            getattr(js, "_pipe_pressure", None) is not None,
            jslab is not None)
    assert got == want
    assert case.solver._terms == 3
    # x3d2_tpu's sweeps at terms=3: w = 32 on the non-lane axes (64-point
    # blocks; its gate checks w = 16 in every mode), 64 on its lane axis;
    # the port's W = 32 on every axis
    if want[0] == "sweeps":
        assert (32, 64) in bands and (64, 128) in bands
        assert _port_widths(case) == {32}
    else:
        assert (32, 64) not in bands and _port_widths(case) == set()


@pytest.mark.parametrize("env", [{"X3D2_BF16_OLDS": "1"},
                                 {"X3D2_BF16_ACC": "1"},
                                 {"X3D2_BF16_OLDS": "1",
                                  "X3D2_XDIV_FUSED": "0"},
                                 {"X3D2_BF16_OLDS": "1",
                                  "X3D2_XDIV_FUSED": "0", "X3D2_D2C": "1"}])
def test_bf16_chains_at_w32_raise(monkeypatch, env):
    """x3d2_tpu builds its reduced-precision AB chains at w = 32 in the
    HIGHEST mode, and so does the port (it once raised NotImplementedError
    here): the fused chain, xdiv at this grid (z-x-y with
    X3D2_XDIV_FUSED=0; with X3D2_D2C=1 also the carry's chain without its z
    sweep and the boot z sweep), every sweep at W = 32 with the bfloat16
    streams the switches ask for; two steps finite, the history bfloat16.
    The compensated step (no fused chain) keeps its bfloat16 history.
    tests/test_torch_bf16.py holds the chains against x3d2_tpu's."""
    monkeypatch.setenv("X3D2_MATMUL_PRECISION", "highest")
    for k, val in env.items():
        monkeypatch.setenv(k, val)
    kw = dict(monitor_path=None, verbose=False, keep_pressure=False,
              device="cpu")
    olds = "X3D2_BF16_OLDS" in env
    case = TGVCase(Mesh(SHAPE, L, PER), SolverParams(dt=DT), **kw)
    assert case._fused_ab is not None
    assert case._ab_is_xdiv == ("X3D2_XDIV_FUSED" not in env)
    assert (case._olds_dtype == torch.bfloat16) == olds
    assert (case._acc_dtype == torch.bfloat16) == ("X3D2_BF16_ACC" in env)
    assert _port_widths(case) == {32}
    d2c = "X3D2_D2C" in env
    assert (case._pipe_d2c is not None) == d2c
    if d2c:
        assert {f.blocks.w for f in case._fused_ab_nod2.sweeps} == {32}
        assert case._d2_boot.blocks.w == 32
    s = case.initial_state()
    for _ in range(2):
        s = case.step(s)
    assert all(bool(torch.isfinite(s[k]).all()) for k in ("u", "v", "w"))
    if olds:
        assert {o.dtype for p in s["olds"] for o in p} == {torch.bfloat16}
    if olds:
        case = TGVCase(Mesh(SHAPE, L, PER),
                       SolverParams(dt=DT, compensated=True), **kw)
        assert case._olds_dtype == torch.bfloat16 and case._fused_ab is None


# ---------------------------------------------------------------------------
# compensated TGV in the HIGHEST mode against x3d2_tpu
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_highest_compensated_tgv_matches_x3d2_tpu(monkeypatch, dtype):
    monkeypatch.setenv("X3D2_MATMUL_PRECISION", "highest")
    monkeypatch.setattr(jcompact, "PRECISION", jax.lax.Precision.HIGHEST)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    p = dict(Re=1600, time_intg="AB3", dt=DT, compensated=True)
    kw = dict(monitor_path=None, verbose=False, keep_pressure=False)
    case = TGVCase(Mesh(SHAPE, L, PER), SolverParams(**p), dtype=tdt,
                   device="cpu", **kw)
    jcase = JTGVCase(JMesh(SHAPE, L, JPER), JSolverParams(**p), dtype=jdt,
                     **kw)
    assert case._fused_ab is None and case.solver._slab is not None
    # float32: the W = 32 sweep chain (its plain versions here); float64:
    # the dense products (the sweeps are float32 only)
    assert (_port_widths(case) == {32}) == (dtype == "float32")
    s, js = case.initial_state(), jcase.initial_state()
    for _ in range(1 if dtype == "float64" else 2):
        s, js = case.step(s), jcase._step(js)
    scale = np.abs(np.asarray(js["u"], np.float64)).max()
    for k in ("u", "v", "w"):
        d = np.abs(s[k].numpy().astype(np.float64)
                   - np.asarray(js[k], np.float64)).max()
        assert d <= (1e-10 * scale if dtype == "float64" else 1e-5), k
    if dtype == "float64":
        for c, jc in zip(s["comp"], js["comp"]):
            assert np.abs(c.numpy() - np.asarray(jc)).max() \
                <= 4 * EPS64 * scale
