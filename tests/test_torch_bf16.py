"""The AB step's speed mode in the port against x3d2_tpu, on the CPU: the
bfloat16 AB history (X3D2_BF16_OLDS=1) with its error feedback and the
bfloat16 cross-direction partials (X3D2_BF16_ACC=1); and the one-field
parity x applies (X3D2_MERGED_X=0), the branch choice under every switch
the step reads, and the switches a case once refused at any value.

- ab_step with a bfloat16 history, float32 and float64, on the same numpy
  inputs as x3d2_tpu's ab_step: u' equal to 2 roundings of the state's
  dtype (the same operations in the same order; one multiply-add may be
  contracted on either side), the stored history bit-equal.
- The plain sweep with bfloat16 partials stores exactly RNE(its own
  float32 result) (tests/test_bf16_acc.py:46-65 semantics), and one with a
  bfloat16 history stores RNE(r) and adds dtc4 (r - RNE(r)) to u'.
- The fused AB chain, z-x-y and xdiv, with a bfloat16 history, bfloat16
  partials or both, against x3d2_tpu's make_fused_transeq_ab_v3(...,
  interpret=True, olds_dtype=, acc_dtype=) at (128, 128, 256), in the
  default mode and in the HIGHEST one (terms=3: x3d2_tpu's w = 32, the
  port's W = 32 instances): u' within
  5e-4 * scale and rhs within 2e-2 * max |rhs| (tests/test_bf16_acc.py's
  own bounds: two bfloat16 roundings of dt-scaled partial sums, and the
  quantisation of rhs itself); its buffers alias as x3d2_tpu's do.
- TGV (128, 128, 256) float32 AB3 with two scalars and a bfloat16 history,
  3 steps: the port's fused chain (plain versions) against x3d2_tpu's
  einsum step under the same flag; 1e-4 * scale (test_bf16_olds.py:85).
- The one-field parity x applies' plain versions against x3d2_tpu's
  make_x_apply(parity=..., interpret=True) (2e-4 * scale, the bound of
  tests/test_pallas_poisson.py:50-54) and plain float64 (1e-12 * scale).
- Branch choice: with x3d2_tpu's backend reported as a TPU (so its gates
  build its kernel branches; nothing is run), the port takes the branches
  x3d2_tpu takes under each switch; X3D2_D2C=1 takes the carry and
  X3D2_BFLY=0 the slab's dense forms exactly where x3d2_tpu does
  (tests/test_torch_d2c.py and test_torch_mid_forms.py hold them against
  x3d2_tpu's kernels).
"""

import contextlib
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
from x3d2_tpu.ops.pallas_kernels import make_fused_transeq_ab_v3
from x3d2_tpu.ops.pallas_poisson import make_x_apply
from x3d2_tpu.time_integrators import TimeIntegrator as JTimeIntegrator

from x3d2_tpu_torch.cases import SolverParams, TGVCase
from x3d2_tpu_torch.common import BC
from x3d2_tpu_torch.mesh import Mesh
from x3d2_tpu_torch.ops import operator_apply as oa
from x3d2_tpu_torch.ops import pressure_slab as sl
from x3d2_tpu_torch.ops import transeq_sweep as ts
from x3d2_tpu_torch.ops import x_apply_manual as xm
from x3d2_tpu_torch.time_integrators import TimeIntegrator

# one thread for torch and for numpy's BLAS: the suite runs several workers
# on one machine, and multi-threaded BLAS calls in each of them, spinning on
# oversubscribed cores, made these tests many times slower there
torch.set_num_threads(1)
threadpool_limits(1, user_api="blas")

SHAPE = (128, 128, 256)   # the smallest grid of the sweeps (z >= 256)
L = (2 * np.pi,) * 3
PER = ((BC.PERIODIC, BC.PERIODIC),) * 3
JPER = ((JBC.PERIODIC, JBC.PERIODIC),) * 3
SWITCHES = ("X3D2_BF16_OLDS", "X3D2_BF16_ACC", "X3D2_FUSED_AB",
            "X3D2_XDIV_FUSED", "X3D2_MERGED_X", "X3D2_PIPE3", "X3D2_BFLY",
            "X3D2_D2C", "X3D2_FUSED_RK")
BF = torch.bfloat16


@pytest.fixture(autouse=True)
def _clean_switches(monkeypatch):
    for k in SWITCHES:
        monkeypatch.delenv(k, raising=False)


def _rng(seed):
    return np.random.default_rng(seed)


def _bf16_np(a):
    """numpy float32 of the bfloat16 rounding of `a` (x3d2_tpu's astype)."""
    return np.array(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
                    .astype(jnp.float32))


@pytest.fixture(scope="module")
def case32():
    """The port's TGV at (128, 128, 256), float32, on the CPU."""
    return TGVCase(Mesh(SHAPE, L, PER), SolverParams(dt=1e-3),
                   dtype=torch.float32, monitor_path=None, verbose=False,
                   keep_pressure=False, device="cpu")


@pytest.fixture(scope="module")
def jops32():
    """x3d2_tpu's operators at (128, 128, 256), float32."""
    return JTGVCase(JMesh(SHAPE, L, JPER), JSolverParams(dt=1e-3),
                    dtype=jnp.float32, monitor_path=None,
                    verbose=False).solver.ops


# ---------------------------------------------------------------------------
# the AB step with a bfloat16 history
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("istep", [1, 3])
def test_ab_step_bf16_history_matches_x3d2_tpu(dtype, istep):
    rng = _rng(1)
    shape = (8, 8, 8)
    f = [rng.standard_normal(shape).astype(dtype) for _ in range(2)]
    r = [rng.standard_normal(shape).astype(dtype) for _ in range(2)]
    olds = [[_bf16_np(0.5 * rng.standard_normal(shape)) for _ in range(2)]
            for _ in range(2)]
    dt = 1e-3
    jti = JTimeIntegrator("AB3")
    jf, jo = jti.ab_step(tuple(jnp.asarray(a) for a in f),
                         tuple(tuple(jnp.asarray(o, jnp.bfloat16) for o in p)
                               for p in olds),
                         jnp.asarray(istep), tuple(jnp.asarray(a) for a in r),
                         dt)
    ti = TimeIntegrator("AB3")
    tf, to = ti.ab_step(tuple(torch.from_numpy(a) for a in f),
                        tuple(tuple(torch.from_numpy(o).to(BF) for o in p)
                              for p in olds),
                        istep, tuple(torch.from_numpy(a) for a in r), dt)
    eps = np.finfo(dtype).eps
    for a, b in zip(tf, jf):
        # the same operations in the same order; one multiply-add may be
        # contracted on either side: 2 roundings of the state's dtype
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=2 * eps * np.abs(np.asarray(b)).max())
    for pa, pb in zip(to, jo):
        assert [o.dtype for o in pa] == [BF, BF]
        for a, b in zip(pa, pb):
            np.testing.assert_array_equal(
                a.float().numpy(), np.asarray(b.astype(jnp.float32)))


def test_empty_olds_dtype_and_feedback_row():
    ti = TimeIntegrator("AB3")
    t = torch.zeros(4, 4, 4)
    olds = ti.empty_olds((t, t), dtype=BF)
    assert [[o.dtype for o in p] for p in olds] == [[BF, BF]] * 2
    row = ti.ab_row(3, 1e-3, feedback=True)
    # col 4: dt * future_coeff_sum in the state's dtype (x3d2_tpu
    # cases/base.py:412-420); AB3: -16/12 + 5/12 = -11/12
    assert row[4] == float(np.float32(1e-3 * (-11.0 / 12)))
    assert row[:4] == ti.ab_row(3, 1e-3)


# ---------------------------------------------------------------------------
# the plain sweep's bfloat16 streams
# ---------------------------------------------------------------------------

def test_bf16_partial_sweep_is_rne_of_its_f32_result(case32):
    """A sweep with bfloat16 partials widens acc exactly, adds it at float32
    and rounds only at the store: its output is RNE of the float32 sweep on
    the widened acc, bit for bit."""
    rng = _rng(2)
    u, v, w = (torch.from_numpy(0.1 * rng.standard_normal(SHAPE)
                                .astype(np.float32)) for _ in range(3))
    acc = tuple(torch.from_numpy(0.1 * rng.standard_normal(SHAPE)
                                 .astype(np.float32)).to(BF)
                for _ in range(3))
    blocks = ts.build_sweep_blocks(case32.solver.ops[0], 0, device="cpu")
    nu = case32.solver.nu
    red = ts.transeq_sweep(u, v, w, blocks, nu, acc=acc, acc_dtype=BF)
    ref = ts.transeq_sweep(u, v, w, blocks, nu,
                           acc=tuple(a.float() for a in acc))
    z = ts.transeq_sweep(u, v, w, ts.build_sweep_blocks(
        case32.solver.ops[2], 2, device="cpu"), nu, acc_dtype=BF)
    zref = ts.transeq_sweep(u, v, w, ts.build_sweep_blocks(
        case32.solver.ops[2], 2, device="cpu"), nu)
    for r, f in zip(red + z, ref + zref):
        assert r.dtype == BF
        assert torch.equal(r.view(torch.int16), f.to(BF).view(torch.int16))


def test_bf16_history_sweep_stores_rne_and_feeds_back(case32):
    rng = _rng(3)
    u, v, w = (torch.from_numpy(0.1 * rng.standard_normal(SHAPE)
                                .astype(np.float32)) for _ in range(3))
    acc = tuple(torch.from_numpy(rng.standard_normal(SHAPE)
                                 .astype(np.float32)) for _ in range(3))
    olds = tuple(tuple(torch.from_numpy(rng.standard_normal(SHAPE).astype(
        np.float32)).to(BF) for _ in range(2)) for _ in range(3))
    blocks = ts.build_sweep_blocks(case32.solver.ops[1], 1, device="cpu")
    nu = case32.solver.nu
    dtc = TimeIntegrator("AB3").ab_row(3, 1e-3, feedback=True)
    (un, rs) = ts.transeq_sweep(u, v, w, blocks, nu, acc=acc, olds=olds,
                                dtc=dtc)
    r = ts.transeq_sweep(u, v, w, blocks, nu, acc=acc)
    for c in range(3):
        assert rs[c].dtype == BF and torch.equal(rs[c], r[c].to(BF))
        want = (u, v, w)[c] + dtc[0] * r[c]
        for j in range(2):
            want = want + dtc[1 + j] * olds[c][j].float()
        want = want + dtc[4] * (r[c] - r[c].to(BF).float())
        assert torch.equal(un[c], want)
    with pytest.raises(ValueError, match="reduced-precision"):
        ts.make_transeq_sweep(case32.solver.ops[0], nu, 0, SHAPE,
                              accumulate=True, nolds=2, olds_dtype=BF)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ts.make_fused_transeq_ab(case32.solver.ops, nu, SHAPE, 2,
                                 device="cpu", olds_dtype=torch.float16)


# ---------------------------------------------------------------------------
# the fused AB chain against x3d2_tpu's kernel chain (interpret mode)
# ---------------------------------------------------------------------------

# (chain, bfloat16 history, bfloat16 partials, x3d2_tpu's kernel terms: 3
# is the HIGHEST mode, X3D2_MATMUL_PRECISION=highest, the port's W = 32)
CHAINS = [("zxy", True, False, 2), ("zxy", False, True, 2),
          ("zxy", True, True, 2), ("xdiv", True, False, 2),
          ("xdiv", True, True, 2), ("zxy", True, False, 3),
          ("zxy", False, True, 3), ("zxy", True, True, 3),
          ("xdiv", True, True, 3)]


@pytest.mark.parametrize("chain,olds_red,acc_red,terms", [
    pytest.param(*c, id=f"{c[0]}-{c[1]}-{c[2]}"
                 + ("-highest" if c[3] == 3 else "")) for c in CHAINS])
def test_fused_chain_matches_x3d2_tpu_kernel_chain(case32, jops32, chain,
                                                   olds_red, acc_red, terms):
    """At x3d2_tpu's terms 2 and, in the HIGHEST mode, 3 (its w = 32 chain
    against the port's W = 32 instances' plain versions); the bounds are
    the bfloat16 streams', the same in both modes."""
    rng = _rng(4)
    ops, nu = case32.solver.ops, case32.solver.nu
    u, v, w, o0, o1, o2 = (0.1 * rng.standard_normal(SHAPE)
                           .astype(np.float32) for _ in range(6))
    holds = [[0.05 * o, 0.02 * o] for o in (o0, o1, o2)]
    if olds_red:
        holds = [[_bf16_np(x) for x in p] for p in holds]
    odt = BF if olds_red else None
    adt = BF if acc_red else None
    d64 = case32.solver._fp_mats64()
    xdiv = (d64["sx"], d64["ix"]) if chain == "xdiv" else None
    dt = 1e-3
    row = [dt, 1.5 * dt, -0.5 * dt, 0.0] + ([dt] if olds_red else [])
    jfn = make_fused_transeq_ab_v3(
        jops32, nu, SHAPE, nolds=2, interpret=True, xdiv=xdiv, terms=terms,
        olds_dtype=jnp.bfloat16 if olds_red else None,
        acc_dtype=jnp.bfloat16 if acc_red else None)
    jout = jfn(*(jnp.asarray(a) for a in (u, v, w)),
               tuple(tuple(jnp.asarray(x, jnp.bfloat16 if olds_red
                                       else jnp.float32) for x in p)
                     for p in holds),
               jnp.asarray(row, jnp.float32))
    fn = ts.make_fused_transeq_ab(ops, nu, SHAPE, 2, device="cpu",
                                  xdiv=xdiv, olds_dtype=odt, acc_dtype=adt,
                                  terms=terms)
    assert {f.blocks.w for f in fn.sweeps} == {16 if terms == 2 else 32}
    olds = tuple(tuple(torch.from_numpy(x).to(odt or torch.float32)
                       for x in p) for p in holds)
    oldest = [p[-1] for p in olds]
    out = fn(*(torch.from_numpy(a) for a in (u, v, w)), olds, row)
    scale = float(np.abs(np.asarray(jout[0][0])).max())
    for got, want in zip(out[0], jout[0]):
        assert got.dtype == torch.float32
        err = np.abs(got.numpy() - np.asarray(want)).max()
        assert err < 5e-4 * scale, f"{err:.2e} vs {scale:.2e}"
    for got, want in zip(out[1], jout[1]):
        assert got.dtype == (BF if olds_red else torch.float32)
        want = np.asarray(want.astype(jnp.float32))
        err = np.abs(got.float().numpy() - want).max()
        assert err < 2e-2 * np.abs(want).max()
    if chain == "xdiv":
        for got, want in zip(out[2], jout[2]):
            want = np.asarray(want)
            err = np.abs(got.numpy() - want).max()
            assert err < 5e-4 * np.abs(want).max()
    # the buffers the final sweep wrote (x3d2_tpu's alias pairings,
    # pallas_kernels.py:567-594): the oldest history takes u' where its
    # dtype is u''s, rhs where it is rhs's
    if olds_red and not acc_red:
        assert all(r is o for r, o in zip(out[1], oldest))
    elif not olds_red:
        assert all(q is o for q, o in zip(out[0], oldest))
    else:
        assert not any(q is o or r is o for q, r, o in
                       zip(out[0], out[1], oldest))


def test_species_bf16_history_matches_x3d2_tpu(monkeypatch):
    """TGV with two scalars, AB3, bfloat16 history, 3 steps: the port's
    fused chain and species sweeps (plain versions) with the elementwise phi
    update and its feedback, against x3d2_tpu's einsum step under the same
    flag. Both quantise the history of the same rhs; where the two rhs
    straddle a bfloat16 rounding boundary one bfloat16 ulp enters through
    dt*c_j (test_bf16_olds.py:85's 1e-4 * scale)."""
    monkeypatch.setenv("X3D2_BF16_OLDS", "1")
    prm = dict(Re=1600, time_intg="AB3", dt=1e-3, n_species=2,
               pr_species=(0.7, 1.0))
    kw = dict(monitor_path=None, verbose=False, keep_pressure=False)
    case = TGVCase(Mesh(SHAPE, L, PER), SolverParams(**prm),
                   dtype=torch.float32, device="cpu", **kw)
    jcase = JTGVCase(JMesh(SHAPE, L, JPER), JSolverParams(**prm),
                     dtype=jnp.float32, **kw)
    assert case._fused_ab is not None and case._olds_dtype == BF
    s, js = case.initial_state(), jcase.initial_state()
    for _ in range(3):
        s, js = case.step(s), jcase._step(js)
    assert [o.dtype for p in s["olds"] for o in p] == [BF] * 8
    # scaled by max |u| (w starts at 0), and max |phi| for phi
    for k in ("u", "v", "w", "phi"):
        want = np.asarray(js[k])
        scale = np.abs(np.asarray(js["phi" if k == "phi" else "u"])).max()
        err = np.abs(s[k].numpy() - want).max()
        assert err < 1e-4 * scale, (k, err)


# ---------------------------------------------------------------------------
# the one-field parity x applies (X3D2_MERGED_X=0, pressure_grads)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,sub", [("sx", False), ("ix", False),
                                      ("gxs", False), ("gxi", False),
                                      ("gxs", True), ("gxi", True)])
def test_x_apply_parity_matches_x3d2_tpu(case32, name, sub):
    pm = case32.solver._slab
    jname = {"sx": "sx", "ix": "ix", "gxs": "gx_s", "gxi": "gx_i"}[name]
    M64 = case32.solver._fp_mats64()[jname]
    rng = _rng(5)
    f = rng.standard_normal(SHAPE).astype(np.float32)
    s = rng.standard_normal(SHAPE).astype(np.float32) if sub else None
    jfn = make_x_apply(M64, terms=2, sub=sub, interpret=True,
                       parity="fwd" if name in ("sx", "ix") else "inv")
    want = np.asarray(jfn(jnp.asarray(f), *(() if s is None
                                            else (jnp.asarray(s),))))
    oa.reset_launch_counts()
    xm.reset_launch_counts()
    got = sl.x_apply_parity(name, torch.from_numpy(f), pm,
                            None if s is None else torch.from_numpy(s))
    # CPU tensors take the plain version: no launch of the x-apply kernel
    # (csrc/x_apply_manual.cu, which serves them on the card) or the
    # template
    assert oa.launch_counts() == {} and xm.launch_counts() == {}
    scale = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= 2e-4 * scale
    # plain float64 against the float64 operator (natural x order in and
    # out of the physical side; block-parity order on the modes' side)
    got64 = sl.x_apply_parity(name, torch.from_numpy(f.astype(np.float64)),
                              pm, None if s is None
                              else torch.from_numpy(s.astype(np.float64)))
    perm = pm.x_perm
    if name in ("sx", "ix"):
        ref = np.einsum("ij,jkl->ikl", M64, f.astype(np.float64))[perm]
    else:
        ref = np.einsum("ij,jkl->ikl", M64[:, perm], f.astype(np.float64))
        if sub:
            ref = s - ref
    assert np.abs(got64.numpy() - ref).max() <= 1e-12 * np.abs(ref).max()
    if name in ("sx", "ix"):
        with pytest.raises(ValueError, match="inverse-stage"):
            sl.x_apply_parity(name, torch.from_numpy(f), pm,
                              torch.from_numpy(f))


def test_merged_x_off_takes_the_one_field_kernels(monkeypatch):
    """X3D2_MERGED_X=0 (x3d2_tpu pallas_poisson.py:709-715): the slab's x
    stage goes one field a call, 3 forward and 3 subtracting inverse
    applies in place of x_div3 and x_gradsub3, the same projection."""
    rng = _rng(6)
    t = [torch.from_numpy(rng.standard_normal(SHAPE).astype(np.float32))
         for _ in range(3)]
    results = {}
    for merged in ("1", "0"):
        monkeypatch.setenv("X3D2_MERGED_X", merged)
        case = TGVCase(Mesh(SHAPE, L, PER), SolverParams(dt=1e-3),
                       dtype=torch.float32, monitor_path=None, verbose=False,
                       keep_pressure=True, device="cpu")
        calls = []
        for fn in ("x_div3", "x_gradsub3", "x_apply_parity"):
            inner = getattr(sl, fn)
            monkeypatch.setattr(sl, fn, lambda *a, _f=inner, _n=fn, **k: (
                calls.append((_n, a[0] if _n == "x_apply_parity" else None,
                              len(a) > 3 and a[3] is not None)),
                _f(*a, **k))[1])
        results[merged] = case.solver.pressure_correction(*t,
                                                          keep_pressure=True)
        monkeypatch.undo()
        if merged == "1":
            assert case.solver._merged_x
            assert [c[0] for c in calls] == ["x_div3", "x_gradsub3"]
        else:
            assert not case.solver._merged_x
            assert calls == [("x_apply_parity", n, sub) for n, sub in (
                ("sx", False), ("ix", False), ("ix", False), ("gxs", True),
                ("gxi", True), ("gxi", True))]
    for a, b in zip(results["1"], results["0"]):
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())


# ---------------------------------------------------------------------------
# the branches under each switch, against x3d2_tpu's gates
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _tpu_gates():
    """x3d2_tpu builds its kernel branches only on a TPU backend with no
    other default device (solver.py:106-110); report one while its case is
    built (building runs no kernel)."""
    real = jax.default_backend
    device = jax.config.jax_default_device
    jax.default_backend = lambda: "tpu"
    jax.config.update("jax_default_device", None)
    try:
        yield
    finally:
        jax.default_backend = real
        jax.config.update("jax_default_device", device)


def _branches(shape, env, compensated=False, keep_pressure=False):
    """(port, x3d2_tpu) branch tuples under `env`: the history and partial
    dtypes, the fused AB chain (None, "zxy", "xdiv"), the pipeline, the
    slab's x stage ("merged", "field", "dense")."""
    for k, val in env.items():
        os.environ[k] = val
    try:
        prm = dict(dt=1e-3, compensated=compensated)
        kw = dict(monitor_path=None, verbose=False,
                  keep_pressure=keep_pressure)
        case = TGVCase(Mesh(shape, L, PER), SolverParams(**prm),
                       dtype=torch.float32, device="cpu", **kw)
        with _tpu_gates():
            jcase = JTGVCase(JMesh(shape, L, JPER), JSolverParams(**prm),
                             dtype=jnp.float32, **kw)
    finally:
        for k in env:
            del os.environ[k]
    slab = case.solver._slab
    got = ("bf16" if case._olds_dtype == BF else None,
           "bf16" if case._acc_dtype == BF else None,
           None if case._fused_ab is None
           else "xdiv" if case._ab_is_xdiv else "zxy",
           case.solver._pipe is not None,
           None if slab is None else "dense" if slab.x_perm is None
           else "merged" if case.solver._merged_x else "field")
    jslab = getattr(jcase.solver, "_slab_pressure", None)
    want = ("bf16" if jcase._olds_dtype == jnp.bfloat16 else None,
            "bf16" if jcase._acc_dtype == jnp.bfloat16 else None,
            None if jcase._fused_ab is None
            else "xdiv" if jcase._ab_is_xdiv else "zxy",
            getattr(jcase.solver, "_pipe_pressure", None) is not None,
            None if jslab is None else "dense" if jslab[3].x_perm is None
            else "merged" if "div3" in jslab[2] else "field")
    return got, want


@pytest.mark.parametrize("shape,env,comp,expect", [
    (SHAPE, {}, False, (None, None, "xdiv", True, "merged")),
    (SHAPE, {"X3D2_BF16_OLDS": "1"}, False,
     ("bf16", None, "xdiv", True, "merged")),
    (SHAPE, {"X3D2_BF16_OLDS": "1", "X3D2_BF16_ACC": "1"}, False,
     ("bf16", "bf16", "xdiv", True, "merged")),
    (SHAPE, {"X3D2_BF16_ACC": "1", "X3D2_XDIV_FUSED": "0"}, False,
     (None, "bf16", "zxy", True, "merged")),
    (SHAPE, {"X3D2_FUSED_AB": "0"}, False, (None, None, None, True,
                                           "merged")),
    (SHAPE, {"X3D2_MERGED_X": "0"}, False, (None, None, "xdiv", True,
                                           "field")),
    (SHAPE, {"X3D2_PIPE3": "0"}, False, (None, None, "xdiv", False,
                                        "merged")),
    (SHAPE, {"X3D2_BF16_OLDS": "1"}, True, ("bf16", None, None, True,
                                           "merged")),
    ((512,) * 3, {"X3D2_BF16_OLDS": "1", "X3D2_BF16_ACC": "1"}, False,
     ("bf16", "bf16", "zxy", True, "merged")),
    ((512,) * 3, {}, True, (None, None, None, True, "merged")),
    ((128,) * 3, {"X3D2_BF16_OLDS": "1"}, False,
     ("bf16", None, None, True, "merged")),
])
def test_branch_choice_under_switches_matches_x3d2_tpu(shape, env, comp,
                                                       expect):
    got, want = _branches(shape, env, compensated=comp)
    assert got == want == expect


@pytest.mark.parametrize("env,keep", [
    ({"X3D2_D2C": "1"}, False), ({"X3D2_D2C": "1"}, True),
    ({"X3D2_D2C": "1", "X3D2_XDIV_FUSED": "0"}, False),
    ({"X3D2_D2C": "1", "X3D2_XDIV_FUSED": "0"}, True),
    ({"X3D2_D2C": "1", "X3D2_XDIV_FUSED": "0", "X3D2_BF16_ACC": "1"}, False)])
def test_d2c_raises_where_x3d2_tpu_takes_it(env, keep):
    """X3D2_D2C=1 builds the carry where x3d2_tpu's carry gate holds
    (cases/base.py:182-211), and the state carries the z partials where
    the step uses them (keep_pressure=False, :326-330); elsewhere
    x3d2_tpu ignores the switch, and so does the port (the name is from
    when the port raised there)."""
    for k, val in env.items():
        os.environ[k] = val
    try:
        kw = dict(monitor_path=None, verbose=False, keep_pressure=keep)
        with _tpu_gates():
            jcase = JTGVCase(JMesh(SHAPE, L, JPER), JSolverParams(dt=1e-3),
                             dtype=jnp.float32, **kw)
        case = TGVCase(Mesh(SHAPE, L, PER), SolverParams(dt=1e-3),
                       device="cpu", **kw)
        state = case.initial_state()
    finally:
        for k in env:
            del os.environ[k]
    built = jcase._pipe_d2c is not None
    assert (case._pipe_d2c is not None) == built
    takes = built and not keep
    assert ("rhsp" in state) == takes
    if takes:
        assert len(state["rhsp"]) == 3 and not case._ab_is_xdiv
    assert takes == (env.get("X3D2_XDIV_FUSED") == "0" and not keep
                     and "X3D2_BF16_ACC" not in env)


def test_bfly_and_merged_x_are_not_ignored(monkeypatch):
    """X3D2_BFLY=0 on a slab grid takes the dense-Ty and dense-z forms of
    the mid and the dense x stage, as x3d2_tpu (pallas_poisson.py:588-708;
    the pipeline keeps its parity splits, :1593-1604); on a grid without
    the slab x3d2_tpu ignores it, and so does the port. X3D2_MERGED_X=0
    switches the x stage (above)."""
    monkeypatch.setenv("X3D2_BFLY", "0")
    case = TGVCase(Mesh(SHAPE, L, PER), SolverParams(), device="cpu",
                   monitor_path=None)
    slab = case.solver._slab
    assert slab.dense and slab.x_perm is None and slab.q_perm is None
    assert not case.solver._pipe.mats.dense and not case._ab_is_xdiv
    case = TGVCase(Mesh((32,) * 3, L, PER), SolverParams(), device="cpu",
                   monitor_path=None)
    assert case.solver._slab is None
    monkeypatch.setenv("X3D2_BFLY", "1")
    case = TGVCase(Mesh(SHAPE, L, PER), SolverParams(), device="cpu",
                   monitor_path=None)
    assert not case.solver._slab.dense and case._ab_is_xdiv


def test_bfly_raises_where_the_solver_builds_the_slab(monkeypatch):
    """X3D2_BFLY is read where the slab is built, as in x3d2_tpu
    (pallas_poisson.py:589-603): NavierStokes.build itself builds the
    dense forms on a slab grid, also with the pipeline switched off, and
    the pipeline's own operator set keeps the parity splits; without the
    slab the switch is ignored (the name is from when the port raised
    there)."""
    from x3d2_tpu_torch.solver import NavierStokes
    monkeypatch.setenv("X3D2_BFLY", "0")
    for pipe3 in ("1", "0"):
        monkeypatch.setenv("X3D2_PIPE3", pipe3)
        ns = NavierStokes.build(Mesh(SHAPE, L, PER), 1e-3, device="cpu")
        assert ns._slab.dense and ns._slab.x_perm is None
        assert (ns._pipe is not None) == (pipe3 == "1")
        assert ns._pipe is None or not ns._pipe.mats.dense
    assert NavierStokes.build(Mesh((32,) * 3, L, PER), 1e-3,
                              device="cpu")._slab is None


@pytest.mark.parametrize("switch,value,expect", [
    ("X3D2_MID_SPLIT", "1", "runs"),
    ("X3D2_MATMUL_PRECISION", "highest", "w32"),
    ("X3D2_PALLAS", "0", "dense"),
    ("X3D2_CHUNK", "0", "runs"),
    ("X3D2_MATMUL_PRECISION", "bf16x9", "ValueError")])
def test_unported_switches_raise_naming_their_kernels(monkeypatch, switch,
                                                      value, expect):
    """The four switches a case refused at any value until they were read
    where x3d2_tpu reads them. X3D2_MID_SPLIT=1 and X3D2_CHUNK=0 on a grid
    without the slab: the case runs, as x3d2_tpu's (where the slab's mid
    runs the split takes its two halves: tests/test_torch_switches.py).
    X3D2_MATMUL_PRECISION=highest: the sweeps at the W = 32 band; an
    unknown value raises ValueError (x3d2_tpu: KeyError). X3D2_PALLAS=0:
    the einsum paths, no kernel branch."""
    monkeypatch.setenv(switch, value)
    kw = dict(device="cpu", monitor_path=None, verbose=False)
    if expect == "ValueError":
        with pytest.raises(ValueError, match="X3D2_MATMUL_PRECISION"):
            TGVCase(Mesh((32,) * 3, L, PER), SolverParams(), **kw)
    elif expect == "runs":
        case = TGVCase(Mesh((32,) * 3, L, PER), SolverParams(), **kw)
        state = case.run(n_iters=2, n_output=1)
        assert int(state["istep"]) == 3
        assert all(torch.isfinite(state[k]).all() for k in "uvw")
    else:
        case = TGVCase(Mesh(SHAPE, L, PER), SolverParams(), **kw)
        if expect == "w32":
            assert case.solver._terms == 3
            assert [f.blocks.w for f in case._fused_ab.sweeps] == [32] * 3
        else:
            assert case.solver._transport == "dense"
            assert case.solver._slab is None and case.solver._pipe is None
            assert case._fused_ab is None and case.solver._sweeps is None


def test_bf16_state_crosses_with_x3d2_tpu(monkeypatch):
    """A bfloat16-history state handed over from x3d2_tpu (float32 arrays,
    np.asarray(a.astype(jnp.float32))) and continued in the port matches
    x3d2_tpu's own run (float64 state, 32^3, 3 + 3 steps), and comes back
    as float32 arrays holding the same bfloat16 values."""
    from x3d2_tpu_torch.convert import state_from_numpy, state_to_numpy
    monkeypatch.setenv("X3D2_BF16_OLDS", "1")
    shape = (32,) * 3
    kw = dict(monitor_path=None, verbose=False, keep_pressure=False)
    case = TGVCase(Mesh(shape, L, PER), SolverParams(dt=1e-3),
                   dtype=torch.float64, device="cpu", **kw)
    jcase = JTGVCase(JMesh(shape, L, JPER), JSolverParams(dt=1e-3),
                     dtype=jnp.float64, **kw)
    js = jcase.initial_state()
    for _ in range(3):
        js = jcase._step(js)
    handed = {k: np.asarray(js[k]) for k in ("u", "v", "w", "p", "istep")}
    handed["olds"] = tuple(tuple(np.asarray(o.astype(jnp.float32))
                                 for o in p) for p in js["olds"])
    s = state_from_numpy(handed, device="cpu", olds_dtype=case._olds_dtype)
    assert [o.dtype for p in s["olds"] for o in p] == [BF] * 6
    for _ in range(3):
        s, js = case.step(s), jcase._step(js)
    out = state_to_numpy(s)
    for k in ("u", "v", "w"):
        want = np.asarray(js[k])
        # float64 states, the same bfloat16 history: the f64 roundings of
        # two orders of summation, and a rhs straddling a bfloat16
        # boundary would enter through dt*c_j (none at this size)
        assert np.abs(out[k] - want).max() <= 1e-12 * np.abs(want).max()
    # the history: the same bfloat16 values but where the two float64 rhs
    # straddle a rounding boundary (one bfloat16 ulp, 2^-7 relative) or are
    # rounding noise of the O(1) transport terms (TGV's w rhs, 1e-16 here;
    # 1e-14 absolute, max |u| = 1)
    for pa, pb in zip(out["olds"], js["olds"]):
        for a, b in zip(pa, pb):
            assert a.dtype == np.float32
            b = np.asarray(b.astype(jnp.float32))
            assert (np.abs(a - b) <= 2.0 ** -7 * np.abs(b) + 1e-14).all()
