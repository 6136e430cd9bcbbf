"""The transport sweeps' plain versions against float64 references, at the
smallest shape the sweeps tile, (128, 128, 256), float32 on the CPU.

- Each sweep vs the dense float64 operator RHS: <= 3e-5 * scale, the
  bound x3d2_tpu holds its default-mode kernels to
  (tests/test_pallas_v3.py:63); here it covers f32 rounding and the band
  truncation at 1e-6 of the largest operator entry.
- The fused transport + AB chain vs x3d2_tpu's dense transeq followed by
  TimeIntegrator.ab_step, for the startup rows istep 1, 2, 3: <= 1e-5,
  as tests/test_fused_ab.py:52-61. The reference runs in float64, so the
  difference is the port's own f32 error.
- The xdiv chain (z, y, then x with the AB update and the x-transformed
  divergence inputs) vs the z, x, y chain, vs a float64 parity apply of
  its own u', v', w', and vs x3d2_tpu's xdiv chain in interpret mode; and
  the ValueError cases of build_xdiv_mats and make_transeq_sweep.
"""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax.numpy as jnp

from x3d2_tpu.common import BC as JBC
from x3d2_tpu.mesh import Mesh as JMesh
from x3d2_tpu.solver import NavierStokes as JNavierStokes
from x3d2_tpu.time_integrators import TimeIntegrator as JTimeIntegrator

from x3d2_tpu_torch.common import BC, DataLoc
from x3d2_tpu_torch.mesh import Mesh
from x3d2_tpu_torch.ops import transeq_sweep as ts
from x3d2_tpu_torch.solver import NavierStokes
from x3d2_tpu_torch.time_integrators import TimeIntegrator

# one thread for torch and for numpy's BLAS: the suite runs several workers
# on one machine, and multi-threaded BLAS calls in each of them, spinning on
# oversubscribed cores, made these tests many times slower there
torch.set_num_threads(1)
threadpool_limits(1, user_api="blas")


SHAPE = (128, 128, 256)
L = (2 * np.pi,) * 3
NU = 1 / 1600
DT = 1e-3


@pytest.fixture(scope="module")
def setup():
    mesh = Mesh(SHAPE, L, ((BC.PERIODIC, BC.PERIODIC),) * 3)
    ns = NavierStokes.build(mesh, NU, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(0)
    comps = tuple(rng.standard_normal(SHAPE).astype(np.float32)
                  for _ in range(3))
    return mesh, ns, comps


def _dir_reference64(ns, comps, axis):
    """Dense float64 RHS of one direction (as tests/test_pallas_v3.py)."""
    o = ns.ops[axis]
    c64 = [np.asarray(q, np.float64) for q in comps]
    conv = c64[axis]
    out = []
    for c in range(3):
        if c == axis:
            d1, dd, d2 = o.der1st, o.der1st_sym, o.der2nd
        else:
            d1, dd, d2 = o.der1st_sym, o.der1st, o.der2nd_sym

        def ap(M, f):
            return np.moveaxis(np.tensordot(M, f, axes=([1], [axis])), 0,
                               axis)

        q = c64[c]
        out.append(-0.5 * (conv * ap(d1.M64, q) + ap(dd.M64, q * conv))
                   + NU * ap(d2.M64, q))
    return out


def test_supported(setup):
    _, ns, _ = setup
    assert ts.transeq_sweep_supported(ns, SHAPE)
    assert not ts.transeq_sweep_supported(ns, (32, 32, 32))


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_sweep_plain_matches_f64(setup, axis):
    _, ns, comps = setup
    fn = ts.make_transeq_sweep(ns.ops[axis], NU, axis, SHAPE, device="cpu")
    got = fn(*(torch.from_numpy(q) for q in comps))
    for g, want in zip(got, _dir_reference64(ns, comps, axis)):
        scale = np.abs(want).max()
        err = np.abs(g.numpy().astype(np.float64) - want).max()
        assert err < 3e-5 * scale, f"{err:.2e} vs {scale:.2e}"


@pytest.fixture(scope="module")
def ab_inputs(setup):
    mesh, _, _ = setup
    X, Y, Z = mesh.coord_grids(DataLoc.VERT)
    u = np.sin(X) * np.cos(Y) * np.cos(Z)
    v = -np.cos(X) * np.sin(Y) * np.cos(Z)
    w = 0.1 * np.sin(X + 2 * Y) * np.cos(Z)
    rng = np.random.default_rng(1)
    fields = tuple(np.asarray(f, np.float32) for f in (u, v, w))
    olds = tuple(tuple((0.1 * rng.standard_normal(SHAPE)).astype(np.float32)
                       for _ in range(2)) for _ in range(3))
    jmesh = JMesh(SHAPE, L, ((JBC.PERIODIC, JBC.PERIODIC),) * 3)
    jns = JNavierStokes.build(jmesh, NU, dtype=jnp.float64)
    jf = tuple(jnp.asarray(f, jnp.float64) for f in fields)
    jrhs = jns.transeq(*jf)
    return fields, olds, jf, jrhs


@pytest.mark.parametrize("istep", [1, 2, 3])
def test_fused_ab_chain_matches_transeq_ab_step(setup, ab_inputs, istep):
    _, ns, _ = setup
    fields, olds, jf, jrhs = ab_inputs
    ti = TimeIntegrator("AB3")
    chain = ts.make_fused_transeq_ab(ns.ops, NU, SHAPE, ti.nolds,
                                     device="cpu")
    t_olds = tuple(tuple(torch.from_numpy(o.copy()) for o in per)
                   for per in olds)
    (un, vn, wn), rhs = chain(*(torch.from_numpy(f) for f in fields),
                              t_olds, ti.ab_row(istep, DT))
    jolds = tuple(tuple(jnp.asarray(o, jnp.float64) for o in per)
                  for per in olds)
    want, _ = JTimeIntegrator("AB3").ab_step(jf, jolds, istep, jrhs, DT)
    for g, e in zip((un, vn, wn), want):
        err = np.abs(g.numpy() - np.asarray(e)).max()
        assert err < 1e-5, f"u': {err:.2e}"
    for g, e in zip(rhs, jrhs):
        e = np.asarray(e)
        err = np.abs(g.numpy() - e).max()
        assert err < 1e-5 * np.abs(e).max(), f"rhs: {err:.2e}"
    # the chain wrote u' over the oldest history buffers (the rotation
    # drops them), as x3d2_tpu's aliasing does
    assert all(t_olds[c][-1] is o for c, o in enumerate((un, vn, wn)))


def test_cpu_sweeps_never_count_launches(setup):
    _, ns, comps = setup
    ts.reset_launch_counts()
    fn = ts.make_transeq_sweep(ns.ops[2], NU, 2, SHAPE, device="cpu")
    fn(*(torch.from_numpy(q) for q in comps))
    assert ts.launch_counts() == {}


# ---------------------------------------------------------------------------
# the xdiv chain: z sweep -> y sweep + acc -> x sweep + acc + AB + xdiv
# ---------------------------------------------------------------------------

def _chains(ns):
    """(z, x, y chain; xdiv chain) of the fused transport + AB update."""
    d64 = ns._fp_mats64()
    plain = ts.make_fused_transeq_ab(ns.ops, NU, SHAPE, 2, device="cpu")
    xdiv = ts.make_fused_transeq_ab(ns.ops, NU, SHAPE, 2, device="cpu",
                                    xdiv=(d64["sx"], d64["ix"]))
    return plain, xdiv


def _torch_inputs(ab_inputs, dtype):
    fields, olds = ab_inputs[:2]
    return (tuple(torch.from_numpy(f).to(dtype) for f in fields),
            tuple(tuple(torch.from_numpy(o.copy()).to(dtype) for o in per)
                  for per in olds))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
def test_xdiv_chain_matches_plain_chain(setup, ab_inputs, dtype, tol):
    """The reordered chain sums the same three direction terms in another
    order: a float reassociation of the rhs (1e-5 * scale in float32,
    1e-12 in float64). Its du, dv, dw equal a float64 parity apply of its
    own u', v', w' (the check of tests/test_fused_ab.py:143-159), to
    float32 rounding of a 64-long dot (3e-6) or float64's (1e-12)."""
    _, ns, _ = setup
    plain, xdiv = _chains(ns)
    dtc = TimeIntegrator("AB3").ab_row(3, DT)
    f, olds = _torch_inputs(ab_inputs, dtype)
    new_a, rhs_a = plain(*f, olds, dtc)
    f, olds = _torch_inputs(ab_inputs, dtype)
    new_x, rhs_x, divs = xdiv(*f, olds, dtc)
    assert xdiv.sweeps[2].xdiv is not None and plain.sweeps[2].xdiv is None
    assert all(olds[c][-1] is o for c, o in enumerate(new_x))
    for a, b in zip(new_a + rhs_a, new_x + rhs_x):
        err = float((a - b).abs().max())
        assert err < tol * float(a.abs().max()), f"{err:.2e}"
    h = SHAPE[0] // 2
    sl = (slice(None), slice(0, 4), slice(None))   # thin y slab
    m64 = xdiv.sweeps[2].xdiv.m64
    for key, fld, got in (("sx", new_x[0], divs[0]), ("ix", new_x[1], divs[1]),
                          ("ix", new_x[2], divs[2])):
        F = fld.numpy().astype(np.float64)[sl]
        want = np.concatenate([
            np.einsum("ab,byz->ayz", m64[key][:h], F[:h] + F[h:]),
            np.einsum("ab,byz->ayz", m64[key][h:], F[:h] - F[h:])])
        err = np.abs(got.numpy()[sl] - want).max()
        dtol = 3e-6 if dtype == torch.float32 else 1e-12
        assert err < dtol * np.abs(want).max(), f"{key}: {err:.2e}"


def test_xdiv_chain_matches_x3d2_tpu_kernel_chain(setup, ab_inputs):
    """Against x3d2_tpu's xdiv chain run in interpret mode (terms=3) on the
    same inputs, at the shape of tests/test_fused_ab.py: 3e-5 * scale, the
    bound x3d2_tpu holds its default-mode kernels to. The ordering of du,
    dv, dw is the JAX kernel's."""
    from x3d2_tpu.ops.pallas_kernels import make_fused_transeq_ab_v3

    _, ns, _ = setup
    _, xdiv = _chains(ns)
    fields, olds = ab_inputs[:2]
    jmesh = JMesh(SHAPE, L, ((JBC.PERIODIC, JBC.PERIODIC),) * 3)
    jns = JNavierStokes.build(jmesh, NU, dtype=jnp.float32)
    d64 = jns._fp_mats64()
    jchain = make_fused_transeq_ab_v3(jns.ops, NU, SHAPE, nolds=2,
                                      interpret=True, terms=3,
                                      xdiv=(d64["sx"], d64["ix"]))
    dtc = TimeIntegrator("AB3").ab_row(3, DT)
    want = jchain(*(jnp.asarray(f) for f in fields),
                  tuple(tuple(jnp.asarray(o) for o in per) for per in olds),
                  jnp.asarray(dtc, jnp.float32))
    f, t_olds = _torch_inputs(ab_inputs, torch.float32)
    got = xdiv(*f, t_olds, dtc)
    assert len(got) == len(want) == 3
    for gs, es in zip(got, want):
        for g, e in zip(gs, es):
            e = np.asarray(e)
            err = np.abs(g.numpy() - e).max()
            assert err < 3e-5 * np.abs(e).max(), f"{err:.2e}"


def test_xdiv_value_errors(setup, monkeypatch):
    """make_transeq_sweep and build_xdiv_mats raise where x3d2_tpu does
    (pallas_kernels.py:520-536) and beyond the size the kernel serves."""
    mesh, ns, _ = setup
    d64 = ns._fp_mats64()
    x = (d64["sx"], d64["ix"])
    with pytest.raises(ValueError, match="AB-fused axis-0"):
        ts.make_transeq_sweep(ns.ops[1], NU, 1, SHAPE, accumulate=True,
                              nolds=2, device="cpu", xdiv_mats=x)
    with pytest.raises(ValueError, match="AB-fused axis-0"):
        ts.make_transeq_sweep(ns.ops[0], NU, 0, SHAPE, accumulate=True,
                              device="cpu", xdiv_mats=x)
    with pytest.raises(ValueError, match="even block count"):
        ts.build_xdiv_mats(*x, 192, device="cpu")
    with pytest.raises(ValueError, match=r"\(n, n\)"):
        ts.build_xdiv_mats(d64["sx"][:, :64], d64["ix"], 128, device="cpu")
    with pytest.raises(ValueError, match="serves n <="):
        ts.build_xdiv_mats(*x, 512, device="cpu")
    rng = np.random.default_rng(2)
    with pytest.raises(ValueError, match="parity symmetry"):
        ts.build_xdiv_mats(rng.standard_normal((128, 128)), d64["ix"], 128,
                           device="cpu")
    # the kernel stages one operator block for all x blocks: unequal
    # blocks (never the case on a uniform periodic axis) are refused
    real = ts.build_sweep_blocks

    def skewed(*args, **kw):
        blocks = real(*args, **kw)
        blocks.m64["sa"][1] *= 1 + 1e-6
        return blocks

    monkeypatch.setattr(ts, "build_sweep_blocks", skewed)
    with pytest.raises(ValueError, match="equal operator blocks"):
        ts.make_transeq_sweep(ns.ops[0], NU, 0, SHAPE, accumulate=True,
                              nolds=1, device="cpu", xdiv_mats=x)
    monkeypatch.undo()
    # CPU tensors take the plain version and count no launch
    ts.reset_launch_counts()
    fn = ts.make_transeq_sweep(ns.ops[0], NU, 0, SHAPE, accumulate=True,
                               nolds=1, device="cpu", xdiv_mats=x)
    z = torch.zeros(SHAPE)
    out = fn(z, z, z, acc=(z, z, z), olds=((z,),) * 3, dtc=[DT, 0.0])
    assert len(out) == 3 and ts.launch_counts() == {}
    assert ts.variant_name(0, True, 2, True) == "transeq_sweep[x,acc,ab3,xdiv]"
