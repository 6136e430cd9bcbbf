"""State carried across between x3d2_tpu and the port.

A TGV or cylinder state of either package, as numpy arrays: ``u, v, w, p``,
the
1-based ``istep``, with passive scalars the stacked ``phi`` (nsp, nx, ny,
nz), and the per-field AB history ``olds`` (per field a (nolds,)-tuple,
newest first, the structure of ``TimeIntegrator.empty_olds``; with scalars
a 4th entry holds the stacked phi history). A Runge-Kutta state carries no
history: x3d2_tpu's has no ``olds``, the port's has an empty tuple per
field. The cylinder's IBM mask ``ep`` is no part of the state: it is the
case's parameter (``CylinderCase(..., ibm_mask=ep)``). A compensated AB
state also carries ``comp``, the Kahan compensation per field (the fields'
structure). A state of the d2-in-C carry (X3D2_D2C=1) also carries
``rhsp``, the z transport partials of its velocities (3 fields; derived
state, which ``run`` makes anew from u, v, w). A history stored in
bfloat16 (X3D2_BF16_OLDS) travels as
float32 arrays, since numpy has no bfloat16 without extra packages:
widening bfloat16 to float32 is exact and narrowing it back is exact, so
``state_from_numpy(..., olds_dtype=torch.bfloat16)`` restores the stored
bits (from x3d2_tpu: ``np.asarray(a.astype(jnp.float32))``). The JAX package's
PRNG ``key`` is dropped on the way in, and the port's state gets its own
``rng``, a torch.Generator seeded from ``seed`` (the two give different
numbers from one seed; the cylinder's inflow noise is drawn from it); the
way out drops ``rng`` and gives plain numpy arrays that the caller turns
into its own arrays.

On a process mesh (parallel/topo.py) a global state, x3d2_tpu's as numpy
(a sharded jax.Array read back with np.asarray is the global array), goes
to each rank as its local block (``state_from_numpy_sharded``), and the
ranks' blocks come back as the global numpy state
(``state_to_numpy_gathered``, collective); the round trip is bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from .common import resolve_device


def state_from_numpy(np_state, device=None, seed=0, olds_dtype=None):
    """The port's state from numpy arrays (x3d2_tpu's state as numpy),
    at the arrays' dtype; the history at `olds_dtype` where given (the
    case's ``_olds_dtype``)."""
    device = resolve_device(device)

    def t(a):
        a = np.array(a)   # a writable copy: JAX arrays convert read-only
        return torch.as_tensor(a, device=device).contiguous()

    state = {
        "u": t(np_state["u"]), "v": t(np_state["v"]), "w": t(np_state["w"]),
        "p": t(np_state["p"]),
        "istep": int(np.asarray(np_state["istep"])),
        "rng": torch.Generator(device=device).manual_seed(seed),
    }
    nfields = 3
    if "phi" in np_state:
        state["phi"] = t(np_state["phi"])
        nfields = 4
    # separate tensors per history slot, so the rotation never aliases
    olds = np_state.get("olds", ((),) * nfields)
    state["olds"] = tuple(
        tuple(t(o) if olds_dtype is None else t(o).to(olds_dtype)
              for o in per_field) for per_field in olds)
    if "comp" in np_state:
        state["comp"] = tuple(t(c) for c in np_state["comp"])
    if "rhsp" in np_state:
        state["rhsp"] = tuple(t(r) for r in np_state["rhsp"])
    return state


def state_to_numpy(state):
    """numpy arrays of the port's state, in the same structure."""
    def a(x):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()

    out = {
        "u": a(state["u"]), "v": a(state["v"]), "w": a(state["w"]),
        "p": a(state["p"]),
        "istep": int(state["istep"]),
        "olds": tuple(tuple(a(o) for o in per_field)
                      for per_field in state["olds"]),
    }
    if "phi" in state:
        out["phi"] = a(state["phi"])
    if "comp" in state:
        out["comp"] = tuple(a(c) for c in state["comp"])
    if "rhsp" in state:
        out["rhsp"] = tuple(a(r) for r in state["rhsp"])
    return out


def state_from_numpy_sharded(np_state, pmesh, device=None, seed=0,
                             olds_dtype=None):
    """This rank's local state from a global numpy state: every field
    sliced to the rank's block (parallel.topo.local_slices), then as
    state_from_numpy."""
    from .parallel.topo import local_slices

    def cut(a):
        a = np.asarray(a)
        return a[local_slices(pmesh, a.shape)] if a.ndim >= 3 else a

    def walk(v):
        if isinstance(v, (tuple, list)):
            return tuple(walk(x) for x in v)
        return cut(v)

    local = {k: (v if k == "istep" else walk(v))
             for k, v in np_state.items() if k != "key"}
    return state_from_numpy(local, device=device, seed=seed,
                            olds_dtype=olds_dtype)


def state_to_numpy_gathered(local_state, pmesh, mesh):
    """The global numpy state from the ranks' local states (collective:
    every rank calls it and gets it). mesh: the case's Mesh."""
    from .parallel.topo import gather_state

    return state_to_numpy(gather_state(pmesh, local_state, mesh))
