"""Differentiable and batched simulation on PyTorch tensors.

Counterpart of x3d2_tpu.diffsim (diffsim.py:1-33), which presents these as
capabilities of the functional design beyond the reference's imperative
Fortran loop (src/case/base_case.f90:181-353):

- gradients of an observable after a rollout with respect to the initial
  state, the exact discrete adjoint of the whole scheme (transport, AB or
  RK update, boundary hooks, projection), through torch.autograd;
- ensembles: a batch of states, a leading axis on every tensor, advanced
  member by member.

On the einsum paths (X3D2_PALLAS=0, or grids where x3d2_tpu takes no
kernel) ``case.step`` records the autograd graph itself. The kernels carry
no backward, and on the CPU their plain versions are no backward either
(some detour through numpy), so a step that launches kernels raises when a
tensor of its state requires grad. :func:`differentiable_step` then gives
the step as a ``torch.autograd.Function``: its forward is ``case.step`` on
the kernels, its backward the vjp of the einsum twin's step
(:func:`make_einsum_twin`) at the same input state, as x3d2_tpu's
``jax.custom_vjp`` (diffsim.py:96-119): the exact discrete adjoint at the
kernel forward's states. The backward is plain PyTorch on the fields'
device, as x3d2_tpu's is XLA; it launches no kernel.

What JAX's functional design gives for free is done by hand here:
- the fused AB chain writes its outputs over the oldest history buffers:
  the forward clones those first, so the input state it saves for the
  backward survives, and a rollout never writes over its caller's state;
- the state's ``rng`` is a live torch.Generator that define_bc advances
  (the cylinder's and the channel's noise planes), where JAX's key is a
  value: the forward saves its state, and the backward's twin step and
  remat's recompute replay it on a generator of their own;
- ``lax.scan`` is a Python loop, ``jax.checkpoint`` a non-reentrant
  ``torch.utils.checkpoint``, ``jax.vmap`` a loop over the members (the
  kernels take no batch axis; a vmapped Pallas call is the members' calls).
"""

from __future__ import annotations

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from .common import env_set


def _kernels_active(case) -> bool:
    """True when the case's step launches any kernel: the fused AB and RK
    chains, the d2-in-C carry, the solver's sweep chains, dense sweeps and
    species sweeps, its pipeline and slab projections, and a sharded
    step's halo sweeps and repencilled projection (x3d2_tpu diffsim.py:
    43-52 reads its own)."""
    s = case.solver
    return (any(getattr(case, a, None) is not None
                for a in ("_fused_ab", "_fused_rk", "_pipe_d2c"))
            or any(getattr(s, a, None) is not None
                   for a in ("_sweeps", "_v1", "_species_sweeps", "_pipe",
                             "_slab", "_sharded_transeq",
                             "_repencil_pressure")))


def make_einsum_twin(case):
    """The case rebuilt with X3D2_PALLAS=0 (read in NavierStokes.build): no
    kernel branch, the einsum paths, whose autograd graph is the exact
    discrete adjoint of the scheme the kernels are held against. Every
    other switch is inherited, so the two states have the same keys,
    shapes and dtypes; the environment is restored afterwards (x3d2_tpu
    diffsim.py:55-76). The twin is built on the case's device."""
    kw = dict(dtype=case.dtype, monitor_path=None, verbose=False,
              keep_pressure=case.keep_pressure, device=case.device,
              seed=case.seed, case_cfg=case.case_cfg)
    if getattr(case, "ep", None) is not None:
        kw["ibm_mask"] = case.ep   # the cylinder's own mask
    with env_set({"X3D2_PALLAS": "0"}):
        return type(case)(case.mesh, case.params, **kw)


def _split(state):
    """(tensor leaves, rebuild): rebuild(tensors) is the state with its
    tensor leaves replaced, its other leaves (istep, rng) kept. rebuild
    holds no tensor: a Function's context keeps it, and a tensor there
    would keep the step's graph alive (its outputs' grad_fn is that
    context)."""
    leaves, spec = tree_flatten(state)
    at = [i for i, x in enumerate(leaves) if isinstance(x, torch.Tensor)]
    tensors = [leaves[i] for i in at]
    for i in at:
        leaves[i] = None

    def rebuild(tensors):
        out = list(leaves)
        for i, t in zip(at, tensors):
            out[i] = t
        return tree_unflatten(out, spec)

    return tensors, rebuild


def _generator(like, gen_state):
    """A new generator on `like`'s device, at `gen_state`."""
    g = torch.Generator(device=like.device)
    g.set_state(gen_state)
    return g


def _replayed(state, gen_state):
    """The state with its generator replaced by a new one at `gen_state`
    (the caller's generator is left where it is)."""
    rng = state.get("rng")
    if not isinstance(rng, torch.Generator):
        return state
    return dict(state, rng=_generator(rng, gen_state))


def _gen_state(state):
    rng = state.get("rng")
    return rng.get_state() if isinstance(rng, torch.Generator) else None


class _KernelStep(torch.autograd.Function):
    """One step: forward on the kernels (`call.forward`), backward the
    einsum twin's vjp at the saved input (`call.vjp`)."""

    @staticmethod
    def forward(ctx, call, *tensors):
        ctx.set_materialize_grads(False)
        ctx.call = call
        ctx.save_for_backward(*tensors)
        return tuple(call.forward(tensors))

    @staticmethod
    def backward(ctx, *cts):
        return (None,) + ctx.call.vjp(ctx.saved_tensors,
                                      ctx.needs_input_grad[1:], cts)


class _Call:
    """What one application of the kernel step keeps for its backward: the
    input's rebuild, its generator's state, the output's rebuild (no
    tensor: the Function saves its input)."""

    def __init__(self, case, twin, rebuild, gen_state):
        self.case, self.twin = case, twin
        self.rebuild, self.gen_state = rebuild, gen_state
        self.out_rebuild = None

    def forward(self, tensors):
        state = self.rebuild(list(tensors))
        if self.case._fused_ab is not None:
            # the chain writes u' (or rhs) over each field's oldest history
            # buffer (transeq_sweep.make_fused_transeq_ab final_out): those
            # are cloned, so the saved input survives
            olds = state["olds"]
            state = dict(state, olds=tuple(
                tuple(o[:-1]) + (o[-1].clone(),) if o else o
                for o in olds[:3]) + tuple(olds[3:]))
        out = self.case.step(state)
        outs, self.out_rebuild = _split(out)
        return outs

    def vjp(self, saved, needs, cts):
        """The twin's step re-run with grad from detached copies of the
        saved input (those the caller differentiates require grad), its
        generator replayed; the cotangents pulled back through its graph
        (zeros where an input is unused)."""
        with torch.enable_grad():
            xs = [t.detach().requires_grad_(n) for t, n in zip(saved, needs)]
            state = _replayed(self.rebuild(xs), self.gen_state)
            outs, _ = _split(self.twin.step(state))
        if len(outs) != len(cts):
            raise RuntimeError("the einsum twin's step returns another "
                               "state structure than the kernel step's")
        pairs = [(o, c) for o, c in zip(outs, cts)
                 if c is not None and o.requires_grad]
        wrt = [x for x in xs if x.requires_grad]
        grads = (torch.autograd.grad([o for o, _ in pairs], wrt,
                                     grad_outputs=[c for _, c in pairs],
                                     allow_unused=True)
                 if pairs else [None] * len(wrt))
        grads = iter(grads)
        out = []
        for x in xs:
            g = next(grads) if x.requires_grad else None
            if g is None and x.requires_grad:
                g = torch.zeros_like(x)
            out.append(g)
        return tuple(out)


def differentiable_step(case, einsum_case=None):
    """The case's step, differentiable (x3d2_tpu diffsim.py:79-119).

    With no kernel active this is ``case.step`` itself, whose einsum paths
    record the graph. Otherwise a cached callable ``step(state) -> state``
    over a torch.autograd.Function: the forward is ``case.step`` on the
    kernels (the same output tensors, bit for bit), the backward the exact
    vjp of the einsum twin's step (``einsum_case``, else
    :func:`make_einsum_twin`) at the same input state, with the input's
    generator replayed. It never writes over the caller's state (the
    buffers the fused AB chain writes over are cloned first), and it
    advances the state's generator as ``case.step`` does. ``istep`` and
    ``rng`` are not differentiable. The d2-in-C carry (X3D2_D2C=1)
    changes the state's structure and raises NotImplementedError, as in
    x3d2_tpu."""
    if not _kernels_active(case):
        return case.step
    if getattr(case, "_pipe_d2c", None) is not None:
        raise NotImplementedError(
            "differentiable_step does not support the X3D2_D2C carry")
    cached = getattr(case, "_diff_step", None)
    if cached is not None:
        return cached
    twin = einsum_case if einsum_case is not None else make_einsum_twin(case)
    if _kernels_active(twin):
        raise ValueError("the einsum twin launches kernels: build it with "
                         "X3D2_PALLAS=0")

    def step(state):
        tensors, rebuild = _split(state)
        call = _Call(case, twin, rebuild, _gen_state(state))
        outs = _KernelStep.apply(call, *tensors)
        return call.out_rebuild(list(outs))

    step.twin = twin
    case._diff_step = step
    return step


def _remat(step, state):
    """step(state) under a non-reentrant torch.utils.checkpoint: the
    backward recomputes the step's internals from its input. The first
    call advances the state's generator as the step does; the recompute
    replays it from its state before the step on a generator of its own
    (checkpoint's preserve_rng_state covers only the global generators)."""
    gen_state = _gen_state(state)
    first = [True]

    def body(s):
        if first[0]:
            first[0] = False
            return step(s)
        return step(_replayed(s, gen_state))

    return torch.utils.checkpoint.checkpoint(body, state, use_reentrant=False)


def rollout(case, state, n_steps: int, remat: bool = True):
    """Advance ``state`` by ``n_steps`` full time steps through
    :func:`differentiable_step`, differentiable end to end (x3d2_tpu
    diffsim.py:122-139, a Python loop for lax.scan). ``remat=True``
    recomputes each einsum step's internals in the backward, so reverse
    mode keeps one state a step boundary instead of every intermediate;
    the kernel step's Function already keeps only its input and recomputes
    the twin's step in its backward, so remat leaves it as it is (neither
    values nor gradients change)."""
    step = differentiable_step(case)
    for _ in range(n_steps):
        if remat and step == case.step:
            state = _remat(step, state)
        else:
            state = step(state)
    return state


def objective(case, observable, n_steps: int, remat: bool = True):
    """``f(u0, v0, w0) -> observable(final state)`` after ``n_steps`` steps
    from the case's initial state with its velocity replaced by the
    arguments (x3d2_tpu diffsim.py:142-155); take its gradient with
    ``torch.autograd.grad`` on arguments that require grad."""

    def f(u0, v0, w0):
        state = dict(case.initial_state(), u=u0, v=v0, w=w0)
        return observable(rollout(case, state, n_steps, remat=remat))

    return f


def kinetic_energy(state):
    """Mean kinetic energy 0.5 <|u|^2>, the TGV monitoring observable
    (x3d2_tpu diffsim.py:158-162)."""
    u, v, w = state["u"], state["v"], state["w"]
    return 0.5 * torch.mean(u * u + v * v + w * w)


def _without_rng(state):
    return {k: v for k, v in state.items() if k != "rng"}


def _stack(states):
    """Tensor leaves stacked along a new leading axis; the other leaves
    (istep) must be equal across the states."""
    flat = [tree_flatten(s) for s in states]
    spec = flat[0][1]
    if any(f[1] != spec for f in flat):
        raise ValueError("the states differ in structure")
    leaves = []
    for parts in zip(*(f[0] for f in flat)):
        if isinstance(parts[0], torch.Tensor):
            leaves.append(torch.stack(parts))
        elif all(p == parts[0] for p in parts):
            leaves.append(parts[0])
        else:
            raise ValueError(f"the states differ in a leaf that is not a "
                             f"tensor: {parts}")
    return tree_unflatten(leaves, spec)


def stack_states(states):
    """Stack a list of states into one batched state (x3d2_tpu diffsim.py:
    172-174): every tensor leaf along a new leading axis, ``rng`` a tuple
    of one generator a member (a copy of the member's, at its state), the
    other leaves (istep) equal across the members."""
    out = _stack([_without_rng(s) for s in states])
    if "rng" in states[0]:
        out["rng"] = tuple(_generator(s["rng"], s["rng"].get_state())
                           for s in states)
    return out


def ensemble_rollout(case, states, n_steps: int, remat: bool = False):
    """Advance a batched state (:func:`stack_states`) by ``n_steps`` steps,
    each member through :func:`rollout` in turn: member i of the result is
    member i run alone, bit for bit, its generator advanced. x3d2_tpu vmaps
    one program (diffsim.py:165-169); the kernels here take no batch axis,
    and a vmapped Pallas call is the members' calls."""
    tensors, rebuild = _split(_without_rng(states))
    outs = []
    for i in range(len(states["u"])):
        member = rebuild([t[i] for t in tensors])
        if "rng" in states:
            member["rng"] = states["rng"][i]
        outs.append(rollout(case, member, n_steps, remat=remat))
    out = _stack([_without_rng(o) for o in outs])
    if "rng" in states:
        out["rng"] = tuple(o["rng"] for o in outs)
    return out
