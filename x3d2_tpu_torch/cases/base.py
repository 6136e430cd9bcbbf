"""Case lifecycle and the time loop.

Counterpart of x3d2_tpu.cases.base (reference src/case/base_case.f90):
per substage {define_bc -> transeq -> forcings -> time update -> apply_bc
-> body (IBM) -> pressure_correction} (base_case.f90:261-300), with
monitoring. The hooks define_bc, forcings, apply_bc and body are those of
x3d2_tpu (cases/base.py:321-341); the tail apply_bc -> body -> projection
is ``_substage_post`` (:343-370). define_bc draws its random numbers from
the state's ``rng``, a torch.Generator seeded from the case's ``seed`` on
its device (in x3d2_tpu a JAX PRNG key, split per substage; the two give
different numbers from one seed).

The four branches of x3d2_tpu's step (cases/base.py:377-524), each taken
where x3d2_tpu takes it:
- AB, unfused (:390-405): transeq (+ species) and ab_step, the update as
  elementwise PyTorch (XLA in x3d2_tpu); on the grids where x3d2_tpu's
  transport is its dense sweep kernel or its einsums (TGV 128^3, the
  cylinder), with X3D2_FUSED_AB=0, and for compensated stepping
  (SolverParams.compensated: ab_step_compensated, then the tail
  _substage_post(comp=), which takes the gradients from
  solver.pressure_grads and adds them through the Kahan compensation).
- AB, fused (:406-471): an AB scheme with history, not compensated,
  X3D2_FUSED_AB not "0", identity forcings, the sweep chains built (the
  solver's transport is the sweeps). The transport + AB sweep chain; under
  x3d2_tpu's gate
  (:141-167: the slab projection with a parity x stage, identity apply_bc
  and body, max(dims) <= 256, X3D2_XDIV_FUSED is not "0") the xdiv one:
  z, y, then the x sweep with the AB update, which also emits the
  projection's x-transformed divergence inputs for the slab projection.
  Otherwise z, x, y with the AB update, then the three-stage pipeline
  (keep_pressure=False) or the slab projection (keep_pressure=True).
  Passive scalars take their RHS from the species sweep chain on the
  velocities before the update (the chain then consumes the history's
  buffers) and the AB update as elementwise PyTorch, as x3d2_tpu does in
  XLA.
- RK, fused (:472-496): RK without scalars, not compensated, identity
  forcings, X3D2_FUSED_RK not "0", a mesh the sweep kernel supports. Per
  substage the sweep chain with the substage update in the y sweep, then
  the projection.
- RK, unfused (:497-514; RK with scalars, or X3D2_FUSED_RK=0): per
  substage transeq (+ species), rk_substage, the projection.
The AB history may be stored in bfloat16 (X3D2_BF16_OLDS=1, AB with
history), with x3d2_tpu's error feedback in every AB branch; the fused AB
chain may keep its cross-direction partials in bfloat16 (X3D2_BF16_ACC=1;
the other chains stay float32, as in x3d2_tpu). X3D2_FUSED_AB,
X3D2_XDIV_FUSED, X3D2_FUSED_RK (here) and X3D2_PIPE3, X3D2_MERGED_X,
X3D2_PALLAS (the solver) route between ported branches as in x3d2_tpu;
X3D2_MATMUL_PRECISION=highest builds every sweep chain (the solver's and
the fused AB and RK chains here) at the W=32 band, as x3d2_tpu's terms=3
(cases/base.py:139, :226). X3D2_D2C=1, under x3d2_tpu's carry gate
(cases/base.py:174-211: the fused AB chain that is not the xdiv one, no
bfloat16 partials, no scalars, no compensation, identity define_bc,
apply_bc and body, the pipeline built), carries the next step's z sweep
in the projection: with keep_pressure=False the state holds ``rhsp``, the
z partials of its velocities (a boot z sweep in ``initial_state``, again
whenever a state enters ``run``), and the step runs the chain without its
z sweep from them, then the pipeline whose stage C also returns the next
``rhsp`` (ops/pressure_pipe.py pipe_c_d2; :420-434, the hooks skipped).
A bfloat16 history or partials on the fused AB chain in the HIGHEST mode
build the chain from the W=32 reduced-precision instances, as x3d2_tpu
builds them at terms=3. X3D2_CHUNK is accepted at any value: x3d2_tpu chains the steps
between outputs into one dispatch or not (cases/base.py:566), the same
steps either way, and the port's ``run`` dispatches per step.

On the card a case runs what x3d2_tpu runs: its kernels as the port's
kernels, its XLA parts (einsums, elementwise updates, boundary hooks) as
plain PyTorch, among them the per-species einsums of the scalars off the
species sweeps (past 8 scalars, the v1 and dense transport routes). Where
x3d2_tpu takes a kernel the port lacks (the slab's wall-bounded y and z
branches), the case raises NotImplementedError at construction. The CPU
runs every case, with plain versions and dense products.

The step consumes its state: like the JAX step's donated buffers, the
fused AB chain writes its outputs over the history's and the partials'
buffers, and apply_bc may write the fields of the time update in place.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Optional

import torch
from torch.utils._pytree import tree_leaves

from ..common import DataLoc, resolve_device
from ..diffsim import _kernels_active
from ..io.monitoring import Monitor
from ..mesh import Mesh
from ..ops.compact import matmul_terms
from ..ops.pressure_pipe import build_carry_mats, make_pressure_pipe_d2
from ..ops.transeq_sweep import (XDIV_MAX_N, make_fused_transeq_ab,
                                 make_fused_transeq_rk, make_transeq_sweep)
from ..solver import NavierStokes
from ..time_integrators import TimeIntegrator, kahan_add


@dataclass
class SolverParams:
    """Mirror of &solver_params (reference config.f90:33-44)."""

    Re: float = 1600.0
    time_intg: str = "AB3"
    dt: float = 1e-3
    n_iters: int = 1000
    n_output: int = 100
    poisson_solver_type: str = "FFT"
    der1st_scheme: str = "compact6"
    der2nd_scheme: str = "compact6"
    interpl_scheme: str = "classic"
    stagder_scheme: str = "compact6"
    n_species: int = 0
    pr_species: tuple = ()
    c_nu: float = 0.44
    nu0_nu: float = 4.0
    lowmem_transeq: bool = False  # accepted for config parity
    lowmem_fft: bool = False
    ibm_on: bool = False
    compensated: bool = False


class BaseCase:
    """Owns solver + integrator + step; concrete cases subclass."""

    name = "generic"

    def __init__(self, mesh: Mesh, params: SolverParams, dtype=torch.float32,
                 monitor_path: str | None = "monitoring.csv", verbose=True,
                 keep_pressure=True, device=None, seed: int = 0,
                 case_cfg=None, monitor_append=False):
        self.ti = TimeIntegrator(params.time_intg)
        self.device = resolve_device(device)
        self.seed = seed
        self.case_cfg = case_cfg
        self.mesh = mesh
        self.params = params
        self.dtype = dtype
        self.keep_pressure = keep_pressure
        schemes = dict(
            der1st_scheme=params.der1st_scheme,
            der2nd_scheme=params.der2nd_scheme,
            interpl_scheme=params.interpl_scheme,
            stagder_scheme=params.stagder_scheme,
            c_nu=params.c_nu, nu0_nu=params.nu0_nu,
        )
        pmethod = {"FFT": "matmul", "CG": "cg"}.get(
            params.poisson_solver_type.upper(), "matmul")
        nu = 1.0 / params.Re
        self.nsp = nsp = params.n_species
        if len(params.pr_species) < nsp:
            raise ValueError(f"{nsp} passive scalars need as many Prandtl "
                             f"numbers, got pr_species={params.pr_species}")
        self.solver = NavierStokes.build(
            mesh, nu, dtype=dtype, schemes=schemes, poisson_method=pmethod,
            device=self.device,
            nu_species=tuple(nu / pr for pr in params.pr_species[:nsp]))
        self.dt = params.dt
        # x3d2_tpu's reduced-precision gates (cases/base.py:104-129): an AB
        # scheme with history stores it in bfloat16 (every AB branch), and
        # the fused AB chain its cross-direction partials
        ab_hist = self.ti.kind == "AB" and self.ti.nolds >= 1
        self._olds_dtype = (torch.bfloat16 if ab_hist and os.environ.get(
            "X3D2_BF16_OLDS", "0") == "1" else None)
        self._acc_dtype = (torch.bfloat16 if ab_hist and os.environ.get(
            "X3D2_BF16_ACC", "0") == "1" else None)
        dims = mesh.dims(DataLoc.VERT)
        on_card = self.device.type == "cuda"
        if on_card and self.solver._projection_gap is not None:
            raise NotImplementedError(
                "the projection on the card: x3d2_tpu runs its slab kernels "
                f"on mesh {dims}; the port lacks "
                f"{self.solver._projection_gap}")
        if on_card and self.solver.transport_gap() is not None:
            raise NotImplementedError(
                f"transeq on the card: {self.solver.transport_gap()}")
        # the scalars off x3d2_tpu's species sweeps take its einsums, which
        # the port runs as plain PyTorch on either device
        if on_card and self.solver.species_gap() is not None:
            raise NotImplementedError(
                f"{nsp} passive scalars on mesh {dims} at {dtype}: "
                f"{self.solver.species_gap()}")
        # transport + AB update in one chain of three sweep kernels, under
        # x3d2_tpu's gate (cases/base.py:131-135: its v3 sweeps are there)
        self._fused_ab = None
        self._ab_is_xdiv = False
        slab = self.solver._slab
        # x3d2_tpu's kernel mode, read where its case builds the chains
        # (cases/base.py:137-139, :224-226)
        terms = matmul_terms()
        chain = dict(device=self.device, olds_dtype=self._olds_dtype,
                     acc_dtype=self._acc_dtype, terms=terms)
        if (os.environ.get("X3D2_FUSED_AB", "1") != "0"
                and self.ti.kind == "AB" and self.ti.nolds >= 1
                and not params.compensated
                and type(self).forcings is BaseCase.forcings
                and self.solver._sweeps is not None):
            # x3d2_tpu's gate (cases/base.py:141-147) is max(dims) <= 256,
            # which is also the most the xdiv kernel tiles along x
            # (XDIV_MAX_N), with the slab's parity x stage and no hook
            # between the AB update and the projection
            if (slab is not None and slab.x_perm is not None
                    and type(self).apply_bc is BaseCase.apply_bc
                    and type(self).body is BaseCase.body
                    and max(dims) <= XDIV_MAX_N
                    and os.environ.get("X3D2_XDIV_FUSED", "1") != "0"):
                # the final sweep also emits the projection's x-transformed
                # divergence inputs, in the block-parity basis of the slab
                # kernels (x3d2_tpu cases/base.py:141-167)
                d64 = self.solver._fp_mats64()
                try:
                    self._fused_ab = make_fused_transeq_ab(
                        self.solver.ops, self.solver.nu, dims,
                        self.ti.nolds, xdiv=(d64["sx"], d64["ix"]), **chain)
                    self._ab_is_xdiv = True
                except ValueError:
                    pass
            if self._fused_ab is None:
                try:
                    self._fused_ab = make_fused_transeq_ab(
                        self.solver.ops, self.solver.nu, dims,
                        self.ti.nolds, **chain)
                except ValueError:
                    # an operator band wider than the kernel's: the CPU
                    # steps unfused; the card has no kernel for it
                    if on_card:
                        raise
        # x3d2_tpu's d2-in-C carry gate (cases/base.py:182-211; the fused
        # AB chain implies no compensation): the pipeline with the carry,
        # the chain without its z sweep and the boot z sweep at the mode's
        # band; the step takes them with keep_pressure=False (:326-330,
        # :420-434)
        self._pipe_d2c = None
        if (os.environ.get("X3D2_D2C", "0") == "1"
                and self._fused_ab is not None and self._acc_dtype is None
                and not self._ab_is_xdiv and not nsp
                and type(self).define_bc is BaseCase.define_bc
                and type(self).apply_bc is BaseCase.apply_bc
                and type(self).body is BaseCase.body
                and self.solver._pipe is not None):
            try:
                self._pipe_d2c = make_pressure_pipe_d2(
                    self.solver._pipe.mats,
                    build_carry_mats(self.solver.ops[2], self.solver.nu,
                                     device=self.device))
                self._fused_ab_nod2 = make_fused_transeq_ab(
                    self.solver.ops, self.solver.nu, dims, self.ti.nolds,
                    skip_d2=True, **chain)
                self._d2_boot = make_transeq_sweep(
                    self.solver.ops[2], self.solver.nu, 2, dims,
                    device=self.device, terms=terms)
            except ValueError:
                self._pipe_d2c = None
        # transport + RK substage update in one chain per substage, under
        # x3d2_tpu's gate (cases/base.py:212-232); scalars ride the unfused
        # branch
        self._fused_rk = None
        if (self.ti.kind == "RK" and not nsp and not params.compensated
                and os.environ.get("X3D2_FUSED_RK", "1") != "0"
                and type(self).forcings is BaseCase.forcings
                and self.solver._sweeps is not None):
            try:
                self._fused_rk = make_fused_transeq_rk(
                    self.solver.ops, self.solver.nu, dims, self.ti.order,
                    device=self.device, terms=terms)
            except ValueError:
                if on_card:
                    raise
        self.monitor = Monitor(self.solver, path=monitor_path,
                               append=monitor_append, verbose=verbose)

    # ------------------------------------------------------------------
    # hooks (overridden by concrete cases)
    # ------------------------------------------------------------------
    def initial_conditions(self):
        """Return dict of initial fields {'u','v','w'[, 'phi']} (numpy or
        tensors; phi stacked (nsp, nx, ny, nz))."""
        raise NotImplementedError

    def define_bc(self, fields, rng, istep):
        """Per-substage pre-transeq hook (reference define_BC,
        base_case.f90:263): may modify the fields and returns (fields,
        bc_data), bc_data carrying what apply_bc consumes. rng: the
        state's torch.Generator."""
        return fields, None

    def forcings(self, rhs, fields, istep):
        """Modify the RHS tuple (base_case forcings hook); the fused chain
        runs only while it is the identity."""
        return rhs

    def apply_bc(self, fields, bc_data, gdt, istep):
        """Face-plane BC enforcement after the time update."""
        return fields

    def body(self, fields):
        """IBM or similar pre-projection modification (ibm.f90:148-170)."""
        return fields

    def postprocess(self, istep, t, state):
        self.monitor.write_step(t, state["u"], state["v"], state["w"])

    # ------------------------------------------------------------------
    def _tensor(self, a):
        return torch.as_tensor(a, dtype=self.dtype,
                               device=self.device).contiguous()

    def initial_state(self):
        fields = self.initial_conditions()
        u, v, w = (self._tensor(fields[k]) for k in ("u", "v", "w"))
        state = {
            "u": u, "v": v, "w": w,
            "p": torch.zeros(self.mesh.dims(DataLoc.CELL), dtype=self.dtype,
                             device=self.device),
            "istep": 1,
            "rng": torch.Generator(device=self.device).manual_seed(
                self.seed),
        }
        tmpl = (u, v, w)
        if self.nsp:
            state["phi"] = self._tensor(fields["phi"])
            tmpl = tmpl + (state["phi"],)
        # AB: per field its history (the stacked scalars' one 4th), at the
        # history's dtype; RK keeps none across steps (empty per field)
        state["olds"] = self.ti.empty_olds(tmpl, dtype=self._olds_dtype)
        if self.ti.kind == "AB" and self.params.compensated:
            # the Kahan compensation, one per field (x3d2_tpu
            # cases/base.py:323-325)
            state["comp"] = tuple(torch.zeros_like(f) for f in tmpl)
        if self._pipe_d2c is not None and not self.keep_pressure:
            # the d2-in-C carry: the z sweep's partials of the velocities
            # (derived from them; x3d2_tpu cases/base.py:326-330)
            state["rhsp"] = tuple(self._d2_boot(u, v, w))
        return state

    def _rhs(self, fields, istep):
        """transeq (+ the scalars' stacked RHS), then the forcings hook."""
        u, v, w = fields[:3]
        if self.nsp:
            mom, sp = self.solver.transeq_with_species(u, v, w, fields[3])
            rhs = mom + (sp,)
        else:
            rhs = self.solver.transeq(u, v, w)
        return self.forcings(rhs, fields, istep)

    def _substage_post(self, fields, bc_data, gdt, istep, divs=None,
                       comp=None):
        """apply_bc -> body (IBM) -> pressure_correction of the velocities,
        one substage's tail (x3d2_tpu cases/base.py:342-376); the scalars
        pass. `divs`: the xdiv sweep's x-transformed divergence inputs
        (only where apply_bc and body are the identity). With `comp` (the
        Kahan compensation of every field) the correction u - grad p is
        added through it, and the compensation is zeroed wherever a hook
        changed a point; returns (fields, p, comp)."""
        hooked = comp is not None and (
            type(self).apply_bc is not BaseCase.apply_bc
            or type(self).body is not BaseCase.body)
        # apply_bc may write in place: keep the values it may change
        pre = tuple(f.clone() for f in fields[:3]) if hooked else None
        fields = self.apply_bc(fields, bc_data, gdt, istep)
        fields = self.body(fields)
        if comp is None:
            u, v, w, p = self.solver.pressure_correction(
                *fields[:3], keep_pressure=self.keep_pressure, divs=divs)
            return (u, v, w) + tuple(fields[3:]), p, None
        if hooked:
            comp = tuple(torch.where(f == f0, c, torch.zeros_like(c))
                         for f, f0, c in zip(fields[:3], pre, comp[:3])) \
                + tuple(comp[3:])
        grads = self.solver.pressure_grads(*fields[:3],
                                           keep_pressure=self.keep_pressure)
        outs, newc = [], []
        for f, g, c in zip(fields[:3], grads[:3], comp[:3]):
            t, c2 = kahan_add(f, -g, c)
            outs.append(t)
            newc.append(c2)
        return (tuple(outs) + tuple(fields[3:]), grads[3],
                tuple(newc) + tuple(comp[3:]))

    def step(self, state):
        """One time step (all substages); returns the new state (the input
        state is consumed: the fused AB chain reuses its history
        buffers). Where grad mode is on and a tensor of the state requires
        grad, a step that runs no kernel records the autograd graph (the
        einsum paths are differentiable, as x3d2_tpu's step is under
        jax.grad), and a step that launches kernels raises: the kernels
        carry no backward, and their plain versions on the CPU are none
        (diffsim.differentiable_step pairs the kernel forward with the
        einsum twin's adjoint). Otherwise the step runs without a graph."""
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in tree_leaves(state)
                if isinstance(t, torch.Tensor)):
            if _kernels_active(self):
                raise RuntimeError(
                    f"{type(self).__name__}.step launches kernels, which "
                    "have no autograd rule, and a tensor of its state "
                    "requires grad: take the gradient through "
                    "x3d2_tpu_torch.diffsim.differentiable_step (the "
                    "kernel forward, the einsum twin's exact adjoint)")
            return self._step(state)
        with torch.no_grad():
            return self._step(state)

    def _step(self, state):
        """The body of step, which runs it with or without a graph."""
        fields = (state["u"], state["v"], state["w"])
        if self.nsp:
            fields = fields + (state["phi"],)
        istep = int(state["istep"])
        dt = self.dt
        olds = state["olds"]
        rng = state["rng"]
        comp = state.get("comp")
        if self.ti.kind == "AB" and self._fused_ab is None:
            fields, bc_data = self.define_bc(fields, rng, istep)
            rhs = self._rhs(fields, istep)
            if comp is not None:
                fields, olds, comp = self.ti.ab_step_compensated(
                    fields, olds, comp, istep, rhs, dt)
            else:
                fields, olds = self.ti.ab_step(fields, olds, istep, rhs, dt)
            fields, p, comp = self._substage_post(
                fields, bc_data, self.ti.gdt(dt, 0), istep, comp=comp)
        elif self.ti.kind == "AB":
            fields, bc_data = self.define_bc(fields, rng, istep)
            # the AB row is picked on the host: no per-step device sync;
            # with a bfloat16 history its 5th entry is the error feedback
            dtc = self.ti.ab_row(istep, dt, self.dtype,
                                 feedback=self._olds_dtype is not None)
            if "rhsp" in state:
                # the d2-in-C carry (x3d2_tpu cases/base.py:420-434): the
                # chain starts at the x sweep from the carried z partials,
                # and the projection returns the next ones; the hooks are
                # the identity by the gate, and p is carried
                mom, rhs = self._fused_ab_nod2(*fields, olds, dtc,
                                               state["rhsp"])
                (un, vn, wn), rhsp = self._pipe_d2c(*mom)
                return {"u": un, "v": vn, "w": wn, "p": state["p"],
                        "istep": istep + 1, "rng": rng, "rhsp": rhsp,
                        "olds": tuple((r,) + tuple(o[:-1])
                                      for r, o in zip(rhs, olds))}
            prhs = None
            if self.nsp:
                # the scalars' RHS on the velocities before the update (the
                # time level the momentum RHS uses inside the chain, whose
                # u' then goes over the oldest history)
                prhs = self.solver.transeq_species_all(fields[3],
                                                       *fields[:3])
            out = self._fused_ab(*fields[:3], olds[:3], dtc)
            divs = None
            if len(out) == 3:   # the xdiv chain
                mom, rhs, divs = out
            else:
                mom, rhs = out
            new_olds = tuple((r,) + tuple(o[:-1])
                             for r, o in zip(rhs, olds[:3]))
            if self.nsp:
                # the phi AB update elementwise, with the reduced history's
                # error feedback (x3d2_tpu cases/base.py:451-465): ab_step
                # on the row the chain took
                (phi,), (phi_olds,) = self.ti.ab_step(
                    (fields[3],), (olds[3],), istep, (prhs,), dt)
                mom = mom + (phi,)
                new_olds = new_olds + (phi_olds,)
            olds = new_olds
            fields, p, _ = self._substage_post(mom, bc_data,
                                               self.ti.gdt(dt, 0), istep,
                                               divs=divs)
        elif self._fused_rk is not None:
            ks = []
            for istage, stage in enumerate(self._fused_rk):
                fields, bc_data = self.define_bc(fields, rng, istep)
                if istage == 0:
                    # the step-initial fields, after define_bc (x3d2_tpu
                    # cases/base.py:476-478)
                    fields0 = fields
                dtc = self.ti.rk_row(istage, dt, self.dtype)
                mom, rhs = stage(*fields, fields0, ks, dtc)
                ks.append(rhs)
                fields, p, _ = self._substage_post(
                    mom, bc_data, self.ti.gdt(dt, istage), istep)
        else:
            ks = []
            for istage in range(self.ti.nstage):
                fields, bc_data = self.define_bc(fields, rng, istep)
                if istage == 0:
                    fields0 = fields
                ks.append(self._rhs(fields, istep))
                fields = self.ti.rk_substage(fields0, ks, istage, dt)
                fields, p, _ = self._substage_post(
                    fields, bc_data, self.ti.gdt(dt, istage), istep)
        if p is None:
            # no pressure was formed (keep_pressure=False): carry the
            # previous (diagnostic-only) one, as x3d2_tpu does
            p = state["p"]
        new = {"u": fields[0], "v": fields[1], "w": fields[2], "p": p,
               "istep": istep + 1, "olds": olds, "rng": rng}
        if self.nsp:
            new["phi"] = fields[3]
        if comp is not None:
            new["comp"] = comp
        return new

    def _chunk(self, state, k):
        """k steps as a plain loop."""
        for _ in range(k):
            state = self.step(state)
        return state

    # ------------------------------------------------------------------
    @torch.no_grad()
    def run(self, n_iters: Optional[int] = None, state=None,
            n_output: Optional[int] = None, io_manager=None,
            fresh: Optional[bool] = None):
        """Time loop (reference base_case run, base_case.f90:181-353;
        x3d2_tpu cases/base.py:527-606): step -> stats accumulation ->
        monitoring every n_output iterations (with the wall clock of the
        reported steps) -> checkpoint and snapshot (io_manager, an
        io.IOManager), and the manager's finalise at the end. `fresh` marks
        a new initial condition (write the t=0 monitoring row) rather than
        a checkpoint restore; default: a state built here is fresh, a
        caller's is fresh at istep 1. IO reads the state between steps:
        its host copies are made, and the statistics' device updates
        enqueued, before the next step (which may write over the state's
        buffers) starts."""
        n_iters = n_iters or self.params.n_iters
        n_output = n_output or self.params.n_output
        if state is None:
            state = self.initial_state()
            if fresh is None:
                fresh = True
        if fresh is None:
            fresh = int(state["istep"]) == 1
        if "rhsp" in state:
            # the carried z partials are derived from u, v, w: made anew
            # whenever a state enters the loop, a restored one too
            # (x3d2_tpu cases/base.py:545-552)
            state = dict(state, rhsp=tuple(self._d2_boot(
                state["u"], state["v"], state["w"])))
        if fresh and int(state["istep"]) == 1:
            self.postprocess(0, 0.0, state)
        t0 = time.perf_counter()
        t_rep = t0
        start = int(state["istep"])
        for it in range(start, start + n_iters):
            state = self.step(state)
            t = it * self.dt
            if io_manager is not None:
                io_manager.update_stats(state, it)
            if it % n_output == 0:
                self.postprocess(it, t, state)
                if self.monitor.verbose:
                    # per-reported-step wall clock (base_case.f90:244-266)
                    self._sync()
                    now = time.perf_counter()
                    print(f"Time for this time step: "
                          f"{(now - t_rep) / n_output * 1e3:.2f} ms "
                          f"(iteration {it})")
                    t_rep = now
            if io_manager is not None:
                io_manager.handle_io_step(state, it, t)
        self._sync()
        elapsed = time.perf_counter() - t0
        if io_manager is not None:
            last = start + n_iters - 1
            io_manager.finalise(state, last, last * self.dt)
        if self.monitor.verbose:
            print(f"Total time {elapsed:.3f}s for {n_iters} iters "
                  f"({elapsed / n_iters * 1e3:.2f} ms/step)")
        return state

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
