"""Explicit time integrators: Adams-Bashforth 1-4 and Runge-Kutta 1-4.

Counterpart of x3d2_tpu.time_integrators (reference
src/time_integrator.f90, coefficients :83-118). The AB derivative history
is a per-field tuple of separate tensors, newest first, so its rotation is
a tuple reshuffle. ``istep`` is a Python int: the startup coefficient row
is picked on the host, so no per-step device sync is needed.

Two modes of the AB step, as in x3d2_tpu (time_integrators.py:22-31,
:88-129, :155-164): a history stored at a reduced precision (bfloat16,
X3D2_BF16_OLDS) with the error feedback that pre-pays the stored rhs's
rounding, and Kahan-compensated state accumulation (``compensated``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def kahan_add(x, inc, c):
    """One compensated accumulation step (x3d2_tpu time_integrators.py:
    22-31): (x + inc, c'), c' the rounding error of the addition. PyTorch
    evaluates each operation as written, so the cancellation survives."""
    y = inc - c
    t = x + y
    c_new = (t - x) - y
    return t, c_new


# AB coefficients (time_integrator.f90:108-118); row k = AB(k+1)
AB_COEFFS = np.array([
    [1.0, 0.0, 0.0, 0.0],
    [1.5, -0.5, 0.0, 0.0],
    [23.0 / 12, -4.0 / 3, 5.0 / 12, 0.0],
    [55.0 / 24, -59.0 / 24, 37.0 / 24, -3.0 / 8],
])

# RK stage tables (time_integrator.f90:83-106); rk_a[order][stage][j]
RK_A = {
    1: np.zeros((0, 3)),
    2: np.array([[0.5, 0.0, 0.0]]),
    3: np.array([[0.5, 0.0, 0.0],
                 [0.0, 0.75, 0.0]]),
    4: np.array([[0.5, 0.0, 0.0],
                 [0.0, 0.5, 0.0],
                 [0.0, 0.0, 1.0]]),
}
RK_B = {
    1: np.array([1.0]),
    2: np.array([0.0, 1.0]),
    3: np.array([2.0 / 9, 1.0 / 3, 4.0 / 9]),
    4: np.array([1.0 / 6, 1.0 / 3, 1.0 / 3, 1.0 / 6]),
}


@dataclass(frozen=True)
class TimeIntegrator:
    """Scheme descriptor parsed from names like 'AB3' / 'RK3'."""

    name: str

    def __post_init__(self):
        kind, order = self.name[:2].upper(), int(self.name[2])
        if kind not in ("AB", "RK") or not 1 <= order <= 4:
            raise ValueError(f"unsupported time integrator {self.name!r}")
        object.__setattr__(self, "kind", kind)
        object.__setattr__(self, "order", order)

    @property
    def nstage(self) -> int:
        return self.order if self.kind == "RK" else 1

    @property
    def nolds(self) -> int:
        # AB(k) carries k-1 old derivatives; RK carries none across steps
        return self.order - 1 if self.kind == "AB" else 0

    def gdt(self, dt: float, istage: int) -> float:
        """Effective sub-timestep for BC ramping (time_integrator.f90:166-182)."""
        if self.kind == "AB":
            return dt
        return float(RK_B[self.order][istage]) * dt

    def future_coeff_sum(self) -> float:
        """Sum of the steady-state AB coefficients that will multiply a
        derivative stored this step in future updates (c_1..c_{order-1})."""
        return float(AB_COEFFS[self.order - 1][1:self.order].sum())

    def ab_row(self, istep: int, dt: float, dtype=torch.float32,
               feedback: bool = False) -> list:
        """The dt-scaled coefficient row dt*AB_COEFFS[min(istep, order)-1]
        (the startup rows for istep < order) as host floats. The table is
        rounded to `dtype` and multiplied by dt there, as x3d2_tpu does.
        feedback: a 5th entry, the reduced history's error-feedback
        coefficient dt * future_coeff_sum() rounded to `dtype` (x3d2_tpu
        cases/base.py:412-420, "col 4")."""
        npd = np.float64 if dtype == torch.float64 else np.float32
        row = AB_COEFFS.astype(npd)[min(int(istep), self.order) - 1]
        out = [float(npd(dt) * c) for c in row]
        if feedback:
            out.append(self._feedback(dt, dtype))
        return out

    def _feedback(self, dt, dtype) -> float:
        """dt * future_coeff_sum() rounded to `dtype`: the coefficient of
        the reduced history's error feedback."""
        npd = np.float64 if dtype == torch.float64 else np.float32
        return float(npd(dt * self.future_coeff_sum()))

    def _with_history(self, acc, f, r, o, co, dt):
        """acc + sum_j co_{j+1} o_j (a reduced history widened to f's dtype
        before its multiply), plus, where the history is stored reduced,
        the error feedback dt*future_coeff_sum*(r - round(r)) that pre-pays
        the stored rhs's rounding while r is exact (x3d2_tpu
        time_integrators.py:102-118, :155-165)."""
        for j in range(self.order - 1):
            acc = acc + co[j + 1] * o[j].to(f.dtype)
        if o and o[0].dtype != f.dtype:
            rb = r.to(o[0].dtype).to(f.dtype)
            acc = acc + self._feedback(dt, f.dtype) * (r - rb)
        return acc

    def _rotate(self, rhs, olds):
        """The new history: each rhs at its history's storage dtype in
        front, the oldest dropped."""
        if self.nolds == 0:
            return olds
        return tuple((r.to(o[0].dtype),) + tuple(o[:-1])
                     for r, o in zip(rhs, olds))

    def ab_step(self, fields, olds, istep, rhs, dt):
        """One AB step. `fields`/`rhs` are tuples of tensors; `olds` is a
        matching tuple whose entries are (nolds,)-tuples of tensors (the
        derivative history, newest first, at the state's dtype or
        bfloat16); istep is a 1-based int. Returns (new_fields,
        new_olds)."""
        co = self.ab_row(istep, dt, fields[0].dtype)
        new_fields = tuple(self._with_history(f + co[0] * r, f, r, o, co, dt)
                           for f, r, o in zip(fields, rhs, olds))
        return new_fields, self._rotate(rhs, olds)

    def ab_step_compensated(self, fields, olds, comp, istep, rhs, dt):
        """AB step with Kahan-compensated state accumulation (x3d2_tpu
        time_integrators.py:88-129): the increment is formed first, then
        added through the running compensation `comp` (one tensor per
        field), which carries the low-order bits each state addition
        drops. Returns (new_fields, new_olds, new_comp)."""
        co = self.ab_row(istep, dt, fields[0].dtype)
        pairs = [kahan_add(f, self._with_history(co[0] * r, f, r, o, co, dt),
                           c)
                 for f, r, o, c in zip(fields, rhs, olds, comp)]
        return (tuple(p[0] for p in pairs), self._rotate(rhs, olds),
                tuple(p[1] for p in pairs))

    def _rk_tab(self, istage: int):
        """The tableau row of RK substage istage's update."""
        order = self.order
        return RK_B[order] if istage == order - 1 else RK_A[order][istage]

    def rk_prev(self, istage: int) -> list:
        """The earlier stages whose derivatives the update of substage
        istage reads: those with a nonzero coefficient in its row (x3d2_tpu
        make_fused_transeq_rk, pallas_kernels.py:973-976). The fused chain
        needs the fresh derivative's coefficient to be nonzero."""
        tab = self._rk_tab(istage)
        if tab[istage] == 0.0:
            raise ValueError("fused RK needs a nonzero fresh coefficient")
        return [j for j in range(istage) if tab[j] != 0.0]

    def rk_row(self, istage: int, dt: float, dtype=torch.float32) -> list:
        """The dt-scaled row [fresh, rk_prev...] of substage istage's fused
        update as host floats, each dt * c in float64 rounded to `dtype`,
        as x3d2_tpu builds it (cases/base.py:483-488)."""
        tab = self._rk_tab(istage)
        npd = np.float64 if dtype == torch.float64 else np.float32
        return [float(npd(dt * float(tab[j])))
                for j in [istage] + self.rk_prev(istage)]

    def rk_substage(self, fields0, ks, istage, dt):
        """Stage update for RK: given the step-initial fields and the list
        of stage derivatives computed so far (each a tuple like fields0),
        produce the fields for the next stage evaluation (istage < nstage)
        or the final step result (istage == nstage-1). Mirrors
        time_integrator.f90:166-231 (x3d2_tpu time_integrators.py:176-192)."""
        tab = self._rk_tab(istage)

        def upd(i):
            acc = fields0[i]
            for c, k in zip(tab, ks):
                if c != 0.0:
                    acc = acc + dt * float(c) * k[i]
            return acc

        return tuple(upd(i) for i in range(len(fields0)))

    def empty_olds(self, template, dtype=None):
        """Zero-initialised history: per field, a (nolds,)-tuple of
        separate tensors (so rotation is a reshuffle, never a copy).
        `dtype` overrides the storage precision (bfloat16 under
        X3D2_BF16_OLDS)."""
        return tuple(tuple(torch.zeros_like(f, dtype=dtype)
                           for _ in range(self.nolds)) for f in template)
