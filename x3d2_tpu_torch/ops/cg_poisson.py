"""Iterative (right-preconditioned BiCGStab) pressure Poisson solver.

Counterpart of x3d2_tpu.ops.cg_poisson. The reference declares a 'CG'
poisson_solver_type but ships a stub that zeroes the pressure
(solver.f90:680-691 poisson_cg); this is a matrix-free Krylov solve on the
composite operator A = divergence_v2p(gradient_p2v(.)), the discrete
operator the projection needs, for any boundary conditions and
stretching. The spectral matmul solve (the uniform-metric inverse) is the
right preconditioner: on a uniform mesh the iteration converges at once,
on a stretched one at a rate set by the metric's contrast. BiCGStab, not
CG: the compact-scheme div/grad composition is not symmetric.

A is singular (constant null space); the iterates are kept mean-free.
x3d2_tpu runs the iteration as a lax.while_loop inside its step; here it
is a host loop of plain PyTorch operations, and its condition (the
residual against the tolerance, and the iteration count) reads one scalar
to the host each iteration, as the while loop's condition decides on the
device. ``iterations`` holds the count of the last solve.
"""

from __future__ import annotations

import torch

# x3d2_tpu's guard on the recurrences' denominators; it rounds to 0 in
# float32 (in both packages), so there it guards nothing
_EPS = 1e-300


class CGPoisson:
    def __init__(self, apply_A, precond=None, tol=1e-8, max_iters=100):
        """apply_A: p -> div(grad(p)); precond: r -> approx A^-1 r."""
        self.apply_A = apply_A
        self.precond = precond if precond is not None else (lambda r: r)
        self.tol = tol
        self.max_iters = max_iters
        self.iterations = None

    def __call__(self, f: torch.Tensor) -> torch.Tensor:
        """Right-preconditioned BiCGStab, stopping where the residual's
        squared norm is at most tol^2 |f|^2 + 1e-300, or after max_iters
        iterations (x3d2_tpu cg_poisson.py:44-47)."""
        def demean(x):
            return x - x.mean()

        def A(p):
            return demean(self.apply_A(demean(self.precond(p))))

        f = demean(f)
        tol = torch.tensor(self.tol, dtype=f.dtype, device=f.device)
        tol2 = tol ** 2 * (f * f).sum() + 1e-300
        x = torch.zeros_like(f)
        r = f
        rhat = r
        p = torch.zeros_like(f)
        v = torch.zeros_like(f)
        one = torch.ones((), dtype=f.dtype, device=f.device)
        rho = alpha = omega = one
        it = 0
        while it < self.max_iters and bool((r * r).sum() > tol2):
            rho_new = (rhat * r).sum()
            beta = (rho_new / (rho + _EPS)) * (alpha / (omega + _EPS))
            p = r + beta * (p - omega * v)
            v = A(p)
            alpha = rho_new / ((rhat * v).sum() + _EPS)
            s = r - alpha * v
            t = A(s)
            omega = (t * s).sum() / ((t * t).sum() + _EPS)
            x = x + alpha * p + omega * s
            r = s - omega * t
            rho = rho_new
            it += 1
        self.iterations = it
        # un-precondition the solution (right preconditioning: y = M x)
        return demean(self.precond(demean(x)))
