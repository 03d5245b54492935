"""Krylov solvers on torch tensors: preconditioned CG as init + resume.

The torch counterpart of ``cutfemx_tpu.la.cg_init`` / ``cg_resume`` / ``cg``.
``lax.while_loop`` becomes a Python loop that reads the stopping test on
the host every iteration; the stopping rule, including the ``rz > 0``
breakdown guard, is the reference's exactly, so iteration counts compare.
"""

from __future__ import annotations

import torch

__all__ = ["cg_init", "cg_resume", "cg"]


def cg_init(operator, b, x0=None, M=None):
    """Initial PCG state (x, r, p, rz, it) and squared rhs norm."""
    x = torch.zeros_like(b) if x0 is None else x0
    if M is None:
        def M(r):
            return r
    r = b - operator(x)
    z = M(r)
    rz = torch.dot(r, z)
    return (x, r, z, rz, 0), torch.dot(b, b)


def cg_resume(operator, state, M, tol2, it_cap):
    """Continue PCG from ``state`` until ||r||^2 <= tol2 or it >= it_cap.
    tol2 may be a 0-d tensor or a float; it_cap an int."""
    if M is None:
        def M(r):
            return r
    x, r, p, rz, it = state
    while True:
        # rz > 0 is a finite-precision breakdown guard: in exact
        # arithmetic (r, M^-1 r) stays positive, and once it is not, the
        # recurrence can only produce garbage (NaN x within a few steps)
        go = (torch.dot(r, r) > tol2) & (rz > 0)
        if it >= it_cap or not bool(go):
            break
        Ap = operator(p)
        alpha = rz / torch.dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = torch.dot(r, z)
        beta = rz_new / rz
        p = z + beta * p
        rz = rz_new
        it += 1
    return (x, r, p, rz, it)


def cg(operator, b, x0=None, M=None, rtol=1e-10, atol=0.0, maxiter=1000):
    """Preconditioned conjugate gradients.

    operator: callable x -> A@x (linear, SPD). M: callable r -> M^{-1} r.
    Returns (x, iterations, residual_norm)."""
    state, bb = cg_init(operator, b, x0=x0, M=M)
    tol2 = torch.clamp(rtol * torch.sqrt(bb), min=atol) ** 2
    x, r, p, rz, it = cg_resume(operator, state, M, tol2, maxiter)
    return x, it, torch.linalg.norm(r)
