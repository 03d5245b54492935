"""Linear algebra: the host CSR matrix, a host direct solve, and Krylov
solvers and preconditioners on torch tensors.

The torch counterpart of ``cutfemx_tpu.la``. ``MatrixCSR`` and
``direct_solve`` are host code (SciPy) by the reference's design: the
oracle and direct-solve path. The device path is the matrix-free
``fem.CutOperator`` driving the CG below. ``lax.while_loop`` becomes a
Python loop that reads the stopping test on the host every iteration; the
stopping rule, including the ``rz > 0`` breakdown guard, is the
reference's exactly, so iteration counts compare.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["MatrixCSR", "direct_solve", "cg_init", "cg_resume", "cg",
           "bicgstab", "power_iteration_lmax", "chebyshev_preconditioner"]


class MatrixCSR:
    """Host CSR matrix (SciPy) with the subset of the DOLFINx
    la.MatrixCSR API the demos use (to_scipy, to_dense,
    scatter_reverse)."""

    def __init__(self, sp_matrix):
        import scipy.sparse as sps
        self._m = sps.csr_matrix(sp_matrix)

    @classmethod
    def from_coo(cls, rows, cols, vals, shape):
        """Duplicates are summed."""
        import scipy.sparse as sps
        m = sps.coo_matrix((np.asarray(vals), (np.asarray(rows),
                                               np.asarray(cols))),
                           shape=shape).tocsr()
        return cls(m)

    @property
    def shape(self):
        return self._m.shape

    def to_scipy(self):
        return self._m

    def to_dense(self):
        return self._m.toarray()

    def scatter_reverse(self):
        """Ghost accumulation: a no-op in one process."""

    def matvec(self, x):
        """A @ x for a host vector (numpy or a CPU tensor)."""
        return self._m @ np.asarray(x)

    def diagonal(self):
        return self._m.diagonal()

    def zero_rows(self, rows, diag=1.0):
        """Zero the given rows and set ``diag`` on their diagonal."""
        import scipy.sparse as sps
        rows = np.asarray(rows, dtype=np.int64)
        if rows.size == 0:
            return
        m = self._m.tocsr()
        # zero the stored entries of the selected rows on the CSR data (a
        # lil fancy assignment would materialize a dense block)
        sel = np.zeros(m.shape[0], dtype=bool)
        sel[rows] = True
        row_ids = np.repeat(np.arange(m.shape[0]), np.diff(m.indptr))
        m.data[sel[row_ids]] = 0.0
        m.eliminate_zeros()
        if diag != 0.0:
            if m.shape[0] != m.shape[1]:
                raise ValueError(
                    "cannot set a diagonal on a non-square block")
            # in the matrix's dtype: an f32 matrix stays f32 (SciPy's sum
            # with an f64 diagonal would promote it)
            d = sps.coo_matrix((np.full(len(rows), diag, dtype=m.dtype),
                                (rows, rows)), shape=m.shape)
            m = (m + d).tocsr()
        self._m = m


def direct_solve(A, b):
    """Sparse direct solve on the host (SciPy ``spsolve``), by the
    reference's design: it is the serial direct path of its demos, not a
    fallback of a device solver. ``A`` is a MatrixCSR or a SciPy matrix;
    ``b`` a numpy array or a tensor on any device, copied to the host
    explicitly. The solution comes back as ``b`` came: numpy, or a tensor
    of ``b``'s dtype on ``b``'s device."""
    from scipy.sparse.linalg import spsolve
    m = A.to_scipy() if isinstance(A, MatrixCSR) else A
    if isinstance(b, torch.Tensor):
        x = spsolve(m.tocsr(), b.detach().cpu().numpy())
        return torch.as_tensor(x, dtype=b.dtype, device=b.device)
    return spsolve(m.tocsr(), np.asarray(b))


def _rdot(a, b):
    """Re(a^H b): the inner product of real and complex vectors (on real
    tensors ``torch.vdot`` is ``torch.dot``, the same kernel)."""
    return torch.vdot(a, b).real


def cg_init(operator, b, x0=None, M=None):
    """Initial PCG state (x, r, p, rz, it) and squared rhs norm."""
    x = torch.zeros_like(b) if x0 is None else x0
    if M is None:
        def M(r):
            return r
    r = b - operator(x)
    z = M(r)
    rz = _rdot(r, z)
    return (x, r, z, rz, 0), _rdot(b, b)


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
        go = (_rdot(r, r) > tol2) & (rz > 0)
        if it >= it_cap or not bool(go):
            break
        Ap = operator(p)
        alpha = rz / _rdot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = _rdot(r, z)
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


def bicgstab(operator, b, x0=None, M=None, rtol=1e-10, maxiter=1000):
    """BiCGStab for nonsymmetric operators: the reference's recurrence and
    stopping test (||r||^2 <= (rtol ||b||)^2, read on the host before every
    iteration). M: callable r -> M^{-1} r. Returns (x, iterations,
    residual_norm)."""
    x = torch.zeros_like(b) if x0 is None else x0
    if M is None:
        def M(r):
            return r
    r = b - operator(x)
    rhat = r
    rho = alpha = omega = torch.ones((), dtype=b.dtype, device=b.device)
    v = p = torch.zeros_like(b)
    tol2 = (rtol * torch.linalg.norm(b)) ** 2
    it = 0
    while it < maxiter and bool(_rdot(r, r) > tol2):
        rho_new = torch.vdot(rhat, r)
        beta = (rho_new / rho) * (alpha / omega)
        p = r + beta * (p - omega * v)
        phat = M(p)
        v = operator(phat)
        alpha = rho_new / torch.vdot(rhat, v)
        s = r - alpha * v
        shat = M(s)
        t = operator(shat)
        omega = torch.vdot(t, s) / torch.vdot(t, t)
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        rho = rho_new
        it += 1
    return x, it, torch.linalg.norm(r)


def power_iteration_lmax(operator, d, n, iters=15):
    """Estimate the largest eigenvalue of D^{-1/2} A D^{-1/2} by power
    iteration (the Chebyshev interval's upper end)."""
    x = torch.sin(torch.arange(n, dtype=d.dtype, device=d.device) + 1.0)
    dinv_sqrt = 1.0 / torch.sqrt(torch.clamp(d, min=1e-30))
    x = x / torch.linalg.norm(x)
    for _ in range(iters):
        y = dinv_sqrt * operator(dinv_sqrt * x)
        x = y / torch.linalg.norm(y)
    y = dinv_sqrt * operator(dinv_sqrt * x)
    return _rdot(x, y)


def chebyshev_preconditioner(operator, d, lmax, degree=4, lmin_frac=0.06):
    """Chebyshev polynomial of the Jacobi-scaled operator targeting
    [lmin_frac*lmax, 1.1*lmax]. As a standalone CG preconditioner it
    cannot beat CG's own optimal polynomial; it is the high-mode smoother
    of a multigrid hierarchy."""
    lo = lmin_frac * lmax
    hi = 1.1 * lmax
    theta = 0.5 * (hi + lo)
    delta = 0.5 * (hi - lo)
    dinv = 1.0 / torch.clamp(d, min=1e-30)

    def M(r):
        # the standard Chebyshev iteration for A z = r from z0 = 0
        z = torch.zeros_like(r)
        p = torch.zeros_like(r)
        alpha = None
        for k in range(degree):
            resid = dinv * (r - operator(z))
            if k == 0:
                p = resid
                alpha = 1.0 / theta
            elif k == 1:
                beta = 0.5 * (delta * alpha) ** 2
                alpha = 1.0 / (theta - beta / alpha)
                p = resid + beta * p
            else:
                beta = (delta * alpha / 2.0) ** 2
                alpha = 1.0 / (theta - beta / alpha)
                p = resid + beta * p
            z = z + alpha * p
        return z

    return M
