"""Geometric-Galerkin multigrid preconditioning for cut problems.

The torch counterpart of ``cutfemx_tpu.mg``. CG with plain Jacobi needs
O(h^-1) iterations; a V-cycle preconditioner makes the count
mesh-independent. Design (the reference's):

- transfers exploit the structured background lattice of create_box /
  create_rectangle meshes: every fine vertex value is a 2^|S|-corner
  average of its enclosing coarse sub-cube (|S| = axes with half-offset;
  for Freudenthal tet meshes the min->max diagonal convention makes this
  exactly P1 interpolation), and P2 -> P1 on the same mesh is
  vertex-identity + edge-midpoint averages;
- coarse operators are Galerkin products R A P built on the host in SciPy
  (inactive fine rows keep their identity, so deactivation is respected);
- each level applies its CSR operator on the device as a sorted segment
  sum of ``data * x[cols]`` over the rows (no atomics: two applies of one
  input agree bitwise);
- Chebyshev smoothing, a dense inverse on the coarsest level; the V-cycle
  is symmetric, so CG may take it as its preconditioner.

The V-cycle runs as plain torch ops on the space's device (XLA code in
the reference, no Pallas kernel).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .fem import segment_sum_sorted

__all__ = ["structured_lattice_info", "MGPreconditioner", "mg_solve_cg"]

MAX_RESTARTS = 10


def structured_lattice_info(mesh):
    """Detect a structured lattice: returns (lo, n_axes, h_axes) when every
    vertex sits on lo + (i,j,k)*h for integer lattice sizes, else None."""
    v = mesh.vertices
    lo = v.min(axis=0)
    hi = v.max(axis=0)
    out_n = []
    for ax in range(v.shape[1]):
        vals = np.unique(np.round((v[:, ax] - lo[ax]) * 1e12) / 1e12)
        n = len(vals) - 1
        if n < 1:
            return None
        h = (hi[ax] - lo[ax]) / n
        if not np.allclose(vals, lo[ax] * 0 + np.arange(n + 1) * h,
                           atol=1e-9 * max(abs(hi[ax] - lo[ax]), 1)):
            return None
        out_n.append(n)
    if len(v) != np.prod([n + 1 for n in out_n]):
        return None
    h_axes = (hi - lo) / np.asarray(out_n)
    return lo, np.asarray(out_n, np.int64), h_axes


def _lattice_index(mesh, lo, h_axes):
    """(NV, gdim) integer lattice coords of the mesh vertices."""
    return np.round((mesh.vertices - lo) / h_axes).astype(np.int64)


def _vertex_id_map(n_axes):
    """Map lattice coords -> vertex id for create_rectangle/create_box
    ordering (last axis fastest: vid = ((i)*(ny+1)+j)*(nz+1)+k)."""
    def vid(idx):
        out = idx[:, 0]
        for ax in range(1, idx.shape[1]):
            out = out * (n_axes[ax] + 1) + idx[:, ax]
        return out
    return vid


def p1_grid_transfer(mesh_f, mesh_c):
    """Prolongation from coarse-lattice P1 vertices to fine vertices:
    (idx (NVf, K), w (NVf, K)) gather-weights (K = 2^gdim padded)."""
    inf_f = structured_lattice_info(mesh_f)
    inf_c = structured_lattice_info(mesh_c)
    if inf_f is None or inf_c is None:
        raise ValueError("meshes are not structured lattices")
    lo, nf, hf = inf_f
    _, nc, _ = inf_c
    if not np.allclose(nf, 2 * nc):
        raise ValueError("fine lattice must be the coarse refined by 2")
    gdim = mesh_f.gdim
    idx_f = _lattice_index(mesh_f, lo, hf)
    base = idx_f // 2
    frac = idx_f - 2 * base                     # 0 or 1 per axis
    vid_c = _vertex_id_map(nc)
    K = 2 ** gdim
    NV = len(idx_f)
    idx = np.zeros((NV, K), np.int64)
    w = np.zeros((NV, K))
    if mesh_f.cell_type in ("triangle", "tetrahedron", "interval"):
        # Freudenthal/right-diagonal: value at a half-offset point is the
        # average of the min and max corners of its sub-simplex diagonal
        hi_corner = base + frac
        idx[:, 0] = vid_c(np.clip(base, 0, None))
        idx[:, 1] = vid_c(np.clip(hi_corner, None, nc))
        on_corner = (frac == 0).all(axis=1)
        w[:, 0] = np.where(on_corner, 1.0, 0.5)
        w[:, 1] = np.where(on_corner, 0.0, 0.5)
    else:
        # multilinear cells: 2^|S| corner average
        for k in range(K):
            offs = np.array([(k >> a) & 1 for a in range(gdim)])
            corner = base + frac * offs[None, :]
            idx[:, k] = vid_c(np.clip(corner, None, nc))
        nS = frac.sum(axis=1)
        for k in range(K):
            offs = np.array([(k >> a) & 1 for a in range(gdim)])
            active = ((frac * (1 - offs[None, :])) == frac).all(axis=1)
            w[:, k] = np.where(active, 1.0 / (2.0 ** nS), 0.0)
        # normalize duplicated corners
        w /= np.maximum(w.sum(axis=1, keepdims=True), 1e-300)
    return idx, w


def _check_p2_dof_order(V2):
    """The transfer below reads P2 dofs as vertices first, then one dof
    per edge in ``mesh.edges`` order; raise if V2's dofmap is otherwise."""
    mesh, el = V2.mesh, V2.element
    if V2.family != "Lagrange" or V2.degree != 2:
        raise ValueError("p2_to_p1_transfer expects a P2 Lagrange space")
    nv = mesh.num_vertices
    for (edim, eidx), dofs in el.entity_dofs.items():
        if edim == 0:
            want = mesh.cells[:, eidx]
        elif edim == 1:
            want = nv + mesh.cell_edges[:, eidx]
        else:
            raise ValueError("P2 space with dofs on faces or cells")
        if not np.array_equal(V2.dofmap[:, dofs[0]], want):
            raise ValueError("P2 dofs are not numbered vertices first, "
                             "then edges in mesh.edges order")


def p2_to_p1_transfer(V2, V1):
    """Prolongation P1 -> P2 on the same mesh: vertex identity + edge
    midpoint averages. Returns (idx (nd2, 2), w (nd2, 2))."""
    _check_p2_dof_order(V2)
    mesh = V2.mesh
    nd2 = V2.num_scalar_dofs
    idx = np.zeros((nd2, 2), np.int64)
    w = np.zeros((nd2, 2))
    nv = mesh.num_vertices
    idx[:nv, 0] = np.arange(nv)
    w[:nv, 0] = 1.0
    edges = mesh.edges
    idx[nv:nv + len(edges), 0] = edges[:, 0]
    idx[nv:nv + len(edges), 1] = edges[:, 1]
    w[nv:nv + len(edges)] = 0.5
    if nd2 != nv + len(edges):
        raise ValueError("p2_to_p1_transfer expects a scalar P2 space")
    return idx, w


def _prolong_matrix(idx, w, ncols):
    import scipy.sparse as sps
    n = idx.shape[0]
    rows = np.repeat(np.arange(n), idx.shape[1])
    return sps.coo_matrix((w.ravel(), (rows, idx.ravel())),
                          shape=(n, ncols)).tocsr()


def _csr_device(m, dtype, device):
    """(data, cols, row lengths) of a SciPy matrix on ``device``: values
    in the numpy ``dtype``, int32 columns, int64 row lengths (the segment
    plan)."""
    m = m.tocsr()
    m.sum_duplicates()
    return (torch.as_tensor(m.data.astype(dtype, copy=False),
                            device=device),
            torch.as_tensor(m.indices.astype(np.int32), device=device),
            torch.as_tensor(np.diff(m.indptr).astype(np.int64),
                            device=device))


def _csr_apply(arrs, x):
    """y = A x for a device CSR: per row, the sum of data * x[cols] over
    its entries in column order (the reference's sorted segment_sum)."""
    data, cols, lengths = arrs
    return segment_sum_sorted(data * torch.index_select(x, 0, cols),
                              lengths)


def _power_lmax(dev, dinv, iters=12):
    """Largest eigenvalue of D^-1 A by power iteration from the
    reference's start vector, read on the host."""
    n = dinv.shape[0]
    x = torch.sin(torch.arange(n, dtype=dinv.dtype, device=dinv.device)
                  + 1.0)
    x = x / torch.linalg.norm(x)
    for _ in range(iters):
        y = dinv * _csr_apply(dev, x)
        x = y / torch.linalg.norm(y)
    return float(torch.dot(x, dinv * _csr_apply(dev, x)))


class MGPreconditioner:
    """V-cycle preconditioner built from a deactivated fine CSR matrix.

    Parameters: A (la.MatrixCSR or SciPy) on space V; the mesh hierarchy
    is derived by halving the structured background lattice while the
    lattice size stays even and the dof count > coarse_size. Every device
    tensor takes A's dtype and lives on V's device (the card unless V was
    made on another). ``omega`` and ``bs`` are the reference's signature;
    the smoother is Chebyshev and the block size is V's.

    ``build_times`` holds the seconds of the build's stages: ``transfers``
    (lattices and prolongations), ``galerkin`` (the products P^T A P),
    ``device`` (the CSRs and inverse diagonals moved to the device),
    ``power`` (each level's lmax) and ``coarse_inverse``.
    """

    def __init__(self, A, V, *, nu=2, omega=0.7, coarse_size=3000,
                 bs=1):
        import scipy.sparse as sps
        from .functionspace import FunctionSpace
        from .mesh import create_box, create_rectangle

        t0 = time.perf_counter()
        m = A.to_scipy().tocsr() if hasattr(A, "to_scipy") else A.tocsr()
        np_dtype = m.dtype
        self.dtype = torch.from_numpy(np.zeros(0, np_dtype)).dtype
        self.device = V.device
        mesh = V.mesh
        info = structured_lattice_info(mesh)
        if info is None:
            raise ValueError("MGPreconditioner needs a structured "
                             "background mesh")
        lo, n_axes, h_axes = info
        hi = lo + n_axes * h_axes
        self.nu = nu
        self.omega = omega

        # prolongation chain (fine to coarse); vector (blocked) spaces use
        # the scalar transfer kron'ed with the block identity
        bs = V.bs

        def blocked(P):
            if bs == 1:
                return P
            return sps.kron(P, sps.eye(bs), format="csr")

        prolongs = []
        if V.degree == 2:
            V1 = FunctionSpace(mesh, ("Lagrange", 1), device=V.device)
            idx, w = p2_to_p1_transfer(V, V1)
            prolongs.append(blocked(
                _prolong_matrix(idx, w, V1.num_scalar_dofs)))
        elif V.degree != 1:
            raise NotImplementedError(
                "MG supports P1/P2 Lagrange spaces")

        cur_mesh = mesh
        cur_n = n_axes.copy()
        while (cur_n % 2 == 0).all() and (cur_n > 2).all():
            size = np.prod(cur_n // 2 + 1) * bs
            nxt_n = cur_n // 2
            if cur_mesh.gdim == 3:
                nxt = create_box(lo, hi, tuple(int(k) for k in nxt_n),
                                 cur_mesh.cell_type)
            else:
                nxt = create_rectangle(lo, hi,
                                       tuple(int(k) for k in nxt_n),
                                       cur_mesh.cell_type)
            idx, w = p1_grid_transfer(cur_mesh, nxt)
            prolongs.append(blocked(
                _prolong_matrix(idx, w, nxt.num_vertices)))
            cur_mesh, cur_n = nxt, nxt_n
            if size <= coarse_size:
                break
        t1 = time.perf_counter()

        # Galerkin chain in SciPy's arithmetic (the transfers are f64, so
        # the coarse products are f64 whatever A's dtype, as in the
        # reference); the device copies take A's dtype
        mats = [m]
        for P in prolongs:
            m = (P.T @ m @ P).tocsr()
            mats.append(m)
        t2 = time.perf_counter()

        self.levels = []
        for mk in mats:
            diag = np.asarray(mk.diagonal())
            diag = np.where(np.abs(diag) > 1e-300, diag, 1.0)
            dinv = (1.0 / diag).astype(np_dtype, copy=False)
            self.levels.append(dict(
                A=_csr_device(mk, np_dtype, self.device),
                dinv=torch.as_tensor(dinv, device=self.device)))
        self._sizes = tuple(int(mk.shape[0]) for mk in mats)
        self.prolongs = [_csr_device(P, np_dtype, self.device)
                         for P in prolongs]
        self.restricts = [_csr_device(P.T.tocsr(), np_dtype, self.device)
                          for P in prolongs]
        t3 = time.perf_counter()
        for lv in self.levels:
            # spectral bound of D^-1 A for Chebyshev smoothing
            lv["lmax"] = _power_lmax(lv["A"], lv["dinv"])
        t4 = time.perf_counter()
        self.coarse_inv = torch.as_tensor(
            np.linalg.inv(mats[-1].toarray()).astype(np_dtype, copy=False),
            device=self.device)
        self.n_levels = len(self.levels)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t5 = time.perf_counter()
        self.build_times = dict(transfers=t1 - t0, galerkin=t2 - t1,
                                device=t3 - t2, power=t4 - t3,
                                coarse_inverse=t5 - t4)

    def __call__(self, r):
        return self._vcycle(0, r)

    def _vcycle(self, k, bk):
        """The symmetric V-cycle from level k: nu Chebyshev steps, the
        coarse correction, nu Chebyshev steps."""
        if k == self.n_levels - 1:
            return torch.matmul(self.coarse_inv, bk)
        lv = self.levels[k]
        Ak, dinv, lmax = lv["A"], lv["dinv"], lv["lmax"]
        x = torch.zeros_like(bk)
        x = _smooth(Ak, dinv, lmax, bk, x, self.nu)
        r = bk - _csr_apply(Ak, x)
        rc = _csr_apply(self.restricts[k], r)
        xc = self._vcycle(k + 1, rc)
        x = x + _csr_apply(self.prolongs[k], xc)
        return _smooth(Ak, dinv, lmax, bk, x, self.nu)

    def operator(self):
        """The fine-level CSR operator (for driving CG)."""
        A0 = self.levels[0]["A"]
        return lambda x: _csr_apply(A0, x)

    def solve_cg(self, b, rtol=1e-8, maxiter=200):
        """CG on the fine CSR system with this V-cycle as preconditioner;
        ``b`` (numpy or a tensor) is taken in the hierarchy's dtype on its
        device. Returns (x, iters, residual_norm).

        In f64 this is the reference's solve: the recurrence's residual
        decides. A reduced-precision recurrence drifts from the true
        residual (the reference's f32 solve of bench.py's n = 48 problem
        stops at a true relative residual of 1.18e-6 for rtol 1e-6), so
        below f64 the true residual is measured by one f64 apply of the
        fine CSR, and while it misses rtol, CG restarts on it (at most
        ``MAX_RESTARTS`` times, within ``maxiter``). Then the returned
        norm is the true one."""
        from .la import cg
        b = torch.as_tensor(b).to(device=self.device, dtype=self.dtype)
        x, it, res = cg(self.operator(), b, M=self, rtol=rtol,
                        maxiter=maxiter)
        if self.dtype == torch.float64:
            return x, int(it), float(res)
        A64 = tuple(t.double() if t.is_floating_point() else t
                    for t in self.levels[0]["A"])
        b64 = b.double()
        tol = rtol * float(torch.linalg.norm(b64))
        x64 = x.double()
        for restart in range(MAX_RESTARTS + 1):
            r64 = b64 - _csr_apply(A64, x64)
            res = float(torch.linalg.norm(r64))
            if res <= tol or it >= maxiter or restart == MAX_RESTARTS:
                break
            d, k, _ = cg(self.operator(), r64.to(self.dtype), M=self,
                         rtol=tol / res, maxiter=maxiter - it)
            x64 = x64 + d.double()
            it += k
        return x64.to(self.dtype), int(it), res


def _smooth(Ak, dinv, lmax, b, x, degree):
    """Chebyshev smoother on [lmax/4, 1.1 lmax] of D^-1 A."""
    lo, hi = lmax / 4.0, 1.1 * lmax
    theta = 0.5 * (hi + lo)
    delta = 0.5 * (hi - lo)
    p = torch.zeros_like(b)
    alpha = 0.0
    for k in range(degree):
        resid = dinv * (b - _csr_apply(Ak, x))
        if k == 0:
            p = resid
            alpha = 1.0 / theta
        else:
            beta = (delta * alpha / 2.0) ** 2 if k > 1 else \
                0.5 * (delta * alpha) ** 2
            alpha = 1.0 / (theta - beta / alpha)
            p = resid + beta * p
        x = x + alpha * p
    return x


def mg_solve_cg(A, V, b, *, rtol=1e-8, maxiter=200, **mg_kwargs):
    """CG on the deactivated CSR system with V-cycle preconditioning, on
    V's device in A's dtype (see ``MGPreconditioner.solve_cg``). Returns
    (x, iters, residual_norm)."""
    M = MGPreconditioner(A, V, **mg_kwargs)
    return M.solve_cg(b, rtol=rtol, maxiter=maxiter)
