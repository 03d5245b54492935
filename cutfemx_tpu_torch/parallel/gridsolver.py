"""Distributed grid-layout stencil solver: the single-card stencil solver
(stencil.StencilCutOperator: interior stencil + gathered element band +
cube-block additive Schwarz) split over the slabs of a slab mesh.

The torch counterpart of ``cutfemx_tpu.parallel.gridsolver``. Layout: the
channel grid (nch, N, N, N) splits into contiguous x-plane slabs. Slab p
owns planes [start_p, start_p + W_p) and the lattice cubes starting in
them. Local blocks carry TWO extra halo planes on the right only — every
read/write of the interior stencil (cube c touches planes c..c+1), the
element band (elements are owned by the slab of their minimum plane and
reach at most min+2), and the ASM block apply (cube c touches c..c+1)
stays within [owned | right-halo-2].

One operator apply or preconditioner apply costs exactly two ppermutes:
ghost-plane contributions accumulate to the right neighbor, then the halo
planes refresh from the right neighbor's owned boundary. CG dot products
are psums of the slabs' sums over their owned valid planes.

The interior stencil of a slab apply is K1 (``interior_stencil``) on a box
of Wmax x n x n cubes over (Wmax + 2) x N x N points, all local slabs in
one launch; the reference does that part as an einsum. Per cube it
computes A x, the port's convention
(``tests/test_torch_core.py::test_reference_grid_apply_uses_A_transpose``
pins it); the reference's slab apply contracts ``"xyzl,lm->xyzm"``
(A^T x), as its serial grid apply does. Full standard cubes carry a
symmetric A_local, so the two agree.
"""

from __future__ import annotations

import numpy as np
import torch

from ..interior_stencil import interior_stencil_apply_box
from ..stencil import _blocks_vecmat
from .halo import _SlabScatter

__all__ = ["ShardedStencilSolver"]


def _plane_split(n, N, nparts):
    """Split lattice planes [0, N) into slabs of >= 2 cube columns."""
    if n < 2 * nparts:
        raise ValueError(
            f"grid solver needs >= 2 cube columns per slab "
            f"({n} columns, {nparts} slabs)")
    bounds = np.linspace(0, n, nparts + 1).round().astype(int)
    starts = bounds[:-1]
    widths = np.diff(bounds)
    widths[-1] = N - starts[-1]   # last slab also owns plane n
    return starts, widths


def _slab_planes(G, starts, Wext, nparts):
    """Slice a (C, N, ...) host array into (P, C, Wext, ...) slab blocks
    (planes past N stay zero)."""
    N = G.shape[1]
    out = np.zeros((nparts, G.shape[0], Wext) + G.shape[2:], G.dtype)
    for p in range(nparts):
        s = starts[p]
        e = min(s + Wext, N)
        out[p, :, :e - s] = G[:, s:e]
    return out


class ShardedStencilSolver:
    """Distribute a built StencilCutOperator over a slab mesh.

    The element data is REGROUPED from the serial operator (oracle
    construction; the owner-computes construction is
    sgrid.ShardedStencilProblem). The SOLVE — interior stencil, element
    band, cube-ASM preconditioner, CG — runs distributed.
    """

    def __init__(self, op, device_mesh, axis="cells"):
        self.op = op
        self.mesh_dev = device_mesh
        self.axis = axis
        self.comm = device_mesh.comm
        nparts = device_mesh.shape[axis]
        self.nparts = nparts
        n, N, nch = op.n, op.N, op.nch
        self.n, self.N, self.nch = n, N, nch
        self.table = tuple((int(ch), tuple(int(o) for o in off))
                           for ch, off in op.table)
        L = len(self.table)
        put = device_mesh.put

        starts, widths = _plane_split(n, N, nparts)
        self.starts, self.widths = starts, widths
        Wmax = int(widths.max())
        Wext = Wmax + 2
        self.Wmax, self.Wext = Wmax, Wext

        # cubes owned by slab p: [start_p, start_p + ncubes_p) where the
        # last slab's width counts plane n (one more plane than cubes)
        ncubes = np.minimum(starts + widths, n) - starts
        self.ncubes = ncubes
        cmask_l = np.zeros((nparts, Wmax, n, n), np.uint8)
        for p in range(nparts):
            s, e = starts[p], starts[p] + ncubes[p]
            cmask_l[p, :e - s] = op.cube_mask[s:e]
        self.d_cube_mask = put(cmask_l)

        act = op.active_grid.cpu().numpy().reshape(nch, N, N, N)
        idg = op.identity_grid.cpu().numpy().reshape(nch, N, N, N)
        self.d_active = put(_slab_planes(act, starts, Wext, nparts))
        self.d_identity = put(_slab_planes(idg, starts, Wext, nparts))
        self.d_W = put(np.asarray(widths, np.int64))
        owned = np.zeros((nparts, 1, Wext, 1, 1), bool)
        for p in range(nparts):
            owned[p, 0, :widths[p]] = True
        self.d_owned_planes = put(owned)

        # -- element band regrouped by owning slab (min plane) -------------
        def local_flat(gpos, p):
            """Global grid flat index -> local extended flat index."""
            ch = gpos // N ** 3
            rem = gpos % N ** 3
            lx = rem // N ** 2 - starts[p]
            return ((ch * Wext + lx) * N ** 2) + rem % N ** 2

        d_insts = []
        for Ae, rgn, cgn in zip(op.rest_mats, op._rest_rows_grid_host,
                                op._rest_cols_grid_host):
            Ah = Ae.cpu().numpy()
            # owner slab = slab of the element's minimum x-plane (its other
            # positions reach at most min+2: within the right halo)
            gx_r = (rgn % N ** 3) // N ** 2
            gx_c = (cgn % N ** 3) // N ** 2
            gx_min = np.minimum(gx_r.min(axis=1), gx_c.min(axis=1))
            owner = np.clip(np.searchsorted(starts, gx_min, "right") - 1,
                            0, nparts - 1)
            Emax = max(int(np.bincount(owner, minlength=nparts).max()), 1)
            Al = np.zeros((nparts, Emax) + Ah.shape[1:], Ah.dtype)
            Rl = np.zeros((nparts, Emax, rgn.shape[1]), np.int64)
            Cl = np.zeros((nparts, Emax, cgn.shape[1]), np.int64)
            for p in range(nparts):
                sel = np.flatnonzero(owner == p)
                if not len(sel):
                    continue
                Al[p, :len(sel)] = Ah[sel]
                Rl[p, :len(sel)] = local_flat(rgn[sel], p)
                Cl[p, :len(sel)] = local_flat(cgn[sel], p)
            d_insts.append((put(Al), put(Rl), put(Cl)))
        self.d_insts = tuple(d_insts)
        self.gsize_l = nch * Wext * N * N
        self._scatter = _SlabScatter([R.cpu().numpy() for _, R, _ in d_insts],
                                     self.gsize_l, device_mesh.device)

        # -- ASM inverse blocks sliced per slab (owned cubes only) ----------
        op._ensure_cube_asm()
        x0, y0, z0, nbx, nby, nbz = op._asm_bbox
        bh = op._asm_binv.cpu().numpy()              # (nbx, nby, nbz, L, L)
        Bl = np.zeros((nparts, Wmax, n, n, L, L), bh.dtype)
        for p in range(nparts):
            s, e = starts[p], starts[p] + ncubes[p]
            lo = max(s, x0)
            hi = min(e, x0 + nbx)
            if hi > lo:
                Bl[p, lo - s:hi - s, y0:y0 + nby, z0:z0 + nbz] = \
                    bh[lo - x0:hi - x0]
        self.d_binv = put(Bl)

        # covered slots (host precompute): grid slots of any cube with a
        # nonzero ASM block; uncovered active slots keep r (identity M)
        cov_cubes = np.zeros((n, n, n), bool)
        cov_cubes[x0:x0 + nbx, y0:y0 + nby, z0:z0 + nbz] = \
            np.abs(bh).max(axis=(-1, -2)) > 0
        covered = np.zeros((nch, N, N, N), bool)
        for (ch, (dx, dy, dz)) in self.table:
            covered[ch, dx:dx + n, dy:dy + n, dz:dz + n] |= cov_cubes
        self.d_covered = put(_slab_planes(covered, starts, Wext, nparts))

        self.A_local = op.A_local
        self.dtype = op.A_local.dtype

    # -- host-side vector staging -----------------------------------------

    def to_local(self, x):
        """Global dof vector -> (P_local, nch, Wext, N, N) slab blocks
        (halo planes populated)."""
        G = self.op.vec_to_grid(x).cpu().numpy().reshape(
            self.nch, self.N, self.N, self.N)
        return self.mesh_dev.put(_slab_planes(G, self.starts, self.Wext,
                                              self.nparts))

    def to_global_grid(self, Xl):
        """Slab blocks -> (gsize,) flat global grid (owned planes)."""
        Xn = self.mesh_dev.gather(Xl)
        N, nch = self.N, self.nch
        G = np.zeros((nch, N, N, N), Xn.dtype)
        for p in range(self.nparts):
            s, w = self.starts[p], self.widths[p]
            G[:, s:s + w] = Xn[p, :, :w]
        return G.reshape(-1)

    def to_global(self, Xl):
        """Slab blocks -> global dof vector."""
        return self.to_global_grid(Xl)[self.op.dof_to_grid.cpu().numpy()]

    # -- distributed solve ---------------------------------------------------

    def solve_cg(self, b, rtol=1e-8, maxiter=500):
        """Distributed ASM-preconditioned CG. Returns (x_dofs, iters,
        true-residual norm)."""
        x, it, res = _sgrid_cg(self, _sgrid_apply_body, _sgrid_precond_body,
                               self.to_local(b), rtol, maxiter)
        return self.to_global(x), int(it), float(res)

    def apply_global(self, x):
        """A @ x through the distributed apply (testing/oracle path)."""
        return self.to_global(_sgrid_apply_body(self, self.to_local(x)))

    def precond_global(self, r):
        """M @ r through the distributed ASM apply (testing path)."""
        return self.to_global(_sgrid_precond_body(self, self.to_local(r)))


# -- slab bodies (every tensor has the slab axis first) -----------------------


def _plane_index(slv, Y):
    """Gather index of the two halo planes [W, W+2) of each slab."""
    P, C, _, N1, N2 = Y.shape
    planes = slv.d_W[:, None] + torch.arange(2, device=Y.device)
    return planes[:, None, :, None, None].expand(P, C, 2, N1, N2)


def _halo_accumulate(slv, Y):
    """Send right-halo write planes [W, W+2) to the right neighbor's owned
    planes [0, 2); then zero the local halo contribution."""
    idx = _plane_index(slv, Y)
    recv = slv.comm.ppermute(torch.gather(Y, 2, idx),
                             [(p, p + 1) for p in range(slv.nparts - 1)])
    Y = Y.scatter(2, idx, torch.zeros_like(recv))
    Y[:, :, 0:2] += recv
    return Y


def _halo_refresh(slv, Y):
    """Refresh local halo planes [W, W+2) from the right neighbor's owned
    planes [0, 2) (the last slab receives zeros — out of domain)."""
    recv = slv.comm.ppermute(Y[:, :, 0:2],
                             [(p + 1, p) for p in range(slv.nparts - 1)])
    return Y.scatter(2, _plane_index(slv, Y), recv)


def _band_apply(slv, Xin, insts, scatter):
    """Slab-owned element band: gather + batched matvec + one sorted
    segment sum into the stacked slab grids."""
    P = Xin.shape[0]
    xf = Xin.reshape(P, -1)
    parts = [torch.einsum("peij,pej->pei", A,
                          torch.gather(xf, 1, C.reshape(P, -1))
                          .reshape(C.shape))
             for A, _, C in insts]
    return scatter(parts).reshape(Xin.shape)


def _sgrid_apply_body(slv, X, insts=None, A_local=None):
    """Operator apply on (P_local, nch, Wext, N, N) slab blocks.
    Invariant: halo planes of X hold the neighbor's current values.
    ``insts`` / ``A_local`` default to the solver's (f64 copies for the
    true residual of iterative refinement)."""
    insts = slv.d_insts if insts is None else insts
    A_local = slv.A_local if A_local is None else A_local
    Xin = torch.where(slv.d_active, X, 0.0)
    # interior stencil over owned cubes: K1, every local slab in one launch
    Y = interior_stencil_apply_box(slv.nch, slv.table, A_local,
                                   slv.d_cube_mask, Xin)
    if insts:
        Y = Y + _band_apply(slv, Xin, insts, slv._scatter)
    Y = _halo_refresh(slv, _halo_accumulate(slv, Y))
    return torch.where(slv.d_active, Y, 0.0) + \
        torch.where(slv.d_identity, X, 0.0)


def _cube_slots(slv, R):
    """(P, Wmax, n, n, L) slot values of each slab's owned cube planes."""
    n, Wmax = slv.n, slv.Wmax
    return torch.stack([R[:, ch, dx:dx + Wmax, dy:dy + n, dz:dz + n]
                        for (ch, (dx, dy, dz)) in slv.table], dim=-1)


def _cube_scatter(slv, zc, like):
    """Slice-add (P, Wmax, n, n, L) cube slot values into slab blocks."""
    n, Wmax = slv.n, slv.Wmax
    Z = torch.zeros_like(like)
    for s, (ch, (dx, dy, dz)) in enumerate(slv.table):
        Z[:, ch, dx:dx + Wmax, dy:dy + n, dz:dz + n] += zc[..., s]
    return Z


def _sgrid_precond_body(slv, R):
    """Cube-block ASM apply on slab blocks (identity on uncovered
    slots)."""
    Z = _cube_scatter(slv, _blocks_vecmat(_cube_slots(slv, R), slv.d_binv),
                      R)
    Z = _halo_refresh(slv, _halo_accumulate(slv, Z))
    return torch.where(slv.d_active & slv.d_covered, Z, R)


def _pdot(slv, u, v):
    """Sum over owned active slots of u * v, psum-reduced over slabs."""
    m = slv.d_owned_planes & slv.d_active
    return slv.comm.psum(torch.where(m, u * v, 0.0).sum((1, 2, 3, 4)))[0]


def _sgrid_cg(slv, apply_body, precond_body, b, rtol, maxiter):
    """Distributed PCG over slab blocks, the reference's recurrence and
    stopping test; the loop reads the test on the host every iteration."""
    act = slv.d_active
    bb = torch.where(act, b, 0.0)
    x = torch.zeros_like(bb)
    r = bb - apply_body(slv, x)
    z = precond_body(slv, r)
    p_vec = z
    rz = _pdot(slv, r, z)
    tol2 = torch.clamp((rtol * rtol) * _pdot(slv, bb, bb),
                       min=torch.finfo(bb.dtype).tiny)
    it = 0
    while it < maxiter and bool(_pdot(slv, r, r) > tol2):
        Ap = apply_body(slv, p_vec)
        alpha = rz / _pdot(slv, p_vec, Ap)
        x = x + alpha * p_vec
        r = r - alpha * Ap
        z = precond_body(slv, r)
        rz_new = _pdot(slv, r, z)
        p_vec = z + (rz_new / rz) * p_vec
        rz = rz_new
        it += 1
    return x, it, torch.sqrt(_pdot(slv, r, r))
