"""Structured-stencil operator: the grid-layout apply and its Jacobi solve.

The torch counterpart of ``cutfemx_tpu.stencil`` on the Jacobi path. On
create_box backgrounds the P1/P2 operator is translation-invariant away
from the cut, so the interior apply becomes a stencil over lattice cubes
(``interior_stencil.interior_stencil_apply``: the CUDA kernel on the card,
its plain twin on the CPU). Only cubes whose six tets all belong to the
standard (uncut inside) instance use the stencil; every other contribution
(cut cells, interface, ghost penalty, leftover simplices) flows through the
element path, a gather + batched matvec + sorted segment sum. The
composition is exact.

Channel layout per cube at lattice origin o (P2 Freudenthal tets):
  ch0 vertex at o; ch1-3 axis edges o->o+e_i; ch4-6 face diagonals
  o->o+e_i+e_j (the min->max Freudenthal diagonals); ch7 body diagonal.
P1 uses ch0 only. Local cube dofs: 8 vertices + 19 edges = 27 (P2) or
8 (P1), each addressed as (channel, corner offset).

Solves run CG in grid layout: f32 problems by default through iterative
refinement (f64 true residuals measured natively in f64 around short f32
Jacobi-CG corrections). The fold, cube-ASM and coarse preconditioners wait
for ROADMAP items 6.2-6.7.
"""

from __future__ import annotations

import numpy as np
import torch

from .fem import (CutOperator, _build_apply_arrays, segment_sum_sorted,
                  sorted_scatter_plan)
from .interior_stencil import interior_stencil_apply
from .la import cg, cg_init, cg_resume
from .mg import structured_lattice_info

__all__ = ["StencilCutOperator"]

_EDGE_CLASS = {
    (1, 0, 0): 1, (0, 1, 0): 2, (0, 0, 1): 3,
    (1, 1, 0): 4, (1, 0, 1): 5, (0, 1, 1): 6, (1, 1, 1): 7,
}

# solve_cg preconditioners of cutfemx_tpu not ported yet -> ROADMAP item
_PRECOND_ROADMAP = {
    "auto": "6.7 (the production stack and its 'auto' rule)",
    "pallas": "6.7 (the production stack)",
    "asm": "6.3 (cube-block ASM)",
    "asm-fold": "6.3 (cube-block ASM on the folded band)",
    "asm2": "6.4 (the coarse lattice)",
    "asm-fold2": "6.4 (the coarse lattice)",
}


def _local_dof_table(degree):
    """[(channel, (dx,dy,dz))] for the cube-local dofs, fixed order."""
    corners = [(dx, dy, dz) for dx in (0, 1) for dy in (0, 1)
               for dz in (0, 1)]
    table = [(0, c) for c in corners]
    if degree == 2:
        # 12 axis edges: canonical origin = min corner of the edge
        for delta, ch in _EDGE_CLASS.items():
            if sum(delta) == 1:
                ax = delta.index(1)
                for c in corners:
                    if c[ax] == 0:
                        table.append((ch, c))
        # 6 face diagonals: origin = face min corner
        for delta, ch in _EDGE_CLASS.items():
            if sum(delta) == 2:
                free = [a for a in range(3) if delta[a] == 0][0]
                for v in (0, 1):
                    c = [0, 0, 0]
                    c[free] = v
                    table.append((ch, tuple(c)))
        # body diagonal
        table.append((7, (0, 0, 0)))
    return table


class StencilCutOperator:
    """Matrix-free operator with a structured-stencil interior.

    Supports scalar P1/P2 spaces on 3D create_box tet meshes. The largest
    standard cell instance of the form becomes the stencil; everything
    else goes through the element path. Tensors live on the form's device.
    """

    def __init__(self, form, domain=None):
        V = form.test_space
        mesh = V.mesh
        dev = form.device
        self.device = dev
        if mesh.cell_type != "tetrahedron" or V.bs != 1 or \
                V.degree not in (1, 2):
            raise NotImplementedError(
                "StencilCutOperator supports scalar P1/P2 on 3D tet "
                "backgrounds")
        info = structured_lattice_info(mesh)
        if info is None:
            raise ValueError("structured background required")
        lo, n_axes, h_axes = info
        if not (n_axes == n_axes[0]).all():
            raise NotImplementedError("cubic lattice required")
        self.n = int(n_axes[0])
        n = self.n
        self.degree = V.degree
        self.dim = V.dim
        self.form = form

        # cube of each cell: create_box emits 6 tets per cube in order
        cube_of_cell = np.arange(mesh.num_cells) // 6

        # find the standard cell instance with the largest batch
        std_idx = None
        for i, inst in enumerate(form.instances):
            if inst.itype == "cell" and not inst.runtime:
                if std_idx is None or len(inst.entities) > len(
                        form.instances[std_idx].entities):
                    std_idx = i
        if std_idx is None:
            raise ValueError("form has no standard cell instance")
        std = form.instances[std_idx]
        if std.kernel.coefficients:
            raise NotImplementedError(
                "stencil interior requires a coefficient-free standard "
                "integrand (spatially varying coefficients break "
                "translation invariance)")
        valid_rows = np.arange(len(std.rows_cells)) < std.n_valid
        std_cells = np.asarray(std.rows_cells)[valid_rows]

        # cubes fully covered by the standard instance
        count = np.zeros(n ** 3, np.int64)
        np.add.at(count, cube_of_cell[std_cells], 1)
        full_cubes = count == 6
        self.cube_mask = full_cubes.reshape(n, n, n)
        self.cube_mask_t = torch.as_tensor(self.cube_mask.astype(np.uint8),
                                           device=dev)
        in_full = full_cubes[cube_of_cell[std_cells]]
        leftover_cells = std_cells[~in_full]

        # local cube matrix from the instance's own kernel on one
        # interior cube (uniform geometry; form-generic)
        table = _local_dof_table(self.degree)
        self.table = table
        L = len(table)
        probe_cube = self._an_interior_cube(full_cubes, n)
        probe_cells = probe_cube * 6 + np.arange(6)
        probe_data = self._subset_data(form, probe_cells)
        Ae6 = std.kernel.assemble_matrix(probe_data, form.dtype,
                                         form.block).cpu().numpy()
        A_local = np.zeros((L, L))
        slot = self._dof_slot_map(mesh, probe_cube, n)
        bd = V.blocked_dofmap
        for t in range(6):
            ls = [slot[d] for d in bd[probe_cells[t]]]
            for a_, la in enumerate(ls):
                for b_, lb in enumerate(ls):
                    A_local[la, lb] += Ae6[t, a_, b_]
        self.A_local = torch.as_tensor(A_local, dtype=form.dtype,
                                       device=dev)

        # dof -> (channel, lattice coords) grids depend only on (V, mesh),
        # not on the level set: cache them on the function space so a
        # moving-domain step re-cuts and re-assembles but reuses the maps
        gm_key = (self.n, self.degree, lo.tobytes(), h_axes.tobytes())
        gm = getattr(V, "_stencil_grid_cache", None)
        if gm is not None and gm[0] == gm_key:
            (self.grid_index, self._grid_valid_host, self.grid_valid,
             self.grid_gather, self._dof_to_grid_host, self.dof_to_grid,
             self.N) = gm[1]
        else:
            self._build_grid_maps(V, mesh, lo, h_axes)
            V._stencil_grid_cache = (gm_key, (
                self.grid_index, self._grid_valid_host, self.grid_valid,
                self.grid_gather, self._dof_to_grid_host, self.dof_to_grid,
                self.N))

        # element path: all other instances + leftover standard cells,
        # merged and with interior-facet duplicate dofs compressed
        op_rest = CutOperator(form, domain)
        mats, rows, cols, itypes = [], [], [], []
        for i, inst in enumerate(form.instances):
            Ae = op_rest.element_matrices[i]
            rr = op_rest._rows_host[i]
            cc = op_rest._cols_host[i]
            if i == std_idx:
                keep = np.isin(np.asarray(inst.rows_cells), leftover_cells)
                keep &= np.arange(len(keep)) < inst.n_valid
                if keep.any():
                    sel = torch.as_tensor(np.flatnonzero(keep), device=dev)
                    mats.append(Ae[sel])
                    rows.append(rr[keep])
                    cols.append(cc[keep])
                    itypes.append(inst.itype)
            else:
                mats.append(Ae)
                rows.append(rr)
                cols.append(cc)
                itypes.append(inst.itype)
        mats_m, rows_m, cols_m = _build_apply_arrays(mats, rows, cols,
                                                     itypes)
        self.rest_mats = tuple(mats_m)

        self.active = (torch.as_tensor(domain.active_mask, device=dev)
                       if domain is not None else None)

        # grid-layout solve path: CG state stays in channel-grid layout so
        # the interior needs no gathers; only the element path gathers
        nch = 8 if self.degree == 2 else 1
        self.nch = nch
        self.gsize = nch * self.N ** 3
        d2g = self._dof_to_grid_host
        self.rest_rows_grid = tuple(
            torch.as_tensor(d2g[np.asarray(r)].astype(np.int64), device=dev)
            for r in rows_m)
        self.rest_cols_grid = tuple(
            torch.as_tensor(d2g[np.asarray(c)].astype(np.int64), device=dev)
            for c in cols_m)
        flat = np.concatenate([np.asarray(r).ravel() for r in rows_m]) if \
            rows_m else np.zeros(0, np.int64)
        gflat = d2g[flat] if len(flat) else np.zeros(0, np.int64)
        self._permg, self._seg_lengths = sorted_scatter_plan(
            gflat, self.gsize, dev)
        valid_flat = self._grid_valid_host.reshape(-1)
        if self.active is not None:
            act = np.zeros(self.gsize, bool)
            act[valid_flat] = np.asarray(domain.active_mask)[
                self.grid_index.reshape(-1)[valid_flat]]
            self.active_grid = torch.as_tensor(act, device=dev)
            self.identity_grid = torch.as_tensor(valid_flat & ~act,
                                                 device=dev)
        else:
            self.active_grid = torch.as_tensor(valid_flat, device=dev)
            self.identity_grid = torch.zeros(self.gsize, dtype=torch.bool,
                                             device=dev)
        self._arrays64 = None

    # -- grid-layout conversions ---------------------------------------------

    def vec_to_grid(self, x):
        """Dof vector -> flat channel-grid vector (zeros at invalid slots)."""
        X = torch.where(self.grid_valid, x[self.grid_gather], 0.0)
        return X.reshape(-1)

    def grid_to_vec(self, Xf):
        return Xf[self.dof_to_grid]

    # -- setup helpers -------------------------------------------------------

    @staticmethod
    def _an_interior_cube(full_cubes, n):
        idx = np.flatnonzero(full_cubes)
        if len(idx) == 0:
            raise ValueError("no fully-standard cube found")
        # prefer a cube away from the lattice boundary
        for c in idx:
            i, j, k = c // (n * n), (c // n) % n, c % n
            if 0 < i < n - 1 and 0 < j < n - 1 and 0 < k < n - 1:
                return int(c)
        return int(idx[0])

    @staticmethod
    def _subset_data(form, cells):
        """Kernel data for specific cells (uniform interior probes)."""
        mesh = form.mesh

        def t(a):
            return torch.as_tensor(a, dtype=form.dtype, device=form.device)
        return dict(coords=t(mesh.cell_vertex_coords[cells]),
                    h=t(mesh.cell_diameters()[cells]), coeffs=(),
                    mask=t(np.ones(len(cells))))

    def _dof_slot_map(self, mesh, cube, n):
        """dof -> local slot index for one cube."""
        origin = np.array([cube // (n * n), (cube // n) % n, cube % n])
        slot_of = {}
        for s, (ch, off) in enumerate(self.table):
            target = origin + np.array(off)
            if ch == 0:
                vid = ((target[0] * (n + 1) + target[1]) * (n + 1)
                       + target[2])
                slot_of[vid] = s
            else:
                delta = [k for k, v in _EDGE_CLASS.items() if v == ch][0]
                a = target
                b = target + np.array(delta)
                va = ((a[0] * (n + 1) + a[1]) * (n + 1) + a[2])
                vb = ((b[0] * (n + 1) + b[1]) * (n + 1) + b[2])
                key = np.sort([va, vb])
                eidx = np.flatnonzero(
                    (mesh.edges[:, 0] == key[0])
                    & (mesh.edges[:, 1] == key[1]))[0]
                slot_of[mesh.num_vertices + eidx] = s
        return slot_of

    def _build_grid_maps(self, V, mesh, lo, h_axes):
        """Scatter/gather maps between the dof vector and the channel
        grids X (nch, N, N, N) with N = n+1."""
        n = self.n
        N = n + 1
        nch = 8 if self.degree == 2 else 1
        dev = self.device
        lat = np.round((mesh.vertices - lo) / h_axes).astype(np.int64)
        grid_index = np.full((nch, N, N, N), -1, np.int64)
        # vertices -> ch0
        grid_index[0, lat[:, 0], lat[:, 1], lat[:, 2]] = np.arange(
            mesh.num_vertices)
        if self.degree == 2:
            e = mesh.edges
            la, lb = lat[e[:, 0]], lat[e[:, 1]]
            origin = np.minimum(la, lb)
            delta = np.abs(lb - la)
            ch_table = np.zeros(8, np.int64)
            for d, c in _EDGE_CLASS.items():
                ch_table[d[0] * 4 + d[1] * 2 + d[2]] = c
            code = delta[:, 0] * 4 + delta[:, 1] * 2 + delta[:, 2]
            ch = ch_table[code]
            grid_index[ch, origin[:, 0], origin[:, 1], origin[:, 2]] = \
                mesh.num_vertices + np.arange(len(e))
        self.grid_index = grid_index
        valid = grid_index >= 0
        self._grid_valid_host = valid
        self.grid_valid = torch.as_tensor(valid, device=dev)
        self.grid_gather = torch.as_tensor(np.where(valid, grid_index, 0),
                                           device=dev)
        # inverse: dof -> (ch, i, j, k) flat position in the grid
        flatpos = np.full(V.dim, 0, np.int64)
        pos = np.argwhere(valid)
        flat_ids = grid_index[valid]
        lin = ((pos[:, 0] * N + pos[:, 1]) * N + pos[:, 2]) * N + pos[:, 3]
        flatpos[flat_ids] = lin
        self._dof_to_grid_host = flatpos
        self.dof_to_grid = torch.as_tensor(flatpos, device=dev)
        self.N = N

    # -- apply ---------------------------------------------------------------

    def __call__(self, x):
        """Vector-in/vector-out apply (wraps the grid apply)."""
        Xf = self.vec_to_grid(x)
        return self.grid_to_vec(
            _grid_apply_body(*self._grid_statics(), *self._grid_arrays(),
                             Xf))

    def diagonal(self):
        """Assembled diagonal (stencil + element parts), 1.0 at inactive
        dofs."""
        return self.diagonal_grid()[self.dof_to_grid]

    def diagonal_grid(self):
        """Assembled diagonal in flat grid layout (1.0 at inactive and
        invalid slots so Jacobi division is safe)."""
        return _grid_diag_body(*self._grid_statics(), *self._grid_arrays())

    def _grid_statics(self):
        return (self.n, self.N, self.nch, tuple(
            (int(ch), (int(o[0]), int(o[1]), int(o[2])))
            for ch, o in self.table), self.gsize)

    def _grid_arrays(self):
        return (self.A_local, self.cube_mask_t, self.active_grid,
                self.identity_grid, self.rest_mats, self.rest_rows_grid,
                self.rest_cols_grid, self._permg, self._seg_lengths)

    def _grid_arrays_f64(self):
        """_grid_arrays with the matrices widened to f64 (the same values):
        the true-residual apply of iterative refinement."""
        if self._arrays64 is None:
            a = self._grid_arrays()
            self._arrays64 = (a[0].double(), *a[1:4],
                              tuple(m.double() for m in a[4]), *a[5:])
        return self._arrays64

    # -- solve ---------------------------------------------------------------

    def solve_cg(self, b, rtol=1e-8, maxiter=500, precond="jacobi",
                 dispatch_chunk=None, refine="auto"):
        """Jacobi-preconditioned CG in grid layout; takes and returns dof
        vectors. f32 right-hand sides solve through iterative refinement
        unless ``refine=False``. Returns (x, iterations, residual norm).

        precond: 'jacobi' only. The other preconditioners of cutfemx_tpu,
        and its 'auto' rule, raise NotImplementedError naming the ROADMAP
        item that ports them."""
        if precond != "jacobi":
            if precond in _PRECOND_ROADMAP:
                raise NotImplementedError(
                    f"precond={precond!r}: ROADMAP item "
                    f"{_PRECOND_ROADMAP[precond]}")
            raise ValueError(f"unknown precond {precond!r}")
        if refine is True or (refine == "auto"
                              and b.dtype == torch.float32):
            return self._solve_ir(b, rtol, maxiter, dispatch_chunk)
        bb = torch.where(self.active, b, 0.0) \
            if self.active is not None else b
        bg = self.vec_to_grid(bb)
        xg, it, res = _grid_cg(*self._grid_statics(), *self._grid_arrays(),
                               bg, rtol, maxiter)
        return xg[self.dof_to_grid], it, res

    def _inner_solve(self, bg, rtol, maxiter, dispatch_chunk):
        """Chunked f32 Jacobi solve in grid layout -> (x_grid, its, rr)."""
        return self._chunked_cg(_grid_cg_jac_first, _grid_cg_jac_chunk,
                                self._grid_statics(), self._grid_arrays(),
                                bg, rtol, maxiter, dispatch_chunk)

    def _solve_ir(self, b, rtol, maxiter, dispatch_chunk):
        """Mixed-precision iterative refinement around the f32 solver.

        The f32 apply has an absolute rounding floor of roughly
        eps * sqrt(active rows) * sum|row terms|, so no f32 Krylov
        recurrence reaches a 1e-6 relative TRUE residual at large sizes.
        Measure the true residual with ONE f64 apply per outer step, then
        correct with a SHORT f32 inner solve at loose tolerance (1e-3
        relative to the current residual). f64 is native on the card."""
        act = self.active if self.active is not None else True
        bg, bg64, bb2d = _ir_prep(act, self.grid_valid, self.grid_gather, b)
        bb2 = float(bb2d)
        tol2 = rtol * rtol * bb2
        x64 = None
        best_x64, best_rho2 = None, bb2   # x = 0 has residual ||b||^2
        total_its = 0
        prev_rho2 = np.inf
        rho2 = bb2
        # every trip through the loop top MEASURES the current iterate
        # (one f64 apply), so the returned residual is never stale; the
        # extra 11th trip exists only to measure the 10th correction
        for outer in range(11):
            if outer == 0:
                r32 = bg
                rho2 = bb2
            else:
                r32, rho2d = _ir_measure(*self._grid_statics(),
                                         *self._grid_arrays_f64(), bg64,
                                         x64)
                rho2 = float(rho2d)
                if np.isfinite(rho2) and rho2 < best_rho2:
                    best_x64, best_rho2 = x64, rho2
            if best_rho2 <= tol2 or total_its >= maxiter or outer == 10 \
                    or not np.isfinite(rho2) or rho2 >= 0.25 * prev_rho2:
                break
            prev_rho2 = rho2
            # the last outer step should target the global tolerance
            # directly (padded), not over-solve a fixed 1e-3 below the
            # current residual into the inner f32 floor
            inner_rtol = max(1e-3, 0.5 * float(np.sqrt(tol2 / rho2)))
            eg, its, _ = self._inner_solve(
                r32, inner_rtol, min(maxiter - total_its, 400),
                dispatch_chunk)
            total_its += int(its) + 1   # +1 for the outer f64 apply
            x64 = eg.double() if x64 is None else x64 + eg.double()
        if best_x64 is None:
            xf = torch.zeros_like(bg[self.dof_to_grid])
        else:
            xf = best_x64[self.dof_to_grid].float()
        return xf, total_its, np.sqrt(best_rho2)

    def _chunked_cg(self, first_fn, chunk_fn, statics, arrays, bg, rtol,
                    maxiter, dispatch_chunk):
        """Host loop of bounded CG chunks with a TRUE-RESIDUAL RESTART at
        every chunk boundary; the restart truncates f32 recurrence drift."""
        if dispatch_chunk is None:
            dispatch_chunk = max(50, int(1.25e9 / max(self.gsize, 1)))
        chunk = max(1, min(int(dispatch_chunk), 150))
        state, rr, tol2d = first_fn(*statics, *arrays, bg, rtol,
                                    min(chunk, maxiter))
        rr_f, tol2 = float(rr), float(tol2d)
        it = int(state[4])
        x = state[0]
        if not np.isfinite(rr_f):
            # first chunk already broke down (NaN > tol2 is False, so the
            # loop below would silently return garbage)
            return self._jacobi_tail(bg, torch.zeros_like(bg), tol2, it,
                                     maxiter, chunk)
        best_x, best_rr = x, rr_f
        while rr_f > tol2 and it < maxiter:
            cap = min(chunk, maxiter - it)
            x, rr, its_done = chunk_fn(*statics, *arrays, bg, x, tol2, cap)
            rr_f = float(rr)
            it += int(its_done) + 1   # +1: the restart's fresh apply
            # f32 accuracy floor: if a chunk diverges, NaNs, breaks down
            # (rz <= 0 exits the loop early), or stalls at full size above
            # tolerance, finish with the Jacobi tail from the best iterate
            breakdown = int(its_done) < cap and rr_f > tol2
            if (not np.isfinite(rr_f)) or rr_f > 4.0 * best_rr or \
                    breakdown or \
                    (int(its_done) >= 50 and rr_f > 0.7 * best_rr):
                if rr_f < best_rr:
                    best_x, best_rr = x, rr_f
                if best_rr <= tol2:
                    break
                return self._jacobi_tail(bg, best_x, tol2, it, maxiter,
                                         chunk)
            if rr_f < best_rr:
                best_x, best_rr = x, rr_f
        if rr_f <= best_rr:
            best_x, best_rr = x, rr_f
        return best_x, it, best_rr

    def _jacobi_tail(self, bg, x0, tol2, it, maxiter, chunk):
        """Finish a solve with restarted Jacobi-PCG chunks from x0
        (returns a GRID vector and the squared residual)."""
        statics = self._grid_statics()
        arrays = self._grid_arrays()
        x, rr_f = x0, np.inf
        best = np.inf
        retried_from_zero = False
        while it < maxiter:
            x, rr, its_done = _grid_cg_jac_chunk(
                *statics, *arrays, bg, x, tol2, min(chunk, maxiter - it))
            rr_f = float(rr)
            it += int(its_done) + 1
            if not np.isfinite(rr_f):
                if retried_from_zero:
                    break
                retried_from_zero = True
                x = torch.zeros_like(bg)   # discard a poisoned iterate
                continue
            if rr_f <= tol2:
                break
            # f32 floor: a full-size chunk that fails to reduce the
            # residual by 30% will not do better on the next restart
            if int(its_done) >= 50 and rr_f > 0.7 * best:
                break
            best = min(best, rr_f)
        return x, it, rr_f


# -- grid-layout bodies -------------------------------------------------------


def _grid_apply_body(n, N, nch, table, gsize, A_local, cube_mask,
                     active_grid, identity_grid, rest_mats, rest_rows,
                     rest_cols, permg, seg_lengths, Xf):
    """Operator apply on flat grid-layout vectors. Invariant: invalid grid
    slots are zero on input and output; inactive dofs get identity."""
    Xin = torch.where(active_grid, Xf, 0.0)
    Yf = interior_stencil_apply(n, N, nch, table, A_local, cube_mask, Xin)
    if rest_mats:
        flat = torch.cat([torch.einsum("eij,ej->ei", Ae, Xin[cg]).reshape(-1)
                          for Ae, cg in zip(rest_mats, rest_cols)])
        Yf = Yf + segment_sum_sorted(flat[permg], seg_lengths)
    # identity on inactive (valid) slots; zero on invalid slots
    Yf = torch.where(active_grid, Yf, 0.0)
    return Yf + torch.where(identity_grid, Xf, 0.0)


def _grid_diag_body(n, N, nch, table, gsize, A_local, cube_mask,
                    active_grid, identity_grid, rest_mats, rest_rows,
                    rest_cols, permg, seg_lengths):
    dloc = torch.diagonal(A_local)
    mask = cube_mask.bool()
    Y = torch.zeros((nch, N, N, N), dtype=A_local.dtype,
                    device=A_local.device)
    for s, (ch, (dx, dy, dz)) in enumerate(table):
        Y[ch, dx:dx + n, dy:dy + n, dz:dz + n] += torch.where(
            mask, dloc[s], 0.0)
    d = Y.reshape(-1)
    if rest_mats:
        # interior-facet elements repeat shared facet dofs on both sides:
        # sum every (i, j) entry whose row and column map to the same dof
        flat = torch.cat([
            torch.where(rg[:, :, None] == cg[:, None, :], Ae, 0.0)
            .sum(dim=2).reshape(-1)
            for Ae, rg, cg in zip(rest_mats, rest_rows, rest_cols)])
        d = d + segment_sum_sorted(flat[permg], seg_lengths)
    return torch.where(active_grid, d, 1.0)


def _jacobi(args):
    """(apply, M) of the Jacobi-preconditioned grid operator."""
    dg = _grid_diag_body(*args)
    dg = torch.where(torch.abs(dg) > 1e-30, dg, 1.0)  # 0/0 -> NaN guard
    return (lambda Xf: _grid_apply_body(*args, Xf)), (lambda r: r / dg)


def _grid_cg(*a):
    """Single-run Jacobi PCG (the refine=False path): trajectory-compatible
    with cutfemx_tpu's _grid_cg."""
    args, (bg, rtol, maxiter) = a[:-3], a[-3:]
    dg = _grid_diag_body(*args)
    return cg(lambda Xf: _grid_apply_body(*args, Xf), bg,
              M=lambda r: r / dg, rtol=rtol, maxiter=maxiter)


def _cg_first(op, M, bg, rtol, it_cap):
    """init + first resume. Returns (state, rr, tol2)."""
    state, bb = cg_init(op, bg, M=M)
    rtol = torch.tensor(rtol, dtype=bg.dtype, device=bg.device)
    # clamp: for tiny-magnitude rhs at tight rtol the f32 product can
    # underflow to 0, which would make the solve grind to maxiter
    tol2 = torch.clamp((rtol * rtol) * bb, min=torch.finfo(bg.dtype).tiny)
    state = cg_resume(op, state, M, tol2, it_cap)
    return state, torch.dot(state[1], state[1]), tol2


def _cg_restart(op, M, bg, x0, tol2, it_cap):
    """Fresh-start chunk: recompute the TRUE residual at x0, run up to
    it_cap iterations. Returns (x, rr, iterations_done)."""
    tol2 = torch.tensor(tol2, dtype=bg.dtype, device=bg.device)
    state, _ = cg_init(op, bg, x0=x0, M=M)
    state = cg_resume(op, state, M, tol2, it_cap)
    return state[0], torch.dot(state[1], state[1]), state[4]


def _grid_cg_jac_first(*a):
    """First chunk with the Jacobi preconditioner."""
    return _cg_first(*_jacobi(a[:-3]), *a[-3:])


def _grid_cg_jac_chunk(*a):
    """Restart chunk with the Jacobi preconditioner."""
    return _cg_restart(*_jacobi(a[:-4]), *a[-4:])


# -- iterative-refinement steps ----------------------------------------------


def _ir_prep(active, grid_valid, grid_gather, b):
    """dof rhs -> (f32 grid rhs, f64 grid rhs, ||b||^2)."""
    bb = torch.where(active, b, 0.0)
    X = torch.where(grid_valid, bb[grid_gather], 0.0).reshape(-1)
    X64 = X.double()
    return X, X64, torch.dot(X64, X64)


def _ir_measure(*a):
    """One f64 true-residual measurement: r = b64 - A x64, returns the
    f32 copy for the inner corrector and ||r||^2."""
    bg64, x64 = a[-2], a[-1]
    r64 = bg64 - _grid_apply_body(*a[:-2], x64)
    return r64.float(), torch.dot(r64, r64)
