"""Structured-stencil operator: the grid-layout apply, its preconditioners
and its solves.

The torch counterpart of ``cutfemx_tpu.stencil``, function for function
under the same names. On create_box backgrounds the P1/P2 operator is translation-invariant away
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

The production stack re-expresses that element path as dense cube-block
tensors (the band fold: no gathers in the apply), preconditions with one
additive-Schwarz block per lattice cube plus a coarse trilinear lattice
level, and keeps the three builds in a cache that hands them back only to
an operator whose build inputs are bitwise the same.

Solves run CG in grid layout: f32 problems by default through iterative
refinement (f64 true residuals measured natively in f64 around short f32
preconditioned-CG corrections).

Against cutfemx_tpu: every scatter-add of the builds is a sorted segment
sum (two builds of one cut give bitwise equal tensors on the card); the
ASM blocks always come from the band fold (cutfemx_tpu's host sweep and
its sweep fold are not carried over); no environment variable is read; the
per-preconditioner ``_grid_cg_*_first/_chunk`` jit entry points have no
counterpart, ``_chunked_cg`` takes the (apply, M) pair of ``_ops``.
"""

from __future__ import annotations

import time
from collections import OrderedDict

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

_PRECONDS = ("jacobi", "asm", "asm-fold", "asm2", "asm-fold2", "pallas")
_AUTO_STACK_FROM_N = 96    # 'auto' on CUDA tensors, see _auto_precond

# latest preconditioner builds keyed by grid/shape signature; adopted only
# after a bitwise input-fingerprint match (see _adopt_cached)
_BUILD_CACHE: OrderedDict = OrderedDict()

# Device bytes one cache entry may pin between passes. The fold, ASM and
# coarse tensors of the 10,218,313-dof bench problem (n = 108) take about
# 2.5 GB together in f32 (fold 4 x 52^3 x 27^2, ASM 52^3 x 27^2, coarse
# inverse 6859^2), so a tenth of an 80 GB card holds all three stages three
# times over and leaves the assembly's transients their room; the cache
# keeps at most two entries.
_BUILD_CACHE_BUDGET_BYTES = 8 * 10 ** 9

_FP_CHUNK = 1 << 24      # words fingerprinted per pass (bounds temporaries)
_FOLD_CHUNK = 1 << 16    # elements per band-fold pass
_COARSE_CHUNK = 1 << 15  # cubes per coarse-fold pass


def _fp_arrays(arrs):
    """(k, 2) int64 bitwise fingerprint of a sequence of tensors: the sum
    of their 32-bit words and a position-weighted sum, both mod 2^32.
    Floating tensors are read as their raw words (two per f64 value), so
    any changed bit changes the plain sum; equal tensors always match, and
    differing ones collide only if both sums coincide. Integer sums wrap
    the same way in any order, so the value does not depend on the device.
    One transfer to the host."""
    out = []
    for a in arrs:
        if a.dtype.is_floating_point:
            v = a.contiguous().view(torch.int32).reshape(-1)
        else:
            v = a.reshape(-1)
        s0 = torch.zeros((), dtype=torch.int64, device=a.device)
        s1 = torch.zeros((), dtype=torch.int64, device=a.device)
        for st in range(0, v.numel(), _FP_CHUNK):
            w = v[st:st + _FP_CHUNK].to(torch.int64) & 0xFFFFFFFF
            i = torch.arange(st, st + w.numel(), dtype=torch.int64,
                             device=a.device)
            # Knuth multiplier, kept to 31 bits so w * weight < 2^63
            weight = ((i * 2654435761) & 0x7FFFFFFF) | 1
            s0 = s0 + w.sum()
            s1 = s1 + (w * weight).sum()
        out.append(torch.stack([s0, s1]) & 0xFFFFFFFF)
    if not out:
        return np.zeros((0, 2), np.int64)
    return torch.stack(out).cpu().numpy()


def _tree_nbytes(val):
    """Total bytes of the tensors in a (possibly nested) stage value."""
    if isinstance(val, torch.Tensor):
        return val.numel() * val.element_size()
    if isinstance(val, (tuple, list)):
        return sum(_tree_nbytes(v) for v in val)
    if isinstance(val, dict):
        return sum(_tree_nbytes(v) for v in val.values())
    return 0


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


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
        op_rest = CutOperator(form, domain, apply_plan=False)
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
        # host mirrors: the builds do their bounding-box bookkeeping on them
        self._rest_rows_grid_host = tuple(
            d2g[np.asarray(r)].astype(np.int64) for r in rows_m)
        self._rest_cols_grid_host = tuple(
            d2g[np.asarray(c)].astype(np.int64) for c in cols_m)
        self.rest_rows_grid = tuple(
            torch.as_tensor(g, device=dev)
            for g in self._rest_rows_grid_host)
        self.rest_cols_grid = tuple(
            torch.as_tensor(g, device=dev)
            for g in self._rest_cols_grid_host)
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
            self._active_grid_host = act
            self.active_grid = torch.as_tensor(act, device=dev)
            self.identity_grid = torch.as_tensor(valid_flat & ~act,
                                                 device=dev)
        else:
            self._active_grid_host = valid_flat
            self.active_grid = torch.as_tensor(valid_flat, device=dev)
            self.identity_grid = torch.zeros(self.gsize, dtype=torch.bool,
                                             device=dev)
        self._init_stack_state()

    def _init_stack_state(self):
        """Nothing built yet: the fold, ASM and coarse tensors, the input
        fingerprint, the f64 copy of the apply arrays, and ``build_log``
        (stage -> ("built" | "adopted", seconds))."""
        self._arrays64 = None
        self._fp_cache = None
        self._bf_diag = self._bf_fwd = self._bf_rev = self._bf_bbox = None
        self._asm_binv = self._asm_bbox = None
        self._c_m = self._c_K = self._c_W = self._c_sel = None
        self._c_acinv = None
        self.build_log = {}

    # -- grid-layout conversions ---------------------------------------------

    def _vector(self, x):
        """``x`` as a tensor of the form's dtype (the stencil's) on the
        operator's device: numpy input is copied there, a tensor on another
        device refused (as ``fem.CutOperator`` takes its vectors)."""
        if isinstance(x, torch.Tensor) and x.device != self.device:
            raise ValueError(f"vector on {x.device}, operator on "
                             f"{self.device}")
        return torch.as_tensor(x, dtype=self.A_local.dtype,
                               device=self.device)

    def vec_to_grid(self, x):
        """Dof vector -> flat channel-grid vector (zeros at invalid slots)."""
        X = torch.where(self.grid_valid, self._vector(x)[self.grid_gather],
                        0.0)
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

    def traffic_model(self):
        """Device-memory bytes one preconditioned-CG iteration of the
        'pallas' stack must move: the roofline denominator for an achieved
        bandwidth.

        Per iteration: the interior-stencil kernel's own bound (the grid
        written once, the cube mask and A read once, the values that full
        cubes touch read once), one read of each folded-band, ASM and
        coarse tensor, and the CG and preconditioner vector recurrences (r,
        z, p, q, x updates and dot products, counted as 12 grid-vector
        sweeps). A lower bound: it ignores the slicing copies of the torch
        stages. Only meaningful after a 'pallas' solve has built the
        stages."""
        item = self.A_local.element_size()
        vec = self.gsize * item
        n, L = self.n, len(self.table)
        touched = np.zeros((self.nch, self.N, self.N, self.N), bool)
        for ch, (dx, dy, dz) in self.table:
            touched[ch, dx:dx + n, dy:dy + n, dz:dz + n] |= self.cube_mask
        stencil = (self.gsize + int(touched.sum()) + L * L) * item + n ** 3
        band = _tree_nbytes((self._bf_diag, self._bf_fwd, self._bf_rev))
        asm = _tree_nbytes(self._asm_binv)
        coarse = _tree_nbytes((self._c_W, self._c_acinv))
        cg_vecs = 12 * vec
        return {"vec_bytes": vec, "stencil_bytes": stencil,
                "band_bytes": band, "asm_bytes": asm,
                "coarse_bytes": coarse, "cg_vec_bytes": cg_vecs,
                "bytes_per_it": stencil + band + asm + coarse + cg_vecs}

    # -- solve ---------------------------------------------------------------

    def solve_cg(self, b, rtol=1e-8, maxiter=500, precond="auto",
                 dispatch_chunk=None, refine="auto"):
        """Preconditioned CG in grid layout; takes and returns dof vectors.
        f32 right-hand sides solve through iterative refinement unless
        ``refine=False``. Returns (x, iterations, residual norm).

        precond:
          'auto' (default): see ``_auto_precond``.
          'asm': gather element path + overlapping cube-block additive
            Schwarz.
          'asm-fold': folded element path (dense cube/pair blocks, no
            gathers in the apply) + ASM.
          'asm2' / 'asm-fold2': the above plus the coarse lattice level.
          'pallas': the production stack: the interior-stencil kernel +
            folded band + cube-ASM + coarse level (named after the
            reference's Pallas kernel, whose place the CUDA kernel takes).
            The same path as 'asm-fold2' here: every apply reaches the
            kernel on CUDA tensors.
          'jacobi': diagonal preconditioner.

        Every preconditioner but 'jacobi' builds the band fold (the ASM
        blocks are taken from it); builds are reused across operators on a
        bitwise-equal cut (see ``_adopt_cached``). Long solves run as
        chunks of at most ``dispatch_chunk`` iterations with a
        true-residual restart between them."""
        if precond == "auto":
            precond = self._auto_precond()
        if precond not in _PRECONDS:
            raise ValueError(f"unknown precond {precond!r}")
        b = self._vector(b)
        if refine is True or (refine == "auto"
                              and b.dtype == torch.float32):
            return self._solve_ir(b, rtol, maxiter, precond, dispatch_chunk)
        bb = torch.where(self.active, b, 0.0) \
            if self.active is not None else b
        bg = self.vec_to_grid(bb)
        if precond == "jacobi":
            # single-run Jacobi PCG: trajectory-compatible with a plain
            # element-path solve
            xg, it, res = _grid_cg(*self._grid_statics(),
                                   *self._grid_arrays(), bg, rtol, maxiter)
            return xg[self.dof_to_grid], it, res
        xg, it, rr = self._inner_solve(bg, rtol, maxiter, precond,
                                       dispatch_chunk)
        return xg[self.dof_to_grid], it, np.sqrt(rr)

    def _auto_precond(self):
        """The 'auto' rule. CPU tensors: 'asm' (the cheapest build; the
        interior stencil has only its plain version there).

        CUDA tensors: 'pallas' from n = _AUTO_STACK_FROM_N on, 'asm' below.
        What was measured, on the bench step on an NVIDIA H100 80GB HBM3 at
        700 W (chip_smoke.py --compare-preconds --n72 --n90 --n108; PERF.md
        section 6 has the table): 'asm' solved faster at n = 48, 72 and 90,
        'pallas' at n = 108, in every call.
        - n = 48 (912,673 dofs), solve seconds: 'asm' 0.24-0.43 (102
          iterations), 'jacobi' 0.27-0.40 (263), 'pallas' 0.46-1.24 (87);
        - n = 72 (3,048,625 dofs): 'asm' 0.42-0.52 (133), 'pallas'
          0.87-1.02 (100), 'jacobi' 0.95-0.99 (340);
        - n = 90 (5,929,741 dofs): 'asm' 0.74-0.87 (138), 'pallas'
          0.95-1.31 (109), 'jacobi' 1.57-1.61 (309);
        - n = 108 (10,218,313 dofs): 'pallas' 0.72-1.46 (105), 'asm'
          1.41-1.79 (161), 'jacobi' 2.64-3.00 (323).
        A stack iteration is some 210 small launches and costs 5-15 ms of
        host time whatever n is; a gather-path iteration costs 2.4-3.6 ms
        at n = 48, 3.1-3.3 at n = 72, 5.4-5.7 at n = 90 and 8.2-9.7 at
        n = 108, where its segment sum over all grid rows fills the card.
        The cut lies where the two solve times, taken linear in the dof
        count between n = 90 and n = 108, cross. It is provisional: it moves once the host is
        out of the CG loop. Whether the build cache can hand the builds
        back does not enter: they cost 0.08-0.16 s at n = 48 and 0.26-0.36
        s at n = 108, less than the spread of the host-bound solves."""
        if self.device.type != "cuda":
            return "asm"
        return "pallas" if self.n >= _AUTO_STACK_FROM_N else "asm"

    def _ops(self, precond):
        """(apply, M) of the grid operator and one preconditioner, building
        (or adopting) the stages it needs."""
        st, ar = self._grid_statics(), self._grid_arrays()
        if precond == "jacobi":
            return _jacobi((*st, *ar))
        self._ensure_band_fold()     # first, so each stage logs its own time
        self._ensure_cube_asm()
        if precond == "asm":
            return _gather_asm_ops(*st, self._asm_bbox, *ar, self._asm_binv)
        if precond == "asm2":
            self._ensure_coarse()
            return _gather_asm2_ops(*st, self._asm_bbox, self._c_sel, *ar,
                                    self._asm_binv, *self._c_W,
                                    self._c_acinv)
        bf = (self._bf_diag, self._bf_fwd, self._bf_rev)
        if precond == "asm-fold":
            return _fold_ops(*st, self._asm_bbox, self._bf_bbox, *ar[:4],
                             *bf, self._asm_binv)
        self._ensure_coarse()
        return _fold2_ops(*st, self._asm_bbox, self._bf_bbox, self._c_sel,
                          *ar[:4], *bf, self._asm_binv, *self._c_W,
                          self._c_acinv)

    def _inner_solve(self, bg, rtol, maxiter, precond, dispatch_chunk):
        """Chunked solve in grid layout -> (x_grid, its, rr)."""
        return self._chunked_cg(*self._ops(precond), bg, rtol, maxiter,
                                dispatch_chunk)

    def _solve_ir(self, b, rtol, maxiter, precond, dispatch_chunk):
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
                r32, inner_rtol, min(maxiter - total_its, 400), precond,
                dispatch_chunk)
            total_its += int(its) + 1   # +1 for the outer f64 apply
            x64 = eg.double() if x64 is None else x64 + eg.double()
        if best_x64 is None:
            xf = torch.zeros_like(bg[self.dof_to_grid])
        else:
            xf = best_x64[self.dof_to_grid].float()
        return xf, total_its, np.sqrt(best_rho2)

    def _chunked_cg(self, op, M, bg, rtol, maxiter, dispatch_chunk):
        """Host loop of bounded CG chunks on the (apply, M) pair with a
        TRUE-RESIDUAL RESTART at every chunk boundary; the restart
        truncates f32 recurrence drift (the block-ASM recurrence is
        monotone in the true residual only in restarted chunks)."""
        if dispatch_chunk is None:
            dispatch_chunk = max(50, int(1.25e9 / max(self.gsize, 1)))
        chunk = max(1, min(int(dispatch_chunk), 150))
        state, rr, tol2d = _cg_first(op, M, bg, rtol, min(chunk, maxiter))
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
            x, rr, its_done = _cg_restart(op, M, bg, x, tol2, cap)
            rr_f = float(rr)
            it += int(its_done) + 1   # +1: the restart's fresh apply
            # f32 accuracy floor of the block preconditioner: if a chunk
            # diverges, NaNs, breaks down (rz <= 0 exits the loop early),
            # or stalls at full size above tolerance, finish with the
            # Jacobi recurrence (lower floor) from the best iterate
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
        op, M = self._ops("jacobi")
        x, rr_f = x0, np.inf
        best = np.inf
        retried_from_zero = False
        while it < maxiter:
            x, rr, its_done = _cg_restart(op, M, bg, x, tol2,
                                          min(chunk, maxiter - it))
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

    # -- verified-reuse build cache ------------------------------------------
    #
    # A moving-domain loop rebuilds the operator every step (re-cut ->
    # re-assemble). The fold / cube-ASM / coarse builds are pure functions
    # of a small set of device tensors (element batches, grid positions,
    # masks). Steps where the cut band did not change (a static level set,
    # a Newton or multi-rhs loop on a fixed cut) reuse the previous step's
    # builds: every build input is fingerprinted bitwise on the device and
    # the cached tensors are adopted only on an exact match. The probe is
    # one reduction pass over the inputs.

    def _build_inputs_fp(self):
        """Bitwise fingerprint of every tensor the fold/ASM/coarse builds
        consume. Memoized per operator (the inputs are immutable)."""
        if self._fp_cache is None:
            self._fp_cache = _fp_arrays(
                [self.A_local, self.cube_mask_t, self.active_grid,
                 *self.rest_mats, *self.rest_rows_grid,
                 *self.rest_cols_grid])
        return self._fp_cache

    def _cache_key(self):
        return (self.n, self.N, self.nch, tuple(self.table),
                str(self.A_local.dtype), str(self.device),
                tuple(tuple(m.shape) for m in self.rest_mats))

    def _cache_entry(self, create=False):
        key = self._cache_key()
        entry = _BUILD_CACHE.get(key)
        if entry is None and create:
            entry = _BUILD_CACHE[key] = {}
            while len(_BUILD_CACHE) > 2:   # bound device memory held
                _BUILD_CACHE.pop(next(iter(_BUILD_CACHE)))
        if entry is not None:
            _BUILD_CACHE.move_to_end(key)
        return entry

    def _adopt_cached(self, stage):
        """Adopt stage tensors from the cache iff every build input is
        bitwise identical to the operator they were built from."""
        entry = self._cache_entry()
        if not entry or stage not in entry:
            return False
        if not np.array_equal(entry["fp"], self._build_inputs_fp()):
            # the cut moved: every cached stage is stale. Drop the tensors
            # now so the rebuild does not hold two copies of the blocks.
            entry.clear()
            return False
        for name, val in entry[stage].items():
            setattr(self, name, val)
        return True

    def _store_cached(self, stage, names):
        entry = self._cache_entry(create=True)
        fp = self._build_inputs_fp()
        if "fp" in entry and not np.array_equal(entry["fp"], fp):
            entry.clear()   # inputs moved: stages must not mix origins
        entry["fp"] = fp
        vals = {name: getattr(self, name) for name in names}
        # cached tensors stay pinned across the next pass's quadrature and
        # assembly transients: a stage that would pass the budget is not
        # kept (and is rebuilt next pass)
        used = sum(_tree_nbytes(v) for k, v in entry.items()
                   if k not in ("fp", stage))
        if used + _tree_nbytes(vals) > _BUILD_CACHE_BUDGET_BYTES:
            entry.pop(stage, None)
            return
        entry[stage] = vals

    def _ensure(self, stage, built_attr, build, names):
        """Adopt ``stage`` from the cache or build and store it; log which
        and how long it took (the card is drained first, as every build
        ends drained, so stages do not hold each other's transients)."""
        if getattr(self, built_attr) is not None:
            return
        t0 = time.perf_counter()
        how = "adopted"
        if not self._adopt_cached(stage):
            how = "built"
            build()
            _sync(self.device)
            self._store_cached(stage, names)
        self.build_log[stage] = (how, time.perf_counter() - t0)

    def _ensure_band_fold(self):
        self._ensure("fold", "_bf_diag", self._build_band_fold_direct,
                     ("_bf_diag", "_bf_fwd", "_bf_rev", "_bf_bbox"))

    def _ensure_cube_asm(self):
        self._ensure("asm", "_asm_binv", self._build_cube_asm,
                     ("_asm_binv", "_asm_bbox"))

    def _ensure_coarse(self):
        self._ensure("coarse", "_c_acinv", self._build_coarse,
                     ("_c_m", "_c_K", "_c_W", "_c_sel", "_c_acinv"))

    # -- band folding: the element path as dense cube blocks -----------------

    def _slot_lut(self):
        lut = -np.ones((self.nch, 2, 2, 2), np.int64)
        for s, (ch, (dx, dy, dz)) in enumerate(self.table):
            lut[ch, dx, dy, dz] = s
        return lut

    def _instance_positions(self, rg):
        """Grid positions of one merged instance -> (ch, px, py, pz)."""
        N = self.N
        g = np.asarray(rg)
        rem = g % N ** 3
        return g // N ** 3, rem // N ** 2, (rem // N) % N, rem % N

    def _build_band_fold_direct(self):
        """Re-express the whole element path (cut cells, Nitsche surface,
        ghost-penalty facets, leftover simplices) as dense cube-block
        tensors so the operator apply has no gathers:

          A_rest = sum_c R_c^T D_c R_c
                 + sum_{c,d} R_c^T F_cd R_{c+e_d} + R_{c+e_d}^T G_cd R_c

        Every element-matrix entry (i, j) is assigned exactly once by a
        closed form evaluated on the device. With per-axis dof grid
        positions p_i, p_j:
        - |p_i - p_j| <= 1 on every axis -> diagonal block of cube
          c_a = max(max(p_i_a, p_j_a) - 1, 0) (both dofs are slots of c);
        - exactly one axis d with |delta| = 2 -> the (c, c+e_d) pair block
          with c_d = min(p_i_d, p_j_d): fwd when the column dof is the
          upper one, rev otherwise. For symmetric element matrices the rev
          claim is exactly the transposed fwd claim, so only fwd is stored
          and the apply reads it twice;
        - anything else is unassignable (raises).

        The top-cube assignment also makes _bf_diag exactly invertible
        into per-cube ASM blocks (see _asm_blocks_from_fold)."""
        n, nch = self.n, self.nch
        table = self.table
        L = len(table)
        dev = self.device
        lut = self._slot_lut()
        # per-channel per-axis offset availability; the closed form needs
        # each channel's slot offsets to be a product set O_x x O_y x O_z
        # (true for lattice dof layouts: each channel class has fixed
        # half-offset axes)
        h0 = np.zeros((nch, 3), np.int64)
        h1 = np.zeros((nch, 3), np.int64)
        for chn, off in table:
            for a, o in enumerate(off):
                (h0 if o == 0 else h1)[chn, a] = 1
        for chn in range(nch):
            have = {off for c2, off in table if c2 == chn}
            axes = [[o for o in (0, 1) if (h0, h1)[o][chn, a]]
                    for a in range(3)]
            prod = {(ox, oy, oz) for ox in axes[0] for oy in axes[1]
                    for oz in axes[2]}
            if have and have != prod:
                raise NotImplementedError(
                    "band fold: the slot table is not a product set per "
                    "channel (cutfemx_tpu falls back to its host sweep "
                    "here, which is not carried over)")
        h01 = torch.as_tensor(np.stack([h0, h1]), device=dev)
        # flat lut for device indexing; -1 slots are only reachable from
        # zero-padded elements, route them to slot 0 with their zero value
        lutf = torch.as_tensor(np.maximum(lut.reshape(-1), 0), device=dev)

        # covering bbox from per-instance position ranges (host, cheap)
        lo3, hi3 = None, np.zeros(3, np.int64)
        for rg in self._rest_rows_grid_host:
            p = np.stack([q.reshape(-1)
                          for q in self._instance_positions(rg)[1:]])
            lo = np.maximum(p.min(1) - 1, 0)
            lo3 = lo if lo3 is None else np.minimum(lo3, lo)
            hi3 = np.maximum(hi3, np.minimum(p.max(1), n - 1))
        if lo3 is None:
            lo3 = np.zeros(3, np.int64)
        # round dims up (shape-stable across small cut movements)
        org = tuple(int(v) for v in lo3)
        nb = tuple(min(-(-(int(hi3[a]) + 1 - org[a]) // 4) * 4, n - org[a])
                   for a in range(3))

        symmetric = all(
            float((Ae - Ae.transpose(-1, -2)).abs().max())
            <= 1e-6 * (float(Ae.abs().max()) + 1e-30)
            for Ae in self.rest_mats if Ae.numel())
        nkinds = 4 if symmetric else 7
        size = nb[0] * nb[1] * nb[2] * L * L
        dense = torch.zeros(nkinds * size, dtype=self.A_local.dtype,
                            device=dev)
        bad = torch.zeros((), dtype=torch.int64, device=dev)
        # elements chunked so the (E, nd, nd) assignment temporaries stay
        # bounded
        for rg, Ae in zip(self.rest_rows_grid, self.rest_mats):
            for st in range(0, len(rg), _FOLD_CHUNK):
                bad = bad + _fold_direct_device(
                    n, self.N, L, *nb, nkinds, dense, lutf, h01, org,
                    rg[st:st + _FOLD_CHUNK], Ae[st:st + _FOLD_CHUNK])
        if int(bad):
            raise RuntimeError(
                "band fold: element entries not assignable to cube/"
                "pair blocks (unexpected mesh numbering)")
        blocks = dense.view(nkinds, *nb, L, L)
        self._bf_diag = blocks[0]
        self._bf_fwd = tuple(blocks[1 + d] for d in range(3))
        self._bf_rev = (None if symmetric
                        else tuple(blocks[4 + d] for d in range(3)))
        self._bf_bbox = (*org, *nb)

    # -- cube-block additive Schwarz preconditioner --------------------------

    def _build_cube_asm(self):
        """Overlapping additive Schwarz with one block per lattice cube
        (the cube's 27 P2 / 8 P1 dofs). Blocks approximate R_c A R_c^T:

          block = [A_local if the cube is fully standard]
                + principal submatrices of every element-path element
                  (cut cells, Nitsche, ghost-penalty facets, leftover
                  simplices) folded into every cube they touch
                + exact operator diagonal (the missing neighbor-cell
                  couplings contribute at least their diagonal mass)

        Inactive slots become identity rows, blocks are inverted with an
        SPD check, and stored dense over the bounding box of covered cubes
        so the preconditioner apply is slicing + one batched matvec with no
        gathers. The element fold is always reconstructed from the band
        fold's block tensors (_asm_blocks_from_fold), which is built first
        if it is not there yet."""
        self._ensure_band_fold()
        self._finish_cube_asm(*self._asm_blocks_from_fold())

    def _asm_blocks_from_fold(self):
        """Element-path ASM fold blocks reconstructed from the band fold:
        _bf_diag assigns every same-cube entry (i, j) to the TOP cube of
        the pair's containing range (closed form in
        _build_band_fold_direct), and the pair's remaining containing
        cubes are exactly the delta in {0,1}^3 DOWN-shifts whose slot
        remap (ch, o) -> (ch, o + delta) exists in the slot table for
        both row and column slots. So the per-cube principal-submatrix
        sum over all containing cubes is

          ASM_c = sum_delta  P_delta^T  _bf_diag[c + delta]  P_delta

        with P_delta the static slot-selection map: 8 shifted
        slot-remapped adds of the fold tensor, no per-element work.
        Pair-block entries (disjoint cube ranges) never share a cube and
        correctly never contribute. The band is the set of cubes with a
        nonzero reconstructed off-diagonal (block diagonals are
        overwritten with the exact operator diagonal downstream)."""
        n = self.n
        table = self.table
        L = len(table)
        dev = self.device
        dtype = self.A_local.dtype
        x0, y0, z0, nbx, nby, nbz = self._bf_bbox
        # shifted targets extend one cube below the fold bbox
        ex0, ey0, ez0 = max(x0 - 1, 0), max(y0 - 1, 0), max(z0 - 1, 0)
        mbx = nbx + (x0 - ex0)
        mby = nby + (y0 - ey0)
        mbz = nbz + (z0 - ez0)
        sidx = {(ch, tuple(o)): s for s, (ch, o) in enumerate(table)}
        acc = torch.zeros((mbx, mby, mbz, L, L), dtype=dtype, device=dev)
        for dx in (0, 1):
            for dy in (0, 1):
                for dz in (0, 1):
                    iperm = np.zeros(L, np.int64)
                    mask = np.zeros(L)
                    for t, (ch, o) in enumerate(table):
                        src = sidx.get((ch, (o[0] - dx, o[1] - dy,
                                             o[2] - dz)))
                        if src is not None:
                            iperm[t] = src
                            mask[t] = 1.0
                    if not mask.any():
                        continue
                    sx = max(0, dx - (x0 - ex0))
                    sy = max(0, dy - (y0 - ey0))
                    sz = max(0, dz - (z0 - ez0))
                    _asm_shift_add(
                        acc, self._bf_diag,
                        torch.as_tensor(iperm, device=dev),
                        torch.as_tensor(mask, dtype=dtype, device=dev),
                        (sx, sy, sz,
                         (x0 - ex0) - dx + sx, (y0 - ey0) - dy + sy,
                         (z0 - ez0) - dz + sz,
                         nbx - sx, nby - sy, nbz - sz))
        covb = _asm_offdiag_cover(acc).reshape(-1).cpu().numpy()
        gx = np.arange(mbx) + ex0
        gy = np.arange(mby) + ey0
        gz = np.arange(mbz) + ez0
        gflat = ((gx[:, None, None] * n + gy[None, :, None]) * n
                 + gz[None, None, :]).reshape(-1)
        bsel = np.flatnonzero(covb)
        bsel = bsel[np.argsort(gflat[bsel], kind="stable")]
        band = gflat[bsel]
        blocks = acc.reshape(-1, L, L)[torch.as_tensor(bsel, device=dev)]
        return band, blocks

    def _finish_cube_asm(self, band, blocks):
        """ASM finishing: base A_local on fully-standard cubes,
        exact-diagonal overwrite, weak-slot decoupling, SPD inversion,
        dense bbox inverse tensor. ``blocks`` is consumed."""
        n, N = self.n, self.N
        table = self.table
        L = len(table)
        dev = self.device
        dtype = self.A_local.dtype
        # -- base: A_local for fully-standard cubes
        full_flat = self.cube_mask.reshape(-1)
        fb = np.flatnonzero(full_flat[band])
        if len(fb):
            blocks[torch.as_tensor(fb, device=dev)] += self.A_local

        # -- exact diagonal + active mask at each band cube's slots
        d_exact = self.diagonal_grid()
        bc = np.stack([band // (n * n), (band // n) % n, band % n], 1)
        tch = np.array([ch for ch, _ in table])
        toff = np.array([off for _, off in table])
        pos = (((tch[None, :] * N + bc[:, 0:1] + toff[None, :, 0]) * N
                + bc[:, 1:2] + toff[None, :, 1]) * N
               + bc[:, 2:3] + toff[None, :, 2])       # (B, L)
        posd = torch.as_tensor(pos, device=dev)
        d_b = d_exact[posd]
        a_b = self.active_grid[posd]
        # WEAK slots: dofs whose operator diagonal sits far below the
        # ghost-penalty-stabilized scale (true slivers / near-null
        # directions). Their block ROWS must not mix healthy residuals
        # with ~1/d amplification: that injects enormous near-null
        # components into x, whose f32 A*x roundoff then swamps the
        # residual. Weak slots keep ONLY their own diagonal.
        dmax = torch.clamp(d_exact.max(), min=1.0)
        weak = d_b <= 1e-6 * dmax
        couple = (a_b & ~weak).to(dtype)
        blocks = blocks * couple[:, :, None] * couple[:, None, :]
        blocks.diagonal(dim1=-2, dim2=-1).copy_(
            torch.where(a_b, torch.maximum(d_b, 1e-30 * dmax), 1.0))
        inv_band = _spd_inverse_device(blocks)

        # -- shared interior block: A_local + uniform exact diagonal (a
        # channel-c dof's diagonal sums dloc over every table slot of that
        # channel: one per containing cube)
        B_int = self.A_local.cpu().numpy().astype(np.float64)   # a copy
        dloc = np.diag(B_int).copy()
        B_int[np.diag_indices(L)] = [dloc[tch == tch[s]].sum()
                                     for s in range(L)]
        # rounded through f32 whatever the dtype, as cutfemx_tpu stores
        # it: both packages then hold the same preconditioner
        inv_int = torch.as_tensor(
            _spd_clamp_inverse(B_int[None])[0].astype(np.float32),
            device=dev).to(dtype)

        # -- dense inverse tensor over the covered-cube bounding box
        cov = np.zeros(n ** 3, bool)
        cov[band] = True
        cov |= full_flat
        cidx = np.flatnonzero(cov)
        cx, cy, cz = cidx // (n * n), (cidx // n) % n, cidx % n
        x0, y0, z0 = int(cx.min()), int(cy.min()), int(cz.min())
        nbx = int(cx.max()) + 1 - x0
        nby = int(cy.max()) + 1 - y0
        nbz = int(cz.max()) + 1 - z0
        ifull = np.flatnonzero(full_flat)
        lin_full = (((ifull // (n * n)) - x0) * nby
                    + (ifull // n) % n - y0) * nbz + ifull % n - z0
        lin_band = ((bc[:, 0] - x0) * nby + bc[:, 1] - y0) * nbz \
            + bc[:, 2] - z0
        dense = torch.zeros((nbx * nby * nbz, L, L), dtype=dtype,
                            device=dev)
        dense[torch.as_tensor(lin_full, device=dev)] = inv_int
        dense[torch.as_tensor(lin_band, device=dev)] = inv_band
        self._asm_binv = dense.reshape(nbx, nby, nbz, L, L)
        self._asm_bbox = (x0, y0, z0, nbx, nby, nbz)

    # -- two-level coarse space ----------------------------------------------

    def _channel_sub(self):
        """(nch, 3) dof sub-position inside its cube per channel, in
        half-lattice units (0 -> on the lattice plane, 1 -> mid-cell)."""
        sub = np.zeros((self.nch, 3), np.int64)
        for delta, ch in _EDGE_CLASS.items():
            if ch < self.nch:
                sub[ch] = delta
        return sub

    def _coarse_1d(self, m):
        """1-D coarse lattice tables for spacing m (last cell clamped).

        Returns (K, Ws, PJ, PW): K = #coarse vertices per axis, Ws = two
        dense (N, K) interpolation matrices for sub-offsets {0, 0.5},
        PJ/PW = per-point-coordinate coarse cell index and hat weights
        (PJ (N, 2) int, PW (N, 2, 2)) indexed by [point, sub-offset]."""
        K, W0, Wh, PJ, PW = _coarse_1d_tables(self.n, m)
        kw = dict(dtype=self.A_local.dtype, device=self.device)
        return K, (torch.as_tensor(W0, **kw), torch.as_tensor(Wh, **kw)), \
            PJ, PW

    def _coarse_tab3(self, m):
        """1-D hat-weight table for base-relative coarse windows:
        tab[c, sh, d, s, k] = weight of coarse vertex (c//m + k) for the
        point min(c+sh, n-1) + d + 0.5*s. Offsets stay within [0, 2]
        even for the shifted (+e_axis pair-block) cube because the point
        gap to c is < 2m for m >= 2."""
        n = self.n
        K, Ws, PJ, PW = self._coarse_1d(m)
        tab = np.zeros((n, 2, 2, 2, 3), np.float64)
        c = np.arange(n)
        base = c // m
        for sh in (0, 1):
            ce = np.minimum(c + sh, n - 1)
            for d in (0, 1):
                for s in (0, 1):
                    j = PJ[ce + d, s]
                    w = PW[ce + d, s]
                    k2 = np.stack([j - base, j + 1 - base], 1)
                    if k2.min() < 0 or k2.max() > 2:
                        raise AssertionError("coarse window wider than 3")
                    for t in range(2):
                        tab[c, sh, d, s, k2[:, t]] += w[:, t]
        return K, Ws, tab

    def _coarse_galerkin_fold(self, m):
        """Exact Galerkin coarse operator A_c = P~^T A P~ on the coarse
        trilinear lattice space, where P~ = diag(active) P and P is
        per-channel trilinear interpolation from coarse vertices to fine
        dof positions, assembled on the device from the band-fold block
        tensors + the interior stencil (the fold reproduces the element
        path exactly, and active-masking commutes through the block
        decomposition: P~^T A_rest P~ = sum_c (act W_c)^T D_c (act W_c) +
        pair terms).

        All four fold kinds accumulate (27, 27) coarse-window blocks keyed
        by ONE base-cell index per cube (windows are expressed relative to
        the unshifted cube's coarse cell, which also covers the +e_axis
        pair side), then a single conversion scatter builds the dense
        coarse matrix."""
        n, N = self.n, self.N
        table = self._grid_statics()[3]
        L = len(table)
        dev = self.device
        dt = self.A_local.dtype
        K, Ws, tab = self._coarse_tab3(m)
        tabd = torch.as_tensor(tab, dtype=dt, device=dev)
        sub = tuple(tuple(int(v) for v in row)
                    for row in self._channel_sub())
        nc = -(-n // m)
        Vc = K ** 3
        acc = torch.zeros((nc ** 3, 27, 27), dtype=dt, device=dev)
        actf = self.active_grid
        geo = (n, N, nc, m, table, sub)

        full = np.flatnonzero(self.cube_mask.reshape(-1))
        for st in range(0, len(full), _COARSE_CHUNK):
            cub = torch.as_tensor(full[st:st + _COARSE_CHUNK], device=dev)
            _coarse_fold_shared(*geo, acc, tabd, actf, cub, self.A_local)

        # band part: chunk along bbox x-planes so each block-tensor chunk
        # is a contiguous leading-axis slice (a view, no copy)
        x0, y0, z0, nbx, nby, nbz = self._bf_bbox
        jj, kk = np.meshgrid(np.arange(nby), np.arange(nbz),
                             indexing="ij")
        plane = ((y0 + jj) * n + z0 + kk).reshape(-1)
        CHX = max(1, _COARSE_CHUNK // (nby * nbz))
        sym = self._bf_rev is None
        for st in range(0, nbx, CHX):
            xs = np.arange(st, min(st + CHX, nbx))
            cub = torch.as_tensor(((x0 + xs)[:, None] * (n * n)
                                   + plane[None, :]).reshape(-1),
                                  device=dev)

            def chunk(T5):
                return T5[st:st + CHX].reshape(-1, L, L)

            _coarse_fold_diag(*geo, acc, tabd, actf, cub,
                              chunk(self._bf_diag))
            for d in range(3):
                _coarse_fold_pair(*geo, d, False, sym, acc, tabd, actf,
                                  cub, chunk(self._bf_fwd[d]))
                if not sym:
                    _coarse_fold_pair(*geo, d, True, False, acc, tabd,
                                      actf, cub, chunk(self._bf_rev[d]))
        Aflat = _coarse_acc_to_dense(nc, K, acc)
        return Aflat.reshape(Vc, Vc), K, Ws

    def _build_coarse(self, m=None):
        """Build the additive coarse-level correction P A_c^{-1} P^T of
        the two-level preconditioners. The cube-ASM blocks bound the
        high-frequency error; this bounds the global low-frequency error,
        flattening CG iteration growth in n. The spacing m is the smallest
        (>= 2) that keeps the coarse lattice at most 10000 vertices."""
        n = self.n
        if m is None:
            m = 2
            while (-(-n // m) + 1) ** 3 > 10000:
                m += 1
        self._ensure_band_fold()
        A_c, K, Ws = self._coarse_galerkin_fold(m)
        self._c_m = m
        self._c_K = K
        self._c_W = Ws
        sub = self._channel_sub()
        self._c_sel = tuple(tuple(int(v) for v in sub[ch])
                            for ch in range(self.nch))
        self._c_acinv = _dense_spd_inverse(A_c)


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


# -- deterministic scatter-add -----------------------------------------------


def _sorted_scatter_add(out, idx, vals):
    """out[idx] += vals along axis 0, duplicates summed in index order by
    a sorted segment sum (CUDA's index_add_ sums with atomics in a varying
    order). In place; idx is int64, vals has out's trailing shape."""
    if idx.numel() == 0:
        return
    order = torch.argsort(idx, stable=True)
    keys, counts = torch.unique_consecutive(idx[order], return_counts=True)
    out[keys] += torch.segment_reduce(vals[order], "sum", lengths=counts,
                                      axis=0, unsafe=True)


# -- band fold ---------------------------------------------------------------


def _fold_direct_device(n, N, L, nbx, nby, nbz, nkinds, out, lutf, h01,
                        org, rg, Ae):
    """Closed-form band fold on the device (see _build_band_fold_direct):
    every element-matrix entry (e, i, j) gets a (kind, cube, slot_row,
    slot_col) in vectorized integer arithmetic and is summed into the
    dense block tensors in one sorted pass.

    A dof's valid cubes per axis form the contiguous range
    [p - has1, p - 1 + has0] clamped to [0, n-1], where has0/has1 say
    whether the dof's channel appears in the slot table with offset 0/1
    on that axis (edge/face channels only have one). For an entry:
    ranges intersect on every axis -> diagonal block of the upper-end
    cube; ranges disjoint on exactly one axis with a one-cube step ->
    the (c, c+e_d) pair block (fwd when the column dof is the upper
    one); anything else is unassignable.

    rg: (E, nd) flat grid ids (rows == cols of the instance); Ae: (E, nd,
    nd); lutf: flat (nch*8,) slot lut (clamped >= 0); h01: (2, nch, 3)
    has0/has1 table; org: bbox origin; out: flat (nkinds * nbx*nby*nbz *
    L*L,) accumulator, updated in place. Returns the count of
    unassignable entries (0-d tensor)."""
    N3 = N * N * N
    rem = rg % N3
    ch = rg // N3
    P = (rem // (N * N), (rem // N) % N, rem % N)
    cmin = [torch.clamp(P[a] - h01[1, ch, a], min=0) for a in range(3)]
    cmax = [torch.clamp(P[a] - 1 + h01[0, ch, a], max=n - 1)
            for a in range(3)]
    dof_bad = (cmin[0] > cmax[0]) | (cmin[1] > cmax[1]) \
        | (cmin[2] > cmax[2])
    # pairwise range intersection per axis
    A = [torch.maximum(cmin[a][:, :, None], cmin[a][:, None, :])
         for a in range(3)]
    B = [torch.minimum(cmax[a][:, :, None], cmax[a][:, None, :])
         for a in range(3)]
    dis = [A[a] > B[a] for a in range(3)]
    ndis = dis[0].long() + dis[1].long() + dis[2].long()
    # disjoint axis: the lower range's top cube hosts the block; the step
    # to the other range must be exactly one cube (B is that top)
    rmax = [cmax[a][:, :, None] for a in range(3)]   # row dof range top
    gap_ok = [A[a] - B[a] == 1 for a in range(3)]
    ent_bad = (ndis > 1) | (dis[0] & ~gap_ok[0]) | (dis[1] & ~gap_ok[1]) \
        | (dis[2] & ~gap_ok[2]) | dof_bad[:, :, None] | dof_bad[:, None, :]
    axk = dis[0].long() * 1 + dis[1].long() * 2 + dis[2].long() * 3
    # rev when the ROW dof's range is the upper one on the pair axis
    rev = ((axk == 1) & (rmax[0] > B[0])) \
        | ((axk == 2) & (rmax[1] > B[1])) \
        | ((axk == 3) & (rmax[2] > B[2]))
    kind = torch.where(axk > 0, torch.where(rev, axk + 3, axk), 0)
    # block cube: the lower range's top on a disjoint axis, the
    # intersection's top otherwise: min of the range tops either way
    c = B
    ex = [(axk == 1), (axk == 2), (axk == 3)]
    # row dof lives in c (+e_d for rev); col dof in c (+e_d for fwd)
    rowc = [c[a] + (ex[a] & rev).long() for a in range(3)]
    colc = [c[a] + (ex[a] & ~rev).long() for a in range(3)]
    rowp = [p[:, :, None] for p in P]
    colp = [p[:, None, :] for p in P]

    def slot(pp, cc, chs):
        d = [torch.clamp(pp[a] - cc[a], 0, 1) for a in range(3)]
        return lutf[((chs * 2 + d[0]) * 2 + d[1]) * 2 + d[2]]

    sr = slot(rowp, rowc, ch[:, :, None])
    sc = slot(colp, colc, ch[:, None, :])
    lc = [c[a] - org[a] for a in range(3)]
    ent_bad = ent_bad | (lc[0] < 0) | (lc[0] >= nbx) | (lc[1] < 0) \
        | (lc[1] >= nby) | (lc[2] < 0) | (lc[2] >= nbz)
    lin = (lc[0] * nby + lc[1]) * nbz + lc[2]
    idx = (kind * (nbx * nby * nbz) + lin) * (L * L) + sr * L + sc
    # symmetric (nkinds == 4): rev values are implied by fwd^T and drop
    sel = (kind < nkinds) & ~ent_bad
    _sorted_scatter_add(out, idx[sel], Ae[sel])
    return ent_bad.sum()


def _blocks_matvec(B, x):
    """y = B x per block: B (..., L, L), x (..., L)."""
    return torch.matmul(B, x.unsqueeze(-1)).squeeze(-1)


def _blocks_vecmat(x, B):
    """y = B^T x per block ("...l,...lm->...m")."""
    return torch.matmul(x.unsqueeze(-2), B).squeeze(-2)


def _band_rest_apply(n, N, nch, table, bbox, Dg, Fwd, Rev, Xin):
    """Element-path apply as dense cube-block contractions (no gathers).
    Xin: masked flat grid vector. Returns the element-path contribution in
    flat grid layout.

    Works on the bounding box's window of the grid, widened by one point
    for the +e_d neighbours and zero-padded where that leaves the lattice:
    the blocks there are zero (no element has a dof beyond the lattice), so
    the padding takes the place of cutfemx_tpu's wrapping roll."""
    x0, y0, z0, nbx, nby, nbz = bbox
    X = Xin.reshape(nch, N, N, N)
    wx, wy, wz = (min(nb + 2, N - o) for nb, o in
                  ((nbx, x0), (nby, y0), (nbz, z0)))
    Xb = torch.nn.functional.pad(
        X[:, x0:x0 + wx, y0:y0 + wy, z0:z0 + wz],
        (0, nbz + 2 - wz, 0, nby + 2 - wy, 0, nbx + 2 - wx))
    Yb = torch.zeros_like(Xb)

    def stack_bbox(e):
        """Slot values of cube c + e for every bbox cube c."""
        return torch.stack(
            [Xb[ch, dx + e[0]:dx + e[0] + nbx, dy + e[1]:dy + e[1] + nby,
                dz + e[2]:dz + e[2] + nbz]
             for (ch, (dx, dy, dz)) in table], dim=-1)   # (bx, by, bz, L)

    def scatter_bbox(yc, e):
        for s, (ch, (dx, dy, dz)) in enumerate(table):
            Yb[ch, dx + e[0]:dx + e[0] + nbx, dy + e[1]:dy + e[1] + nby,
               dz + e[2]:dz + e[2] + nbz] += yc[..., s]

    rc = stack_bbox((0, 0, 0))
    y0c = _blocks_matvec(Dg, rc)
    for d in range(3):
        e = tuple(int(a == d) for a in range(3))
        # fwd blocks: rows at cube c, columns at cube c + e_d
        y0c = y0c + _blocks_matvec(Fwd[d], stack_bbox(e))
        # rev blocks: rows at c + e_d, columns at c. Rev is None for
        # symmetric operators (Rev[d] == Fwd[d]^T)
        yrev = _blocks_vecmat(rc, Fwd[d]) if Rev is None \
            else _blocks_matvec(Rev[d], rc)
        scatter_bbox(yrev, e)
    scatter_bbox(y0c, (0, 0, 0))
    Y = torch.zeros_like(X)
    Y[:, x0:x0 + wx, y0:y0 + wy, z0:z0 + wz] = Yb[:, :wx, :wy, :wz]
    return Y.reshape(-1)


def _grid_apply_fold_body(n, N, nch, table, gsize, bbox, A_local,
                          cube_mask, active_grid, identity_grid, Dg, Fwd,
                          Rev, Xf):
    """Full operator apply with the folded element path: the interior
    stencil (the kernel on CUDA tensors, its plain version on CPU tensors)
    + dense cube/pair blocks. No gathers."""
    Xin = torch.where(active_grid, Xf, 0.0)
    Yf = interior_stencil_apply(n, N, nch, table, A_local, cube_mask, Xin)
    Yf = Yf + _band_rest_apply(n, N, nch, table, bbox, Dg, Fwd, Rev, Xin)
    Yf = torch.where(active_grid, Yf, 0.0)
    return Yf + torch.where(identity_grid, Xf, 0.0)


# -- cube-block additive Schwarz ---------------------------------------------


def _asm_shift_add(acc, D, iperm, mask, sl):
    """acc[w:w+l] += slot-remapped D[s:s+l] for one ASM shift delta, in
    place: target block entry (t_r, t_c) reads source (iperm[t_r],
    iperm[t_c]), masked to slots whose remap exists (see
    _asm_blocks_from_fold)."""
    sx, sy, sz, wx, wy, wz, lx, ly, lz = sl
    Ds = D[sx:sx + lx, sy:sy + ly, sz:sz + lz]
    Dm = Ds[..., iperm, :][..., :, iperm] * (mask[:, None] * mask[None, :])
    acc[wx:wx + lx, wy:wy + ly, wz:wz + lz] += Dm


def _asm_offdiag_cover(acc):
    """(..., L, L) block tensor -> bool cover of blocks with any nonzero
    off-diagonal entry."""
    L = acc.shape[-1]
    off = acc.abs() * (1.0 - torch.eye(L, dtype=acc.dtype,
                                       device=acc.device))
    return off.sum((-1, -2)) > 0


def _spd_clamp_inverse(blocks, rel=1e-10):
    """Symmetrize, clamp eigenvalues to rel*max per block, invert (host
    numpy; guarantees SPD inverses for the additive-Schwarz sum)."""
    sym = 0.5 * (blocks + np.swapaxes(blocks, -1, -2))
    ew, Q = np.linalg.eigh(sym)
    floor = rel * np.maximum(np.abs(ew).max(axis=-1, keepdims=True), 1.0)
    ew = np.maximum(ew, floor)
    return np.einsum("bij,bj,bkj->bik", Q, 1.0 / ew, Q)


def _spd_inverse_device(blocks):
    """Batched SPD block inversion, robust at f32:

    1. symmetrize + diagonal equilibration (unit-diagonal scaling) so LU
       operates on O(1)-conditioned matrices,
    2. relative ridge,
    3. LU inverse + re-symmetrize,
    4. batched Cholesky check on the equilibrated block: any block that is
       not numerically SPD (sliver-cut cubes at large n) falls back to its
       diagonal inverse, keeping the additive-Schwarz sum SPD.

    A marginally indefinite block is worse than a weaker one: PCG
    diverges with an indefinite M. The ``_ex`` factorizations report a
    failed block in ``info`` instead of raising."""
    sym = 0.5 * (blocks + blocks.transpose(-1, -2))
    L = blocks.shape[-1]
    d = sym.diagonal(dim1=-2, dim2=-1)
    s = 1.0 / torch.sqrt(torch.clamp(d.abs(), min=1e-30))
    eq = sym * s[..., :, None] * s[..., None, :]
    eye = torch.eye(L, dtype=blocks.dtype, device=blocks.device)
    eq = eq + 1e-5 * eye
    inv_eq, info_inv = torch.linalg.inv_ex(eq)
    inv_eq = 0.5 * (inv_eq + inv_eq.transpose(-1, -2))
    _, info_chol = torch.linalg.cholesky_ex(eq - 0.5e-5 * eye)
    bad = (info_inv != 0) | (info_chol != 0) \
        | ~torch.isfinite(inv_eq).all(-1).all(-1)
    inv_eq = torch.where(bad[..., None, None], eye, inv_eq)
    return inv_eq * s[..., :, None] * s[..., None, :]


def _asm_apply_body(n, N, nch, table, bbox, Binv, active_grid, rf):
    """Additive-Schwarz preconditioner apply in flat grid layout: slice
    the residual into per-cube slot vectors over the covered-cube bounding
    box, one batched (cube, L) x (cube, L, L) contraction, slice-add back.
    Identity on slots outside the covered region."""
    x0, y0, z0, nbx, nby, nbz = bbox
    R = rf.reshape(nch, N, N, N)
    rc = torch.stack(
        [R[ch, x0 + dx:x0 + dx + nbx, y0 + dy:y0 + dy + nby,
           z0 + dz:z0 + dz + nbz] for (ch, (dx, dy, dz)) in table], dim=-1)
    zc = _blocks_vecmat(rc, Binv)
    Z = torch.zeros_like(R)
    for s, (ch, (dx, dy, dz)) in enumerate(table):
        Z[ch, x0 + dx:x0 + dx + nbx, y0 + dy:y0 + dy + nby,
          z0 + dz:z0 + dz + nbz] += zc[..., s]
    # every active dof is covered by >= 1 block; inactive slots keep r
    return torch.where(active_grid, Z.reshape(-1), rf)


# -- coarse lattice ----------------------------------------------------------


def _coarse_1d_tables(n, m):
    """Host 1-D coarse tables for an n-cube lattice with spacing m (last
    cell clamped): (K, W0, Wh, PJ, PW), see
    StencilCutOperator._coarse_1d."""
    N = n + 1
    nc = -(-n // m)
    K = nc + 1
    p = np.minimum(np.arange(K) * m, n).astype(np.float64)

    def wt(t):
        j = np.minimum(np.searchsorted(p, t, "right") - 1, nc - 1)
        w1 = (t - p[j]) / (p[j + 1] - p[j])
        return j.astype(np.int64), 1.0 - w1, w1

    Ws = []
    PJ = np.zeros((N, 2), np.int64)
    PW = np.zeros((N, 2, 2))
    for s2 in (0, 1):
        t = np.minimum(np.arange(N) + 0.5 * s2, float(n))
        j, w0, w1 = wt(t)
        W = np.zeros((N, K))
        W[np.arange(N), j] = w0
        W[np.arange(N), j + 1] = w1
        Ws.append(W)
        PJ[:, s2] = j
        PW[:, s2, 0] = w0
        PW[:, s2, 1] = w1
    return K, Ws[0], Ws[1], PJ, PW


def _coarse_windows(n, N, nc, m, table, sub, tabd, actf, cubes, masked,
                    shift=None):
    """Per-cube trilinear coarse windows relative to the UNSHIFTED cube's
    coarse base cell: (C, L, 27) weights W and (C,) flat base-cell ids
    (shift: the cube is the +e_axis side of a pair block; lattice-edge
    neighbors clamp, their blocks are zero). masked multiplies slot rows
    by the active mask (P~ = diag(active) P on the element path)."""
    dev = cubes.device
    chs = torch.tensor([ch for ch, _ in table], device=dev)
    offs = torch.tensor([off for _, off in table], device=dev)
    subs = torch.tensor(sub, device=dev)[chs]
    cx = cubes // (n * n)
    cy = (cubes // n) % n
    cz = cubes % n
    e = [int(shift == a) for a in range(3)]
    TX = tabd[cx[:, None], e[0], offs[None, :, 0], subs[None, :, 0]]
    TY = tabd[cy[:, None], e[1], offs[None, :, 1], subs[None, :, 1]]
    TZ = tabd[cz[:, None], e[2], offs[None, :, 2], subs[None, :, 2]]
    W = (TX[:, :, :, None, None] * TY[:, :, None, :, None]
         * TZ[:, :, None, None, :]).reshape(cubes.shape[0], len(table), 27)
    if masked:
        ex = torch.clamp(cx + e[0], max=n - 1)
        ey = torch.clamp(cy + e[1], max=n - 1)
        ez = torch.clamp(cz + e[2], max=n - 1)
        pos = (((chs[None, :] * N + ex[:, None] + offs[None, :, 0]) * N
                + ey[:, None] + offs[None, :, 1]) * N
               + ez[:, None] + offs[None, :, 2])
        W = W * actf[pos].to(W.dtype)[:, :, None]
    bflat = ((cx // m) * nc + cy // m) * nc + cz // m
    return W, bflat


def _coarse_fold_shared(n, N, nc, m, table, sub, acc, tabd, actf, cubes,
                        Aloc):
    """acc[base] += W_c^T A_local W_c over full interior cubes (unmasked
    windows: every dof of a full cube is active). In place."""
    W, bflat = _coarse_windows(n, N, nc, m, table, sub, tabd, actf, cubes,
                               False)
    T = torch.einsum("clk,lm->cmk", W, Aloc)
    _sorted_scatter_add(acc, bflat, torch.einsum("cmk,cmq->ckq", T, W))


def _coarse_fold_diag(n, N, nc, m, table, sub, acc, tabd, actf, cubes, M):
    """acc[base] += W_c^T D_c W_c over band cubes, active-masked."""
    W, bflat = _coarse_windows(n, N, nc, m, table, sub, tabd, actf, cubes,
                               True)
    T = torch.einsum("clk,clm->cmk", W, M)
    _sorted_scatter_add(acc, bflat, torch.einsum("cmk,cmq->ckq", T, W))


def _coarse_fold_pair(n, N, nc, m, table, sub, axis, rev, sym, acc, tabd,
                      actf, cubes, F):
    """acc[base] += a pair-block congruence: fwd blocks couple rows at
    cube c with columns at c+e_axis (rev: the transpose layout); sym also
    adds the transposed coupling (Rev = Fwd^T shortcut). Both windows
    share the unshifted cube's base, so the transpose lands in the same
    accumulator block."""
    Wr, bflat = _coarse_windows(n, N, nc, m, table, sub, tabd, actf, cubes,
                                True, shift=axis if rev else None)
    Wc, _ = _coarse_windows(n, N, nc, m, table, sub, tabd, actf, cubes,
                            True, shift=None if rev else axis)
    T = torch.einsum("clk,clm->cmk", Wr, F)
    G = torch.einsum("cmk,cmq->ckq", T, Wc)
    if sym:
        G = G + G.transpose(1, 2)
    _sorted_scatter_add(acc, bflat, G)


def _coarse_acc_to_dense(nc, K, acc):
    """(nc^3, 27, 27) base-keyed window blocks -> dense (Vc*Vc,) coarse
    matrix: one conversion scatter. Window offsets that would exceed the
    vertex lattice carry exactly-zero weights (clamp is safe)."""
    b = np.arange(nc ** 3)
    bx, by, bz = b // (nc * nc), (b // nc) % nc, b % nc
    k3 = np.stack(np.meshgrid(np.arange(3), np.arange(3), np.arange(3),
                              indexing="ij"), -1).reshape(27, 3)
    I = np.minimum(((np.minimum(bx[:, None] + k3[None, :, 0], K - 1)) * K
                    + np.minimum(by[:, None] + k3[None, :, 1], K - 1)) * K
                   + np.minimum(bz[:, None] + k3[None, :, 2], K - 1),
                   K ** 3 - 1)
    pair = torch.as_tensor((I[:, :, None] * (K ** 3)
                            + I[:, None, :]).reshape(-1), device=acc.device)
    Aflat = torch.zeros(K ** 3 * K ** 3, dtype=acc.dtype, device=acc.device)
    _sorted_scatter_add(Aflat, pair, acc.reshape(-1))
    return Aflat


def _dense_spd_inverse(A, ridge=1e-5):
    """Dense SPD inverse, robust at f32: symmetrize, unit-diagonal
    equilibration, relative ridge, invert, re-symmetrize. Dead rows
    (zero diagonal: coarse vertices with no active support) produce
    zero inverse rows, so they contribute nothing to the correction."""
    sym = 0.5 * (A + A.T)
    d = sym.diagonal()
    dead = d <= 1e-12 * torch.clamp(d.max(), min=1e-30)
    s = torch.where(dead, 0.0, 1.0 / torch.sqrt(torch.clamp(d, min=1e-30)))
    eq = sym * s[:, None] * s[None, :]
    eq = eq + ridge * torch.eye(A.shape[0], dtype=A.dtype, device=A.device)
    inv = torch.linalg.inv_ex(eq).inverse
    inv = 0.5 * (inv + inv.T)
    return inv * s[:, None] * s[None, :]


def _coarse_apply_body(N, nch, chsel, W0, Wh, Acinv, active_grid, rf):
    """Coarse correction P A_c^{-1} P^T r in flat grid layout. P is
    separable trilinear interpolation per channel (two 1-D matrices,
    sub-offset 0 / 0.5), so restriction and prolongation are three
    contractions each, batched over the channels. No gathers."""
    K = W0.shape[1]
    Ws = (W0, Wh)
    Wx, Wy, Wz = (torch.stack([Ws[chsel[ch][a]] for ch in range(nch)])
                  for a in range(3))                       # (nch, N, K)
    R = torch.where(active_grid, rf, 0.0).reshape(nch, N, N, N)
    t = torch.einsum("cxyz,czk->cxyk", R, Wz)
    t = torch.einsum("cxyk,cyj->cxjk", t, Wy)
    rc = torch.einsum("cxjk,cxi->ijk", t, Wx)
    Zc = torch.mv(Acinv, rc.reshape(-1)).reshape(K, K, K)
    t = torch.einsum("cxi,ijk->cxjk", Wx, Zc)
    t = torch.einsum("cyj,cxjk->cxyk", Wy, t)
    z = torch.einsum("czk,cxyk->cxyz", Wz, t).reshape(-1)
    return torch.where(active_grid, z, 0.0)


# -- (apply, M) pairs --------------------------------------------------------


def _gather_asm_ops(n, N, nch, table, gsize, bbox_asm, A_local, cube_mask,
                    active_grid, identity_grid, rest_mats, rest_rows,
                    rest_cols, permg, seg_lengths, Binv):
    args = (n, N, nch, table, gsize, A_local, cube_mask, active_grid,
            identity_grid, rest_mats, rest_rows, rest_cols, permg,
            seg_lengths)
    return (lambda Xf: _grid_apply_body(*args, Xf),
            lambda r: _asm_apply_body(n, N, nch, table, bbox_asm, Binv,
                                      active_grid, r))


def _two_level(n, N, nch, table, bbox_asm, chsel, active_grid, Binv, W0,
               Wh, Acinv):
    """M of the two-level preconditioners: cube-ASM + coarse correction."""
    def M(r):
        z = _asm_apply_body(n, N, nch, table, bbox_asm, Binv, active_grid,
                            r)
        return z + _coarse_apply_body(N, nch, chsel, W0, Wh, Acinv,
                                      active_grid, r)
    return M


def _gather_asm2_ops(n, N, nch, table, gsize, bbox_asm, chsel, A_local,
                     cube_mask, active_grid, identity_grid, rest_mats,
                     rest_rows, rest_cols, permg, seg_lengths, Binv, W0,
                     Wh, Acinv):
    args = (n, N, nch, table, gsize, A_local, cube_mask, active_grid,
            identity_grid, rest_mats, rest_rows, rest_cols, permg,
            seg_lengths)
    return (lambda Xf: _grid_apply_body(*args, Xf),
            _two_level(n, N, nch, table, bbox_asm, chsel, active_grid,
                       Binv, W0, Wh, Acinv))


def _fold_ops(n, N, nch, table, gsize, bbox_asm, bbox_bf, A_local,
              cube_mask, active_grid, identity_grid, Dg, Fwd, Rev, Binv):
    args = (n, N, nch, table, gsize, bbox_bf, A_local, cube_mask,
            active_grid, identity_grid, Dg, Fwd, Rev)
    return (lambda Xf: _grid_apply_fold_body(*args, Xf),
            lambda r: _asm_apply_body(n, N, nch, table, bbox_asm, Binv,
                                      active_grid, r))


def _fold2_ops(n, N, nch, table, gsize, bbox_asm, bbox_bf, chsel, A_local,
               cube_mask, active_grid, identity_grid, Dg, Fwd, Rev, Binv,
               W0, Wh, Acinv):
    args = (n, N, nch, table, gsize, bbox_bf, A_local, cube_mask,
            active_grid, identity_grid, Dg, Fwd, Rev)
    return (lambda Xf: _grid_apply_fold_body(*args, Xf),
            _two_level(n, N, nch, table, bbox_asm, chsel, active_grid,
                       Binv, W0, Wh, Acinv))


# 'pallas' is the reference's name for the stack whose interior apply is
# its kernel, 'asm-fold2' for the same stack with an einsum there. Here the
# interior-stencil wrapper picks the kernel by the tensors' device, so the two
# names are one path.
_pallas_ops = _fold2_ops


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
