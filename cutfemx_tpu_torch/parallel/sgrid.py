"""Owner-computes distributed PRODUCTION pipeline: per-slab classify ->
cut -> runtime quadrature -> element kernels feeding the distributed
grid-layout stencil solve (interior stencil + element band + cube-block
additive Schwarz + two-level coarse lattice + mixed-precision iterative
refinement) with NO serial global operator build anywhere.

The torch counterpart of ``cutfemx_tpu.parallel.sgrid``. It composes
parallel/spipeline.py (owner-computes element sets) with
parallel/gridsolver.py (distributed stencil apply/ASM) and adds the
distributed constructions of the remaining production-stack pieces:

- the cube-ASM blocks are built from a PER-SLAB closed-form diagonal band
  fold (the same entry->cube assignment as the serial
  ``_build_band_fold_direct``) with one cube-plane halo exchange (3
  ppermutes), so each slab inverts exactly its owned cubes' blocks;
- the exact operator diagonal is assembled per slab and halo-summed
  (scatter_rev(add));
- the coarse trilinear lattice operator is a sum of per-slab congruence
  folds reduced by ONE psum and inverted once per device (with every slab
  stacked on one card, once);
- iterative refinement wraps the distributed f32 CG with one f64
  distributed apply per outer step (stencil._solve_ir, distributed).

Slab layout matches ShardedStencilSolver: slab p owns lattice planes
[start_p, start_p + W_p) and the cubes starting in them; locals carry two
extra halo planes on the right; entity ownership (cell -> its cube's slab,
facet -> its first cell's slab) guarantees every element writes within
[owned | right-halo-2]. Every tensor has the slab axis first; the slabs'
per-slab plane offsets (start, width, owned cube count) are index tensors,
so the bodies take all local slabs at once. Scatters with repeated targets
are sorted segment sums (no atomics).
"""

from __future__ import annotations

import numpy as np
import torch

from ..mg import structured_lattice_info
from ..stencil import (_EDGE_CLASS, _coarse_1d_tables, _coarse_acc_to_dense,
                       _dense_spd_inverse, _local_dof_table,
                       _sorted_scatter_add, _spd_clamp_inverse,
                       _spd_inverse_device)
from .gridsolver import (_cube_scatter, _halo_accumulate, _halo_refresh,
                         _pdot, _plane_split, _sgrid_apply_body, _sgrid_cg,
                         _sgrid_precond_body, _slab_planes)
from .halo import _SlabScatter
from .spipeline import (SlabContext, _group_data, _make_plan, _pad_rows,
                        _slab_kernel)

__all__ = ["ShardedStencilProblem"]


def _grid_maps_host(V, mesh, lo, h_axes, degree):
    """Global dof <-> channel-grid maps (host metadata, the IndexMap
    role): grid_index (nch, N, N, N), valid mask, dof_to_grid (dim,)."""
    n = int(round((mesh.vertices[:, 0].max() - lo[0]) / h_axes[0]))
    N = n + 1
    nch = 8 if degree == 2 else 1
    lat = np.round((mesh.vertices - lo) / h_axes).astype(np.int64)
    grid_index = np.full((nch, N, N, N), -1, np.int64)
    grid_index[0, lat[:, 0], lat[:, 1], lat[:, 2]] = np.arange(
        mesh.num_vertices)
    if degree == 2:
        e = mesh.edges
        la, lb = lat[e[:, 0]], lat[e[:, 1]]
        origin = np.minimum(la, lb)
        delta = np.abs(lb - la)
        ch_table = np.zeros(8, np.int64)
        for d, c in _EDGE_CLASS.items():
            ch_table[d[0] * 4 + d[1] * 2 + d[2]] = c
        code = delta[:, 0] * 4 + delta[:, 1] * 2 + delta[:, 2]
        grid_index[ch_table[code], origin[:, 0], origin[:, 1],
                   origin[:, 2]] = mesh.num_vertices + np.arange(len(e))
    valid = grid_index >= 0
    flatpos = np.zeros(V.dim, np.int64)
    pos = np.argwhere(valid)
    lin = ((pos[:, 0] * N + pos[:, 1]) * N + pos[:, 2]) * N + pos[:, 3]
    flatpos[grid_index[valid]] = lin
    return grid_index, valid, flatpos


def _host_windows(PJ, PW, coords, s2, nc):
    """Trilinear coarse windows for point sets: coords/s2 are 3-tuples of
    (B, nd) int arrays (grid coords / half-offsets). Returns
    (W3 (B, nd, 27) float64, base (B,) flat coarse-cell id)."""
    B, nd = coords[0].shape
    bi = np.arange(B)[:, None]
    di = np.arange(nd)[None, :]
    us, c0s = [], []
    for a in range(3):
        ja = PJ[coords[a], s2[a]]
        wa = PW[coords[a], s2[a]]
        c0 = ja.min(axis=1) if nd else np.zeros(B, np.int64)
        pos = ja - c0[:, None]
        if pos.size and pos.max() > 1:
            raise ValueError("coarse spacing must be >= 2")
        ua = np.zeros((B, nd, 3))
        ua[bi, di, pos] = wa[..., 0]
        ua[bi, di, pos + 1] = wa[..., 1]
        us.append(ua)
        c0s.append(c0)
    W3 = (us[0][:, :, :, None, None] * us[1][:, :, None, :, None]
          * us[2][:, :, None, None, :]).reshape(B, nd, 27)
    base = (c0s[0] * nc + c0s[1]) * nc + c0s[2]
    return W3, base


class ShardedStencilProblem:
    """End-to-end distributed cut problem on a structured background:
    owner-computes assembly + the distributed production solve.

    Parameters mirror spipeline.ShardedCutProblem: ``builder(ctx)`` returns
    (a_expr, L_expr) over the slab's entity subsets (use
    spipeline.cut_poisson_builder for the flagship problem)."""

    def __init__(self, V, builder, device_mesh, axis="cells", dtype=None,
                 coarse=True):
        from ..fem import CutForm, IntegralInstance

        mesh = V.mesh
        if mesh.cell_type != "tetrahedron" or V.bs != 1 or \
                V.degree not in (1, 2):
            raise NotImplementedError(
                "ShardedStencilProblem supports scalar P1/P2 on 3D tet "
                "backgrounds")
        info = structured_lattice_info(mesh)
        if info is None:
            raise ValueError("structured background required")
        lo, n_axes, h_axes = info
        if not (n_axes == n_axes[0]).all():
            raise NotImplementedError("cubic lattice required")
        self.V = V
        self.mesh_dev = device_mesh
        self.axis = axis
        self.comm = device_mesh.comm
        dev = device_mesh.device
        self.device = dev
        nparts = device_mesh.shape[axis]
        self.nparts = nparts
        nloc = len(device_mesh.local)
        n = int(n_axes[0])
        N = n + 1
        deg = V.degree
        nch = 8 if deg == 2 else 1
        self.n, self.N, self.nch, self.degree = n, N, nch, deg
        self.table = tuple((int(ch), (int(o[0]), int(o[1]), int(o[2])))
                           for ch, o in _local_dof_table(deg))
        L = len(self.table)
        self.L = L
        put = device_mesh.put

        starts, widths = _plane_split(n, N, nparts)
        self.starts, self.widths = starts, widths
        Wmax = int(widths.max())
        Wext = Wmax + 2
        self.Wmax, self.Wext = Wmax, Wext
        ncubes = np.minimum(starts + widths, n) - starts
        self.ncubes = ncubes

        # -- cell partition by cube x-plane (assembly slabs == solve slabs)
        cube_of_cell = np.arange(mesh.num_cells) // 6
        cube_x = cube_of_cell // (n * n)
        cell_part = np.clip(
            np.searchsorted(starts, cube_x, "right") - 1, 0,
            nparts - 1).astype(np.int32)
        self.cell_part = cell_part

        # -- per-slab forms over slab-local entity subsets -----------------
        a_groups: dict = {}
        L_groups: dict = {}
        a_form_by_slab = [None] * nparts
        L_form_by_slab = [None] * nparts
        std_by_slab = [None] * nparts
        full_local = np.zeros((nparts, Wmax, n, n), bool)

        def add_L(p, L_expr):
            if L_expr is None:
                return
            Lf = CutForm(L_expr, dtype=dtype, device=dev)
            L_form_by_slab[p] = Lf
            for inst in Lf.instances:
                L_groups.setdefault(inst.origin, [None] * nparts)[p] = inst

        for p in range(nparts):
            ctx = SlabContext(mesh, cell_part, p)
            if ctx.cells.size == 0:
                continue
            a_expr, L_expr = builder(ctx)
            if a_expr is None:
                continue
            af = CutForm(a_expr, dtype=dtype, device=dev)
            a_form_by_slab[p] = af
            # standard cell instance -> interior stencil split
            std_idx = None
            for i, inst in enumerate(af.instances):
                if inst.itype == "cell" and not inst.runtime:
                    if std_idx is None or len(inst.entities) > len(
                            af.instances[std_idx].entities):
                        std_idx = i
            if std_idx is None:
                # slab entirely outside the active domain (or cut-band
                # only): every instance goes through the element path
                for inst in af.instances:
                    a_groups.setdefault(inst.origin,
                                        [None] * nparts)[p] = inst
                add_L(p, L_expr)
                continue
            std = af.instances[std_idx]
            if std.kernel.coefficients:
                raise NotImplementedError(
                    "stencil interior requires a coefficient-free "
                    "standard integrand")
            std_cells = np.asarray(std.rows_cells)[:std.n_valid]
            # owned full cubes (all 6 tets standard) — slab-local info
            count = np.zeros(n ** 3, np.int64)
            np.add.at(count, cube_of_cell[std_cells], 1)
            fullc = count == 6
            s0, nc_p = starts[p], ncubes[p]
            full_local[p, :nc_p] = fullc.reshape(n, n, n)[s0:s0 + nc_p]
            std_by_slab[p] = (std, std_cells, fullc)
            # leftover standard cells -> element path, rebuilt from mesh
            # data directly (uniform geometry)
            left = std_cells[~fullc[cube_of_cell[std_cells]]]
            insts = [inst for i, inst in enumerate(af.instances)
                     if i != std_idx]
            if len(left):
                data = dict(coords=af._tensor(mesh.cell_vertex_coords[left]),
                            h=af._tensor(mesh.cell_diameters()[left]),
                            coeffs=())
                linst = af._bucket_pad(IntegralInstance(
                    kernel=std.kernel, itype="cell", runtime=False,
                    entities=left, data=data, rows_cells=left))
                linst.origin = ("std-leftover",)
                insts.append(linst)
            for inst in insts:
                a_groups.setdefault(inst.origin, [None] * nparts)[p] = inst
            add_L(p, L_expr)
        some = next((f for f in a_form_by_slab if f is not None), None)
        if some is None:
            raise ValueError("no slab produced any integral instance")
        self.dtype = some.dtype
        if some.test_space is not some.trial_space:
            raise ValueError("test space must equal trial space")
        self._block = some.block
        self.d_cube_mask = put(full_local.astype(np.uint8))

        # -- A_local probe (one interior cube; geometry is uniform) --------
        self.A_local = self._probe_A_local(V, mesh, std_by_slab)

        # -- global dof <-> grid maps (host metadata) -----------------------
        grid_index, gvalid, d2g = _grid_maps_host(V, mesh, lo, h_axes, deg)
        self._d2g = d2g
        self._grid_index = grid_index
        self._grid_valid = gvalid

        def g2l(p, dofs):
            """Global blocked dofs -> slab-local extended flat grid ids."""
            pos = d2g[np.asarray(dofs)]
            ch = pos // N ** 3
            rem = pos % N ** 3
            lx = rem // N ** 2 - starts[p]
            if pos.size and (lx.min() < 0 or lx.max() >= Wext):
                raise ValueError(
                    "element couples dofs outside the slab window")
            return (ch * Wext + lx) * N ** 2 + rem % N ** 2

        def group_rows(insts, form_by_slab, plan):
            per_slab = [None] * nparts
            nd = None
            for p, inst in enumerate(insts):
                if inst is None:
                    continue
                f = form_by_slab[p] or some
                loc = g2l(p, np.asarray(f._entity_dofs(V, inst)))
                per_slab[p] = _pad_rows(loc, plan.E)
                nd = loc.shape[1]
            # zero-mask slabs scatter exactly-zero matrices; any in-range
            # target works — use slot 0
            return [np.zeros((plan.E, nd), np.int64) if r is None else r
                    for r in per_slab]

        def local_rows(rows):
            return np.stack([rows[p] for p in device_mesh.local])

        # -- element groups: matrices on the device per slab ----------------
        d_insts = []
        self._host_rows = []        # (plan, insts, rows-per-slab)
        gsize_l = nch * Wext * N * N
        self.gsize_l = gsize_l
        for origin in sorted(a_groups, key=str):
            insts = a_groups[origin]
            plan = _make_plan(insts)
            rows = group_rows(insts, a_form_by_slab, plan)
            A = _slab_kernel("matrix", plan,
                             _group_data(insts, plan, device_mesh),
                             self.dtype, self._block, nloc)
            D = put(rows)
            d_insts.append((A, D, D))
            self._host_rows.append((plan, insts, rows))
        self.d_insts = tuple(d_insts)
        self._scatter = _SlabScatter(
            [local_rows(r) for _, _, r in self._host_rows], gsize_l, dev)

        # -- active / identity grids (halo-consistent) ----------------------
        act = np.zeros((nparts, gsize_l), bool)
        for (plan, insts, rows) in self._host_rows:
            for p, inst in enumerate(insts):
                if inst is not None:
                    act[p][rows[p][:inst.n_valid].ravel()] = True
        # interior stencil activity: the dofs of the std instance's cells
        for p in range(nparts):
            if std_by_slab[p] is not None:
                _, std_cells, _ = std_by_slab[p]
                act[p][g2l(p, V.blocked_dofmap[std_cells]).ravel()] = True
        self.d_W = put(np.asarray(widths, np.int64))
        owned = np.zeros((nparts, 1, Wext, 1, 1), bool)
        for p in range(nparts):
            owned[p, 0, :widths[p]] = True
        self.d_owned_planes = put(owned)
        shape_l = (nloc, nch, Wext, N, N)
        d_act = self._halo_sum_grid(
            put(act.astype(np.float32)).reshape(shape_l)) > 0
        d_valid = put(_slab_planes(gvalid, starts, Wext, nparts))
        self.d_active = d_act & d_valid
        self.d_identity = d_valid & ~d_act

        # -- RHS assembled per slab on device + halo accumulation -----------
        b_local = torch.zeros((nloc, gsize_l), dtype=self.dtype, device=dev)
        for origin in sorted(L_groups, key=str):
            insts = L_groups[origin]
            plan = _make_plan(insts)
            rows = group_rows(insts, L_form_by_slab, plan)
            be = _slab_kernel("vector", plan,
                              _group_data(insts, plan, device_mesh),
                              self.dtype, (self._block[0], None), nloc)
            b_local = b_local + _SlabScatter([local_rows(rows)], gsize_l,
                                             dev)([be])
        b_local = self._halo_sum_grid(b_local.reshape(shape_l))
        self.b_local = torch.where(self.d_active, b_local, 0.0)

        # -- distributed cube-ASM build --------------------------------------
        self._build_asm_distributed()

        # -- distributed coarse level -----------------------------------------
        self.coarse = bool(coarse)
        if self.coarse:
            self._build_coarse_distributed(std_by_slab)
        self._f64 = None

    # ------------------------------------------------------------------

    def _probe_A_local(self, V, mesh, std_by_slab):
        """Local cube matrix from ONE interior full cube (translation
        invariance makes any full cube representative; mirrors
        stencil.StencilCutOperator's probe)."""
        n = self.n
        probe = None
        for p in range(self.nparts):
            if std_by_slab[p] is None:
                continue
            std, std_cells, fullc = std_by_slab[p]
            idx = np.flatnonzero(fullc)
            for c in idx:
                i, j, k = c // (n * n), (c // n) % n, c % n
                if 0 < i < n - 1 and 0 < j < n - 1 and 0 < k < n - 1:
                    probe = (std, int(c))
                    break
            if probe is None and len(idx):
                probe = (std, int(idx[0]))
            if probe is not None:
                break
        if probe is None:
            raise ValueError("no fully-standard cube found")
        std, cube = probe
        probe_cells = cube * 6 + np.arange(6)

        def t(a):
            return torch.as_tensor(a, dtype=self.dtype, device=self.device)
        data = dict(coords=t(mesh.cell_vertex_coords[probe_cells]),
                    h=t(mesh.cell_diameters()[probe_cells]), coeffs=(),
                    mask=t(np.ones(6)))
        Ae6 = std.kernel.assemble_matrix(data, self.dtype,
                                         self._block).cpu().numpy()
        # dof -> slot map of the probe cube
        origin = np.array([cube // (n * n), (cube // n) % n, cube % n])
        slot_of = {}
        for s, (ch, off) in enumerate(self.table):
            tgt = origin + np.array(off)
            if ch == 0:
                vid = ((tgt[0] * (n + 1) + tgt[1]) * (n + 1) + tgt[2])
                slot_of[vid] = s
            else:
                delta = [k for k, v in _EDGE_CLASS.items() if v == ch][0]
                a = tgt
                b = tgt + np.array(delta)
                va = ((a[0] * (n + 1) + a[1]) * (n + 1) + a[2])
                vb = ((b[0] * (n + 1) + b[1]) * (n + 1) + b[2])
                key = np.sort([va, vb])
                eidx = np.flatnonzero(
                    (mesh.edges[:, 0] == key[0])
                    & (mesh.edges[:, 1] == key[1]))[0]
                slot_of[mesh.num_vertices + eidx] = s
        A_local = np.zeros((self.L, self.L))
        bd = V.blocked_dofmap
        for tt in range(6):
            ls = [slot_of[d] for d in bd[probe_cells[tt]]]
            for a_, la in enumerate(ls):
                for b_, lb in enumerate(ls):
                    A_local[la, lb] += Ae6[tt, a_, b_]
        return t(A_local)

    # -- halo primitives on (P, nch, Wext, N, N) grids -----------------------

    def _halo_sum_grid(self, Y):
        return _halo_refresh(self, _halo_accumulate(self, Y))

    # -- distributed ASM ------------------------------------------------------

    def _build_asm_distributed(self):
        """Per-slab diag band fold + cube-plane exchange + reconstruction
        + finishing + batched inversion of OWNED cubes' blocks only."""
        n, L, nch = self.n, self.L, self.nch
        table = self.table
        put = self.mesh_dev.put
        dev = self.device
        # slot lut + per-channel axis-offset availability (closed form)
        lut = -np.ones((nch, 2, 2, 2), np.int64)
        for s, (ch, (dx, dy, dz)) in enumerate(table):
            lut[ch, dx, dy, dz] = s
        h0 = np.zeros((nch, 3), np.int64)
        h1 = np.zeros((nch, 3), np.int64)
        for chn, (dx, dy, dz) in table:
            for a, o in enumerate((dx, dy, dz)):
                (h0 if o == 0 else h1)[chn, a] = 1
        lutf = torch.as_tensor(np.maximum(lut.reshape(-1), 0), device=dev)
        h01 = torch.as_tensor(np.stack([h0, h1]), device=dev)
        d_start = put(np.asarray(self.starts, np.int64))
        d_nc = put(np.asarray(self.ncubes, np.int64))
        # shared interior inverse: A_local + uniform exact diagonal
        A_loc = self.A_local.double().cpu().numpy()
        dloc = np.diag(A_loc)
        ch_of = np.array([ch for ch, _ in table])
        B_int = A_loc.copy()
        B_int[np.diag_indices(L)] = [dloc[ch_of == ch_of[s]].sum()
                                     for s in range(L)]
        inv_int = torch.as_tensor(
            _spd_clamp_inverse(B_int[None])[0].astype(np.float32),
            dtype=self.dtype, device=dev)
        binv, covered, diag = _slab_asm_build(
            self, lutf, h01, inv_int, self.d_cube_mask.bool(), d_start,
            d_nc, self.d_active, [(A, R) for A, R, _ in self.d_insts])
        self.d_binv = binv
        self.d_covered = covered
        self.d_diag = diag    # halo-consistent exact diagonal (grid layout)

    # -- distributed coarse level ---------------------------------------------

    def _build_coarse_distributed(self, std_by_slab):
        """Per-slab congruence folds of the exact Galerkin coarse operator
        (host windows + device folds, mirroring stencil's coarse
        Galerkin), reduced by one psum and inverted once."""
        n, N, L = self.n, self.N, self.L
        nch, Wext = self.nch, self.Wext
        nparts = self.nparts
        mesh_dev = self.mesh_dev
        dev = self.device
        dt = self.dtype
        m = 2
        while (-(-n // m) + 1) ** 3 > 10000:
            m += 1
        K, W0, Wh, PJ, PW = _coarse_1d_tables(n, m)
        nc = K - 1
        self._c_m, self._c_K = m, K
        sub = np.zeros((nch, 3), np.int64)
        for delta, ch in _EDGE_CLASS.items():
            if ch < nch:
                sub[ch] = delta
        self._c_sel = tuple(tuple(int(v) for v in sub[ch])
                            for ch in range(nch))

        offs = np.array([off for _, off in self.table])
        chs = np.array([ch for ch, _ in self.table])
        s2_slot = sub[chs]                                  # (L, 3)

        # full owned cubes (shared A_local, UNMASKED — matches serial)
        full_jobs = []
        for p in range(nparts):
            if std_by_slab[p] is None:
                full_jobs.append(None)
                continue
            _, _, fullc = std_by_slab[p]
            s0, ncp = self.starts[p], self.ncubes[p]
            own = np.zeros(n ** 3, bool)
            own.reshape(n, n, n)[s0:s0 + ncp] = \
                fullc.reshape(n, n, n)[s0:s0 + ncp]
            cub = np.flatnonzero(own)
            if not len(cub):
                full_jobs.append(None)
                continue
            cpos = np.stack([cub // (n * n), (cub // n) % n, cub % n], 1)
            coords = tuple(cpos[:, a][:, None] + offs[None, :, a]
                           for a in range(3))
            s2 = tuple(np.broadcast_to(s2_slot[None, :, a],
                                       coords[a].shape) for a in range(3))
            full_jobs.append(_host_windows(PJ, PW, coords, s2, nc))

        # element groups: windows over the row position sets
        elem_jobs = []
        for (plan, insts, rows) in self._host_rows:
            per = []
            for p, inst in enumerate(insts):
                if inst is None:
                    per.append(None)
                    continue
                lids = np.asarray(rows[p], np.int64)
                ch_r = lids // (Wext * N * N)
                rem = lids % (Wext * N * N)
                xr = rem // (N * N) + self.starts[p]
                yr = (rem // N) % N
                zr = rem % N
                s2r = sub[ch_r]
                per.append(_host_windows(
                    PJ, PW, (xr, yr, zr),
                    tuple(s2r[..., a] for a in range(3)), nc))
            elem_jobs.append(per)

        def stack_job(per, shape_tail, dtp):
            """Stack per-slab job arrays ZERO-padded to the max length:
            the folds rely on zero window rows for padding slots (row-0
            replication would double-count the first cube's Galerkin
            block on every shorter slab)."""
            Emaxg = max(x.shape[0] for x in per if x is not None)
            outs = [_pad_rows(np.zeros((0,) + shape_tail) if x is None
                              else x, Emaxg, pad_value=0) for x in per]
            return mesh_dev.put(outs, dtp)

        nloc = len(mesh_dev.local)
        acc = torch.zeros((nloc * nc ** 3, 27, 27), dtype=dt, device=dev)
        off = torch.arange(nloc, device=dev)[:, None] * nc ** 3

        def fold(base, G):
            _sorted_scatter_add(acc, (base + off).reshape(-1),
                                G.reshape(-1, 27, 27))

        if any(j is not None for j in full_jobs):
            W = stack_job([None if j is None else j[0] for j in full_jobs],
                          (L, 27), dt)
            base = stack_job([None if j is None else j[1]
                              for j in full_jobs], (), torch.int64)
            T = torch.einsum("pclk,lm->pcmk", W, self.A_local)
            fold(base, torch.einsum("pcmk,pcmq->pckq", T, W))

        # element folds (active-masked rows AND columns)
        af = self.d_active.reshape(nloc, -1)
        for (A, R, _), per in zip(self.d_insts, elem_jobs):
            E = A.shape[1]
            W3 = stack_job([None if j is None else j[0] for j in per],
                           (R.shape[-1], 27), dt)
            base = stack_job([None if j is None else j[1] for j in per], (),
                             torch.int64)
            mask = torch.gather(af, 1, R.reshape(nloc, -1)).reshape(
                R.shape).to(dt)[..., None]
            W = W3[:, :E] * mask
            T = torch.einsum("pelm,pelq->pemq", A, W)
            fold(base[:, :E], torch.einsum("pemq,pemr->peqr", T, W))

        # one psum over the slabs, then the dense inverse once
        acc_sum = self.comm.psum(acc.reshape(nloc, nc ** 3, 27, 27))[0]
        Vc = K ** 3
        self._c_araw = _coarse_acc_to_dense(nc, K, acc_sum).reshape(Vc, Vc)
        self._c_acinv = _dense_spd_inverse(self._c_araw)

        # per-slab x tables for the distributed coarse apply (f32, as the
        # reference keeps them)
        WX = np.zeros((4, nparts, Wext, K))
        for p in range(nparts):
            s, w = self.starts[p], self.widths[p]
            for lx in range(Wext):
                gx = s + lx
                if gx >= N:
                    continue
                WX[2, p, lx] = W0[gx]
                WX[3, p, lx] = Wh[gx]
                if lx < w:
                    WX[0, p, lx] = W0[gx]
                    WX[1, p, lx] = Wh[gx]
        f32 = WX.astype(np.float32)
        self.d_WXr = (mesh_dev.put(f32[0]), mesh_dev.put(f32[1]))
        self.d_WXp = (mesh_dev.put(f32[2]), mesh_dev.put(f32[3]))
        self._c_Wy = (torch.as_tensor(W0, dtype=dt, device=dev),
                      torch.as_tensor(Wh, dtype=dt, device=dev))

    # -- solves ---------------------------------------------------------------

    def solve_cg(self, rtol=1e-8, maxiter=500, refine="auto"):
        """Distributed two-level (ASM + coarse) PCG with optional mixed-
        precision iterative refinement (f32 problems by default). Returns
        (x_global, its, true residual norm)."""
        bl = self.b_local
        if refine is True or (refine == "auto"
                              and bl.dtype == torch.float32):
            return self._solve_ir(bl, rtol, maxiter)
        x, it, res = _sgrid_cg(self, _sgrid_apply_body, _sgridp_precond_body,
                               bl, rtol, maxiter)
        return self.to_global(x), int(it), float(res)

    def _apply64(self, x64):
        """The f64 true-residual apply: the same matrices widened to f64."""
        if self._f64 is None:
            self._f64 = (tuple((A.double(), R, C)
                               for A, R, C in self.d_insts),
                         self.A_local.double())
        insts, A_local = self._f64
        return _sgrid_apply_body(self, x64, insts, A_local)

    def _solve_ir(self, bl, rtol, maxiter):
        """Mixed-precision IR around the distributed f32 CG (the
        distributed form of stencil._solve_ir: one f64 distributed apply
        per outer step, f32 inner corrections)."""
        b64 = bl.double()
        bb2 = float(_pdot(self, b64, b64))
        tol2 = rtol * rtol * bb2
        x64 = None
        best_x64, best_rho2 = None, bb2
        total_its = 0
        prev_rho2 = np.inf
        rho2 = bb2
        for outer in range(11):
            if outer == 0:
                r64 = b64
                rho2 = bb2
            else:
                r64 = b64 - self._apply64(x64)
                rho2 = float(_pdot(self, r64, r64))
                if np.isfinite(rho2) and rho2 < best_rho2:
                    best_x64, best_rho2 = x64, rho2
            if best_rho2 <= tol2 or total_its >= maxiter or outer == 10 \
                    or not np.isfinite(rho2) or rho2 >= 0.25 * prev_rho2:
                break
            prev_rho2 = rho2
            inner_rtol = max(1e-3, 0.5 * float(np.sqrt(
                tol2 / max(rho2, 1e-300))))
            eg, its, _ = _sgrid_cg(self, _sgrid_apply_body,
                                   _sgridp_precond_body, r64.float(),
                                   inner_rtol, min(maxiter - total_its, 400))
            total_its += int(its) + 1
            x64 = eg.double() if x64 is None else x64 + eg.double()
        xl = torch.zeros_like(bl) if best_x64 is None else \
            best_x64.to(bl.dtype)
        return self.to_global(xl), total_its, float(np.sqrt(best_rho2))

    # -- layout helpers -------------------------------------------------------

    def to_global(self, Xl):
        """Slab grid blocks -> global dof vector (host)."""
        N, nch = self.N, self.nch
        Xn = self.mesh_dev.gather(Xl)
        G = np.zeros((nch, N, N, N), Xn.dtype)
        for p in range(self.nparts):
            s, w = self.starts[p], self.widths[p]
            G[:, s:s + w] = Xn[p, :, :w]
        return G.reshape(-1)[self._d2g]

    def to_local(self, x):
        """Global dof vector -> slab grid blocks (halo valid)."""
        N, nch = self.N, self.nch
        x = np.asarray(x)
        G = np.zeros((nch, N, N, N), x.dtype)
        G.reshape(-1)[self._d2g] = x
        return self.mesh_dev.put(_slab_planes(G, self.starts, self.Wext,
                                              self.nparts), self.dtype)

    def apply_global(self, x):
        return self.to_global(_sgrid_apply_body(self, self.to_local(x)))

    def precond_global(self, r):
        return self.to_global(_sgridp_precond_body(self, self.to_local(r)))

    def b_global(self):
        return self.to_global(self.b_local)


# -- slab build bodies --------------------------------------------------------


def _slab_fold_diag(slv, lutf, h01, start, Rl, Ae, F):
    """Closed-form DIAGONAL band fold on slab-local ids, in place: every
    element entry whose dofs share a cube goes to the top cube of the
    pair's containing range (the assignment of the serial
    _build_band_fold_direct, kind 0). F: flat accumulator over every local
    slab's cube planes [-1, Wmax+2) x (n, n) x (L, L) — slab-owned elements
    reach one cube left and up to two cube planes right of the owned range
    (a facet element's upper-cell dofs sit at min+2)."""
    n, N, L = slv.n, slv.N, slv.L
    Wext, Wmax = slv.Wext, slv.Wmax
    N2 = N * N
    P = Rl.shape[0]
    ch = Rl // (Wext * N2)
    rem = Rl % (Wext * N2)
    Pp = (rem // N2 + start[:, None, None], (rem // N) % N, rem % N)
    cmin = [torch.clamp(Pp[a] - h01[1, ch, a], min=0) for a in range(3)]
    cmax = [torch.clamp(Pp[a] - 1 + h01[0, ch, a], max=n - 1)
            for a in range(3)]
    A_ = [torch.maximum(cmin[a][..., :, None], cmin[a][..., None, :])
          for a in range(3)]
    c = [torch.minimum(cmax[a][..., :, None], cmax[a][..., None, :])
         for a in range(3)]
    isect = (A_[0] <= c[0]) & (A_[1] <= c[1]) & (A_[2] <= c[2])
    rowp = [q[..., :, None] for q in Pp]
    colp = [q[..., None, :] for q in Pp]

    def slot(pp, chs):
        # entries outside every shared cube index garbage slots (clamped
        # in range); they are dropped with isect below
        code = ((chs * 2 + pp[0] - c[0]) * 2 + pp[1] - c[1]) * 2 \
            + pp[2] - c[2]
        return lutf[torch.clamp(code, 0, lutf.numel() - 1)]

    sr = slot(rowp, ch[..., :, None])
    sc = slot(colp, ch[..., None, :])
    clx = c[0] - start[:, None, None, None] + 1       # buffer plane index
    plane = (Wmax + 3) * n * n * L * L
    idx = (((clx * n + c[1]) * n + c[2]) * L + sr) * L + sc \
        + (torch.arange(P, device=Rl.device) * plane)[:, None, None, None]
    sel = isect.reshape(-1)
    _sorted_scatter_add(F, idx.reshape(-1)[sel], Ae.reshape(-1)[sel])


def _slab_asm_build(slv, lutf, h01, inv_int, cmask, start, nc_own,
                    act_grid, insts):
    """ASM build of every local slab: fold -> cube-plane exchange ->
    reconstruction -> finishing -> batched inversion. Returns (binv
    (P, Wmax, n, n, L, L), covered (P, nch, Wext, N, N) bool, diag grid
    (P, nch, Wext, N, N))."""
    n, L = slv.n, slv.L
    Wmax = slv.Wmax
    table = slv.table
    dt = slv.dtype
    comm, nparts = slv.comm, slv.nparts
    P = cmask.shape[0]
    dev = cmask.device

    # -- fold
    F = torch.zeros(P * (Wmax + 3) * n * n * L * L, dtype=dt, device=dev)
    for Ae, Rl in insts:
        _slab_fold_diag(slv, lutf, h01, start, Rl, Ae, F)
    F = F.reshape(P, Wmax + 3, n, n, L, L)

    # -- cube-plane exchange: plane 0 (global cube start-1) to the left
    # neighbor's last owned cube; planes nc_own+1, nc_own+2 (the right
    # neighbor's cubes 0 and 1) to the right
    # (each slab's planes by index tensors, in place)
    sl = torch.arange(P, device=dev)
    recv_r = comm.ppermute(F[:, 0], [(p, p - 1) for p in range(1, nparts)])
    F[:, 0] = 0.0
    F[sl, nc_own] += recv_r
    hi = (nc_own + 1)[:, None] + torch.arange(2, device=dev)     # (P, 2)
    recv_l = comm.ppermute(F[sl[:, None], hi],
                           [(p, p + 1) for p in range(nparts - 1)])
    F[sl[:, None], hi] = 0.0
    F[:, 1:3] += recv_l
    # refresh the right halo cube plane (reconstruction reads cube nc_own)
    # from the neighbor's accumulated cube 0
    F[sl, nc_own + 1] = comm.ppermute(
        F[:, 1], [(p + 1, p) for p in range(nparts - 1)])

    # owned-cube mask (lx < nc_own)
    ownc = (torch.arange(Wmax, device=dev)[None, :] < nc_own[:, None])[
        :, :, None, None]                                  # (P, Wmax, 1, 1)

    # -- exact diagonal grid: element diag from owned fold blocks + stencil
    # dloc on full cubes, halo-summed
    dloc = torch.diagonal(slv.A_local)
    Fown = torch.where(ownc[..., None, None], F[:, 1:1 + Wmax], 0.0)
    D = _cube_scatter(
        slv, torch.stack([Fown[..., s, s] + torch.where(cmask, dloc[s], 0.0)
                          for s in range(L)], dim=-1), act_grid.to(dt))
    D = _halo_refresh(slv, _halo_accumulate(slv, D))
    Dg = torch.where(act_grid, D, 1.0)

    # -- reconstruction: ASM_c = sum_delta P_d^T F[c+delta] P_d
    sidx = {(ch, tuple(o)): s for s, (ch, o) in enumerate(table)}
    acc = torch.zeros((P, Wmax, n, n, L, L), dtype=dt, device=dev)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                iperm = np.zeros(L, np.int64)
                mask = np.zeros(L)
                for t, (chn, o) in enumerate(table):
                    src = sidx.get((chn, (o[0] - dx, o[1] - dy, o[2] - dz)))
                    if src is not None:
                        iperm[t] = src
                        mask[t] = 1.0
                if not mask.any():
                    continue
                ip = torch.as_tensor(iperm, device=dev)
                mk = torch.as_tensor(mask, dtype=dt, device=dev)
                src_b = F[:, 1 + dx:1 + dx + Wmax, dy:n, dz:n]
                acc[:, :, :n - dy, :n - dz] += \
                    src_b[..., ip, :][..., :, ip] * (mk[:, None] * mk[None, :])

    # -- band cover + finishing
    eyeL = torch.eye(L, dtype=dt, device=dev)
    off = acc.abs() * (1.0 - eyeL)
    band = (off.sum((-1, -2)) > 0) & ownc                # (P, Wmax, n, n)
    fullo = cmask & ownc
    blocks = acc + torch.where(fullo[..., None, None], slv.A_local, 0.0)
    # slot gathers of the exact diagonal + active mask
    N, Wext = slv.N, slv.Wext
    tch = np.array([ch for ch, _ in table])
    tof = np.array([o for _, o in table])
    cx = np.arange(Wmax)[:, None, None, None]
    cy = np.arange(n)[None, :, None, None]
    cz = np.arange(n)[None, None, :, None]
    pos = torch.as_tensor(
        (((tch * Wext + cx + tof[:, 0]) * N + cy + tof[:, 1]) * N
         + cz + tof[:, 2]).reshape(-1), device=dev)      # (Wmax*n*n*L,)
    shape = (P, Wmax, n, n, L)
    d_b = Dg.reshape(P, -1)[:, pos].reshape(shape)
    a_b = act_grid.reshape(P, -1)[:, pos].reshape(shape)
    dmax = comm.pmax(torch.clamp(Dg.reshape(P, -1).amax(1), min=1.0))[0]
    weak = d_b <= 1e-6 * dmax
    couple = (a_b & ~weak).to(dt)
    blocks = blocks * couple[..., :, None] * couple[..., None, :]
    ii = torch.arange(L, device=dev)
    blocks[..., ii, ii] = torch.where(a_b, torch.maximum(d_b, 1e-30 * dmax),
                                      1.0)
    # invert band blocks only (identity placeholder elsewhere)
    sel = band[..., None, None]
    inv = _spd_inverse_device(torch.where(sel, blocks, eyeL).reshape(
        -1, L, L)).reshape(P, Wmax, n, n, L, L)
    binv = torch.where(sel, inv,
                       torch.where((fullo & ~band)[..., None, None],
                                   inv_int, 0.0))
    # covered slots: slots of band|full cubes, halo-consistent
    has = (band | fullo).to(dt)
    Cov = _cube_scatter(slv, has[..., None].expand(*has.shape, L),
                        act_grid.to(dt))
    covered = _halo_refresh(slv, _halo_accumulate(slv, Cov)) > 0
    return binv, covered, Dg


# -- coarse correction + the two-level preconditioner -------------------------


def _sgridp_coarse_body(slv, R):
    """Distributed coarse correction: per-slab restriction (owned planes
    only) -> psum -> one dense solve -> local prolongation."""
    K = slv._c_K
    dt = R.dtype
    Wy = tuple(w.to(dt) for w in slv._c_Wy)
    WXr = tuple(w.to(dt) for w in slv.d_WXr)
    WXp = tuple(w.to(dt) for w in slv.d_WXp)
    Rm = torch.where(slv.d_active, R, 0.0)
    rc = torch.zeros((R.shape[0], K, K, K), dtype=dt, device=R.device)
    for ch in range(slv.nch):
        sx, sy, sz = slv._c_sel[ch]
        t = torch.einsum("pxyz,zk->pxyk", Rm[:, ch], Wy[sz])
        t = torch.einsum("pxyk,yj->pxjk", t, Wy[sy])
        rc = rc + torch.einsum("pxjk,pxi->pijk", t, WXr[sx])
    rc = slv.comm.psum(rc)[0]
    Zc = torch.mv(slv._c_acinv.to(dt), rc.reshape(-1)).reshape(K, K, K)
    Z = []
    for ch in range(slv.nch):
        sx, sy, sz = slv._c_sel[ch]
        t = torch.einsum("pxi,ijk->pxjk", WXp[sx], Zc)
        t = torch.einsum("yj,pxjk->pxyk", Wy[sy], t)
        Z.append(torch.einsum("zk,pxyk->pxyz", Wy[sz], t))
    return torch.where(slv.d_active, torch.stack(Z, dim=1), 0.0)


def _sgridp_precond_body(slv, R):
    """Cube-ASM, plus the coarse correction when the problem has one."""
    z = _sgrid_precond_body(slv, R)
    if slv.coarse:
        z = z + _sgridp_coarse_body(slv, R)
    return z
