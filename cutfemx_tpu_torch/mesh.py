"""Background meshes as plain arrays.

Replaces the DOLFINx mesh role the reference builds on (topology,
connectivity, facet computation — see SURVEY.md L1). Topology is computed
host-side with NumPy and cached; the torch compute path consumes vertex
coordinates and connectivity as static-shaped device arrays.

Vertex ordering inside each cell follows the Basix conventions in
``cutfemx_tpu_torch.cells``.
"""

from __future__ import annotations

import numpy as np

from .cells import CellType, reference_cell

__all__ = [
    "Mesh", "create_interval", "create_rectangle", "create_box",
    "create_unit_square", "create_unit_cube",
]


class Mesh:
    """Unstructured conforming mesh: vertices + cell-vertex connectivity."""

    def __init__(self, vertices, cells, cell_type: str):
        self.vertices = np.ascontiguousarray(vertices, dtype=np.float64)
        self.cells = np.ascontiguousarray(cells, dtype=np.int32)
        self.cell_type = cell_type
        self.ref_cell = reference_cell(cell_type)
        self.tdim = self.ref_cell.tdim
        self.gdim = self.vertices.shape[1]
        self.num_vertices = self.vertices.shape[0]
        self.num_cells = self.cells.shape[0]
        self._cache: dict = {}
        # set by the structured generators (create_rectangle/create_box):
        # (n_axes tuple, cell order "interleaved"|"blocked") — enables the
        # closed-form lattice topology path (no sort-based dedup).
        self._lattice = None

    # -- derived topology (host-side, cached) -------------------------------

    def _build_subentities(self, sub_verts_table):
        """Unique-subentity builder: closed-form lattice numbering when the
        mesh came from a structured generator, sort-based dedup otherwise.

        sub_verts_table: (n_sub_per_cell, nv_sub) local vertex indices.
        Returns (entities (NE, nv_sub) int32 — vertex lists in *sorted* global
        order, cell_entities (NC, n_sub_per_cell) int32).
        """
        if self._lattice is not None:
            uniq, ce, _ = _lattice_subentities(self, sub_verts_table)
            return uniq, ce
        return self._build_subentities_generic(sub_verts_table)

    def _build_subentities_generic(self, sub_verts_table):
        """Sort-based dedup over all per-cell subentity instances — works
        for any conforming mesh but streams NC*n_sub rows through an
        argsort (tens of seconds at 10M-dof scale; the structured path
        above replaces it with per-class arithmetic)."""
        local = np.asarray(sub_verts_table)
        nvs = local.shape[1]
        sub = self.cells[:, local].reshape(-1, nvs)  # (NC*nspc, nvs)
        sub.sort(axis=1)
        # np.unique(axis=0) falls back to void-dtype comparisons (an order
        # of magnitude slower); dedup via a scalar code (pairs) or lexsort.
        # int32 everywhere it fits: cumsum/astype on int64 are memory-bound
        # and measurably slow on this host.
        nv = int(self.num_vertices)
        if nvs == 2 or (nvs == 3 and nv ** 3 < (1 << 62)):
            # scalar-code dedup: one int64 sort instead of a multi-column
            # lexsort (each lexsort pass re-streams the key array)
            code = sub[:, 0].astype(np.int64)
            for j in range(1, nvs):
                code *= nv
                code += sub[:, j]
            order = np.argsort(code, kind="stable")
            cs = code[order]
            first = np.empty(len(cs), dtype=bool)
            first[0] = True
            np.not_equal(cs[1:], cs[:-1], out=first[1:])
        else:
            order = np.lexsort(sub.T[::-1])
            ks = sub[order]
            first = np.empty(len(ks), dtype=bool)
            first[0] = True
            np.any(ks[1:] != ks[:-1], axis=1, out=first[1:])
        uid_sorted = np.cumsum(first, dtype=np.int32)
        uid_sorted -= 1
        inv = np.empty(len(order), dtype=np.int32)
        inv[order] = uid_sorted
        uniq = np.ascontiguousarray(sub[order[first]])
        cell_entities = inv.reshape(self.num_cells, local.shape[0])
        return uniq, cell_entities

    @property
    def edges(self):
        """(NE, 2) unique edges, vertices sorted ascending."""
        self._ensure_edges()
        return self._cache["edges"]

    @property
    def cell_edges(self):
        """(NC, n_edges_per_cell) edge indices."""
        self._ensure_edges()
        return self._cache["cell_edges"]

    def _ensure_edges(self):
        if "edges" not in self._cache:
            if self.tdim == 1:
                self._cache["edges"] = np.sort(self.cells, axis=1)
                self._cache["cell_edges"] = np.arange(
                    self.num_cells, dtype=np.int32).reshape(-1, 1)
            else:
                e, ce = self._build_subentities(self.ref_cell.edges)
                self._cache["edges"] = e
                self._cache["cell_edges"] = ce

    @property
    def facets(self):
        """(NF, nv_facet) unique facets, vertices sorted ascending."""
        self._ensure_facets()
        return self._cache["facets"]

    @property
    def cell_facets(self):
        self._ensure_facets()
        return self._cache["cell_facets"]

    @property
    def facet_cells(self):
        """(NF, 2) adjacent cells, second entry -1 on the boundary.
        Ordering: lower cell index first."""
        self._ensure_facets()
        return self._cache["facet_cells"]

    @property
    def facet_local_index(self):
        """(NF, 2) local facet index within each adjacent cell (-1 unused)."""
        self._ensure_facets()
        return self._cache["facet_local_index"]

    def _ensure_facets(self):
        if "facets" in self._cache:
            return
        if self.tdim == 1:
            # facets are vertices
            nv = self.num_vertices
            facets = np.arange(nv, dtype=np.int32).reshape(-1, 1)
            cell_facets = self.cells.copy()
            fc = np.full((nv, 2), -1, np.int32)
            fl = np.full((nv, 2), -1, np.int32)
            for c in range(self.num_cells):
                for lf in range(2):
                    f = self.cells[c, lf]
                    slot = 0 if fc[f, 0] < 0 else 1
                    fc[f, slot] = c
                    fl[f, slot] = lf
            self._cache.update(facets=facets, cell_facets=cell_facets,
                               facet_cells=fc, facet_local_index=fl)
            return
        if self._lattice is not None:
            facets, cell_facets, fcfl = _lattice_facets_with_adjacency(self)
            self._cache.update(facets=facets, cell_facets=cell_facets,
                               facet_cells=fcfl[0], facet_local_index=fcfl[1])
            return
        facets, cell_facets = self._build_subentities(self.ref_cell.facets)
        nf = facets.shape[0]
        fc = np.full((nf, 2), -1, np.int32)
        fl = np.full((nf, 2), -1, np.int32)
        nfpc = cell_facets.shape[1]
        cells_rep = np.repeat(np.arange(self.num_cells, dtype=np.int32),
                              nfpc)
        fids = cell_facets.ravel()
        locals_rep = np.tile(np.arange(nfpc, dtype=np.int32),
                             self.num_cells)
        # sort by (facet, cell) so the lower cell lands in slot 0
        order = np.lexsort((cells_rep, fids))
        fids_s, cells_s, locals_s = fids[order], cells_rep[order], \
            locals_rep[order]
        first = np.ones(len(fids_s), dtype=bool)
        first[1:] = fids_s[1:] != fids_s[:-1]
        slot = np.where(first, 0, 1)
        fc[fids_s, slot] = cells_s
        fl[fids_s, slot] = locals_s
        self._cache.update(facets=facets, cell_facets=cell_facets,
                           facet_cells=fc, facet_local_index=fl)

    @property
    def exterior_facets(self):
        """Sorted indices of boundary facets."""
        return np.flatnonzero(self.facet_cells[:, 1] < 0).astype(np.int32)

    @property
    def interior_facets(self):
        return np.flatnonzero(self.facet_cells[:, 1] >= 0).astype(np.int32)

    @property
    def num_facets(self):
        return self.facets.shape[0]

    @property
    def num_edges(self):
        return self.edges.shape[0]

    # -- geometry helpers ----------------------------------------------------

    @property
    def cell_vertex_coords(self):
        """(NC, nv_cell, gdim) float64."""
        if "cvx" not in self._cache:
            self._cache["cvx"] = self.vertices[self.cells]
        return self._cache["cvx"]

    def cell_diameters(self):
        """(NC,) max inter-vertex distance per cell (matches
        ufl.CellDiameter semantics for simplices)."""
        if "hmax" not in self._cache:
            x = self.cell_vertex_coords
            # pairwise max over the few unique vertex pairs with (NC,)-sized
            # running state — the all-pairs (NC, nv, nv, gdim) broadcast is
            # a multi-GB temporary at 10M-dof scale
            nv = x.shape[1]
            h2 = np.zeros(x.shape[0])
            for i in range(nv):
                for j in range(i + 1, nv):
                    d = x[:, i] - x[:, j]
                    np.maximum(h2, np.einsum("ij,ij->i", d, d), out=h2)
            self._cache["hmax"] = np.sqrt(h2, out=h2)
        return self._cache["hmax"]

    def midpoints(self, dim=None, entities=None):
        """Midpoints of cells (default) or given entities of dimension dim."""
        if dim is None or dim == self.tdim:
            pts = self.cell_vertex_coords.mean(axis=1)
        elif dim == self.tdim - 1:
            pts = self.vertices[self.facets].mean(axis=1)
        elif dim == 1:
            pts = self.vertices[self.edges].mean(axis=1)
        elif dim == 0:
            pts = self.vertices
        else:
            raise ValueError(dim)
        if entities is not None:
            pts = pts[np.asarray(entities)]
        return pts


# -- structured lattice topology ----------------------------------------------
#
# Structured generators (create_rectangle/create_box) tile a vertex lattice
# with a fixed per-cube cell pattern, so every subentity (edge, facet) is a
# translate of one of finitely many "classes": a set of offset vectors in
# {0,1}^d relative to the componentwise-min corner of the entity. Classes
# are DISCOVERED programmatically from a tiny template mesh via the generic
# sort-based builder (no hand-maintained tables for the Freudenthal split),
# then entities of the full-size mesh are numbered class-by-class in closed
# form: base corners sweep a sub-box, ids are base-linear-index + class
# offset. This replaces an argsort over NC*n_sub rows (45M at the 10M-dof
# bench) with pure per-class arithmetic. Plays the role of DOLFINx's
# topology computation for the structured backgrounds the stencil solver uses
# (SURVEY.md L1).

_LATTICE_CACHE: dict = {}


def _vid_strides(n):
    """Vertex-id strides of the (n+1)-per-axis vertex grid, C order."""
    d = len(n)
    s = np.ones(d, np.int64)
    for a in range(d - 2, -1, -1):
        s[a] = s[a + 1] * (n[a + 1] + 1)
    return s


def _cube_strides(n):
    d = len(n)
    s = np.ones(d, np.int64)
    for a in range(d - 2, -1, -1):
        s[a] = s[a + 1] * n[a + 1]
    return s


def _vid_to_coords(v, n):
    d = len(n)
    s = _vid_strides(n)
    out = np.empty(v.shape + (d,), np.int64)
    rem = np.asarray(v, np.int64)
    for a in range(d):
        out[..., a] = rem // s[a]
        rem = rem % s[a]
    return out


def _cells_of_cube_t(ncubes, cpc, order, t):
    cubes = np.arange(ncubes, dtype=np.int64)
    if order == "interleaved":
        return cubes * cpc + t
    return t * ncubes + cubes


def _discover_entity_classes(tm, n_t, order, local_table):
    """Learn the translation-invariant subentity classes of a lattice
    complex from a template mesh (generic topology as ground truth).

    Returns (classes, cls_of, db_of):
      classes: list of (nvs, d) offset arrays, rows sorted by vid offset
      cls_of:  (cpc, n_le) class id of each (cell-in-cube, local entity)
      db_of:   (cpc, n_le, d) entity base corner relative to cube coords
    """
    d = len(n_t)
    ncubes = int(np.prod(n_t))
    cpc = tm.num_cells // ncubes
    local = np.asarray(local_table)
    n_le = len(local)
    coords = _vid_to_coords(tm.cells, n_t)  # (NC, nv_cell, d)
    classes, keys = [], {}
    cls_of = np.full((cpc, n_le), -1, np.int64)
    db_of = np.zeros((cpc, n_le, d), np.int64)
    for c in range(tm.num_cells):
        cube, t = ((c // cpc, c % cpc) if order == "interleaved"
                   else (c % ncubes, c // ncubes))
        cube_co = np.array(np.unravel_index(cube, n_t))
        for le in range(n_le):
            co = coords[c, local[le]]
            base = co.min(axis=0)
            rel = co - base
            if rel.min() < 0 or rel.max() > 1:
                raise RuntimeError("not a unit-offset lattice complex")
            # vid order == lexicographic order of offsets (strides are
            # super-increasing), identical for template and full mesh
            o = np.lexsort(rel.T[::-1])
            R = rel[o]
            key = tuple(map(tuple, R))
            q = keys.setdefault(key, len(classes))
            if q == len(classes):
                classes.append(R)
            db = base - cube_co
            if cls_of[t, le] < 0:
                cls_of[t, le] = q
                db_of[t, le] = db
            elif cls_of[t, le] != q or (db_of[t, le] != db).any():
                raise RuntimeError("lattice complex is not translation "
                                   "invariant")
    return classes, cls_of, db_of


def _lattice_meta(mesh, local_table):
    """Cached class discovery keyed by generator variant + entity table."""
    n_axes, order, variant = mesh._lattice
    d = len(n_axes)
    key = (mesh.cell_type, order, variant, d,
           tuple(map(tuple, np.asarray(local_table))))
    hit = _LATTICE_CACHE.get(key)
    if hit is not None:
        return hit
    n_t = (3,) * d
    tm = _make_template_mesh(mesh.cell_type, variant, n_t)
    meta = _discover_entity_classes(tm, n_t, order, local_table)
    _LATTICE_CACHE[key] = meta
    return meta


def _make_template_mesh(cell_type, variant, n_t):
    if len(n_t) == 3:
        tm = create_box((0.0,) * 3, (1.0,) * 3, n_t, cell_type)
    else:
        tm = create_rectangle((0.0,) * 2, (1.0,) * 2, n_t, cell_type,
                              diagonal=variant)
    tm._lattice = None  # template always goes through the generic builder
    return tm


def _class_boxes(classes, n):
    """Base-corner box dims, entity counts, and id offsets per class."""
    exts = np.array([R.max(axis=0) for R in classes])     # (Q, d)
    dims = np.asarray(n, np.int64) + 1 - exts             # (Q, d)
    counts = dims.prod(axis=1)
    starts = np.concatenate([[0], np.cumsum(counts)])
    return dims, starts


def _base_vids(dims_q, sv):
    """Vertex ids of all base corners of a class box, C order."""
    d = len(dims_q)
    bv = np.arange(dims_q[0], dtype=np.int64) * sv[0]
    for a in range(1, d):
        bv = bv[..., None] + np.arange(dims_q[a], dtype=np.int64) * sv[a]
    return bv.reshape(-1)


def _lattice_subentities(mesh, local_table):
    """Closed-form (entities, cell_entities) for a structured mesh; also
    returns the class metadata for adjacency construction."""
    n_axes, order, _ = mesh._lattice
    n = np.asarray(n_axes, np.int64)
    classes, cls_of, db_of = _lattice_meta(mesh, local_table)
    d = len(n)
    sv = _vid_strides(n)
    dims, starts = _class_boxes(classes, n)
    nvs = classes[0].shape[0]

    uniq = np.empty((int(starts[-1]), nvs), np.int32)
    for q, R in enumerate(classes):
        bv = _base_vids(dims[q], sv)
        offs = (R @ sv).astype(np.int64)                  # ascending
        uniq[starts[q]:starts[q + 1]] = (bv[:, None] + offs[None, :])

    ncubes = int(np.prod(n))
    cpc, n_le = cls_of.shape
    ce = np.empty((mesh.num_cells, n_le), np.int32)
    ccoords = np.stack(np.unravel_index(np.arange(ncubes), tuple(n)),
                       axis=1).astype(np.int64)           # (ncubes, d)
    for t in range(cpc):
        rows = _cells_of_cube_t(ncubes, cpc, order, t)
        for le in range(n_le):
            q = int(cls_of[t, le])
            b = ccoords + db_of[t, le]
            lin = b[:, 0]
            for a in range(1, d):
                lin = lin * dims[q, a] + b[:, a]
            ce[rows, le] = starts[q] + lin
    return uniq, ce, (classes, cls_of, db_of, dims, starts)


def _lattice_facets_with_adjacency(mesh):
    """Facets + (facet_cells, facet_local_index) in closed form.

    Host patterns per facet class — which (cell-in-cube, local facet,
    cube offset) pairs touch an instance — are discovered from the
    template's generic adjacency, then applied per class over the full
    mesh with boundary masking."""
    n_axes, order, variant = mesh._lattice
    n = np.asarray(n_axes, np.int64)
    d = len(n)
    facets, cell_facets, meta = _lattice_subentities(mesh,
                                                     mesh.ref_cell.facets)
    classes, cls_of, db_of, dims, starts = meta

    hosts = _lattice_facet_hosts(mesh.cell_type, order, variant, d,
                                 mesh.ref_cell.facets)

    nf = facets.shape[0]
    fc = np.full((nf, 2), -1, np.int32)
    fl = np.full((nf, 2), -1, np.int32)
    ncubes = int(np.prod(n))
    cpc = cls_of.shape[0]
    sc = _cube_strides(n)
    for q in range(len(classes)):
        ids = np.arange(starts[q], starts[q + 1])
        # base coords of every instance (C order over the class box)
        m = dims[q]
        grids = np.meshgrid(*[np.arange(m[a], dtype=np.int64)
                              for a in range(d)], indexing="ij")
        B = np.stack([g.ravel() for g in grids], axis=1)  # (count, d)
        cand = []
        for (t, lf, dd) in hosts[q]:
            cc = B + np.asarray(dd, np.int64)
            valid = np.all((cc >= 0) & (cc < n), axis=1)
            lin = (np.clip(cc, 0, None) * sc).sum(axis=1)
            cell = (lin * cpc + t if order == "interleaved"
                    else t * ncubes + lin)
            cand.append((cell.astype(np.int64), valid, lf))
        if len(cand) == 1:
            cell0, v0, lf0 = cand[0]
            fc[ids, 0] = np.where(v0, cell0, -1)
            fl[ids, 0] = np.where(v0, lf0, -1)
        else:
            (cellA, vA, lfA), (cellB, vB, lfB) = cand
            a_first = vA & (~vB | (cellA < cellB))
            fc[ids, 0] = np.where(a_first, cellA, np.where(vB, cellB, -1))
            fl[ids, 0] = np.where(a_first, lfA, np.where(vB, lfB, -1))
            both = vA & vB
            fc[ids, 1] = np.where(both, np.where(a_first, cellB, cellA), -1)
            fl[ids, 1] = np.where(both, np.where(a_first, lfB, lfA), -1)
    return facets, cell_facets, (fc, fl)


def _lattice_facet_hosts(cell_type, order, variant, d, local_table):
    """Per facet class: the (cell-in-cube, local facet, cube-offset) pairs
    hosting an interior instance, learned from a template mesh."""
    key = ("hosts", cell_type, order, variant, d)
    hit = _LATTICE_CACHE.get(key)
    if hit is not None:
        return hit
    n_t = (3,) * d
    tm = _make_template_mesh(cell_type, variant, n_t)
    classes, cls_of, db_of = _discover_entity_classes(tm, n_t, order,
                                                      local_table)
    tfacets, tcf = tm._build_subentities_generic(local_table)
    ncubes = int(np.prod(n_t))
    cpc = tm.num_cells // ncubes
    # hosts of each template facet
    inst_hosts = [[] for _ in range(tfacets.shape[0])]
    for c in range(tm.num_cells):
        for lf in range(tcf.shape[1]):
            inst_hosts[tcf[c, lf]].append((c, lf))
    # classify each template facet, keep the max-host pattern per class
    coords = _vid_to_coords(tfacets, n_t)                 # (NF, nvs, d)
    base = coords.min(axis=1)                             # (NF, d)
    patterns = [None] * len(classes)
    for f in range(tfacets.shape[0]):
        rel = coords[f] - base[f]
        o = np.lexsort(rel.T[::-1])
        key_f = tuple(map(tuple, rel[o]))
        q = next(i for i, R in enumerate(classes)
                 if tuple(map(tuple, R)) == key_f)
        pat = []
        for (c, lf) in inst_hosts[f]:
            cube, t = ((c // cpc, c % cpc) if order == "interleaved"
                       else (c % ncubes, c // ncubes))
            cube_co = np.array(np.unravel_index(cube, n_t))
            pat.append((int(t), int(lf), tuple(cube_co - base[f])))
        pat.sort()
        if patterns[q] is None or len(pat) > len(patterns[q]):
            patterns[q] = pat
        elif len(pat) == len(patterns[q]) and pat != patterns[q]:
            raise RuntimeError("inconsistent facet host patterns")
    _LATTICE_CACHE[key] = patterns
    return patterns


# -- generators --------------------------------------------------------------


def create_interval(n, a=0.0, b=1.0):
    x = np.linspace(a, b, n + 1).reshape(-1, 1)
    cells = np.stack([np.arange(n), np.arange(1, n + 1)], axis=1)
    return Mesh(x, cells, CellType.interval)


def _grid_vertices_2d(p0, p1, nx, ny):
    x = np.linspace(p0[0], p1[0], nx + 1)
    y = np.linspace(p0[1], p1[1], ny + 1)
    X, Y = np.meshgrid(x, y, indexing="ij")
    return np.stack([X.ravel(), Y.ravel()], axis=-1)


def create_rectangle(p0, p1, n, cell_type=CellType.triangle,
                     diagonal="right"):
    """Rectangle mesh matching dolfinx.mesh.create_rectangle semantics."""
    nx, ny = n
    verts = _grid_vertices_2d(p0, p1, nx, ny)

    def vid(i, j):
        return i * (ny + 1) + j

    I, J = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    v00 = vid(I, J).ravel()
    v10 = vid(I + 1, J).ravel()
    v01 = vid(I, J + 1).ravel()
    v11 = vid(I + 1, J + 1).ravel()
    if cell_type == CellType.quadrilateral:
        cells = np.stack([v00, v10, v01, v11], axis=1)
        m = Mesh(verts, cells, cell_type)
        m._lattice = ((nx, ny), "interleaved", "quad")
        return m
    if diagonal == "right":
        t1 = np.stack([v00, v10, v11], axis=1)
        t2 = np.stack([v00, v11, v01], axis=1)
    elif diagonal == "left":
        t1 = np.stack([v00, v10, v01], axis=1)
        t2 = np.stack([v10, v11, v01], axis=1)
    elif diagonal == "crossed":
        raise NotImplementedError("crossed diagonal not supported")
    else:
        raise ValueError(diagonal)
    cells = np.concatenate([t1, t2], axis=0)
    m = Mesh(verts, cells, CellType.triangle)
    m._lattice = ((nx, ny), "blocked", diagonal)
    return m


def create_box(p0, p1, n, cell_type=CellType.tetrahedron):
    nx, ny, nz = n
    x = np.linspace(p0[0], p1[0], nx + 1)
    y = np.linspace(p0[1], p1[1], ny + 1)
    z = np.linspace(p0[2], p1[2], nz + 1)
    X, Y, Z = np.meshgrid(x, y, z, indexing="ij")
    verts = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=-1)

    def vid(i, j, k):
        return (i * (ny + 1) + j) * (nz + 1) + k

    I, J, K = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                          indexing="ij")
    c = [vid(I + di, J + dj, K + dk).ravel()
         for dk in (0, 1) for dj in (0, 1) for di in (0, 1)]
    # hex vertex order (Basix): (0,0,0),(1,0,0),(0,1,0),(1,1,0),
    #                           (0,0,1),(1,0,1),(0,1,1),(1,1,1)
    v = [c[0], c[1], c[2], c[3], c[4], c[5], c[6], c[7]]
    if cell_type == CellType.hexahedron:
        cells = np.stack(v, axis=1)
        m = Mesh(verts, cells, cell_type)
        m._lattice = ((nx, ny, nz), "interleaved", "hex")
        return m
    # Freudenthal split of each cube into 6 tets along the 0-7 diagonal;
    # faces of adjacent cubes match because each square face is split along
    # the diagonal containing its lexicographically extreme corners.
    split = reference_cell(CellType.hexahedron).simplex_split
    vs = np.stack(v, axis=1)  # (ncubes, 8)
    cells = vs[:, split].reshape(-1, 4)
    m = Mesh(verts, cells, CellType.tetrahedron)
    m._lattice = ((nx, ny, nz), "interleaved", "freudenthal")
    return m


def create_unit_square(n, cell_type=CellType.triangle):
    return create_rectangle((0.0, 0.0), (1.0, 1.0), (n, n), cell_type)


def create_unit_cube(n, cell_type=CellType.tetrahedron):
    return create_box((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), (n, n, n), cell_type)
