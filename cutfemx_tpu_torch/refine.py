"""Mesh refinement (host numpy): red-green marked-edge refinement of
triangle meshes, marked-edge bisection with longest-edge closure for local
tetrahedral refinement, and uniform (Bey) refinement of tetrahedra. The
torch counterpart of ``cutfemx_tpu.refine``; ``distance.adapt_mesh_to_stl``
drives it.
"""

from __future__ import annotations

import numpy as np

from .cells import CellType
from .mesh import Mesh

__all__ = ["refine_marked", "refine_uniform"]


def _edge_midpoints(mesh, edges_idx):
    ev = mesh.edges[edges_idx]
    return 0.5 * (mesh.vertices[ev[:, 0]] + mesh.vertices[ev[:, 1]])


def refine_uniform(mesh: Mesh) -> Mesh:
    if mesh.cell_type == CellType.triangle:
        return _refine_tri(mesh, np.arange(mesh.num_edges, dtype=np.int64))
    if mesh.cell_type == CellType.tetrahedron:
        return _refine_tet_uniform(mesh)
    raise NotImplementedError(
        f"refinement of {mesh.cell_type} meshes is not supported")


def refine_marked(mesh: Mesh, marked_edges) -> Mesh:
    """Conforming refinement of cells touching the marked edges."""
    marked_edges = np.asarray(marked_edges, dtype=np.int64)
    if mesh.cell_type == CellType.triangle:
        return _refine_tri(mesh, marked_edges)
    if mesh.cell_type == CellType.tetrahedron:
        return _refine_tet_marked(mesh, marked_edges)
    raise NotImplementedError(
        f"refinement of {mesh.cell_type} meshes is not supported")


def _refine_tri(mesh: Mesh, marked_edges) -> Mesh:
    """Red-green refinement: 3 marked edges -> 4 children (red); 2 -> close
    to red; 1 -> bisect (green); 0 -> keep."""
    ne = mesh.num_edges
    marked = np.zeros(ne, bool)
    marked[marked_edges] = True
    ce = mesh.cell_edges                          # (NC, 3)
    # closure: a cell with exactly 2 marked edges marks its third
    while True:
        counts = marked[ce].sum(axis=1)
        two = counts == 2
        if not two.any():
            break
        marked[ce[two].ravel()] = True

    new_vid = np.full(ne, -1, np.int64)
    midx = np.flatnonzero(marked)
    new_vid[midx] = mesh.num_vertices + np.arange(len(midx))
    verts = np.concatenate([mesh.vertices, _edge_midpoints(mesh, midx)])

    # triangle local edges (cells.py): e0=(1,2), e1=(0,2), e2=(0,1);
    # m_i = midpoint of the edge opposite vertex i
    cells_out = []
    counts = marked[ce].sum(axis=1)
    c = mesh.cells
    m = new_vid[ce]                               # (NC, 3) -1 when unsplit
    # red cells
    red = counts == 3
    if red.any():
        v0, v1, v2 = c[red, 0], c[red, 1], c[red, 2]
        m0, m1, m2 = m[red, 0], m[red, 1], m[red, 2]
        cells_out += [np.stack([v0, m2, m1], 1), np.stack([v1, m0, m2], 1),
                      np.stack([v2, m1, m0], 1), np.stack([m0, m1, m2], 1)]
    # green cells: one marked edge (opposite vertex i); bisect to vertex i
    one = counts == 1
    if one.any():
        which = np.argmax(marked[ce[one]], axis=1)
        vi = c[one, which]
        mm = m[one, which]
        # the two other vertices
        oth = np.stack([np.delete(np.arange(3), w) for w in which])
        va = c[one][np.arange(one.sum()), oth[:, 0]]
        vb = c[one][np.arange(one.sum()), oth[:, 1]]
        cells_out += [np.stack([vi, va, mm], 1), np.stack([vi, mm, vb], 1)]
    keep = counts == 0
    if keep.any():
        cells_out.append(c[keep])
    return Mesh(verts, np.concatenate(cells_out), CellType.triangle)


def _refine_tet_marked(mesh: Mesh, marked_edges) -> Mesh:
    """Local tet refinement by marked-edge bisection with longest-edge
    closure.

    Closure: every cell touching a marked edge also marks its longest
    edge, iterated to a fixpoint (monotone, terminates). Each cell is
    then recursively bisected by its highest-priority marked ORIGINAL
    edge, where priority = (length, edge key) is a GLOBAL order: two
    cells sharing a face therefore split the face's edges in the same
    relative order and produce the same face triangulation, so the
    result is conforming. Children inherit only original edges (the
    sub-edges of a bisected edge are new and unmarked), so recursion
    depth is at most 6.
    """
    ev = mesh.edges                               # (NE, 2), a < b
    ne = mesh.num_edges
    marked = np.zeros(ne, bool)
    marked[np.asarray(marked_edges, np.int64)] = True
    ce = mesh.cell_edges                          # (NC, 6)
    el = np.linalg.norm(mesh.vertices[ev[:, 1]] - mesh.vertices[ev[:, 0]],
                        axis=1)
    while True:
        has = marked[ce].any(axis=1)
        longest = ce[np.arange(len(ce)), np.argmax(el[ce], axis=1)]
        need = has & ~marked[longest]
        if not need.any():
            break
        marked[longest[need]] = True

    midx = np.flatnonzero(marked)
    mid_vid = mesh.num_vertices + np.arange(len(midx))
    verts = np.concatenate([mesh.vertices, _edge_midpoints(mesh, midx)])
    # (a, b) -> (midpoint vid, priority); priority orders longest first,
    # ties broken by the (global) vertex-pair key
    info = {}
    for e, m in zip(midx, mid_vid):
        a, b = int(ev[e, 0]), int(ev[e, 1])
        info[(a, b)] = (int(m), (float(el[e]), -a, -b))

    out = []

    def bisect(t):
        best = None
        for i in range(4):
            for j in range(i + 1, 4):
                a, b = t[i], t[j]
                k = (a, b) if a < b else (b, a)
                hit = info.get(k)
                if hit is not None and (best is None or hit[1] > best[0]):
                    best = (hit[1], i, j, hit[0])
        if best is None:
            out.append(t)
            return
        _, i, j, m = best
        t1 = list(t)
        t1[i] = m
        t2 = list(t)
        t2[j] = m
        bisect(tuple(t1))
        bisect(tuple(t2))

    has = marked[ce].any(axis=1)
    for t in mesh.cells[~has]:
        out.append((int(t[0]), int(t[1]), int(t[2]), int(t[3])))
    for t in mesh.cells[has]:
        bisect((int(t[0]), int(t[1]), int(t[2]), int(t[3])))
    cells = np.asarray(out, np.int64)
    # orient children positively (signed volume > 0)
    p0 = verts[cells[:, 0]]
    d = np.einsum("ij,ij->i",
                  np.cross(verts[cells[:, 1]] - p0, verts[cells[:, 2]] - p0),
                  verts[cells[:, 3]] - p0)
    neg = d < 0
    cells[neg] = cells[neg][:, [0, 1, 3, 2]]
    return Mesh(verts, cells, CellType.tetrahedron)


def _refine_tet_uniform(mesh: Mesh) -> Mesh:
    """Bey's red refinement: each tet -> 4 corner tets + 4 octahedron tets
    along the m02-m13 diagonal."""
    ne = mesh.num_edges
    new_vid = mesh.num_vertices + np.arange(ne)
    verts = np.concatenate([mesh.vertices,
                            _edge_midpoints(mesh, np.arange(ne))])
    c = mesh.cells
    ce = mesh.cell_edges                          # Basix order:
    # edges: (2,3),(1,3),(1,2),(0,3),(0,2),(0,1)
    m23, m13, m12, m03, m02, m01 = (new_vid[ce[:, k]] for k in range(6))
    v0, v1, v2, v3 = c[:, 0], c[:, 1], c[:, 2], c[:, 3]
    children = [
        (v0, m01, m02, m03), (v1, m01, m12, m13),
        (v2, m02, m12, m23), (v3, m03, m13, m23),
        (m01, m02, m13, m03), (m01, m02, m12, m13),
        (m02, m03, m13, m23), (m02, m12, m13, m23),
    ]
    cells = np.concatenate([np.stack(ch, 1) for ch in children])
    return Mesh(verts, cells, CellType.tetrahedron)
