"""STL ingestion, the cell -> triangle candidate map and exact
point-segment / point-triangle distances.

The torch counterpart of ``cutfemx_tpu.distance.stl``. Reading, welding,
orientation and the cell-triangle map are host numpy (preprocessing); the
binary record parser and the separating-axis narrow phase run in the port's
native library (``native.py``). The distance functions are torch functions
on any device.
"""

from __future__ import annotations

import struct
from collections import defaultdict
from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["TriSoup", "read_stl", "write_stl", "stl_bbox",
           "distribute_stl", "build_cell_triangle_map", "CellTriangleMap",
           "point_triangle_distance", "point_segment_distance",
           "orient_surface", "OrientDiagnostics"]


@dataclass
class TriSoup:
    """Triangle soup: vertices, triangles, unit facet normals and global
    triangle ids (host numpy)."""
    X: np.ndarray        # (nv, 3) vertices
    tri: np.ndarray      # (nt, 3) vertex indices
    N: np.ndarray        # (nt, 3) facet normals
    tri_gid: np.ndarray  # (nt,) global triangle ids

    @property
    def num_triangles(self):
        return self.tri.shape[0]

    def triangle_coords(self):
        return self.X[self.tri]       # (nt, 3, 3)

    def bbox(self):
        return self.X.min(axis=0), self.X.max(axis=0)


def read_stl(path) -> TriSoup:
    """Binary or ASCII STL reader."""
    with open(path, "rb") as f:
        head = f.read(5)
    if head == b"solid":
        # a binary file may also start with 'solid': look for 'facet'
        with open(path, "rb") as f:
            content = f.read()
        if b"facet" in content[:1000]:
            return _read_ascii(content.decode("ascii", errors="ignore"))
    return _read_binary(path)


def _read_binary(path):
    from ..native import parse_stl_records
    with open(path, "rb") as f:
        f.read(80)
        (nt,) = struct.unpack("<I", f.read(4))
        data = np.frombuffer(f.read(nt * 50), dtype=np.uint8)
    if data.size != nt * 50:
        raise ValueError("truncated binary STL")
    normals, verts = parse_stl_records(data)
    return _weld(verts, normals)


def _read_ascii(text):
    verts, normals = [], []
    cur_n = None
    for line in text.splitlines():
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "facet" and len(parts) >= 5:
            cur_n = [float(parts[2]), float(parts[3]), float(parts[4])]
        elif parts[0] == "vertex":
            verts.append([float(parts[1]), float(parts[2]),
                          float(parts[3])])
            if len(verts) % 3 == 0:
                normals.append(cur_n or [0.0, 0.0, 0.0])
    return _weld(np.asarray(verts).reshape(-1, 3, 3), np.asarray(normals))


def _weld(verts, normals):
    """Merge coincident vertices (quantised to 1e-12 of the extent) and
    orient the stored normals with the geometric winding; missing or zero
    normals are taken from the geometry."""
    nt = verts.shape[0]
    flat = verts.reshape(-1, 3)
    scale = max(np.abs(flat).max(), 1.0)
    key = np.round(flat / scale * 1e12).astype(np.int64)
    uniq, inv = np.unique(key, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    X = np.zeros((len(uniq), 3))
    X[inv] = flat
    tri = inv.reshape(nt, 3).astype(np.int32)
    e1 = X[tri[:, 1]] - X[tri[:, 0]]
    e2 = X[tri[:, 2]] - X[tri[:, 0]]
    geo_n = np.cross(e1, e2)
    norm = np.linalg.norm(geo_n, axis=1, keepdims=True)
    geo_n = geo_n / np.maximum(norm, 1e-300)
    nn = np.linalg.norm(normals, axis=1, keepdims=True)
    N = np.where(nn > 1e-12, normals / np.maximum(nn, 1e-300), geo_n)
    flip = np.einsum("ij,ij->i", N, geo_n) < 0
    N = np.where(flip[:, None], -N, N)
    return TriSoup(X, tri, N, np.arange(nt, dtype=np.int64))


@dataclass
class OrientDiagnostics:
    """Orientation pass report."""
    n_components: int
    n_flipped: int
    n_boundary_edges: int
    n_nonmanifold_edges: int
    component_of: np.ndarray


def orient_surface(soup: TriSoup):
    """Orient each connected component consistently (a depth-first walk
    over the edge adjacency that flips a neighbour whose shared edge runs
    the same way) and report manifoldness diagnostics.

    Returns (oriented TriSoup, OrientDiagnostics)."""
    tri = soup.tri.copy()
    nt = len(tri)
    edge_tris = defaultdict(list)
    for t in range(nt):
        a, b, c = tri[t]
        for (u, v) in ((a, b), (b, c), (c, a)):
            edge_tris[(min(u, v), max(u, v))].append(t)
    nonmanifold = sum(1 for lst in edge_tris.values() if len(lst) > 2)
    boundary = sum(1 for lst in edge_tris.values() if len(lst) == 1)

    def runs(tt, u, v):
        x, y, z = tri[tt]
        return (u, v) in ((x, y), (y, z), (z, x))

    comp = np.full(nt, -1, np.int64)
    flipped = np.zeros(nt, bool)
    ncomp = 0
    for seed in range(nt):
        if comp[seed] >= 0:
            continue
        comp[seed] = ncomp
        stack = [seed]
        while stack:
            t = stack.pop()
            a, b, c = tri[t]
            for (u, v) in ((a, b), (b, c), (c, a)):
                lst = edge_tris[(min(u, v), max(u, v))]
                if len(lst) != 2:
                    continue
                for t2 in lst:
                    if t2 == t or comp[t2] >= 0:
                        continue
                    if runs(t2, u, v):
                        tri[t2] = tri[t2][[0, 2, 1]]
                        flipped[t2] = True
                    comp[t2] = ncomp
                    stack.append(t2)
        ncomp += 1

    e1 = soup.X[tri[:, 1]] - soup.X[tri[:, 0]]
    e2 = soup.X[tri[:, 2]] - soup.X[tri[:, 0]]
    N = np.cross(e1, e2)
    N /= np.maximum(np.linalg.norm(N, axis=1, keepdims=True), 1e-300)
    out = TriSoup(soup.X, tri, N, soup.tri_gid)
    return out, OrientDiagnostics(ncomp, int(flipped.sum()), boundary,
                                  nonmanifold, comp)


def write_stl(path, soup: TriSoup):
    """Binary STL writer."""
    nt = soup.num_triangles
    rec = np.zeros(nt, dtype=[("n", "<f4", 3), ("v", "<f4", (3, 3)),
                              ("attr", "<u2")])
    rec["n"] = soup.N
    rec["v"] = soup.triangle_coords()
    with open(path, "wb") as f:
        f.write(b"\0" * 80)
        f.write(struct.pack("<I", nt))
        f.write(rec.tobytes())


def stl_bbox(path):
    return read_stl(path).bbox()


def distribute_stl(mesh, path_or_soup, padding=0.0):
    """The soup of one process: every triangle whose box meets the padded
    mesh box (all of them when none is outside)."""
    soup = path_or_soup if isinstance(path_or_soup, TriSoup) else \
        read_stl(path_or_soup)
    lo = mesh.vertices.min(axis=0) - padding
    hi = mesh.vertices.max(axis=0) + padding
    tc = soup.triangle_coords()
    keep = ((tc.max(axis=1) >= lo) & (tc.min(axis=1) <= hi)).all(axis=1)
    if keep.all():
        return soup
    return TriSoup(soup.X, soup.tri[keep], soup.N[keep],
                   soup.tri_gid[keep])


@dataclass
class CellTriangleMap:
    """CSR cell -> candidate triangles."""
    offsets: np.ndarray    # (num_cells+1,)
    triangles: np.ndarray  # (nnz,)

    def cells_with_triangles(self):
        return np.flatnonzero(np.diff(self.offsets) > 0).astype(np.int32)

    def links(self, cell):
        return self.triangles[self.offsets[cell]:self.offsets[cell + 1]]


def build_cell_triangle_map(mesh, soup: TriSoup, padding=0.0,
                            narrow=True) -> CellTriangleMap:
    """AABB broad phase + separating-axis narrow phase. Each cell's
    triangles keep the reference's order (by the first shared bin of 64
    along x, then by triangle)."""
    tc = soup.triangle_coords()
    tlo = tc.min(axis=1) - padding
    thi = tc.max(axis=1) + padding
    cv = mesh.cell_vertex_coords
    clo = cv.min(axis=1)
    chi = cv.max(axis=1)
    pairs_c, pairs_t = _aabb_pairs(clo, chi, tlo, thi)
    if narrow and len(pairs_c):
        keep = _tri_cell_overlap(cv[pairs_c], tc[pairs_t])
        pairs_c, pairs_t = pairs_c[keep], pairs_t[keep]
    counts = np.bincount(pairs_c, minlength=mesh.num_cells)
    offsets = np.zeros(mesh.num_cells + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    return CellTriangleMap(offsets, pairs_t.astype(np.int64))


def _aabb_pairs(clo, chi, tlo, thi, bins=64):
    """Every (cell, triangle) pair whose boxes overlap, ordered by cell,
    then by the first of 64 bins along x that both boxes meet, then by
    triangle.

    A uniform 3D grid, each bin at least one cell box wide, finds the
    candidates: a cell sits in the bin of its lower corner, so it meets
    bins up to one above it per axis, and a triangle is offered to every
    bin from two below its lower corner to one above its upper one (one
    bin of slack either way against rounding). The exact box test then
    keeps precisely the overlapping pairs."""
    empty = (np.zeros(0, np.int64),) * 2
    if not len(clo) or not len(tlo):
        return empty
    g = clo.shape[1]
    dlo = np.minimum(clo.min(axis=0), tlo.min(axis=0))
    ext = np.maximum((chi - clo).max(axis=0), 1e-300)
    w = ext * (1.0 + 1e-9)
    nb = np.maximum(np.ceil((np.maximum(chi.max(axis=0), thi.max(axis=0))
                             - dlo) / w).astype(np.int64) + 4, 1)

    def bin_of(x):
        return np.floor((x - dlo) / w).astype(np.int64) + 2

    strides = np.cumprod(np.concatenate([[1], nb[:-1]]))
    ckey = bin_of(clo) @ strides
    corder = np.argsort(ckey, kind="stable")
    ckey_sorted = ckey[corder]
    t0 = bin_of(tlo) - 2
    t1 = bin_of(thi) + 1
    span = t1 - t0 + 1                                   # (T, g)
    nbins_t = span.prod(axis=1)
    tri_ids = np.repeat(np.arange(len(tlo)), nbins_t)
    local = np.arange(nbins_t.sum()) - np.repeat(
        np.cumsum(nbins_t) - nbins_t, nbins_t)
    key = np.zeros_like(local)
    rem = local
    for k in range(g):
        sk = span[tri_ids, k]
        key += (t0[tri_ids, k] + rem % sk) * strides[k]
        rem = rem // sk
    lo_i = np.searchsorted(ckey_sorted, key, "left")
    hi_i = np.searchsorted(ckey_sorted, key, "right")
    cnt = hi_i - lo_i
    if not cnt.sum():
        return empty
    T = np.repeat(tri_ids, cnt)
    pos = np.arange(cnt.sum()) - np.repeat(np.cumsum(cnt) - cnt, cnt) \
        + np.repeat(lo_i, cnt)
    C = corder[pos]
    ok = ((clo[C] <= thi[T]) & (tlo[T] <= chi[C])).all(axis=1)
    C, T = C[ok], T[ok]
    # the reference's order: 1D bins along x, a pair in its first shared
    x_lo = min(clo[:, 0].min(), tlo[:, 0].min())
    width = max(max(chi[:, 0].max(), thi[:, 0].max()) - x_lo, 1e-300)

    def xbin(x):
        return np.clip(((x - x_lo) / width * bins).astype(int), 0, bins - 1)

    first = np.maximum(xbin(clo[C, 0]), xbin(tlo[T, 0]))
    order = np.lexsort((T, first, C))
    return C[order].astype(np.int64), T[order].astype(np.int64)


def _tri_cell_overlap(cells, tris):
    """Separating-axis overlap flags of convex cells (their vertex sets,
    (M, nv, 3)) against triangles ((M, 3, 3)), in the native library."""
    from ..native import tri_cell_overlap
    if cells.shape[-1] != 3:
        pad = [(0, 0)] * (cells.ndim - 1) + [(0, 3 - cells.shape[-1])]
        cells = np.pad(cells, pad)
    return tri_cell_overlap(cells, tris)


# -- exact distances ----------------------------------------------------------


def _dot(a, b):
    return (a * b).sum(dim=-1)


def point_segment_distance(p, a, b):
    """Batched point-segment distance. p, a, b: (..., g) tensors
    (broadcast). Returns (distance, closest point)."""
    ab = b - a
    t = _dot(p - a, ab) / torch.clamp(_dot(ab, ab), min=1e-300)
    t = torch.clamp(t, 0.0, 1.0)
    closest = a + t[..., None] * ab
    return torch.linalg.vector_norm(p - closest, dim=-1), closest


def point_triangle_distance(p, tri):
    """Batched exact point-triangle distance. p: (..., 3); tri: (..., 3, 3)
    tensors (broadcast). Returns (distance, closest point); of the face
    and the three edge candidates the first nearest wins."""
    a, b, c = tri[..., 0, :], tri[..., 1, :], tri[..., 2, :]
    ab, ac, ap = b - a, c - a, p - a
    d1, d2 = _dot(ab, ap), _dot(ac, ap)
    bp = p - b
    d3, d4 = _dot(ab, bp), _dot(ac, bp)
    cp = p - c
    d5, d6 = _dot(ab, cp), _dot(ac, cp)
    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    denom = torch.clamp(va + vb + vc, min=1e-300)
    v = vb / denom
    w = vc / denom
    interior = a + v[..., None] * ab + w[..., None] * ac
    _, pe_ab = point_segment_distance(p, a, b)
    _, pe_ac = point_segment_distance(p, a, c)
    _, pe_bc = point_segment_distance(p, b, c)
    in_face = (va >= 0) & (vb >= 0) & (vc >= 0)
    shape = torch.broadcast_shapes(interior.shape, pe_ab.shape)
    cands = torch.stack([interior.expand(shape), pe_ab.expand(shape),
                         pe_ac.expand(shape), pe_bc.expand(shape)], dim=-2)
    dists = torch.linalg.vector_norm(p[..., None, :] - cands, dim=-1)
    dists[..., 0] = torch.where(in_face, dists[..., 0], torch.inf)
    dmin, best = torch.min(dists, dim=-1)
    closest = torch.gather(
        cands, -2, best[..., None, None].expand(*best.shape, 1, 3))[..., 0, :]
    return dmin, closest
