"""Marching-simplex case tables for cut-cell quadrature.

Replaces the CutCells cell-cutting role (SURVEY.md §2e). Tables are
generated programmatically at import time for interval/triangle/tetrahedron:
for each of the 2^(d+1) vertex sign patterns they list

- VOL:  sub-simplices covering the {phi < 0} part of the simplex
- SURF: sub-(d-1)-simplices covering the {phi = 0} interface

Node encoding: 0..d are the simplex vertices; d+1.. are edge-intersection
nodes indexed by the canonical edge list (all vertex pairs i<j). Entries of
-1 are padding. Because the cut is planar per simplex (P1 level set), any
convex-polytope triangulation is exact; we use the standard wedge split
(B0,B1,B2,T0),(B1,B2,T0,T1),(B2,T0,T1,T2).

Zero dof values classify a cell as intersected (the reference's
classify_entity_dofs, upstream CutFEMx cpp/cutfemx/cut/cut.cpp:292-321); in
the sign patterns here a vertex value of exactly 0 counts as non-negative,
producing degenerate (zero-weight) sub-simplices — consistent, and exact up
to measure zero.
"""

from __future__ import annotations

from itertools import combinations

import numpy as np

__all__ = ["simplex_cut_tables", "canonical_edges", "subdivided_simplices"]


def canonical_edges(d):
    """All vertex pairs (i < j) of a d-simplex."""
    return list(combinations(range(d + 1), 2))


def _edge_node(edges, a, b, offset):
    key = (min(a, b), max(a, b))
    return offset + edges.index(key)


def _build_tables(d):
    nv = d + 1
    edges = canonical_edges(d)
    ncases = 1 << nv
    if d == 1:
        max_vol, max_surf, surf_nv = 1, 1, 1
    elif d == 2:
        max_vol, max_surf, surf_nv = 2, 1, 2
    else:
        max_vol, max_surf, surf_nv = 3, 2, 3

    VOL = -np.ones((ncases, max_vol, nv), dtype=np.int32)
    SURF = -np.ones((ncases, max_surf, surf_nv), dtype=np.int32)

    def e(a, b):
        return _edge_node(edges, a, b, nv)

    for case in range(ncases):
        inside = [i for i in range(nv) if case >> i & 1]
        outside = [i for i in range(nv) if not case >> i & 1]
        vol, surf = [], []
        if len(inside) == nv:
            vol = [tuple(range(nv))]
        elif len(inside) == 0:
            pass
        elif d == 1:
            (a,), (b,) = inside, outside
            vol = [(a, e(a, b))]
            surf = [(e(a, b),)]
        elif d == 2:
            if len(inside) == 1:
                a = inside[0]
                b, c = outside
                vol = [(a, e(a, b), e(a, c))]
                surf = [(e(a, b), e(a, c))]
            else:  # 2 inside
                a, b = inside
                (c,) = outside
                # quad (a, e_ac, e_bc, b) -> two triangles
                vol = [(a, e(a, c), e(b, c)), (a, e(b, c), b)]
                surf = [(e(a, c), e(b, c))]
        else:  # d == 3
            if len(inside) == 1:
                a = inside[0]
                b, c, dd = outside
                vol = [(a, e(a, b), e(a, c), e(a, dd))]
                surf = [(e(a, b), e(a, c), e(a, dd))]
            elif len(inside) == 3:
                a = outside[0]
                b, c, dd = inside
                tb, tc, td = e(a, b), e(a, c), e(a, dd)
                # wedge bottom (b,c,dd), top (tb,tc,td)
                vol = [(b, c, dd, tb), (c, dd, tb, tc), (dd, tb, tc, td)]
                surf = [(tb, tc, td)]
            else:  # 2 inside, 2 outside
                a, b = inside
                c, dd = outside
                ac, ad = e(a, c), e(a, dd)
                bc, bd = e(b, c), e(b, dd)
                # wedge bottom (a, ac, ad), top (b, bc, bd)
                vol = [(a, ac, ad, b), (ac, ad, b, bc), (ad, b, bc, bd)]
                # interface quad cyclic order (ac, bc, bd, ad)
                surf = [(ac, bc, bd), (ac, bd, ad)]
        for k, s in enumerate(vol):
            VOL[case, k, :] = s
        for k, s in enumerate(surf):
            SURF[case, k, :] = s
    return VOL, SURF


_TABLES = {d: _build_tables(d) for d in (1, 2, 3)}


def simplex_cut_tables(d):
    """(VOL (2^(d+1), max_vol, d+1), SURF (2^(d+1), max_surf, d)) int32."""
    return _TABLES[d]



def _subdivide_once(simplices):
    """Red-refine each simplex (coordinates, not topology).

    simplices: (n, d+1, k) vertex coordinate arrays -> (n*2^d, d+1, k)."""
    out = []
    for S in simplices:
        d = S.shape[0] - 1
        if d == 1:
            m = 0.5 * (S[0] + S[1])
            out += [np.stack([S[0], m]), np.stack([m, S[1]])]
        elif d == 2:
            m01 = 0.5 * (S[0] + S[1])
            m02 = 0.5 * (S[0] + S[2])
            m12 = 0.5 * (S[1] + S[2])
            out += [np.stack([S[0], m01, m02]),
                    np.stack([S[1], m01, m12]),
                    np.stack([S[2], m02, m12]),
                    np.stack([m01, m12, m02])]
        else:
            v0, v1, v2, v3 = S
            m01 = 0.5 * (v0 + v1)
            m02 = 0.5 * (v0 + v2)
            m03 = 0.5 * (v0 + v3)
            m12 = 0.5 * (v1 + v2)
            m13 = 0.5 * (v1 + v3)
            m23 = 0.5 * (v2 + v3)
            # Bey's 8-subtet rule
            out += [np.stack([v0, m01, m02, m03]),
                    np.stack([v1, m01, m12, m13]),
                    np.stack([v2, m02, m12, m23]),
                    np.stack([v3, m03, m13, m23]),
                    np.stack([m01, m02, m13, m03]),
                    np.stack([m01, m02, m12, m13]),
                    np.stack([m02, m03, m13, m23]),
                    np.stack([m02, m12, m13, m23])]
    return np.stack(out)


def subdivided_simplices(base_verts, levels):
    """Recursively red-refine simplices given by coordinate arrays.

    base_verts: (n, d+1, k) -> (n * (2^d)^levels, d+1, k). The marching of
    a higher-degree level set on these re-evaluates it through its true
    basis at every sub-simplex vertex, so the geometric error drops to
    O((h/2^levels)^2)."""
    S = np.asarray(base_verts, dtype=np.float64)
    for _ in range(levels):
        S = _subdivide_once(S)
    return S
