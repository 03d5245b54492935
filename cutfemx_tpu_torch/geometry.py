"""Geometry maps: Jacobians, pushforward, pullback, facet normals.

The torch counterpart of ``cutfemx_tpu.geometry``. All functions act on the
quadrature points of one entity; batching over entities is done by
``torch.func.vmap`` in the form compiler, so nothing here updates a tensor
in place.
"""

from __future__ import annotations

import numpy as np
import torch

from .cells import reference_cell
from .elements import lagrange_element

__all__ = ["pullback", "pullback_affine", "gram_det", "map_facet_points",
           "facet_reference_normals", "take_row"]


def pullback_affine(cell_type, coords, xphys):
    """Inverse map for affine (simplex) cells: (Q, gdim) -> (Q, tdim)."""
    cell = reference_cell(cell_type)
    if not cell.is_simplex:
        raise ValueError("pullback_affine requires a simplex cell")
    origin = coords[0]
    J = torch.stack([coords[i + 1] - origin for i in range(cell.tdim)],
                    dim=-1)  # (gdim, tdim)
    K = inv_or_pinv(J)
    return torch.einsum("tg,qg->qt", K, xphys - origin)


def pullback(cell_type, coords, xphys):
    """Inverse geometry map; the slice has simplex cells only."""
    if not reference_cell(cell_type).is_simplex:
        raise NotImplementedError(
            "non-affine pullback (ROADMAP item 10: geometry breadth)")
    return pullback_affine(cell_type, coords, xphys)


def gram_det(J):
    """sqrt(det(J^T J)) for possibly non-square J (..., gdim, tdim)."""
    g, t = J.shape[-2], J.shape[-1]
    if g == t:
        return torch.abs(torch.linalg.det(J))
    JTJ = torch.einsum("...gi,...gj->...ij", J, J)
    return torch.sqrt(torch.abs(torch.linalg.det(JTJ)))


def inv_or_pinv(J):
    if J.shape[-2] == J.shape[-1]:
        return torch.linalg.inv(J)
    return torch.linalg.pinv(J)


def take_row(table, idx):
    """table[idx] for a 0-d index tensor. Plain indexing would read the
    index on the host, which torch.func.vmap cannot do for a batched
    index."""
    return table[idx.reshape(1)][0]


# -- facet embedding ---------------------------------------------------------


def map_facet_points(cell_type, local_facet, facet_points, fverts_table):
    """Map facet-reference points (Q, fdim) to cell-reference (Q, tdim) for a
    given local facet index (a 0-d integer tensor).

    fverts_table: (nf, nvf, tdim) static reference coords of facet vertices.
    """
    cell = reference_cell(cell_type)
    fct = cell.facet_cell_type
    fel = lagrange_element(fct, 1) if fct != "point" else None
    fv = take_row(torch.as_tensor(fverts_table, dtype=facet_points.dtype,
                                  device=facet_points.device), local_facet)
    if fel is None:
        return fv[0].expand(facet_points.shape[0], cell.tdim)
    phi = fel.tabulate(facet_points)  # (Q, nvf)
    return torch.einsum("qv,vt->qt", phi, fv)


def facet_reference_normals(cell_type):
    """(nfacets, tdim) outward unit normals of the reference cell facets."""
    cell = reference_cell(cell_type)
    n = np.zeros((cell.num_facets, cell.tdim))
    centroid = cell.vertices.mean(axis=0)
    for f in range(cell.num_facets):
        vs = cell.vertices[cell.facets[f]]
        if cell.tdim == 1:
            nv = vs[0] - centroid
        elif cell.tdim == 2:
            t = vs[1] - vs[0]
            nv = np.array([t[1], -t[0]])
        else:
            nv = np.cross(vs[1] - vs[0], vs[2] - vs[0])
        mid = vs.mean(axis=0)
        if np.dot(nv, mid - centroid) < 0:
            nv = -nv
        n[f] = nv / np.linalg.norm(nv)
    return n
