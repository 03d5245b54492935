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

__all__ = ["coordinate_element", "jacobian", "pushforward", "pullback",
           "pullback_affine", "pullback_newton", "gram_det", "inv_or_pinv",
           "reference_facet_map", "map_facet_points",
           "facet_reference_normals", "physical_facet_normal", "take_row"]


def coordinate_element(cell_type):
    return lagrange_element(cell_type, 1)


def jacobian(cell_type, coords, points):
    """J = dx/dxi at each point.

    coords: (nv, gdim) cell vertex coords; points: (Q, tdim).
    Returns (Q, gdim, tdim).
    """
    el = coordinate_element(cell_type)
    dphi = el.tabulate_grad(points)  # (Q, nv, tdim)
    return torch.einsum("vg,qvt->qgt", coords, dphi)


def pushforward(cell_type, coords, points):
    """Map reference points (Q, tdim) to physical (Q, gdim)."""
    el = coordinate_element(cell_type)
    phi = el.tabulate(points)  # (Q, nv)
    return torch.einsum("qv,vg->qg", phi, coords)


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


def pullback_newton(cell_type, coords, xphys, iters=8):
    """Inverse of the (multilinear) geometry map by ``iters`` Newton steps
    from the reference centroid. The step count is fixed (no
    data-dependent exit), so the function runs under torch.func.vmap.

    coords: (nv, gdim); xphys: (Q, gdim) -> (Q, tdim)."""
    cell = reference_cell(cell_type)
    el = coordinate_element(cell_type)
    xi = torch.as_tensor(cell.vertices.mean(axis=0), dtype=xphys.dtype,
                         device=xphys.device).expand(xphys.shape[0],
                                                     cell.tdim)
    for _ in range(iters):
        x = torch.einsum("qv,vg->qg", el.tabulate(xi), coords)
        J = torch.einsum("vg,qvt->qgt", coords, el.tabulate_grad(xi))
        xi = xi + torch.einsum("qtg,qg->qt", inv_or_pinv(J), xphys - x)
    return xi


def pullback(cell_type, coords, xphys):
    """General inverse geometry map: exact affine solve for simplices,
    Newton otherwise."""
    if reference_cell(cell_type).is_simplex:
        return pullback_affine(cell_type, coords, xphys)
    return pullback_newton(cell_type, coords, xphys)


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


def reference_facet_map(cell_type):
    """(nfacets, nvf, tdim) reference coordinates of each facet's
    vertices: a facet-reference point maps into the cell reference
    through the facet's P1 map over them (bilinear for the quadrilateral
    facets of hexahedra)."""
    return reference_cell(cell_type).facet_vertices_coords()


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


def physical_facet_normal(cell_type, K, ref_normal):
    """Outward physical normal from reference normal: n = K^T n_ref / |.|.

    K: (Q, tdim, gdim) inverse Jacobian; ref_normal: (tdim,).
    """
    n = torch.einsum("qtg,t->qg", K, torch.as_tensor(
        ref_normal, dtype=K.dtype, device=K.device))
    return n / torch.linalg.norm(n, dim=-1, keepdim=True)
