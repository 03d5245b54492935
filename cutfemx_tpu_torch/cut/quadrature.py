"""Runtime (cut-cell) quadrature generation, linear marching path.

The torch counterpart of ``cutfemx_tpu.cut.quadrature`` for a P1 level set:
every cut cell emits a fixed maximum number of quadrature points
(zero-weight padded), so the whole pipeline is static-shaped and runs as
batched tensor ops on the level set's device.

Uniform weight construction: a cut part is a k-simplex with vertex matrix S
in parent *reference* coordinates (k = tdim for volume parts, tdim-1 for
interface parts). With T = [S_1-S_0, ..., S_k-S_0] and the parent geometry
Jacobian J(xi) the physical weight of rule point q is

    w_q * sqrt(det( (J T)^T (J T) ))

so runtime rules carry PHYSICAL weights, and the assembly kernels skip the
detJ scaling for them.

Facet-hosted rules (the parts of facets, and their codim-2 interface)
and compound rules (an intersection of level-set regions, by re-marching
each part against the next level set) share the same machinery.

A higher-degree level set is cut either on red-refined marching simplices
(``levels``: the true basis re-evaluated at every sub-vertex, geometric
error O((h/2^levels)^2)) or, on simplex hosts, by the curved path
(``curved``): edge crossings Newton-polished onto the true zero set, each
part an isoparametric P2 sub-simplex whose interface mid-edge nodes are
projected onto {phi = 0}, and quadrature through that quadratic map with
per-point Jacobians and normals (O(h^3) at the linear part count).
"""

from __future__ import annotations

import numpy as np
import torch

from ..cells import reference_cell
from ..elements import lagrange_element
from ..quadrature import quadrature_rule
from .tables import (canonical_edges, simplex_cut_tables,
                     subdivided_simplices)

__all__ = ["RuntimeQuadratureRules", "volume_rules", "interface_rules",
           "facet_volume_rules", "facet_interface_rules",
           "compound_volume_rules", "full_cell_rules"]


class RuntimeQuadratureRules:
    """Runtime quadrature rules of cut cells, padded: points_padded
    (n, Qmax, tdim) in parent reference coords and weights_padded
    (n, Qmax), PHYSICAL weights with zero padding, as tensors on the level
    set's device; parent_map holds the n parent entities. Facet-hosted
    rules also carry the background cell whose reference coordinates the
    points are in (``parent_cells``, the facet's first cell) and the
    facet's local index in it (``local_facets``)."""

    kind = "per_entity"

    def __init__(self, tdim, parent_map, points_padded, weights_padded,
                 mesh=None, parent_cells=None, local_facets=None,
                 normals_padded=None):
        self.tdim = int(tdim)
        self.parent_map = np.asarray(parent_map, dtype=np.int32)
        self.points_padded = points_padded
        self.weights_padded = weights_padded
        self.mesh = mesh
        self.parent_cells = (self.parent_map if parent_cells is None
                             else np.asarray(parent_cells, np.int32))
        self.local_facets = local_facets
        self.normals_padded = normals_padded  # interface geometric normals


# ---------------------------------------------------------------------------
# vectorized marching-simplex machinery
# ---------------------------------------------------------------------------


def _march_parts(phis, verts, k, table, basis=None):
    """Extract cut parts of embedded k-simplices.

    phis:  (C, k+1) level-set values at simplex vertices
    verts: (C, k+1, tdim) simplex vertex coords (parent-reference space)
    table: (2^(k+1), max_parts, m) node-id table (m = k+1 for volume parts,
           k for interface parts)
    basis: optional (element, dofs (C, ndofs)) of the true level set: every
           edge-intersection node is then Newton-polished along its host
           edge onto the true zero set instead of the crossing of the
           linear interpolant.

    Returns (X (C, max_parts, m, tdim), valid (C, max_parts),
             ids (C, max_parts, m) marching node ids with -1 padding;
             ids >= k+1 are edge-intersection nodes).
    """
    C = phis.shape[0]
    edges = canonical_edges(k)
    signs = (phis < 0.0).to(torch.int64)
    case = torch.zeros(C, dtype=torch.int64, device=phis.device)
    for i in range(k + 1):
        case = case + (signs[:, i] << i)

    # node coordinates: vertices then canonical-edge intersections
    a_idx = [a for a, _ in edges]
    b_idx = [b for _, b in edges]
    fa = phis[:, a_idx]
    fb = phis[:, b_idx]
    denom = fa - fb
    t = torch.where(torch.abs(denom) > 1e-300, fa / denom, 0.5)
    t = torch.clamp(t, 0.0, 1.0)                # (C, nE)
    va = verts[:, a_idx, :]
    vb = verts[:, b_idx, :]
    d = vb - va
    if basis is not None:
        el, dofs = basis
        # Newton in the edge parameter on g(t) = phi(va + t d) with the
        # true basis, seeded by the linear crossing. Negated phis (side
        # '>') do not move the roots, so the dofs stay as they are.
        for _ in range(6):
            p = va + t[..., None] * d
            g = torch.einsum("cen,cn->ce", el.tabulate(p), dofs)
            dg = torch.einsum("cent,cn,cet->ce", el.tabulate_grad(p),
                              dofs, d)
            big = torch.abs(dg) > 1e-300
            safe = torch.where(big, dg, 1.0)
            tn = t - torch.where(big, g / safe, 0.0)
            t = torch.clamp(torch.where(torch.isfinite(tn), tn, t),
                            0.0, 1.0)
    cross = va + t[..., None] * d               # (C, nE, tdim)
    nodes = torch.cat([verts, cross], dim=1)    # (C, nn, tdim)

    tab = torch.as_tensor(np.asarray(table), dtype=torch.int64,
                          device=phis.device)[case]   # (C, max_parts, m)
    valid = tab[:, :, 0] >= 0
    ids = torch.where(valid[:, :, None], tab, -1)
    tab = torch.clamp(tab, min=0)
    rows = torch.arange(C, device=phis.device)[:, None, None]
    X = nodes[rows, tab]                        # (C, max_parts, m, tdim)
    return X, valid, ids


def _physical_weights(mesh_cell_type, cell_coords, points, T, rule_w, valid):
    """w_q * gram_det(J(xi_q) @ T) with padding zeroed.

    cell_coords: (C, nv, gdim); points: (C, M, nq, tdim);
    T: (C, M, tdim, k); rule_w: (nq,); valid: (C, M).
    Returns weights (C, M, nq).
    """
    el = lagrange_element(mesh_cell_type, 1)
    C, M, nq, tdim = points.shape
    dphi = el.tabulate_grad(points.reshape(C, M * nq, tdim))  # (C,Mnq,nv,t)
    J = torch.einsum("cvg,cqvt->cqgt", cell_coords, dphi)
    J = J.reshape(C, M, nq, J.shape[-2], tdim)
    G = torch.einsum("cmqgt,cmtk->cmqgk", J, T)
    GTG = torch.einsum("cmqgk,cmqgl->cmqkl", G, G)
    k = T.shape[-1]
    if k == 1:
        gram = torch.sqrt(torch.abs(GTG[..., 0, 0]))
    else:
        gram = torch.sqrt(torch.abs(torch.linalg.det(GTG)))
    w = rule_w[None, None, :] * gram
    return torch.where(valid[:, :, None], w, 0.0)


def _map_rule(X, rule_pts):
    """Map reference-simplex rule points onto part simplices.

    X: (C, M, m, tdim) part vertices (m = k+1); rule_pts: (nq, k).
    Returns (points (C, M, nq, tdim), T (C, M, tdim, k))."""
    T = torch.movedim(X[:, :, 1:, :] - X[:, :, :1, :], 2, 3)  # (C,M,tdim,k)
    rp = torch.as_tensor(rule_pts, dtype=X.dtype, device=X.device)
    pts = X[:, :, None, 0, :] + torch.einsum("qk,cmtk->cmqt", rp, T)
    return pts, T


_SIMPLEX_NAME = {1: "interval", 2: "triangle", 3: "tetrahedron"}


# ---------------------------------------------------------------------------
# curved (quadratic) cut approximation on simplex hosts: marching-part
# vertices are Newton-polished onto the true zero set along their host
# edges (_march_parts basis=), each part becomes an isoparametric P2
# sub-simplex whose interface mid-edge nodes are projected onto {phi=0}
# along grad(phi), and quadrature maps through the quadratic geometry with
# per-point Jacobians. Geometric error O(h^3) at the linear part count.
# ---------------------------------------------------------------------------


def _p2_simplex_shapes(k, pts):
    """P2 Lagrange shape functions of the reference k-simplex.

    pts: (nq, k) -> (N (nq, nn), dN (nq, nn, k)) numpy, node order
    [vertices 0..k, then canonical_edges(k) midpoints]."""
    pts = np.asarray(pts, dtype=np.float64)
    nq = pts.shape[0]
    lam = np.concatenate([1.0 - pts.sum(axis=1, keepdims=True), pts],
                         axis=1)                        # (nq, k+1)
    dlam = np.concatenate([-np.ones((1, k)), np.eye(k)], axis=0)  # (k+1, k)
    Ns, dNs = [], []
    for i in range(k + 1):
        Ns.append(lam[:, i] * (2.0 * lam[:, i] - 1.0))
        dNs.append((4.0 * lam[:, i] - 1.0)[:, None] * dlam[i])
    for (a, b) in canonical_edges(k):
        Ns.append(4.0 * lam[:, a] * lam[:, b])
        dNs.append(4.0 * (lam[:, a][:, None] * dlam[b]
                          + lam[:, b][:, None] * dlam[a]))
    N = np.stack(Ns, axis=1)                            # (nq, nn)
    dN = np.stack(dNs, axis=1).reshape(nq, -1, k)       # (nq, nn, k)
    return N, dN


def _curved_nodes(X, ids, nvm, el, dofs, k):
    """Quadratic node set of each part: straight vertices + mid-edge nodes,
    with interface mid-edges projected onto the true zero set.

    X: (C, M, k+1, tdim) part vertices; ids: (C, M, k+1) marching node
    ids (>= nvm: edge-intersection node, already polished onto {phi=0});
    el/dofs: level-set basis per row. A part edge whose BOTH endpoints lie
    on the interface gets its midpoint Newton-projected along grad(phi);
    other mid-edges stay straight (cell-boundary pieces are affine).
    Returns P (C, M, nn, tdim)."""
    edges = canonical_edges(k)
    a_idx = [a for a, _ in edges]
    b_idx = [b for _, b in edges]
    Xa = X[:, :, a_idx, :]
    Xb = X[:, :, b_idx, :]
    mid = 0.5 * (Xa + Xb)                               # (C, M, nE, t)
    on_if = (ids[:, :, a_idx] >= nvm) & (ids[:, :, b_idx] >= nvm)
    C, M, nE, t = mid.shape
    p = mid.reshape(C, M * nE, t)
    for _ in range(6):
        f = torch.einsum("cpn,cn->cp", el.tabulate(p), dofs)
        g = torch.einsum("cpnt,cn->cpt", el.tabulate_grad(p), dofs)
        gg = torch.sum(g * g, dim=-1)
        step = torch.where(gg > 1e-300,
                           f / torch.where(gg > 0, gg, 1.0), 0.0)
        pn = p - step[..., None] * g
        p = torch.where(torch.isfinite(pn).all(-1, keepdim=True), pn, p)
    p = p.reshape(C, M, nE, t)
    # accept a projected midpoint only when it stayed near its edge
    # (|disp| <= half the edge length: slivers and vanishing gradients
    # keep the straight midpoint, which is always consistent)
    disp2 = torch.sum((p - mid) ** 2, dim=-1)
    elen2 = torch.sum((Xb - Xa) ** 2, dim=-1)
    ok = on_if & torch.isfinite(p).all(-1) & (disp2 <= 0.25 * elen2 + 1e-30)
    mids = torch.where(ok[..., None], p, mid)
    return torch.cat([X, mids], dim=2)


def _map_rule_curved(P, rule_pts, k):
    """Map reference-simplex rule points through the quadratic part
    geometry. P: (C, M, nn, tdim) P2 nodes; rule_pts: (nq, k).
    Returns (points (C, M, nq, tdim), Tq (C, M, nq, tdim, k))."""
    N, dN = _p2_simplex_shapes(k, rule_pts)
    N = torch.as_tensor(N, dtype=P.dtype, device=P.device)
    dN = torch.as_tensor(dN, dtype=P.dtype, device=P.device)
    pts = torch.einsum("qn,cmnt->cmqt", N, P)
    Tq = torch.einsum("qnk,cmnt->cmqtk", dN, P)
    return pts, Tq


def _physical_weights_q(mesh_cell_type, cell_coords, points, Tq, rule_w,
                        valid):
    """Per-point variant of _physical_weights for curved parts:
    w_q * gram_det(J(xi_q) @ T_q). Tq: (C, M, nq, tdim, k)."""
    el = lagrange_element(mesh_cell_type, 1)
    C, M, nq, tdim = points.shape
    dphi = el.tabulate_grad(points.reshape(C, M * nq, tdim))
    J = torch.einsum("cvg,cqvt->cqgt", cell_coords, dphi)
    J = J.reshape(C, M, nq, J.shape[-2], tdim)
    G = torch.einsum("cmqgt,cmqtk->cmqgk", J, Tq)
    GTG = torch.einsum("cmqgk,cmqgl->cmqkl", G, G)
    k = Tq.shape[-1]
    if k == 1:
        gram = torch.sqrt(torch.abs(GTG[..., 0, 0]))
    else:
        gram = torch.sqrt(torch.abs(torch.linalg.det(GTG)))
    w = rule_w[None, None, :] * gram
    return torch.where(valid[:, :, None], w, 0.0)


def _part_normals_q(Tq):
    """Per-point unit normal (up to sign) of curved codim-1 parts.

    Tq: (C, M, nq, tdim, tdim-1) -> (C, M, nq, tdim)."""
    tdim = Tq.shape[3]
    if tdim == 2:
        t = Tq[..., 0]
        n = torch.stack([t[..., 1], -t[..., 0]], dim=-1)
    elif tdim == 3:
        n = torch.linalg.cross(Tq[..., 0], Tq[..., 1], dim=-1)
    else:
        n = torch.ones(Tq.shape[:3] + (1,), dtype=Tq.dtype,
                       device=Tq.device)
    norm = torch.linalg.norm(n, dim=-1, keepdim=True)
    return n / torch.where(norm > 0, norm, 1.0)


def _push_normal_q(cell_type, coords, pts, nref):
    """Per-point covariant pushforward n_phys ~ J^{-T} n_ref.

    coords: (C, nv, g); pts: (C, M, nq, t); nref: (C, M, nq, t)."""
    el = lagrange_element(cell_type, 1)
    C, M, nq, tdim = pts.shape
    dphi = el.tabulate_grad(pts.reshape(C, M * nq, tdim))
    J = torch.einsum("cvg,cqvt->cqgt", coords, dphi).reshape(
        C, M, nq, -1, tdim)
    K = torch.linalg.inv(J) if J.shape[-2] == tdim else torch.linalg.pinv(J)
    n = torch.einsum("cmqtg,cmqt->cmqg", K, nref)
    norm = torch.linalg.norm(n, dim=-1, keepdim=True)
    return n / torch.where(norm > 0, norm, 1.0)


def _eval_phi_at(space, dofs_per_cell, ref_points):
    """Tabulate a level-set function at fixed reference points of each cell.

    dofs_per_cell: (C, ndofs) tensor; ref_points: (npt, tdim) static numpy.
    Returns (C, npt)."""
    tab = np.asarray(space.element.tabulate(
        np.asarray(ref_points, dtype=np.float64)))  # (npt, ndofs)
    return torch.einsum("pn,cn->cp",
                        torch.as_tensor(tab, dtype=dofs_per_cell.dtype,
                                        device=dofs_per_cell.device),
                        dofs_per_cell)


def _cell_phi_dofs(phi, cells):
    V = phi.function_space
    idx = torch.as_tensor(V.dofmap[cells], dtype=torch.int64,
                          device=phi.x.device)
    return phi.x[idx]


def _cell_simplices(mesh, levels):
    """Static (NS, d+1, tdim) reference-space simplices covering the cell:
    the simplex split, red-refined ``levels`` times."""
    cell = mesh.ref_cell
    return subdivided_simplices(cell.vertices[cell.simplex_split], levels)


def _marching_setup(mesh, phi, cut_cells, levels):
    """Inputs of the marching over the NS (refined) simplices that split
    each cut cell: (vertex phi values (C*NS, d+1), sub-simplex vertices
    (C*NS, d+1, tdim), cell coords (C*NS, nv, gdim), the level set's
    dofs (C, nd), NS)."""
    tdim = mesh.ref_cell.tdim
    dt, dev = phi.x.dtype, phi.x.device
    C = len(cut_cells)
    dofs = _cell_phi_dofs(phi, cut_cells)
    sims = _cell_simplices(mesh, levels)          # (NS, d+1, tdim)
    NS = sims.shape[0]
    phi_all = _eval_phi_at(phi.function_space, dofs,
                           sims.reshape(-1, tdim)).reshape(C * NS, tdim + 1)
    verts = torch.as_tensor(sims, dtype=dt, device=dev)[None].expand(
        C, NS, tdim + 1, tdim).reshape(C * NS, tdim + 1, tdim)
    coords = torch.as_tensor(mesh.cell_vertex_coords[cut_cells], dtype=dt,
                             device=dev)
    coords_rep = torch.repeat_interleave(coords, NS, dim=0)
    return phi_all, verts, coords_rep, dofs, NS


def volume_rules(mesh, phi, cut_cells, order, side="<", levels=0,
                 curved=False):
    """Padded volume rules for {phi < 0} (side '<') or {phi > 0} (side '>')
    on the given cut cells. Points in parent reference coords; weights
    physical. ``levels`` red-refines the marching simplices with the true
    level-set basis re-evaluated at every sub-vertex; ``curved`` upgrades
    every part to an isoparametric P2 sub-simplex with polished/projected
    interface nodes (higher-order cut approximation on simplex hosts)."""
    tdim = mesh.ref_cell.tdim
    VOL, _ = simplex_cut_tables(tdim)
    rule_pts, rule_w = quadrature_rule(_SIMPLEX_NAME[tdim], order)
    cut_cells = np.asarray(cut_cells, dtype=np.int32)
    C = len(cut_cells)
    phi_all, verts, coords_rep, dofs, NS = _marching_setup(
        mesh, phi, cut_cells, levels)
    if side == ">":
        phi_all = -phi_all
    el = phi.function_space.element
    dofs_rep = torch.repeat_interleave(dofs, NS, dim=0) if curved else None
    X, valid, ids = _march_parts(phi_all, verts, tdim, VOL,
                                 basis=(el, dofs_rep) if curved else None)
    rw = torch.as_tensor(rule_w, dtype=phi_all.dtype, device=phi_all.device)
    if curved:
        P = _curved_nodes(X, ids, tdim + 1, el, dofs_rep, tdim)
        pts, Tq = _map_rule_curved(P, rule_pts, tdim)
        w = _physical_weights_q(mesh.cell_type, coords_rep, pts, Tq, rw,
                                valid)
    else:
        pts, T = _map_rule(X, rule_pts)           # (C*NS, M, nq, t)
        w = _physical_weights(mesh.cell_type, coords_rep, pts, T, rw, valid)
    return RuntimeQuadratureRules(tdim, cut_cells, pts.reshape(C, -1, tdim),
                                  w.reshape(C, -1), mesh=mesh)


def interface_rules(mesh, phi, cut_cells, order, levels=0, curved=False):
    """Padded interface ({phi = 0}) rules on cut cells, with geometric
    normals oriented by grad(phi) (outward from the {phi<0} phase).
    ``curved`` maps the rule through quadratic parts whose nodes all lie
    on the true zero set, with per-point normals."""
    tdim = mesh.ref_cell.tdim
    _, SURF = simplex_cut_tables(tdim)
    rule_pts, rule_w = quadrature_rule(_SIMPLEX_NAME[tdim - 1], order) \
        if tdim > 1 else (np.zeros((1, 0)), np.ones(1))
    cut_cells = np.asarray(cut_cells, dtype=np.int32)
    C = len(cut_cells)
    sphis, sverts, coords_rep, dofs, NS = _marching_setup(
        mesh, phi, cut_cells, levels)
    el = phi.function_space.element
    dofs_rep = torch.repeat_interleave(dofs, NS, dim=0) if curved else None
    X, valid, ids = _march_parts(sphis, sverts, tdim, SURF,
                                 basis=(el, dofs_rep) if curved else None)
    rw = torch.as_tensor(rule_w, dtype=sphis.dtype, device=sphis.device)
    if curved:
        P = _curved_nodes(X, ids, tdim + 1, el, dofs_rep, tdim - 1)
        pts, Tq = _map_rule_curved(P, rule_pts, tdim - 1)
        w = _physical_weights_q(mesh.cell_type, coords_rep, pts, Tq, rw,
                                valid)
        # per-point normal of the curved part, oriented by the TRUE
        # grad(phi) at each quadrature point
        nref = _part_normals_q(Tq)                        # (CNS, M, nq, t)
        CN, M, nq, _ = pts.shape
        gref = torch.einsum(
            "cpnt,cn->cpt", el.tabulate_grad(pts.reshape(CN, M * nq, tdim)),
            dofs_rep).reshape(CN, M, nq, tdim)
        orient = torch.sign(torch.einsum("cmqt,cmqt->cmq", nref, gref))
        orient = torch.where(orient == 0, 1.0, orient)
        nphys = _push_normal_q(mesh.cell_type, coords_rep, pts,
                               nref * orient[..., None])
    else:
        pts, T = _map_rule(X, rule_pts)           # T: (CNS, M, t, t-1)
        w = _physical_weights(mesh.cell_type, coords_rep, pts, T, rw, valid)
        # geometric normal: reference-space normal of the planar part,
        # pushed forward covariantly (J^-T), oriented along grad(phi)
        gphi_ref = _linear_gradient(sverts, sphis)        # (CNS, tdim)
        nref = _part_normals(T)                           # (CNS, M, tdim)
        orient = torch.sign(torch.einsum("cmt,ct->cm", nref, gphi_ref))
        orient = torch.where(orient == 0, 1.0, orient)
        nref = nref * orient[:, :, None]
        nphys = _push_normal(mesh.cell_type, coords_rep, pts, nref)
    return RuntimeQuadratureRules(
        tdim, cut_cells, pts.reshape(C, -1, tdim), w.reshape(C, -1),
        mesh=mesh, normals_padded=nphys.reshape(C, -1, nphys.shape[-1]))


def _facet_setup(mesh, phi, facets):
    """Per-facet inputs of the facet-hosted marching: (first adjacent
    cells, their local facet indices, the facet vertices in those cells'
    reference coords (C, nvf, tdim), the level set's dofs on those cells,
    the cells' vertex coords, the facet simplex split)."""
    cell = mesh.ref_cell
    dt, dev = phi.x.dtype, phi.x.device
    cells = mesh.facet_cells[facets, 0]
    locals_ = mesh.facet_local_index[facets, 0]
    fv = torch.as_tensor(cell.facet_vertices_coords()[locals_], dtype=dt,
                         device=dev)
    dofs = _cell_phi_dofs(phi, cells)
    coords = torch.as_tensor(mesh.cell_vertex_coords[cells], dtype=dt,
                             device=dev)
    if cell.facet_cell_type == "quadrilateral":
        fsplit = reference_cell("quadrilateral").simplex_split
    else:
        fsplit = np.arange(cell.tdim, dtype=np.int32)[None, :]
    return cells, locals_, fv, dofs, coords, fsplit


def facet_volume_rules(mesh, phi, facets, order, side="<"):
    """Rules for the {phi < 0} (side '<') or {phi > 0} (side '>') parts of
    the given facets (facet-hosted cuts). Points in the reference coords
    of each facet's first adjacent cell; weights physical."""
    k = mesh.ref_cell.tdim - 1
    VOL, _ = simplex_cut_tables(k)
    rule_pts, rule_w = quadrature_rule(_SIMPLEX_NAME[k], order)
    facets = np.asarray(facets, dtype=np.int32)
    C = len(facets)
    cells, locals_, fv, dofs, coords, fsplit = _facet_setup(mesh, phi,
                                                            facets)
    el = phi.function_space.element
    rw = torch.as_tensor(rule_w, dtype=fv.dtype, device=fv.device)
    all_pts, all_w = [], []
    for sub in fsplit:
        verts = fv[:, np.asarray(sub), :]         # (C, k+1, tdim)
        phis = torch.einsum("cpn,cn->cp", el.tabulate(verts), dofs)
        if side == ">":
            phis = -phis
        X, valid, _ = _march_parts(phis, verts, k, VOL)
        pts, T = _map_rule(X, rule_pts)
        w = _physical_weights(mesh.cell_type, coords, pts, T, rw, valid)
        all_pts.append(pts.reshape(C, -1, mesh.tdim))
        all_w.append(w.reshape(C, -1))
    return RuntimeQuadratureRules(
        mesh.tdim, facets, torch.cat(all_pts, dim=1),
        torch.cat(all_w, dim=1), mesh=mesh, parent_cells=cells,
        local_facets=locals_)


def facet_interface_rules(mesh, phi, facets, order, polish=False):
    """Codim-2 rules: {phi = 0} restricted to the given facets (the
    skeleton rules of a surface DG method). In 3D each cut facet yields
    segments; in 2D a single crossing point with physical weight 1 (the
    rule has no dimension there). Points in the first adjacent cell's
    reference coords.

    ``polish`` moves 2D crossing points onto the root of the true
    level-set basis along the facet by Newton's method (for a higher-
    degree level set: the root, not the crossing of its linear
    interpolant)."""
    tdim = mesh.ref_cell.tdim
    k = tdim - 1          # facet dimension; interface parts have dim k-1
    _, SURF = simplex_cut_tables(k)
    if k - 1 >= 1:
        rule_pts, rule_w = quadrature_rule(_SIMPLEX_NAME[k - 1], order)
    else:
        rule_pts, rule_w = np.zeros((1, 0)), np.ones(1)
    facets = np.asarray(facets, dtype=np.int32)
    C = len(facets)
    cells, locals_, fv, dofs, coords, fsplit = _facet_setup(mesh, phi,
                                                            facets)
    el = phi.function_space.element
    rw = torch.as_tensor(rule_w, dtype=fv.dtype, device=fv.device)
    all_pts, all_w = [], []
    for sub in fsplit:
        verts = fv[:, np.asarray(sub), :]
        phis = torch.einsum("cpn,cn->cp", el.tabulate(verts), dofs)
        X, valid, _ = _march_parts(phis, verts, k, SURF)
        if polish and k == 1 and X.shape[1] and X.shape[2] == 1:
            # Newton on g(t) = phi(p + t*d) along the facet direction
            d = verts[:, 1, :] - verts[:, 0, :]            # (C, tdim)
            p = X[:, :, 0, :]                              # (C, M, tdim)
            for _ in range(8):
                g = torch.einsum("cpn,cn->cp", el.tabulate(p), dofs)
                dg = torch.einsum("cpnt,cn,ct->cp", el.tabulate_grad(p),
                                  dofs, d)
                safe = torch.where(torch.abs(dg) > 1e-300, dg, 1.0)
                p = p - (g / safe)[..., None] * d[:, None, :]
            ok = torch.isfinite(p).all(-1) & valid
            X = torch.where(ok[:, :, None, None], p[:, :, None, :], X)
        pts, T = _map_rule(X, rule_pts)
        if T.shape[-1] == 0:
            # 2D: point "rules" of physical weight 1 at the crossing
            w = valid[:, :, None].to(fv.dtype)
        else:
            w = _physical_weights(mesh.cell_type, coords, pts, T, rw, valid)
        all_pts.append(pts.reshape(C, -1, tdim))
        all_w.append(w.reshape(C, -1))
    return RuntimeQuadratureRules(
        tdim, facets, torch.cat(all_pts, dim=1), torch.cat(all_w, dim=1),
        mesh=mesh, parent_cells=cells, local_facets=locals_)


def compound_volume_rules(mesh, clauses, cells, order, levels=0):
    """Volume rules of an intersection region {AND_i phi_i OP_i 0}: each
    cell's simplices are cut by the first level set, each resulting part
    is re-cut by the next one, and so on. ``clauses``: [(phi, side)] with
    side '<' or '>' (level sets on one device). ``levels`` red-refines the
    cells' simplices first (higher-degree level sets). Points in parent
    reference coords, physical weights."""
    tdim = mesh.ref_cell.tdim
    VOL, _ = simplex_cut_tables(tdim)
    rule_pts, rule_w = quadrature_rule(_SIMPLEX_NAME[tdim], order)
    cells = np.asarray(cells, dtype=np.int32)
    C = len(cells)
    dt, dev = clauses[0][0].x.dtype, clauses[0][0].x.device
    coords = torch.as_tensor(mesh.cell_vertex_coords[cells], dtype=dt,
                             device=dev)
    sims = _cell_simplices(mesh, levels)
    NS = sims.shape[0]
    # candidate parts of each cell: (C, B, d+1, tdim), and which are real
    batch = torch.as_tensor(sims, dtype=dt, device=dev)[None].expand(
        C, NS, tdim + 1, tdim)
    batch_valid = torch.ones((C, NS), dtype=torch.bool, device=dev)
    for phi, side in clauses:
        B = batch.shape[1]
        dofs = _cell_phi_dofs(phi, cells)                 # (C, nd)
        tab = phi.function_space.element.tabulate(
            batch.reshape(C, B * (tdim + 1), tdim))       # (C, B(d+1), nd)
        phis = torch.einsum("cpn,cn->cp", tab, dofs).reshape(
            C * B, tdim + 1)
        if side == ">":
            phis = -phis
        X, valid, _ = _march_parts(
            phis, batch.reshape(C * B, tdim + 1, tdim), tdim, VOL)
        M = X.shape[1]
        valid = valid & batch_valid.reshape(C * B)[:, None]
        batch = X.reshape(C, B * M, tdim + 1, tdim)
        batch_valid = valid.reshape(C, B * M)
    B = batch.shape[1]
    pts, T = _map_rule(batch.reshape(C * B, 1, tdim + 1, tdim), rule_pts)
    w = _physical_weights(mesh.cell_type,
                          torch.repeat_interleave(coords, B, dim=0), pts, T,
                          torch.as_tensor(rule_w, dtype=dt, device=dev),
                          batch_valid.reshape(C * B, 1))
    return RuntimeQuadratureRules(tdim, cells, pts.reshape(C, -1, tdim),
                                  w.reshape(C, -1), mesh=mesh)


def _linear_gradient(verts, vals):
    """Gradient of the linear interpolant on each simplex.

    verts: (C, k+1, tdim); vals: (C, k+1) -> (C, tdim)."""
    E = verts[:, 1:, :] - verts[:, :1, :]          # (C, k, t)
    d = vals[:, 1:] - vals[:, :1]                  # (C, k)
    if E.shape[1] == E.shape[2]:
        return torch.linalg.solve(E, d[..., None])[..., 0]
    ET = E.transpose(1, 2)
    g = torch.linalg.solve(E @ ET, d[..., None])
    return (ET @ g)[..., 0]


def _part_normals(T):
    """Unit normal (up to sign) of codim-1 parts from their reference
    tangent matrix T: (C, M, tdim, tdim-1) -> (C, M, tdim)."""
    tdim = T.shape[2]
    if tdim == 2:
        t = T[:, :, :, 0]
        n = torch.stack([t[..., 1], -t[..., 0]], dim=-1)
    elif tdim == 3:
        n = torch.linalg.cross(T[:, :, :, 0], T[:, :, :, 1], dim=-1)
    else:
        n = torch.ones(T.shape[:2] + (1,), dtype=T.dtype, device=T.device)
    norm = torch.linalg.norm(n, dim=-1, keepdim=True)
    return n / torch.where(norm > 0, norm, 1.0)


def _push_normal(cell_type, coords, pts, nref):
    """Covariant pushforward n_phys ~ J^{-T} n_ref, normalized.

    coords: (C, nv, g); pts: (C, M, nq, t); nref: (C, M, t)."""
    el = lagrange_element(cell_type, 1)
    C, M, nq, tdim = pts.shape
    dphi = el.tabulate_grad(pts.reshape(C, M * nq, tdim))
    J = torch.einsum("cvg,cqvt->cqgt", coords, dphi).reshape(
        C, M, nq, -1, tdim)
    if J.shape[-2] == tdim:
        K = torch.linalg.inv(J)                   # (C, M, nq, t, g)
    else:
        K = torch.linalg.pinv(J)
    n = torch.einsum("cmqtg,cmt->cmqg", K, nref)
    norm = torch.linalg.norm(n, dim=-1, keepdim=True)
    return n / torch.where(norm > 0, norm, 1.0)


def full_cell_rules(mesh, cells, order, *, device="cuda",
                    dtype=torch.float64):
    """Runtime rules covering whole (uncut) cells — the oracle utility the
    reference tests use to check runtime assembly against standard
    assembly."""
    cell = mesh.ref_cell
    tdim = cell.tdim
    rule_pts, rule_w = quadrature_rule(_SIMPLEX_NAME[tdim], order)
    cells = np.asarray(cells, dtype=np.int32)
    C = len(cells)
    coords = torch.as_tensor(mesh.cell_vertex_coords[cells], dtype=dtype,
                             device=device)
    rw = torch.as_tensor(rule_w, dtype=dtype, device=device)
    all_pts, all_w = [], []
    for sub in cell.simplex_split:
        verts = torch.as_tensor(cell.vertices[sub], dtype=dtype,
                                device=device).expand(C, tdim + 1, tdim)
        X = verts[:, None, :, :]
        valid = torch.ones((C, 1), dtype=torch.bool, device=device)
        pts, T = _map_rule(X, rule_pts)
        w = _physical_weights(mesh.cell_type, coords, pts, T, rw, valid)
        all_pts.append(pts.reshape(C, -1, tdim))
        all_w.append(w.reshape(C, -1))
    return RuntimeQuadratureRules(tdim, cells, torch.cat(all_pts, dim=1),
                                  torch.cat(all_w, dim=1), mesh=mesh)
