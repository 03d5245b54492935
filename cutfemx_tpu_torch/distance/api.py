"""Public distance API: STL -> signed distance, reinitialization,
normal-velocity extension, mesh adaptation.

The torch counterpart of ``cutfemx_tpu.distance.api``. The exact near
field, the FIM sweeps, the winding sums, the edge sign propagation and the
point-to-interface distances run on the device in float64; the
cell-triangle map, the cut-facet predicates (native library) and the
component labels run on the host. Functions come back in float64 on the
device of the call (``device=``, or the level set's).
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from enum import Enum

import numpy as np
import torch

from ..functionspace import Function, FunctionSpace
from ..geometry import pullback
from .fim import FMMOptions, eikonal_solve
from .stl import (TriSoup, build_cell_triangle_map, distribute_stl,
                  point_segment_distance, point_triangle_distance, read_stl)

logger = logging.getLogger("cutfemx_tpu_torch")

__all__ = ["SignMode", "from_stl", "compute_unsigned_distance",
           "compute_signed_distance", "reinitialize",
           "reinitialize_from_facets", "extend_normal_velocity",
           "NormalExtensionResult", "adapt_mesh_to_stl",
           "refinement_edges_from_stl"]

F64 = torch.float64
# (points x pieces) pairs per chunk of a dense distance evaluation
_PAIR_CHUNK = 1 << 22


class SignMode(Enum):
    """Sign strategies."""
    local_normal_band = "local_normal_band"
    component_anchor = "component_anchor"
    winding_number = "winding_number"


def _pad3(x):
    if x.shape[1] == 3:
        return x
    out = np.zeros((x.shape[0], 3))
    out[:, :x.shape[1]] = x
    return out


# -- near field --------------------------------------------------------------


def _near_field(mesh, soup: TriSoup, ctmap, device="cuda"):
    """Exact distances at the vertices of triangle-mapped cells.

    Each vertex takes its closest candidate triangle: of equal distances
    the smallest (vertex, triangle) key wins, as a stable sort by distance
    over the sorted unique keys picks it. Returns host arrays (d0 (NV,),
    frozen (NV,), closest (NV, gdim), tri_normal (NV, gdim))."""
    dev = torch.device(device)
    nv, gdim = mesh.num_vertices, mesh.gdim
    inf = FMMOptions().inf
    counts = np.diff(ctmap.offsets)
    if not counts.sum():
        return (np.full(nv, inf), np.zeros(nv, bool), np.zeros((nv, gdim)),
                np.zeros((nv, gdim)))
    cell_of = np.repeat(np.arange(mesh.num_cells), counts)
    verts = mesh.cells[cell_of].astype(np.int64)          # (P, nvc)
    key = np.unique((verts * soup.num_triangles
                     + ctmap.triangles[:, None]).ravel())
    pv, pt = key // soup.num_triangles, key % soup.num_triangles
    X = torch.as_tensor(_pad3(mesh.vertices), dtype=F64, device=dev)
    tc = torch.as_tensor(soup.triangle_coords(), dtype=F64, device=dev)
    pv_t = torch.as_tensor(pv, device=dev)
    pt_t = torch.as_tensor(pt, device=dev)
    d_parts, cl_parts = [], []
    for s in range(0, len(pv), _PAIR_CHUNK):
        d, cl = point_triangle_distance(X[pv_t[s:s + _PAIR_CHUNK]],
                                        tc[pt_t[s:s + _PAIR_CHUNK]])
        d_parts.append(d)
        cl_parts.append(cl)
    d, closest = torch.cat(d_parts), torch.cat(cl_parts)
    d0 = torch.full((nv,), inf, dtype=F64, device=dev)
    d0.scatter_reduce_(0, pv_t, d, "amin")
    pos = torch.arange(len(pv), device=dev)
    first = torch.full((nv,), len(pv), dtype=torch.int64, device=dev)
    first.scatter_reduce_(0, pv_t, torch.where(d == d0[pv_t], pos, len(pv)),
                          "amin")
    frozen = first < len(pv)
    sel = first[frozen]
    cl = torch.zeros((nv, 3), dtype=F64, device=dev)
    cl[frozen] = closest[sel]
    N = torch.as_tensor(soup.N, dtype=F64, device=dev)
    nrm = torch.zeros((nv, 3), dtype=F64, device=dev)
    nrm[frozen] = N[pt_t[sel]]
    return (d0.cpu().numpy(), frozen.cpu().numpy(),
            cl[:, :gdim].cpu().numpy(), nrm[:, :gdim].cpu().numpy())


def compute_unsigned_distance(mesh, soup: TriSoup, ctmap=None,
                              options: FMMOptions | None = None,
                              device="cuda"):
    """Unsigned distance at mesh vertices (host array) and the FIM sweep
    count: exact near field + FIM."""
    if ctmap is None:
        ctmap = build_cell_triangle_map(mesh, soup)
    d0, frozen, _, _ = _near_field(mesh, soup, ctmap, device)
    d, _, its = eikonal_solve(mesh, d0, frozen, options, device=device)
    return d.cpu().numpy(), its


# -- sign strategies ---------------------------------------------------------


def _component_labels(mesh, cut_facets_mask):
    """Cell components of the graph of uncut interior facets: 0 for every
    component that holds a cell with an uncut boundary facet, a distinct
    label > 0 for each other component."""
    import scipy.sparse as sps
    from scipy.sparse.csgraph import connected_components
    nc = mesh.num_cells
    fc = mesh.facet_cells
    interior = (fc[:, 1] >= 0) & ~cut_facets_mask
    a, b = fc[interior, 0], fc[interior, 1]
    g = sps.coo_matrix((np.ones(len(a), np.int8), (a, b)), shape=(nc, nc))
    _, comp = connected_components(g, directed=False)
    anchored = np.zeros(comp.max() + 1, bool)
    bmask = (fc[:, 1] < 0) & ~cut_facets_mask
    anchored[comp[fc[bmask, 0]]] = True
    return np.where(anchored[comp], 0, comp + 1).astype(np.int64)


def _cut_facets_exact(mesh, soup, ctmap):
    """Facets that surface triangles really intersect: the exact
    predicate-only segment/triangle (2D) and triangle/triangle (3D) tests
    of the native library over the candidate pairs."""
    from ..native import seg_tri_isect_batch, tri_tri_isect_batch
    cut_facets = np.zeros(mesh.num_facets, bool)
    counts = np.diff(ctmap.offsets)
    cell_idx = np.repeat(np.arange(mesh.num_cells), counts)
    if not len(cell_idx):
        return cut_facets
    nfpc = mesh.cell_facets.shape[1]
    fids_flat = mesh.cell_facets[cell_idx].ravel()
    tris = np.repeat(soup.triangle_coords()[ctmap.triangles], nfpc, axis=0)
    fverts = _pad3(mesh.vertices)[mesh.facets[fids_flat]]
    if mesh.facets.shape[1] == 3:
        hit = tri_tri_isect_batch(fverts, tris)
    elif mesh.facets.shape[1] == 2:
        hit = seg_tri_isect_batch(fverts, tris)
    else:
        raise NotImplementedError(
            "exact cut facets need simplex facets of 2 or 3 vertices")
    cut_facets[fids_flat[hit]] = True
    return cut_facets


def _sign_component_anchor(mesh, soup, ctmap, d, closest, nrm, frozen):
    """Cut facets block a flood fill; the boundary-anchored component is
    outside; near-band and ambiguous vertices use the closest-triangle
    normal test."""
    label = _component_labels(mesh, _cut_facets_exact(mesh, soup, ctmap))
    nv = mesh.num_vertices
    sign = np.zeros(nv)
    vert_out = np.zeros(nv, bool)
    vert_in = np.zeros(nv, bool)
    vert_out[mesh.cells[label == 0].ravel()] = True
    vert_in[mesh.cells[label > 0].ravel()] = True
    sign[vert_out & ~vert_in] = 1.0
    sign[vert_in & ~vert_out] = -1.0
    amb = frozen | (vert_in & vert_out) | (sign == 0.0)
    s = np.einsum("ij,ij->i", mesh.vertices[amb] - closest[amb], nrm[amb])
    sign[amb] = np.where(s >= 0, 1.0, -1.0)
    return sign


def _assign_last(sign, tgt, src, mask):
    """sign[tgt[mask]] = src[mask] where a repeated target takes its last
    masked entry (numpy's fancy assignment), deterministically."""
    pos = torch.where(mask, torch.arange(len(tgt), device=tgt.device), -1)
    last = torch.full_like(sign, -1, dtype=torch.int64)
    last.scatter_reduce_(0, tgt, pos, "amax")
    upd = last >= 0
    sign[upd] = src[last[upd]]


def _sign_local_normal_band(mesh, d, closest, nrm, frozen, device="cuda"):
    """Normal dot test in the near band, then propagation along edges, one
    layer per round (on the device); what no band reaches is outside."""
    dev = torch.device(device)
    sign = np.zeros(mesh.num_vertices)
    s = np.einsum("ij,ij->i", mesh.vertices[frozen] - closest[frozen],
                  nrm[frozen])
    sign[frozen] = np.where(s >= 0, 1.0, -1.0)
    sign = torch.as_tensor(sign, device=dev)
    edges = torch.as_tensor(mesh.edges, dtype=torch.int64, device=dev)
    a, b = edges[:, 0], edges[:, 1]
    while bool((sign == 0).any()):
        m1 = (sign[a] == 0) & (sign[b] != 0)
        _assign_last(sign, a, sign[b], m1)
        m2 = (sign[b] == 0) & (sign[a] != 0)
        _assign_last(sign, b, sign[a], m2)
        if not bool(m1.any() | m2.any()):
            sign[sign == 0] = 1.0
            break
    return sign.cpu().numpy()


def _sign_winding_number(mesh, soup, device="cuda"):
    """Generalized winding number: inside (w > 1/2) is negative. Soups of
    more than 4096 triangles take the clustered scheme of winding.py; the
    rest the brute batched sum."""
    if soup.tri.shape[0] > 4096:
        from .winding import build_winding_clusters, winding_numbers
        w = winding_numbers(mesh.vertices, build_winding_clusters(soup),
                            device=device)
        return np.where(w > 0.5, -1.0, 1.0)
    from .winding import _solid_angles
    dev = torch.device(device)
    P = torch.as_tensor(_pad3(mesh.vertices), dtype=F64, device=dev)
    T = torch.as_tensor(soup.triangle_coords(), dtype=F64, device=dev)
    out = []
    chunk = 8192
    for i in range(0, P.shape[0], chunk):
        p = P[i:i + chunk]
        out.append(_solid_angles(p, T[None].expand(p.shape[0], -1, -1, -1))
                   / (4 * np.pi))
    w = torch.cat(out).cpu().numpy()
    return np.where(w > 0.5, -1.0, 1.0)


def compute_signed_distance(mesh, soup: TriSoup, ctmap=None,
                            sign_mode=SignMode.component_anchor,
                            options: FMMOptions | None = None,
                            device="cuda"):
    """Signed distance at mesh vertices (host array, negative inside) and
    the FIM sweep count."""
    if ctmap is None:
        ctmap = build_cell_triangle_map(mesh, soup)
    d0, frozen, closest, nrm = _near_field(mesh, soup, ctmap, device)
    d, _, its = eikonal_solve(mesh, d0, frozen, options, device=device)
    d = d.cpu().numpy()
    if isinstance(sign_mode, str):
        sign_mode = SignMode(sign_mode)
    if sign_mode == SignMode.component_anchor:
        sign = _sign_component_anchor(mesh, soup, ctmap, d, closest, nrm,
                                      frozen)
    elif sign_mode == SignMode.local_normal_band:
        sign = _sign_local_normal_band(mesh, d, closest, nrm, frozen,
                                       device)
    else:
        sign = _sign_winding_number(mesh, soup, device)
    return sign * d, its


def _vertex_p1_function(mesh, values, name, device):
    """Per-vertex values as a float64 P1 Function (vertex dofs lead the
    global numbering)."""
    f = Function(FunctionSpace(mesh, ("Lagrange", 1), device=device),
                 name=name, dtype=F64)
    f.x = torch.as_tensor(np.asarray(values), dtype=F64, device=f.x.device)
    return f


def from_stl(mesh, path, *, sign_mode=SignMode.component_anchor,
             padding=0.0, options: FMMOptions | None = None,
             log_timings=True, device="cuda"):
    """STL -> signed-distance P1 Function on ``device``, with a per-phase
    timing log."""
    t0 = time.perf_counter()
    soup = distribute_stl(mesh, path, padding=padding)
    t1 = time.perf_counter()
    ctmap = build_cell_triangle_map(mesh, soup)
    t2 = time.perf_counter()
    d, its = compute_signed_distance(mesh, soup, ctmap, sign_mode=sign_mode,
                                     options=options, device=device)
    t3 = time.perf_counter()
    if log_timings:
        logger.info(
            "from_stl: distribute %.3fs, cell_triangle_map %.3fs, "
            "signed_distance %.3fs (%d FIM sweeps)",
            t1 - t0, t2 - t1, t3 - t2, its)
    return _vertex_p1_function(mesh, d, "signed_distance", device)


# -- reinitialization --------------------------------------------------------


def _interface_soup(mesh, phi):
    """Zero contour of phi as a segment (2D) / triangle (3D) soup in
    physical coordinates, the parent cell of each piece, and the CutData."""
    from ..cut.api import create_cut_mesh, cut as cut_fn
    cd = cut_fn(phi)
    cm = create_cut_mesh(cd, f"{cd.level_set_names[0]}=0", mode="cut_only")
    if cm.mesh is None:
        raise ValueError("level set has no zero contour on this mesh")
    return cm.mesh.cell_vertex_coords, cm.parent_index, cd


def _closest_pieces(points, pieces, device):
    """For each point the nearest segment/triangle of the soup: (distance,
    index (the first of equal ones), closest point), tensors on ``device``;
    chunked over the points so that a chunk holds at most _PAIR_CHUNK
    pairs."""
    dev = torch.device(device)
    g = points.shape[1]
    P = torch.as_tensor(pieces, dtype=F64, device=dev)
    if P.shape[1] == 2:
        pts = torch.as_tensor(points, dtype=F64, device=dev)
    else:
        pts = torch.as_tensor(_pad3(points), dtype=F64, device=dev)
        P = torch.nn.functional.pad(P, (0, 3 - P.shape[2]))
    step = max(1, _PAIR_CHUNK // max(P.shape[0], 1))
    d_out, i_out, c_out = [], [], []
    for s in range(0, pts.shape[0], step):
        p = pts[s:s + step, None, :]
        if P.shape[1] == 2:
            dmat, cl = point_segment_distance(p, P[None, :, 0, :],
                                              P[None, :, 1, :])
        else:
            dmat, cl = point_triangle_distance(p, P[None])
        dmin, best = torch.min(dmat, dim=1)
        d_out.append(dmin)
        i_out.append(best)
        c_out.append(cl[torch.arange(cl.shape[0], device=dev), best, :g])
    if not d_out:
        return (torch.zeros(0, dtype=F64, device=dev),
                torch.zeros(0, dtype=torch.int64, device=dev),
                torch.zeros((0, g), dtype=F64, device=dev))
    return torch.cat(d_out), torch.cat(i_out), torch.cat(c_out)


def _exact_distance_to_pieces(points, pieces, device="cuda"):
    """Min distance from each point to a soup of segments/triangles (host
    array)."""
    return _closest_pieces(points, pieces, device)[0].cpu().numpy()


def reinitialize(phi, options: FMMOptions | None = None):
    """Rebuild phi as a signed distance to its own zero contour: exact
    near field on cut-cell vertices, FIM far field, phi's sign restored.

    Degree >= 2 level sets: the P1 carrier solve is interpolated linearly
    into phi's space, and every dof of a cut cell takes its exact distance
    to the interface pieces (marched from the vertex values)."""
    mesh = phi.function_space.mesh
    V = phi.function_space
    dev = phi.x.device
    pieces, _, cd = _interface_soup(mesh, phi)
    nv = mesh.num_vertices
    inf = (options or FMMOptions()).inf
    d0 = np.full(nv, inf)
    cut_cells = cd.locate(f"{cd.level_set_names[0]}=0")
    near_verts = np.unique(mesh.cells[cut_cells].ravel())
    d0[near_verts] = _exact_distance_to_pieces(mesh.vertices[near_verts],
                                               pieces, dev)
    d, _, _ = eikonal_solve(mesh, d0, d0 < inf * 0.5, options, device=dev)
    d = d.cpu().numpy()
    x = phi.x.detach().cpu().numpy()
    out = phi.copy()
    if V.degree == 1:
        sign = np.where(x[:nv] < 0, -1.0, 1.0)
        out.x = torch.as_tensor(sign * d, dtype=phi.x.dtype, device=dev)
        return out
    vals = _interp_p1_to_space(V, d)
    near_dofs = np.unique(V.dofmap[cut_cells].ravel())
    vals[near_dofs] = _exact_distance_to_pieces(
        V.dof_coordinates[near_dofs], pieces, dev)
    sign = np.where(x < 0, -1.0, 1.0)
    out.x = torch.as_tensor(sign * vals, dtype=phi.x.dtype, device=dev)
    return out


def reinitialize_from_facets(mesh_or_phi, facets,
                             options: FMMOptions | None = None,
                             phi_sign=None, device="cuda"):
    """Distance to a set of mesh facets, signed by ``phi_sign`` (or the
    level set's vertex values when a Function is given, on its device)."""
    if isinstance(mesh_or_phi, Function):
        mesh = mesh_or_phi.function_space.mesh
        device = mesh_or_phi.x.device
        phi_sign = mesh_or_phi.x.detach().cpu().numpy()[:mesh.num_vertices]
    else:
        mesh = mesh_or_phi
    facets = np.asarray(facets)
    pieces = mesh.vertices[mesh.facets[facets]]
    nv = mesh.num_vertices
    inf = (options or FMMOptions()).inf
    d0 = np.full(nv, inf)
    fc = mesh.facet_cells[facets]
    cells = np.unique(fc[fc >= 0])
    near_verts = np.unique(mesh.cells[cells].ravel())
    d0[near_verts] = _exact_distance_to_pieces(mesh.vertices[near_verts],
                                               pieces, device)
    d, _, _ = eikonal_solve(mesh, d0, d0 < inf * 0.5, options,
                            device=device)
    d = d.cpu().numpy()
    if phi_sign is not None:
        d = np.where(np.asarray(phi_sign) < 0, -d, d)
    return _vertex_p1_function(mesh, d, "distance", device)


# -- normal-velocity extension ----------------------------------------------


@dataclass
class NormalExtensionResult:
    """Extended speed, velocity = speed * normal, and the signed
    distance."""
    speed: Function
    velocity: Function
    signed_distance: Function


def extend_normal_velocity(phi, interface_speed,
                           options: FMMOptions | None = None,
                           target_space=None):
    """Extend a scalar interface speed into the bulk along the
    characteristics of the distance function: the exact near field with
    the speed evaluated at the closest interface point, FIM payload
    transport of (speed, normal) to the far field, velocity = speed *
    normal. Functions come back in float64 on phi's device."""
    mesh = phi.function_space.mesh
    V = phi.function_space
    if V.degree != 1:
        raise NotImplementedError("extend_normal_velocity supports P1")
    dev = phi.x.device
    pieces, parents, cd = _interface_soup(mesh, phi)
    nv, gdim = mesh.num_vertices, mesh.gdim
    inf = (options or FMMOptions()).inf
    cut_cells = cd.locate(f"{cd.level_set_names[0]}=0")
    near_verts = np.unique(mesh.cells[cut_cells].ravel())
    d_near, best, closest = _closest_pieces(mesh.vertices[near_verts],
                                            pieces, dev)
    host = parents[best.cpu().numpy()]           # background cell per point
    speed_vals = _eval_function_at(interface_speed, host, closest)
    normal_vals = _levelset_normal_at(phi, host, closest)
    d0 = np.full(nv, inf)
    d0[near_verts] = d_near.cpu().numpy()
    payload = torch.zeros((nv, 1 + gdim), dtype=F64, device=dev)
    nv_t = torch.as_tensor(near_verts, device=dev)
    payload[nv_t, 0] = speed_vals
    payload[nv_t, 1:] = normal_vals
    d, pay, _ = eikonal_solve(mesh, d0, d0 < inf * 0.5, options,
                              payload=payload, device=dev)
    pay = pay.cpu().numpy()
    nrm = pay[:, 1:]
    nrm = nrm / np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True),
                           1e-14)
    vel_vals = pay[:, :1] * nrm
    sign = np.where(phi.x.detach().cpu().numpy()[:nv] < 0, -1.0, 1.0)
    sd = sign * d.cpu().numpy()
    if target_space is None:
        Vvec = FunctionSpace(mesh, ("Lagrange", 1), shape=(gdim,),
                             device=dev)
        vel = Function(Vvec, name="extension_velocity", dtype=F64)
        vel.x = torch.as_tensor(vel_vals.reshape(-1), device=dev)
        return NormalExtensionResult(
            _vertex_p1_function(mesh, pay[:, 0], "extended_speed", dev),
            vel, _vertex_p1_function(mesh, sd, "signed_distance", dev))
    # the P1 carrier triple interpolated into the target space (and the
    # matching vector space)
    if target_space.mesh is not mesh:
        raise ValueError("target_space must live on phi's mesh")
    if target_space.value_shape:
        raise ValueError("target_space must be scalar")
    tdev = target_space.device

    def on_target(space, vals, name):
        f = Function(space, name=name, dtype=F64)
        f.x = torch.as_tensor(vals, dtype=F64, device=tdev)
        return f

    Vtv = FunctionSpace(mesh, ("Lagrange", target_space.degree),
                        shape=(gdim,), device=tdev)
    comps = [_interp_p1_to_space(target_space, vel_vals[:, k])
             for k in range(gdim)]
    return NormalExtensionResult(
        on_target(target_space, _interp_p1_to_space(target_space,
                                                     pay[:, 0]),
                  "extended_speed"),
        on_target(Vtv, np.stack(comps, axis=1).reshape(-1),
                  "extension_velocity"),
        on_target(target_space, _interp_p1_to_space(target_space, sd),
                  "signed_distance"))


def _interp_p1_to_space(V, vertex_vals):
    """Exact linear interpolation of a P1 vertex field into a scalar
    Lagrange space on the same mesh: vertex dofs copy, edge-interior dofs
    interpolate along the (ascending) edge, face dofs take the face-vertex
    mean (one symmetric point, P <= 3), cell-interior dofs the P1 value at
    their point (host numpy)."""
    mesh = V.mesh
    vertex_vals = np.asarray(vertex_vals)
    if V.degree == 1 and V.family == "Lagrange":
        return vertex_vals.copy()
    from ..elements import lagrange_element
    el = V.element
    phi_geo = np.asarray(lagrange_element(mesh.cell_type, 1).tabulate(
        np.asarray(el.dof_points)))
    cell = mesh.ref_cell
    tdim = mesh.tdim
    out = np.zeros(V.num_scalar_dofs, vertex_vals.dtype)
    out[:mesh.num_vertices] = vertex_vals
    for (edim, eidx), dofs in el.entity_dofs.items():
        if edim == 0 or eidx != 0:
            continue
        if edim == 1 and tdim >= 2:
            _, lb = cell.edges[0]
            ts = phi_geo[np.asarray(dofs), lb]
            e = mesh.edges
            lo, hi = vertex_vals[e[:, 0]], vertex_vals[e[:, 1]]
            base = V._edge_off + np.arange(mesh.num_edges,
                                           dtype=np.int64) * len(ts)
            for j, t in enumerate(ts):
                out[base + j] = (1.0 - t) * lo + t * hi
        elif edim == tdim - 1 and tdim == 3:
            centers = vertex_vals[mesh.facets].mean(axis=1)
            base = V._face_off + np.arange(mesh.num_facets,
                                           dtype=np.int64) * len(dofs)
            for j in range(len(dofs)):
                out[base + j] = centers
        elif edim == tdim or (edim == 1 and tdim == 1):
            d = np.asarray(sorted(dofs))
            vals = np.einsum("dk,ck->cd", phi_geo[d],
                             vertex_vals[mesh.cells])
            out[V.dofmap[:, d].ravel()] = vals.ravel()
    return out


def _pullback_simplex(coords, x):
    """Reference coordinates of physical points x (n, gdim) in simplices
    with vertex coordinates coords (n, nv, gdim): (n, tdim)."""
    J = torch.movedim(coords[:, 1:, :] - coords[:, :1, :], 1, 2)
    K = torch.linalg.inv(J) if J.shape[-1] == J.shape[-2] \
        else torch.linalg.pinv(J)
    return torch.einsum("ntg,ng->nt", K, x - coords[:, 0, :])


def _cell_data(f, cells, points_phys):
    V = f.function_space
    mesh = V.mesh
    dev = points_phys.device
    coords = torch.as_tensor(mesh.cell_vertex_coords[cells], dtype=F64,
                             device=dev)
    x = points_phys.to(F64)
    if mesh.ref_cell.is_simplex:
        ref = _pullback_simplex(coords, x)
    else:
        ref = torch.func.vmap(lambda c, p: pullback(
            mesh.cell_type, c, p[None])[0])(coords, x)
    dofs = f.x.to(device=dev, dtype=F64)[
        torch.as_tensor(V.dofmap[cells], dtype=torch.int64, device=dev)]
    return V, mesh, coords, ref, dofs


def _eval_function_at(f, cells, points_phys):
    """Values of a scalar Function at physical points (tensor (n, gdim))
    inside the given cells: (n,) float64 tensor."""
    V, _, _, ref, dofs = _cell_data(f, cells, points_phys)
    return torch.einsum("nd,nd->n", V.element.tabulate(ref), dofs)


def _levelset_normal_at(phi, cells, points_phys):
    """Unit gradient of phi at physical points inside the given cells:
    (n, gdim) float64 tensor."""
    from ..elements import lagrange_element
    V, mesh, coords, ref, dofs = _cell_data(phi, cells, points_phys)
    gref = torch.einsum("ndt,nd->nt", V.element.tabulate_grad(ref), dofs)
    dphi = lagrange_element(mesh.cell_type, 1).tabulate_grad(ref)
    J = torch.einsum("nvg,nvt->ngt", coords, dphi)
    g = torch.einsum("ntg,nt->ng", torch.linalg.inv(J), gref)
    nn = torch.linalg.vector_norm(g, dim=1, keepdim=True)
    return g / torch.clamp(nn, min=1e-14)


# -- mesh adaptation ---------------------------------------------------------


def refinement_edges_from_stl(mesh, soup_or_path, *, rings=1):
    """Unique edges of STL-intersecting cells (+ k facet-neighbour rings),
    the marker set for refinement."""
    soup = soup_or_path if isinstance(soup_or_path, TriSoup) else \
        read_stl(soup_or_path)
    ctmap = build_cell_triangle_map(mesh, soup)
    marked = np.zeros(mesh.num_cells, bool)
    marked[ctmap.cells_with_triangles()] = True
    fc = mesh.facet_cells
    interior = fc[:, 1] >= 0
    a, b = fc[interior, 0], fc[interior, 1]
    for _ in range(rings):
        nxt = marked.copy()
        nxt[a[marked[b]]] = True
        nxt[b[marked[a]]] = True
        marked = nxt
    return np.unique(mesh.cell_edges[marked].ravel()).astype(np.int32)


def adapt_mesh_to_stl(mesh, path, *, max_iterations=3, rings=1):
    """Refine the cells near the STL surface, up to ``max_iterations``
    times."""
    from ..refine import refine_marked
    soup = read_stl(path)
    for _ in range(max_iterations):
        edges = refinement_edges_from_stl(mesh, soup, rings=rings)
        if len(edges) == 0:
            break
        mesh = refine_marked(mesh, edges)
    return mesh
