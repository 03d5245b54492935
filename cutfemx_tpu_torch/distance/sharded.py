"""Sharded Fast Iterative Method: slab-partitioned vertices with a ghost
min-exchange every sweep.

The torch counterpart of ``cutfemx_tpu.distance.sharded`` (the role of the
reference's distributed Eikonal loop with its ghost MPI_MIN reduces): cells
partition into slabs (reusing the halo machinery — P1 dofs are exactly
mesh vertices), each slab sweeps its own virtual-simplex updates, and
shared/ghost vertices are combined owner-wise with a MIN through the slab
mesh's ppermutes. cutfemx_tpu runs the whole iteration inside one
shard_mapped ``lax.while_loop`` with a ``pmax`` convergence test; here the
loop runs on the host, as the serial ``fim.eikonal_solve`` does, reading
the pmax of each sweep's change. The sweep count is the reference's: the
first sweep whose change is at or below ``tol`` ends it.
"""

from __future__ import annotations

import numpy as np
import torch

from .fim import FMMOptions, _all_candidates, _Geometry, build_update_stencil

__all__ = ["sharded_eikonal_solve", "distribute_stl_sharded",
           "sharded_signed_distance"]


def sharded_eikonal_solve(mesh, d0, frozen, device_mesh, axis="cells",
                          options: FMMOptions | None = None,
                          dtype=torch.float64):
    """Distributed |grad d| = 1 solve. Returns (d_global, iterations).

    mesh: background Mesh; d0 (NV,) initial values (inf on unknown);
    frozen (NV,) bool; device_mesh: a slab mesh (``make_device_mesh``)
    with the named axis to shard over.
    """
    opts = options or FMMOptions()
    from ..functionspace import FunctionSpace
    from ..parallel.halo import build_slab_partition

    nparts = device_mesh.shape[axis]
    comm = device_mesh.comm
    put = device_mesh.put
    dev = device_mesh.device
    V1 = FunctionSpace(mesh, ("Lagrange", 1), device="cpu")  # dofs = verts
    part = build_slab_partition(V1, nparts)

    upd_v, upd_others = build_update_stencil(mesh)
    d = mesh.tdim
    g = mesh.gdim
    nsub = mesh.ref_cell.simplex_split.shape[0]
    # build_update_stencil emits (d+1) blocks over all virtual simplices
    cell_of_entry = np.tile(np.repeat(np.arange(mesh.num_cells), nsub),
                            d + 1)
    slab = part.cell_part[cell_of_entry]

    emax = max(int(np.bincount(slab, minlength=nparts).max()), 1)
    LS = part.local_size
    Lv = np.zeros((nparts, emax), np.int64)
    Lo = np.zeros((nparts, emax, d), np.int64)
    valid = np.zeros((nparts, emax), bool)
    XV = np.zeros((nparts, emax, g))
    XO = np.zeros((nparts, emax, d, g))
    verts = mesh.vertices
    for p in range(nparts):
        sel = np.flatnonzero(slab == p)
        if not len(sel):
            continue
        m = len(sel)
        valid[p, :m] = True
        Lv[p, :m] = part.locals_of_globals(p, upd_v[sel])
        Lo[p, :m] = part.locals_of_globals(p, upd_others[sel])
        XV[p, :m] = verts[upd_v[sel]]
        XO[p, :m] = verts[upd_others[sel]]

    gol = part.global_of_local
    vmask = gol >= 0
    d0l = np.full((nparts, LS), opts.inf)
    d0l[vmask] = np.asarray(d0)[gol[vmask]]
    frzl = np.zeros((nparts, LS), bool)
    frzl[vmask] = np.asarray(frozen)[gol[vmask]]
    ownl = np.zeros((nparts, LS), bool)
    for p in range(nparts):
        ownl[p, :part.n_owned[p]] = True

    xv, xo = put(XV, dtype), put(XO, dtype)
    nloc = xv.shape[0]
    # the planar updates' geometry, once per solve (padded entries are
    # masked out of every sweep)
    geo = _Geometry(xv.reshape(-1, g), xo.reshape(-1, d, g))
    lv, lo, val = put(Lv), put(Lo), put(valid)
    frz, own = put(frzl), put(ownl)
    sl, sr = put(part.send_left_slots), put(part.send_right_slots)
    glv, grv = put(part.ghostl_valid), put(part.ghostr_valid)
    idx = torch.tensor(list(device_mesh.local), device=dev)[:, None]
    om, gl, gr = part.owned_max, part.gl_max, part.gr_max
    inf = float(opts.inf)
    left = [(p, p - 1) for p in range(1, nparts)]
    right = [(p, p + 1) for p in range(nparts - 1)]

    def exchange_min(dv):
        # ghost -> owner min (2 ppermutes), then owner -> ghost refresh
        from_right = comm.ppermute(
            torch.where(glv, dv[:, om:om + gl], inf), left)
        from_right = torch.where(idx < nparts - 1, from_right, inf)
        dv = dv.scatter_reduce(1, sl, from_right, "amin")
        from_left = comm.ppermute(
            torch.where(grv, dv[:, om + gl:om + gl + gr], inf), right)
        from_left = torch.where(idx > 0, from_left, inf)
        dv = dv.scatter_reduce(1, sr, from_left, "amin")
        to_right = comm.ppermute(torch.gather(dv, 1, sl), right)
        dv[:, om:om + gl] = torch.where(glv & (idx > 0), to_right, inf)
        to_left = comm.ppermute(torch.gather(dv, 1, sr), left)
        dv[:, om + gl:om + gl + gr] = torch.where(
            grv & (idx < nparts - 1), to_left, inf)
        return dv

    def sweep(dv):
        dvals = torch.gather(dv, 1, lo.reshape(nloc, -1)).reshape(
            -1, d)                                            # (P*E, d)
        cand, _, _ = _all_candidates(geo, dvals, inf)
        cand = torch.where(val, cand.reshape(nloc, emax), inf)
        new = torch.full_like(dv, inf).scatter_reduce(1, lv, cand, "amin")
        new = torch.where(frz, dv, torch.minimum(dv, new))
        new = exchange_min(new)
        known = own & (dv < inf * 0.5)
        ch = torch.where(known, torch.abs(new - dv), 0.0).amax(1)
        big = (own & ~(dv < inf * 0.5) & (new < inf * 0.5)).any(1)
        return new, comm.pmax(torch.maximum(ch, big.to(dv.dtype)))[0]

    dv = exchange_min(put(d0l, dtype))
    it = 0
    while it < opts.max_iter:
        dv, change = sweep(dv)
        it += 1
        if not bool(change > opts.tol):
            break

    dl = device_mesh.gather(dv)
    out = np.full(mesh.num_vertices, opts.inf)
    own_valid = ownl & vmask
    out[gol[own_valid]] = dl[own_valid]
    return out, it


# -- distributed STL routing + end-to-end sharded signed distance -------------


def distribute_stl_sharded(mesh, soup, part, padding=None):
    """Route triangles to slabs by padded-AABB overlap (the role of the
    reference's global AABB exchange + Alltoallv): each slab keeps exactly
    the triangles whose AABB overlaps its padded cell bounding box, so
    every (slab cell, triangle) candidate pair of the global broad phase is
    present locally.

    Returns a list of TriSoup, one per slab (empty slabs get the empty
    soup)."""
    from .stl import TriSoup

    if padding is None:
        # one cell diameter: slab-cell candidates stay local
        padding = float(mesh.cell_diameters().max())
    tc = soup.triangle_coords()
    tlo, thi = tc.min(axis=1), tc.max(axis=1)
    out = []
    for p in range(part.nparts):
        cells = np.flatnonzero(part.cell_part == p)
        if not len(cells):
            out.append(TriSoup(soup.X, soup.tri[:0], soup.N[:0],
                               soup.tri_gid[:0]))
            continue
        cv = mesh.cell_vertex_coords[cells].reshape(-1, mesh.gdim)
        lo = cv.min(axis=0) - padding
        hi = cv.max(axis=0) + padding
        keep = ((thi[:, :mesh.gdim] >= lo)
                & (tlo[:, :mesh.gdim] <= hi)).all(axis=1)
        out.append(TriSoup(soup.X, soup.tri[keep], soup.N[keep],
                           soup.tri_gid[keep]))
    return out


def sharded_signed_distance(mesh, soup, device_mesh, axis="cells",
                            options: FMMOptions | None = None,
                            padding=None):
    """Distributed signed distance: per-slab STL routing -> per-slab exact
    near field (owner-restricted) -> sharded FIM far field -> sign by the
    near-band normal test with outward edge propagation (the reference's
    parallel mode). Returns (d (NV,), iterations)."""
    from ..functionspace import FunctionSpace
    from ..parallel.halo import build_slab_partition
    from .api import _near_field, _sign_local_normal_band
    from .stl import build_cell_triangle_map

    opts = options or FMMOptions()
    dev = device_mesh.device
    nparts = device_mesh.shape[axis]
    V1 = FunctionSpace(mesh, ("Lagrange", 1), device="cpu")
    part = build_slab_partition(V1, nparts)
    soups = distribute_stl_sharded(mesh, soup, part, padding=padding)

    nv = mesh.num_vertices
    gdim = mesh.gdim
    d0 = np.full(nv, opts.inf)
    closest = np.zeros((nv, gdim))
    nrm = np.zeros((nv, gdim))
    frozen = np.zeros(nv, bool)
    for p in range(nparts):
        if soups[p].num_triangles == 0:
            continue
        ctmap_p = build_cell_triangle_map(mesh, soups[p])
        d0_p, fr_p, cl_p, nr_p = _near_field(mesh, soups[p], ctmap_p, dev)
        # owner-restricted merge (the ghost min-reduce happens inside the
        # FIM loop; near-field values are exact per owner)
        own = part.dof_owner == p
        upd = own & (d0_p < d0)
        d0[upd] = d0_p[upd]
        closest[upd] = cl_p[upd]
        nrm[upd] = nr_p[upd]
        frozen |= own & fr_p

    d, its = sharded_eikonal_solve(mesh, d0, frozen, device_mesh,
                                   axis=axis, options=opts)
    sign = _sign_local_normal_band(mesh, d, closest, nrm, frozen, dev)
    return sign * d, its
