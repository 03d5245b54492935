"""Owner-computes halo-exchange parallelism over a slab mesh.

The torch counterpart of ``cutfemx_tpu.parallel.halo`` (the role of
DOLFINx IndexMap ghost scatters): cells partition into contiguous geometric
slabs along the domain's longest axis; each slab also carries a one-cell
ghost layer so facet-coupling terms (ghost penalty, DG) assemble locally.
Dofs are owned by the lowest-index slab touching them; each slab's locals
are [owned | left ghosts (owner p-1) | right ghosts (owner p+1)].
``scatter_rev`` (ghost -> owner add) and ``scatter_fwd`` (owner -> ghost
refresh) are two ``ppermute`` pairs of the mesh's communicator; CG dot
products reduce owned entries with a ``psum``.

The partition is host numpy and equals the reference's exactly. Sharded
tensors carry the slab axis first; every scatter with repeated targets is a
sorted segment sum (no atomics), so two runs agree bitwise on the card.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..fem import segment_sum_sorted, sorted_scatter_plan

__all__ = ["SlabPartition", "build_slab_partition", "HaloOperator"]


@dataclass
class SlabPartition:
    """Host-side partition data, padded to uniform per-slab sizes."""
    nparts: int
    cell_part: np.ndarray          # (NC,) owning slab per cell
    n_owned: np.ndarray            # (P,)
    owned_max: int
    gl_max: int                    # left-ghost padding
    gr_max: int                    # right-ghost padding
    local_size: int                # owned_max + gl_max + gr_max
    global_of_local: np.ndarray    # (P, local_size), -1 padded
    # exchange tables (aligned with the neighbor's ghost slot order):
    send_left_slots: np.ndarray    # (P, gl_max): owned slots of p that
    #                                 p+1 holds as left ghosts
    send_right_slots: np.ndarray   # (P, gr_max): owned slots of p that
    #                                 p-1 holds as right ghosts
    ghostl_valid: np.ndarray       # (P, gl_max) bool
    ghostr_valid: np.ndarray       # (P, gr_max) bool
    dof_owner: np.ndarray
    owned_ids: list                # per part: sorted global dofs owned
    gl_ids: list                   # per part: sorted left-ghost globals
    gr_ids: list                   # per part: sorted right-ghost globals

    def locals_of_globals(self, p: int, g: np.ndarray) -> np.ndarray:
        """Vectorized (global dof -> local slot) map for part p. Raises if
        any dof is neither owned by p nor in p's ghost layer."""
        g = np.asarray(g)
        owner = self.dof_owner[g]
        loc = np.empty(g.shape, np.int64)
        pools = ((p, self.owned_ids[p], 0),
                 (p - 1, self.gl_ids[p], self.owned_max),
                 (p + 1, self.gr_ids[p], self.owned_max + self.gl_max))
        covered = np.zeros(g.shape, bool)
        for q, ids, off in pools:
            m = owner == q
            if not m.any():
                continue
            idx = np.searchsorted(ids, g[m])
            ok = (idx < len(ids))
            ok &= np.where(ok, ids[np.minimum(idx, len(ids) - 1)] == g[m],
                           False)
            if not ok.all():
                raise ValueError(
                    "integral couples dofs outside the slab's ghost "
                    "layer; use fewer partitions")
            loc[m] = off + idx
            covered |= m
        if not covered.all():
            raise ValueError(
                "integral couples dofs outside the slab's ghost layer; "
                "use fewer partitions")
        return loc


class _NonNeighborGhosts(ValueError):
    pass


def build_slab_partition(V, nparts, weights=None) -> SlabPartition:
    """Partition cells of V.mesh into geometric slabs with one-cell ghost
    layers and build the two-sided halo layout for V's blocked dofs.

    ``weights`` (optional, per cell) balances slab boundaries by cumulative
    weight instead of cell count. If ``nparts`` slabs would be so thin that
    a ghost layer spans two slabs, weights are first blended toward
    uniform, then the cells are spread over fewer non-empty slabs —
    trailing slabs own nothing but still take part in the collectives."""
    if weights is not None:
        w = np.asarray(weights, float)
        u = np.full_like(w, max(w.mean(), 1e-12))
        candidates = [b * w + (1.0 - b) * u
                      for b in (1.0, 0.75, 0.5, 0.25)] + [None]
    else:
        candidates = [None]
    last_err = None
    for m in range(nparts, 0, -1):
        for wts in candidates:
            try:
                return _build_slab_partition_m(V, nparts, m, wts)
            except _NonNeighborGhosts as e:
                last_err = e
    raise last_err


def _split_cells(order, m, weights):
    if weights is None:
        return list(np.array_split(order, m))
    w = np.asarray(weights, float)[order]
    cw = np.cumsum(w)
    bounds = np.searchsorted(cw, cw[-1] * np.arange(1, m) / m)
    return list(np.split(order, bounds))


def _build_slab_partition_m(V, nparts, m, weights=None) -> SlabPartition:
    mesh = V.mesh
    bd = V.blocked_dofmap
    ndofs = V.dim

    mids = mesh.midpoints()
    extent = mesh.vertices.max(axis=0) - mesh.vertices.min(axis=0)
    axis = int(np.argmax(extent))
    order = np.argsort(mids[:, axis], kind="stable")
    parts_cells = _split_cells(order, m, weights)
    parts_cells += [np.empty(0, np.int64)] * (nparts - m)
    cell_part = np.empty(mesh.num_cells, np.int32)
    for p, cs in enumerate(parts_cells[:m]):
        cell_part[cs] = p

    # dof owner = lowest slab touching it: write slabs in descending order
    # so lower indices overwrite
    dof_owner = np.full(ndofs, nparts, np.int32)
    for p in range(m - 1, -1, -1):
        dof_owner[bd[parts_cells[p]].ravel()] = p

    # one-cell ghost layer via facet adjacency
    fc = mesh.facet_cells
    interior = fc[:, 1] >= 0
    a, b = fc[interior, 0], fc[interior, 1]

    owned_lists, gl_lists, gr_lists = [], [], []
    empty = np.empty(0, np.int64)
    for p in range(nparts):
        if p >= m:
            owned_lists.append(empty)
            gl_lists.append(empty)
            gr_lists.append(empty)
            continue
        own_cells = parts_cells[p]
        in_p = cell_part == p
        nb = np.concatenate([b[in_p[a]], a[in_p[b]]])
        layer_cells = np.unique(np.concatenate([own_cells, nb]))
        touched = np.unique(bd[layer_cells].ravel())
        owned = np.flatnonzero(dof_owner == p).astype(np.int64)
        ghosts = touched[dof_owner[touched] != p]
        owners = dof_owner[ghosts]
        if len(ghosts) and not np.isin(owners, [p - 1, p + 1]).all():
            raise _NonNeighborGhosts(
                "slab partition has non-neighbor ghosts; use fewer "
                "partitions or a finer mesh")
        owned_lists.append(owned)
        gl_lists.append(np.sort(ghosts[owners == p - 1]).astype(np.int64))
        gr_lists.append(np.sort(ghosts[owners == p + 1]).astype(np.int64))

    owned_max = max(len(o) for o in owned_lists)
    gl_max = max(max((len(g) for g in gl_lists), default=0), 1)
    gr_max = max(max((len(g) for g in gr_lists), default=0), 1)
    local_size = owned_max + gl_max + gr_max

    global_of_local = np.full((nparts, local_size), -1, np.int64)
    for p in range(nparts):
        global_of_local[p, :len(owned_lists[p])] = owned_lists[p]
        global_of_local[p, owned_max:owned_max + len(gl_lists[p])] = \
            gl_lists[p]
        go = owned_max + gl_max
        global_of_local[p, go:go + len(gr_lists[p])] = gr_lists[p]

    part = SlabPartition(
        nparts=nparts, cell_part=cell_part,
        n_owned=np.array([len(o) for o in owned_lists], np.int32),
        owned_max=owned_max, gl_max=gl_max, gr_max=gr_max,
        local_size=local_size, global_of_local=global_of_local,
        send_left_slots=np.zeros((nparts, gl_max), np.int64),
        send_right_slots=np.zeros((nparts, gr_max), np.int64),
        ghostl_valid=np.zeros((nparts, gl_max), bool),
        ghostr_valid=np.zeros((nparts, gr_max), bool),
        dof_owner=dof_owner, owned_ids=owned_lists, gl_ids=gl_lists,
        gr_ids=gr_lists)

    for p in range(nparts):
        part.ghostl_valid[p, :len(gl_lists[p])] = True
        part.ghostr_valid[p, :len(gr_lists[p])] = True
        if p + 1 < nparts and len(gl_lists[p + 1]):
            # p+1's left ghosts are owned by p: local slot = owned index
            part.send_left_slots[p, :len(gl_lists[p + 1])] = \
                np.searchsorted(owned_lists[p], gl_lists[p + 1])
        if p - 1 >= 0 and len(gr_lists[p - 1]):
            part.send_right_slots[p, :len(gr_lists[p - 1])] = \
                np.searchsorted(owned_lists[p], gr_lists[p - 1])
    return part


class _SlabScatter:
    """Sorted scatter plan of per-slab local rows (P_local, E, nd) into
    (P_local, size) slab vectors: one segment sum for all slabs and
    instances, in a fixed order."""

    def __init__(self, rows, size, device):
        nloc = rows[0].shape[0] if rows else 0
        off = np.arange(nloc, dtype=np.int64)[:, None] * size
        flat = np.concatenate([(np.asarray(r, np.int64).reshape(nloc, -1)
                                + off).ravel() for r in rows]) \
            if rows else np.zeros(0, np.int64)
        self.shape = (nloc, size)
        self.perm, self.lengths = sorted_scatter_plan(flat, nloc * size,
                                                      device)

    def __call__(self, parts):
        """parts: per instance (P_local, E, nd) contributions."""
        flat = torch.cat([p.reshape(-1) for p in parts])
        return segment_sum_sorted(flat[self.perm], self.lengths) \
            .reshape(self.shape)


def _gather_rows(x, D):
    """x (P, n), D (P, E, nd) -> x[p, D[p]]: (P, E, nd)."""
    return torch.gather(x, 1, D.reshape(D.shape[0], -1)).reshape(D.shape)


class HaloOperator:
    """Distributed matrix-free operator + CG over slab-sharded dofs.

    Element batches are regrouped per slab (entities live on the slab of
    their first cell; the ghost layer guarantees all their dofs are
    local). One apply = local batched matvec + scatter + ghost->owner adds
    (2 ppermutes) + owner->ghost refresh (2 ppermutes).

    Two construction paths:

    - ``HaloOperator(form, domain, part, mesh)`` — ORACLE path: builds the
      global element set serially, then regroups per slab.
    - ``HaloOperator.from_device(part, mesh, d_instances, d_active)`` —
      production path fed by the owner-computes pipeline
      (parallel/spipeline.py): element matrices arrive as per-slab device
      tensors; no global element array ever exists.
    """

    @classmethod
    def from_device(cls, partition: SlabPartition, mesh, d_instances,
                    d_active, axis="cells"):
        """Build from per-slab device element data.

        d_instances: tuple of (A, D) tensors with shapes (P_local, E, nd,
        nd) / (P_local, E, nd) (D holds LOCAL slots). d_active:
        (P_local, local_size) bool, or None (set later)."""
        self = cls.__new__(cls)
        self.part = partition
        self.mesh = mesh
        self.axis = axis
        self.instances = None   # no host copy on this path
        self._init_device(tuple(d_instances), d_active)
        return self

    def __init__(self, form, domain, partition: SlabPartition, mesh,
                 axis="cells"):
        from ..fem import CutOperator
        part = partition
        self.part = part
        self.mesh = mesh
        self.axis = axis
        op = CutOperator(form, domain, apply_plan=False)
        if len(op.element_matrices) == 0:
            raise ValueError("empty operator")

        stacked = []
        for Ae, rows, inst in zip(op.element_matrices, op._rows_host,
                                  form.instances):
            Ae = Ae.detach().cpu().numpy()
            cells = np.asarray(inst.rows_cells)
            cells0 = cells if cells.ndim == 1 else cells[:, 0]
            slabs = part.cell_part[cells0]
            nd = rows.shape[1]
            counts = np.bincount(slabs, minlength=part.nparts)
            emax = max(int(counts.max()), 1)
            A = np.zeros((part.nparts, emax, nd, nd), Ae.dtype)
            D = np.full((part.nparts, emax, nd), part.local_size - 1,
                        np.int64)
            for p in range(part.nparts):
                sel = np.flatnonzero(slabs == p)
                if not len(sel):
                    continue
                A[p, :len(sel)] = Ae[sel]
                D[p, :len(sel)] = part.locals_of_globals(p, rows[sel])
            stacked.append((A, D))
        self.instances = stacked

        active = op.active.cpu().numpy() if op.active is not None else None
        gol = part.global_of_local
        valid = gol >= 0
        ga = np.zeros((part.nparts, part.local_size), bool)
        ga[valid] = active[gol[valid]] if active is not None else True
        self.active_local = ga
        self._init_device(tuple((mesh.put(A), mesh.put(D))
                                for A, D in stacked), mesh.put(ga))

    def _init_device(self, d_instances, d_active):
        part, mesh = self.part, self.mesh
        self.owned_mask = np.zeros((part.nparts, part.local_size), bool)
        for p in range(part.nparts):
            self.owned_mask[p, :part.n_owned[p]] = True
        self.d_instances = d_instances
        self.d_active = d_active
        self.d_owned = mesh.put(self.owned_mask)
        self.d_send_l = mesh.put(part.send_left_slots)
        self.d_send_r = mesh.put(part.send_right_slots)
        self.d_gl_valid = mesh.put(part.ghostl_valid)
        self.d_gr_valid = mesh.put(part.ghostr_valid)
        self._scatter = _SlabScatter(
            [D.cpu().numpy() for _, D in d_instances], part.local_size,
            mesh.device)

    # -- vector layout helpers ----------------------------------------------

    def to_local(self, x_global):
        gol = self.part.global_of_local
        x = np.asarray(x_global)
        out = np.zeros(gol.shape, x.dtype)
        valid = gol >= 0
        out[valid] = x[gol[valid]]
        return self.mesh.put(out)

    def to_global(self, x_local):
        gol = self.part.global_of_local
        xl = self.mesh.gather(x_local)
        out = np.zeros(int(self.part.dof_owner.shape[0]), xl.dtype)
        own = self.owned_mask & (gol >= 0)
        out[gol[own]] = xl[own]
        return out

    def solve_cg(self, b_global, rtol=1e-8, maxiter=500):
        bl = self.to_local(np.asarray(b_global))
        x, it, res = _halo_cg(self, bl, rtol, maxiter)
        return self.to_global(x), int(it), float(res)

    def apply_global(self, x_global):
        """A @ x for a replicated global vector (testing/oracle path)."""
        return self.to_global(_apply_body(self, self.to_local(x_global)))


def _halo_sync(op, y):
    """Ghost->owner adds then owner->ghost refresh (2+2 ppermutes) on a
    (P_local, local_size) tensor."""
    part = op.part
    comm = op.mesh.comm
    nparts = part.nparts
    om, gl, gr = part.owned_max, part.gl_max, part.gr_max
    send_l, send_r = op.d_send_l, op.d_send_r
    gl_part = torch.where(op.d_gl_valid, y[:, om:om + gl], 0.0)
    recv_from_right = comm.ppermute(
        gl_part, [(p, p - 1) for p in range(1, nparts)])
    # the padded send slots (0) receive zeros: their adds are exact
    y = y.scatter_add(1, send_l, recv_from_right)
    gr_part = torch.where(op.d_gr_valid, y[:, om + gl:om + gl + gr], 0.0)
    recv_from_left = comm.ppermute(
        gr_part, [(p, p + 1) for p in range(nparts - 1)])
    y = y.scatter_add(1, send_r, recv_from_left)
    to_right = comm.ppermute(
        torch.gather(y, 1, send_l), [(p, p + 1) for p in range(nparts - 1)])
    y = y.clone()
    y[:, om:om + gl] = torch.where(op.d_gl_valid, to_right, 0.0)
    to_left = comm.ppermute(
        torch.gather(y, 1, send_r), [(p, p - 1) for p in range(1, nparts)])
    y[:, om + gl:om + gl + gr] = torch.where(op.d_gr_valid, to_left, 0.0)
    return y


def _diag_body(op):
    """Assembled operator diagonal per slab (duplicate-slot aware: a
    facet-pair element lists shared dofs twice, so their cross entries
    belong on the diagonal), halo-summed like the apply."""
    parts = [torch.where(D[..., :, None] == D[..., None, :], A, 0.0).sum(-1)
             for A, D in op.d_instances]
    d = _halo_sync(op, op._scatter(parts))
    return torch.where(op.d_active & (torch.abs(d) > 1e-30), d, 1.0)


def _apply_body(op, x):
    """Operator application on (P_local, local_size) slab vectors."""
    xin = torch.where(op.d_active, x, 0.0)
    parts = [torch.einsum("peij,pej->pei", A, _gather_rows(xin, D))
             for A, D in op.d_instances]
    y = _halo_sync(op, op._scatter(parts))
    return torch.where(op.d_active, y, x)


def _halo_cg(op: HaloOperator, b, rtol, maxiter):
    """Jacobi-preconditioned CG on slab vectors; dot products are psums of
    the slabs' owned sums. The loop reads its stopping test on the host
    every iteration (the reference's ``lax.while_loop`` condition)."""
    comm = op.mesh.comm
    owned = op.d_owned

    def pdot(u, v):
        return comm.psum(torch.where(owned, u * v, 0.0).sum(1))[0]

    d = _diag_body(op)
    act = op.d_active

    def M(r_):
        return torch.where(act, r_ / d, r_)

    bb = torch.where(act, b, 0.0)
    x = torch.zeros_like(bb)
    r = bb - _apply_body(op, x)
    z = M(r)
    p_vec = z
    rz = pdot(r, z)
    tol2 = (rtol ** 2) * pdot(r, r)
    it = 0
    while it < maxiter and bool(pdot(r, r) > tol2):
        Ap = _apply_body(op, p_vec)
        alpha = rz / pdot(p_vec, Ap)
        x = x + alpha * p_vec
        r = r - alpha * Ap
        z = M(r)
        rz_new = pdot(r, z)
        p_vec = z + (rz_new / rz) * p_vec
        rz = rz_new
        it += 1
    # the TRUE residual norm (rz is the preconditioned r.M^-1 r)
    return x, it, torch.sqrt(pdot(r, r))
