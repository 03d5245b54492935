"""Function spaces, dofmaps and Functions.

Replaces the DOLFINx FunctionSpace/DofMap role (SURVEY.md L1). Dof numbering
is global: vertex dofs first, then edge-interior, face-interior and
cell-interior dofs, with edge-orientation permutations so shared dofs agree
across cells (the role of DOLFINx dofmap construction).

Vector-valued spaces are blocked: global dof = scalar_dof * bs + component,
matching the DOLFINx convention the reference relies on
(upstream CutFEMx python/cutfemx/fem.py deactivation operates on blocked dofs).
"""

from __future__ import annotations

import numpy as np
import torch

from .elements import lagrange_element
from .mesh import Mesh

__all__ = ["FunctionSpace", "functionspace", "Function"]


class FunctionSpace:
    """A Lagrange space on a mesh. The dofmap is host numpy; ``device`` is
    where Functions of the space (and forms over it) keep their data: the
    CUDA card unless the caller asks for another."""

    def __init__(self, mesh: Mesh, family_degree, shape=(), *,
                 device="cuda"):
        self.device = torch.device(device)
        family, degree = family_degree
        if family not in ("Lagrange", "P", "DG", "Discontinuous Lagrange"):
            raise ValueError(f"unsupported family '{family}'")
        self.mesh = mesh
        self.family = "DG" if family in ("DG", "Discontinuous Lagrange") \
            else "Lagrange"
        self.degree = int(degree)
        if self.degree == 0 and self.family != "DG":
            raise ValueError("degree-0 spaces must be DG")
        self.element = lagrange_element(mesh.cell_type, self.degree)
        self.value_shape = tuple(shape)
        self.bs = int(np.prod(self.value_shape)) if self.value_shape else 1
        self._build_dofmap()
        self._dof_coords = None

    def _build_dofmap(self):
        mesh, el = self.mesh, self.element
        p = self.degree
        nc = mesh.num_cells

        if self.family == "DG":
            nd = el.ndofs
            self.dofmap = (np.arange(nc * nd, dtype=np.int32)
                           .reshape(nc, nd))
            self.num_scalar_dofs = nc * nd
            return

        cell = mesh.ref_cell
        tdim = mesh.tdim
        ndofs_cell = el.ndofs
        dofmap = np.zeros((nc, ndofs_cell), dtype=np.int64)

        # counts per entity
        n_edge_int = max(p - 1, 0)
        # face-interior counts (tdim==3 facets)
        if tdim == 3:
            fct = cell.facet_cell_type
            if fct == "triangle":
                n_face_int = max((p - 1) * (p - 2) // 2, 0)
            else:  # quadrilateral
                n_face_int = (p - 1) ** 2
        else:
            n_face_int = 0
        # n_face_int > 1 needs face-orientation permutations so the two
        # cells sharing a face agree on the ordering of its interior
        # dofs (the role of Basix/DOLFINx dof permutations; the reference
        # inherits this from DOLFINx, SURVEY.md L1). Implemented below in
        # _face_orientation_slots/_face_orientation_ids for any degree.

        offset = 0
        # vertex dofs
        vert_off = offset
        offset += mesh.num_vertices
        # edge dofs
        edge_off = self._edge_off = offset
        if n_edge_int and tdim >= 2:
            offset += mesh.num_edges * n_edge_int
        elif n_edge_int and tdim == 1:
            pass  # interval: 'edge interior' dofs are cell-interior
        # face dofs (3D)
        face_off = self._face_off = offset
        if n_face_int and tdim == 3:
            offset += mesh.num_facets * n_face_int
        # cell-interior dofs
        cell_off = offset
        # count interior dofs from element
        n_cell_int = len(el.entity_dofs.get((tdim, 0), []))
        offset += nc * n_cell_int
        self.num_scalar_dofs = offset

        # fill: iterate element dofs grouped by entity
        for (edim, eidx), dofs in el.entity_dofs.items():
            dofs = np.asarray(dofs)
            if edim == 0:
                gverts = mesh.cells[:, eidx]
                dofmap[:, dofs[0]] = vert_off + gverts
            elif edim == 1 and tdim >= 2:
                ge = mesh.cell_edges[:, eidx]          # (NC,)
                la, lb = cell.edges[eidx]
                gva, gvb = mesh.cells[:, la], mesh.cells[:, lb]
                fwd = (gva < gvb)                      # (NC,)
                for k, d in enumerate(dofs):
                    k_rev = len(dofs) - 1 - k
                    kk = np.where(fwd, k, k_rev)
                    dofmap[:, d] = edge_off + ge * n_edge_int + kk
            elif edim == tdim - 1 and tdim == 3:
                gf = mesh.cell_facets[:, eidx]
                if n_face_int <= 1:
                    for k, d in enumerate(dofs):
                        dofmap[:, d] = face_off + gf * n_face_int + k
                else:
                    fverts = np.asarray(cell.facets[eidx])
                    slots = _face_orientation_slots(
                        cell, el, eidx, dofs, p)      # (nd, n_orient)
                    orient = _face_orientation_ids(
                        mesh.cells[:, fverts])        # (NC,)
                    for j, d in enumerate(dofs):
                        dofmap[:, d] = (face_off + gf * n_face_int
                                        + slots[j][orient])
            elif edim == tdim:
                for k, d in enumerate(dofs):
                    dofmap[:, d] = cell_off + \
                        np.arange(nc) * n_cell_int + k
            elif edim == 1 and tdim == 1:
                # interval interior dofs
                for k, d in enumerate(dofs):
                    dofmap[:, d] = cell_off + np.arange(nc) * n_cell_int + k
            else:  # pragma: no cover
                raise RuntimeError((edim, eidx))
        self.dofmap = dofmap.astype(np.int32)

    # ------------------------------------------------------------------

    @property
    def blocked_dofmap(self):
        """(NC, ndofs_cell*bs) int32 blocked (global) dofs per cell."""
        if not hasattr(self, "_blocked_dofmap"):
            if self.bs == 1:
                self._blocked_dofmap = self.dofmap
            else:
                bd = (self.dofmap[:, :, None] * self.bs
                      + np.arange(self.bs)[None, None, :])
                self._blocked_dofmap = bd.reshape(
                    self.dofmap.shape[0], -1).astype(np.int32)
        return self._blocked_dofmap

    @property
    def dim(self):
        """Total number of (blocked) dofs."""
        return self.num_scalar_dofs * self.bs

    @property
    def dof_coordinates(self):
        """(num_scalar_dofs, gdim) coordinates of each scalar dof."""
        if self._dof_coords is None:
            self._dof_coords = self._compute_dof_coordinates()
        return self._dof_coords

    def _compute_dof_coordinates(self):
        el, mesh = self.element, self.mesh
        if self.family == "DG":
            # per-cell dof numbering: no shared entities to exploit
            phi_geo = np.asarray(
                lagrange_element(mesh.cell_type, 1).tabulate(el.dof_points))
            return self._dof_coordinates_percell(phi_geo)
        if self.degree == 1:
            # P1 dofs are exactly the mesh vertices (dof numbering puts
            # vertex dofs first, ordered by global vertex id)
            return np.ascontiguousarray(mesh.vertices)
        # Entity-wise construction: each global dof's coordinate comes from
        # the P1 geometry weights of its reference point, evaluated on the
        # vertices of its owning entity — O(ndofs) instead of the per-cell
        # einsum (which recomputes every shared dof once per adjacent cell
        # and allocates (NC, ndofs_cell, gdim) temporaries).
        phi_geo = np.asarray(lagrange_element(mesh.cell_type, 1).tabulate(
            el.dof_points))                                   # (nd, nvert)
        cell = mesh.ref_cell
        tdim = mesh.tdim
        out = np.zeros((self.num_scalar_dofs, mesh.gdim))
        verts = mesh.vertices
        cell_int_dofs = []
        for (edim, eidx), dofs in el.entity_dofs.items():
            if edim == 0:
                continue  # vertex block = verts, filled below
            if edim == 1 and tdim >= 2:
                la, lb = cell.edges[eidx]
                if eidx != 0:
                    continue  # same params for every edge; handle once
                # slot j along the ascending global edge sits at param t_j:
                # dofmap stores slot kk = k (fwd) so slot j <-> local dof
                # dofs[j] measured la->lb, param = weight on lb.
                ts = phi_geo[np.asarray(dofs), lb]            # (n_edge_int,)
                e = mesh.edges                                # ascending rows
                lo, hi = verts[e[:, 0]], verts[e[:, 1]]       # (NE, gdim)
                n_ei = len(ts)
                base = self._edge_off + np.arange(
                    mesh.num_edges, dtype=np.int64) * n_ei
                for j, t in enumerate(ts):
                    out[base + j] = (1.0 - t) * lo + t * hi
            elif edim == tdim - 1 and tdim == 3:
                if eidx != 0:
                    continue
                fverts = np.asarray(cell.facets[eidx])
                w = phi_geo[np.asarray(dofs)][:, fverts]      # (nfi, nvf)
                if not np.allclose(w, w[:, :1]):
                    # asymmetric face points would need orientation
                    # bookkeeping; fall back to the per-cell path
                    return self._dof_coordinates_percell(phi_geo)
                f = mesh.facets
                centers = verts[f].mean(axis=1)               # (NF, gdim)
                n_fi = len(dofs)
                base = self._face_off + np.arange(
                    mesh.num_facets, dtype=np.int64) * n_fi
                for j in range(n_fi):
                    out[base + j] = centers
            elif edim == tdim or (edim == 1 and tdim == 1):
                cell_int_dofs.extend(dofs)
        out[:mesh.num_vertices] = verts
        if cell_int_dofs:
            d = np.asarray(sorted(cell_int_dofs))
            coords = np.einsum("dk,ckg->cdg", phi_geo[d],
                               mesh.cell_vertex_coords)       # (NC, nci, g)
            out[self.dofmap[:, d].ravel()] = coords.reshape(-1, mesh.gdim)
        return out

    def _dof_coordinates_percell(self, phi_geo):
        mesh = self.mesh
        coords = np.einsum("dk,ckg->cdg", phi_geo,
                           mesh.cell_vertex_coords)
        out = np.zeros((self.num_scalar_dofs, mesh.gdim))
        out[self.dofmap.ravel()] = coords.reshape(-1, mesh.gdim)
        return out


def _face_orientation_slots(cell, el, eidx, dofs, p):
    """Canonical face-slot table for the interior dofs of local face
    ``eidx``: ``slots[j, orient]`` is the within-face global slot of
    local dof ``dofs[j]`` when the cell sees the face in orientation
    ``orient``. The canonical frame is defined purely by the face's
    GLOBAL vertex ids (triangle: ascending-id barycentric order; quad:
    origin at the min-id corner, first axis toward its smaller-id
    neighbor), so the two cells sharing a face always agree.

    Replaces the DOLFINx/Basix dof-permutation machinery the reference
    inherits (SURVEY.md L1; reference caps nothing — Basix tabulates any
    degree)."""
    import itertools

    fverts = np.asarray(cell.facets[eidx])
    pts = np.asarray(el.dof_points)[np.asarray(dofs)]
    nd = len(dofs)
    if len(fverts) == 3:                       # triangle face (tet)
        va, vb, vc = cell.vertices[fverts]
        M = np.stack([vb - va, vc - va], axis=-1)       # (3, 2)
        lam, *_ = np.linalg.lstsq(M, (pts - va).T, rcond=None)
        iB = np.rint(lam[0] * p).astype(int)
        iC = np.rint(lam[1] * p).astype(int)
        iA = p - iB - iC
        interior = [(a, b, p - a - b)
                    for a in range(1, p) for b in range(1, p - a)]
        lut = {m: k for k, m in enumerate(interior)}
        perms = list(itertools.permutations(range(3)))
        slots = np.empty((nd, len(perms)), np.int64)
        for pid, sg in enumerate(perms):
            for j in range(nd):
                multi = (iA[j], iB[j], iC[j])
                m = (multi[sg[0]], multi[sg[1]], multi[sg[2]])
                slots[j, pid] = lut[m]
        return slots
    # quadrilateral face (hex), tensor vertex order [A, A+u, A+v, A+u+v]
    va = cell.vertices[fverts[0]]
    u = cell.vertices[fverts[1]] - va
    v = cell.vertices[fverts[2]] - va
    M = np.stack([u, v], axis=-1)
    ab, *_ = np.linalg.lstsq(M, (pts - va).T, rcond=None)
    a = np.rint(ab[0] * p).astype(int)
    b = np.rint(ab[1] * p).astype(int)
    # 8 orientations: (origin corner, axis choice); see
    # _face_orientation_ids for the matching id computation
    q = p
    xf = [lambda a, b: (a, b),           lambda a, b: (b, a),
          lambda a, b: (q - a, b),       lambda a, b: (b, q - a),
          lambda a, b: (q - b, a),       lambda a, b: (a, q - b),
          lambda a, b: (q - b, q - a),   lambda a, b: (q - a, q - b)]
    slots = np.empty((nd, 8), np.int64)
    for w in range(8):
        aa, bb = xf[w](a, b)
        slots[:, w] = (aa - 1) * (p - 1) + (bb - 1)
    return slots


def _face_orientation_ids(gv):
    """Orientation id of each cell's view of a face, from the face's
    global vertex ids ``gv`` (NC, 3) or (NC, 4).

    Triangle: index into itertools.permutations(range(3)) of the argsort
    of (gA, gB, gC). Quad (tensor order A,B,C,D): id = 2*argmin_corner + s,
    where s selects the axis toward the min corner's smaller-id neighbor."""
    gv = np.asarray(gv)
    if gv.shape[1] == 3:
        import itertools
        sg = np.argsort(gv, axis=1)                       # (NC, 3)
        code = sg[:, 0] * 9 + sg[:, 1] * 3 + sg[:, 2]
        lut = np.full(27, -1, np.int64)
        for pid, perm in enumerate(itertools.permutations(range(3))):
            lut[perm[0] * 9 + perm[1] * 3 + perm[2]] = pid
        return lut[code]
    o = np.argmin(gv, axis=1)                             # (NC,)
    nbr = np.array([[1, 2], [0, 3], [0, 3], [1, 2]])      # quad adjacency
    n0 = gv[np.arange(len(gv)), nbr[o, 0]]
    n1 = gv[np.arange(len(gv)), nbr[o, 1]]
    return o * 2 + (n0 > n1).astype(np.int64)


def functionspace(mesh: Mesh, family_degree, shape=(), *, device="cuda"):
    return FunctionSpace(mesh, family_degree, shape, device=device)


class Function:
    """Finite element function: a FunctionSpace plus a dof vector.

    The dof vector ``x`` is a torch tensor of length space.dim on the
    space's device. The default dtype is torch's default float dtype, as
    cutfemx_tpu defaults to JAX's.
    """

    def __init__(self, space: FunctionSpace, name=None, dtype=None):
        self.function_space = space
        self.name = name or "f"
        dtype = dtype or torch.get_default_dtype()
        self.x = torch.zeros(space.dim, dtype=dtype, device=space.device)

    def interpolate(self, fn):
        """Interpolate a callable ``fn(x)`` with x of shape (gdim, N)
        (dolfinx convention) returning (N,) or (bs, N)."""
        coords = self.function_space.dof_coordinates  # (nd, gdim)
        vals = np.asarray(fn(coords.T))
        bs = self.function_space.bs
        if bs == 1:
            flat = vals.reshape(-1)
        else:
            if vals.shape[0] != bs:
                raise ValueError(
                    f"expected leading dim {bs}, got {vals.shape}")
            flat = np.ascontiguousarray(vals.T).reshape(-1)
        self.x = torch.as_tensor(flat, dtype=self.x.dtype,
                                 device=self.x.device)
        return self

    def copy(self):
        f = Function(self.function_space, name=self.name,
                     dtype=self.x.dtype)
        f.x = self.x.clone()
        return f

    @property
    def dtype(self):
        return self.x.dtype
