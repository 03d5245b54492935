"""Lagrange finite elements with closed-form (Vandermonde) tabulation.

Replaces the Basix element-tabulation role used throughout the reference
(e.g. upstream CutFEMx cpp/cutfemx/level_set/value.h:34-119 tabulates basis
functions at runtime quadrature points). Here tabulation at arbitrary points
is a dense matmul ``monomials(points) @ C`` with a precomputed float64
coefficient matrix — batched and differentiable.

Dof ordering follows the Basix convention: dofs are grouped by sub-entity
(vertices, then edges, then faces, then interior), so cross-cell dof matching
in the dofmap builder only needs per-entity orientation permutations.
"""

from __future__ import annotations

import numpy as np
import torch

from .cells import CellType, reference_cell

__all__ = ["LagrangeElement", "lagrange_element"]

_TENSOR_CELLS = (CellType.quadrilateral, CellType.hexahedron)


def _monomial_exponents(cell_type: str, degree: int) -> np.ndarray:
    cell = reference_cell(cell_type)
    d = cell.tdim
    if cell_type in _TENSOR_CELLS:
        ranges = [range(degree + 1)] * d
        exps = np.array(np.meshgrid(*ranges, indexing="ij")).reshape(d, -1).T
    else:
        exps = []
        if d == 1:
            exps = [[i] for i in range(degree + 1)]
        elif d == 2:
            exps = [[i, j] for i in range(degree + 1)
                    for j in range(degree + 1 - i)]
        else:
            exps = [[i, j, k] for i in range(degree + 1)
                    for j in range(degree + 1 - i)
                    for k in range(degree + 1 - i - j)]
        exps = np.array(exps)
    return exps.astype(np.int64)


def _lattice_points(cell_type: str, degree: int):
    """Lagrange lattice points with their (entity_dim, entity_idx) owner,
    ordered Basix-style: vertices, edge interiors, face interiors, cell
    interior."""
    cell = reference_cell(cell_type)
    d = cell.tdim
    p = degree
    if p == 0:
        # single interior point (cell midpoint)
        mid = cell.vertices.mean(axis=0)
        return mid[None, :], [(d, 0)]

    # generate the full lattice in barycentric/tensor coordinates
    if cell_type in _TENSOR_CELLS:
        axes = [np.arange(p + 1) / p] * d
        grid = np.array(np.meshgrid(*axes, indexing="ij")).reshape(d, -1).T
        pts = grid
    else:
        idx = []
        if d == 1:
            idx = [[i] for i in range(p + 1)]
        elif d == 2:
            idx = [[i, j] for i in range(p + 1) for j in range(p + 1 - i)]
        else:
            idx = [[i, j, k] for i in range(p + 1) for j in range(p + 1 - i)
                   for k in range(p + 1 - i - j)]
        pts = np.array(idx, dtype=np.float64) / p

    def owner(x):
        """Classify a lattice point to its smallest containing sub-entity."""
        tol = 1e-12
        # vertex?
        for vi, v in enumerate(cell.vertices):
            if np.allclose(x, v, atol=tol):
                return (0, vi)
        # edge? (only matters when tdim >= 2; in 1D edges==cell)
        if d >= 2:
            for ei, (a, b) in enumerate(cell.edges):
                va, vb = cell.vertices[a], cell.vertices[b]
                t = vb - va
                s = np.dot(x - va, t) / np.dot(t, t)
                if -tol < s < 1 + tol and np.allclose(va + s * t, x, atol=tol):
                    return (1, ei)
        # facet? (2D facets of 3D cells)
        if d == 3:
            for fi, fverts in enumerate(cell.facets):
                vs = cell.vertices[np.asarray(fverts)]
                v0 = vs[0]
                e1, e2 = vs[1] - v0, vs[2] - v0
                nrm = np.cross(e1, e2)
                if abs(np.dot(x - v0, nrm)) < tol:
                    # inside the facet? project and check barycentric/box
                    if _point_in_facet(cell, fverts, x, tol):
                        return (2, fi)
        return (d, 0)

    owners = [owner(x) for x in pts]

    def entity_param(i):
        """Within-entity ordering: edge-interior dofs run along the edge
        direction a->b (as listed in cell.edges) so the cross-cell
        orientation permutation in the dofmap builder is exact; other
        entities use lexicographic coordinates."""
        edim, eidx = owners[i]
        if edim == 1 and d >= 2:
            a, b = cell.edges[eidx]
            va, vb = cell.vertices[a], cell.vertices[b]
            t = vb - va
            return (float(np.dot(pts[i] - va, t) / np.dot(t, t)),)
        return tuple(np.round(pts[i] * p).astype(int))

    order = sorted(range(len(pts)),
                   key=lambda i: (owners[i][0], owners[i][1],
                                  entity_param(i)))
    pts = pts[order]
    owners = [owners[i] for i in order]
    return pts, owners


def _point_in_facet(cell, fverts, x, tol):
    vs = cell.vertices[np.asarray(fverts)]
    if len(fverts) == 3:  # triangle facet
        v0 = vs[0]
        A = np.stack([vs[1] - v0, vs[2] - v0], axis=-1)
        coef, *_ = np.linalg.lstsq(A, x - v0, rcond=None)
        return (coef >= -tol).all() and coef.sum() <= 1 + tol
    # quad facet
    v0 = vs[0]
    A = np.stack([vs[1] - v0, vs[2] - v0], axis=-1)
    coef, *_ = np.linalg.lstsq(A, x - v0, rcond=None)
    return ((coef >= -tol) & (coef <= 1 + tol)).all()


class LagrangeElement:
    """Scalar Lagrange element on a reference cell.

    ``tabulate(points)`` -> (npts, ndofs); ``tabulate_grad(points)`` ->
    (npts, ndofs, tdim). Works with NumPy arrays or torch tensors (the
    coefficient matrix is a float64 NumPy constant that the caller's array
    library promotes as needed).
    """

    def __init__(self, cell_type: str, degree: int):
        self.cell_type = cell_type
        self.degree = int(degree)
        self.cell = reference_cell(cell_type)
        self.tdim = self.cell.tdim

        self.exponents = _monomial_exponents(cell_type, self.degree)
        pts, owners = _lattice_points(cell_type, self.degree)
        if self.degree == 0:
            # P0/DG0: single constant basis function
            self.exponents = np.zeros((1, self.tdim), dtype=np.int64)
        self.dof_points = pts
        self.dof_entities = owners  # list of (entity_dim, entity_index)
        V = self._monomials_np(pts)
        if V.shape[0] != V.shape[1]:
            raise RuntimeError(
                f"lattice/monomial mismatch for {cell_type} P{degree}: "
                f"{V.shape}")
        self.coeffs = np.linalg.solve(V, np.eye(V.shape[0]))
        self.ndofs = V.shape[0]

        # per-entity dof lists: dict (dim, idx) -> local dof ids (ordered)
        self.entity_dofs = {}
        for dof, key in enumerate(self.dof_entities):
            self.entity_dofs.setdefault(key, []).append(dof)

        cond = np.linalg.cond(V)
        if cond > 1e12:  # pragma: no cover
            raise RuntimeError(f"ill-conditioned Vandermonde ({cond:.2e})")

    # -- tabulation ---------------------------------------------------------

    def _monomials_np(self, points):
        points = np.asarray(points, dtype=np.float64)
        return np.prod(points[:, None, :] ** self.exponents[None, :, :],
                       axis=-1)

    def _monomials(self, points, xp):
        # points: (..., tdim) -> (..., nmono)
        e = self.exponents
        out = None
        for d in range(self.tdim):
            t = points[..., d:d + 1] ** xp.asarray(e[:, d],
                                                   dtype=points.dtype)
            out = t if out is None else out * t
        return out

    def _monomial_grads(self, points, xp):
        # (..., nmono, tdim)
        e = self.exponents
        grads = []
        for g in range(self.tdim):
            out = None
            for d in range(self.tdim):
                ed = xp.asarray(e[:, d], dtype=points.dtype)
                if d == g:
                    # d/dx x^n = n x^(n-1); guard n=0
                    expm1 = xp.asarray(np.maximum(e[:, d] - 1, 0),
                                       dtype=points.dtype)
                    t = ed * points[..., d:d + 1] ** expm1
                else:
                    t = points[..., d:d + 1] ** ed
                out = t if out is None else out * t
            grads.append(out)
        return xp.stack(grads, axis=-1)

    def tabulate(self, points):
        """(..., tdim) -> (..., ndofs) basis values."""
        xp = _get_xp(points)
        pts = xp.asarray(points)
        C = xp.asarray(self.coeffs, dtype=pts.dtype)
        return self._monomials(pts, xp) @ C

    def tabulate_grad(self, points):
        """(..., tdim) -> (..., ndofs, tdim) reference gradients."""
        xp = _get_xp(points)
        pts = xp.asarray(points)
        C = xp.asarray(self.coeffs, dtype=pts.dtype)
        dm = self._monomial_grads(pts, xp)  # (..., nmono, tdim)
        return xp.einsum("...md,mn->...nd", dm, C)


class _TorchXP:
    """The few array-API calls the tabulation makes, on torch tensors.
    Constants are created on the device of the points they meet."""

    def __init__(self, like):
        self.like = like

    def asarray(self, a, dtype=None):
        if isinstance(a, torch.Tensor):
            return a if dtype is None else a.to(dtype)
        return torch.as_tensor(a, dtype=dtype or self.like.dtype,
                               device=self.like.device)

    @staticmethod
    def stack(arrays, axis=0):
        return torch.stack(arrays, dim=axis)

    einsum = staticmethod(torch.einsum)


def _get_xp(points):
    if isinstance(points, torch.Tensor):
        return _TorchXP(points)
    if isinstance(points, np.ndarray) or np.isscalar(points) or isinstance(
            points, (list, tuple)):
        return np
    raise TypeError(f"cannot tabulate at points of type {type(points)}")


_element_cache: dict = {}


def lagrange_element(cell_type: str, degree: int) -> LagrangeElement:
    key = (cell_type, int(degree))
    if key not in _element_cache:
        _element_cache[key] = LagrangeElement(cell_type, degree)
    return _element_cache[key]
