"""Level-set quantities as quadrature-point fields.

The torch counterpart of ``cutfemx_tpu.level_set``: lazy fields evaluated
at runtime quadrature points for use inside weak forms. ``normal`` is
sign*grad(phi)/|grad(phi)|, ``level_set_value`` tabulates phi,
``surface_normal`` is the geometric normal of the cut facet,
``conormal`` the side-aware conormal of a surface on a runtime dS
measure and ``correction_distance`` the distance along a direction onto
the zero set. Evaluators receive the RuntimeQuadratureRules and return
padded (n, Qmax, *shape) tensors aligned with them, on the rules' device.
"""

from __future__ import annotations

import torch

from .elements import lagrange_element
from .forms.dsl import QuadratureField
from .geometry import facet_reference_normals, inv_or_pinv, pullback

__all__ = ["normal", "level_set_value", "surface_normal", "conormal",
           "correction_distance"]


def _cell_tensor(a, like):
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


def _phi_dofs_per_parent(phi, rules):
    V = phi.function_space
    idx = torch.as_tensor(V.dofmap[rules.parent_cells], dtype=torch.int64,
                          device=phi.x.device)
    return phi.x[idx]


def _tabulate_at_rule_points(space, rules):
    """Basis values/grads of `space` at the padded rule points.

    Returns (val (n, Qmax, nd), refgrad (n, Qmax, nd, tdim))."""
    el = space.element
    pts = rules.points_padded
    return el.tabulate(pts), el.tabulate_grad(pts)


def _inverse_jacobians(cell_type, coords, pts):
    """K = J^{-1} (or the pseudo-inverse) of the P1 geometry at points
    (E, Q, tdim) of cells with vertex coords (E, nv, gdim)."""
    dphi = lagrange_element(cell_type, 1).tabulate_grad(pts)
    return inv_or_pinv(torch.einsum("evg,eqvt->eqgt", coords, dphi))


def _pullback_points(cell_type, coords, xphys):
    """Reference coords (E, Q, tdim) of physical points (E, Q, gdim) in
    cells with vertex coords (E, nv, gdim)."""
    return torch.func.vmap(lambda c, x: pullback(cell_type, c, x))(coords,
                                                                  xphys)


def level_set_value(level_set, *, name=None):
    """Lazy quadrature field of phi values."""

    def evaluator(rules):
        dofs = _phi_dofs_per_parent(level_set, rules)
        val, _ = _tabulate_at_rule_points(level_set.function_space, rules)
        return torch.einsum("nqd,nd->nq", val, dofs.to(val.dtype))

    return QuadratureField(name or "level_set_value", (), evaluator,
                           mesh=level_set.function_space.mesh)


def normal(level_set, *, name=None, sign=1.0):
    """Lazy quadrature field sign*grad(phi)/|grad(phi)| (norm clamped at
    1e-14)."""
    mesh = level_set.function_space.mesh
    gdim = mesh.gdim

    def evaluator(rules):
        dofs = _phi_dofs_per_parent(level_set, rules)
        _, rg = _tabulate_at_rule_points(level_set.function_space, rules)
        gref = torch.einsum("nqdt,nd->nqt", rg, dofs.to(rg.dtype))
        pts = rules.points_padded
        coords = _cell_tensor(mesh.cell_vertex_coords[rules.parent_cells],
                              pts)
        K = _inverse_jacobians(mesh.cell_type, coords, pts)
        g = torch.einsum("nqtg,nqt->nqg", K, gref)
        nrm = torch.linalg.norm(g, dim=-1, keepdim=True)
        return sign * g / torch.clamp(nrm, min=1e-14)

    return QuadratureField(name or "normal", (gdim,), evaluator, mesh=mesh)


def surface_normal(cut_data, selector=None, *, name=None, sign=1.0):
    """Geometric (facet-exact) normal of the cut surface, read from the
    normals the marching recorded on the interface rules."""
    mesh = cut_data.mesh

    def evaluator(rules):
        if rules.normals_padded is None:
            raise ValueError(
                "surface_normal requires interface ('phi=0') runtime rules")
        return sign * rules.normals_padded

    return QuadratureField(name or "surface_normal", (mesh.gdim,),
                           evaluator, mesh=mesh)


def conormal(normal_field, *, tolerance=1e-14, name=None):
    """Side-aware surface conormal for runtime dS measures: the unit vector
    tangent to the surface and normal to the skeleton curve, pointing out
    of each side's cell, mu_side = normalize((I - n n^T) n_facet,side).
    ``normal_field`` is a vector QuadratureField (``normal``)."""
    if not isinstance(normal_field, QuadratureField) or \
            len(normal_field.shape) != 1:
        raise TypeError("conormal expects a vector-valued quadrature field")
    mesh = normal_field.mesh
    gdim = mesh.gdim

    def evaluator(rules, side):
        if rules.local_facets is None:
            raise ValueError(
                "conormal requires facet-hosted runtime rules (a runtime "
                "dS measure)")
        n_surf = normal_field.evaluator(rules)           # (E, Q, g)
        facets = rules.parent_map
        col = 0 if side == "+" else 1
        cells = mesh.facet_cells[facets, col]
        locals_ = mesh.facet_local_index[facets, col]
        pts = rules.points_padded                        # '+' cell coords
        coords = _cell_tensor(mesh.cell_vertex_coords[cells], pts)
        if side == "-":
            plus = _cell_tensor(mesh.cell_vertex_coords[rules.parent_cells],
                                pts)
            phi1 = lagrange_element(mesh.cell_type, 1).tabulate(pts)
            xq = torch.einsum("eqv,evg->eqg", phi1, plus)
            pts = _pullback_points(mesh.cell_type, coords, xq)
        K = _inverse_jacobians(mesh.cell_type, coords, pts)
        nref = _cell_tensor(facet_reference_normals(mesh.cell_type)[locals_],
                            pts)                         # (E, t)
        nf = torch.einsum("eqtg,et->eqg", K, nref)
        nf = nf / torch.clamp(torch.linalg.norm(nf, dim=-1, keepdim=True),
                              min=tolerance)
        mu = nf - torch.einsum("eqg,eqg->eq", nf, n_surf)[..., None] * n_surf
        nrm = torch.linalg.norm(mu, dim=-1, keepdim=True)
        return mu / torch.clamp(nrm, min=tolerance)

    return QuadratureField(name or "conormal", (gdim,), evaluator,
                           mesh=mesh, side_dependent=True)


def correction_distance(level_set, direction, *, max_iterations=20,
                        tolerance=1e-12, name=None):
    """Root-finding distance rho(x) such that phi(x + rho * d(x)) = 0
    along a direction quadrature field: Newton iterations with the host
    cell's polynomial extension of phi (a step is skipped where the slope
    is at most ``tolerance``)."""
    mesh = level_set.function_space.mesh
    V = level_set.function_space
    el1 = lagrange_element(mesh.cell_type, 1)

    def evaluator(rules):
        d = direction.evaluator(rules)                   # (E, Q, g)
        pts = rules.points_padded                        # (E, Q, t)
        coords = _cell_tensor(mesh.cell_vertex_coords[rules.parent_cells],
                              pts)
        x0 = torch.einsum("eqv,evg->eqg", el1.tabulate(pts), coords)
        dofs = _phi_dofs_per_parent(level_set, rules).to(pts.dtype)

        def phi_and_grad(x):
            ref = _pullback_points(mesh.cell_type, coords, x)
            val = torch.einsum("eqn,en->eq", V.element.tabulate(ref), dofs)
            rg = torch.einsum("eqnt,en->eqt", V.element.tabulate_grad(ref),
                              dofs)
            K = _inverse_jacobians(mesh.cell_type, coords, ref)
            return val, torch.einsum("eqtg,eqt->eqg", K, rg)

        rho = torch.zeros(pts.shape[:2], dtype=pts.dtype, device=pts.device)
        for _ in range(max_iterations):
            val, g = phi_and_grad(x0 + rho[..., None] * d)
            slope = torch.einsum("eqg,eqg->eq", g, d)
            steep = torch.abs(slope) > tolerance
            step = val / torch.where(steep, slope, 1.0)
            rho = rho - torch.where(steep, step, 0.0)
        return rho

    return QuadratureField(name or "correction_distance", (), evaluator,
                           mesh=mesh)
