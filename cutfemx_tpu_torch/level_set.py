"""Level-set quantities as quadrature-point fields.

The torch counterpart of ``cutfemx_tpu.level_set``: lazy fields evaluated
at runtime quadrature points for use inside weak forms. Only ``normal``
(sign*grad(phi)/|grad(phi)|) is ported; the other fields wait for ROADMAP
item 10. Evaluators receive the RuntimeQuadratureRules and return padded
(n, Qmax, *shape) tensors aligned with them, on the rules' device.
"""

from __future__ import annotations

import torch

from .elements import lagrange_element
from .forms.dsl import QuadratureField

__all__ = ["normal"]


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


def normal(level_set, *, name=None, sign=1.0):
    """Lazy quadrature field sign*grad(phi)/|grad(phi)| (norm clamped at
    1e-14)."""
    mesh = level_set.function_space.mesh
    gdim = mesh.gdim

    def evaluator(rules):
        dofs = _phi_dofs_per_parent(level_set, rules)
        _, rg = _tabulate_at_rule_points(level_set.function_space, rules)
        gref = torch.einsum("nqdt,nd->nqt", rg, dofs.to(rg.dtype))
        # K = J^{-1} at the rule points
        el1 = lagrange_element(mesh.cell_type, 1)
        pts = rules.points_padded
        dphi = el1.tabulate_grad(pts)                    # (n, Q, nv, tdim)
        coords = torch.as_tensor(mesh.cell_vertex_coords[rules.parent_cells],
                                 dtype=pts.dtype, device=pts.device)
        J = torch.einsum("nvg,nqvt->nqgt", coords, dphi)
        K = torch.linalg.inv(J) if J.shape[-1] == J.shape[-2] \
            else torch.linalg.pinv(J)
        g = torch.einsum("nqtg,nqt->nqg", K, gref)
        nrm = torch.linalg.norm(g, dim=-1, keepdim=True)
        return sign * g / torch.clamp(nrm, min=1e-14)

    return QuadratureField(name or "normal", (gdim,), evaluator, mesh=mesh)
