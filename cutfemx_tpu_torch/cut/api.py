"""Public cut API: cut, update, locate_entities, runtime_quadrature,
ghost_penalty_facets — the torch counterpart of ``cutfemx_tpu.cut.api``.

Classification and facet bands are host numpy; runtime quadrature runs on
the level set's device. Only the linear marching path (a P1 level set on
cell-hosted CutData) is ported; the rest waits for ROADMAP item 10.
"""

from __future__ import annotations

from collections.abc import Sequence

import numpy as np

from ..functionspace import Function
from ..mesh import Mesh
from .classify import CutData
from .quadrature import RuntimeQuadratureRules, interface_rules, volume_rules
from .selector import DOMAIN_INTERSECTED, parse_selector

__all__ = [
    "cut", "update", "locate_entities", "runtime_quadrature", "CutData",
    "ghost_penalty_facets", "interior_facets_for_cells",
]


def _normalize_level_sets(level_set):
    if isinstance(level_set, Function):
        return [level_set]
    if isinstance(level_set, Sequence) and not isinstance(level_set, str):
        out = list(level_set)
        if not out:
            raise ValueError("cut requires at least one level-set Function")
        if not all(isinstance(f, Function) for f in out):
            raise TypeError("cut sequence entries must be Functions")
        return out
    raise TypeError("cut expects a Function or a sequence of Functions")


def cut(level_set, entities=None, entity_dim=None, *,
        cut_approximation="auto", cut_approximation_order=1,
        max_refinement_iterations=8, edge_max_depth=20) -> CutData:
    """Classify cells (or selected entities) against one or more level
    sets."""
    level_sets = _normalize_level_sets(level_set)
    options = dict(cut_approximation=cut_approximation,
                   cut_approximation_order=cut_approximation_order,
                   max_refinement_iterations=max_refinement_iterations,
                   edge_max_depth=edge_max_depth)
    return CutData(level_sets, entities=entities, entity_dim=entity_dim,
                   options=options)


def update(cut_data: CutData):
    """Re-classify ``cut_data`` from its level sets' current values (the
    re-cut of a moving domain)."""
    cut_data.update()


def locate_entities(cut_data: CutData, ls_part: str):
    return cut_data.locate(ls_part)


def runtime_quadrature(cut_data: CutData, ls_part: str, order: int, *,
                       backend: str = "straight") -> RuntimeQuadratureRules:
    """Runtime quadrature for the selected part on intersected cells.
    Inclusive selectors produce the same rules as the strict ones."""
    if backend != "straight":
        raise NotImplementedError(
            f"backend {backend!r} (ROADMAP item 10: Saye quadrature)")
    terms = parse_selector(ls_part)
    if len(terms) != 1 or len(terms[0]) != 1:
        raise NotImplementedError(
            "compound and union selectors (ROADMAP item 10)")
    name, op = terms[0][0]
    try:
        idx = cut_data.level_set_names.index(name)
    except ValueError:
        raise ValueError(f"unknown level-set name '{name}'") from None
    phi = cut_data.level_sets[idx]
    mesh = cut_data.mesh
    if cut_data.hosted_dim != mesh.tdim:
        raise NotImplementedError(
            "facet-hosted runtime quadrature (ROADMAP item 10)")
    if phi.function_space.degree > 1:
        raise NotImplementedError(
            "higher-degree level sets: refined and curved cuts "
            "(ROADMAP item 10)")
    cut_entities = cut_data.hosted_entities[
        cut_data.domains[idx] == DOMAIN_INTERSECTED]
    if op in ("<", "<="):
        return volume_rules(mesh, phi, cut_entities, order, side="<")
    if op in (">", ">="):
        return volume_rules(mesh, phi, cut_entities, order, side=">")
    return interface_rules(mesh, phi, cut_entities, order)


# -- stabilization facet bands ----------------------------------------------


def interior_facets_for_cells(msh: Mesh, cells, *, include_ghosts=False):
    """Interior facets whose both neighbors are in ``cells``."""
    sel = np.zeros(msh.num_cells, dtype=bool)
    sel[np.asarray(cells, dtype=np.int64)] = True
    fc = msh.facet_cells
    interior = fc[:, 1] >= 0
    both = interior & sel[fc[:, 0]] & sel[np.maximum(fc[:, 1], 0)]
    return np.flatnonzero(both).astype(np.int32)


def ghost_penalty_facets(cut_data: CutData, selector: str, *, depth=1,
                         include_ghosts=False):
    """Interior facets of the cut-cell stabilization band: facets adjacent
    to a cut cell whose both neighbors are active (cut or selected)."""
    if depth != 1:
        raise NotImplementedError(
            "ghost_penalty_facets currently supports depth=1.")
    if cut_data.entity_dim is not None and \
            cut_data.entity_dim != cut_data.mesh.tdim:
        raise ValueError("ghost_penalty_facets expects cell-hosted CutData.")
    msh = cut_data.mesh
    cut_cells = locate_entities(cut_data, "phi=0" if
                                "phi" in cut_data.level_set_names else
                                f"{cut_data.level_set_names[0]}=0")
    selected = locate_entities(cut_data, selector)
    active = np.zeros(msh.num_cells, dtype=bool)
    active[cut_cells] = True
    active[selected] = True
    is_cut = np.zeros(msh.num_cells, dtype=bool)
    is_cut[cut_cells] = True
    fc = msh.facet_cells
    interior = fc[:, 1] >= 0
    c1 = np.maximum(fc[:, 1], 0)
    both_active = interior & active[fc[:, 0]] & active[c1]
    any_cut = is_cut[fc[:, 0]] | is_cut[c1]
    return np.flatnonzero(both_active & any_cut).astype(np.int32)
