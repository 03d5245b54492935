"""Public cut API: cut, update, locate_entities, runtime_quadrature,
ghost_penalty_facets, create_cut_mesh — the torch counterpart of
``cutfemx_tpu.cut.api``.

Classification and facet bands are host numpy; runtime quadrature and the
cut-mesh marching run on the level set's device. Only the linear marching
path (a P1 level set on cell-hosted CutData; cut meshes also march the
vertex values of a higher-degree one) is ported; the rest waits for
ROADMAP item 10.
"""

from __future__ import annotations

from collections.abc import Sequence

import numpy as np
import torch

from ..functionspace import Function
from ..mesh import Mesh
from .classify import CutData
from .quadrature import (RuntimeQuadratureRules, _march_parts,
                         interface_rules, volume_rules)
from .selector import (DOMAIN_INSIDE, DOMAIN_INTERSECTED, DOMAIN_OUTSIDE,
                       parse_selector)
from .tables import simplex_cut_tables

__all__ = [
    "cut", "update", "locate_entities", "runtime_quadrature", "CutData",
    "ghost_penalty_facets", "interior_facets_for_cells", "CutMesh",
    "create_cut_mesh",
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


# -- cut visualisation meshes ------------------------------------------------


class CutMesh:
    """Simplex mesh of a selected cut part: ``mesh`` (None when the part
    is empty), the parent cell of each of its cells and whether that cell
    is a cut fragment (1) or a whole uncut cell (0)."""

    def __init__(self, mesh, parent_index, is_cut_cell):
        self.mesh = mesh
        self.parent_index = np.asarray(parent_index, dtype=np.int32)
        self.is_cut_cell = np.asarray(is_cut_cell, dtype=np.int8)


_SIMPLEX_OF_DIM = {1: "interval", 2: "triangle", 3: "tetrahedron"}


def create_cut_mesh(cut_data: CutData, ls_part: str, mode=None) -> CutMesh:
    """Build a simplex mesh of the selected part of cell-hosted CutData.
    mode: 'full' includes the uncut cells of the phase, 'cut_only' only
    the cut fragments; 'auto' is 'full' for volume parts and 'cut_only'
    for interfaces. The fragments are marched in physical coordinates on
    the level set's device from its values at the cell vertices."""
    mode = mode or "auto"
    terms = parse_selector(ls_part)
    if len(terms) != 1 or len(terms[0]) != 1:
        raise NotImplementedError(
            "compound and union selectors (ROADMAP item 10)")
    name, op = terms[0][0]
    idx = cut_data.level_set_names.index(name)
    phi = cut_data.level_sets[idx]
    mesh = cut_data.mesh
    tdim = mesh.tdim
    if op == "=" and mode == "full":
        raise ValueError(
            "mode='full' is not valid for interface parts ('=' selector)")
    if cut_data.hosted_dim != tdim:
        raise NotImplementedError(
            "facet-hosted cut meshes (ROADMAP item 10)")
    if mode == "auto":
        mode = "cut_only" if op == "=" else "full"

    cut_cells = cut_data.hosted_entities[
        cut_data.domains[idx] == DOMAIN_INTERSECTED]
    split = mesh.ref_cell.simplex_split
    VOL, SURF = simplex_cut_tables(tdim)
    verts_out, cells_out, parents, iscut = [], [], [], []
    nv_off = 0

    def add_parts(X, valid, parent_cells, cut_flag):
        nonlocal nv_off
        C, M, m, g = X.shape
        sel = np.nonzero(valid)
        npart = len(sel[0])
        if npart == 0:
            return
        verts_out.append(X[sel[0], sel[1]].reshape(-1, g))
        cells_out.append((np.arange(npart * m) + nv_off).reshape(npart, m))
        nv_off += npart * m
        parents.append(parent_cells[sel[0]])
        iscut.append(np.full(npart, cut_flag, np.int8))

    if len(cut_cells):
        V = phi.function_space
        dev = phi.x.device
        dofs = phi.x.detach().cpu().numpy()[V.dofmap[cut_cells]]
        tab = np.asarray(V.element.tabulate(mesh.ref_cell.vertices))
        phiv = np.einsum("pn,cn->cp", tab, dofs)
        coords = mesh.cell_vertex_coords[cut_cells]
        for sub in split:
            pv = torch.as_tensor(coords[:, sub, :], device=dev)
            ph = torch.as_tensor(phiv[:, sub], device=dev)
            if op == "=":
                X, valid = _march_parts(ph, pv, tdim, SURF)
            else:
                sgn = -1.0 if op in (">", ">=") else 1.0
                X, valid = _march_parts(sgn * ph, pv, tdim, VOL)
            add_parts(X.cpu().numpy(), valid.cpu().numpy(), cut_cells, 1)

    if mode == "full" and op != "=":
        want = DOMAIN_INSIDE if op in ("<", "<=") else DOMAIN_OUTSIDE
        full_cells = cut_data.hosted_entities[cut_data.domains[idx] == want]
        if len(full_cells):
            coords = mesh.cell_vertex_coords[full_cells]
            for sub in split:
                pv = coords[:, sub, :]
                add_parts(pv[:, None], np.ones((pv.shape[0], 1), bool),
                          full_cells, 0)

    if not verts_out:
        return CutMesh(None, np.zeros(0, np.int32), np.zeros(0, np.int8))
    out_dim = tdim - 1 if op == "=" else tdim
    vis = Mesh(np.concatenate(verts_out), np.concatenate(cells_out),
               _SIMPLEX_OF_DIM[out_dim])
    return CutMesh(vis, np.concatenate(parents), np.concatenate(iscut))
