"""Public cut API: cut, update, locate_entities, runtime_quadrature,
ghost_penalty_facets, create_cut_mesh — the torch counterpart of
``cutfemx_tpu.cut.api``.

Classification and facet bands are host numpy; runtime quadrature and the
cut-mesh marching run on the level set's device. Cell-hosted CutData is
marched on the cells' simplices (compound and union selectors too): a P1
level set exactly, a higher-degree one on red-refined simplices or, with
``cut_approximation_order >= 2`` on simplex hosts, by the curved path.
Facet-hosted CutData of any degree is marched on the level set's values
at the facet vertices. The ``algoim`` backends take Saye's
dimension-reduction rules on quadrilateral and hexahedral cells
(``cut/saye.py``; its box grouping runs on the host).
"""

from __future__ import annotations

from collections.abc import Sequence
from itertools import combinations

import numpy as np
import torch

from ..functionspace import Function
from ..mesh import Mesh
from ..profiling import span
from .classify import CutData
from .quadrature import (RuntimeQuadratureRules, _march_parts,
                         compound_volume_rules, facet_interface_rules,
                         facet_volume_rules, interface_rules, volume_rules)
from .saye import saye_interface_rules, saye_volume_rules
from .selector import (DOMAIN_INSIDE, DOMAIN_INTERSECTED, DOMAIN_OUTSIDE,
                       parse_selector)
from .tables import simplex_cut_tables

__all__ = [
    "cut", "update", "locate_entities", "runtime_quadrature",
    "runtime_quadratures", "CutData",
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
    with span("cut.classify"):
        return CutData(level_sets, entities=entities, entity_dim=entity_dim,
                       options=options)


def update(cut_data: CutData):
    """Re-classify ``cut_data`` from its level sets' current values (the
    re-cut of a moving domain)."""
    cut_data.update()


def locate_entities(cut_data: CutData, ls_part: str):
    with span("cut.locate"):
        return cut_data.locate(ls_part)


def _subdivision_levels(cut_data, phi):
    """Red-refinement levels of the marching simplices from the cut
    options: a degree-1 level set is cut exactly at level 0; a
    higher-degree one gets two levels (at most max_refinement_iterations)
    unless ``cut_approximation="linear"``."""
    opts = cut_data.options or {}
    approx = opts.get("cut_approximation", "auto")
    if approx in ("linear",):
        return 0
    order = int(opts.get("cut_approximation_order", 1))
    max_iter = int(opts.get("max_refinement_iterations", 8))
    if phi.function_space.degree <= 1:
        return 0
    if approx == "auto" or order > 1:
        return max(0, min(2, max_iter))
    return 0


def _approx_plan(cut_data, phi, mesh):
    """(levels, curved) for cell-hosted marching rules.

    ``cut_approximation_order >= 2`` on a simplex host with a
    higher-degree level set selects the curved path (isoparametric P2
    parts with polished/projected interface nodes, O(h^3) geometric
    error) at the base part count; other combinations keep the
    red-refinement levels of _subdivision_levels."""
    opts = cut_data.options or {}
    approx = opts.get("cut_approximation", "auto")
    order = int(opts.get("cut_approximation_order", 1))
    if (approx != "linear" and order > 1
            and phi.function_space.degree > 1
            and mesh.cell_type in ("triangle", "tetrahedron")):
        return 0, True
    return _subdivision_levels(cut_data, phi), False


def runtime_quadrature(cut_data: CutData, ls_part: str, order: int, *,
                       backend: str = "straight") -> RuntimeQuadratureRules:
    """Runtime quadrature for the selected part on intersected entities
    (cells, or facets for facet-hosted CutData). Inclusive selectors
    produce the same rules as the strict ones. Compound AND selectors over
    several level sets give the rules of the intersection region by
    re-marching; OR selectors give signed-weight blocks by
    inclusion-exclusion. ``backend="algoim"`` (or ``"algoim_general"``)
    gives Saye's rules on quadrilateral and hexahedral cells and the
    polished facet rules on facet-hosted CutData."""
    if backend not in ("straight", "algoim", "algoim_general"):
        raise ValueError(f"unknown backend '{backend}'")
    with span("cut.rules"):
        terms = parse_selector(ls_part)
        if len(terms) > 1:
            return _union_runtime_quadrature(cut_data, terms, order)
        if len(terms[0]) > 1:
            return _compound_runtime_quadrature(cut_data, terms[0], order)
        name, op = terms[0][0]
        try:
            idx = cut_data.level_set_names.index(name)
        except ValueError:
            raise ValueError(f"unknown level-set name '{name}'") from None
        phi = cut_data.level_sets[idx]
        mesh = cut_data.mesh
        cut_entities = cut_data.hosted_entities[
            cut_data.domains[idx] == DOMAIN_INTERSECTED]
        side = "<" if op in ("<", "<=") else ">"
        if backend in ("algoim", "algoim_general"):
            # Saye's dimension-reduction rules on quad/hex cells; facet-hosted
            # CutData takes the facet rules with 2D crossings polished onto
            # the root of the true basis
            if cut_data.hosted_dim == mesh.tdim - 1:
                if op == "=":
                    return facet_interface_rules(mesh, phi, cut_entities,
                                                 order, polish=True)
                return facet_volume_rules(mesh, phi, cut_entities, order,
                                          side=side)
            if cut_data.hosted_dim != mesh.tdim:
                raise NotImplementedError(
                    "algoim backends support cell-hosted rules only")
            if op == "=":
                return saye_interface_rules(mesh, phi, cut_entities, order)
            return saye_volume_rules(mesh, phi, cut_entities, order, side=side)
        if cut_data.hosted_dim == mesh.tdim - 1:
            # facets march the level set's values at their vertices (the
            # reference's rule for every degree)
            if op == "=":
                return facet_interface_rules(mesh, phi, cut_entities, order)
            return facet_volume_rules(mesh, phi, cut_entities, order,
                                      side=side)
        if cut_data.hosted_dim != mesh.tdim:
            raise NotImplementedError(f"entity dim {cut_data.hosted_dim}")
        levels, curved = _approx_plan(cut_data, phi, mesh)
        if op == "=":
            return interface_rules(mesh, phi, cut_entities, order,
                                   levels=levels, curved=curved)
        return volume_rules(mesh, phi, cut_entities, order, side=side,
                            levels=levels, curved=curved)


def _compound_masks(cut_data, clauses):
    """(inclusive-match mask, any-clause-intersected mask, phis, sides)."""
    phis, sides = [], []
    incl = np.ones(len(cut_data.hosted_entities), bool)
    any_cut = np.zeros(len(cut_data.hosted_entities), bool)
    for name, op in clauses:
        if op == "=":
            raise NotImplementedError(
                "compound selectors with '=' clauses are not supported "
                "for runtime quadrature")
        idx = cut_data.level_set_names.index(name)
        d = cut_data.domains[idx]
        want = DOMAIN_INSIDE if op in ("<", "<=") else DOMAIN_OUTSIDE
        incl &= (d == want) | (d == DOMAIN_INTERSECTED)
        any_cut |= d == DOMAIN_INTERSECTED
        phis.append(cut_data.level_sets[idx])
        sides.append("<" if op in ("<", "<=") else ">")
    return incl, any_cut, phis, sides


def _compound_runtime_quadrature(cut_data, clauses, order, cells=None):
    """AND-intersection region rules: cells matching every clause
    inclusively with at least one clause intersected (or an explicit cell
    set); each cell cut recursively by all participating level sets."""
    mesh = cut_data.mesh
    if cut_data.hosted_dim != mesh.tdim:
        raise NotImplementedError(
            "compound runtime quadrature requires cell-hosted CutData")
    incl, any_cut, phis, sides = _compound_masks(cut_data, clauses)
    if cells is None:
        cells = cut_data.hosted_entities[incl & any_cut]
    levels = max(_subdivision_levels(cut_data, p) for p in phis)
    return compound_volume_rules(mesh, list(zip(phis, sides)), cells,
                                 order, levels=levels)


def _union_runtime_quadrature(cut_data, terms, order):
    """OR of AND-terms by inclusion-exclusion: |A u B| = A + B - A^B,
    emitted as concatenated signed-weight rule blocks (every subset S of
    terms contributes (-1)^(|S|+1) x rules(AND of S's clauses)). Cells
    wholly inside some term are left to ``locate_entities``."""
    for clauses in terms:
        for name, op in clauses:
            if op == "=":
                raise NotImplementedError(
                    "union selectors with '=' clauses are not supported "
                    "for runtime quadrature")
    fully_inside = np.zeros(len(cut_data.hosted_entities), bool)
    for clauses in terms:
        incl, any_cut, _, _ = _compound_masks(cut_data, clauses)
        fully_inside |= incl & ~any_cut
    pieces = []
    for size in range(1, len(terms) + 1):
        for subset in combinations(range(len(terms)), size):
            # the subset's clauses, duplicates dropped, in order
            uniq = list(dict.fromkeys(c for i in subset for c in terms[i]))
            incl, _, _, _ = _compound_masks(cut_data, uniq)
            cells = cut_data.hosted_entities[incl & ~fully_inside]
            rules = _compound_runtime_quadrature(cut_data, uniq, order,
                                                 cells=cells)
            pieces.append((1.0 if size % 2 == 1 else -1.0, rules))
    qmax = max(r.points_padded.shape[1] for _, r in pieces)
    pts, wts = [], []
    for sign, r in pieces:
        pad = qmax - r.points_padded.shape[1]
        pts.append(torch.nn.functional.pad(r.points_padded,
                                           (0, 0, 0, pad)))
        wts.append(torch.nn.functional.pad(sign * r.weights_padded,
                                           (0, pad)))
    return RuntimeQuadratureRules(
        cut_data.mesh.tdim, np.concatenate([r.parent_map for _, r in pieces]),
        torch.cat(pts), torch.cat(wts), mesh=cut_data.mesh)


def runtime_quadratures(cut_data: CutData, ls_parts, order: int, *,
                        backend: str = "straight"):
    """{selector: runtime_quadrature(cut_data, selector, order)} for each
    of ``ls_parts``."""
    return {str(p): runtime_quadrature(cut_data, str(p), order,
                                       backend=backend)
            for p in ls_parts}


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
    with span("cut.ghost_facets"):
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
    """Build a simplex mesh of the selected part of cell- or facet-hosted
    CutData. mode: 'full' includes the uncut entities of the phase,
    'cut_only' only the cut fragments; 'auto' is 'full' for volume parts
    and 'cut_only' for interfaces. The fragments are marched in physical coordinates on
    the level set's device from its values at the cell vertices."""
    mode = mode or "auto"
    terms = parse_selector(ls_part)
    if len(terms) != 1 or len(terms[0]) != 1:
        # as in the reference: a cut mesh is of one level set's part
        raise NotImplementedError(
            "cut meshes support single-clause selectors "
            f"(got {ls_part!r})")
    name, op = terms[0][0]
    idx = cut_data.level_set_names.index(name)
    phi = cut_data.level_sets[idx]
    mesh = cut_data.mesh
    tdim = mesh.tdim
    if op == "=" and mode == "full":
        raise ValueError(
            "mode='full' is not valid for interface parts ('=' selector)")
    if cut_data.hosted_dim == tdim - 1:
        return _create_facet_cut_mesh(cut_data, idx, op, mode)
    if cut_data.hosted_dim != tdim:
        raise NotImplementedError("cut meshes require cell- or facet-hosted "
                                  "CutData")
    if mode == "auto":
        mode = "cut_only" if op == "=" else "full"

    cut_cells = cut_data.hosted_entities[
        cut_data.domains[idx] == DOMAIN_INTERSECTED]
    split = mesh.ref_cell.simplex_split
    VOL, SURF = simplex_cut_tables(tdim)
    parts = _Parts()

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
                X, valid, _ = _march_parts(ph, pv, tdim, SURF)
            else:
                sgn = -1.0 if op in (">", ">=") else 1.0
                X, valid, _ = _march_parts(sgn * ph, pv, tdim, VOL)
            parts.add(X.cpu().numpy(), valid.cpu().numpy(), cut_cells, 1)

    if mode == "full" and op != "=":
        want = DOMAIN_INSIDE if op in ("<", "<=") else DOMAIN_OUTSIDE
        full_cells = cut_data.hosted_entities[cut_data.domains[idx] == want]
        if len(full_cells):
            coords = mesh.cell_vertex_coords[full_cells]
            for sub in split:
                pv = coords[:, sub, :]
                parts.add(pv[:, None], np.ones((pv.shape[0], 1), bool),
                          full_cells, 0)

    return parts.cut_mesh(tdim - 1 if op == "=" else tdim)


class _Parts:
    """The simplices of a cut mesh as they are found: ``add`` takes the
    valid parts of a marching (X (C, M, m, gdim), valid (C, M)) with their
    parent entities; ``cut_mesh`` joins them."""

    def __init__(self):
        self.verts, self.cells, self.parents, self.iscut = [], [], [], []
        self.nv = 0

    def add(self, X, valid, parent_entities, cut_flag):
        sel = np.nonzero(valid)
        npart = len(sel[0])
        if npart == 0:
            return
        m, g = X.shape[2], X.shape[3]
        self.verts.append(X[sel[0], sel[1]].reshape(-1, g))
        self.cells.append((np.arange(npart * m) + self.nv).reshape(npart, m))
        self.nv += npart * m
        self.parents.append(parent_entities[sel[0]])
        self.iscut.append(np.full(npart, cut_flag, np.int8))

    def cut_mesh(self, out_dim):
        if not self.verts:
            return CutMesh(None, np.zeros(0, np.int32), np.zeros(0, np.int8))
        vis = Mesh(np.concatenate(self.verts), np.concatenate(self.cells),
                   _SIMPLEX_OF_DIM[out_dim])
        return CutMesh(vis, np.concatenate(self.parents),
                       np.concatenate(self.iscut))


def _create_facet_cut_mesh(cut_data, idx, op, mode):
    """Mesh of the cut parts hosted on (simplex) facets, marched on the
    level set's values at the facet vertices (exact for a P1 level set;
    vertex dofs lead the Lagrange numbering) on its device."""
    mesh = cut_data.mesh
    k = mesh.tdim - 1
    phi = cut_data.level_sets[idx]
    if mesh.facets.shape[1] != k + 1:
        raise NotImplementedError(
            "facet-hosted cut meshes support simplex facets")
    out_dim = k - 1 if op == "=" else k
    if out_dim < 1:
        raise NotImplementedError(
            "facet interface parts in 2D are point sets, not meshes")
    if mode == "auto":
        mode = "cut_only" if op == "=" else "full"
    VOL, SURF = simplex_cut_tables(k)
    ents = cut_data.hosted_entities
    dom = cut_data.domains[idx]
    cut_facets = ents[dom == DOMAIN_INTERSECTED]
    parts = _Parts()
    if len(cut_facets):
        dev = phi.x.device
        fv = mesh.facets[cut_facets]
        coords = torch.as_tensor(mesh.vertices[fv], dtype=phi.x.dtype,
                                 device=dev)
        ph = phi.x[torch.as_tensor(fv, dtype=torch.int64, device=dev)]
        if op == "=":
            X, valid, _ = _march_parts(ph, coords, k, SURF)
        else:
            sgn = -1.0 if op in (">", ">=") else 1.0
            X, valid, _ = _march_parts(sgn * ph, coords, k, VOL)
        parts.add(X.cpu().numpy(), valid.cpu().numpy(), cut_facets, 1)
    if mode == "full" and op != "=":
        want = DOMAIN_INSIDE if op in ("<", "<=") else DOMAIN_OUTSIDE
        full_f = ents[dom == want]
        if len(full_f):
            coords = mesh.vertices[mesh.facets[full_f]]
            parts.add(coords[:, None], np.ones((len(full_f), 1), bool),
                      full_f, 0)
    return parts.cut_mesh(out_dim)
