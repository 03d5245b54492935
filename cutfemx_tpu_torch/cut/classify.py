"""Entity classification against level sets.

Replaces the CutCells parent-cell classification consumed by the reference
(upstream CutFEMx cpp/cutfemx/cut/cut.cpp:292-321 classify_entity_dofs): an
entity is *inside* if all its level-set dofs are < 0, *outside* if all > 0,
and *intersected* otherwise (so exact zeros classify as intersected,
mirroring test_cut_api.py:191 zero-dofs-are-interface).
"""

from __future__ import annotations

import numpy as np

from .selector import (DOMAIN_INSIDE, DOMAIN_INTERSECTED, DOMAIN_OUTSIDE,
                       selector_mask)

__all__ = ["classify_entities", "entity_closure_dofs", "CutData",
           "frozen_level_set_names"]


def _local_facet_closure_dofs(element, cell):
    """Static table: local facet -> element dofs on that facet's closure."""
    tdim = cell.tdim
    out = []
    for lf in range(cell.num_facets):
        fverts = set(int(v) for v in cell.facets[lf])
        dofs = []
        for dof, (edim, eidx) in enumerate(element.dof_entities):
            if edim == 0:
                ok = eidx in fverts
            elif edim == 1 and tdim == 2:
                ok = eidx == lf
            elif edim == 1 and tdim == 3:
                a, b = cell.edges[eidx]
                ok = int(a) in fverts and int(b) in fverts
            elif edim == tdim - 1:
                ok = eidx == lf
            else:
                ok = False
            if ok:
                dofs.append(dof)
        out.append(dofs)
    return out


def entity_closure_dofs(space, dim, entities):
    """Global dofs on the closure of each entity: (n, ndofs_entity) int32.

    Supports cells (dim == tdim), facets (dim == tdim-1), and vertices
    (dim == 0, continuous spaces: vertex dofs are numbered first, so the
    scalar dof of vertex v is v — functionspace._build_dofmap)."""
    mesh = space.mesh
    entities = np.asarray(entities, dtype=np.int32)
    if dim == 0:
        if getattr(space, "family", "Lagrange") == "DG":
            raise NotImplementedError("vertex dofs of a DG space")
        return entities.reshape(-1, 1)
    if dim == mesh.tdim:
        return space.dofmap[entities]
    if dim == mesh.tdim - 1:
        table = _local_facet_closure_dofs(space.element, mesh.ref_cell)
        nd = len(table[0])
        cells = mesh.facet_cells[entities, 0]
        locals_ = mesh.facet_local_index[entities, 0]
        tab = np.asarray(table)                   # (nf_local, nd)
        local_dofs = tab[locals_]                 # (n, nd)
        return np.take_along_axis(space.dofmap[cells], local_dofs, axis=1)
    raise NotImplementedError(f"entity dim {dim}")


def classify_entities(phi, dim, entities):
    """(n,) int8 domain codes for the given entities."""
    space = phi.function_space
    dofs = entity_closure_dofs(space, dim, entities)
    vals = phi.x.cpu().numpy()[dofs]              # (n, nd)
    all_neg = (vals < 0).all(axis=1)
    all_pos = (vals > 0).all(axis=1)
    out = np.full(len(entities), DOMAIN_INTERSECTED, dtype=np.int8)
    out[all_neg] = DOMAIN_INSIDE
    out[all_pos] = DOMAIN_OUTSIDE
    return out


_UNSPECIFIED_NAMES = ("", "f", "u")


def frozen_level_set_names(level_sets):
    """Default names phi, phi1, ... honoring user-set valid names
    (cut.cpp:81-137 frozen_level_set_names)."""
    import re
    valid = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")
    real = []
    for ls in level_sets:
        name = getattr(ls, "name", "") or ""
        if name in _UNSPECIFIED_NAMES:
            real.append(None)
        else:
            if not valid.match(name):
                raise ValueError(
                    f"level-set name '{name}' is not a valid selector "
                    "identifier")
            real.append(name)
    used = set(n for n in real if n)
    if len(used) != len([n for n in real if n]):
        raise ValueError("Duplicate level-set function name")
    names = []
    for i, name in enumerate(real):
        if name:
            names.append(name)
            continue
        cand = "phi" if i == 0 else f"phi{i}"
        j = 1 if i == 0 else i + 1
        while cand in used:
            cand = f"phi{j}"
            j += 1
        used.add(cand)
        names.append(cand)
    return tuple(names)


class CutData:
    """Cut state: level sets + per-entity classification
    (the reference's CutData, upstream CutFEMx python/cutfemx/cut.py:94-147).
    """

    def __init__(self, level_sets, entities=None, entity_dim=None,
                 options=None):
        self._level_sets = tuple(level_sets)
        if not self._level_sets:
            raise ValueError("need at least one level set")
        self.level_set_names = frozen_level_set_names(self._level_sets)
        msh = self._level_sets[0].function_space.mesh
        for ls in self._level_sets:
            if ls.function_space.mesh is not msh:
                raise ValueError("level sets must share a mesh")
            if ls.function_space.value_shape:
                raise ValueError("level sets must be scalar Lagrange "
                                 "functions")
        self._mesh = msh
        if entities is None:
            if entity_dim is not None:
                raise ValueError(
                    "entity_dim is only valid when entities are supplied")
            self._entities = None
            self._entity_dim = None
        else:
            if entity_dim is None:
                raise ValueError(
                    "entity_dim must be supplied when entities are supplied")
            self._entities = np.asarray(entities, dtype=np.int32)
            self._entity_dim = int(entity_dim)
        self.options = options or {}
        self.update()

    def update(self):
        """Re-classify from current level-set values (cut.cpp:845-868)."""
        dim = self.hosted_dim
        ents = self.hosted_entities
        self.domains = np.stack(
            [classify_entities(ls, dim, ents) for ls in self._level_sets])

    @property
    def hosted_dim(self):
        return self._entity_dim if self._entity_dim is not None \
            else self._mesh.tdim

    @property
    def hosted_entities(self):
        if self._entities is not None:
            return self._entities
        n = (self._mesh.num_cells if self.hosted_dim == self._mesh.tdim
             else self._mesh.num_facets)
        return np.arange(n, dtype=np.int32)

    @property
    def level_sets(self):
        return self._level_sets

    @property
    def mesh(self):
        return self._mesh

    @property
    def tdim(self):
        return self._mesh.tdim

    @property
    def gdim(self):
        return self._mesh.gdim

    @property
    def num_local_cells(self):
        return self._mesh.num_cells

    @property
    def entities(self):
        return self._entities

    @property
    def entity_dim(self):
        return self._entity_dim

    def select(self, selector):
        """Boolean mask over hosted entities."""
        return selector_mask(selector, self.level_set_names, self.domains)

    def locate(self, selector):
        """Entity indices matching the selector (locate_entities)."""
        return self.hosted_entities[self.select(selector)].astype(np.int32)
