"""Reference cell definitions.

Array-based analog of the Basix reference-cell conventions used by the
reference library (vertex/edge/facet numbering follows Basix so that the
classification and cut semantics of upstream CutFEMx cpp/cutfemx/cut/cut.cpp
carry over; see also upstream CutFEMx cpp/cutfemx/mesh/convert.h:14-90 for the
dolfinx<->cutcells<->basix cell-type mapping this replaces).

Everything here is static host-side data (NumPy, float64): reference vertex
coordinates, sub-entity (edge/facet) vertex lists, and simplex decompositions
of tensor-product cells. The torch compute path consumes these as constants.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "CellType",
    "ReferenceCell",
    "reference_cell",
]


class CellType:
    interval = "interval"
    triangle = "triangle"
    quadrilateral = "quadrilateral"
    tetrahedron = "tetrahedron"
    hexahedron = "hexahedron"


class ReferenceCell:
    """Static description of a reference cell.

    Attributes
    ----------
    name: cell type name
    tdim: topological dimension
    vertices: (num_vertices, tdim) float64 reference coordinates
    edges: (num_edges, 2) vertex indices (Basix ordering)
    facets: (num_facets, nv_facet) vertex indices of codim-1 sub-entities
    facet_cell_type: name of the facet cell type
    volume: reference measure
    simplex_split: (n_sub, tdim+1) decomposition into simplices expressed in
        local vertex indices (identity for simplices)
    """

    def __init__(self, name, tdim, vertices, edges, facets, facet_cell_type,
                 simplex_split):
        self.name = name
        self.tdim = tdim
        self.vertices = np.asarray(vertices, dtype=np.float64)
        self.edges = np.asarray(edges, dtype=np.int32).reshape(-1, 2)
        self.facets = np.asarray(facets, dtype=np.int32)
        self.facet_cell_type = facet_cell_type
        self.simplex_split = np.asarray(simplex_split, dtype=np.int32)
        self.num_vertices = self.vertices.shape[0]
        self.num_edges = self.edges.shape[0]
        self.num_facets = self.facets.shape[0]
        if name == CellType.interval:
            self.volume = 1.0
        elif name == CellType.triangle:
            self.volume = 0.5
        elif name == CellType.quadrilateral:
            self.volume = 1.0
        elif name == CellType.tetrahedron:
            self.volume = 1.0 / 6.0
        elif name == CellType.hexahedron:
            self.volume = 1.0
        else:  # pragma: no cover
            raise ValueError(f"unknown cell {name}")

    @property
    def is_simplex(self):
        return self.name in (CellType.interval, CellType.triangle,
                             CellType.tetrahedron)

    def facet_vertices_coords(self):
        """(num_facets, nv_facet, tdim) coordinates of facet vertices."""
        return self.vertices[self.facets]


_CELLS = {}


def _register(cell):
    _CELLS[cell.name] = cell
    return cell


# interval: vertices 0,1
_register(ReferenceCell(
    CellType.interval, 1,
    vertices=[[0.0], [1.0]],
    edges=np.zeros((0, 2)),
    facets=[[0], [1]],
    facet_cell_type="point",
    simplex_split=[[0, 1]],
))

# triangle (Basix): v0=(0,0), v1=(1,0), v2=(0,1).
# Edge i is opposite vertex i: e0=(1,2), e1=(0,2), e2=(0,1).
_register(ReferenceCell(
    CellType.triangle, 2,
    vertices=[[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]],
    edges=[[1, 2], [0, 2], [0, 1]],
    facets=[[1, 2], [0, 2], [0, 1]],
    facet_cell_type=CellType.interval,
    simplex_split=[[0, 1, 2]],
))

# quadrilateral (Basix): v0=(0,0), v1=(1,0), v2=(0,1), v3=(1,1)
_register(ReferenceCell(
    CellType.quadrilateral, 2,
    vertices=[[0.0, 0.0], [1.0, 0.0], [0.0, 1.0], [1.0, 1.0]],
    edges=[[0, 1], [0, 2], [1, 3], [2, 3]],
    facets=[[0, 1], [0, 2], [1, 3], [2, 3]],
    facet_cell_type=CellType.interval,
    simplex_split=[[0, 1, 2], [1, 3, 2]],
))

# tetrahedron (Basix): v0=(0,0,0), v1=(1,0,0), v2=(0,1,0), v3=(0,0,1)
# edges: (2,3),(1,3),(1,2),(0,3),(0,2),(0,1); facet i opposite vertex i
_register(ReferenceCell(
    CellType.tetrahedron, 3,
    vertices=[[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
              [0.0, 0.0, 1.0]],
    edges=[[2, 3], [1, 3], [1, 2], [0, 3], [0, 2], [0, 1]],
    facets=[[1, 2, 3], [0, 2, 3], [0, 1, 3], [0, 1, 2]],
    facet_cell_type=CellType.triangle,
    simplex_split=[[0, 1, 2, 3]],
))

# hexahedron (Basix): vertices in lexicographic (x fastest) order
# (0,0,0),(1,0,0),(0,1,0),(1,1,0),(0,0,1),(1,0,1),(0,1,1),(1,1,1)
# Freudenthal 6-tet split along the 0-7 diagonal (same decomposition the
# reference uses for its virtual simplices, fast_iterative.h:71-110).
_register(ReferenceCell(
    CellType.hexahedron, 3,
    vertices=[[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
              [1.0, 1.0, 0.0], [0.0, 0.0, 1.0], [1.0, 0.0, 1.0],
              [0.0, 1.0, 1.0], [1.0, 1.0, 1.0]],
    edges=[[0, 1], [0, 2], [0, 4], [1, 3], [1, 5], [2, 3], [2, 6], [3, 7],
           [4, 5], [4, 6], [5, 7], [6, 7]],
    facets=[[0, 1, 2, 3], [0, 1, 4, 5], [0, 2, 4, 6], [1, 3, 5, 7],
            [2, 3, 6, 7], [4, 5, 6, 7]],
    facet_cell_type=CellType.quadrilateral,
    simplex_split=[[0, 1, 3, 7], [0, 3, 2, 7], [0, 2, 6, 7],
                   [0, 6, 4, 7], [0, 4, 5, 7], [0, 5, 1, 7]],
))


def reference_cell(name: str) -> ReferenceCell:
    try:
        return _CELLS[name]
    except KeyError:
        raise ValueError(f"unknown cell type '{name}'") from None
