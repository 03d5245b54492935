"""Signed-distance subsystem: STL ingestion, exact near-field
point-triangle distances, the Eikonal fast-iterative far field as masked
full-array sweeps, three sign strategies, level-set reinitialization and
normal-velocity extension — the torch counterpart of
``cutfemx_tpu.distance``."""

from .fim import FMMOptions, eikonal_solve  # noqa: F401
from .stl import (TriSoup, read_stl, stl_bbox, distribute_stl,
                  build_cell_triangle_map)  # noqa: F401
from .api import (SignMode, from_stl, compute_signed_distance,
                  compute_unsigned_distance, reinitialize,
                  reinitialize_from_facets, extend_normal_velocity,
                  NormalExtensionResult, adapt_mesh_to_stl,
                  refinement_edges_from_stl)  # noqa: F401

