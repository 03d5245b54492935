"""Cell aggregation and extension-penalty stabilization.

The torch counterpart of ``cutfemx_tpu.extensions``: ill-posed (small-cut)
cells are mapped to well-posed root cells by iterative facet-neighbour
propagation, and an L2 penalty beta*(u_bad - u_root)(v_bad - v_root) over
the full bad cell ties each bad cell's dofs to its root's polynomial
extension (quadrature on the bad cell, the same physical points pulled back
into the root's reference coordinates).

The aggregation is host numpy and Python, as in the reference: its sweep is
a Gauss-Seidel propagation whose roots depend on the visiting order. The
volume fractions, the extension quadrature and the element matrices are
computed on the level set's and the space's device; the penalty matrix is
assembled on the host (COO -> CSR with SciPy) like every ``MatrixCSR``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .cut.classify import CutData
from .cut.quadrature import volume_rules
from .cut.selector import parse_selector
from .elements import lagrange_element
from .geometry import pullback
from .la import MatrixCSR
from .quadrature import quadrature_rule

__all__ = [
    "CellAggregation", "ExtensionQuadrature", "ExtensionPenaltyTerm",
    "create_cell_aggregation", "extension_quadrature",
    "assemble_extension_penalty", "extension_penalty_matrix",
    "create_extension_penalty_matrix",
]


@dataclass
class CellAggregation:
    """Aggregation state: host arrays of cell ids, and per-cell arrays
    over all cells of the mesh (-1 where unset)."""
    interior_cells: np.ndarray
    cut_cells: np.ndarray
    active_cells: np.ndarray
    well_posed_cells: np.ndarray
    ill_posed_cells: np.ndarray
    rootless_cells: np.ndarray
    cut_volume_fraction: np.ndarray   # (num_cells,)
    root_cell: np.ndarray             # (num_cells,), -1 unset
    aggregate_id: np.ndarray
    propagation_depth: np.ndarray


def _strict_clause(selector):
    terms = parse_selector(selector)
    if len(terms) != 1 or len(terms[0]) != 1 or \
            terms[0][0][1] not in ("<", ">"):
        raise ValueError(
            "cell aggregation requires a strict single-clause selector "
            f"like 'phi<0' (got {selector!r})")
    return terms[0][0]


def _facet_neighbours(mesh):
    """CSR (offsets, neighbours) of each cell's facet neighbours, each
    cell's list sorted ascending without repeats."""
    fc = mesh.facet_cells
    pairs = fc[fc[:, 1] >= 0].astype(np.int64)
    nc = mesh.num_cells
    key = np.unique(np.concatenate([pairs[:, 0] * nc + pairs[:, 1],
                                    pairs[:, 1] * nc + pairs[:, 0]]))
    offsets = np.zeros(nc + 1, np.int64)
    np.cumsum(np.bincount(key // nc, minlength=nc), out=offsets[1:])
    return offsets, key % nc


def create_cell_aggregation(cut_data: CutData, selector: str,
                            volume_fraction_threshold: float, *,
                            root_policy: str = "interior_or_well_cut",
                            max_iterations: int = -1,
                            allow_rootless: bool = False) -> CellAggregation:
    """Classify cells and propagate ill-posed cells to roots. The sweep is
    the reference's: ill-posed cells in ascending order, the first rooted
    active facet neighbour in ascending cell order wins, and an update is
    visible within the same sweep."""
    if cut_data.entity_dim is not None:
        raise ValueError("CellAggregation v1 only supports cuts on the "
                         "original background cell mesh")
    if not 0.0 <= volume_fraction_threshold <= 1.0:
        raise ValueError("Volume fraction threshold must be in [0, 1].")
    if root_policy not in ("interior_only", "interior_or_well_cut"):
        raise ValueError("Unknown root policy. Expected 'interior_only' or "
                         "'interior_or_well_cut'.")
    name, op = _strict_clause(selector)
    if name not in cut_data.level_set_names:
        raise ValueError("CellAggregation selector level set is unknown.")
    phi = cut_data.level_sets[cut_data.level_set_names.index(name)]
    mesh = cut_data.mesh
    nc = mesh.num_cells

    interior = cut_data.locate(f"{name}{op}0")
    cut_cells = cut_data.locate(f"{name}=0")
    active = np.union1d(interior, cut_cells).astype(np.int32)

    # volume fractions of the selected phase on cut cells
    fractions = np.zeros(nc)
    if len(cut_cells):
        rules = volume_rules(mesh, phi, cut_cells, order=2, side=op)
        part_vol = rules.weights_padded.sum(dim=1).cpu().double().numpy()
        fractions[cut_cells] = part_vol / _cell_volumes(mesh, cut_cells)

    if root_policy == "interior_or_well_cut":
        well_cut = fractions[cut_cells] >= volume_fraction_threshold
    else:
        well_cut = np.zeros(len(cut_cells), bool)
    well_posed = np.union1d(interior, cut_cells[well_cut]).astype(np.int32)
    ill_posed = np.unique(cut_cells[~well_cut]).astype(np.int32)

    root_cell = np.full(nc, -1, np.int32)
    aggregate_id = np.full(nc, -1, np.int32)
    depth = np.full(nc, -1, np.int32)
    root_cell[well_posed] = well_posed
    aggregate_id[well_posed] = np.arange(len(well_posed), dtype=np.int32)
    depth[well_posed] = 0

    offsets, neighbours = _facet_neighbours(mesh)
    is_active = np.zeros(nc, bool)
    is_active[active] = True
    # the ill-posed cells' candidate roots: active neighbours, ascending
    cand = {}
    for c in ill_posed.tolist():
        ns = neighbours[offsets[c]:offsets[c + 1]]
        cand[c] = ns[is_active[ns]].tolist()

    limit = nc if max_iterations < 0 else max_iterations
    for _ in range(limit):
        mapped = 0
        for c in ill_posed.tolist():
            if root_cell[c] >= 0:
                continue
            for other in cand[c]:
                if root_cell[other] < 0:
                    continue
                root_cell[c] = root_cell[other]
                aggregate_id[c] = aggregate_id[other]
                depth[c] = depth[other] + 1
                mapped += 1
                break
        if mapped == 0:
            break

    rootless = ill_posed[root_cell[ill_posed] < 0]
    if len(rootless) and not allow_rootless:
        raise RuntimeError(
            "CellAggregation found active ill-posed cells without an "
            "admissible root. Adjust the root policy or threshold, or "
            "explicitly allow rootless aggregation for diagnostics.")

    return CellAggregation(interior, cut_cells, active, well_posed,
                           ill_posed, rootless, fractions, root_cell,
                           aggregate_id, depth)


def _cell_volumes(mesh, cells):
    """Host volumes of the given cells (sums over their simplex split)."""
    coords = mesh.cell_vertex_coords[cells]
    vol = np.zeros(len(cells))
    for sub in mesh.ref_cell.simplex_split:
        v = coords[:, sub, :]
        E = v[:, 1:, :] - v[:, :1, :]
        if mesh.tdim == 2:
            vol += 0.5 * np.abs(E[:, 0, 0] * E[:, 1, 1]
                                - E[:, 0, 1] * E[:, 1, 0])
        else:
            vol += np.abs(np.einsum("ci,ci->c", np.cross(E[:, 0], E[:, 1]),
                                    E[:, 2])) / 6.0
    return vol


@dataclass
class ExtensionQuadrature:
    """Full-cell quadrature on bad cells with root pullbacks: host cell
    ids and tensors on the space's device."""
    bad_cells: np.ndarray        # (nb,)
    root_cells: np.ndarray       # (nb,)
    points_bad: torch.Tensor     # (nb, nq, tdim) bad-cell reference coords
    points_root: torch.Tensor    # (nb, nq, tdim) root-cell reference coords
    weights: torch.Tensor        # (nb, nq) physical weights


def extension_quadrature(V, cut_data: CutData,
                         aggregation: CellAggregation,
                         quadrature_degree: int) -> ExtensionQuadrature:
    """The standard full-cell rule on each rooted bad cell, and the same
    physical points in the root's reference coordinates, on V's device in
    f64 (the affine pullback on simplices, Newton's on quads and
    hexahedra)."""
    mesh = cut_data.mesh
    dt, dev = torch.float64, V.device
    bad = aggregation.ill_posed_cells
    bad = bad[aggregation.root_cell[bad] >= 0]
    roots = aggregation.root_cell[bad]
    pts, w = quadrature_rule(mesh.cell_type, quadrature_degree)
    ref = torch.as_tensor(pts, dtype=dt, device=dev)
    coords_bad = torch.as_tensor(mesh.cell_vertex_coords[bad], dtype=dt,
                                 device=dev)
    coords_root = torch.as_tensor(mesh.cell_vertex_coords[roots], dtype=dt,
                                  device=dev)
    el1 = lagrange_element(mesh.cell_type, 1)
    xphys = torch.einsum("qv,cvg->cqg", el1.tabulate(ref), coords_bad)
    pts_root = torch.func.vmap(
        lambda c, x: pullback(mesh.cell_type, c, x))(coords_root, xphys)
    # physical weights: w * |detJ_bad|
    J = torch.einsum("cvg,qvt->cqgt", coords_bad, el1.tabulate_grad(ref))
    weights = torch.as_tensor(w, dtype=dt, device=dev)[None, :] * \
        torch.abs(torch.linalg.det(J))
    pts_bad = ref.expand(len(bad), len(w), mesh.tdim)
    return ExtensionQuadrature(bad, roots, pts_bad, pts_root, weights)


@dataclass
class ExtensionPenaltyTerm:
    """Descriptor of an extension penalty contribution (what
    ``assemble_matrix(extension_terms=...)`` takes)."""
    V: object
    cut_data: CutData
    aggregation: CellAggregation
    beta: object = 1.0
    quadrature_degree: int = 2


def _penalty_element_matrices(V, eq: ExtensionQuadrature, beta):
    """(nb, 2*nd, 2*nd) element matrices over stacked (bad, root) dofs.
    ``beta``: a number, or one value per mesh cell (array or tensor)."""
    el = V.element
    psi = torch.cat([el.tabulate(eq.points_bad),
                     -el.tabulate(eq.points_root)], dim=-1)  # (nb, nq, 2nd)
    w = eq.weights
    if isinstance(beta, (int, float)):
        bw = float(beta) * w
    else:
        beta_arr = torch.as_tensor(beta, dtype=w.dtype, device=w.device)
        if beta_arr.ndim != 1:
            raise ValueError("cellwise beta must be a 1D per-cell array")
        idx = torch.as_tensor(eq.bad_cells, dtype=torch.int64,
                              device=w.device)
        bw = beta_arr[idx][:, None] * w
    return torch.einsum("cq,cqi,cqj->cij", bw, psi, psi)


def _penalty_dofs(V, eq):
    bd = V.blocked_dofmap
    return np.concatenate([bd[eq.bad_cells], bd[eq.root_cells]], axis=1)


def assemble_extension_penalty(A, V, cut_data=None, aggregation=None,
                               beta=None, quadrature_degree=None):
    """Add the L2 extension penalty into ``A`` (a MatrixCSR). ``V`` may be
    an ExtensionPenaltyTerm, whose fields fill the other arguments left
    None. ``beta`` is a number, a per-cell array, or a DG0 Function; the
    quadrature degree defaults to twice V's degree."""
    if isinstance(V, ExtensionPenaltyTerm):
        term = V
        V, cut_data, aggregation = term.V, term.cut_data, term.aggregation
        beta = term.beta if beta is None else beta
        quadrature_degree = term.quadrature_degree if quadrature_degree \
            is None else quadrature_degree
    beta = 1.0 if beta is None else beta
    quadrature_degree = 2 * V.degree if quadrature_degree is None else \
        quadrature_degree
    from .functionspace import Function
    if isinstance(beta, Function):
        if beta.function_space.degree != 0:
            raise ValueError("beta Function must be DG0")
        beta = beta.x
    eq = extension_quadrature(V, cut_data, aggregation, quadrature_degree)
    if len(eq.bad_cells) == 0:
        return A
    Ae = _penalty_element_matrices(V, eq, beta).cpu().numpy()
    dofs = _penalty_dofs(V, eq)
    nb, nd2 = dofs.shape
    rows = np.broadcast_to(dofs[:, :, None], (nb, nd2, nd2)).ravel()
    cols = np.broadcast_to(dofs[:, None, :], (nb, nd2, nd2)).ravel()
    M = MatrixCSR.from_coo(rows, cols, Ae.ravel(), (V.dim, V.dim))
    A._m = (A.to_scipy() + M.to_scipy()).tocsr()
    return A


def extension_penalty_matrix(V, cut_data, aggregation, beta=1.0,
                             quadrature_degree=None):
    """The penalty assembled into a fresh MatrixCSR."""
    return assemble_extension_penalty(
        create_extension_penalty_matrix(V, cut_data, aggregation), V,
        cut_data, aggregation, beta, quadrature_degree)


def create_extension_penalty_matrix(V, cut_data, aggregation, dtype=None):
    """A zero MatrixCSR of V's shape (host CSR builds its sparsity on
    insert)."""
    import scipy.sparse as sps
    return MatrixCSR(sps.csr_matrix((V.dim, V.dim)))
