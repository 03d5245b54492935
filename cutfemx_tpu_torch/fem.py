"""Runtime form assembly, dof deactivation and matrix-free operators.

The torch counterpart of ``cutfemx_tpu.fem``: ``form``/``CutForm`` (rank
0, 1 and 2, real or complex, per-block forms of a mixed space, ``dx``,
``ds`` and ``dS`` integrals over standard entities or runtime rules,
side-aware quadrature fields on runtime ``dS``, vertex ``dP`` and ridge
``dr`` integrals over entity arrays) with its bucket padding, the monolithic
``MixedCutForm``, ``extract_blocks``, ``assemble_scalar/vector/matrix``
and their block variants, strong Dirichlet conditions (``dirichletbc``,
``locate_dofs_*``, ``set_bc``, ``apply_lifting``), the sparsity helpers
and extension-penalty terms, ``active_domain``, ``deactivate_outside``,
``zero_rows`` and their block variants, ``derivative``/``newton_solve``,
and the element-batched ``CutOperator``.
The compiled kernels come from ``forms.compile``; this module decides which
entities each integral runs over (standard vs runtime quadrature) and
performs the global scatter.

Element data is computed on the device of the form; ``assemble_matrix``
builds its CSR matrix on the host with SciPy, as the reference does, and
the boundary-condition elimination and the direct solves run there too.
Every device scatter is a segment sum over row-sorted contributions
(``segment_sum_sorted``), so it sums in the same order on every run; CUDA's
``index_add_`` would sum with atomics in a varying order.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .forms.compile import compile_integral
from .forms.dsl import extract_arguments
from .forms.measure import (FormExpr, Integral, Measure,
                            split_subdomain_data)
from .la import MatrixCSR
from .profiling import span

__all__ = ["CutForm", "form", "cut_form", "MixedCutForm",
           "extract_blocks", "assemble_scalar", "assemble_vector",
           "assemble_matrix", "assemble_matrix_block",
           "assemble_vector_block",
           "DirichletBC", "dirichletbc", "locate_dofs_geometrical",
           "locate_dofs_topological", "set_bc", "apply_lifting",
           "create_sparsity_pattern", "insert_diagonal", "create_matrix",
           "ActiveDomain", "MixedActiveDomain", "active_domain",
           "deactivate_outside", "deactivate_outside_blocks", "zero_rows",
           "zero_block_rows", "block_offsets", "derivative",
           "newton_solve", "CutOperator", "segment_sum_sorted"]


def segment_sum_sorted(vals, lengths):
    """Sums of consecutive runs of ``vals``: run i has ``lengths[i]``
    entries (zero-length runs sum to 0). One pass in a fixed order, with no
    atomics. Complex values are summed as (real, imag) pairs, in the same
    order (torch's segment reduction has no complex kernel)."""
    if vals.is_complex():
        return torch.view_as_complex(torch.segment_reduce(
            torch.view_as_real(vals), "sum", lengths=lengths, unsafe=True))
    return torch.segment_reduce(vals, "sum", lengths=lengths, unsafe=True)


def sorted_scatter_plan(flat_rows, num_segments, device):
    """(perm, lengths) that turn a scatter-add of values at ``flat_rows``
    into ``segment_sum_sorted(vals[perm], lengths)``."""
    flat_rows = np.asarray(flat_rows, np.int64)
    perm = np.argsort(flat_rows, kind="stable")
    lengths = np.bincount(flat_rows, minlength=num_segments)
    return (torch.as_tensor(perm, device=device),
            torch.as_tensor(lengths, device=device))


def _first_host(table, entities, num_entities, what):
    """(host row, local column) of each entity's first occurrence in
    ``table`` (rows: cells, columns: their local entities)."""
    nloc = table.shape[1]
    flat = table.ravel()
    order = np.argsort(flat, kind="stable")
    uniq, first = np.unique(flat[order], return_index=True)
    host_of = np.full(num_entities, -1, np.int64)
    host_of[uniq] = order[first] // nloc
    host = host_of[entities]
    if np.any(host < 0):
        raise ValueError(f"{what} without an adjacent cell")
    local = np.argmax(table[host] == entities[:, None], axis=1)
    return host, local


def _vertex_rules(mesh, verts, device):
    """One-point physical-weight runtime rules hosting each vertex in an
    adjacent cell: the integral is the sum of the integrand's values at
    the vertices (the reference's vertex integral type)."""
    from .cells import reference_cell
    from .cut.quadrature import RuntimeQuadratureRules
    verts = np.asarray(verts, np.int64)
    host, local = _first_host(np.asarray(mesh.cells), verts,
                              mesh.num_vertices, "vertex")
    pts = reference_cell(mesh.cell_type).vertices[local][:, None, :]
    wts = np.ones((len(verts), 1))
    return RuntimeQuadratureRules(
        mesh.tdim, host, torch.as_tensor(pts, device=device),
        torch.as_tensor(wts, device=device), mesh=mesh)


def _ridge_rules(mesh, edges, device, degree=2):
    """Arc-length Gauss rules along mesh edges, hosted in an adjacent
    cell's reference coordinates (the reference's ridge integral type,
    codim 2 in 3D)."""
    from .cells import reference_cell
    from .cut.quadrature import RuntimeQuadratureRules
    from .quadrature import gauss_legendre
    edges = np.asarray(edges, np.int64)
    host, local = _first_host(np.asarray(mesh.cell_edges), edges,
                              mesh.num_edges, "edge")
    cell = reference_cell(mesh.cell_type)
    eview = np.asarray(cell.edges)
    A = cell.vertices[eview[local, 0]]
    B = cell.vertices[eview[local, 1]]
    t, w = gauss_legendre(max(1, (degree + 2) // 2))
    pts = A[:, None, :] + t[None, :, None] * (B - A)[:, None, :]
    ev = np.asarray(mesh.edges)[edges]
    xy = np.asarray(mesh.vertices)
    length = np.linalg.norm(xy[ev[:, 1]] - xy[ev[:, 0]], axis=1)
    wts = length[:, None] * w[None, :]
    return RuntimeQuadratureRules(
        mesh.tdim, host, torch.as_tensor(pts, device=device),
        torch.as_tensor(wts, device=device), mesh=mesh)


def _canonical_device(d):
    """``d`` with its index filled in ("cuda" -> "cuda:0"), so that a
    space's device and its tensors' devices compare equal."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


@dataclass
class IntegralInstance:
    """One (kernel, entity set) pair ready for assembly."""
    kernel: object
    itype: str
    runtime: bool
    entities: np.ndarray          # cells / facets / rule parents
    rules: object = None          # RuntimeQuadratureRules for runtime
    data: dict = None             # batched kernel inputs (tensors)
    rows_cells: np.ndarray = None  # cells whose dofs receive contributions
    # (E,) for cell/ext-facet instances, (E, 2) for interior facets
    n_valid: int = None           # rows [0, n_valid) are real, the rest
    # bucket padding (host mirror of data["mask"])
    origin: tuple = None          # (integral idx, runtime, itype)


class CutForm:
    """Compiled form: mesh + integral instances + argument spaces.

    ``block=(test_part, trial_part)`` restricts assembly to one block of a
    mixed form (what ``extract_blocks`` builds). Data lives on the one
    device of the form's argument spaces, coefficients and runtime rules,
    or on ``device`` when none of them says (the card by default), in
    ``dtype`` (torch's default float dtype when None)."""

    def __init__(self, form_expr: FormExpr, dtype=None, block=None,
                 device="cuda"):
        if not isinstance(form_expr, FormExpr):
            raise TypeError("form() expects expr * measure (a FormExpr)")
        self.integrals = form_expr.integrals
        self.arguments = {}
        for itg in self.integrals:
            for key, arg in extract_arguments(itg.integrand).items():
                self.arguments.setdefault(key, arg)
        self.rank = len({num for num, _ in self.arguments})
        self.is_mixed = any(p is not None for _, p in self.arguments)
        if block is None:
            if self.is_mixed:
                raise ValueError(
                    "mixed-space forms must go through fem.extract_blocks")
            block = (None, None)
        self.block = tuple(block)
        self.mesh = self._find_mesh()
        self.device = self._find_device(device)
        self.dtype = dtype if dtype is not None else \
            torch.get_default_dtype()
        self.instances = []
        for i, itg in enumerate(self.integrals):
            for inst in self._build_instances(itg):
                inst.origin = (i, inst.runtime, inst.itype)
                self.instances.append(inst)

    # ------------------------------------------------------------------

    def _find_mesh(self):
        from .forms.dsl import traverse
        from .mesh import Mesh
        for itg in self.integrals:
            m = itg.measure.domain
            if m is not None:
                return m
            for node in traverse(itg.integrand):
                sp = getattr(node, "space", None)
                if sp is not None:
                    return sp.mesh
                fn = getattr(node, "function", None)
                if fn is not None:
                    return fn.function_space.mesh
                nm = getattr(node, "mesh", None)
                if isinstance(nm, Mesh):
                    return nm
        raise ValueError("cannot infer mesh for form")

    def _find_device(self, default):
        """The one device of the argument spaces, the coefficients and the
        runtime rules (``default`` when there are none); a form over data
        on two devices is refused rather than copied quietly."""
        from .forms.dsl import extract_coefficients
        found = [a.space.device for a in self.arguments.values()]
        for itg in self.integrals:
            found += [f.x.device
                      for f in extract_coefficients(itg.integrand)]
            _, rules = split_subdomain_data(itg.measure.subdomain_data)
            if rules is not None:
                found.append(rules.points_padded.device)
        devs = {_canonical_device(d) for d in found}
        if len(devs) > 1:
            raise ValueError(f"form data lies on several devices: {devs}")
        return devs.pop() if devs else _canonical_device(default)

    @property
    def test_space(self):
        a = self.arguments.get((0, self.block[0]))
        return a.space if a is not None else None

    @property
    def trial_space(self):
        a = self.arguments.get((1, self.block[1]))
        return a.space if a is not None else None

    def _tensor(self, a, dtype=None):
        return torch.as_tensor(a, dtype=dtype or self.dtype,
                               device=self.device)

    # -- instance building --------------------------------------------------

    def _build_instances(self, itg):
        if self.rank:
            # drop integrals not contributing to this block
            keys = set(extract_arguments(itg.integrand))
            if (0, self.block[0]) not in keys:
                return []
            if self.rank == 2 and (1, self.block[1]) not in keys:
                return []
        mesh = self.mesh
        itype = itg.integral_type
        ents, rules = split_subdomain_data(itg.measure.subdomain_data)
        out = []
        if itype == "cell":
            if rules is None:
                cells = (np.arange(mesh.num_cells, dtype=np.int32)
                         if ents is None else ents)
                out.append(self._cell_instance(itg, cells))
            else:
                if ents is not None and len(ents):
                    out.append(self._cell_instance(itg, ents))
                out.append(self._runtime_cell_instance(itg, rules))
        elif itype == "exterior_facet":
            if rules is None:
                facets = mesh.exterior_facets if ents is None else ents
                out.append(self._exterior_facet_instance(itg, facets))
            else:
                if ents is not None and len(ents):
                    out.append(self._exterior_facet_instance(itg, ents))
                out.append(self._runtime_facet_instance(itg, rules))
        elif itype == "interior_facet":
            if rules is None:
                facets = mesh.interior_facets if ents is None else ents
                out.append(self._interior_facet_instance(itg, facets))
            else:
                if ents is not None and len(ents):
                    out.append(self._interior_facet_instance(itg, ents))
                out.append(self._runtime_interior_facet_instance(itg,
                                                                 rules))
        else:  # vertex or ridge
            # lowered onto the runtime cell path: a vertex integral is a
            # one-point physical-weight rule hosted in an adjacent cell
            # (the sum of the integrand's point values); a ridge (codim-2)
            # integral is a Gauss rule along each edge, pulled back into
            # its host cell with arc-length weights. In 2D ridges are
            # vertices.
            if rules is not None:
                raise ValueError(f"{itype} integrals take entity arrays, "
                                 "not runtime rules")
            if ents is None or not len(ents):
                raise ValueError(f"{itype} integrals require an entity "
                                 "array in subdomain_data")
            if itype == "vertex" or mesh.tdim == 2:
                vr = _vertex_rules(mesh, ents, self.device)
            else:
                deg = itg.measure.metadata.get("quadrature_degree", 2)
                vr = _ridge_rules(mesh, ents, self.device, deg)
            cell_itg = Integral(itg.integrand,
                                Measure("dx", domain=itg.measure.domain,
                                        metadata=itg.measure.metadata))
            out.append(self._runtime_cell_instance(cell_itg, vr))
        return [self._bucket_pad(o) for o in out if o is not None]

    @staticmethod
    def _bucket(n):
        """Round entity counts up to stable buckets so re-cut steps with
        slightly different cut-cell counts keep the same shapes
        (zero-mask padding is exact)."""
        if n <= 32:
            step = 8
        elif n <= 512:
            step = 64
        elif n <= 16384:
            step = 1024
        else:
            # keep padding waste under ~10% at large sizes (the padded
            # elements are gathered/scattered every operator apply)
            step = 2048
        return ((n + step - 1) // step) * step

    def _bucket_pad(self, inst):
        E = inst.rows_cells.shape[0]
        target = self._bucket(E)
        data = dict(inst.data)
        mask = torch.zeros(target, dtype=self.dtype, device=self.device)
        mask[:E] = 1.0
        if target != E:
            pad = target - E

            def padded(a):
                reps = a[:1].expand((pad,) + tuple(a.shape[1:]))
                return torch.cat([a, reps], dim=0)

            for key in ("coords", "h", "points", "weights",
                        "local_facet"):
                if key in data:
                    data[key] = padded(data[key])
            for key in ("coeffs", "qfields"):
                if key in data:
                    data[key] = tuple(padded(a) for a in data[key])
            inst.rows_cells = np.concatenate(
                [inst.rows_cells,
                 np.broadcast_to(inst.rows_cells[:1],
                                 (pad,) + inst.rows_cells.shape[1:])])
        data["mask"] = mask
        inst.data = data
        inst.n_valid = E
        return inst

    def _coeff_arrays(self, coefficients, cells):
        """Gather coefficient dofs: tuple of (E, nd*bs) tensors."""
        out = []
        for f in coefficients:
            bd = f.function_space.blocked_dofmap
            g = f.x.to(device=self.device, dtype=self.dtype)[
                self._tensor(bd[cells], torch.int64)]
            out.append(g if cells.ndim == 1 else g.reshape(g.shape[0], -1))
        return tuple(out)

    def _qfield_arrays(self, qfields, rules, two_sided=False):
        """Quadrature-field values at the rule points: (E, Q, *shape), or
        (E, 2, Q, *shape) for a side-aware field on a runtime dS measure
        (``two_sided``: its '+' then its '-' values)."""
        out = []
        for qf in qfields:
            if getattr(qf, "side_dependent", False):
                if not two_sided:
                    raise ValueError(
                        f"{qf.name} is side-aware and requires a runtime dS "
                        "measure")
                v = torch.stack([qf.evaluator(rules, "+"),
                                 qf.evaluator(rules, "-")], dim=1)
            else:
                v = qf.evaluator(rules)
            out.append(v.to(device=self.device, dtype=self.dtype))
        return tuple(out)

    def _cell_instance(self, itg, cells):
        from .forms.dsl import extract_coefficients, extract_qfields
        cells = np.asarray(cells, dtype=np.int32)
        if cells.size == 0:
            return None
        mesh = self.mesh
        kernel = compile_integral(itg, mesh.cell_type, mesh.gdim,
                                  runtime=False)
        if extract_qfields(itg.integrand):
            raise ValueError("QuadratureField terms require runtime rules")
        data = dict(
            coords=self._tensor(mesh.cell_vertex_coords[cells]),
            h=self._tensor(mesh.cell_diameters()[cells]),
            coeffs=self._coeff_arrays(extract_coefficients(itg.integrand),
                                      cells),
        )
        return IntegralInstance(kernel, "cell", False, cells, data=data,
                                rows_cells=cells)

    def _runtime_cell_instance(self, itg, rules):
        from .forms.dsl import extract_coefficients, extract_qfields
        mesh = self.mesh
        parents = np.asarray(rules.parent_map, dtype=np.int32)
        if parents.size == 0:
            return None
        kernel = compile_integral(itg, mesh.cell_type, mesh.gdim,
                                  runtime=True)
        data = dict(
            coords=self._tensor(mesh.cell_vertex_coords[parents]),
            h=self._tensor(mesh.cell_diameters()[parents]),
            points=rules.points_padded.to(device=self.device,
                                          dtype=self.dtype),
            weights=rules.weights_padded.to(device=self.device,
                                            dtype=self.dtype),
            coeffs=self._coeff_arrays(extract_coefficients(itg.integrand),
                                      parents),
            qfields=self._qfield_arrays(extract_qfields(itg.integrand),
                                        rules),
        )
        return IntegralInstance(kernel, "cell", True, parents, rules=rules,
                                data=data, rows_cells=parents)

    def _exterior_facet_instance(self, itg, facets):
        from .forms.dsl import extract_coefficients
        facets = np.asarray(facets, dtype=np.int32)
        if facets.size == 0:
            return None
        mesh = self.mesh
        cells = mesh.facet_cells[facets, 0]
        local = mesh.facet_local_index[facets, 0]
        kernel = compile_integral(itg, mesh.cell_type, mesh.gdim,
                                  runtime=False)
        data = dict(
            coords=self._tensor(mesh.cell_vertex_coords[cells]),
            h=self._tensor(mesh.cell_diameters()[cells]),
            local_facet=self._tensor(local, torch.int64),
            coeffs=self._coeff_arrays(extract_coefficients(itg.integrand),
                                      cells),
        )
        return IntegralInstance(kernel, "exterior_facet", False, facets,
                                data=data, rows_cells=cells)

    def _runtime_facet_instance(self, itg, rules):
        """Runtime ds: facet-hosted rules, each in its facet's first
        cell."""
        from .forms.dsl import extract_coefficients, extract_qfields
        mesh = self.mesh
        parents = np.asarray(rules.parent_map, dtype=np.int32)
        if parents.size == 0:
            return None
        if rules.local_facets is None:
            raise ValueError("runtime ds integrals take facet-hosted rules")
        cells = np.asarray(rules.parent_cells, dtype=np.int32)
        kernel = compile_integral(itg, mesh.cell_type, mesh.gdim,
                                  runtime=True)
        data = dict(
            coords=self._tensor(mesh.cell_vertex_coords[cells]),
            h=self._tensor(mesh.cell_diameters()[cells]),
            points=rules.points_padded.to(device=self.device,
                                          dtype=self.dtype),
            weights=rules.weights_padded.to(device=self.device,
                                            dtype=self.dtype),
            local_facet=self._tensor(np.asarray(rules.local_facets),
                                     torch.int64),
            coeffs=self._coeff_arrays(extract_coefficients(itg.integrand),
                                      cells),
            qfields=self._qfield_arrays(extract_qfields(itg.integrand),
                                        rules),
        )
        return IntegralInstance(kernel, "exterior_facet", True, parents,
                                rules=rules, data=data, rows_cells=cells)

    def _runtime_interior_facet_instance(self, itg, rules):
        """Runtime dS: per-facet cut rules on interior facets, the points
        in the '+' cell's reference coords (the kernel pulls them back
        into the '-' cell)."""
        from .forms.dsl import extract_coefficients, extract_qfields
        mesh = self.mesh
        facets = np.asarray(rules.parent_map, dtype=np.int32)
        if facets.size == 0:
            return None
        if rules.local_facets is None:
            raise ValueError("runtime dS integrals take facet-hosted rules")
        cells = mesh.facet_cells[facets]           # (E, 2)
        if (cells[:, 1] < 0).any():
            raise ValueError("runtime dS rules include boundary facets")
        kernel = compile_integral(itg, mesh.cell_type, mesh.gdim,
                                  runtime=True)
        data = dict(
            coords=self._tensor(mesh.cell_vertex_coords[cells]),
            h=self._tensor(mesh.cell_diameters()[cells]),
            points=rules.points_padded.to(device=self.device,
                                          dtype=self.dtype),
            weights=rules.weights_padded.to(device=self.device,
                                            dtype=self.dtype),
            local_facet=self._tensor(mesh.facet_local_index[facets],
                                     torch.int64),
            coeffs=self._coeff_arrays(extract_coefficients(itg.integrand),
                                      cells),
            qfields=self._qfield_arrays(extract_qfields(itg.integrand),
                                        rules, two_sided=True),
        )
        return IntegralInstance(kernel, "interior_facet", True, facets,
                                rules=rules, data=data, rows_cells=cells)

    def _interior_facet_instance(self, itg, facets):
        facets = np.asarray(facets, dtype=np.int32)
        if facets.size == 0:
            return None
        mesh = self.mesh
        cells = mesh.facet_cells[facets]          # (E, 2)
        if (cells[:, 1] < 0).any():
            raise ValueError("interior-facet integral over boundary facets")
        local = mesh.facet_local_index[facets]    # (E, 2)
        from .forms.dsl import extract_coefficients
        kernel = compile_integral(itg, mesh.cell_type, mesh.gdim,
                                  runtime=False)
        data = dict(
            coords=self._tensor(mesh.cell_vertex_coords[cells]),
            h=self._tensor(mesh.cell_diameters()[cells]),
            local_facet=self._tensor(local, torch.int64),
            coeffs=self._coeff_arrays(extract_coefficients(itg.integrand),
                                      cells),
        )
        return IntegralInstance(kernel, "interior_facet", False, facets,
                                data=data, rows_cells=cells)

    # -- dof rows -----------------------------------------------------------

    def _entity_dofs(self, space, inst):
        """Global blocked dofs receiving contributions: (E, nd*bs[*2])."""
        bd = space.blocked_dofmap
        cells = inst.rows_cells
        if cells.ndim == 1:
            return bd[cells]
        g = bd[cells]                            # (E, 2, nd*bs)
        return g.reshape(g.shape[0], -1)


class DirichletBC:
    """Strong Dirichlet condition: blocked dofs of ``V`` and their
    prescribed values, both host numpy (the elimination runs on the host
    CSR matrix). ``value`` is a Function of ``V``, a Constant (one value,
    or one per component of a ``bs``-vector space), a ConstantExpr or
    constant, a scalar, one value per dof, or one value per component of
    a ``bs``-vector space."""

    def __init__(self, value, dofs, V):
        from .forms.dsl import ConstantExpr
        from .functionspace import Constant, Function
        self.function_space = V
        self.dofs = np.asarray(dofs, dtype=np.int64).ravel()
        if isinstance(value, Function):
            self.values = value.x.detach().cpu().numpy()[self.dofs]
            return
        if isinstance(value, Constant):
            v = value.value.detach().cpu().numpy()
            if v.size == V.bs and V.bs > 1:
                v = v.ravel()[self.dofs % V.bs]
            self.values = np.broadcast_to(v, self.dofs.shape).astype(float)
            return
        if isinstance(value, ConstantExpr):
            value = value.value
        if isinstance(value, torch.Tensor):
            value = value.detach().cpu().numpy()
        v = np.asarray(value, dtype=float)
        if v.ndim == 0:
            self.values = np.full(len(self.dofs), float(v))
        elif v.shape == self.dofs.shape:
            self.values = v
        elif v.size == V.bs:
            self.values = v.ravel()[self.dofs % V.bs]
        else:
            raise ValueError("cannot broadcast bc value")


def dirichletbc(value, dofs, V):
    return DirichletBC(value, dofs, V)


def _blocked(V, scalar_dofs):
    """Blocked dofs of every component of the given scalar dofs."""
    scalar_dofs = np.asarray(scalar_dofs, np.int64)
    if V.bs == 1:
        return scalar_dofs
    return (scalar_dofs[:, None] * V.bs + np.arange(V.bs)).ravel()


def locate_dofs_geometrical(V, marker):
    """Blocked dofs whose coordinates satisfy ``marker(x)``, x of shape
    (gdim, N)."""
    hits = np.flatnonzero(np.asarray(marker(V.dof_coordinates.T)))
    return _blocked(V, hits)


def locate_dofs_topological(V, dim, entities):
    """Blocked dofs on the closure of the given facets or cells."""
    from .cut.classify import entity_closure_dofs
    return _blocked(V, np.unique(
        entity_closure_dofs(V, dim, entities).ravel()))


def set_bc(b, bcs, scale=1.0):
    """b[bc dofs] = scale * g. A numpy ``b`` is written in place; a tensor
    (on any device) comes back as a new one."""
    if isinstance(b, np.ndarray):
        for bc in bcs:
            b[bc.dofs] = scale * bc.values
        return b
    for bc in bcs:
        b = b.index_put(
            (torch.as_tensor(bc.dofs, device=b.device),),
            torch.as_tensor(scale * bc.values, dtype=b.dtype,
                            device=b.device))
    return b


def apply_lifting(b, a_forms, bcs_lists, scale=1.0):
    """b - scale * A g for each (form, bcs) pair, g the values of the bcs
    on the form's trial space (others are skipped, as assemble_matrix
    skips them). The matrices are assembled (host CSR) and the product
    taken on the host; the result comes back as ``b`` came: a new numpy
    array, or a tensor of ``b``'s dtype on ``b``'s device."""
    is_tensor = isinstance(b, torch.Tensor)
    out = np.array(b.detach().cpu().numpy() if is_tensor else b)
    for a, bcs in zip(a_forms, bcs_lists):
        U = a.trial_space
        for bc in bcs:
            _check_bc_space(bc.function_space, (U,))
        bcs = [bc for bc in bcs if bc.function_space is U]
        if not bcs:
            continue
        g = np.zeros(U.dim)
        for bc in bcs:
            g[bc.dofs] = bc.values
        out -= scale * (assemble_matrix(a).to_scipy() @ g)
    if is_tensor:
        return torch.as_tensor(out, dtype=b.dtype, device=b.device)
    return out


def form(form_expr, dtype=None, device="cuda"):
    """Compile a form expression. ``device`` is used only by a form whose
    data names no device (no argument, coefficient or runtime rule). A
    mixed-space form (arguments from TrialFunctions/TestFunctions of a
    MixedFunctionSpace) compiles into a MixedCutForm, whose assembly gives
    the block-composed matrix and vector."""
    if not isinstance(form_expr, FormExpr):
        raise TypeError("form() expects expr * measure (a FormExpr)")
    with span("forms.compile"):
        if any(part is not None for _, part in _arguments(form_expr)):
            return MixedCutForm(form_expr, dtype=dtype, device=device)
        return CutForm(form_expr, dtype=dtype, device=device)


cut_form = form


def _arguments(form_expr):
    """{(number, part): Argument} over every integral of a form."""
    keys = {}
    for itg in form_expr.integrals:
        keys.update(extract_arguments(itg.integrand))
    return keys


class MixedCutForm:
    """Monolithic view of a mixed-space form: block CutForms plus the
    concatenated dof layout [part0 | part1 | ...]. Every block lives on
    one device (``self.device``) in one dtype."""

    def __init__(self, form_expr, dtype=None, device="cuda"):
        keys = _arguments(form_expr)
        if any(part is None for (_, part) in keys):
            raise ValueError(
                "mixed forms must build every argument from a "
                "MixedFunctionSpace (no part-less arguments)")
        self.rank = len({num for (num, _) in keys})

        def layout(num):
            args = [a for k, a in keys.items() if k[0] == num]
            if not args:
                return []
            W = next((a.mixed for a in args if a.mixed is not None), None)
            if W is not None:
                return list(W.spaces)
            parts = sorted(k[1] for k in keys if k[0] == num)
            return [keys[(num, p)].space for p in parts]

        self.test_spaces = layout(0)
        self.trial_spaces = layout(1) if self.rank == 2 else []

        def make(block):
            f = CutForm(form_expr, dtype=dtype, block=block, device=device)
            return f if f.instances else None

        nt = len(self.test_spaces)
        if self.rank == 1:
            self.blocks = tuple(
                make((i, None)) if (0, i) in keys else None
                for i in range(nt))
        else:
            nu = len(self.trial_spaces)
            self.blocks = tuple(tuple(
                make((i, j)) if ((0, i) in keys and (1, j) in keys)
                else None for j in range(nu)) for i in range(nt))
        self.test_offsets = block_offsets(self.test_spaces).astype(np.int64)
        self.trial_offsets = block_offsets(self.trial_spaces).astype(
            np.int64) if self.rank == 2 else None
        present = [b for b in _flat(self.blocks) if b is not None]
        if not present:
            raise ValueError("mixed form has no block with integrals")
        devices = {b.device for b in present}
        if len(devices) > 1:
            raise ValueError(f"mixed form blocks on several devices: "
                             f"{devices}")
        self.dtype = present[0].dtype
        self.mesh = present[0].mesh
        self.device = present[0].device

    @property
    def dim(self):
        return int(self.test_offsets[-1])


def _flat(blocks):
    for b in blocks:
        if isinstance(b, tuple):
            yield from _flat(b)
        else:
            yield b


def derivative(residual_expr, u, du=None):
    """Gateaux derivative of a residual form F(u; v) with respect to the
    Function ``u`` in direction ``du`` (a TrialFunction of u's space by
    default): u -> u + du, so the AD kernel's argument Jacobian at zero
    trial coefficients is the exact Newton Jacobian at u's current
    state."""
    from .forms.dsl import CoefficientExpr, Sum, TrialFunction, replace
    from .forms.measure import Integral
    if du is None:
        du = TrialFunction(u.function_space)
    cexpr = CoefficientExpr(u)
    return FormExpr([Integral(replace(itg.integrand,
                                      {cexpr: Sum(CoefficientExpr(u), du)}),
                              itg.measure)
                     for itg in residual_expr.integrals])


def newton_solve(residual_expr, u, bcs=None, tol=1e-10, max_iter=20,
                 report=False):
    """Newton's method on a nonlinear residual form F(u; v) = 0 with the
    AD-exact Jacobian, in u's dtype. Residual and Jacobian are assembled on
    u's device; the Jacobian's CSR matrix, its boundary conditions and the
    direct solve run on the host. ``u.x`` is updated in place and stays a
    tensor on its device. Returns (u, iterations, |F| history)."""
    from .la import direct_solve
    bc_dofs = np.concatenate([bc.dofs for bc in bcs]) if bcs else None
    hist = []
    for it in range(max_iter):
        b = assemble_vector(form(residual_expr, dtype=u.x.dtype))
        if bcs:
            b = _zero_entries(b, bc_dofs)
        norm = float(torch.linalg.norm(b))
        hist.append(norm)
        if report:
            print(f"newton it {it}: |F| = {norm:.3e}")
        if norm < tol:
            break
        A = assemble_matrix(form(derivative(residual_expr, u),
                                 dtype=u.x.dtype), bcs=bcs)
        u.x = u.x - direct_solve(A, b)
    return u, len(hist), hist


def extract_blocks(form_expr, dtype=None):
    """Split a mixed-space form into per-block CutForms (the role of
    ufl.extract_blocks). Returns a nested tuple for rank-2 forms, a flat
    tuple for rank-1 forms; entries are None when a block has no
    contribution."""
    keys = _arguments(form_expr)
    test_parts = sorted({p for (num, p) in keys if num == 0},
                        key=lambda p: -1 if p is None else p)
    trial_parts = sorted({p for (num, p) in keys if num == 1},
                         key=lambda p: -1 if p is None else p)

    def make(block):
        f = CutForm(form_expr, dtype=dtype, block=block)
        return f if f.instances else None

    if not trial_parts:
        return tuple(make((tp, None)) for tp in test_parts)
    return tuple(tuple(make((tp, up)) for up in trial_parts)
                 for tp in test_parts)


# -- assembly ---------------------------------------------------------------


def assemble_scalar(f: CutForm):
    """The value of a rank-0 form: a 0-d tensor on the form's device."""
    if f.rank != 0:
        raise ValueError("assemble_scalar requires a rank-0 form")
    total = torch.zeros((), dtype=f.dtype, device=f.device)
    for inst in f.instances:
        total = total + inst.kernel.assemble_scalar(inst.data, f.dtype)
    return total


def assemble_vector(f):
    """The vector of a rank-1 form on the form's device: one segment sum
    over row-sorted element contributions. A MixedCutForm gives the
    concatenation of its parts (zeros where a part has no integral)."""
    if isinstance(f, MixedCutForm):
        if f.rank != 1:
            raise ValueError("assemble_vector requires a rank-1 form")
        return torch.cat([
            assemble_vector(b) if b is not None
            else torch.zeros(sp.dim, dtype=f.dtype, device=f.device)
            for b, sp in zip(f.blocks, f.test_spaces)])
    if f.rank != 1:
        raise ValueError("assemble_vector requires a rank-1 form")
    with span("forms.assemble_vector"):
        V = f.test_space
        parts, rows_list = [], []
        for inst in f.instances:
            be = inst.kernel.assemble_vector(inst.data, f.dtype, f.block)
            parts.append(be.reshape(-1))
            rows_list.append(np.asarray(f._entity_dofs(V, inst)).ravel())
        if not parts:
            return torch.zeros(V.dim, dtype=f.dtype, device=f.device)
        perm, lengths = sorted_scatter_plan(np.concatenate(rows_list),
                                            V.dim, f.device)
        return segment_sum_sorted(torch.cat(parts)[perm], lengths)


def assemble_matrix(f, bcs=None, extension_terms=None):
    """Assemble a rank-2 form into a host CSR matrix (the oracle and
    direct-solve path; the device path is CutOperator). The element
    matrices are computed on the form's device; the COO -> CSR step runs
    on the host with SciPy, as in the reference. A MixedCutForm gives the
    block-composed matrix.

    With ``bcs``, the rows of the dofs constrained on the test space and
    the columns of those constrained on the trial space are zeroed on the
    CSR data, and a form whose test and trial space are one space gets a
    unit diagonal there (pair with apply_lifting + set_bc). A condition on
    another space (by identity) leaves the form alone, as in DOLFINx, so
    one list of conditions serves every block of a mixed system. Two
    equal but distinct space objects raise ValueError: which rule they
    want cannot be told.

    ``extension_terms`` (an ``extensions.ExtensionPenaltyTerm`` or a list
    of them) adds the aggregation extension penalties before the
    conditions are eliminated."""
    if isinstance(f, MixedCutForm):
        if bcs or extension_terms:
            raise NotImplementedError(
                "bcs/extension_terms with monolithic mixed forms: apply "
                "them per block via extract_blocks")
        if f.rank != 2:
            raise ValueError("assemble_matrix requires a rank-2 form")
        return assemble_matrix_block(
            f.blocks, f.test_spaces, f.trial_spaces)
    if f.rank != 2:
        raise ValueError("assemble_matrix requires a rank-2 form")
    V, U = f.test_space, f.trial_space
    rows_all, cols_all, vals_all = [], [], []
    for inst in f.instances:
        Ae = inst.kernel.assemble_matrix(inst.data, f.dtype, f.block)
        Ae = Ae.cpu().numpy()
        r = f._entity_dofs(V, inst)              # (E, nv)
        c = f._entity_dofs(U, inst)              # (E, nu)
        E, nv = r.shape
        nu = c.shape[1]
        rows_all.append(np.broadcast_to(r[:, :, None], (E, nv, nu)).ravel())
        cols_all.append(np.broadcast_to(c[:, None, :], (E, nv, nu)).ravel())
        vals_all.append(Ae.ravel())
    if not rows_all:
        A = MatrixCSR.from_coo([], [], [], (V.dim, U.dim))
    else:
        A = MatrixCSR.from_coo(np.concatenate(rows_all),
                               np.concatenate(cols_all),
                               np.concatenate(vals_all), (V.dim, U.dim))
    if extension_terms:
        from .extensions import assemble_extension_penalty
        for term in _as_list(extension_terms):
            assemble_extension_penalty(A, term)
    if bcs:
        _eliminate_bcs(A, bcs, V, U)
    return A


def _as_list(terms):
    return list(terms) if isinstance(terms, (list, tuple)) else [terms]


def _equal_spaces(a, b):
    """Two distinct space objects that no assembly can tell apart: one
    mesh object, one element, one block size and dimension."""
    return (a is not b and a.mesh is b.mesh and a.family == b.family
            and a.degree == b.degree and a.bs == b.bs and a.dim == b.dim)


def _check_bc_space(bc_space, spaces):
    """Conditions are matched to a form's spaces by identity. A condition
    whose space equals one of them without being it is ambiguous: it may
    mean a diagonal block (rows and columns eliminated, unit diagonal) or
    an off-diagonal block of two equal fields (rows only, as DOLFINx
    does). Raise instead of guessing."""
    if any(_equal_spaces(bc_space, sp) for sp in spaces):
        raise ValueError(
            "a Dirichlet condition's space equals the form's test or trial "
            "space but is another object: a square (diagonal) form must "
            "take one space object for its test and trial functions and "
            "its conditions")


def _eliminate_bcs(A, bcs, V, U):
    """Zero the rows of the bcs on V and the columns of those on U (on the
    CSR data: a lil fancy assignment would materialise dense blocks), then
    a unit diagonal on the constrained rows when V is U. A square form
    over two equal space objects raises (see _check_bc_space)."""
    import scipy.sparse as sps

    if _equal_spaces(V, U):
        raise ValueError(
            "assemble_matrix(bcs=...) on a form whose test and trial spaces "
            "are two equal space objects: a square (diagonal) form must "
            "take one space object for its test and trial functions")
    for bc in bcs:
        _check_bc_space(bc.function_space, (V, U))

    def dofs_on(space):
        d = [bc.dofs for bc in bcs if bc.function_space is space]
        return np.unique(np.concatenate(d)) if d else np.zeros(0, np.int64)

    rows, cols = dofs_on(V), dofs_on(U)
    if rows.size == 0 and cols.size == 0:
        return
    m = A.to_scipy().tocsr()
    sel_r = np.zeros(m.shape[0], bool)
    sel_r[rows] = True
    sel_c = np.zeros(m.shape[1], bool)
    sel_c[cols] = True
    row_ids = np.repeat(np.arange(m.shape[0]), np.diff(m.indptr))
    m.data[sel_r[row_ids] | sel_c[m.indices]] = 0.0
    m.eliminate_zeros()
    if V is U:
        m = (m + sps.coo_matrix((np.ones(len(rows)), (rows, rows)),
                                shape=m.shape)).tocsr()
    A._m = m


def assemble_matrix_block(a_blocks, spaces=None, trial_spaces=None):
    """One monolithic host CSR matrix from a nested block layout whose
    entries are CutForms, MatrixCSRs or None (the role of the reference's
    PETSc nest-matrix path). ``spaces`` gives the block rows' spaces (and
    the columns', unless ``trial_spaces`` does) where a whole row is
    None."""
    import scipy.sparse as sps
    if spaces is None:
        spaces = [next(blk.test_space for blk in row if blk is not None)
                  for row in a_blocks]
    dims = [sp.dim for sp in spaces]
    cdims = [sp.dim for sp in trial_spaces] if trial_spaces else dims
    grid = []
    for i, row in enumerate(a_blocks):
        out_row = []
        for j, blk in enumerate(row):
            if blk is None:
                out_row.append(sps.csr_matrix((dims[i], cdims[j])))
            elif isinstance(blk, MatrixCSR):
                out_row.append(blk.to_scipy().tocsr())
            else:
                out_row.append(assemble_matrix(blk).to_scipy().tocsr())
        grid.append(out_row)
    return MatrixCSR(sps.bmat(grid, format="csr"))


def assemble_vector_block(L_blocks, spaces):
    """The concatenated vector of rank-1 blocks (None -> zeros), a tensor
    on the forms' device."""
    present = [blk for blk in L_blocks if blk is not None]
    dtype = present[0].dtype if present else torch.get_default_dtype()
    device = present[0].device if present else spaces[0].device
    return torch.cat([
        assemble_vector(blk) if blk is not None
        else torch.zeros(sp.dim, dtype=dtype, device=device)
        for blk, sp in zip(L_blocks, spaces)])


def create_sparsity_pattern(f: CutForm, extension_terms=None):
    """Sparsity of a rank-2 form as a SciPy CSR structure matrix (int8
    ones) with the deactivation diagonal included. ``extension_terms``
    adds the (bad, root) dof pair blocks of each penalty term."""
    if f.rank != 2:
        raise ValueError("create_sparsity_pattern requires a rank-2 form")
    import scipy.sparse as sps
    V, U = f.test_space, f.trial_space
    rows, cols = [], []
    for inst in f.instances:
        r = f._entity_dofs(V, inst)
        c = f._entity_dofs(U, inst)
        E, nv = r.shape
        nu = c.shape[1]
        rows.append(np.broadcast_to(r[:, :, None], (E, nv, nu)).ravel())
        cols.append(np.broadcast_to(c[:, None, :], (E, nv, nu)).ravel())
    if V.dim == U.dim:
        diag = np.arange(V.dim)
        rows.append(diag)
        cols.append(diag)
    if extension_terms:
        from .extensions import _penalty_dofs, extension_quadrature
        for term in _as_list(extension_terms):
            eq = extension_quadrature(term.V, term.cut_data,
                                      term.aggregation,
                                      term.quadrature_degree)
            dofs = _penalty_dofs(term.V, eq)
            nb, nd2 = dofs.shape
            rows.append(np.broadcast_to(dofs[:, :, None],
                                        (nb, nd2, nd2)).ravel())
            cols.append(np.broadcast_to(dofs[:, None, :],
                                        (nb, nd2, nd2)).ravel())
    data = np.ones(sum(len(r) for r in rows), np.int8)
    m = sps.coo_matrix((data, (np.concatenate(rows),
                               np.concatenate(cols))),
                       shape=(V.dim, U.dim)).tocsr()
    m.data[:] = 1
    return m


def insert_diagonal(A: MatrixCSR, rows, value=1.0):
    """Set ``value`` on the diagonal of the given rows, on the CSR data:
    the rows' stored diagonal entries are zeroed, then a COO diagonal is
    added."""
    import scipy.sparse as sps
    rows = np.asarray(rows, dtype=np.int64)
    if rows.size == 0:
        return A
    m = A.to_scipy().tocsr()
    mask = np.zeros(m.shape[0], dtype=bool)
    mask[rows] = True
    coo = m.tocoo()
    m.data[mask[coo.row] & (coo.row == coo.col)] = 0.0
    add = sps.coo_matrix((np.full(rows.size, value, dtype=m.dtype),
                          (rows, rows)), shape=m.shape)
    A._m = (m + add.tocsr()).tocsr()
    return A


def create_matrix(f: CutForm, extension_terms=None):
    """A zero host CSR matrix of the form's shape (the sparsity is
    implicit in the COO assembly, extension terms' included)."""
    import scipy.sparse as sps
    return MatrixCSR(sps.csr_matrix((f.test_space.dim, f.trial_space.dim)))


def block_offsets(spaces):
    """Cumulative dof offsets of a block layout."""
    dims = [0] + [sp.dim for sp in spaces]
    return np.cumsum(dims)


# -- active domain ------------------------------------------------------------


@dataclass
class ActiveDomain:
    """Active-cell/dof bookkeeping (the reference's ActiveDomain)."""
    function_space: object
    active_cells: np.ndarray
    inactive_dofs: np.ndarray

    @property
    def active_mask(self):
        m = np.ones(self.function_space.dim, dtype=bool)
        m[self.inactive_dofs] = False
        return m


@dataclass
class MixedActiveDomain:
    """Per-part active domains with monolithic offsets."""
    domains: list
    offsets: np.ndarray

    @property
    def inactive_dofs(self):
        return np.concatenate([
            d.inactive_dofs + off
            for d, off in zip(self.domains, self.offsets[:-1])])

    @property
    def active_mask(self):
        return np.concatenate([d.active_mask for d in self.domains])

    def sub(self, i):
        return self.domains[i]


def active_domain(f, space=None):
    """Collect cells from all integral domains and mark dofs untouched by
    any of them as inactive. A MixedCutForm gives a MixedActiveDomain: each
    part's domain from its diagonal block (else the first block of its
    row), with monolithic offsets."""
    if isinstance(f, MixedCutForm):
        doms = []
        rows = f.blocks if f.rank == 2 else [(b,) for b in f.blocks]
        for i, row in enumerate(rows):
            if f.rank == 2 and i < len(row) and row[i] is not None:
                blk = row[i]
            else:
                blk = next((b for b in row if b is not None), None)
            sp = f.test_spaces[i]
            if blk is None:
                doms.append(ActiveDomain(
                    sp, np.zeros(0, np.int32),
                    np.arange(sp.dim, dtype=np.int32)))
            else:
                doms.append(active_domain(blk, space=sp))
        return MixedActiveDomain(doms, f.test_offsets)
    V = space or f.test_space or f.trial_space
    if V is None:
        raise ValueError("active_domain requires a form with arguments")
    with span("forms.active_domain"):
        cells = [inst.rows_cells.ravel() for inst in f.instances]
        if cells:
            active_cells = np.unique(np.concatenate(cells)).astype(np.int32)
        else:
            active_cells = np.zeros(0, np.int32)
        touched = np.zeros(V.dim, dtype=bool)
        touched[V.blocked_dofmap[active_cells].ravel()] = True
        inactive = np.flatnonzero(~touched).astype(np.int32)
        return ActiveDomain(V, active_cells, inactive)


def _zero_entries(b, rows):
    """``b`` with ``rows`` set to 0, as what came in: a numpy array is
    written in place, a tensor (on any device) comes back as a new one."""
    if isinstance(b, np.ndarray):
        b[rows] = 0.0
        return b
    idx = torch.as_tensor(np.asarray(rows, np.int64), device=b.device)
    return b.index_fill(0, idx, 0.0)


def deactivate_outside(A, b, domain, diag=1.0):
    """Unit-diagonal the inactive rows of a host CSR matrix and zero the
    right-hand side there (an ActiveDomain, or a MixedActiveDomain for the
    monolithic system). Returns (A, b)."""
    rows = domain.inactive_dofs
    if isinstance(A, MatrixCSR):
        A.zero_rows(rows, diag=diag)
    if b is not None:
        b = _zero_entries(b, rows)
    return A, b


def zero_rows(A: MatrixCSR, rows=None, diag=1.0, *, tol=0.0):
    """Two reference-compatible behaviours:

    - ``zero_rows(A, rows)``: zero the given rows with ``diag`` on the
      diagonal;
    - ``zero_rows(A, tol=...)`` with no rows: RETURN the indices of rows
      whose entries are all <= tol in magnitude (the post-deactivation
      diagnostic)."""
    if rows is None:
        m = A.to_scipy().tocsr()
        sums = np.asarray(abs(m).sum(axis=1)).ravel()
        return np.flatnonzero(sums <= tol).astype(np.int32)
    A.zero_rows(rows, diag=diag)
    return A


def deactivate_outside_blocks(A_blocks, domains, b_blocks=None, diag=1.0):
    """Block variant: zero inactive rows in the whole block row, unit
    diagonal only in the diagonal block. ``b_blocks`` entries are updated
    in the list, each returned as what came in."""
    for i, dom in enumerate(domains):
        rows = dom.inactive_dofs
        for j, A in enumerate(A_blocks[i]):
            if A is not None:
                A.zero_rows(rows, diag=diag if i == j else 0.0)
        if b_blocks is not None and b_blocks[i] is not None:
            b_blocks[i] = _zero_entries(b_blocks[i], rows)
    return A_blocks, b_blocks


def zero_block_rows(A_blocks):
    """Rows that are identically zero across a block row (the
    post-deactivation sanity check). One index array per block row."""
    out = []
    for row in A_blocks:
        mask = None
        for A in row:
            if A is None:
                continue
            nz = np.asarray(abs(A.to_scipy().tocsr()).sum(axis=1)).ravel()
            mask = nz if mask is None else mask + nz
        out.append(np.flatnonzero(mask == 0.0).astype(np.int32)
                   if mask is not None else np.zeros(0, np.int32))
    return out


def cut_function(u, cut_mesh):
    """Interpolate a background Function onto a cut mesh: a P1 Function on
    ``cut_mesh.mesh`` (on u's device, in u's dtype) whose vertex values
    are u's. Each cut-mesh vertex lies in its cell's parent background
    cell; it is pulled back there (Newton's map on quads and hexahedra)
    and u's basis is evaluated at it."""
    from .cut.api import CutMesh
    from .functionspace import Function, FunctionSpace
    from .geometry import pullback

    if not isinstance(cut_mesh, CutMesh) or cut_mesh.mesh is None:
        raise ValueError("cut_function requires a non-empty CutMesh")
    V = u.function_space
    bg = V.mesh
    vis = cut_mesh.mesh
    dt, dev = u.x.dtype, u.x.device
    Vout = FunctionSpace(vis, ("Lagrange", 1), shape=V.value_shape,
                         device=dev)
    out = Function(Vout, name=u.name, dtype=dt)
    # cut-mesh vertices are duplicated per cell, so a plain per-cell
    # evaluation covers every dof
    parents = cut_mesh.parent_index
    vis_coords = torch.as_tensor(vis.cell_vertex_coords, dtype=dt,
                                 device=dev)                # (E, m, gdim)
    par_coords = torch.as_tensor(bg.cell_vertex_coords[parents], dtype=dt,
                                 device=dev)
    ref = torch.func.vmap(lambda c, x: pullback(bg.cell_type, c, x))(
        par_coords, vis_coords)                             # (E, m, tdim)
    tab = V.element.tabulate(ref)                           # (E, m, nd)
    idx = torch.as_tensor(V.dofmap[parents], dtype=torch.int64, device=dev)
    dofs = u.x.reshape(-1, V.bs)[idx]                       # (E, nd, bs)
    vals = torch.einsum("emn,enb->emb", tab, dofs)          # (E, m, bs)
    x = torch.zeros((Vout.num_scalar_dofs, Vout.bs), dtype=dt, device=dev)
    x[torch.as_tensor(Vout.dofmap, dtype=torch.int64, device=dev)] = vals
    out.x = x.reshape(-1)
    return out


# -- element-matrix operators ------------------------------------------------


def _merge_equal_batches(mats, rows, cols):
    """Sum element-matrix batches that address identical (rows, cols)
    (e.g. the runtime-volume and Nitsche-surface instances both run over
    the cut cells): one gather/scatter pass instead of two. mats are
    device tensors; rows/cols host int arrays."""
    out_m, out_r, out_c = [], [], []
    for m, r, c in zip(mats, rows, cols):
        for i, (rm, rr, rc) in enumerate(zip(out_m, out_r, out_c)):
            if rr.shape == r.shape and rc.shape == c.shape and \
                    out_m[i].shape == m.shape and \
                    np.array_equal(rr, r) and np.array_equal(rc, c):
                out_m[i] = rm + m
                break
        else:
            out_m.append(m)
            out_r.append(r)
            out_c.append(c)
    return out_m, out_r, out_c


def _fold_duplicates_device(A, slot, L):
    """A_c[e, a, b] = sum over (i, j) with slot[e,i]=a, slot[e,j]=b of
    A[e, i, j], as two batched one-hot matmuls."""
    S = (slot[:, :, None] == torch.arange(L, device=A.device)).to(A.dtype)
    return torch.einsum("eia,eij,ejb->eab", S, A, S)


def _duplicate_slots(rr):
    """Per-element duplicate-dof slot map (host, small arrays only).

    rr: (E, n) host int array -> (slot (E, n), rows_u (E, L), L) or None
    when nothing compresses. A facet-pair element lists both cells' dofs,
    so the shared-facet dofs appear twice (P2 tet pair: 20 listed, 14
    unique)."""
    E, n = rr.shape
    order = np.argsort(rr, axis=1, kind="stable")
    srt = np.take_along_axis(rr, order, axis=1)
    new = np.ones((E, n), bool)
    new[:, 1:] = srt[:, 1:] != srt[:, :-1]
    slot_sorted = np.cumsum(new, axis=1) - 1
    L = int(slot_sorted.max()) + 1
    if L >= n:
        return None
    slot = np.empty((E, n), np.int64)
    np.put_along_axis(slot, order, slot_sorted, axis=1)
    rows_u = np.zeros((E, L), rr.dtype)
    np.put_along_axis(rows_u, slot, rr, axis=1)
    return slot, rows_u, L


def _build_apply_arrays(mats, rows, cols, itypes):
    """Merged + duplicate-compressed (mats, rows, cols) for the matvec.
    mats: device tensors; rows/cols: host int arrays."""
    cm, cr, cc = [], [], []
    for m, r, c, it in zip(mats, rows, cols, itypes):
        if it == "interior_facet" and r.shape == c.shape and \
                np.array_equal(r, c):
            packed = _duplicate_slots(r)
            if packed is not None:
                slot, rows_u, L = packed
                m = _fold_duplicates_device(
                    m, torch.as_tensor(slot, device=m.device), L)
                r = c = rows_u
        cm.append(m)
        cr.append(r)
        cc.append(c)
    return _merge_equal_batches(cm, cr, cc)


def _matfree_apply_sorted(mats, cols, perm, lengths, active, x):
    """A@x with deactivated dofs passed through identically: per batch one
    gather and one batched (E, n, n) x (E, n) product, then the element
    contributions permuted into row-sorted order and summed per row by one
    segment sum (the presorted scatter plan; no atomics)."""
    xin = torch.where(active, x, 0.0) if active is not None else x
    parts = [torch.einsum("eij,ej->ei", Ae, xin[c]).reshape(-1)
             for Ae, c in zip(mats, cols)]
    flat = torch.cat(parts) if len(parts) > 1 else parts[0]
    y = segment_sum_sorted(flat[perm], lengths)
    if active is not None:
        y = torch.where(active, y, x)
    return y


def _matfree_diagonal(mats, rows, cols, perm, lengths, active):
    """Operator diagonal through the apply's scatter plan. Each element
    sums every (i, j) entry whose row and column map to the same dof,
    which covers any remaining duplicate-dof elements."""
    parts = [torch.where(r[:, :, None] == c[:, None, :], Ae, 0.0)
             .sum(dim=2).reshape(-1)
             for Ae, r, c in zip(mats, rows, cols)]
    flat = torch.cat(parts) if len(parts) > 1 else parts[0]
    d = segment_sum_sorted(flat[perm], lengths)
    if active is not None:
        d = torch.where(active, d, 1.0)
    return d


class CutOperator:
    """Matrix-free operator for a rank-2 form: element matrices on the
    form's device and their gather/product/scatter action, with the
    inactive dofs passed through identically.

    ``apply_plan=False`` keeps the per-instance element matrices and dof
    maps only (what ``StencilCutOperator`` builds its element path from);
    ``__call__``, ``diagonal`` and ``solve_cg`` then raise."""

    def __init__(self, f: CutForm, domain: ActiveDomain | None = None,
                 apply_plan: bool = True):
        if f.rank != 2:
            raise ValueError("CutOperator requires a rank-2 form")
        if not f.instances:
            raise ValueError(
                "CutOperator: form produced no integral instances (every "
                "measure had an empty entity set); nothing to apply")
        self.form = f
        self.device = f.device
        V, U = f.test_space, f.trial_space
        if V.dim != U.dim:
            raise ValueError("matrix-free operator requires square forms")
        self.dim = V.dim
        self.element_matrices = []
        self._rows_host = []
        self._cols_host = []
        self._itypes = []
        for inst in f.instances:
            self.element_matrices.append(
                inst.kernel.assemble_matrix(inst.data, f.dtype, f.block))
            self._rows_host.append(np.asarray(f._entity_dofs(V, inst)))
            self._cols_host.append(np.asarray(f._entity_dofs(U, inst)))
            self._itypes.append(inst.itype)
        self.active = (torch.as_tensor(domain.active_mask, device=f.device)
                       if domain is not None else None)
        self._has_plan = bool(apply_plan)
        if not apply_plan:
            return
        # merged + duplicate-compressed copies of the per-instance data:
        # the apply is gather-bound, so every dropped row element counts
        mats, rows, cols = _build_apply_arrays(
            self.element_matrices, list(self._rows_host),
            list(self._cols_host), self._itypes)

        def ints(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=f.device)

        self._mats = tuple(mats)
        self._rows = tuple(ints(r) for r in rows)
        self._cols = tuple(ints(c) for c in cols)
        self._perm, self._lengths = sorted_scatter_plan(
            np.concatenate([np.asarray(r).ravel() for r in rows]),
            self.dim, f.device)

    def _require_plan(self):
        if not self._has_plan:
            raise RuntimeError(
                "CutOperator was built with apply_plan=False (element "
                "data only); rebuild with apply_plan=True to apply it")

    def _vector(self, x):
        """``x`` as a tensor of the form's dtype on the operator's device:
        numpy input is copied there, a tensor on another device refused."""
        if isinstance(x, torch.Tensor) and x.device != self.device:
            raise ValueError(f"vector on {x.device}, operator on "
                             f"{self.device}")
        return torch.as_tensor(x, dtype=self.form.dtype, device=self.device)

    def __call__(self, x):
        self._require_plan()
        return _matfree_apply_sorted(self._mats, self._cols, self._perm,
                                     self._lengths, self.active,
                                     self._vector(x))

    def diagonal(self):
        self._require_plan()
        return _matfree_diagonal(self._mats, self._rows, self._cols,
                                 self._perm, self._lengths, self.active)

    def solve_cg(self, b, rtol=1e-8, maxiter=500, jacobi=True,
                 precond=None):
        """Preconditioned CG on the active dofs; returns (x, iterations,
        residual_norm). precond: 'jacobi' (default), 'chebyshev' (a
        degree-4 polynomial of the Jacobi-scaled operator) or 'none'."""
        from .la import cg, chebyshev_preconditioner, power_iteration_lmax
        if precond is None:
            precond = "jacobi" if jacobi else "none"
        self._require_plan()
        b = self._vector(b)
        bb = torch.where(self.active, b, 0.0) if self.active is not None \
            else b
        if precond == "jacobi":
            d = self.diagonal()

            def M(r):
                return r / d
        elif precond == "chebyshev":
            d = self.diagonal()
            lmax = power_iteration_lmax(self, d, self.dim)
            M = chebyshev_preconditioner(self, d, lmax, degree=4)
        elif precond == "none":
            M = None
        else:
            raise ValueError(f"unknown precond {precond!r}: 'jacobi', "
                             "'chebyshev' or 'none'")
        return cg(self, bb, M=M, rtol=rtol, maxiter=maxiter)
