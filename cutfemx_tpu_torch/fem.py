"""Runtime form assembly, active domains and element-matrix operators.

The torch counterpart of the parts of ``cutfemx_tpu.fem`` that the
cut-Poisson moving-domain step runs: ``form``/``CutForm`` with its bucket
padding, ``active_domain``, ``assemble_vector`` and the element data of
``CutOperator``. The compiled kernels come from ``forms.compile``; this
module decides which entities each integral runs over (standard vs runtime
quadrature) and performs the global scatter.

Every scatter is a segment sum over row-sorted contributions
(``segment_sum_sorted``), so it sums in the same order on every run; CUDA's
``index_add_`` would sum with atomics in a varying order.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .forms.compile import compile_integral
from .forms.dsl import extract_arguments
from .forms.measure import FormExpr, split_subdomain_data

__all__ = ["CutForm", "form", "assemble_vector", "ActiveDomain",
           "active_domain", "CutOperator", "segment_sum_sorted"]


def segment_sum_sorted(vals, lengths):
    """Sums of consecutive runs of ``vals``: run i has ``lengths[i]``
    entries (zero-length runs sum to 0). One pass in a fixed order, with no
    atomics."""
    return torch.segment_reduce(vals, "sum", lengths=lengths, unsafe=True)


def sorted_scatter_plan(flat_rows, num_segments, device):
    """(perm, lengths) that turn a scatter-add of values at ``flat_rows``
    into ``segment_sum_sorted(vals[perm], lengths)``."""
    flat_rows = np.asarray(flat_rows, np.int64)
    perm = np.argsort(flat_rows, kind="stable")
    lengths = np.bincount(flat_rows, minlength=num_segments)
    return (torch.as_tensor(perm, device=device),
            torch.as_tensor(lengths, device=device))


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

    Data lives on the device of the form's argument spaces, in ``dtype``
    (torch's default float dtype when None)."""

    def __init__(self, form_expr: FormExpr, dtype=None):
        if not isinstance(form_expr, FormExpr):
            raise TypeError("form() expects expr * measure (a FormExpr)")
        self.integrals = form_expr.integrals
        self.arguments = {}
        for itg in self.integrals:
            for key, arg in extract_arguments(itg.integrand).items():
                self.arguments.setdefault(key, arg)
        if any(p is not None for _, p in self.arguments):
            raise NotImplementedError(
                "mixed-space forms (ROADMAP item 8: Stokes)")
        self.rank = len({num for num, _ in self.arguments})
        if self.rank == 0:
            raise NotImplementedError(
                "rank-0 forms (ROADMAP item 9: assemble_scalar)")
        self.block = (None, None)
        self.mesh = self.test_space.mesh
        self.device = self.test_space.device
        self.dtype = dtype if dtype is not None else \
            torch.get_default_dtype()
        self.instances = []
        for i, itg in enumerate(self.integrals):
            for inst in self._build_instances(itg):
                inst.origin = (i, inst.runtime, inst.itype)
                self.instances.append(inst)

    # ------------------------------------------------------------------

    @property
    def test_space(self):
        a = self.arguments.get((0, None))
        return a.space if a is not None else None

    @property
    def trial_space(self):
        a = self.arguments.get((1, None))
        return a.space if a is not None else None

    def _tensor(self, a, dtype=None):
        return torch.as_tensor(a, dtype=dtype or self.dtype,
                               device=self.device)

    # -- instance building --------------------------------------------------

    def _build_instances(self, itg):
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
        elif itype == "interior_facet":
            if rules is not None:
                raise NotImplementedError(
                    "runtime dS integrals (ROADMAP item 10)")
            facets = mesh.interior_facets if ents is None else ents
            out.append(self._interior_facet_instance(itg, facets))
        else:
            raise NotImplementedError(
                f"{itype} integrals (ROADMAP item 9)")
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

    def _qfield_arrays(self, qfields, rules):
        for qf in qfields:
            if getattr(qf, "side_dependent", False):
                raise ValueError(
                    f"{qf.name} is side-aware and requires a runtime dS "
                    "measure")
        return tuple(qf.evaluator(rules).to(device=self.device,
                                            dtype=self.dtype)
                     for qf in qfields)

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


def form(form_expr, dtype=None):
    """Compile a form expression."""
    return CutForm(form_expr, dtype=dtype)


# -- assembly ---------------------------------------------------------------


def assemble_vector(f):
    if f.rank != 1:
        raise ValueError("assemble_vector requires a rank-1 form")
    V = f.test_space
    parts, rows_list = [], []
    for inst in f.instances:
        be = inst.kernel.assemble_vector(inst.data, f.dtype, f.block)
        parts.append(be.reshape(-1))
        rows_list.append(np.asarray(f._entity_dofs(V, inst)).ravel())
    if not parts:
        return torch.zeros(V.dim, dtype=f.dtype, device=f.device)
    perm, lengths = sorted_scatter_plan(np.concatenate(rows_list), V.dim,
                                        f.device)
    return segment_sum_sorted(torch.cat(parts)[perm], lengths)


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


def active_domain(f, space=None):
    """Collect cells from all integral domains and mark dofs untouched by
    any of them as inactive."""
    V = space or f.test_space or f.trial_space
    if V is None:
        raise ValueError("active_domain requires a form with arguments")
    cells = [inst.rows_cells.ravel() for inst in f.instances]
    if cells:
        active_cells = np.unique(np.concatenate(cells)).astype(np.int32)
    else:
        active_cells = np.zeros(0, np.int32)
    touched = np.zeros(V.dim, dtype=bool)
    touched[V.blocked_dofmap[active_cells].ravel()] = True
    inactive = np.flatnonzero(~touched).astype(np.int32)
    return ActiveDomain(V, active_cells, inactive)


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


class CutOperator:
    """Element data of a rank-2 form: per-instance element matrices on the
    form's device with their host row/column dof maps.

    This is what ``StencilCutOperator`` builds its element path from. The
    matrix-free apply of ``cutfemx_tpu.fem.CutOperator`` (its merged
    sorted-scatter plan, ``apply_plan=True``) waits for ROADMAP item 9.
    """

    def __init__(self, f: CutForm, domain: ActiveDomain | None = None,
                 apply_plan: bool = False):
        if apply_plan:
            raise NotImplementedError(
                "the element-batched apply (ROADMAP item 9); the stencil "
                "operator builds from element data only")
        if f.rank != 2:
            raise ValueError("CutOperator requires a rank-2 form")
        if not f.instances:
            raise ValueError(
                "CutOperator: form produced no integral instances (every "
                "measure had an empty entity set); nothing to apply")
        self.form = f
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
