"""Runtime form assembly, dof deactivation and matrix-free operators.

The torch counterpart of ``cutfemx_tpu.fem``'s cut-Poisson surface:
``form``/``CutForm`` (rank 0, 1 and 2, per-block forms of a mixed space,
``dx``, ``ds`` and ``dS`` integrals) with its bucket padding,
``extract_blocks``, ``assemble_scalar/vector/matrix``, ``active_domain``,
``deactivate_outside``, ``zero_rows`` and their block variants, and the
element-batched ``CutOperator``. The compiled kernels come from
``forms.compile``; this module decides which entities each integral runs
over (standard vs runtime quadrature) and performs the global scatter.

Element data is computed on the device of the form; ``assemble_matrix``
builds its CSR matrix on the host with SciPy, as the reference does.
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
from .forms.measure import FormExpr, split_subdomain_data
from .la import MatrixCSR

__all__ = ["CutForm", "form", "extract_blocks",
           "assemble_scalar", "assemble_vector", "assemble_matrix",
           "ActiveDomain", "active_domain", "deactivate_outside",
           "deactivate_outside_blocks", "zero_rows", "zero_block_rows",
           "block_offsets", "CutOperator", "segment_sum_sorted"]


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
            if rules is not None:
                raise NotImplementedError(
                    "runtime ds integrals (ROADMAP item 10)")
            facets = mesh.exterior_facets if ents is None else ents
            out.append(self._exterior_facet_instance(itg, facets))
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


def form(form_expr, dtype=None, device="cuda"):
    """Compile a form expression. ``device`` is used only by a form whose
    data names no device (no argument, coefficient or runtime rule). A
    mixed-space form (arguments from TrialFunctions/TestFunctions of a
    MixedFunctionSpace) is split with ``extract_blocks``; its monolithic
    MixedCutForm waits for ROADMAP item 8 (Stokes)."""
    if not isinstance(form_expr, FormExpr):
        raise TypeError("form() expects expr * measure (a FormExpr)")
    for itg in form_expr.integrals:
        if any(part is not None
               for _, part in extract_arguments(itg.integrand)):
            raise NotImplementedError(
                "monolithic mixed-space forms, MixedCutForm (ROADMAP item "
                "8: Stokes); split the form with fem.extract_blocks")
    return CutForm(form_expr, dtype=dtype, device=device)


def extract_blocks(form_expr, dtype=None):
    """Split a mixed-space form into per-block CutForms (the role of
    ufl.extract_blocks). Returns a nested tuple for rank-2 forms, a flat
    tuple for rank-1 forms; entries are None when a block has no
    contribution."""
    keys = {}
    for itg in form_expr.integrals:
        keys.update(extract_arguments(itg.integrand))
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


def assemble_matrix(f: CutForm, bcs=None, extension_terms=None):
    """Assemble a rank-2 form into a host CSR matrix (the oracle and
    direct-solve path; the device path is CutOperator). The element
    matrices are computed on the form's device; the COO -> CSR step runs
    on the host with SciPy, as in the reference."""
    if bcs:
        raise NotImplementedError(
            "assemble_matrix(bcs=...): lifting and strong boundary "
            "conditions (ROADMAP item 9)")
    if extension_terms:
        raise NotImplementedError(
            "assemble_matrix(extension_terms=...): aggregation extensions "
            "(ROADMAP item 10)")
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
        return MatrixCSR.from_coo([], [], [], (V.dim, U.dim))
    return MatrixCSR.from_coo(np.concatenate(rows_all),
                              np.concatenate(cols_all),
                              np.concatenate(vals_all), (V.dim, U.dim))


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


def _zero_entries(b, rows):
    """``b`` with ``rows`` set to 0, as what came in: a numpy array is
    written in place, a tensor (on any device) comes back as a new one."""
    if isinstance(b, np.ndarray):
        b[rows] = 0.0
        return b
    idx = torch.as_tensor(np.asarray(rows, np.int64), device=b.device)
    return b.index_fill(0, idx, 0.0)


def deactivate_outside(A, b, domain: ActiveDomain, diag=1.0):
    """Unit-diagonal the inactive rows of a host CSR matrix and zero the
    right-hand side there. Returns (A, b)."""
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
