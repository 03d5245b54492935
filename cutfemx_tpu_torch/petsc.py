"""Solver-backend layer: the assembly and deactivation surface of the
reference's ``petsc`` module on the host CSR backend (``la.MatrixCSR``),
with nest (block) assembly; when ``petsc4py`` is importable the assembled
operators convert to PETSc matrices so user KSP code keeps working (the
torch counterpart of ``cutfemx_tpu.petsc``).

The device solve path does not need PETSc: matrix-free CG and BiCGStab
on the card (``fem.CutOperator``, ``stencil``, ``la``) are the
performance route. This module is for API parity and for coupling to
external CPU solver stacks. Host vectors come back as numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from . import fem as _fem
from .la import MatrixCSR

__all__ = [
    "assemble_matrix", "assemble_vector", "create_matrix", "create_vector",
    "deactivate_outside", "deactivate_outside_blocks", "zero_rows",
    "zero_block_rows", "apply_lifting", "set_bc",
    "assemble_extension_penalty", "to_petsc",
]


def _have_petsc():
    try:
        import petsc4py  # noqa: F401
        return True
    except ImportError:
        return False


def _is_petsc_mat(A):
    if not _have_petsc():
        return False
    from petsc4py import PETSc
    return isinstance(A, PETSc.Mat)


def _is_petsc_vec(b):
    if not _have_petsc():
        return False
    from petsc4py import PETSc
    return isinstance(b, PETSc.Vec)


def to_petsc(A: MatrixCSR):
    """Convert a host CSR matrix to a PETSc Mat (requires petsc4py)."""
    if not _have_petsc():
        raise RuntimeError(
            "petsc4py is not available in this environment; use the "
            "MatrixCSR/CutOperator paths instead")
    from petsc4py import PETSc
    m = A.to_scipy().tocsr()
    return PETSc.Mat().createAIJ(size=m.shape,
                                 csr=(m.indptr, m.indices, m.data))


def assemble_matrix(form, bcs=None, petsc=False):
    """Assemble; with petsc=True (and petsc4py present) return a PETSc
    Mat, otherwise a MatrixCSR (identical values — upstream CutFEMx's
    test_petsc.py:31 path-equality contract)."""
    A = _fem.assemble_matrix(form, bcs=bcs)
    return to_petsc(A) if petsc else A


def assemble_vector(form):
    """The assembled vector as a host numpy array."""
    return _fem.assemble_vector(form).detach().cpu().numpy().copy()


def create_matrix(form, extension_terms=None):
    return _fem.create_matrix(form, extension_terms)


def create_vector(V, kind=None):
    """Create a solution/rhs vector for a function space (upstream CutFEMx
    petsc.py:167-169). kind="petsc" returns a PETSc Vec; default is a
    NumPy array (the backend-native layout)."""
    if kind == "petsc":
        if not _have_petsc():
            raise RuntimeError("petsc4py is not available")
        from petsc4py import PETSc
        v = PETSc.Vec().createSeq(V.dim)
        v.set(0.0)
        return v
    return np.zeros(V.dim)


def _zero_rows_backend(A, rows, diag):
    """Row surgery on whichever matrix backend A is (CSR-native on the
    MatrixCSR path — fancy lil assignment materializes dense blocks)."""
    if _is_petsc_mat(A):
        A.zeroRows(np.asarray(rows, dtype=np.int32), diag=diag)
    elif isinstance(A, MatrixCSR):
        A.zero_rows(np.asarray(rows), diag=diag)
    else:
        raise TypeError(f"unsupported matrix type {type(A).__name__}")


def _set_vec_rows(b, rows, value):
    if b is None:
        return b
    if _is_petsc_vec(b):
        arr = b.getArray()
        arr[np.asarray(rows)] = value
        return b
    if isinstance(b, np.ndarray):
        b[np.asarray(rows)] = value
        return b
    # a tensor (on any device) comes back as a new one, as fem.set_bc's
    idx = torch.as_tensor(np.asarray(rows, np.int64), device=b.device)
    return b.index_put((idx,), torch.as_tensor(value, dtype=b.dtype,
                                               device=b.device))


def deactivate_outside(A, b_or_domain, domain=None, diagonal=1.0,
                       rhs_value=0.0):
    """Deactivate matrix rows outside a form-derived active domain —
    the solver-backend mirror of fem.deactivate_outside (upstream CutFEMx
    petsc.py:299-330). Two signatures, as upstream:

    - ``deactivate_outside(A, active_domain)``: matrix only;
    - ``deactivate_outside(A, b, active_domain)``: also sets the rhs
      rows to ``rhs_value``.

    Works on MatrixCSR and (when petsc4py is importable) PETSc Mat/Vec.
    Returns the ActiveDomain."""
    if isinstance(b_or_domain, _fem.ActiveDomain):
        if domain is not None:
            raise TypeError(
                "deactivate_outside(A, active_domain) takes no RHS vector")
        dom, b = b_or_domain, None
    else:
        if domain is None:
            raise TypeError(
                "deactivate_outside(A, b, active_domain) requires "
                "active_domain")
        b, dom = b_or_domain, domain
    rows = np.asarray(dom.inactive_dofs)
    _zero_rows_backend(A, rows, diagonal)
    _set_vec_rows(b, rows, rhs_value)
    return dom


def _matrix_block_rows(A_blocks):
    """Nested PETSc Mat (MatNest) or nested sequence -> list of lists
    (upstream CutFEMx petsc.py:332-346)."""
    if _is_petsc_mat(A_blocks):
        try:
            rows, cols = A_blocks.getNestSize()
        except Exception as exc:
            raise TypeError(
                "deactivate_outside_blocks expects a nested matrix or a "
                "nested sequence of matrix blocks") from exc
        return [[A_blocks.getNestSubMatrix(i, j) for j in range(cols)]
                for i in range(rows)]
    return [list(row) for row in A_blocks]


def deactivate_outside_blocks(A_blocks, active_domains, b_blocks=None,
                              diagonal=1.0, rhs_value=0.0):
    """Deactivate block rows from per-row active-domain support: zero the
    inactive rows across the whole block row, keep the unit diagonal only
    in the diagonal block (upstream CutFEMx petsc.py:348-377,
    deactivate.h:420-457). Accepts a nested list of blocks or a PETSc
    MatNest. Returns the domains."""
    domains = list(active_domains)
    mat_blocks = _matrix_block_rows(A_blocks)
    for i, dom in enumerate(domains):
        rows = np.asarray(dom.inactive_dofs)
        for j, blk in enumerate(mat_blocks[i]):
            if blk is None:
                continue
            _zero_rows_backend(blk, rows, diagonal if i == j else 0.0)
        if b_blocks is not None and b_blocks[i] is not None:
            b_blocks[i] = _set_vec_rows(b_blocks[i], rows, rhs_value)
    return domains


def _row_abs_sums(A):
    if _is_petsc_mat(A):
        indptr, indices, data = A.getValuesCSR()
        import scipy.sparse as sps
        m = sps.csr_matrix((data, indices, indptr),
                           shape=A.getSize())
    else:
        m = A.to_scipy().tocsr()
    return np.asarray(np.abs(m).sum(axis=1)).ravel()


def zero_rows(A, tol=0.0):
    """Indices of rows whose assembled entries are all <= tol in
    magnitude — upstream CutFEMx's post-deactivation diagnostic
    (petsc.py:380-384)."""
    return np.flatnonzero(_row_abs_sums(A) <= tol).astype(np.int32)


def zero_block_rows(A_blocks, tol=0.0):
    """zero_rows per block row of a nested system (petsc.py:387-394):
    a row counts as zero only if it is zero across ALL blocks of that
    block row."""
    out = []
    for row in _matrix_block_rows(A_blocks):
        sums = None
        for blk in row:
            if blk is None:
                continue
            s = _row_abs_sums(blk)
            sums = s if sums is None else sums + s
        out.append(np.flatnonzero(sums <= tol).astype(np.int32)
                   if sums is not None else np.zeros(0, np.int32))
    return out


apply_lifting = _fem.apply_lifting
set_bc = _fem.set_bc


def assemble_extension_penalty(A, V, cut_data, aggregation, beta=None,
                               quadrature_degree=None):
    from .extensions import assemble_extension_penalty as _aep
    return _aep(A, V, cut_data, aggregation, beta, quadrature_degree)


def assemble_matrix_nest(form_expr_or_blocks, petsc=False):
    """Assemble a mixed form into block ("nest") structure: a nested list
    of per-block matrices with None for empty blocks (upstream CutFEMx's
    assemble_matrix_nest, petsc.py:330-344). Accepts a mixed form
    expression, a MixedCutForm, or an extract_blocks grid. With
    petsc=True and petsc4py present, returns a PETSc MatNest."""
    if isinstance(form_expr_or_blocks, _fem.MixedCutForm):
        blocks = form_expr_or_blocks.blocks
    elif isinstance(form_expr_or_blocks, (list, tuple)) and \
            form_expr_or_blocks and isinstance(form_expr_or_blocks[0],
                                               (list, tuple)):
        blocks = form_expr_or_blocks
    else:
        blocks = _fem.extract_blocks(form_expr_or_blocks)
    A = [[_fem.assemble_matrix(blk) if blk is not None else None
          for blk in row] for row in blocks]
    if not petsc:
        return A
    if not _have_petsc():
        raise RuntimeError("petsc4py is not available in this environment")
    from petsc4py import PETSc
    mats = [[to_petsc(blk) if blk is not None else None for blk in row]
            for row in A]
    return PETSc.Mat().createNest(mats)


def assemble_vector_nest(form_expr_or_blocks, spaces=None):
    """Assemble a mixed rank-1 form into per-block vectors (zero-filled
    for absent blocks when the owning spaces are known)."""
    if isinstance(form_expr_or_blocks, _fem.MixedCutForm):
        f = form_expr_or_blocks
        return [assemble_vector(b) if b is not None
                else np.zeros(sp.dim)
                for b, sp in zip(f.blocks, f.test_spaces)]
    blocks = (_fem.extract_blocks(form_expr_or_blocks)
              if not isinstance(form_expr_or_blocks, (list, tuple))
              else form_expr_or_blocks)
    out = []
    for i, b in enumerate(blocks):
        if b is not None:
            out.append(assemble_vector(b))
        elif spaces is not None:
            out.append(np.zeros(spaces[i].dim))
        else:
            out.append(None)
    return out
