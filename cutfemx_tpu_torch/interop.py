"""Carry state across from the JAX reference package, as numpy arrays.

Nothing here imports JAX: the caller converts the reference's arrays with
``np.asarray`` first. This lets a test hold one stage fixed (the assembly,
say) and compare the next (the apply, the solve) on identical inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from .functionspace import Function
from .la import MatrixCSR
from .stencil import StencilCutOperator

__all__ = ["operator_from_reference", "function_from_reference",
           "matrix_from_reference",
           "GRID_STATE_KEYS", "GRID_LAYOUT_KEYS", "STACK_KEYS"]

# a cutfemx_tpu StencilCutOperator's _grid_statics() + _grid_arrays()
GRID_STATE_KEYS = ("n", "N", "nch", "table", "gsize", "A_local",
                   "cube_mask", "active_grid", "identity_grid", "rest_mats",
                   "rest_rows_grid", "rest_cols_grid", "permg", "sortedg")
# its dof <-> grid layout maps, needed for the dof-vector entry points
GRID_LAYOUT_KEYS = ("grid_valid", "grid_gather", "dof_to_grid", "active")
# its built preconditioner stack, under the attribute names of both packages
STACK_KEYS = ("_bf_diag", "_bf_fwd", "_bf_rev", "_bf_bbox", "_asm_binv",
              "_asm_bbox", "_c_W", "_c_sel", "_c_acinv")


def operator_from_reference(arrays, device, dtype):
    """A StencilCutOperator whose grid-apply state is the reference's.

    ``arrays`` maps every name of GRID_STATE_KEYS to numpy copies of the
    reference operator's ``_grid_statics()`` and ``_grid_arrays()`` (in
    that order of names); ``rest_mats``, ``rest_rows_grid`` and
    ``rest_cols_grid`` are sequences of arrays. With the GRID_LAYOUT_KEYS
    too (``active`` may be None), the operator also takes dof vectors
    (``__call__``, ``diagonal``, ``solve_cg``). Any of STACK_KEYS present
    (the reference's fold, ASM and coarse tensors; ``_bf_fwd``, ``_bf_rev``
    and ``_c_W`` are sequences, ``_bf_rev`` may be None) is adopted as
    built, so a solve runs on the reference's own preconditioner. Matrices
    are cast to ``dtype`` on ``device``."""
    missing = [k for k in GRID_STATE_KEYS if k not in arrays]
    if missing:
        raise KeyError(f"reference grid state lacks {missing}")
    dev = torch.device(device)

    def ints(a):
        return torch.tensor(np.asarray(a), dtype=torch.int64, device=dev)

    op = StencilCutOperator.__new__(StencilCutOperator)
    op.device = dev
    op.n, op.N, op.nch = int(arrays["n"]), int(arrays["N"]), \
        int(arrays["nch"])
    op.table = [(int(ch), tuple(int(o) for o in off))
                for ch, off in arrays["table"]]
    op.gsize = int(arrays["gsize"])
    op.A_local = torch.tensor(np.asarray(arrays["A_local"]), dtype=dtype,
                              device=dev)
    op.cube_mask = np.asarray(arrays["cube_mask"], bool)
    op.cube_mask_t = torch.tensor(op.cube_mask.astype(np.uint8),
                                  device=dev)
    op.active_grid = torch.tensor(np.asarray(arrays["active_grid"], bool),
                                  device=dev)
    op.identity_grid = torch.tensor(
        np.asarray(arrays["identity_grid"], bool), device=dev)
    op.rest_mats = tuple(torch.tensor(np.asarray(m), dtype=dtype,
                                      device=dev)
                         for m in arrays["rest_mats"])
    op._rest_rows_grid_host = tuple(
        np.asarray(r, np.int64) for r in arrays["rest_rows_grid"])
    op._rest_cols_grid_host = tuple(
        np.asarray(c, np.int64) for c in arrays["rest_cols_grid"])
    op.rest_rows_grid = tuple(ints(r) for r in op._rest_rows_grid_host)
    op.rest_cols_grid = tuple(ints(c) for c in op._rest_cols_grid_host)
    op._active_grid_host = np.asarray(arrays["active_grid"], bool)
    # the reference sums rows in sorted (permg, sortedg) order; the port
    # takes that order as permutation + run lengths
    sortedg = np.asarray(arrays["sortedg"]).astype(np.int64)
    op._permg = ints(arrays["permg"])
    op._seg_lengths = torch.tensor(
        np.bincount(sortedg, minlength=op.gsize), device=dev)
    op._init_stack_state()

    def mats(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=dev)

    for k in STACK_KEYS:
        if k not in arrays:
            continue
        v = arrays[k]
        if k in ("_bf_bbox", "_asm_bbox"):
            v = tuple(int(i) for i in v)
        elif k == "_c_sel":
            v = tuple(tuple(int(i) for i in row) for row in v)
        elif k in ("_bf_fwd", "_bf_rev", "_c_W"):
            v = None if v is None else tuple(mats(a) for a in v)
        else:
            v = mats(v)
        setattr(op, k, v)
    if all(k in arrays for k in GRID_LAYOUT_KEYS):
        op.grid_valid = torch.tensor(
            np.asarray(arrays["grid_valid"], bool), device=dev)
        op.grid_gather = ints(arrays["grid_gather"])
        op.dof_to_grid = ints(arrays["dof_to_grid"])
        act = arrays["active"]
        op.active = None if act is None else torch.tensor(
            np.asarray(act, bool), device=dev)
    return op


def function_from_reference(V, x):
    """A port Function on space V holding the reference's dof values ``x``
    (a numpy copy of a cutfemx_tpu Function's ``.x``)."""
    x = np.asarray(x)
    if x.shape != (V.dim,):
        raise ValueError(f"expected {V.dim} dof values, got {x.shape}")
    f = Function(V)
    f.x = torch.tensor(x, device=V.device)
    return f


def matrix_from_reference(A):
    """The port's MatrixCSR holding a copy of ``A``: a reference
    ``cutfemx_tpu.la.MatrixCSR`` (anything with ``to_scipy()``) or a SciPy
    sparse matrix."""
    import scipy.sparse as sps
    m = A.to_scipy() if hasattr(A, "to_scipy") else A
    return MatrixCSR(sps.csr_matrix(m, copy=True))
