"""The production preconditioner stack of cutfemx_tpu_torch against
cutfemx_tpu on the bench problem in f64 (n = 8, r = 0.46, P2; CPU tensors,
so the interior stencil is the kernel's plain version): the band fold, the
cube-ASM blocks taken from it and the coarse lattice.

This file holds the stack's fixtures; the other stack files take them:
test_torch_stack_solve.py (the coarse apply and the solves),
test_torch_stack_cache.py (the verified-reuse build cache, the traffic
model, numpy vectors into the operator) and test_torch_stack_blocks.py
(the sorted scatter and the SPD block inverse)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import cutfemx_tpu as cj  # noqa: E402
import cutfemx_tpu_torch as ct  # noqa: E402
from cutfemx_tpu import stencil as sj  # noqa: E402
from cutfemx_tpu_torch import interop, stencil as st  # noqa: E402
from test_torch_core import (  # noqa: E402
    bench_problem, host, reference_grid_state, rel_err)

def _port_problem(**kw):
    P = bench_problem(ct, torch.float64, device="cpu",
                      phi_dtype=torch.float64, **kw)
    P["op"] = st.StencilCutOperator(P["af"], P["dom"])
    return P


@pytest.fixture(scope="module")
def ref(port):
    """The reference operator with its three stages built: the direct fold
    first, so its ASM blocks come from the fold as the port's always do.
    Its right-hand side is the port's (the two are compared in
    test_torch_slice_f64.py), so both solves start from the same bits."""
    P = bench_problem(cj, np.float64, rhs=False)
    P["b"] = jnp.asarray(host(port["b"]))
    op = P["op"] = sj.StencilCutOperator(P["af"], P["dom"])
    op._ensure_band_fold()
    assert op._bf_direct
    op._ensure_cube_asm()
    op._ensure_coarse()
    return P


@pytest.fixture(scope="module")
def port():
    P = _port_problem()
    op = P["op"]
    op._ensure_band_fold()
    op._ensure_cube_asm()
    op._ensure_coarse()
    return P


@pytest.fixture(scope="module")
def twin(ref):
    """A port operator holding the reference's own grid state and built
    stack: applies and solves on identical tensors."""
    oj = ref["op"]
    state = reference_grid_state(oj)
    state.update(
        _bf_diag=host(oj._bf_diag), _bf_fwd=[host(a) for a in oj._bf_fwd],
        _bf_rev=None, _bf_bbox=oj._bf_bbox, _asm_binv=host(oj._asm_binv),
        _asm_bbox=oj._asm_bbox, _c_W=[host(a) for a in oj._c_W],
        _c_sel=oj._c_sel, _c_acinv=host(oj._c_acinv))
    assert oj._bf_rev is None       # the bench form is symmetric
    return interop.operator_from_reference(state, "cpu", torch.float64)


def _seeded_grid_vector(op, seed):
    x = np.random.default_rng(seed).standard_normal(op.gsize)
    return np.where(host(op.grid_valid).reshape(-1), x, 0.0)


# -- the band fold -------------------------------------------------------------


def test_fold_tensors_match(ref, port):
    oj, ot = ref["op"], port["op"]
    assert tuple(oj._bf_bbox) == ot._bf_bbox
    assert oj._bf_rev is None and ot._bf_rev is None
    assert rel_err(oj._bf_diag, ot._bf_diag) < 1e-12
    for fj, ft in zip(oj._bf_fwd, ot._bf_fwd):
        assert np.abs(host(fj)).max() > 0
        assert rel_err(fj, ft) < 1e-12


def _plane(x):
    # tilted plane: the active domain touches the box boundary, so the fold
    # bbox origin is 0 on two axes and its far side is the lattice edge
    return x[0] + 0.31 * x[1] - 0.13


@pytest.mark.parametrize("case", ["sphere-P2", "plane-P2", "sphere-P1"])
def test_fold_apply_is_exact(port, case):
    """The folded apply equals the gather apply (the oracle of
    tests/test_stencil.py: the fold moves entries, it changes no sum)."""
    if case == "sphere-P2":
        op = port["op"]
    elif case == "plane-P2":
        op = _port_problem(n=6, level_set=_plane)["op"]
        op._ensure_band_fold()
        assert op._bf_bbox[1:3] == (0, 0)
        assert op._bf_bbox[1] + op._bf_bbox[4] == op.n   # clipped at the edge
    else:
        op = _port_problem(degree=1)["op"]
        op._ensure_band_fold()
        assert op.nch == 1 and len(op.table) == 8
    x = torch.as_tensor(_seeded_grid_vector(op, 2))
    stat, arr = op._grid_statics(), op._grid_arrays()
    y_gather = st._grid_apply_body(*stat, *arr, x)
    y_fold = st._grid_apply_fold_body(
        *stat, op._bf_bbox, *arr[:4], op._bf_diag, op._bf_fwd, op._bf_rev, x)
    assert float(y_gather.abs().max()) > 0
    assert rel_err(y_gather, y_fold) < 1e-13


# -- cube-block additive Schwarz ------------------------------------------------


def test_asm_blocks_match(ref, port):
    oj, ot = ref["op"], port["op"]
    assert tuple(oj._asm_bbox) == ot._asm_bbox
    assert rel_err(oj._asm_binv, ot._asm_binv) < 1e-8


def test_asm_apply_on_identical_tensors(ref, twin):
    oj = ref["op"]
    r = _seeded_grid_vector(twin, 3)
    n, N, nch, table, _ = oj._grid_statics()
    zj = sj._asm_apply_body(n, N, nch, table, oj._asm_bbox, oj._asm_binv,
                            oj.active_grid, jnp.asarray(r))
    zt = st._asm_apply_body(n, N, nch, table, twin._asm_bbox,
                            twin._asm_binv, twin.active_grid,
                            torch.as_tensor(r))
    assert rel_err(zj, zt) < 1e-12


# -- the coarse lattice ---------------------------------------------------------


def test_coarse_operator_matches(ref, port):
    oj, ot = ref["op"], port["op"]
    assert oj._c_sel == ot._c_sel
    assert (oj._c_K, oj._c_m) == (ot._c_K, ot._c_m) == (5, 2)
    for wj, wt in zip(oj._c_W, ot._c_W):
        assert rel_err(wj, wt) < 1e-15
    Aj = oj._coarse_galerkin_fold(oj._c_m)[0]
    At = ot._coarse_galerkin_fold(ot._c_m)[0]
    assert rel_err(Aj, At) < 1e-10
    assert rel_err(oj._c_acinv, ot._c_acinv) < 1e-7


# -- the solves' fixtures (test_torch_stack_solve.py) -------------------------


@pytest.fixture(scope="module")
def port_fold2(port):
    x, its, _ = port["op"].solve_cg(port["b"], rtol=1e-8, maxiter=800,
                                    precond="asm-fold2", refine=False)
    return host(x), its


@pytest.fixture(scope="module")
def ref_fold2(ref):
    x, its, _ = ref["op"].solve_cg(ref["b"], rtol=1e-8, maxiter=800,
                                   precond="asm-fold2", refine=False)
    return host(x), int(its)
