"""Complex forms and the vertex and ridge measures of cutfemx_tpu_torch
against cutfemx_tpu, on the CPU: both cases of
tests/test_complex_assembly.py (rank 0, 1 and 2; 1e-12 against the
reference, and that file's own gates), complex CG and BiCGStab on a
Hermitian positive-definite system (the iteration counts of the
reference, the solution against SciPy's spsolve), the complex sorted
segment sum, and the nine cases of tests/test_vertex_ridge.py (1e-12
against the reference and against their exact values).

The inputs come from chip_smoke.py's builders (``complex_cases``,
``hermitian_cg``, ``vertex_ridge_cases``), which the card's surface_io
phase runs at larger sizes; each package's side is built once per
module."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import cutfemx_tpu as cj  # noqa: E402
import cutfemx_tpu_torch as ct  # noqa: E402
from chip_smoke import (HERMITIAN_X_RTOL, VERTEX_RIDGE_TOL,  # noqa: E402
                        complex_cases, hermitian_cg, hold_complex_cases,
                        vertex_ridge_cases)
from test_torch_core import host  # noqa: E402

TOL = 1e-12
# tests/test_complex_assembly.py's sizes
N_HELMHOLTZ, N_RUNTIME, N_HERMITIAN = 4, 3, 16
VERTEX_CASES = {
    "vertex": ("vertex_functional", "vertex_load_vector",
               "vertex_mass_matrix", "vertex_p2_point_evaluation"),
    "ridge_3d": ("ridge_length_3d", "ridge_polynomial_3d",
                 "ridge_rank1_3d"),
    "ridge_2d_and_errors": ("ridge_2d_falls_back_to_vertices",
                            "vertex_requires_entities"),
}


@pytest.fixture(scope="module")
def complex_out():
    return {pkg: complex_cases(pkg, N_HELMHOLTZ, N_RUNTIME,
                               device=None if pkg is cj else "cpu")
            for pkg in (cj, ct)}


@pytest.mark.parametrize("case", ["helmholtz", "runtime"])
def test_complex_assembly_matches_reference(complex_out, case):
    ref, got = complex_out[cj], complex_out[ct]
    hold_complex_cases(got)
    keys = [k for k in got if k.startswith(case)] + (
        [k for k in got if k.startswith("standard")]
        if case == "runtime" else [])
    assert len(keys) == (3 if case == "helmholtz" else 6)
    for k in keys:
        a, b = ref[k], got[k]
        if hasattr(a, "toarray"):
            assert a.dtype == b.dtype and a.shape == b.shape, k
            a, b = a.toarray(), b.toarray()
        a, b = np.asarray(a), np.asarray(b)
        assert np.iscomplexobj(b) == ("real" not in k and "imag" not in k)
        assert np.abs(a - b).max() < TOL, k
    if case == "helmholtz":
        assert np.abs(got["helmholtz"].imag).max() > 0


def test_complex_krylov_matches_reference():
    """la.cg (vdot inner products, the rz > 0 guard on its real part) on
    the element-batched CutOperator: the reference's count, the solution
    against spsolve; la.bicgstab on the same system (a dense apply): the
    solution against spsolve, the count near the reference's; the complex
    segment sum against index_add_."""
    from scipy.sparse.linalg import spsolve

    from cutfemx_tpu import la as la_j
    from cutfemx_tpu_torch import fem as fem_t, la as la_t
    Aj, b, xj, itj = hermitian_cg(cj, N_HERMITIAN)
    A, b_t, x, it = hermitian_cg(ct, N_HERMITIAN, device="cpu")
    assert np.array_equal(b, b_t) and abs(A - Aj).max() < TOL
    assert abs(A - A.conj().T).max() == 0.0 and it == itj > 10
    xs = spsolve(A.tocsc(), b)
    for got in (x, xj):
        assert np.abs(got - xs).max() < HERMITIAN_X_RTOL * np.abs(xs).max()

    Ad = A.toarray()
    Ajd = jnp.asarray(Ad)
    At = torch.as_tensor(Ad)
    xb_j, itb_j, _ = la_j.bicgstab(lambda v: Ajd @ v, jnp.asarray(b),
                                   rtol=1e-10, maxiter=500)
    xb, itb, _ = la_t.bicgstab(lambda v: At @ v, torch.as_tensor(b),
                               rtol=1e-10, maxiter=500)
    # BiCGStab's count on this system moves by up to 6 when b moves by
    # 1e-15 relative (the reference itself takes 94 to 100 iterations),
    # so it is held to a band here, and the solution to spsolve's
    assert abs(itb - int(itb_j)) <= 6 and itb > 0
    assert np.abs(host(xb) - xs).max() < HERMITIAN_X_RTOL * np.abs(xs).max()

    rng = np.random.default_rng(2)
    rows = rng.integers(0, 40, 500)
    vals = torch.as_tensor(rng.standard_normal(500)
                           + 1j * rng.standard_normal(500))
    perm, lengths = fem_t.sorted_scatter_plan(rows, 40, "cpu")
    got = fem_t.segment_sum_sorted(vals[perm], lengths)
    want = torch.zeros(40, dtype=vals.dtype).index_add_(
        0, torch.as_tensor(rows), vals)
    assert got.dtype == vals.dtype
    assert float((got - want).abs().max()) < 1e-13


@pytest.fixture(scope="module")
def vertex_out():
    return {pkg: vertex_ridge_cases(pkg, device=None if pkg is cj
                                    else "cpu")
            for pkg in (cj, ct)}


@pytest.mark.parametrize("group", list(VERTEX_CASES))
def test_vertex_ridge_match_reference(vertex_out, group):
    ref, got = vertex_out[cj], vertex_out[ct]
    for case in VERTEX_CASES[group]:
        (vj, exact_j), (v, exact) = ref[case], got[case]
        assert np.array_equal(exact, exact_j), case
        assert v.shape == vj.shape, case
        assert np.abs(v - vj).max() < VERTEX_RIDGE_TOL, case
        assert np.abs(v - exact).max() < VERTEX_RIDGE_TOL, case
