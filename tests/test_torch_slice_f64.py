"""cutfemx_tpu_torch against cutfemx_tpu on the bench problem in f64:
cut quadrature, the level-set normal, the cut cell sets, the load vector,
the element matrices and the stencil state (n = 8, r = 0.46, P2; CPU).
The grid-layout apply and the Jacobi solve on the same problem are in
test_torch_slice_f64_solve.py (which takes this file's fixtures), the
cut-geometry and full-cell oracles in test_torch_slice_oracles.py, the
other preconditioners in test_torch_stack*.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import cutfemx_tpu as cj  # noqa: E402
import cutfemx_tpu_torch as ct  # noqa: E402
from cutfemx_tpu import fem as fem_j  # noqa: E402
from cutfemx_tpu.stencil import StencilCutOperator as StencilJ  # noqa: E402
from cutfemx_tpu_torch import fem as fem_t  # noqa: E402
from cutfemx_tpu_torch.stencil import (  # noqa: E402
    StencilCutOperator as StencilT)
from test_torch_core import bench_problem, rel_err  # noqa: E402


@pytest.fixture(scope="module")
def ref():
    P = bench_problem(cj, np.float64)
    P["op"] = StencilJ(P["af"], P["dom"])
    return P


@pytest.fixture(scope="module")
def port():
    P = bench_problem(ct, torch.float64, device="cpu",
                      phi_dtype=torch.float64)
    P["op"] = StencilT(P["af"], P["dom"])
    return P


# -- cut quadrature and the normal -------------------------------------------


@pytest.mark.parametrize("rules", ["vol", "srf"])
def test_runtime_quadrature_matches(ref, port, rules):
    rj, rt = ref[rules], port[rules]
    assert np.array_equal(rj.parent_map, rt.parent_map)
    assert rel_err(rj.points_padded, rt.points_padded) < 1e-13
    assert rel_err(rj.weights_padded, rt.weights_padded) < 1e-13
    if rules == "srf":
        assert rel_err(rj.normals_padded, rt.normals_padded) < 1e-13


def test_level_set_normal_matches(ref, port):
    assert rel_err(ref["ng"].evaluator(ref["srf"]),
                   port["ng"].evaluator(port["srf"])) < 1e-13


def test_cut_cell_sets_match(ref, port):
    assert np.array_equal(ref["gp"], port["gp"])
    assert np.array_equal(ref["dom"].inactive_dofs,
                          port["dom"].inactive_dofs)


def test_assemble_vector_matches(ref, port):
    assert rel_err(ref["b"], port["b"]) < 1e-12


def test_element_matrices_match(ref, port):
    Oj = fem_j.CutOperator(ref["af"], ref["dom"], apply_plan=False)
    Ot = fem_t.CutOperator(port["af"], port["dom"])
    assert len(Oj.element_matrices) == len(Ot.element_matrices)
    for Aj, At, rj, rt in zip(Oj.element_matrices, Ot.element_matrices,
                              Oj._rows_host, Ot._rows_host):
        assert np.array_equal(rj, rt)
        assert rel_err(Aj, At) < 1e-12


def test_stencil_state_matches(ref, port):
    oj, ot = ref["op"], port["op"]
    assert np.array_equal(oj.cube_mask, ot.cube_mask)
    assert int(oj.cube_mask.sum()) == 8          # full interior cubes
    assert rel_err(oj.A_local, ot.A_local) < 1e-12
    assert [tuple(m.shape) for m in oj.rest_mats] == \
        [tuple(m.shape) for m in ot.rest_mats] == [(320, 10, 10),
                                                   (512, 14, 14)]
    for mj, mt in zip(oj.rest_mats, ot.rest_mats):
        assert rel_err(mj, mt) < 1e-12
