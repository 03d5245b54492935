"""cutfemx_tpu_torch against cutfemx_tpu on the bench problem in f64:
cut quadrature, the level-set normal, assembly, the grid-layout apply and
the Jacobi solve (n = 8, r = 0.46, P2; CPU, the kernel's plain version).
The other preconditioners are in test_torch_stack.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import cutfemx_tpu as cj  # noqa: E402
import cutfemx_tpu_torch as ct  # noqa: E402
from cutfemx_tpu import fem as fem_j  # noqa: E402
from cutfemx_tpu.stencil import StencilCutOperator as StencilJ  # noqa: E402
from cutfemx_tpu_torch import fem as fem_t, interop  # noqa: E402
from cutfemx_tpu_torch.stencil import (  # noqa: E402
    StencilCutOperator as StencilT)
from test_torch_core import (  # noqa: E402
    bench_problem, host, reference_grid_state, rel_err)


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


def _sphere(n, r):
    mesh = ct.mesh.create_box((-1, -1, -1), (1, 1, 1), (n, n, n))
    V = ct.functionspace(mesh, ("Lagrange", 1), device="cpu")
    phi = ct.Function(V, name="phi", dtype=torch.float64)
    phi.interpolate(lambda x: np.sqrt(x[0]**2 + x[1]**2 + x[2]**2) - r)
    return mesh, phi


def test_sphere_volume_and_area_oracle():
    """The oracle of tests/test_cut_api.py::test_sphere_volume_and_area_3d:
    P1 level set, O(h^2) geometric error."""
    r, n = 0.4, 12
    mesh, phi = _sphere(n, r)
    cd = ct.cut(phi)
    inside = ct.locate_entities(cd, "phi<0")
    vol_rules = ct.runtime_quadrature(cd, "phi<0", 2)
    surf_rules = ct.runtime_quadrature(cd, "phi=0", 2)
    coords = mesh.cell_vertex_coords[inside]
    vol_full = np.abs(np.einsum(
        "cij,cij->c", np.cross(coords[:, 1] - coords[:, 0],
                               coords[:, 2] - coords[:, 0])[:, None, :],
        (coords[:, 3] - coords[:, 0])[:, None, :])).sum() / 6.0
    vol = vol_full + float(vol_rules.weights_padded.sum())
    area = float(surf_rules.weights_padded.sum())
    h = 2.0 / n
    assert abs(vol - 4 / 3 * np.pi * r ** 3) < 4 * h ** 2
    assert abs(area - 4 * np.pi * r ** 2) < 10 * h ** 2


def test_circle_area_and_perimeter_oracle():
    """tests/test_cut_api.py::test_circle_area_and_perimeter, degree 1."""
    r, n = 0.31, 64
    mesh = ct.mesh.create_rectangle((-1.0, -1.0), (1.0, 1.0), (n, n))
    V = ct.functionspace(mesh, ("Lagrange", 1), device="cpu")
    phi = ct.Function(V, name="phi", dtype=torch.float64)
    phi.interpolate(lambda x: np.sqrt(x[0] ** 2 + x[1] ** 2) - r)
    cd = ct.cut(phi)
    inside = ct.locate_entities(cd, "phi<0")
    vol_rules = ct.runtime_quadrature(cd, "phi<0", 3)
    surf_rules = ct.runtime_quadrature(cd, "phi=0", 3)
    coords = mesh.cell_vertex_coords[inside]
    e1 = coords[:, 1] - coords[:, 0]
    e2 = coords[:, 2] - coords[:, 0]
    area = float(vol_rules.weights_padded.sum()) + 0.5 * np.abs(
        e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]).sum()
    perim = float(surf_rules.weights_padded.sum())
    h = 2.0 / n
    assert abs(area - np.pi * r ** 2) < 2.0 * h ** 2
    assert abs(perim - 2 * np.pi * r) < 5.0 * h ** 2


# -- assembly ----------------------------------------------------------------


def test_runtime_rules_on_full_cells_match_standard_assembly():
    """The oracle of tests/test_runtime_vs_standard.py: runtime quadrature
    over whole cells (full_cell_rules) assembles what the standard rule
    does."""
    from cutfemx_tpu_torch.cut.quadrature import full_cell_rules
    from cutfemx_tpu_torch.forms.dsl import (SpatialCoordinate, TestFunction,
                                             grad, inner, sin)
    from cutfemx_tpu_torch.forms.measure import Measure
    mesh = ct.mesh.create_box((0, 0, 0), (1, 1, 1), (3, 3, 3))
    V = ct.functionspace(mesh, ("Lagrange", 2), device="cpu")
    v, x = TestFunction(V), SpatialCoordinate(mesh)
    f = sin(3 * x[0]) * (1 + x[1] * x[2])
    rules = full_cell_rules(mesh, np.arange(mesh.num_cells), 6,
                            device="cpu")

    def vec(dx):
        L = f * v * dx + inner(grad(f), grad(v)) * dx
        return fem_t.assemble_vector(fem_t.form(L, dtype=torch.float64))
    b_std = vec(Measure("dx", domain=mesh, metadata={"quadrature_degree":
                                                     6}))
    b_run = vec(Measure("dx", domain=mesh, subdomain_data=rules))
    assert rel_err(b_std, b_run) < 1e-12


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


# -- the grid-layout apply ----------------------------------------------------


@pytest.mark.parametrize("state", ["interop", "own"])
def test_grid_apply_matches(ref, port, state):
    """As tests/test_stencil.py::test_stencil_matches_element_apply: three
    seeded vectors, f64, 1e-12 relative."""
    oj = ref["op"]
    ot = port["op"] if state == "own" else interop.operator_from_reference(
        reference_grid_state(oj), "cpu", torch.float64)
    rng = np.random.default_rng(0)
    for _ in range(3):
        x = rng.standard_normal(ref["V"].dim)
        y0 = host(oj(jnp.asarray(x)))
        y1 = host(ot(torch.as_tensor(x)))
        assert np.abs(y0 - y1).max() < 1e-12 * max(np.abs(y0).max(), 1)
    d0, d1 = host(oj.diagonal()), host(ot.diagonal())
    assert np.abs(d0 - d1).max() < 1e-12 * np.abs(d0).max()


def test_function_from_reference_round_trips(ref, port):
    f = interop.function_from_reference(port["phi"].function_space,
                                        np.asarray(ref["phi"].x))
    assert torch.equal(f.x, port["phi"].x)


# -- the f64 Jacobi solve -----------------------------------------------------


def test_jacobi_solve_f64_matches(ref, port):
    """tests/test_stencil.py::test_stencil_solve_matches' oracle: like-
    preconditioned solves follow the same CG trajectory."""
    x0, it0, _ = ref["op"].solve_cg(ref["b"], rtol=1e-9, maxiter=2000,
                                    precond="jacobi", refine=False)
    x1, it1, _ = port["op"].solve_cg(port["b"], rtol=1e-9, maxiter=2000,
                                     precond="jacobi", refine=False)
    mask = ref["dom"].active_mask
    x0, x1 = host(x0), host(x1)
    assert np.abs(x0 - x1)[mask].max() < 1e-6 * np.abs(x0[mask]).max()
    assert abs(int(it0) - it1) <= 2


def test_unknown_precond_raises_value_error(port):
    for pc in ("ilu", "asm3", ""):
        with pytest.raises(ValueError, match="unknown precond"):
            port["op"].solve_cg(port["b"], precond=pc)
