"""Oracles of the cut geometry and of full-cell runtime rules in
cutfemx_tpu_torch (f64, CPU): the P1 sphere's volume and area and the
circle's area and perimeter against their exact values at O(h^2), and
runtime rules over whole cells against the standard rule's assembly."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import cutfemx_tpu_torch as ct  # noqa: E402
from cutfemx_tpu_torch import fem as fem_t  # noqa: E402
from test_torch_core import rel_err  # noqa: E402


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
