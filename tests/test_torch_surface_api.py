"""The rest of the fem/la surface of cutfemx_tpu_torch against
cutfemx_tpu, f64 on the CPU: the compact views of RuntimeQuadratureRules
(ROADMAP C5), the package facade and ``Constant`` (in a form and in
``dirichletbc``), ``native.get_lib`` / ``native_available``, the public
names the reference has on cells, CutData, the DSL, the kernels and the
spaces, and the high-degree spaces of tests/test_high_degree.py.

Both packages get the same numpy inputs. The compact views are held
exactly on the same padded arrays (they are a function of them) and to
1e-14 on each package's own rules, whose padded arrays agree to rounding.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import cutfemx_tpu as cj  # noqa: E402
import cutfemx_tpu_torch as ct  # noqa: E402
from cutfemx_tpu_torch.cut.quadrature import (  # noqa: E402
    RuntimeQuadratureRules)
from test_torch_core import host, rel_err  # noqa: E402
from test_torch_core import (  # noqa: E402,F401  (autouse)
    _yield_cpu_to_the_critical_file)

F64 = torch.float64
VIEWS = ("points", "weights", "offsets", "mask", "total_points", "gdim",
         "physical_points")


def _kw(pkg):
    """(space kwargs, function kwargs, form kwargs) of an f64 problem."""
    if pkg is cj:
        return {}, {}, {}
    return {"device": "cpu"}, {"dtype": F64}, {"dtype": F64}


def _line_rules(pkg):
    """tests/test_cut_api_contracts.py's input of
    test_runtime_quadrature_compact_contract: y = 0.26 on 4 x 4
    triangles, the 'phi<0' rules of order 2."""
    skw, fkw, _ = _kw(pkg)
    mesh = pkg.mesh.create_rectangle((0.0, 0.0), (1.0, 1.0), (4, 4),
                                     "triangle")
    phi = pkg.Function(pkg.functionspace(mesh, ("Lagrange", 1), **skw),
                       name="phi", **fkw)
    phi.interpolate(lambda x: x[1] - 0.26)
    return pkg.runtime_quadrature(pkg.cut(phi), "phi<0", 2)


def _algoim_rules(pkg):
    """tests/test_reference_contracts.py's algoim case on interval facets:
    the roots of the P2 level set (x - 0.37)(x + 0.5) on the interior
    facets of 4 x 4 quadrilaterals."""
    skw, fkw, _ = _kw(pkg)
    mesh = pkg.mesh.create_rectangle((0.0, 0.0), (1.0, 1.0), (4, 4),
                                     "quadrilateral")
    phi = pkg.Function(pkg.functionspace(mesh, ("Lagrange", 2), **skw),
                       name="phi", **fkw)
    phi.interpolate(lambda x: (x[0] - 0.37) * (x[0] + 0.5))
    cd = pkg.cut(phi, entities=mesh.interior_facets,
                 entity_dim=mesh.tdim - 1)
    return pkg.runtime_quadrature(cd, "phi=0", 4, backend="algoim")


@pytest.mark.parametrize("case", ["line", "algoim"])
def test_compact_views_match_reference(case):
    build = _line_rules if case == "line" else _algoim_rules
    rj, rt = build(cj), build(ct)
    assert rt._physical_points is None          # lazy
    # the port's views of the reference's padded arrays: exactly the
    # reference's views
    same = RuntimeQuadratureRules(
        rj.tdim, rj.parent_map, torch.tensor(host(rj.points_padded)),
        torch.tensor(host(rj.weights_padded)), mesh=rt.mesh,
        parent_cells=rj.parent_cells)
    assert same.with_physical_points() is same
    for name in VIEWS:
        assert np.array_equal(getattr(rj, name), getattr(same, name)), name
    # the port's own rules
    for name in VIEWS:
        a, b = np.asarray(getattr(rj, name)), np.asarray(getattr(rt, name))
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert np.abs(a.astype(float) - b.astype(float)).max() < 1e-14, name
    assert rt.total_points == int((host(rt.weights_padded) != 0).sum()) > 0
    assert rt.physical_points.shape == (rt.gdim, rt.total_points)
    if case == "line":      # the contract test's own checks
        assert rt.offsets[0] == 0 and rt.parent_map.size == \
            rt.offsets.size - 1 and (rt.weights > 0).all()
        assert (rt.physical_points[1] <= 0.26 + 1e-12).all()
    else:
        assert np.array_equal(rt.weights, np.ones_like(rt.weights))
        assert np.abs(rt.physical_points[0] - 0.37).max() < 1e-12


def test_facade_names_and_constant():
    """The reference's facade names, the lazy modules (parallel and
    distance.sharded among them), an unknown name that raises; Constant in
    a form, and in dirichletbc on a blocked space (one value per
    component) and a scalar one, against the reference (1e-13)."""
    from cutfemx_tpu_torch.forms import dsl, measure
    assert ct.Measure is measure.Measure
    assert (ct.dx, ct.ds, ct.dS) == (measure.dx, measure.ds, measure.dS)
    assert ct.QuadratureFunction is ct.QuadratureField is dsl.QuadratureField
    assert ct.la.__name__ == "cutfemx_tpu_torch.la"
    for name in ("io", "petsc", "profiling", "parallel"):
        assert getattr(ct, name).__name__ == f"cutfemx_tpu_torch.{name}"
    assert ct.fem.cut_form is ct.fem.form
    import cutfemx_tpu_torch.distance.sharded as sharded
    assert ct.distance.sharded is sharded
    with pytest.raises(AttributeError, match="no attribute 'nothing'"):
        ct.nothing
    c = ct.Constant([0.5, -2.0], device="cpu")
    assert c.dtype == torch.get_default_dtype() and c.value.device.type == \
        "cpu"
    assert ct.Constant(1.0 + 2.0j, device="cpu").dtype.is_complex

    out = {}
    for pkg in (cj, ct):
        skw, _, dkw = _kw(pkg)
        fem, d = pkg.fem, pkg.ufl
        mesh = pkg.mesh.create_rectangle((-1.0, -1.0), (1.0, 1.0), (4, 4))
        V = pkg.functionspace(mesh, ("Lagrange", 2), shape=(2,), **skw)
        Q = pkg.functionspace(mesh, ("Lagrange", 1), **skw)
        top = fem.locate_dofs_geometrical(V, lambda x: np.isclose(x[1], 1.0))
        left = fem.locate_dofs_geometrical(Q, lambda x: np.isclose(x[0], -1))
        const = pkg.Constant(np.array([0.5, -2.0]), **skw)
        q = d.TestFunction(Q)
        b = fem.assemble_vector(fem.form(
            pkg.Constant(3.5, **skw) * q * pkg.dx(domain=mesh), **dkw))
        out[pkg] = (fem.dirichletbc(const, top, V).values,
                    fem.dirichletbc(pkg.Constant(0.25, **skw), left,
                                    Q).values, host(b))
    for a, b in zip(out[cj], out[ct]):
        assert a.shape == b.shape and a.size > 0
        assert np.abs(a - b).max() < 1e-13
    assert set(np.unique(out[ct][0])) == {0.5, -2.0}


def test_native_get_lib_and_availability(monkeypatch):
    """get_lib binds the reference's functions (the same C++ source): the
    orientation and intersection predicates give the reference's values;
    a library that cannot be built gives None and not available."""
    import ctypes

    from cutfemx_tpu.native import get_lib as get_lib_j
    from cutfemx_tpu_torch import native
    lib, lib_j = native.get_lib(), get_lib_j()
    assert lib is not None and native.native_available()

    def dp(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))

    rng = np.random.default_rng(4)
    for _ in range(5):
        p = [np.ascontiguousarray(rng.standard_normal(3)) for _ in range(5)]
        assert lib.cutfemx_orient2d(*map(dp, p[:3])) == \
            lib_j.cutfemx_orient2d(*map(dp, p[:3]))
        assert lib.cutfemx_seg_tri_isect(*map(dp, p)) == \
            lib_j.cutfemx_seg_tri_isect(*map(dp, p))
        t = [np.ascontiguousarray(rng.standard_normal(9)) for _ in range(2)]
        assert lib.cutfemx_tri_tri_isect(*map(dp, t)) == \
            lib_j.cutfemx_tri_tri_isect(*map(dp, t))

    def fail():
        raise RuntimeError("g++ failed")
    monkeypatch.setattr(native, "build", fail)
    assert native.get_lib() is None and not native.native_available()


def test_restored_public_names_match_reference():
    """ReferenceCell.facet_reference_volume, CutData.num_local_cells,
    dsl.Abs (in a form, 1e-13), IntegralKernel.has_block and
    FunctionSpace.tabulate_dof_coordinates against the reference."""
    from cutfemx_tpu.cells import reference_cell as cell_j
    from cutfemx_tpu_torch.cells import reference_cell as cell_t
    for name in ("interval", "triangle", "quadrilateral", "tetrahedron",
                 "hexahedron"):
        assert cell_t(name).facet_reference_volume() == \
            cell_j(name).facet_reference_volume()
    vals = {}
    for pkg in (cj, ct):
        skw, fkw, dkw = _kw(pkg)
        d = pkg.ufl
        mesh = pkg.mesh.create_rectangle((-1.0, -1.0), (1.0, 1.0), (6, 6))
        V = pkg.functionspace(mesh, ("Lagrange", 2), **skw)
        phi = pkg.Function(pkg.functionspace(mesh, ("Lagrange", 1), **skw),
                           **fkw)
        phi.interpolate(lambda x: x[0] - 0.13)
        x = d.SpatialCoordinate(mesh)
        dx = pkg.Measure("dx", domain=mesh)
        f = pkg.fem.form(d.Abs(x[0] - 0.3) * d.TestFunction(V) * dx, **dkw)
        kern = f.instances[0].kernel
        assert kern.has_block((None, None)) and not kern.has_block((0, 0))
        vals[pkg] = (host(pkg.fem.assemble_vector(f)),
                     V.tabulate_dof_coordinates(),
                     pkg.cut(phi).num_local_cells)
    (bj, cj_, nj), (bt, ctt, nt) = vals[cj], vals[ct]
    assert nj == nt == 72
    assert np.array_equal(cj_, ctt)
    assert np.abs(bj - bt).max() < 1e-13 and np.abs(bt).max() > 0


def _poly(p):
    def f(x):
        return (x[0] ** p + 2.0 * x[1] ** (p - 1) * x[0]
                + 0.5 * x[2] ** p - x[0] * x[1] * x[2])
    return f


@pytest.mark.parametrize("cell,degree", [("tetrahedron", 4),
                                         ("hexahedron", 3)])
def test_high_degree_matches_reference(cell, degree):
    """tests/test_high_degree.py's P4 tet and P3 hex spaces (faces with
    more than one interior dof): the dofmap equal to the reference's; a
    degree-p polynomial interpolated and evaluated per cell through the
    dofmap is exact (5e-10, the test's); the stiffness matrix annihilates
    constants and equals the reference's (1e-12)."""
    from cutfemx_tpu_torch.elements import lagrange_element
    spaces, mats = {}, {}
    for pkg in (cj, ct):
        skw, _, dkw = _kw(pkg)
        d = pkg.ufl
        mesh = pkg.mesh.create_box((0, 0, 0), (1, 1, 1), (2, 2, 2),
                                   cell_type=cell)
        V = spaces[pkg] = pkg.functionspace(mesh, ("Lagrange", degree),
                                            **skw)
        u, v = d.TrialFunction(V), d.TestFunction(V)
        mats[pkg] = pkg.fem.assemble_matrix(pkg.fem.form(
            d.inner(d.grad(u), d.grad(v)) * pkg.dx, **dkw)).to_scipy()
    Vj, V = spaces[cj], spaces[ct]
    assert np.array_equal(Vj.dofmap, V.dofmap)
    u = ct.Function(V, dtype=F64)
    u.interpolate(_poly(degree))
    rng = np.random.default_rng(3)
    pts = rng.random((6, 3))
    if cell == "tetrahedron":
        pts = pts / pts.sum(axis=1, keepdims=True) * rng.random((6, 1)) * .95
    ref = V.mesh.ref_cell
    for fverts in ref.facets:            # points on every facet
        lam = rng.random((2, len(fverts)))
        lam /= lam.sum(axis=1, keepdims=True)
        pts = np.concatenate([pts, lam @ ref.vertices[np.asarray(fverts)]])
    w = lagrange_element(cell, 1).tabulate(pts)
    xs = np.einsum("pk,ckg->cpg", w, V.mesh.cell_vertex_coords)
    vals = host(u.x)[V.dofmap] @ V.element.tabulate(pts).T
    exact = _poly(degree)(np.moveaxis(xs, -1, 0))
    assert np.abs(vals - exact).max() < 5e-10 * max(1, np.abs(exact).max())
    A = mats[ct]
    assert np.abs(A @ np.ones(V.dim)).max() < 1e-10
    assert rel_err(mats[cj].toarray(), A.toarray()) < 1e-12
