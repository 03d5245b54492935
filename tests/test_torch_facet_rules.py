"""Facet-hosted, compound and union cut rules, facet-hosted cut meshes and
runtime ds / dS integrals in cutfemx_tpu_torch against cutfemx_tpu, in f64
on the CPU.

The inputs are tests/test_cut_api_contracts.py's: the line y = 0.26 on
the unit square (n = 4; a second level set x = 0.41 for the compound
selectors) and the sphere of radius 0.33 in the unit cube
(n = 6). Both packages cut the same numpy level sets. Tolerances: rule
points and weights 1e-12 absolute, parent and facet arrays exactly,
matrices 1e-12 * max|A|, scalars 1e-12 relative. The reference compiles
each operation of its quadrature for each new shape (~6 s a compound
selector here, twice that for an OR of two terms), so one OR selector is
run in both packages: its inclusion-exclusion blocks hold the AND of its
two clauses as well."""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import cutfemx_tpu as cj  # noqa: E402
import cutfemx_tpu_torch as ct  # noqa: E402
from chip_smoke import compound_numbers  # noqa: E402
from test_torch_core import host, rel_err  # noqa: E402

TOL = 1e-12


def level_sets(pkg, kind, n):
    """The mesh and the named P1 level sets of a test problem, the same
    numpy values in both packages (the port's on the CPU, in f64)."""
    port = pkg is ct
    space_kw = {"device": "cpu"} if port else {}
    fn_kw = {"dtype": torch.float64} if port else {}
    if kind == "sphere":
        mesh = pkg.mesh.create_box((0, 0, 0), (1, 1, 1), (n, n, n))
        fns = {"phi": lambda x: (x[0] - 0.5) ** 2 + (x[1] - 0.5) ** 2
               + (x[2] - 0.5) ** 2 - 0.33 ** 2}
    else:
        mesh = pkg.mesh.create_rectangle((0.0, 0.0), (1.0, 1.0), (n, n),
                                         "triangle")
        fns = {"phi": lambda x: x[1] - 0.26, "cap": lambda x: x[0] - 0.41}
    V = pkg.functionspace(mesh, ("Lagrange", 1), **space_kw)
    out = []
    for name, f in fns.items():
        g = pkg.Function(V, name=name, **fn_kw)
        g.interpolate(f)
        out.append(g)
    return mesh, out


def hold_rules(ref, got):
    """Raise unless two RuntimeQuadratureRules agree: parents exactly,
    points and weights within TOL."""
    assert np.array_equal(ref.parent_map, got.parent_map)
    assert np.array_equal(ref.parent_cells, got.parent_cells)
    if ref.local_facets is not None:
        assert np.array_equal(np.asarray(ref.local_facets),
                              np.asarray(got.local_facets))
    for key in ("points_padded", "weights_padded"):
        a, b = host(getattr(ref, key)), host(getattr(got, key))
        assert a.shape == b.shape, key
        assert np.abs(a - b).max(initial=0.0) <= TOL, key


def both(kind, n, entities=None):
    """(reference, port) CutData of the same problem; ``entities`` picks
    the hosted entities from the reference's mesh: (array, dim)."""
    out = []
    for pkg in (cj, ct):
        mesh, phis = level_sets(pkg, kind, n)
        args = () if entities is None else entities(mesh)
        out.append(pkg.cut(phis if kind != "sphere" else phis[0], *args))
    return out


@pytest.fixture(scope="module")
def line_pair():
    """both('line', 4): the reference's and the port's cell-hosted CutData
    of the line and the cap, shared by the tests that need it."""
    return both("line", 4)


def test_facet_rules_2d_line():
    """The crossing points of the line on exterior and interior facets
    (one point of weight 1 each; the volume parts are held in
    test_runtime_ds_and_dS_integrals); the crossings of a P2 circle
    polished onto its true root (the circle itself: no reference run)."""
    for pick in (lambda m: (m.exterior_facets, 1),
                 lambda m: (m.interior_facets, 1)):
        cdj, cdt = both("line", 4, pick)
        hold_rules(cj.runtime_quadrature(cdj, "phi=0", 2),
                   ct.runtime_quadrature(cdt, "phi=0", 2))
    # polish: the crossings of a P2 circle (exact in P2) land on it
    from cutfemx_tpu_torch.cut.quadrature import facet_interface_rules
    mesh = ct.mesh.create_rectangle((0.0, 0.0), (1.0, 1.0), (4, 4),
                                    "triangle")
    V2 = ct.functionspace(mesh, ("Lagrange", 2), device="cpu")
    phi = ct.Function(V2, name="phi", dtype=torch.float64)
    phi.interpolate(lambda x: x[0] ** 2 + x[1] ** 2 - 0.6 ** 2)
    facets = ct.locate_entities(ct.cut(phi, mesh.interior_facets, 1),
                                "phi=0")
    for polish, tol in ((True, 1e-14), (False, 0.1)):
        r = facet_interface_rules(mesh, phi, facets, 2, polish=polish)
        w = host(r.weights_padded)
        assert len(w) and (w.sum(axis=1) == 1.0).all()
        el = ct.elements.lagrange_element(mesh.cell_type, 1)
        x = np.einsum("eqv,evg->eqg", host(el.tabulate(r.points_padded)),
                      mesh.cell_vertex_coords[r.parent_cells])[w > 0]
        err = np.abs(np.linalg.norm(x, axis=1) - 0.6).max()
        assert err <= tol and (polish or err > 1e-6)


def test_facet_rules_3d_sphere():
    """The interior facets between the sphere's cut cells: both volume
    parts, which sum to the facets' areas, and the interface segments."""
    def skeleton(mesh):
        cells = cj.locate_entities(cj.cut(level_sets(cj, "sphere", 6)[1][0]),
                                   "phi=0")
        return cj.interior_facets_for_cells(mesh, cells), 2

    cdj, cdt = both("sphere", 6, skeleton)
    rules = {}
    for sel in ("phi<0", "phi>0", "phi=0"):
        rules[sel] = ct.runtime_quadrature(cdt, sel, 2)
        hold_rules(cj.runtime_quadrature(cdj, sel, 2), rules[sel])
    mesh = cdt.mesh
    cut_f = ct.locate_entities(cdt, "phi=0")
    v = mesh.vertices[mesh.facets[cut_f]]
    area = 0.5 * np.linalg.norm(np.cross(v[:, 1] - v[:, 0],
                                         v[:, 2] - v[:, 0]), axis=1).sum()
    parts = sum(float(host(rules[s].weights_padded).sum())
                for s in ("phi<0", "phi>0"))
    assert abs(parts - area) <= TOL * area


def test_compound_and_union_rules(line_pair):
    """An OR selector over two level sets through runtime_quadratures: its
    signed blocks (each clause's parts, and minus those of their AND,
    re-marched against both level sets) equal to the reference's. The AND
    and OR rules of chip_smoke's two planes at n = 16, with the cells
    locate_entities gives, sum to the polygons' areas."""
    cdj, cdt = line_pair
    sel = "phi<0 or cap>0"
    got = ct.runtime_quadratures(cdt, [sel], 2)
    assert list(got) == [sel]
    hold_rules(cj.runtime_quadrature(cdj, sel, 2), got[sel])
    assert (host(got[sel].weights_padded) < 0).any()
    port = compound_numbers(ct, 16, "cpu")
    for key in ("and", "or"):
        assert port[f"{key}_parents"] > 0
        assert abs(port[f"{key}_total"] - port[f"{key}_polygon"]) <= \
            TOL * port[f"{key}_polygon"]


def _cut_mesh_arrays(cm):
    if cm.mesh is None:
        return None
    return (cm.mesh.vertices, cm.mesh.cells, cm.parent_index,
            cm.is_cut_cell)


def test_facet_cut_meshes():
    """Facet-hosted create_cut_mesh in 2D (exterior facets) and 3D (the
    sphere's skeleton): vertices, cells and parents exactly as the
    reference's."""
    cases = [("line", 4, lambda m: (m.exterior_facets, 1),
              (("phi<0", None), ("phi>0", "cut_only"))),
             ("sphere", 6, lambda m: (m.interior_facets, 2),
              (("phi<0", None), ("phi>=0", "full"), ("phi=0", None)))]
    for kind, n, pick, sels in cases:
        cdj, cdt = both(kind, n, pick)
        for sel, mode in sels:
            a = _cut_mesh_arrays(cj.create_cut_mesh(cdj, sel, mode))
            b = _cut_mesh_arrays(ct.create_cut_mesh(cdt, sel, mode))
            assert np.abs(a[0] - b[0]).max() <= TOL
            for x, y in zip(a[1:], b[1:]):
                assert np.array_equal(x, y)


def _forms(pkg):
    name = pkg.__name__
    return (importlib.import_module(name + ".fem"),
            importlib.import_module(name + ".forms.dsl"),
            importlib.import_module(name + ".forms.measure").Measure)


def test_runtime_ds_and_dS_integrals():
    """tests/test_cut_api_contracts.py's runtime ds and dS scalars (each
    the sum of its rule weights) and the DG1 jump matrix on a runtime dS
    measure: the 'phi<0' rules of the exterior and interior facets, the
    scalars and the matrix equal to the reference's, the matrix
    symmetric with constants in its kernel."""
    vals, mats, rules_of = {}, {}, {}
    for pkg in (cj, ct):
        fem, d, Measure = _forms(pkg)
        kw = {"dtype": torch.float64} if pkg is ct else {}
        mesh, (phi, _) = level_sets(pkg, "line", 4)
        for key, itype, facets in (("ds", "ds", mesh.exterior_facets),
                                   ("dS", "dS", mesh.interior_facets)):
            rules = pkg.runtime_quadrature(pkg.cut(phi, facets, 1), "phi<0",
                                           2)
            rules_of[pkg, key] = rules
            m = Measure(itype, domain=mesh, subdomain_data=rules)
            vals[pkg, key] = float(fem.assemble_scalar(fem.form(1.0 * m,
                                                                **kw)))
            if pkg is ct:
                assert abs(vals[pkg, key] - float(rules.weights_padded.sum())
                           ) <= TOL * vals[pkg, key]
        V = pkg.functionspace(mesh, ("DG", 1),
                              **({"device": "cpu"} if pkg is ct else {}))
        u, v = d.TrialFunction(V), d.TestFunction(V)
        a = d.jump(u) * d.jump(v) * m
        mats[pkg] = fem.assemble_matrix(fem.form(a, **kw)).to_scipy()
    for key in ("ds", "dS"):
        hold_rules(rules_of[cj, key], rules_of[ct, key])
        assert abs(vals[ct, key] - vals[cj, key]) <= TOL * vals[cj, key]
    A, B = mats[cj].toarray(), mats[ct].toarray()
    assert rel_err(A, B) <= TOL
    assert np.abs(B - B.T).max() <= TOL * np.abs(B).max()
    assert np.abs(B @ np.ones(len(B))).max() <= TOL * np.abs(B).max()


def test_error_contract(line_pair):
    """An unknown backend is a ValueError, as in the reference; so are the
    Saye backends on simplex host cells; cut meshes of compound selectors
    raise NotImplementedError; a side-aware field off a dS measure is a
    ValueError. A P2 level set on cut cells is cut on red-refined
    simplices (the line's area comes out exactly)."""
    cdj, cdt = line_pair
    for cd, pkg in ((cdj, cj), (cdt, ct)):
        with pytest.raises(ValueError, match="unknown backend"):
            pkg.runtime_quadrature(cd, "phi<0", 2, backend="nope")
        with pytest.raises(NotImplementedError):
            pkg.create_cut_mesh(cd, "phi<0 and cap<0")
    for backend in ("algoim", "algoim_general"):
        with pytest.raises(ValueError, match="quadrilateral/hexahedron"):
            ct.runtime_quadrature(cdt, "phi<0", 2, backend=backend)
    mesh = cdt.mesh
    V2 = ct.functionspace(mesh, ("Lagrange", 2), device="cpu")
    phi2 = ct.Function(V2, name="phi", dtype=torch.float64)
    phi2.interpolate(lambda x: x[1] - 0.26)
    cd2 = ct.cut(phi2)
    rules = ct.runtime_quadrature(cd2, "phi<0", 2)
    inside = ct.locate_entities(cd2, "phi<0")
    area = float(rules.weights_padded.sum()) + len(inside) / (2 * 4 ** 2)
    assert abs(area - 0.26) < TOL
    fem, d, Measure = _forms(ct)
    phi = cdt.level_sets[0]
    mu = ct.conormal(ct.normal(phi))
    dxg = Measure("dx", domain=mesh,
                  subdomain_data=ct.runtime_quadrature(cdt, "phi=0", 2))
    with pytest.raises(ValueError, match="side-aware"):
        fem.form(mu[0] * dxg, dtype=torch.float64)
