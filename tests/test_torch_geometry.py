"""The non-affine geometry map of cutfemx_tpu_torch against cutfemx_tpu,
in f64 on the CPU: jacobian, pushforward, pullback_newton, pullback and
physical_facet_normal on distorted quadrilaterals and hexahedra, a ghost-
penalty form on quads (its '-' side pulled back by Newton's map),
cut_function on the quad and hex backgrounds of
tests/test_cut_function_quadhex.py, the surface conormal on quads, and
locate_cells / evaluate_at_points and the distance module's point
evaluation on hexahedra.

Both packages take the same numpy inputs. Tolerances: maps and fields
1e-12 absolute, matrices 1e-12 relative to their largest entry, cut
function values 1e-9 against the exact linear field (the reference
test's), cell ids exactly."""


import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import cutfemx_tpu as cj  # noqa: E402
import cutfemx_tpu_torch as ct  # noqa: E402
from cutfemx_tpu import geometry as geo_j  # noqa: E402
from cutfemx_tpu_torch import geometry as geo_t  # noqa: E402
from chip_smoke import _sphere, ho_mesh_phi  # noqa: E402
from test_torch_core import host  # noqa: E402

TOL = 1e-12
F64 = torch.float64
UNIT = {"quadrilateral": np.array([[0, 0], [1, 0], [0, 1], [1, 1]], float),
        "hexahedron": np.array(list(np.ndindex(2, 2, 2)), float)[:, ::-1]}


def both(fn):
    return fn(cj, {}), fn(ct, {"device": "cpu"})


@pytest.mark.parametrize("cell", ["quadrilateral", "hexahedron"])
def test_geometry_maps_match(cell):
    rng = np.random.default_rng(1)
    coords = 2.0 * UNIT[cell] + 0.15 * rng.standard_normal(UNIT[cell].shape)
    pts = rng.random((9, coords.shape[1]))
    cj_, ct_ = jnp.asarray(coords), torch.as_tensor(coords)
    pj, pt = jnp.asarray(pts), torch.as_tensor(pts)
    J = host(geo_t.jacobian(cell, ct_, pt))
    assert np.abs(J - host(geo_j.jacobian(cell, cj_, pj))).max() < TOL
    x = geo_t.pushforward(cell, ct_, pt)
    assert np.abs(host(x) - host(geo_j.pushforward(cell, cj_, pj))).max() \
        < TOL
    xi = geo_t.pullback_newton(cell, ct_, x)
    assert np.abs(host(xi) - host(geo_j.pullback_newton(
        cell, cj_, jnp.asarray(host(x))))).max() < TOL
    assert np.abs(host(xi) - pts).max() < TOL
    assert torch.equal(geo_t.pullback(cell, ct_, x), xi)
    # vmapped over cells, as the form compiler and the fields call it
    batch = torch.stack([ct_, ct_ + 1.0])
    xs = torch.stack([x, x + 1.0])
    got = torch.func.vmap(lambda c, p: geo_t.pullback(cell, c, p))(batch, xs)
    assert np.abs(host(got) - pts[None]).max() < TOL
    K = np.linalg.inv(J)
    nref = geo_t.facet_reference_normals(cell)
    assert np.array_equal(nref, geo_j.facet_reference_normals(cell))
    assert np.array_equal(geo_t.reference_facet_map(cell),
                          geo_j.reference_facet_map(cell))
    for f in range(len(nref)):
        n_t = geo_t.physical_facet_normal(cell, torch.as_tensor(K), nref[f])
        n_j = geo_j.physical_facet_normal(cell, jnp.asarray(K),
                                          jnp.asarray(nref[f]))
        assert np.abs(host(n_t) - host(n_j)).max() < TOL


def test_ghost_penalty_on_quads_matches():
    """The ghost penalty of the bench form on the facets of a cut circle
    on n = 8 quads (Q1)."""
    def build(pkg, kw):
        import importlib
        d = importlib.import_module(pkg.__name__ + ".forms.dsl")
        Measure = importlib.import_module(
            pkg.__name__ + ".forms.measure").Measure
        mesh, phi = ho_mesh_phi(pkg, 8, "quadrilateral", 1, _sphere(0.55),
                                **kw)
        gp = pkg.ghost_penalty_facets(pkg.cut(phi), "phi<0")
        V = pkg.functionspace(mesh, ("Lagrange", 1), **kw)
        u, v = d.TrialFunction(V), d.TestFunction(V)
        nf, h = d.FacetNormal(mesh), d.CellDiameter(mesh)
        dS = Measure("dS", domain=mesh, subdomain_data=gp)
        a = 0.1 * d.avg(h) * d.inner(d.jump(d.grad(u), nf),
                                     d.jump(d.grad(v), nf)) * dS
        dtype = F64 if pkg is ct else np.float64
        A = pkg.fem.assemble_matrix(pkg.fem.form(a, dtype=dtype))
        return gp, A.to_scipy().toarray()

    (gpj, Aj), (gpt, At) = both(build)
    assert np.array_equal(gpj, gpt) and gpt.size
    assert np.abs(Aj - At).max() <= TOL * np.abs(Aj).max()
    assert np.abs(At @ np.ones(len(At))).max() <= TOL * np.abs(At).max()


@pytest.mark.parametrize("cell", ["quadrilateral", "hexahedron"])
def test_cut_function_on_quadhex_background(cell):
    """tests/test_cut_function_quadhex.py's inputs: a P1 field on the
    'phi<0' cut mesh (mode 'full') of the sphere r = 0.55."""
    n = 12 if cell == "quadrilateral" else 6

    def linear(x):
        if cell == "quadrilateral":
            return x[0] + 2 * x[1]
        return x[0] + 2 * x[1] - 0.5 * x[2]

    def run(pkg, kw):
        mesh, phi = ho_mesh_phi(pkg, n, cell, 1, _sphere(0.55), **kw)
        cm = pkg.create_cut_mesh(pkg.cut(phi), "phi<0", mode="full")
        V = pkg.functionspace(mesh, ("Lagrange", 1), **kw)
        u = pkg.Function(V, **({"dtype": F64} if kw else {}))
        u.interpolate(linear)
        return pkg.fem.cut_function(u, cm)

    uj, ut = both(run)
    mj, mt = uj.function_space.mesh, ut.function_space.mesh
    assert mt.num_cells > 0 and np.array_equal(mj.vertices, mt.vertices)
    assert np.array_equal(uj.function_space.dofmap, ut.function_space.dofmap)
    assert np.abs(host(ut.x) - host(uj.x)).max() < TOL
    assert np.abs(host(ut.x) - linear(mt.vertices.T)).max() < 1e-9
    assert ct.cut_function is ct.fem.cut_function


def test_conormal_on_quads_matches():
    """The conormal of a Q2 circle on the cut interior facets of n = 8
    quads, on both sides (the '-' side pulls the points back by Newton)."""
    def run(pkg, kw):
        mesh, phi = ho_mesh_phi(pkg, 8, "quadrilateral", 2, _sphere(0.55),
                                **kw)
        cd = pkg.cut(phi, entities=mesh.interior_facets, entity_dim=1)
        rules = pkg.runtime_quadrature(cd, "phi=0", 2)
        mu = pkg.conormal(pkg.normal(phi))
        return rules, [host(mu.evaluator(rules, s)) for s in "+-"]

    (rj, mj), (rt, mt) = both(run)
    assert np.array_equal(rj.parent_map, rt.parent_map) and rt.parent_map.size
    for a, b in zip(mj, mt):
        assert np.abs(a - b).max() < TOL
    assert np.abs(mt[0] + mt[1]).max() < 1e-10      # opposite on a facet


def test_point_location_and_evaluation_on_hexes():
    """locate_cells and evaluate_at_points of a Q2 field at points of
    n = 4 hexahedra, and the distance module's point evaluation."""
    from cutfemx_tpu import optimization as opt_j
    from cutfemx_tpu.distance import api as dist_j
    from cutfemx_tpu_torch import optimization as opt_t
    from cutfemx_tpu_torch.distance import api as dist_t
    rng = np.random.default_rng(2)
    pts = rng.uniform(-1.0, 1.0, (40, 3))

    def run(pkg, kw):
        mesh, f = ho_mesh_phi(pkg, 4, "hexahedron", 2,
                              lambda x: x[0] * x[1] + x[2] ** 2, **kw)
        opt = opt_t if pkg is ct else opt_j
        cells = opt.locate_cells(mesh, pts)
        vals = opt.evaluate_at_points(f, pts, cells)
        return mesh, f, cells, vals

    (mj, fj, cj_, vj), (mt, ft, ct_, vt) = both(run)
    assert np.array_equal(cj_, ct_)
    lo = mt.cell_vertex_coords[ct_].min(axis=1) - 1e-12
    hi = mt.cell_vertex_coords[ct_].max(axis=1) + 1e-12
    assert ((lo <= pts) & (pts <= hi)).all()
    assert np.abs(vt - vj).max() < TOL
    assert np.abs(vt - (pts[:, 0] * pts[:, 1] + pts[:, 2] ** 2)).max() < TOL
    dj = dist_j._eval_function_at(fj, cj_, pts)
    dt = dist_t._eval_function_at(ft, ct_, torch.as_tensor(pts))
    assert np.abs(host(dt) - np.asarray(dj)).max() < TOL
