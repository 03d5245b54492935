"""Level-set reinitialization, normal-velocity extension, the clustered
winding numbers and mesh refinement of cutfemx_tpu_torch against
cutfemx_tpu, in f64 on the CPU. Values are held to 1e-12 absolute; meshes
from refinement must be identical."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import cutfemx_tpu as cj  # noqa: E402
import cutfemx_tpu_torch as ct  # noqa: E402
from cutfemx_tpu import distance as dj  # noqa: E402
from cutfemx_tpu import refine as refine_j  # noqa: E402
from cutfemx_tpu.distance import winding as wind_j  # noqa: E402
from cutfemx_tpu_torch import distance as dt  # noqa: E402
from cutfemx_tpu_torch import refine as refine_t  # noqa: E402
from cutfemx_tpu_torch.demos.demo_stl_distance import \
    _make_sphere_stl  # noqa: E402
from cutfemx_tpu_torch.distance import winding as wind_t  # noqa: E402

TOL = 1e-12
PKGS = ((cj, dj, {}), (ct, dt, {"device": "cpu"}))


def host(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def level_set(pkg, kw, n, degree, fn):
    mesh = pkg.mesh.create_rectangle((-1, -1), (1, 1), (n, n))
    V = pkg.functionspace(mesh, ("Lagrange", degree), **kw)
    phi = pkg.Function(V, name="phi",
                       **({"dtype": torch.float64} if kw else {}))
    phi.interpolate(fn)
    return mesh, V, phi


@pytest.mark.parametrize("degree,n", [(1, 24), (2, 12)])
def test_reinitialize_matches_reference(degree, n):
    """reinitialize of the parabola |x|^2 - 1/4 (P1 at n = 24, P2 at
    n = 12): the reference's values within 1e-12, the same space and
    dtype, and within one mesh width of |x| - 1/2."""
    out = {}
    for pkg, dist, kw in PKGS:
        mesh, V, phi = level_set(pkg, kw, n, degree,
                                 lambda x: x[0] ** 2 + x[1] ** 2 - 0.25)
        res = dist.reinitialize(phi)
        assert res.function_space is V
        out[pkg] = host(res.x)
    assert out[ct].dtype == np.float64
    assert np.abs(out[cj] - out[ct]).max() < TOL
    exact = np.linalg.norm(V.dof_coordinates, axis=1) - 0.5
    assert np.abs(out[ct] - exact).max() < 2.0 / n


def test_reinitialize_from_facets_matches_reference():
    """Distance to the facets of the left edge, unsigned (from a mesh)
    and signed by a level set (from a Function)."""
    out = {}
    for pkg, dist, kw in PKGS:
        mesh, V, phi = level_set(pkg, kw, 16, 1, lambda x: x[0] - 0.3)
        mid = mesh.midpoints(mesh.tdim - 1, mesh.exterior_facets)
        left = mesh.exterior_facets[np.abs(mid[:, 0] + 1.0) < 1e-12]
        kwd = {"device": "cpu"} if kw else {}
        out[pkg] = (host(dist.reinitialize_from_facets(mesh, left,
                                                       **kwd).x),
                    host(dist.reinitialize_from_facets(phi, left).x))
    for a, b in zip(out[cj], out[ct]):
        assert np.abs(a - b).max() < TOL
    exact = mesh.vertices[:, 0] + 1.0
    assert np.abs(out[ct][0] - exact).max() < 1e-12
    assert (out[ct][1][mesh.vertices[:, 0] < 0.2] <= 0).all()


def test_extend_normal_velocity_matches_reference():
    """A varying speed 1 + x0 (1 - x1) off the circle r = 0.5 (n = 24), on
    the P1 carrier and through target_space=P2: speed and signed distance
    within 1e-12; the velocity within 1e-12 away from the circle's
    centre, where the transported normal cancels to rounding noise and
    its direction is undefined (|x| > 0.1)."""
    out = {}
    for pkg, dist, kw in PKGS:
        mesh, V, phi = level_set(
            pkg, kw, 24, 1, lambda x: np.sqrt(x[0] ** 2 + x[1] ** 2) - 0.5)
        speed = pkg.Function(V, **({"dtype": torch.float64} if kw else {}))
        speed.interpolate(lambda x: 1.0 + x[0] * (1.0 - x[1]))
        V2 = pkg.functionspace(mesh, ("Lagrange", 2), **kw)
        r1 = dist.extend_normal_velocity(phi, speed)
        r2 = dist.extend_normal_velocity(phi, speed, target_space=V2)
        assert r2.speed.function_space is V2
        assert r2.signed_distance.function_space is V2
        assert r2.velocity.function_space.degree == 2
        out[pkg] = [host(f.x) for r in (r1, r2)
                    for f in (r.speed, r.velocity, r.signed_distance)]
        out[pkg, "xy"] = (V.dof_coordinates, V2.dof_coordinates)
    x1, x2 = out[ct, "xy"]
    away = [np.repeat(np.linalg.norm(x, axis=1) > 0.1, 2) for x in (x1, x2)]
    for i, (a, b) in enumerate(zip(out[cj], out[ct])):
        if i % 3 == 1:
            a, b = a[away[i // 3]], b[away[i // 3]]
        assert np.abs(a - b).max() < TOL, i
    # the extended speed is constant along the normals near the circle
    s, d = out[ct][0], out[ct][2]
    on = np.abs(d) < 0.1
    assert np.abs(s[on] - (1.0 + x1[on, 0] / np.linalg.norm(x1[on], axis=1)
                           * 0.5 * (1.0 - x1[on, 1] / np.linalg.norm(
                               x1[on], axis=1) * 0.5))).max() < 0.12


def test_clustered_winding_matches_reference(tmp_path):
    """A cube-sphere of 9,408 triangles (over 4,096: the clustered route):
    the same clusters (Morton order, dipoles, radii) and winding numbers
    within 1e-12 at random points in [-1, 1]^3."""
    path = tmp_path / "sphere.stl"
    _make_sphere_stl(path, r=0.5, n=28)
    soup = dt.read_stl(path)
    assert soup.num_triangles > 4096
    cl_j = wind_j.build_winding_clusters(soup)
    cl_t = wind_t.build_winding_clusters(soup)
    for k in ("tri", "dipole", "centroid", "radius"):
        assert np.array_equal(getattr(cl_j, k), getattr(cl_t, k)), k
    pts = np.random.default_rng(3).uniform(-1, 1, (600, 3))
    w_j = wind_j.winding_numbers(pts, cl_j, chunk=256)
    w_t = wind_t.winding_numbers(pts, cl_t, chunk=256, device="cpu")
    assert np.abs(w_j - w_t).max() < TOL
    inside = np.linalg.norm(pts, axis=1) < 0.5
    assert np.array_equal(w_t > 0.5, inside)


def test_refine_marked_matches_reference():
    """refine_marked (red-green on triangles, longest-edge bisection on
    tets) and refine_uniform: the same vertices and cells as the
    reference."""
    cases = [(lambda p: p.mesh.create_unit_square(6), np.arange(0, 40, 3)),
             (lambda p: p.mesh.create_unit_cube(3), np.arange(0, 30, 4))]
    for make, edges in cases:
        mj, mt = make(cj), make(ct)
        for fj, ft in ((refine_j.refine_marked(mj, edges),
                        refine_t.refine_marked(mt, edges)),
                       (refine_j.refine_uniform(mj),
                        refine_t.refine_uniform(mt))):
            assert np.array_equal(fj.vertices, ft.vertices)
            assert np.array_equal(fj.cells, ft.cells)
            assert ft.num_cells > mt.num_cells
