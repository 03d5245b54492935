"""The signed-distance path of cutfemx_tpu_torch against cutfemx_tpu, in
f64 on the CPU: the native geometry library (and its source copy), STL
input and output, orient_surface, the Eikonal FIM with payload transport
(with the near field held fixed through ``interop``), ``from_stl`` in the
three sign modes and ``create_cut_mesh``. Distances are held to 1e-12
absolute, FIM sweep counts and signs exactly."""

import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import cutfemx_tpu as cj  # noqa: E402
import cutfemx_tpu_torch as ct  # noqa: E402
from cutfemx_tpu import distance as dj  # noqa: E402
from cutfemx_tpu import native as native_j  # noqa: E402
from cutfemx_tpu.distance import api as api_j  # noqa: E402
from cutfemx_tpu.distance import stl as stl_j  # noqa: E402
from cutfemx_tpu_torch import distance as dt  # noqa: E402
from cutfemx_tpu_torch import interop, native  # noqa: E402
from cutfemx_tpu_torch.demos.demo_stl_distance import \
    _make_sphere_stl  # noqa: E402
from cutfemx_tpu_torch.distance import api as api_t  # noqa: E402
from cutfemx_tpu_torch.distance import stl as stl_t  # noqa: E402

TOL = 1e-12          # distances and payloads, absolute
MODES = ("component_anchor", "local_normal_band", "winding_number")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def host(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


@pytest.fixture(scope="module")
def ref_native():
    """The reference's native library, built: its loader builds in place
    and gives up at the first failed load, which a concurrent first build
    by another test process can cause; wait for that build instead."""
    for _ in range(60):
        if native_j.get_lib() is not None:
            return native_j
        native_j._TRIED = False
        time.sleep(1.0)
    pytest.fail("the reference's native library did not build")


@pytest.fixture(scope="module")
def sphere_stl(tmp_path_factory):
    path = tmp_path_factory.mktemp("stl") / "sphere.stl"
    _make_sphere_stl(path, r=0.5, n=6)
    return path


def test_native_library_matches_reference(ref_native):
    """The source is a copy of the reference's: the same code line for
    line (two provenance comments name the upstream files by a shorter
    path); every entry point gives the reference's result on the same
    random inputs, and a failed build raises with the compiler's
    messages."""
    def code(path):
        with open(path) as fh:
            return [line.split("//")[0].rstrip() for line in fh]

    ours = code(os.path.join(ROOT, "cutfemx_tpu_torch", "csrc",
                             "geometry_kernels.cpp"))
    assert ours == code(os.path.join(ROOT, "cutfemx_tpu", "native",
                                     "geometry_kernels.cpp"))
    assert len([line for line in ours if line]) > 300
    rng = np.random.default_rng(0)
    a, b, c, d = (rng.standard_normal((64, 3)) for _ in range(4))
    assert native.orient3d(a[0], b[0], c[0], d[0]) == \
        ref_native.orient3d(a[0], b[0], c[0], d[0])
    assert np.array_equal(native.orient3d_batch(a, b, c, d),
                          ref_native.orient3d_batch(a, b, c, d))
    raw = np.frombuffer(
        np.concatenate([rng.standard_normal((40, 12)).astype("<f4")
                        .view(np.uint8).reshape(40, 48),
                        np.zeros((40, 2), np.uint8)], axis=1).tobytes(),
        np.uint8)
    for x, y in zip(native.parse_stl_records(raw),
                    ref_native.parse_stl_records(raw)):
        assert np.array_equal(x, y)
    cells = rng.uniform(0, 1, (200, 4, 3))
    tris = rng.uniform(0, 1, (200, 3, 3)) * 0.6 + 0.2
    assert np.array_equal(native.tri_cell_overlap(cells, tris),
                          ref_native.tri_cell_overlap(cells, tris))
    t1 = rng.uniform(0, 1, (300, 3, 3))
    t2 = rng.uniform(0, 1, (300, 3, 3))
    got = native.tri_tri_isect_batch(t1, t2)
    assert np.array_equal(got, ref_native.tri_tri_isect_batch(t1, t2))
    assert 0 < got.sum() < len(got)
    segs = rng.uniform(0, 1, (300, 2, 3))
    got = native.seg_tri_isect_batch(segs, t2)
    assert np.array_equal(got, ref_native.seg_tri_isect_batch(segs, t2))
    assert 0 < got.sum() < len(got)
    # no silent fallback: a source that does not compile raises
    old = native._SRC, native._lib
    bad = os.path.join(ROOT, "build", "cutfemx_tpu_torch", "bad_src.cpp")
    os.makedirs(os.path.dirname(bad), exist_ok=True)
    with open(bad, "w") as fh:
        fh.write("this is not C++\n")
    try:
        native._SRC, native._lib = bad, None
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            native.build()
    finally:
        native._SRC, native._lib = old
        os.remove(bad)


def test_stl_io_and_orient_surface(sphere_stl, tmp_path):
    """Binary and ASCII reading, the writer's round trip, the welded soup
    and orient_surface on a soup with flipped triangles: the same arrays
    and diagnostics as the reference."""
    sj, st = dj.read_stl(sphere_stl), dt.read_stl(sphere_stl)
    for k in ("X", "tri", "N", "tri_gid"):
        assert np.array_equal(getattr(sj, k), getattr(st, k)), k
    out_j, out_t = tmp_path / "ref.stl", tmp_path / "port.stl"
    stl_j.write_stl(out_j, sj)
    stl_t.write_stl(out_t, st)
    assert out_t.read_bytes() == out_j.read_bytes()
    again = dt.read_stl(out_t)
    for k in ("X", "tri", "N"):
        assert np.array_equal(getattr(again, k), getattr(st, k)), k
    ascii_path = tmp_path / "tri.stl"
    ascii_path.write_text(
        "solid t\n facet normal 0 0 1\n  outer loop\n   vertex 0 0 0\n"
        "   vertex 1 0 0\n   vertex 0 1 0\n  endloop\n endfacet\n"
        " facet normal 0 0 0\n  outer loop\n   vertex 1 0 0\n"
        "   vertex 1 1 0\n   vertex 0 1 0\n  endloop\n endfacet\nendsolid\n")
    aj, at = dj.read_stl(ascii_path), dt.read_stl(ascii_path)
    for k in ("X", "tri", "N"):
        assert np.array_equal(getattr(aj, k), getattr(at, k)), k
    for got, want in zip(dt.stl_bbox(sphere_stl), dj.stl_bbox(sphere_stl)):
        assert np.array_equal(got, want)
    # flip every third triangle, then re-orient
    tri = st.tri.copy()
    tri[::3] = tri[::3][:, [0, 2, 1]]
    soup_j = stl_j.TriSoup(st.X, tri, st.N, st.tri_gid)
    soup_t = interop.trisoup_from_reference(st.X, tri, st.N, st.tri_gid)
    (oj, diag_j), (ot, diag_t) = (stl_j.orient_surface(soup_j),
                                  stl_t.orient_surface(soup_t))
    assert np.array_equal(oj.tri, ot.tri)
    assert np.abs(oj.N - ot.N).max() == 0.0
    for k in ("n_components", "n_flipped", "n_boundary_edges",
              "n_nonmanifold_edges"):
        assert getattr(diag_j, k) == getattr(diag_t, k), k
    assert diag_t.n_components == 1 and diag_t.n_flipped > 0


@pytest.mark.parametrize("dim", [2, 3])
def test_eikonal_point_source_matches_reference(dim):
    """A point source with a random 3-vector payload (2D n = 24, 3D
    n = 8): d and the payload within 1e-12, the same sweep count."""
    n = 24 if dim == 2 else 8
    lo, hi = (-1.0,) * dim, (1.0,) * dim
    meshes = [pkg.mesh.create_rectangle(lo, hi, (n, n)) if dim == 2
              else pkg.mesh.create_box(lo, hi, (n, n, n))
              for pkg in (cj, ct)]
    nv = meshes[0].num_vertices
    d0 = np.full(nv, 1e30)
    frozen = np.zeros(nv, bool)
    src = np.argmin(np.linalg.norm(meshes[0].vertices, axis=1))
    d0[src], frozen[src] = 0.0, True
    pay = np.random.default_rng(dim).standard_normal((nv, 3))
    d_j, p_j, it_j = dj.eikonal_solve(meshes[0], d0, frozen, payload=pay)
    d_t, p_t, it_t = dt.eikonal_solve(meshes[1], d0, frozen, payload=pay,
                                      device="cpu")
    assert it_t == it_j and it_t > 1
    assert np.abs(host(d_j) - host(d_t)).max() < TOL
    assert np.abs(host(p_j) - host(p_t)).max() < TOL
    r = np.linalg.norm(meshes[0].vertices - meshes[0].vertices[src], axis=1)
    # first-order FIM: within one mesh width of the exact distance
    assert np.abs(host(d_t) - r).max() < 2.0 / n


def test_from_stl_three_modes_match_reference(sphere_stl):
    """The sphere STL (r = 0.5, 432 triangles) on a 10^3 box: the
    cell-triangle map equals the reference's; with the reference's soup
    and map carried across (interop) the near field and the FIM agree;
    from_stl in every sign mode gives the reference's signs exactly and
    its distances within 1e-12."""
    mesh_j = cj.mesh.create_box((-1, -1, -1), (1, 1, 1), (10, 10, 10))
    mesh_t = ct.mesh.create_box((-1, -1, -1), (1, 1, 1), (10, 10, 10))
    soup_j = dj.read_stl(sphere_stl)
    cm_j = dj.build_cell_triangle_map(mesh_j, soup_j)
    cm_t = dt.build_cell_triangle_map(mesh_t, dt.read_stl(sphere_stl))
    assert np.array_equal(cm_j.offsets, cm_t.offsets)
    assert np.array_equal(cm_j.triangles, cm_t.triangles)
    soup_x = interop.trisoup_from_reference(soup_j.X, soup_j.tri, soup_j.N,
                                            soup_j.tri_gid)
    cm_x = interop.cell_triangle_map_from_reference(cm_j.offsets,
                                                    cm_j.triangles)
    near_j = api_j._near_field(mesh_j, soup_j, cm_j)
    near_t = api_t._near_field(mesh_t, soup_x, cm_x, "cpu")
    assert np.array_equal(near_j[1], near_t[1])
    for a, b in zip(near_j, near_t):
        assert np.abs(np.where(np.isfinite(a), a, 0)
                      - np.where(np.isfinite(b), b, 0)).max() < TOL
    d_j, _, it_j = dj.eikonal_solve(mesh_j, near_j[0], near_j[1])
    d_t, _, it_t = dt.eikonal_solve(mesh_t, near_j[0], near_j[1],
                                    device="cpu")
    assert it_t == it_j and np.abs(host(d_j) - host(d_t)).max() < TOL
    exact = np.linalg.norm(mesh_t.vertices, axis=1) - 0.5
    for mode in MODES:
        fj = dj.from_stl(mesh_j, sphere_stl, sign_mode=mode)
        ft = dt.from_stl(mesh_t, sphere_stl, sign_mode=mode, device="cpu")
        vj, vt = host(fj.x), host(ft.x)
        assert ft.x.dtype == torch.float64
        assert np.array_equal(np.sign(vj), np.sign(vt)), mode
        assert np.abs(vj - vt).max() < TOL, mode
        assert np.abs(vt - exact).max() < 0.15, mode


def test_create_cut_mesh_matches_reference():
    """create_cut_mesh of a P1 circle on a 12^2 square: the interface
    ('phi=0', cut_only) and the inside ('phi<0', full and cut_only) give
    the reference's pieces, parents and cut flags; a facet-hosted 2D
    interface (a point set) and mode='full' on an interface raise."""
    out = {}
    for pkg, kw in ((cj, {}), (ct, {"device": "cpu"})):
        mesh = pkg.mesh.create_rectangle((-1, -1), (1, 1), (12, 12))
        phi = pkg.Function(pkg.functionspace(mesh, ("Lagrange", 1), **kw),
                           **({"dtype": torch.float64} if kw else {}))
        phi.interpolate(lambda x: np.sqrt(x[0] ** 2 + x[1] ** 2) - 0.55)
        cd = pkg.cut(phi)
        out[pkg] = [pkg.create_cut_mesh(cd, sel, mode=mode)
                    for sel, mode in (("phi=0", "cut_only"),
                                      ("phi<0", "full"),
                                      ("phi>0", "cut_only"),
                                      ("phi<0", None))]
        out[pkg, "cd"] = cd
    for cmj, cmt in zip(out[cj], out[ct]):
        assert np.array_equal(cmj.parent_index, cmt.parent_index)
        assert np.array_equal(cmj.is_cut_cell, cmt.is_cut_cell)
        assert np.array_equal(cmj.mesh.cells, cmt.mesh.cells)
        assert np.abs(cmj.mesh.vertices - cmt.mesh.vertices).max() < TOL
        assert cmj.mesh.cell_type == cmt.mesh.cell_type
    assert out[ct][0].mesh.cell_type == "interval"
    assert out[ct][1].is_cut_cell.min() == 0
    with pytest.raises(ValueError, match="not valid for interface"):
        ct.create_cut_mesh(out[ct, "cd"], "phi=0", mode="full")
    mesh = ct.mesh.create_rectangle((-1, -1), (1, 1), (4, 4))
    phi = ct.Function(ct.functionspace(mesh, ("Lagrange", 1), device="cpu"))
    phi.interpolate(lambda x: x[0] - 0.1)
    cdf = ct.cut(phi, entities=np.arange(mesh.num_facets), entity_dim=1)
    with pytest.raises(NotImplementedError, match="point sets"):
        ct.create_cut_mesh(cdf, "phi=0")


# -- the JAX-CPU values chip_smoke.py pins (PERF.md section 4) ---------------


def value_summary(vals):
    """What chip_smoke.py holds a field against: its sum, sum of squares,
    min, max and nine samples at evenly spaced indices."""
    vals = np.asarray(vals, np.float64)
    idx = np.linspace(0, len(vals) - 1, 9).astype(int)
    return dict(n_values=len(vals), sum=float(vals.sum()),
                sumsq=float((vals ** 2).sum()), min=float(vals.min()),
                max=float(vals.max()), samples=[float(v) for v in vals[idx]],
                negative=int((vals < 0).sum()))


def reference_distance_parity(tmp_dir):
    """The reference's numbers of chip_smoke.py's distance_parity phase:
    the demo's sphere STL (r = 0.5, 12 x 12 per cube face) on create_box
    [-1, 1]^3 at n = 16 by compute_signed_distance in each sign mode (the
    from_stl path without the read), the 2D point source of
    tests/test_distance.py (n = 40), and demo_reinit at n = 48."""
    from cutfemx_tpu.distance.fim import FMMOptions
    path = os.path.join(tmp_dir, "sphere.stl")
    _make_sphere_stl(path)
    mesh = cj.mesh.create_box((-1, -1, -1), (1, 1, 1), (16, 16, 16))
    soup = dj.read_stl(path)
    ctmap = dj.build_cell_triangle_map(mesh, soup)
    out = {"sphere": {}}
    for mode in MODES:
        d, its = dj.compute_signed_distance(mesh, soup, ctmap,
                                            sign_mode=mode)
        out["sphere"][mode] = dict(sweeps=its, **value_summary(d))
    m2 = cj.mesh.create_rectangle((-1, -1), (1, 1), (40, 40))
    r = np.linalg.norm(m2.vertices, axis=1)
    frozen = r < 0.15
    d, _, its = dj.eikonal_solve(m2, np.where(frozen, r, FMMOptions().inf),
                                 frozen)
    out["point_source"] = dict(sweeps=its, **value_summary(host(d)))
    m3 = cj.mesh.create_rectangle((-1, -1), (1, 1), (48, 48))
    phi = cj.Function(cj.functionspace(m3, ("Lagrange", 1)))
    phi.interpolate(lambda x: (x[0] ** 2 + x[1] ** 2) - 0.25)
    out["reinit"] = value_summary(host(dj.reinitialize(phi).x))
    return out
