"""Mesh IO, the setup cache, the petsc layer and the profiling utilities
of cutfemx_tpu_torch against cutfemx_tpu on the CPU: gmsh 2.2 and 4.1
files, the XDMF round trip, VTU output (background and cut mesh), the
setup cache (the port's files read by both packages, exact arrays; the
bench step driven from loaded objects equal to the built step bitwise),
the host-CSR petsc surface as tests/test_petsc_layer.py runs it, and the
Timer / ProfileWriter utilities.

Files written by one package are read by both; arrays are held exactly
and the writers' text byte for byte, except for fields the port computes
itself (cut meshes), which are held to 1e-12."""

import os
import xml.etree.ElementTree as ET

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import cutfemx_tpu as cj  # noqa: E402
import cutfemx_tpu_torch as ct  # noqa: E402
from cutfemx_tpu import io as io_j, petsc as petsc_j  # noqa: E402
from cutfemx_tpu_torch import io as io_t, petsc as petsc_t  # noqa: E402
from test_io import MSH22, MSH41  # noqa: E402
from test_torch_core import host  # noqa: E402

F64 = torch.float64


def _same_mesh(a, b):
    assert a.cell_type == b.cell_type and a.gdim == b.gdim
    assert np.array_equal(a.vertices, b.vertices)
    assert np.array_equal(a.cells, b.cells)


def test_read_gmsh_matches_reference(tmp_path):
    """Both formats: mesh, cell and facet tags exactly the reference's;
    the imported mesh drives assembly (the stiffness annihilates
    constants)."""
    from cutfemx_tpu_torch.forms.dsl import (TestFunction, TrialFunction,
                                             grad, inner)
    for name, text in (("v22.msh", MSH22), ("v41.msh", MSH41)):
        p = tmp_path / name
        p.write_text(text)
        (mj, cj_tags, fj), (mt, c_tags, ft) = (io_j.read_gmsh(p),
                                               io_t.read_gmsh(p))
        _same_mesh(mj, mt)
        for a, b in ((cj_tags, c_tags), (fj, ft)):
            assert a.dim == b.dim
            assert np.array_equal(a.indices, b.indices)
            assert np.array_equal(a.values, b.values)
        assert np.array_equal(c_tags.values, [7, 7])
        V = ct.functionspace(mt, ("Lagrange", 1), device="cpu")
        u, v = TrialFunction(V), TestFunction(V)
        A = ct.fem.assemble_matrix(ct.fem.form(
            inner(grad(u), grad(v)) * ct.Measure("dx", domain=mt),
            dtype=F64))
        assert np.abs(A.to_scipy() @ np.ones(V.dim)).max() < 1e-12
    assert np.array_equal(io_t.read_gmsh(tmp_path / "v22.msh")[2].find(5),
                          io_j.read_gmsh(tmp_path / "v22.msh")[2].find(5))


def test_xdmf_round_trip_matches_reference(tmp_path):
    """A triangle mesh with a scalar and a vector field (tensors on the
    port's side) and a hexahedral mesh: the port's file equals the
    reference's, and both packages read it back exactly."""
    for cell, make in (("triangle", lambda pkg: pkg.mesh.create_rectangle(
            (0., 0.), (1., 2.), (3, 4), "triangle")),
            ("hexahedron", lambda pkg: pkg.mesh.create_box(
                (0., 0., 0.), (1., 1., 1.), (2, 2, 2), "hexahedron"))):
        mt, mj = make(ct), make(cj)
        f = np.sin(mt.vertices[:, 0]) + mt.vertices[:, 1]
        fields = {"f": f, "v": np.stack([f, 2 * f], axis=1)}
        pt, pj = tmp_path / f"t_{cell}.xdmf", tmp_path / f"j_{cell}.xdmf"
        io_t.write_xdmf(pt, mt, point_data={
            k: torch.as_tensor(a) for k, a in fields.items()})
        io_j.write_xdmf(pj, mj, point_data=fields)
        assert pt.read_text() == pj.read_text()
        (m1, d1), (m2, d2) = io_t.read_xdmf(pt), io_j.read_xdmf(pt)
        _same_mesh(m1, m2)
        assert np.array_equal(m1.cells, mt.cells)
        assert np.allclose(m1.vertices, mt.vertices, rtol=1e-11, atol=0)
        assert d1.keys() == d2.keys() == fields.keys()
        for k in fields:
            assert np.array_equal(d1[k], d2[k])
            assert np.allclose(d1[k], fields[k], rtol=1e-11, atol=0)


def test_vtu_and_cut_mesh_match_reference(tmp_path):
    """test_coverage_gaps.py::test_vtu_output in both packages: the
    background file byte for byte, the cut mesh's (cut_function onto it)
    parsed arrays to 1e-12, and valid XML with the cut cell data."""
    out = {}
    for pkg, io, kw in ((cj, io_j, ({}, {})),
                        (ct, io_t, ({"device": "cpu"}, {"dtype": F64}))):
        mesh = pkg.mesh.create_rectangle((-1, -1), (1, 1), (8, 8))
        V = pkg.functionspace(mesh, ("Lagrange", 1), **kw[0])
        phi = pkg.Function(V, name="phi", **kw[1])
        phi.interpolate(lambda x: np.sqrt(x[0] ** 2 + x[1] ** 2) - 0.5)
        cm = pkg.create_cut_mesh(pkg.cut(phi), "phi<0", mode="full")
        p1, p2 = tmp_path / f"{pkg.__name__}_bg.vtu", \
            tmp_path / f"{pkg.__name__}_cut.vtu"
        io.write_vtu(p1, mesh,
                     point_data={"phi": phi.x[:mesh.num_vertices]})
        io.write_cut_mesh(p2, cm, [phi])
        out[pkg] = (p1.read_text(), p2)
    assert out[ct][0] == out[cj][0]
    arrays = []
    for pkg in (cj, ct):
        root = ET.parse(out[pkg][1]).getroot()
        assert root.tag == "VTKFile"
        arrays.append({a.get("Name", "points"): np.fromstring(
            a.text, sep=" ") for a in root.iter("DataArray")})
    assert set(arrays[1]) >= {"parent_index", "is_cut_cell", "phi",
                              "connectivity"}
    for k, a in arrays[0].items():
        assert a.shape == arrays[1][k].shape, k
        assert np.abs(a - arrays[1][k]).max() <= 1e-12 * max(
            1.0, np.abs(a).max()), k


def _cached_box(path):
    """tests/test_setup_cache.py's fixture in the port: a 6^3 box, P1
    level set and P2 space, facets and edges built, saved by the port."""
    mesh = ct.mesh.create_box((-1, -1, -1), (1, 1, 1), (6, 6, 6))
    Vphi = ct.functionspace(mesh, ("Lagrange", 1), device="cpu")
    V = ct.functionspace(mesh, ("Lagrange", 2), device="cpu")
    _ = mesh.facets, mesh.edges, Vphi.dof_coordinates
    io_t.save_setup_cache(path, mesh, [Vphi, V])
    return mesh, Vphi, V


def test_setup_cache_round_trip_matches_reference(tmp_path):
    """The port's cache read by both packages: every restored array
    equals the built one; the spaces land on the requested device (the
    card by default); a missing or foreign-version cache gives None."""
    import json
    path = str(tmp_path / "setup")
    mesh, Vphi, V = _cached_box(path)
    (m_t, sp_t), (m_j, sp_j) = (io_t.load_setup_cache(path, device="cpu"),
                                io_j.load_setup_cache(path))
    for m in (m_t, m_j):
        _same_mesh(m, mesh)
        assert m._lattice == mesh._lattice
        for k in ("edges", "cell_edges", "facets", "cell_facets",
                  "facet_cells", "facet_local_index"):
            assert k in m._cache and np.array_equal(m._cache[k],
                                                    getattr(mesh, k)), k
    for W_t, W_j, W in zip(sp_t, sp_j, (Vphi, V)):
        assert W_t.device == torch.device("cpu")
        for attr in ("dofmap", "dof_coordinates"):
            assert np.array_equal(getattr(W_t, attr), getattr(W, attr))
            assert np.array_equal(getattr(W_j, attr), getattr(W, attr))
        assert W_t.dim == W_j.dim == W.dim
        assert (W_t.family, W_t.degree, W_t.bs) == (W.family, W.degree, 1)
    assert io_t.load_setup_cache(path)[1][1].device.type == "cuda"
    assert io_t.load_setup_cache(str(tmp_path / "nope")) is None
    meta = os.path.join(path, "meta.json")
    with open(meta) as f:
        m = json.load(f)
    m["version"] = 2
    with open(meta, "w") as f:
        json.dump(m, f)
    assert io_t.load_setup_cache(path, device="cpu") is None


def test_step_from_loaded_objects_equals_built(tmp_path):
    """bench.py's step (chip_smoke.pipeline: the Nitsche + ghost-penalty
    forms, StencilCutOperator, precond='pallas', f64, n = 8) on objects
    loaded from the port's cache equals the step on the built objects
    bitwise; the loaded level set and load vector too."""
    from chip_smoke import _sphere, pipeline, setup
    mesh, phi, V = setup(ct, 8, "cpu", F64)
    path = str(tmp_path / "setup")
    io_t.save_setup_cache(path, mesh, [phi.function_space, V])
    m2, (Vphi2, V2) = io_t.load_setup_cache(path, device="cpu")
    phi2 = ct.Function(Vphi2, name="phi", dtype=F64)
    phi2.interpolate(_sphere(0.46))
    assert torch.equal(phi2.x, phi.x)
    runs = [pipeline(ct, m, p, W, F64, rtol=1e-9, precond="pallas")
            for m, p, W in ((mesh, phi, V), (m2, phi2, V2))]
    assert runs[0]["its"] == runs[1]["its"] > 0
    assert torch.equal(runs[0]["b"], runs[1]["b"])
    assert torch.equal(runs[0]["x"], runs[1]["x"])


def _petsc_problem(pkg, degree=1):
    """test_petsc_layer.py's cut problem: a disk of radius 0.3 on the
    8 x 8 unit square, (grad u, grad v) + (u, v) over it."""
    kw, fkw, dkw = ({}, {}, {}) if pkg is cj else (
        {"device": "cpu"}, {"dtype": F64}, {"dtype": F64})
    d = pkg.ufl
    mesh = pkg.mesh.create_unit_square(8)
    V = pkg.functionspace(mesh, ("Lagrange", degree), **kw)
    phi = pkg.Function(pkg.functionspace(mesh, ("Lagrange", 1), **kw),
                       **fkw)
    phi.interpolate(lambda x: np.sqrt((x[0] - .5) ** 2 + (x[1] - .5) ** 2)
                    - 0.3)
    cd = pkg.cut(phi)
    dxo = pkg.Measure("dx", domain=mesh, subdomain_data=[
        pkg.locate_entities(cd, "phi<0"),
        pkg.runtime_quadrature(cd, "phi<0", 2 * degree)])
    u, v = d.TrialFunction(V), d.TestFunction(V)
    a = pkg.fem.form((d.inner(d.grad(u), d.grad(v)) + u * v) * dxo, **dkw)
    L = pkg.fem.form(1.0 * v * dxo, **dkw)
    return V, a, L, pkg.fem.active_domain(a)


def test_petsc_layer_matches_reference():
    """tests/test_petsc_layer.py's contracts on the port, each against the
    reference (1e-13): petsc assembly equals fem's exactly; both
    deactivate_outside signatures with their TypeErrors; zero_rows;
    block deactivation and zero_block_rows; nest assembly equals the
    monolithic matrix; create_vector; to_petsc without petsc4py."""
    import scipy.sparse as sps
    res = {}
    for pkg, petsc in ((cj, petsc_j), (ct, petsc_t)):
        V, a, L, dom = _petsc_problem(pkg)
        A = petsc.assemble_matrix(a)
        assert abs(A.to_scipy() - pkg.fem.assemble_matrix(a).to_scipy()
                   ).max() == 0
        b = petsc.assemble_vector(L)
        assert isinstance(b, np.ndarray)
        assert np.array_equal(b, host(pkg.fem.assemble_vector(L)))
        assert petsc.deactivate_outside(A, dom, diagonal=3.0) is dom
        A2, b2 = petsc.assemble_matrix(a), np.ones(V.dim)
        petsc.deactivate_outside(A2, b2, dom, diagonal=1.0, rhs_value=7.0)
        with pytest.raises(TypeError):
            petsc.deactivate_outside(A2, dom, dom)
        with pytest.raises(TypeError):
            petsc.deactivate_outside(A2, b2, None)
        A3 = petsc.assemble_matrix(a)
        A3.zero_rows(np.asarray(dom.inactive_dofs), diag=0.0)
        assert np.array_equal(np.sort(petsc.zero_rows(A3)),
                              np.sort(dom.inactive_dofs))
        assert np.array_equal(petsc.create_vector(V), np.zeros(V.dim))
        with pytest.raises(RuntimeError, match="petsc4py"):
            petsc.to_petsc(A)
        # blocks: P2 velocity-like and P1 spaces on the same cut
        V2, a00, _, dom0 = _petsc_problem(pkg, degree=2)
        blocks = [[petsc.assemble_matrix(a00), petsc.assemble_matrix(a00)],
                  [petsc.assemble_matrix(a00), petsc.assemble_matrix(a00)]]
        bb = [np.ones(V2.dim), np.ones(V2.dim)]
        assert petsc.deactivate_outside_blocks(
            blocks, [dom0, dom0], bb, diagonal=2.0) == [dom0, dom0]
        zr = petsc.zero_block_rows(blocks)
        # nest assembly of a mixed form against the monolithic matrix,
        # both in the default dtype (x64 in the reference's tests: f64)
        d = pkg.ufl
        kw = {} if pkg is cj else {"device": "cpu"}
        mesh = pkg.mesh.create_rectangle((0., 0.), (1., 1.), (4, 4))
        Vv = pkg.functionspace(mesh, ("Lagrange", 2), shape=(2,), **kw)
        Q = pkg.functionspace(mesh, ("Lagrange", 1), **kw)
        W = d.MixedFunctionSpace(Vv, Q)
        (u, p), (v, q) = d.TrialFunctions(W), d.TestFunctions(W)
        dx = pkg.Measure("dx", domain=mesh)
        mixed = (d.inner(d.grad(u), d.grad(v)) - p * d.div(v)
                 + d.div(u) * q) * dx
        default = torch.get_default_dtype()
        torch.set_default_dtype(F64)
        try:
            nest = petsc.assemble_matrix_nest(mixed)
            mono = pkg.fem.assemble_matrix(pkg.fem.form(mixed)).to_scipy()
            bvec = petsc.assemble_vector_nest(pkg.fem.form(1.0 * q * dx))
        finally:
            torch.set_default_dtype(default)
        dims = (Vv.dim, Q.dim)
        A_blk = sps.bmat([[blk.to_scipy() if blk is not None
                           else sps.csr_matrix((dims[i], dims[j]))
                           for j, blk in enumerate(row)]
                          for i, row in enumerate(nest)], format="csr")
        assert A_blk.dtype == np.float64 and abs(mono - A_blk).max() == 0
        assert np.abs(bvec[0]).max() == 0 and abs(bvec[1].sum() - 1) < 1e-12
        res[pkg] = [A.to_dense(), A2.to_dense(), b, b2,
                    blocks[0][0].to_dense(), blocks[0][1].to_dense(),
                    bb[0], *zr, A_blk.toarray(), *bvec]
    for k, (x, y) in enumerate(zip(res[cj], res[ct])):
        x, y = np.asarray(x), np.asarray(y)
        assert x.shape == y.shape, k
        assert np.abs(x - y).max(initial=0.0) < 1e-13, k


def test_profiling_utilities(tmp_path, caplog):
    """tests/test_petsc_layer.py::test_profiling_utilities on the port,
    and the spans' log lines under the "cutfemx_tpu_torch" logger."""
    import logging

    from cutfemx_tpu_torch.profiling import (ProfileWriter, Timer,
                                             list_timings, reset_timings,
                                             timings)
    reset_timings()
    with caplog.at_level(logging.INFO, logger="cutfemx_tpu_torch"):
        with Timer("span_a"):
            _ = sum(range(1000))
    with Timer("span_a", log=False):
        pass
    assert [r.name for r in caplog.records] == ["cutfemx_tpu_torch"]
    assert "span_a" in caplog.records[0].getMessage()
    t = timings()
    assert t["span_a"][0] == 2 and t["span_a"][1] >= 0.0
    lines = []
    list_timings(print_fn=lines.append)
    assert any("span_a" in ln for ln in lines)
    reset_timings()
    assert timings() == {}
    path = tmp_path / "prof.csv"
    with ProfileWriter(path, ["iteration", "compliance"]) as pw:
        pw.write(iteration=0, compliance=1.5)
        pw.write(iteration=1, compliance=1.2, extra="ignored")
    rows = path.read_text().strip().splitlines()
    assert rows == ["iteration,compliance", "0,1.5", "1,1.2"]
