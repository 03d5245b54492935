"""Cell aggregation and the extension penalty (cutfemx_tpu_torch.extensions)
against cutfemx_tpu.extensions, in f64 on the CPU.

The input is tests/test_extensions.py's circle (r = 0.31 in [-1, 1]^2) at
n = 16, cut in both packages from the same numpy level set. Tolerances:
every integer array of CellAggregation exactly, the volume fractions
1e-13 absolute (two quadrature sums), the extension quadrature 1e-12,
penalty matrices 1e-12 * max|A|. In 3D, bench.py's geometry (the P1
sphere r = 0.46 in [-1, 1]^3) at n = 8 is aggregated and penalised in both
packages."""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import cutfemx_tpu as cj  # noqa: E402
import cutfemx_tpu_torch as ct  # noqa: E402
from chip_smoke import (JAX_CPU_UNFITTED, PIN_SUM_RTOL, _hold_pin,  # noqa: E402
                        facet_3d_numbers)
from cutfemx_tpu import extensions as ej  # noqa: E402
from cutfemx_tpu import fem as fem_j  # noqa: E402
from cutfemx_tpu_torch import extensions as et  # noqa: E402
from cutfemx_tpu_torch import fem as fem_t  # noqa: E402
from test_torch_core import host, rel_err  # noqa: E402

N = 16
TOL = 1e-12
AGG_INT = ("interior_cells", "cut_cells", "active_cells", "well_posed_cells",
           "ill_posed_cells", "rootless_cells", "root_cell", "aggregate_id",
           "propagation_depth")


def circle(pkg, n=N, r=0.31):
    kw = {"device": "cpu"} if pkg is ct else {}
    mesh = pkg.mesh.create_rectangle((-1.0, -1.0), (1.0, 1.0), (n, n))
    V = pkg.functionspace(mesh, ("Lagrange", 1), **kw)
    phi = pkg.Function(V, name="phi",
                       **({"dtype": torch.float64} if pkg is ct else {}))
    phi.interpolate(lambda x: np.sqrt(x[0] ** 2 + x[1] ** 2) - r)
    return mesh, phi, pkg.cut(phi)


@pytest.fixture(scope="module")
def problems():
    """Both packages' circle, CutData and aggregation ('phi<0', 0.5)."""
    out = {}
    for pkg, ext in ((cj, ej), (ct, et)):
        mesh, phi, cd = circle(pkg)
        out[pkg] = dict(mesh=mesh, phi=phi, cd=cd,
                        agg=ext.create_cell_aggregation(cd, "phi<0", 0.5))
    return out


def hold_aggregation(a, b):
    for key in AGG_INT:
        x, y = getattr(a, key), getattr(b, key)
        assert x.dtype == y.dtype and np.array_equal(x, y), key
    assert np.abs(a.cut_volume_fraction - b.cut_volume_fraction).max() \
        <= 1e-13


def test_aggregation_arrays(problems):
    """Both root policies, and a one-sweep limit with rootless cells
    allowed: every array as the reference's."""
    hold_aggregation(problems[cj]["agg"], problems[ct]["agg"])
    agg = problems[ct]["agg"]
    assert agg.ill_posed_cells.size and agg.rootless_cells.size == 0
    assert agg.propagation_depth.max() >= 1
    for kw in (dict(root_policy="interior_only"),
               dict(max_iterations=1, allow_rootless=True)):
        hold_aggregation(
            ej.create_cell_aggregation(problems[cj]["cd"], "phi>0", 0.4,
                                       **kw),
            et.create_cell_aggregation(problems[ct]["cd"], "phi>0", 0.4,
                                       **kw))


def test_aggregation_rejects_invalid_inputs(problems):
    """tests/test_extensions.py's invalid inputs, facet-hosted CutData and
    rootless cells without allow_rootless raise in both packages."""
    for pkg, ext in ((cj, ej), (ct, et)):
        cd = problems[pkg]["cd"]
        for sel, thr, kw in (("phi=0", 0.5, {}), ("phi<0", 1.5, {}),
                             ("phi<0", 0.5, {"root_policy": "bogus"}),
                             ("psi<0", 0.5, {})):
            with pytest.raises(ValueError):
                ext.create_cell_aggregation(cd, sel, thr, **kw)
        mesh, phi = problems[pkg]["mesh"], problems[pkg]["phi"]
        with pytest.raises(ValueError):
            ext.create_cell_aggregation(pkg.cut(phi, mesh.exterior_facets, 1),
                                        "phi<0", 0.5)
        with pytest.raises(RuntimeError, match="without an admissible"):
            ext.create_cell_aggregation(cd, "phi<0", 0.5, max_iterations=0)


def test_extension_quadrature(problems):
    got = {}
    for pkg, ext in ((cj, ej), (ct, et)):
        P = problems[pkg]
        kw = {"device": "cpu"} if pkg is ct else {}
        V = pkg.functionspace(P["mesh"], ("Lagrange", 2), **kw)
        got[pkg] = ext.extension_quadrature(V, P["cd"], P["agg"], 4)
    a, b = got[cj], got[ct]
    assert np.array_equal(a.bad_cells, b.bad_cells)
    assert np.array_equal(a.root_cells, b.root_cells)
    for key in ("points_bad", "points_root", "weights"):
        x, y = host(getattr(a, key)), host(getattr(b, key))
        assert x.shape == y.shape and np.abs(x - y).max() <= TOL, key


@pytest.mark.parametrize("degree", [1, 2])
def test_penalty_matrices(problems, degree):
    """extension_penalty_matrix with a scalar, a per-cell and a DG0 beta,
    and assemble_extension_penalty of an ExtensionPenaltyTerm into a
    matrix: equal to the reference's."""
    mats = {}
    for pkg, ext in ((cj, ej), (ct, et)):
        P = problems[pkg]
        kw = {"device": "cpu"} if pkg is ct else {}
        fkw = {"dtype": torch.float64} if pkg is ct else {}
        V = pkg.functionspace(P["mesh"], ("Lagrange", degree), **kw)
        W = pkg.functionspace(P["mesh"], ("DG", 0), **kw)
        beta_f = pkg.Function(W, **fkw)
        beta_f.interpolate(lambda x: 1.0 + x[0] ** 2)
        cells = np.linspace(0.5, 2.0, P["mesh"].num_cells)
        args = (V, P["cd"], P["agg"])
        mats[pkg] = [ext.extension_penalty_matrix(*args, beta=b,
                                                  quadrature_degree=q)
                     for b, q in ((2.0, None), (cells, 2 * degree),
                                  (beta_f, None))]
        term = ext.ExtensionPenaltyTerm(*args, beta=3.0,
                                        quadrature_degree=2 * degree)
        base = ext.create_extension_penalty_matrix(*args)
        mats[pkg].append(ext.assemble_extension_penalty(base, term))
    for A, B in zip(mats[cj], mats[ct]):
        A, B = A.to_dense(), B.to_dense()
        assert np.abs(A).max() > 0 and rel_err(A, B) <= TOL
        assert np.abs(B - B.T).max() <= TOL * np.abs(B).max()
        assert np.abs(B @ np.ones(len(B))).max() <= TOL * np.abs(B).max()


def _poisson(pkg, fem, P, term_beta=1.0):
    """The study demo's bilinear form on the circle, and its extension
    term."""
    d = importlib.import_module(pkg.__name__ + ".forms.dsl")
    Measure = importlib.import_module(pkg.__name__ + ".forms.measure").Measure
    ext = ej if pkg is cj else et
    kw = {"device": "cpu"} if pkg is ct else {}
    mesh, cd = P["mesh"], P["cd"]
    inside = pkg.locate_entities(cd, "phi<0")
    vol = pkg.runtime_quadrature(cd, "phi<0", 2)
    V = pkg.functionspace(mesh, ("Lagrange", 1), **kw)
    u, v = d.TrialFunction(V), d.TestFunction(V)
    a = d.inner(d.grad(u), d.grad(v)) * Measure(
        "dx", domain=mesh, subdomain_data=[inside, vol])
    form = fem.form(a, **({"dtype": torch.float64} if pkg is ct else {}))
    return form, ext.ExtensionPenaltyTerm(V, cd, P["agg"], beta=term_beta)


def test_assembly_takes_extension_terms(problems):
    """assemble_matrix(extension_terms=) = the form's matrix + the penalty
    (and the reference's); create_sparsity_pattern(extension_terms=) and
    create_matrix(extension_terms=) as the reference's."""
    got = {}
    for pkg, fem in ((cj, fem_j), (ct, fem_t)):
        af, term = _poisson(pkg, fem, problems[pkg])
        A = fem.assemble_matrix(af, extension_terms=[term]).to_dense()
        S = fem.create_sparsity_pattern(af, extension_terms=term)
        Z = fem.create_matrix(af, extension_terms=[term])
        got[pkg] = (A, S, Z.shape, fem.assemble_matrix(af).to_dense(),
                    term)
    A, S, shape, A0, term = got[ct]
    assert rel_err(got[cj][0], A) <= TOL
    assert (S != got[cj][1]).nnz == 0 and S.dtype == got[cj][1].dtype
    assert shape == got[cj][2]
    M = et.extension_penalty_matrix(term.V, term.cut_data, term.aggregation,
                                    beta=1.0, quadrature_degree=2)
    assert rel_err(A0 + M.to_dense(), A) <= TOL
    Sd = S.toarray().astype(bool)
    assert Sd[np.abs(A) > 0].all()


def bench_sphere(pkg, n):
    """bench.py's geometry: [-1, 1]^3 in n^3 x 6 tets and the P1 sphere
    r = 0.46; its P1 space and CutData."""
    kw = {"device": "cpu"} if pkg is ct else {}
    mesh = pkg.mesh.create_box((-1, -1, -1), (1, 1, 1), (n, n, n))
    V = pkg.functionspace(mesh, ("Lagrange", 1), **kw)
    phi = pkg.Function(V, name="phi",
                       **({"dtype": torch.float64} if pkg is ct else {}))
    phi.interpolate(lambda x: np.sqrt(x[0] ** 2 + x[1] ** 2 + x[2] ** 2)
                    - 0.46)
    return V, pkg.cut(phi)


def test_facet_3d_numbers_match_jax_cpu():
    """bench.py's geometry at n = 8: the aggregation of 'phi<0' at 0.5 and
    the P1 penalty with beta = 1 as the reference's (symmetric, constants
    in its kernel); the port's chip_smoke.facet_3d_numbers there (also the
    facet-hosted rules and cut mesh) keeps its gates and the JAX-CPU pin
    chip_smoke holds the card to."""
    got = {}
    for pkg, ext in ((cj, ej), (ct, et)):
        V, cd = bench_sphere(pkg, 8)
        agg = ext.create_cell_aggregation(cd, "phi<0", 0.5)
        got[pkg] = agg, ext.extension_penalty_matrix(V, cd, agg,
                                                     beta=1.0).to_dense()
    hold_aggregation(got[cj][0], got[ct][0])
    assert got[ct][0].ill_posed_cells.size and \
        got[ct][0].propagation_depth.max() > 1
    A, B = host(got[cj][1]), host(got[ct][1])
    assert rel_err(A, B) <= TOL
    assert np.abs(B - B.T).max() <= 1e-14 * np.abs(B).max()
    assert np.abs(B @ np.ones(len(B))).max() <= TOL * np.abs(B).max()
    out = facet_3d_numbers(ct, 8, "cpu")
    _hold_pin("facet_3d_8", out, JAX_CPU_UNFITTED["facet_3d_8"],
              PIN_SUM_RTOL)
    assert out["rootless"] == 0
    assert abs(out["lo_sum"] + out["hi_sum"] - out["cut_facet_area"]) <= \
        TOL * out["cut_facet_area"]
