"""Higher-degree level sets on cut cells in cutfemx_tpu_torch against
cutfemx_tpu, in f64 on the CPU: the red-refinement tables, red-refined
(levels 1 and 2) and curved rules of a P2 sphere (3D n = 4, 2D n = 8),
the cut API's choice between them, a compound selector with a P2 level
set, bench.py's problem with a P2 level set on the curved path (n = 4),
and chip_smoke.py's curved pins.

Both packages cut the same numpy level sets. Tolerances: rule points,
weights and normals 1e-12 absolute over the whole padded arrays (the
point order included), matrices and vectors 1e-12 relative to their
largest entry, the pins HIGHER_ORDER_RTOL relative. The reference's rule
builders run under jax.jit (one compile per rule, several times faster
than its op-by-op compiles; the same numbers to ~1e-15)."""


import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

import cutfemx_tpu as cj  # noqa: E402
import cutfemx_tpu_torch as ct  # noqa: E402
from cutfemx_tpu.cut import api as api_j, quadrature as quad_j  # noqa: E402
from cutfemx_tpu.cut import tables as tables_j  # noqa: E402
from cutfemx_tpu_torch.cut import api as api_t  # noqa: E402
from cutfemx_tpu_torch.cut import quadrature as quad_t  # noqa: E402
from cutfemx_tpu_torch.cut import tables as tables_t  # noqa: E402
from chip_smoke import (CURVED_CUT, HIGHER_ORDER_RTOL,  # noqa: E402
                        JAX_CPU_CURVED, _hold_ho, curved_numbers,
                        ho_mesh_phi)
from test_torch_core import bench_problem, host, rel_err  # noqa: E402

TOL = 1e-12
RADIUS = 0.6
ORDER = 4            # bench.py's 2 * degree: shares the reference's compiles
CASES = {"3d": ("tetrahedron", 4, "<"), "2d": ("triangle", 8, ">")}
PLANS = {"levels1": dict(levels=1), "levels2": dict(levels=2),
         "curved": dict(curved=True)}


def sphere(x):
    return sum(xi ** 2 for xi in x) - RADIUS ** 2


def port_phi(cell, n, fn=sphere, degree=2):
    return ho_mesh_phi(ct, n, cell, degree, fn, device="cpu")


def cut_cells(cd):
    return cd.hosted_entities[cd.domains[0] == api_t.DOMAIN_INTERSECTED]


def jit_rules(build, functions):
    """Run a reference rule builder under jax.jit, the level sets'
    values being the traced arguments: (points, weights, normals)."""
    saved = [f.x for f in functions]

    def traced(*xs):
        for f, x in zip(functions, xs):
            f.x = x
        r = build()
        return r.points_padded, r.weights_padded, r.normals_padded

    try:
        return jax.jit(traced)(*saved)
    finally:
        for f, x in zip(functions, saved):
            f.x = x


def hold_rules(ref, rules, what):
    points, weights, normals = ref
    assert rules.points_padded.shape == points.shape, what
    assert np.abs(host(rules.points_padded) - host(points)).max() < TOL, what
    assert np.abs(host(rules.weights_padded) - host(weights)).max() < TOL, \
        what
    if normals is not None:
        assert np.abs(host(rules.normals_padded)
                      - host(normals)).max() < TOL, what


@pytest.fixture(scope="module")
def reference_rules():
    """The reference's red-refined and curved volume and interface rules
    of the P2 sphere, built once: {(case, plan, kind): arrays}."""
    out = {}
    for case, (cell, n, side) in CASES.items():
        mesh, phi = ho_mesh_phi(cj, n, cell, 2, sphere)
        cells = cut_cells(cj.cut(phi))
        for plan, kw in PLANS.items():
            out[case, plan, "vol"] = jit_rules(
                lambda: quad_j.volume_rules(mesh, phi, cells, ORDER,
                                            side=side, **kw), [phi])
            out[case, plan, "srf"] = jit_rules(
                lambda: quad_j.interface_rules(mesh, phi, cells, ORDER,
                                               **kw), [phi])
    return out


def test_subdivided_simplices_equal_reference():
    rng = np.random.default_rng(0)
    for d in (1, 2, 3):
        base = rng.random((2, d + 1, d))
        for levels in (0, 1, 2):
            a = tables_j.subdivided_simplices(base, levels)
            b = tables_t.subdivided_simplices(base, levels)
            assert a.shape == (2 * (2 ** d) ** levels, d + 1, d)
            assert np.array_equal(a, b)


@pytest.mark.parametrize("case", sorted(CASES))
def test_refined_and_curved_rules_match(reference_rules, case):
    cell, n, side = CASES[case]
    mesh, phi = port_phi(cell, n)
    cells = cut_cells(ct.cut(phi))
    for plan, kw in PLANS.items():
        hold_rules(reference_rules[case, plan, "vol"],
                   quad_t.volume_rules(mesh, phi, cells, ORDER, side=side,
                                       **kw), (case, plan, "vol"))
        hold_rules(reference_rules[case, plan, "srf"],
                   quad_t.interface_rules(mesh, phi, cells, ORDER, **kw),
                   (case, plan, "srf"))


def test_approximation_choice():
    """'auto' red-refines a P2 level set two levels, 'linear' marches it
    at level 0, order 2 takes the curved path on simplices only; a P1
    level set is cut at level 0. The same plans in both packages, and
    runtime_quadrature follows them."""
    expect = [("triangle", 2, {}, (2, False)),
              ("triangle", 2, {"cut_approximation": "linear"}, (0, False)),
              ("triangle", 2, CURVED_CUT, (0, True)),
              ("triangle", 2, {"max_refinement_iterations": 1}, (1, False)),
              ("triangle", 1, CURVED_CUT, (0, False)),
              ("quadrilateral", 2, CURVED_CUT, (2, False))]
    for cell, degree, kw, plan in expect:
        mj, pj = ho_mesh_phi(cj, 4, cell, degree, sphere)
        mt, pt = port_phi(cell, 4, degree=degree)
        cdt = ct.cut(pt, **kw)
        assert api_j._approx_plan(cj.cut(pj, **kw), pj, mj) == plan
        assert api_t._approx_plan(cdt, pt, mt) == plan
    mesh, phi = port_phi("triangle", 8)
    cells = cut_cells(ct.cut(phi))
    for kw, plan in (({}, dict(levels=2)), (CURVED_CUT, dict(curved=True)),
                     ({"cut_approximation": "linear"}, {})):
        cd = ct.cut(phi, **kw)
        got = ct.runtime_quadrature(cd, "phi=0", ORDER)
        want = quad_t.interface_rules(mesh, phi, cells, ORDER, **plan)
        assert torch.equal(got.points_padded, want.points_padded)
        assert torch.equal(got.weights_padded, want.weights_padded)
        assert torch.equal(got.normals_padded, want.normals_padded)


def test_compound_selector_with_p2_level_set():
    """'phi<0 and cap>0' with phi the P2 circle (two refinement levels)
    and cap a P1 line, on n = 8 triangles."""
    def cap(x):
        return x[0] - 0.2

    def functions(pkg):
        kw = {"device": "cpu"} if pkg is ct else {}
        fkw = {"dtype": torch.float64} if pkg is ct else {}
        mesh, phi = ho_mesh_phi(pkg, 8, "triangle", 2, sphere, **kw)
        V1 = pkg.functionspace(mesh, ("Lagrange", 1), **kw)
        c = pkg.Function(V1, name="cap", **fkw)
        c.interpolate(cap)
        return mesh, phi, c

    _, pj, cj_ = functions(cj)
    cdj = cj.cut([pj, cj_])
    ref = jit_rules(lambda: cj.runtime_quadrature(cdj, "phi<0 and cap>0",
                                                  ORDER), [pj, cj_])
    _, pt, ct_ = functions(ct)
    cdt = ct.cut([pt, ct_])
    rules = ct.runtime_quadrature(cdt, "phi<0 and cap>0", ORDER)
    incl, any_cut, _, _ = api_j._compound_masks(
        cdj, [("phi", "<"), ("cap", ">")])
    assert np.array_equal(rules.parent_map,
                          cdj.hosted_entities[incl & any_cut])
    hold_rules(ref, rules, "compound")


def test_bench_problem_with_p2_level_set_matches():
    """bench.py's matrix and load vector with the sphere as a P2 level set
    on the curved path (n = 4)."""
    kw = dict(n=4, phi_degree=2, cut_kw=CURVED_CUT)
    Pj = bench_problem(cj, np.float64, **kw)
    Pt = bench_problem(ct, torch.float64, device="cpu",
                       phi_dtype=torch.float64, **kw)
    Aj = cj.fem.assemble_matrix(Pj["af"]).to_scipy().toarray()
    At = ct.fem.assemble_matrix(Pt["af"]).to_scipy().toarray()
    assert np.abs(Aj - At).max() <= TOL * np.abs(Aj).max()
    assert rel_err(Pj["b"], Pt["b"]) < TOL
    assert np.array_equal(Pj["gp"], Pt["gp"])


def test_curved_numbers_meet_jax_cpu_pins():
    """chip_smoke.py's curved_parity numbers on the CPU: the port against
    the JAX-CPU pins (reference_curved recomputes them)."""
    got = curved_numbers(ct, device="cpu")
    assert _hold_ho("curved_parity", got, JAX_CPU_CURVED) \
        <= HIGHER_ORDER_RTOL


def reference_curved():
    """The JAX-CPU numbers JAX_CPU_CURVED pins (x64; ~30 s)."""
    out = curved_numbers(cj)
    return {k: out[k] for k in JAX_CPU_CURVED}
