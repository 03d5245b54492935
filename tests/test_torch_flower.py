"""The 2D flower Poisson problem (BASELINE config 1) in cutfemx_tpu_torch
against cutfemx_tpu, in f64 on the CPU: rank-0 forms, the host CSR
assembly, deactivation and the direct solve, each from its own cut and
quadrature, and the port's demo_poisson against the pinned L2 error of
tests/test_l2_parity.py. (ds integrals: test_torch_interface.py.)

Also holds ``flower_problem``, which test_torch_matfree.py shares."""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import cutfemx_tpu as cj  # noqa: E402
import cutfemx_tpu_torch as ct  # noqa: E402
from cutfemx_tpu_torch import interop  # noqa: E402
from cutfemx_tpu_torch.demos import demo_poisson  # noqa: E402
from test_torch_core import host, rel_err  # noqa: E402

# tests/test_l2_parity.py's pinned errors of the reference (P1, direct);
# copied here, not imported: the port is held to the same numbers
PINNED = {16: 1.052731e-02, 32: 2.934306e-03, 64: 7.978235e-04}
N_FLOWER = 16


def reference_rules(rules, mesh):
    """The reference's RuntimeQuadratureRules holding the port's rules."""
    from cutfemx_tpu.cut.quadrature import RuntimeQuadratureRules
    return RuntimeQuadratureRules(
        rules.tdim, rules.parent_map, jnp.asarray(host(rules.points_padded)),
        jnp.asarray(host(rules.weights_padded)), mesh=mesh)


def flower_problem(pkg, n=N_FLOWER, degree=1, device=None, rules=None):
    """demos/demo_poisson.py up to its forms, in ``pkg`` (cutfemx_tpu or
    cutfemx_tpu_torch; the port gets ``device`` and f64 data), with the
    same numpy inputs in both. ``rules`` (a port problem) gives the
    reference the port's runtime quadrature: the assembly then runs on
    identical rules, and the reference compiles no quadrature."""
    fem = importlib.import_module(pkg.__name__ + ".fem")
    d = importlib.import_module(pkg.__name__ + ".forms.dsl")
    Measure = importlib.import_module(pkg.__name__ + ".forms.measure").Measure
    space_kw = {} if device is None else {"device": device}
    f64 = np.float64 if device is None else torch.float64
    mesh = pkg.mesh.create_rectangle((-1.0, -1.0), (1.0, 1.0), (n, n))
    Vphi = pkg.functionspace(mesh, ("Lagrange", 1), **space_kw)
    phi = pkg.Function(Vphi, name="phi", **({} if device is None
                                             else {"dtype": f64}))
    phi.interpolate(demo_poisson.flower_level_set(0.46, 0.15, 6))
    cd = pkg.cut(phi)
    inside = pkg.locate_entities(cd, "phi<0")
    if rules is None:
        vol = pkg.runtime_quadrature(cd, "phi<0", 2 * degree)
        srf = pkg.runtime_quadrature(cd, "phi=0", 2 * degree)
    else:
        vol, srf = (reference_rules(rules[k], mesh) for k in ("vol", "srf"))
    gp = pkg.ghost_penalty_facets(cd, "phi<0")
    dxo = Measure("dx", domain=mesh, subdomain_data=[inside, vol])
    dxg = Measure("dx", domain=mesh, subdomain_data=srf)
    dSg = Measure("dS", domain=mesh, subdomain_data=gp)
    ds = Measure("ds", domain=mesh)
    V = pkg.functionspace(mesh, ("Lagrange", degree), **space_kw)
    u, v = d.TrialFunction(V), d.TestFunction(V)
    x = d.SpatialCoordinate(mesh)
    ng = pkg.normal(phi)
    nf = d.FacetNormal(mesh)
    h = d.CellDiameter(mesh)
    ue = d.sin(d.pi * x[0]) * d.sin(d.pi * x[1])
    f = 2.0 * d.pi ** 2 * ue
    a = d.inner(d.grad(u), d.grad(v)) * dxo
    a += (-d.dot(d.grad(u), ng) * v - d.dot(d.grad(v), ng) * u
          + 40.0 / h * u * v) * dxg
    a += 0.1 * d.avg(h) * d.inner(d.jump(d.grad(u), nf),
                                  d.jump(d.grad(v), nf)) * dSg
    L = f * v * dxo + (-d.dot(d.grad(v), ng) * ue
                       + 40.0 / h * ue * v) * dxg
    af = fem.form(a, dtype=f64)
    return dict(pkg=pkg, fem=fem, d=d, mesh=mesh, phi=phi, V=V, ue=ue, u=u,
                v=v, nf=nf, h=h, dxo=dxo, dxg=dxg, ds=ds, af=af, vol=vol,
                srf=srf, cd=cd,
                Lf=fem.form(L, dtype=f64), dom=fem.active_domain(af),
                f64=f64)


def _solve(P):
    """Assemble, deactivate (b kept as the package returns it) and solve
    directly; the L2 error of the solution."""
    pkg, fem, f64 = P["pkg"], P["fem"], P["f64"]
    A = fem.assemble_matrix(P["af"])
    b = fem.assemble_vector(P["Lf"])
    b = np.array(b) if pkg is cj else b
    A, b = fem.deactivate_outside(A, b, P["dom"])
    x = pkg.la.direct_solve(A, b)
    uh = pkg.Function(P["V"], **({} if pkg is cj else {"dtype": f64}))
    uh.x = jnp.asarray(x) if pkg is cj else x
    e = P["d"].CoefficientExpr(uh) - P["ue"]
    err = fem.assemble_scalar(fem.form(e * e * P["dxo"], dtype=f64))
    return dict(A=A, b=b, x=x, err=float(np.sqrt(float(err))))


@pytest.fixture(scope="module")
def ref(port):
    """The reference on the port's runtime quadrature (its own cut
    classification, facets and everything after the rules); the whole
    demo, rules included, is compared in test_torch_moving.py and by the
    pinned error below."""
    P = flower_problem(cj, rules=port)
    P.update(_solve(P))
    return P


@pytest.fixture(scope="module")
def port():
    P = flower_problem(ct, device="cpu")
    P.update(_solve(P))
    return P


def _csr_equal(Aj, At, tol=1e-12):
    """Same sparsity pattern, entry by entry, and values to tol relative
    to the largest magnitude."""
    mj = interop.matrix_from_reference(Aj).to_scipy()
    mt = At.to_scipy()
    mj.sort_indices()
    mt.sort_indices()
    assert mj.shape == mt.shape
    assert np.array_equal(mj.indptr, mt.indptr)
    assert np.array_equal(mj.indices, mt.indices)
    assert rel_err(mj.data, mt.data) < tol


def test_rank0_forms_match_reference(ref, port):
    """assemble_scalar: the L2 error of the solution over the cut volume
    (in _solve), and a coefficient integral over the interface rules; a
    rank-0 form whose data names no device lives on the one it is
    given."""
    assert abs(ref["err"] - port["err"]) < 1e-12 * ref["err"]
    vals = []
    for P in (ref, port):
        d = P["d"]
        phi = d.CoefficientExpr(P["phi"])
        M = (phi + 2.0) * P["ue"] * P["dxg"]
        vals.append(P["fem"].assemble_scalar(P["fem"].form(M,
                                                           dtype=P["f64"])))
    st = vals[1]
    assert st.shape == () and st.dtype == torch.float64
    assert abs(float(vals[0]) - float(st)) < 1e-12 * abs(float(vals[0]))
    area = ct.fem.form(1.0 * port["ds"], dtype=torch.float64, device="cpu")
    assert abs(float(ct.fem.assemble_scalar(area)) - 8.0) < 1e-12


def test_assembled_matrix_and_vector_match_reference(ref, port):
    """Before deactivation: the CSR of the Nitsche + ghost-penalty form
    entry by entry, and the load vector."""
    _csr_equal(cj.fem.assemble_matrix(ref["af"]),
               ct.fem.assemble_matrix(port["af"]))
    bt = ct.fem.assemble_vector(port["Lf"])
    assert bt.device.type == "cpu" and bt.dtype == torch.float64
    assert rel_err(cj.fem.assemble_vector(ref["Lf"]), bt) < 1e-12


def test_deactivation_matches_reference(ref, port):
    assert np.array_equal(ref["dom"].inactive_dofs, port["dom"].inactive_dofs)
    _csr_equal(ref["A"], port["A"])
    assert isinstance(port["b"], torch.Tensor)
    assert rel_err(ref["b"], port["b"]) < 1e-12
    assert not host(port["b"])[port["dom"].inactive_dofs].any()
    assert ct.fem.zero_rows(port["A"]).size == 0
    assert cj.fem.zero_rows(ref["A"]).size == 0
    # a numpy right-hand side is zeroed in place and comes back as numpy
    bn = np.ones(port["V"].dim)
    A2 = ct.fem.assemble_matrix(port["af"])
    _, out = ct.fem.deactivate_outside(A2, bn, port["dom"])
    assert out is bn and not bn[port["dom"].inactive_dofs].any()


def test_direct_solve_matches_reference(ref, port):
    assert isinstance(port["x"], torch.Tensor)
    assert rel_err(ref["x"], port["x"]) < 1e-10
    assert abs(ref["err"] - port["err"]) < 1e-10 * ref["err"]


def test_demo_poisson_reaches_the_pinned_l2_error():
    out = demo_poisson.run(N_FLOWER, device="cpu")
    assert abs(out["l2_error"] - PINNED[N_FLOWER]) / PINNED[N_FLOWER] < 1e-6
    assert out["solver"] == "scipy spsolve"
    assert out["active_dofs"] < out["dofs"]


def test_unported_options_raise(port):
    """bcs= works (rows and columns of the constrained dofs zeroed, a unit
    diagonal); a runtime ds measure over cell-hosted rules, and bcs and
    extension terms on a monolithic mixed form, raise (runtime ds rules
    and extension terms: tests/test_torch_facet_rules.py,
    tests/test_torch_extensions.py)."""
    fem, d = ct.fem, port["d"]
    dofs = fem.locate_dofs_geometrical(port["V"],
                                       lambda x: np.isclose(x[0], -1.0))
    A = fem.assemble_matrix(port["af"], bcs=[fem.dirichletbc(
        0.0, dofs, port["V"])]).to_scipy()
    assert np.array_equal(A[dofs].toarray(), np.eye(A.shape[0])[dofs])
    assert np.array_equal(A[:, dofs].toarray(), np.eye(A.shape[0])[:, dofs])
    from cutfemx_tpu_torch.forms.measure import Measure
    rules = ct.runtime_quadrature(ct.cut(port["phi"]), "phi=0", 2)
    with pytest.raises(ValueError, match="facet-hosted"):
        fem.form(port["v"] * Measure("ds", domain=port["mesh"],
                                     subdomain_data=rules))
    W = d.MixedFunctionSpace(port["V"], port["V"])
    u1, u2 = d.TrialFunctions(W)
    v1, v2 = d.TestFunctions(W)
    mixed = fem.form(u1 * v1 * port["dxo"] + u2 * v2 * port["dxo"],
                     dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="per block"):
        fem.assemble_matrix(mixed, bcs=[fem.dirichletbc(0.0, dofs,
                                                        port["V"])])
    with pytest.raises(NotImplementedError, match="per block"):
        fem.assemble_matrix(mixed, extension_terms=[object()])
