"""Two-domain interface Poisson (BASELINE config 3) in cutfemx_tpu_torch
against cutfemx_tpu, in f64 on the CPU (the reference on the port's
runtime quadrature): per-block forms of a mixed space through
extract_blocks, ds integrals with the facet normal, block deactivation,
the block direct solve and its errors; and the port's
demo_interface_poisson held to tests/test_interface_poisson.py's bounds."""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import cutfemx_tpu as cj  # noqa: E402
import cutfemx_tpu_torch as ct  # noqa: E402
from cutfemx_tpu_torch import interop  # noqa: E402
from cutfemx_tpu_torch.demos import (  # noqa: E402
    demo_interface_poisson as demo)
from test_torch_core import rel_err  # noqa: E402
from test_torch_flower import reference_rules  # noqa: E402

N_IFACE, QDEG = 8, 3


def interface_problem(pkg, n=N_IFACE, device=None, rules=None):
    """demos/demo_interface_poisson.py up to its block forms, in ``pkg``;
    ``rules`` (a port problem) gives the reference the port's runtime
    quadrature."""
    fem = importlib.import_module(pkg.__name__ + ".fem")
    d = importlib.import_module(pkg.__name__ + ".forms.dsl")
    Measure = importlib.import_module(pkg.__name__ + ".forms.measure").Measure
    kw = {} if device is None else {"device": device}
    fkw = {} if device is None else {"dtype": torch.float64}
    f64 = np.float64 if device is None else torch.float64
    mesh = pkg.mesh.create_rectangle((-1.0, -1.0), (1.0, 1.0), (n, n))
    phi = pkg.Function(pkg.functionspace(mesh, ("Lagrange", 1), **kw),
                       name="phi", **fkw)
    cx, cy = demo.CENTER
    phi.interpolate(lambda x: np.sqrt((x[0] - cx) ** 2 + (x[1] - cy) ** 2)
                    - demo.RADIUS)
    cd = pkg.cut(phi)
    inside = pkg.locate_entities(cd, "phi<0")
    outside = pkg.locate_entities(cd, "phi>0")
    if rules is None:
        rl = {s: pkg.runtime_quadrature(cd, s, QDEG)
              for s in ("phi<0", "phi>0", "phi=0")}
    else:
        rl = {s: reference_rules(r, mesh) for s, r in rules["rules"].items()}
    gp1 = pkg.ghost_penalty_facets(cd, "phi<0")
    gp2 = pkg.ghost_penalty_facets(cd, "phi>0")
    dx1 = Measure("dx", domain=mesh, subdomain_data=[inside, rl["phi<0"]])
    dx2 = Measure("dx", domain=mesh, subdomain_data=[outside, rl["phi>0"]])
    dgam = Measure("dx", domain=mesh, subdomain_data=rl["phi=0"])
    dS1 = Measure("dS", domain=mesh, subdomain_data=gp1)
    dS2 = Measure("dS", domain=mesh, subdomain_data=gp2)
    ds = Measure("ds", domain=mesh)
    V1 = pkg.functionspace(mesh, ("Lagrange", 1), **kw)
    V2 = pkg.functionspace(mesh, ("Lagrange", 1), **kw)
    W = d.MixedFunctionSpace(V1, V2)
    u1, u2 = d.TrialFunctions(W)
    v1, v2 = d.TestFunctions(W)
    x = d.SpatialCoordinate(mesh)
    k1, k2 = demo.KAPPA_1, demo.KAPPA_2
    r2 = (x[0] - cx) ** 2 + (x[1] - cy) ** 2
    u1_ex = r2
    u2_ex = k1 / k2 * r2 + demo.RADIUS ** 2 * (1.0 - k1 / k2)
    ng, nf, h = pkg.normal(phi), d.FacetNormal(mesh), d.CellDiameter(mesh)
    eta_i = demo.G_INT * 2 * k1 * k2 / (k1 + k2) / h
    eta_b = demo.G_BND * k2 / h
    w1, w2 = k2 / (k1 + k2), k1 / (k1 + k2)
    ju, jv = u1 - u2, v1 - v2
    flux_u = w1 * k1 * d.dot(d.grad(u1), ng) + w2 * k2 * d.dot(d.grad(u2),
                                                                ng)
    flux_v = w1 * k1 * d.dot(d.grad(v1), ng) + w2 * k2 * d.dot(d.grad(v2),
                                                                ng)
    a = k1 * d.inner(d.grad(u1), d.grad(v1)) * dx1
    a += k2 * d.inner(d.grad(u2), d.grad(v2)) * dx2
    a += (-flux_u * jv - flux_v * ju + eta_i * ju * jv) * dgam
    a += demo.G_GHOST * k1 * d.avg(h) * d.inner(
        d.jump(d.grad(u1), nf), d.jump(d.grad(v1), nf)) * dS1
    a += demo.G_GHOST * k2 * d.avg(h) * d.inner(
        d.jump(d.grad(u2), nf), d.jump(d.grad(v2), nf)) * dS2
    a += (-k2 * d.dot(d.grad(u2), nf) * v2 - k2 * d.dot(d.grad(v2), nf) * u2
          + eta_b * u2 * v2) * ds
    L = -4.0 * k1 * v1 * dx1 - 4.0 * k1 * v2 * dx2
    L += (-k2 * d.dot(d.grad(v2), nf) * u2_ex + eta_b * u2_ex * v2) * ds
    return dict(pkg=pkg, fem=fem, d=d, V=(V1, V2), rules=rl, ex=(u1_ex,
                u2_ex), dx=(dx1, dx2, dgam),
                a=fem.extract_blocks(a, dtype=f64),
                L=fem.extract_blocks(L, dtype=f64), f64=f64)


def _solve(P):
    """Block assembly, block deactivation, one direct solve of the block
    system, and the errors of both phases and of the jump."""
    pkg, fem, d, f64 = P["pkg"], P["fem"], P["d"], P["f64"]
    V1, V2 = P["V"]
    A = [[fem.assemble_matrix(blk) for blk in row] for row in P["a"]]
    b = [fem.assemble_vector(blk) for blk in P["L"]]
    if pkg is cj:
        b = [np.array(v) for v in b]
    doms = [fem.active_domain(P["a"][0][0]), fem.active_domain(P["a"][1][1])]
    fem.deactivate_outside_blocks(A, doms, b)
    from scipy.sparse import bmat
    Ah = bmat([[blk.to_scipy() for blk in row] for row in A], format="csr")
    bb = np.concatenate(b) if pkg is cj else torch.cat(b)
    sol = pkg.la.direct_solve(Ah, bb)
    fkw = {} if pkg is cj else {"dtype": f64}
    uh = [pkg.Function(V, **fkw) for V in (V1, V2)]
    for f, part in zip(uh, (sol[:V1.dim], sol[V1.dim:])):
        f.x = jnp.asarray(part) if pkg is cj else part
    c1, c2 = (d.CoefficientExpr(f) for f in uh)
    dx1, dx2, dgam = P["dx"]

    def l2(e, m):
        return float(np.sqrt(float(fem.assemble_scalar(fem.form(
            e * e * m, dtype=f64)))))

    errs = (l2(c1 - P["ex"][0], dx1), l2(c2 - P["ex"][1], dx2),
            l2(c1 - c2, dgam))
    return dict(A=A, b=b, doms=doms, sol=sol, errs=errs)


@pytest.fixture(scope="module")
def port():
    P = interface_problem(ct, device="cpu")
    P["vec"] = [ct.fem.assemble_vector(blk) for blk in P["L"]]
    P.update(_solve(P))
    return P


@pytest.fixture(scope="module")
def ref(port):
    P = interface_problem(cj, rules=port)
    P["vec"] = [cj.fem.assemble_vector(blk) for blk in P["L"]]
    P.update(_solve(P))
    return P


def _csr_equal(Aj, At, tol=1e-12):
    mj = interop.matrix_from_reference(Aj).to_scipy()
    mt = At.to_scipy()
    mj.sort_indices()
    mt.sort_indices()
    assert np.array_equal(mj.indptr, mt.indptr)
    assert np.array_equal(mj.indices, mt.indices)
    assert rel_err(mj.data, mt.data) < tol


def test_extract_blocks_layout(ref, port):
    """A 2 x 2 rank-2 layout and 2 rank-1 blocks, every block present (the
    Nitsche coupling fills the off-diagonal ones), each with the
    reference's integral types in its order."""
    for P in (ref, port):
        assert len(P["a"]) == 2 and all(len(r) == 2 for r in P["a"])
        assert all(b is not None for row in P["a"] for b in row)
        assert len(P["L"]) == 2 and all(b is not None for b in P["L"])
    for rj, rt in zip(ref["a"], port["a"]):
        for bj, bt in zip(rj, rt):
            assert bt.block == bj.block
            assert [i.itype for i in bt.instances] == \
                [i.itype for i in bj.instances]
    assert "exterior_facet" in [i.itype for i in port["a"][1][1].instances]
    assert "exterior_facet" not in [i.itype
                                    for i in port["a"][0][0].instances]
    V1, V2 = port["V"]
    assert list(ct.fem.block_offsets([V1, V2])) == [0, V1.dim,
                                                     V1.dim + V2.dim]


def test_block_matrices_and_vectors_match_reference(ref, port):
    """Before deactivation: each block's CSR entry by entry and each block
    vector, the outer boundary's ds Nitsche terms (with the facet normal)
    included."""
    for rj, rt in zip(ref["a"], port["a"]):
        for bj, bt in zip(rj, rt):
            _csr_equal(cj.fem.assemble_matrix(bj), ct.fem.assemble_matrix(bt))
    for vj, vt in zip(ref["vec"], port["vec"]):
        assert rel_err(vj, vt) < 1e-12


def test_block_deactivation_matches_reference(ref, port):
    for dj, dt in zip(ref["doms"], port["doms"]):
        assert np.array_equal(dj.inactive_dofs, dt.inactive_dofs)
        assert dt.inactive_dofs.size > 0
    for rj, rt in zip(ref["A"], port["A"]):
        for bj, bt in zip(rj, rt):
            _csr_equal(bj, bt)
    for vj, vt in zip(ref["b"], port["b"]):
        assert isinstance(vt, torch.Tensor)
        assert rel_err(vj, vt) < 1e-12
    assert [r.size for r in ct.fem.zero_block_rows(port["A"])] == [0, 0]
    # an inactive row of the first phase, left without its unit diagonal,
    # is what zero_block_rows reports
    A = [[ct.fem.assemble_matrix(b) for b in row] for row in port["a"]]
    dom = port["doms"][0]
    ct.fem.deactivate_outside_blocks(A, [dom, port["doms"][1]], diag=0.0)
    assert np.array_equal(ct.fem.zero_block_rows(A)[0], dom.inactive_dofs)


def test_block_solve_and_errors_match_reference(ref, port):
    assert isinstance(port["sol"], torch.Tensor)
    assert rel_err(ref["sol"], port["sol"]) < 1e-10
    for ej, et in zip(ref["errs"], port["errs"]):
        assert abs(ej - et) < 1e-10 * ej


def test_demo_interface_poisson_converges():
    """tests/test_interface_poisson.py's bounds, at its n = 12 and 24."""
    c, f = (demo.run(n, device="cpu") for n in (12, 24))
    assert f["err1"] < 6e-3 and f["err2"] < 6e-3
    assert np.log2(c["err1"] / f["err1"]) > 1.5
    assert np.log2(c["err2"] / f["err2"]) > 1.5
    assert f["jump"] < 2e-2
    assert c["zero_rows"] == f["zero_rows"] == [0, 0]


def test_mixed_forms_need_extract_blocks(port):
    """fem.form of a mixed expression is a MixedCutForm (its matrix the
    block composition); a plain CutForm of it still refuses."""
    d = port["d"]
    V1, V2 = port["V"]
    W = d.MixedFunctionSpace(V1, V2)
    u1, _ = d.TrialFunctions(W)
    v1, _ = d.TestFunctions(W)
    expr = u1 * v1 * port["dx"][0]
    mixed = ct.fem.form(expr, dtype=torch.float64)
    assert isinstance(mixed, ct.fem.MixedCutForm)
    assert mixed.test_spaces == [V1, V2] and mixed.dim == V1.dim + V2.dim
    assert mixed.blocks[0][1] is None and mixed.blocks[1][1] is None
    A = ct.fem.assemble_matrix(mixed).to_scipy()
    A11 = ct.fem.assemble_matrix(ct.fem.extract_blocks(
        expr, dtype=torch.float64)[0][0]).to_scipy()
    assert abs(A[:V1.dim, :V1.dim] - A11).max() == 0.0
    assert A[V1.dim:].nnz == 0 and A[:, V1.dim:].nnz == 0
    with pytest.raises(ValueError, match="extract_blocks"):
        ct.fem.CutForm(expr)
