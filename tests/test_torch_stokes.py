"""Cut Stokes (BASELINE config 4) in cutfemx_tpu_torch against cutfemx_tpu,
in f64 on the CPU: the block and monolithic (MixedCutForm) assembly of
tests/test_stokes.py's P1-P1 form, its sparsity, the mixed active domain
and deactivation, strong Dirichlet conditions with lifting, the
manufactured errors of tests/test_stokes.py and the cylinder demo of
demos/demo_stokes.py, each from its own cut and quadrature.

Also holds ``reference_cylinder``, the reference demo's steps with its
numbers returned instead of printed: the source of chip_smoke.py's
JAX-CPU cylinder values (PERF.md section 4)."""

import importlib

import numpy as np
import pytest
import scipy.sparse as sps

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import cutfemx_tpu as cj  # noqa: E402
import cutfemx_tpu_torch as ct  # noqa: E402
from cutfemx_tpu_torch import interop  # noqa: E402
from cutfemx_tpu_torch.demos import demo_stokes  # noqa: E402
from test_stokes import solve_cut_stokes  # noqa: E402
from test_torch_core import host, rel_err  # noqa: E402

N_STOKES = 8


def stokes_problem(pkg, n=N_STOKES, device=None):
    """tests/test_stokes.py's manufactured problem up to its forms, in
    ``pkg`` (the port on ``device``, in f64): the block forms, the
    monolithic ones and the outer boundary's facets."""
    fem = importlib.import_module(pkg.__name__ + ".fem")
    d = importlib.import_module(pkg.__name__ + ".forms.dsl")
    Measure = importlib.import_module(pkg.__name__ + ".forms.measure").Measure
    kw = {} if device is None else {"device": device}
    fkw = {} if device is None else {"dtype": torch.float64}
    f64 = np.float64 if device is None else torch.float64
    mesh = pkg.mesh.create_rectangle((-1.0, -1.0), (1.0, 1.0), (n, n))
    phi = pkg.Function(pkg.functionspace(mesh, ("Lagrange", 1), **kw),
                       name="phi", **fkw)
    phi.interpolate(lambda x: np.sqrt(x[0] ** 2 + x[1] ** 2)
                    - demo_stokes.MMS_RADIUS)
    cd = pkg.cut(phi)
    fluid = pkg.locate_entities(cd, "phi<0")
    cut_cells = pkg.locate_entities(cd, "phi=0")
    q = demo_stokes.MMS_QUADRATURE_DEGREE
    rules = pkg.runtime_quadrature(cd, "phi<0", q)
    irules = pkg.runtime_quadrature(cd, "phi=0", q)
    gp = pkg.ghost_penalty_facets(cd, "phi<0")
    p_facets = pkg.interior_facets_for_cells(mesh,
                                             np.union1d(fluid, cut_cells))
    dxo = Measure("dx", domain=mesh, subdomain_data=[fluid, rules])
    dxg = Measure("dx", domain=mesh, subdomain_data=irules)
    dSg = Measure("dS", domain=mesh, subdomain_data=gp)
    dSp = Measure("dS", domain=mesh, subdomain_data=p_facets)
    V = pkg.functionspace(mesh, ("Lagrange", 1), shape=(2,), **kw)
    Q = pkg.functionspace(mesh, ("Lagrange", 1), **kw)
    W = d.MixedFunctionSpace(V, Q)
    u, p = d.TrialFunctions(W)
    v, q_ = d.TestFunctions(W)
    x = d.SpatialCoordinate(mesh)
    pi, sin, cos = d.pi, d.sin, d.cos
    u_ex = d.as_vector([pi * sin(pi * x[0]) * cos(pi * x[1]),
                        -pi * cos(pi * x[0]) * sin(pi * x[1])])
    f = d.as_vector([
        2 * pi ** 2 * pi * sin(pi * x[0]) * cos(pi * x[1])
        - pi * sin(pi * x[0]) * sin(pi * x[1]),
        -2 * pi ** 2 * pi * cos(pi * x[0]) * sin(pi * x[1])
        + pi * cos(pi * x[0]) * cos(pi * x[1])])
    ng, nf, h = pkg.normal(phi), d.FacetNormal(mesh), d.CellDiameter(mesh)

    def traction(w, r):
        return d.dot(d.grad(w), ng) - r * ng

    gu, gp_, gg = demo_stokes.GAMMA_U, demo_stokes.GAMMA_P, \
        demo_stokes.GAMMA_G
    a = d.inner(d.grad(u), d.grad(v)) * dxo
    a += -p * d.div(v) * dxo + d.div(u) * q_ * dxo
    a += -d.inner(traction(u, p), v) * dxg
    a += -d.inner(traction(v, q_), u) * dxg
    a += gu / h * d.inner(u, v) * dxg
    a += gg * d.avg(h) * d.inner(d.jump(d.grad(u), nf),
                                 d.jump(d.grad(v), nf)) * dSg
    a += gp_ * d.avg(h) ** 3 * d.inner(d.jump(d.grad(p), nf),
                                       d.jump(d.grad(q_), nf)) * dSp
    L = d.inner(f, v) * dxo - d.inner(traction(v, q_), u_ex) * dxg
    L += gu / h * d.inner(u_ex, v) * dxg
    return dict(pkg=pkg, fem=fem, d=d, mesh=mesh, V=V, Q=Q,
                ab=fem.extract_blocks(a, dtype=f64),
                Lb=fem.extract_blocks(L, dtype=f64),
                af=fem.form(a, dtype=f64), Lf=fem.form(L, dtype=f64),
                ext=mesh.exterior_facets)


@pytest.fixture(scope="module")
def port():
    return stokes_problem(ct, device="cpu")


@pytest.fixture(scope="module")
def ref():
    return stokes_problem(cj)


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


def test_block_forms_and_sparsity_match_reference(ref, port):
    """Every block of the Stokes form entry by entry, both load-vector
    blocks, and each block's sparsity pattern (deactivation diagonal
    included on the square ones)."""
    for rj, rt in zip(ref["ab"], port["ab"]):
        for bj, bt in zip(rj, rt):
            assert bt.block == bj.block
            _csr_equal(cj.fem.assemble_matrix(bj), ct.fem.assemble_matrix(bt))
            sj = cj.fem.create_sparsity_pattern(bj)
            st = ct.fem.create_sparsity_pattern(bt)
            assert st.dtype == sj.dtype and st.shape == sj.shape
            assert abs(st - sj).nnz == 0
            assert ct.fem.create_matrix(bt).shape == st.shape
    assert len(port["Lb"]) == 2
    for vj, vt in zip(ref["Lb"], port["Lb"]):
        assert rel_err(cj.fem.assemble_vector(vj),
                       ct.fem.assemble_vector(vt)) < 1e-12
    # no extension term adds no pair block (the terms themselves:
    # tests/test_torch_extensions.py)
    s00 = ct.fem.create_sparsity_pattern(port["ab"][0][0])
    assert abs(ct.fem.create_sparsity_pattern(port["ab"][0][0],
                                              extension_terms=[]) - s00
               ).nnz == 0


def test_monolithic_form_equals_block_composition(ref, port):
    """fem.form of the mixed expression is a MixedCutForm whose matrix and
    vector are the block compositions exactly (tests/
    test_mixed_monolithic.py on the port), on one device, and equal the
    reference's monolithic ones."""
    af, Lf, V, Q = port["af"], port["Lf"], port["V"], port["Q"]
    assert isinstance(af, ct.fem.MixedCutForm) and af.rank == 2
    assert af.device == torch.device("cpu") and af.dtype == torch.float64
    assert {b.device for b in ct.fem._flat(af.blocks)} == {af.device}
    assert list(af.test_offsets) == [0, V.dim, V.dim + Q.dim]
    A_mono = ct.fem.assemble_matrix(af).to_scipy()
    A_blk = ct.fem.assemble_matrix_block(port["ab"]).to_scipy()
    by_hand = sps.bmat([[ct.fem.assemble_matrix(b).to_scipy() for b in row]
                        for row in port["ab"]], format="csr")
    assert A_mono.shape == (af.dim, af.dim)
    assert abs(A_mono - A_blk).max() == 0.0
    assert abs(A_mono - by_hand).max() == 0.0
    b_mono = ct.fem.assemble_vector(Lf)
    assert b_mono.shape == (af.dim,) and b_mono.device == af.device
    assert torch.equal(b_mono, ct.fem.assemble_vector_block(port["Lb"],
                                                            (V, Q)))
    _csr_equal(cj.fem.assemble_matrix(ref["af"]), ct.fem.assemble_matrix(af))
    assert rel_err(cj.fem.assemble_vector(ref["Lf"]), b_mono) < 1e-12
    with pytest.raises(NotImplementedError, match="per block"):
        ct.fem.assemble_matrix(af, bcs=[object()])


def test_mixed_active_domain_and_deactivation_match_reference(ref, port):
    dj = cj.fem.active_domain(ref["af"])
    dt = ct.fem.active_domain(port["af"])
    assert isinstance(dt, ct.fem.MixedActiveDomain)
    assert np.array_equal(dj.active_mask, dt.active_mask)
    assert np.array_equal(dj.inactive_dofs, dt.inactive_dofs)
    assert dt.inactive_dofs.size > 0
    for i, sp in enumerate((port["V"], port["Q"])):
        assert dt.sub(i).function_space is sp
        assert np.array_equal(dj.sub(i).inactive_dofs,
                              dt.sub(i).inactive_dofs)
    Aj, bj = cj.fem.deactivate_outside(
        cj.fem.assemble_matrix(ref["af"]),
        np.array(cj.fem.assemble_vector(ref["Lf"])), dj)
    At, bt = ct.fem.deactivate_outside(
        ct.fem.assemble_matrix(port["af"]),
        ct.fem.assemble_vector(port["Lf"]), dt)
    _csr_equal(Aj, At)
    assert isinstance(bt, torch.Tensor) and rel_err(bj, bt) < 1e-12
    assert not host(bt)[dt.inactive_dofs].any()
    assert ct.fem.zero_rows(At).size == 0


def test_strong_bcs_and_lifting_match_reference(ref, port):
    """dirichletbc of every value kind, locate_dofs_*, assemble_matrix(bcs=)
    (same pattern, values to 1e-12), apply_lifting, set_bc and
    insert_diagonal on the velocity block against the reference; on an
    off-diagonal block the port zeroes the columns of the trial space's
    conditions only."""
    rng = np.random.default_rng(5)
    bcs = {}
    for P in (ref, port):
        pkg, fem, V, mesh = P["pkg"], P["fem"], P["V"], P["mesh"]
        mid = mesh.midpoints(mesh.tdim - 1, P["ext"])
        left = P["ext"][np.abs(mid[:, 0] + 1.0) < 1e-12]
        top = P["ext"][np.abs(mid[:, 1] - 1.0) < 1e-12]
        g = pkg.Function(V, **({} if pkg is cj else {"dtype": torch.float64}))
        g.interpolate(lambda x: np.stack((1.0 - x[1] ** 2, x[0] * x[1])))
        const = (pkg.Constant(np.array([0.5, -2.0])) if pkg is cj
                 else P["d"].ConstantExpr(np.array([0.5, -2.0])))
        right = fem.locate_dofs_geometrical(V, lambda x: np.isclose(x[0],
                                                                    1.0))
        bottom = fem.locate_dofs_geometrical(V, lambda x: np.isclose(x[1],
                                                                     -1.0))
        per_dof = np.random.default_rng(7).standard_normal(right.size)
        bcs[P["pkg"]] = [
            fem.dirichletbc(g, fem.locate_dofs_topological(
                V, mesh.tdim - 1, left), V),
            fem.dirichletbc(const, fem.locate_dofs_topological(
                V, mesh.tdim - 1, top), V),
            fem.dirichletbc(np.array([3.0, 4.0]), bottom, V),
            fem.dirichletbc(per_dof, right, V),
            fem.dirichletbc(0.25, bottom[:4], V)]
    for bj, bt in zip(bcs[cj], bcs[ct]):
        assert np.array_equal(bj.dofs, bt.dofs) and bt.dofs.size > 0
        assert rel_err(bj.values, bt.values) < 1e-15
    # the reference's vector-valued Function carried across by interop
    gj = cj.Function(ref["V"])
    gj.interpolate(lambda x: np.stack((np.sin(3 * x[0]), x[1] ** 3)))
    gt = interop.function_from_reference(port["V"], np.asarray(gj.x))
    dofs = bcs[ct][0].dofs
    assert np.array_equal(
        cj.fem.dirichletbc(gj, dofs, ref["V"]).values,
        ct.fem.dirichletbc(gt, dofs, port["V"]).values)
    a00j, a00t = ref["ab"][0][0], port["ab"][0][0]
    _csr_equal(cj.fem.assemble_matrix(a00j, bcs=bcs[cj]),
               ct.fem.assemble_matrix(a00t, bcs=bcs[ct]))
    b0 = rng.standard_normal(port["V"].dim)
    lj = cj.fem.apply_lifting(b0, [a00j], [bcs[cj]], scale=0.5)
    lt = ct.fem.apply_lifting(torch.tensor(b0), [a00t], [bcs[ct]],
                              scale=0.5)
    assert isinstance(lt, torch.Tensor) and rel_err(lj, lt) < 1e-12
    sj = cj.fem.set_bc(np.array(lj), bcs[cj], scale=2.0)
    st = ct.fem.set_bc(lt, bcs[ct], scale=2.0)
    assert rel_err(sj, st) < 1e-12
    sn = ct.fem.set_bc(np.array(lj), bcs[ct], scale=2.0)
    assert rel_err(sj, sn) < 1e-12
    rows = np.unique(bcs[ct][0].dofs)
    _csr_equal(cj.fem.insert_diagonal(cj.fem.assemble_matrix(a00j), rows,
                                      2.5),
               ct.fem.insert_diagonal(ct.fem.assemble_matrix(a00t), rows,
                                      2.5))
    # the (pressure, velocity) block: no row of it is a velocity dof, so
    # only its columns are zeroed, and it gets no diagonal
    a10 = port["ab"][1][0]
    cols = np.unique(np.concatenate([bc.dofs for bc in bcs[ct]]))
    want = ct.fem.assemble_matrix(a10).to_scipy().tolil()
    want[:, cols] = 0.0
    got = ct.fem.assemble_matrix(a10, bcs=bcs[ct]).to_scipy()
    assert abs(got - want.tocsr()).max() == 0.0
    assert not got[:, cols].count_nonzero()


def test_square_form_over_two_equal_spaces_raises():
    """Fault C1: strong conditions on a square form whose test and trial
    spaces are two objects of one space. With two objects the port raises
    ValueError in assemble_matrix(bcs=) and apply_lifting (it cannot tell
    a diagonal block from an off-diagonal one of two equal fields); with
    one object the matrix equals the reference's exactly: the rows and
    columns of the 5 dofs at x = 0 zeroed, 1.0 on the diagonal, full
    rank."""
    def square(pkg, **kw):
        d = importlib.import_module(pkg.__name__ + ".forms.dsl")
        Measure = importlib.import_module(
            pkg.__name__ + ".forms.measure").Measure
        mesh = pkg.mesh.create_unit_square(4)
        V1 = pkg.functionspace(mesh, ("Lagrange", 1), **kw)
        V2 = pkg.functionspace(mesh, ("Lagrange", 1), **kw)
        dx = Measure("dx", domain=mesh)
        fkw = {"dtype": torch.float64} if kw else {}
        forms = {k: pkg.fem.form(d.inner(d.grad(d.TrialFunction(U)),
                                         d.grad(d.TestFunction(V1))) * dx,
                                 **fkw)
                 for k, U in (("two", V2), ("one", V1))}
        dofs = pkg.fem.locate_dofs_geometrical(
            V1, lambda x: np.isclose(x[0], 0.0))
        return forms, pkg.fem.dirichletbc(0.0, dofs, V1), V2, dofs

    (fj, bcj, _, dofs_j), (ft, bct, V2t, dofs_t) = \
        square(cj), square(ct, device="cpu")
    assert np.array_equal(dofs_j, dofs_t) and dofs_t.size == 5
    with pytest.raises(ValueError, match="one space object"):
        ct.fem.assemble_matrix(ft["two"], bcs=[bct])
    with pytest.raises(ValueError, match="one space object"):
        ct.fem.apply_lifting(np.zeros(V2t.dim), [ft["two"]], [[bct]])
    # a condition on the trial space's equal twin is as ambiguous
    with pytest.raises(ValueError, match="one space object"):
        ct.fem.assemble_matrix(
            ft["one"], bcs=[ct.fem.dirichletbc(0.0, dofs_t, V2t)])
    Aj = cj.fem.assemble_matrix(fj["one"], bcs=[bcj]).to_scipy()
    At = ct.fem.assemble_matrix(ft["one"], bcs=[bct]).to_scipy()
    # exact: the same pattern and values, rows and columns zeroed, 1.0 on
    # the constrained diagonal
    assert abs(Aj - At).max() == 0.0
    dense = At.toarray()
    keep = np.setdiff1d(np.arange(dense.shape[0]), dofs_t)
    assert not dense[np.ix_(dofs_t, keep)].any()
    assert not dense[np.ix_(keep, dofs_t)].any()
    assert np.array_equal(np.diag(dense)[dofs_t], np.ones(5))
    assert np.linalg.matrix_rank(dense) == dense.shape[0]


def test_manufactured_errors_match_reference():
    """demo_stokes.run_manufactured(8), through extract_blocks and through
    the MixedCutForm, against tests/test_stokes.py's solve_cut_stokes(8)."""
    eu, ep = solve_cut_stokes(N_STOKES)
    for monolithic in (False, True):
        out = demo_stokes.run_manufactured(N_STOKES, device="cpu",
                                           monolithic=monolithic)
        assert abs(out["err_u"] - eu) < 1e-10 * eu
        assert abs(out["err_p"] - ep) < 1e-10 * ep
        assert out["active_dofs"] < out["dofs"]


def reference_cylinder(n):
    """demos/demo_stokes.py's steps in cutfemx_tpu at size n, returning
    what it prints (flux in and out, |u| on the cylinder, max |u|)."""
    from cutfemx_tpu.forms.dsl import (CellDiameter, CoefficientExpr,
                                       FacetNormal, MixedFunctionSpace,
                                       TestFunctions, TrialFunctions,
                                       as_vector, avg, div, dot, grad,
                                       inner, jump)
    from cutfemx_tpu.forms.measure import Measure
    from scipy.sparse import bmat, csr_matrix
    from scipy.sparse.linalg import spsolve
    fem = cj.fem
    nu = demo_stokes.NU
    gamma_u, gamma_p, gamma_g = (demo_stokes.GAMMA_U, demo_stokes.GAMMA_P,
                                 demo_stokes.GAMMA_G)
    center, radius = demo_stokes.CENTER, demo_stokes.RADIUS
    mesh = cj.mesh.create_rectangle((-3.0, -1.0), (5.0, 1.0), (4 * n, n))
    phi = cj.Function(cj.functionspace(mesh, ("Lagrange", 1)), name="phi")
    phi.interpolate(lambda x: np.sqrt((x[0] - center[0]) ** 2
                                      + (x[1] - center[1]) ** 2) - radius)
    cd = cj.cut(phi)
    fluid = cj.locate_entities(cd, "phi>0")
    cut_cells = cj.locate_entities(cd, "phi=0")
    rules = cj.runtime_quadrature(cd, "phi>0", 4)
    irules = cj.runtime_quadrature(cd, "phi=0", 4)
    gp = cj.ghost_penalty_facets(cd, "phi>0")
    p_facets = cj.interior_facets_for_cells(mesh,
                                            np.union1d(fluid, cut_cells))
    dxo = Measure("dx", domain=mesh, subdomain_data=[fluid, rules])
    dxg = Measure("dx", domain=mesh, subdomain_data=irules)
    dSg = Measure("dS", domain=mesh, subdomain_data=gp)
    dSp = Measure("dS", domain=mesh, subdomain_data=p_facets)
    V = cj.functionspace(mesh, ("Lagrange", 1), shape=(2,))
    Q = cj.functionspace(mesh, ("Lagrange", 1))
    W = MixedFunctionSpace(V, Q)
    u, p = TrialFunctions(W)
    v, q = TestFunctions(W)
    ng = -1.0 * cj.normal(phi)
    nf = FacetNormal(mesh)
    h = CellDiameter(mesh)

    def traction(w, r):
        return nu * dot(grad(w), ng) - r * ng

    a = nu * inner(grad(u), grad(v)) * dxo
    a += -p * div(v) * dxo
    a += div(u) * q * dxo
    a += -inner(traction(u, p), v) * dxg
    a += -inner(traction(v, q), u) * dxg
    a += gamma_u * nu / h * inner(u, v) * dxg
    if gp.size:
        a += gamma_g * avg(h) * inner(jump(grad(u), nf),
                                      jump(grad(v), nf)) * dSg
    a += gamma_p * avg(h) ** 3 * inner(jump(grad(p), nf),
                                       jump(grad(q), nf)) * dSp
    L = inner(as_vector([0.0, 0.0]), v) * dxo
    ab = fem.extract_blocks(a)
    Lb = fem.extract_blocks(L)
    A = [[fem.assemble_matrix(blk) if blk is not None else None
          for blk in row] for row in ab]
    b = [np.zeros(V.dim), np.zeros(Q.dim)]
    for i, blk in enumerate(Lb):
        if blk is not None:
            b[i] = np.array(fem.assemble_vector(blk))
    ext = mesh.exterior_facets
    mid = mesh.midpoints(mesh.tdim - 1, ext)
    leftf = ext[np.abs(mid[:, 0] + 3.0) < 1e-12]
    wallf = ext[np.abs(np.abs(mid[:, 1]) - 1.0) < 1e-12]
    inflow = cj.Function(V)
    inflow.interpolate(lambda x: np.stack((1.0 - x[1] ** 2,
                                           np.zeros_like(x[0]))))
    bcs = [fem.dirichletbc(inflow, fem.locate_dofs_topological(
               V, mesh.tdim - 1, leftf), V),
           fem.dirichletbc(0.0, fem.locate_dofs_topological(
               V, mesh.tdim - 1, wallf), V)]
    fem.deactivate_outside_blocks(A, [fem.active_domain(ab[0][0]),
                                      fem.active_domain(ab[1][1])], b)
    dims = (V.dim, Q.dim)
    Ah = bmat([[blk.to_scipy().tocsr() if blk is not None else
                csr_matrix((dims[i], dims[j]))
                for j, blk in enumerate(row)]
               for i, row in enumerate(A)], format="lil")
    bfull = np.concatenate(b)
    g = np.zeros(V.dim + Q.dim)
    for bc in bcs:
        g[bc.dofs] = bc.values
    bfull -= np.asarray(Ah.tocsr() @ g)
    all_bc = np.unique(np.concatenate([bc.dofs for bc in bcs]))
    Ah[all_bc, :] = 0.0
    Ah[:, all_bc] = 0.0
    Ah[all_bc, all_bc] = 1.0
    bfull[all_bc] = g[all_bc]
    sol = spsolve(Ah.tocsr(), bfull)
    uh = cj.Function(V, name="u")
    uh.x = jnp.asarray(sol[:V.dim])
    ue = CoefficientExpr(uh)
    rightf = ext[np.abs(mid[:, 0] - 5.0) < 1e-12]

    def integral(expr):
        return float(fem.assemble_scalar(fem.form(expr)))

    flux_in = integral(dot(ue, nf) * Measure("ds", domain=mesh,
                                             subdomain_data=leftf))
    flux_out = integral(dot(ue, nf) * Measure("ds", domain=mesh,
                                              subdomain_data=rightf))
    rate = integral(inner(ue, ue) * dxg)
    return dict(flux_in=-flux_in, flux_out=flux_out,
                u_gamma=float(np.sqrt(max(rate, 0.0))),
                max_u=float(np.linalg.norm(np.asarray(uh.x).reshape(-1, 2),
                                           axis=1).max()))


def test_cylinder_demo_matches_reference():
    """demo_stokes.run(8) (dirichletbc + apply_lifting + set_bc on the
    assembled blocks) against the reference demo's steps (lil elimination
    of the monolithic matrix)."""
    want = reference_cylinder(N_STOKES)
    got = demo_stokes.run(N_STOKES, device="cpu")
    for key, val in want.items():
        assert abs(got[key] - val) < 1e-10 * abs(val), (key, got[key], val)
    assert got["bc_dofs"] > 0 and got["mass_defect"] < 1e-2
