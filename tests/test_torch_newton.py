"""Nonlinear residuals with AD-exact Newton Jacobians and BiCGStab in
cutfemx_tpu_torch against cutfemx_tpu, in f64 on the CPU: ``derivative``'s
Jacobian matrix, ``newton_solve`` on both problems of
tests/test_nonlinear.py (the fitted one at its n = 12, the cut disk at
n = 16) with its iteration count and |F| history, and ``la.bicgstab`` on an
element-batched CutOperator of a nonsymmetric form.

``newton_problem`` is also the source of chip_smoke.py's JAX-CPU Newton
counts (PERF.md section 4)."""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import cutfemx_tpu as cj  # noqa: E402
import cutfemx_tpu_torch as ct  # noqa: E402
from cutfemx_tpu_torch import interop  # noqa: E402
from test_torch_core import host, rel_err  # noqa: E402

N_FITTED, N_DISK = 12, 16
TOL = {"fitted": 1e-12, "disk": 1e-11}     # tests/test_nonlinear.py's


def newton_problem(pkg, which, n=None, device=None):
    """tests/test_nonlinear.py's residual F(u; v), its boundary conditions
    and its zero initial guess in ``pkg`` (the port on ``device``, f64):
    ``which`` is "fitted" (-div((1 + u^2) grad u) = f on the unit square,
    strong zero conditions) or "disk" (a cubic reaction on a cut disk with
    Nitsche conditions, the inactive dofs held at zero)."""
    fem = importlib.import_module(pkg.__name__ + ".fem")
    d = importlib.import_module(pkg.__name__ + ".forms.dsl")
    measure = importlib.import_module(pkg.__name__ + ".forms.measure")
    kw = {} if device is None else {"device": device}
    fkw = {} if device is None else {"dtype": torch.float64}
    if which == "fitted":
        mesh = pkg.mesh.create_unit_square(n or N_FITTED)
        V = pkg.functionspace(mesh, ("Lagrange", 1), **kw)
        u = pkg.Function(V, name="u", **fkw)
        v = d.TestFunction(V)
        x = d.SpatialCoordinate(mesh)
        uc = d.CoefficientExpr(u)
        u_ex = x[0] * (1 - x[0]) * x[1] * (1 - x[1])
        dx = measure.Measure("dx", domain=mesh)
        F = d.inner((1.0 + uc * uc) * d.grad(uc), d.grad(v)) * dx
        F -= d.inner((1.0 + u_ex * u_ex) * d.grad(u_ex), d.grad(v)) * dx
        c = V.dof_coordinates
        onb = ((np.abs(c[:, 0]) < 1e-12) | (np.abs(c[:, 0] - 1) < 1e-12)
               | (np.abs(c[:, 1]) < 1e-12) | (np.abs(c[:, 1] - 1) < 1e-12))
        bcs = [fem.dirichletbc(0.0, np.flatnonzero(onb), V)]
    else:
        r, gamma = 0.6, 40.0
        mesh = pkg.mesh.create_rectangle((-1, -1), (1, 1), (n or N_DISK,) * 2)
        phi = pkg.Function(pkg.functionspace(mesh, ("Lagrange", 1), **kw),
                           name="phi", **fkw)
        phi.interpolate(lambda X: np.sqrt(X[0] ** 2 + X[1] ** 2) - r)
        cd = pkg.cut(phi)
        dxo = measure.Measure("dx", domain=mesh, subdomain_data=[
            pkg.locate_entities(cd, "phi<0"),
            pkg.runtime_quadrature(cd, "phi<0", 2)])
        dxg = measure.Measure("dx", domain=mesh, subdomain_data=
                              pkg.runtime_quadrature(cd, "phi=0", 2))
        V = pkg.functionspace(mesh, ("Lagrange", 1), **kw)
        u = pkg.Function(V, name="u", **fkw)
        v = d.TestFunction(V)
        x = d.SpatialCoordinate(mesh)
        ng, h = pkg.normal(phi), d.CellDiameter(mesh)
        uc = d.CoefficientExpr(u)
        u_ex = d.sin(d.pi * x[0]) * d.sin(d.pi * x[1])
        f = 2 * d.pi ** 2 * u_ex + u_ex ** 3
        F = d.inner(d.grad(uc), d.grad(v)) * dxo + (uc ** 3 - f) * v * dxo
        F += (-d.dot(d.grad(uc), ng) * v - d.dot(d.grad(v), ng) * (uc - u_ex)
              + gamma / h * (uc - u_ex) * v) * dxg
        # tests/test_nonlinear.py takes the trial function from cfx.ufl
        probe = fem.form(d.inner(d.grad(pkg.ufl.TrialFunction(V)),
                                 d.grad(v)) * dxo)
        bcs = [fem.dirichletbc(0.0, fem.active_domain(probe).inactive_dofs,
                               V)]
    u.interpolate(lambda X: 0.0 * X[0])
    return dict(pkg=pkg, fem=fem, V=V, u=u, F=F, bcs=bcs)


@pytest.fixture(scope="module")
def solved():
    """Both problems solved by newton_solve in both packages."""
    out = {}
    for which in ("fitted", "disk"):
        for pkg, dev in ((cj, None), (ct, "cpu")):
            P = newton_problem(pkg, which, device=dev)
            u, its, hist = P["fem"].newton_solve(P["F"], P["u"],
                                                 bcs=P["bcs"],
                                                 tol=TOL[which])
            out[which, pkg] = dict(P, its=its, hist=np.array(hist),
                                   x=host(u.x))
    return out


def test_derivative_jacobian_matches_reference():
    """The Jacobian of the cut-disk residual at a seeded nonzero state,
    with its bcs (same pattern, values to 1e-12), and the residual vector
    there."""
    vals = np.random.default_rng(11).standard_normal((N_DISK + 1) ** 2)
    mats, vecs = [], []
    for pkg, dtype in ((cj, None), (ct, torch.float64)):
        P = newton_problem(pkg, "disk", device=None if pkg is cj else "cpu")
        fem, u = P["fem"], P["u"]
        u.x = jnp.asarray(vals) if pkg is cj else torch.tensor(vals)
        J = fem.form(fem.derivative(P["F"], u), dtype=dtype)
        assert J.rank == 2 and J.trial_space is P["V"]
        mats.append(fem.assemble_matrix(J, bcs=P["bcs"]))
        vecs.append(fem.assemble_vector(fem.form(P["F"], dtype=dtype)))
    mj = interop.matrix_from_reference(mats[0]).to_scipy()
    mt = mats[1].to_scipy()
    mj.sort_indices()
    mt.sort_indices()
    assert np.array_equal(mj.indptr, mt.indptr)
    assert np.array_equal(mj.indices, mt.indices)
    assert rel_err(mj.data, mt.data) < 1e-12
    assert rel_err(vecs[0], vecs[1]) < 1e-12


@pytest.mark.parametrize("which", ["fitted", "disk"])
def test_newton_solve_matches_reference(solved, which):
    ref, port = solved[which, cj], solved[which, ct]
    assert port["its"] == ref["its"]
    assert rel_err(ref["hist"], port["hist"]) < 1e-8
    assert np.all(np.abs(port["hist"] - ref["hist"])
                  <= 1e-8 * np.abs(ref["hist"]) + 1e-15)
    assert port["hist"][-1] < TOL[which]
    assert rel_err(ref["x"], port["x"]) < 1e-10
    u = port["u"]
    assert isinstance(u.x, torch.Tensor) and u.x.dtype == torch.float64
    assert u.x.device == torch.device("cpu")


def _convection_operator(pkg, device=None, n=N_FITTED):
    """An element-batched CutOperator of the nonsymmetric
    convection-diffusion-reaction form on the unit square."""
    fem = importlib.import_module(pkg.__name__ + ".fem")
    d = importlib.import_module(pkg.__name__ + ".forms.dsl")
    measure = importlib.import_module(pkg.__name__ + ".forms.measure")
    kw = {} if device is None else {"device": device}
    mesh = pkg.mesh.create_unit_square(n)
    V = pkg.functionspace(mesh, ("Lagrange", 1), **kw)
    u, v = d.TrialFunction(V), d.TestFunction(V)
    beta = d.as_vector([8.0, -5.0])
    dx = measure.Measure("dx", domain=mesh)
    a = (d.inner(d.grad(u), d.grad(v)) + d.dot(beta, d.grad(u)) * v
         + u * v) * dx
    f = fem.form(a, **({} if device is None else {"dtype": torch.float64}))
    return fem.CutOperator(f), V


def test_bicgstab_matches_reference():
    """la.bicgstab with Jacobi on the element-batched operator: the
    reference's iteration count, solution and residual norm."""
    b = np.random.default_rng(3).standard_normal((N_FITTED + 1) ** 2)
    opj, _ = _convection_operator(cj)
    opt, V = _convection_operator(ct, device="cpu")
    dj, dt = opj.diagonal(), opt.diagonal()
    xj, itj, rj = cj.la.bicgstab(opj, jnp.asarray(b), M=lambda r: r / dj,
                                 rtol=1e-10, maxiter=500)
    bt = torch.tensor(b)
    xt, itt, rt = ct.la.bicgstab(opt, bt, M=lambda r: r / dt, rtol=1e-10,
                                 maxiter=500)
    assert int(itj) == itt and 0 < itt < 500
    assert rel_err(xj, xt) < 1e-10
    assert abs(float(rj) - float(rt)) < 1e-6 * float(rj) + 1e-14
    assert float(torch.linalg.norm(bt - opt(xt))) <= \
        1e-10 * float(torch.linalg.norm(bt)) * 1.0001
    # no preconditioner, a start vector
    _, it0, _ = ct.la.bicgstab(opt, bt, x0=xt, rtol=1e-10)
    assert it0 == 0
