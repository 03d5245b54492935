"""The element-batched CutOperator of cutfemx_tpu_torch against its own
assembled CSR matrix and against cutfemx_tpu's CutOperator, on the 2D
flower problem in f64 on the CPU (the reference on the port's runtime
quadrature): apply, diagonal, power iteration and solve_cg with Jacobi and
Chebyshev preconditioning."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import cutfemx_tpu as cj  # noqa: E402
import cutfemx_tpu_torch as ct  # noqa: E402
from test_torch_core import host, rel_err  # noqa: E402
from test_torch_flower import flower_problem  # noqa: E402


@pytest.fixture(scope="module")
def port():
    P = flower_problem(ct, device="cpu")
    P["op"] = ct.fem.CutOperator(P["af"], P["dom"])
    P["b"] = ct.fem.assemble_vector(P["Lf"])
    return P


@pytest.fixture(scope="module")
def ref(port):
    P = flower_problem(cj, rules=port)
    P["op"] = cj.fem.CutOperator(P["af"], P["dom"])
    P["b"] = jnp.asarray(host(port["b"]))
    return P


def _active_csr(P):
    """The port's own assembled matrix with the operator's masking: A on
    the active block, the identity on inactive dofs."""
    A = ct.fem.assemble_matrix(P["af"]).to_scipy().tocsr()
    return A, P["dom"].active_mask


def test_apply_matches_assembled_matrix_and_reference(ref, port):
    op = port["op"]
    A, active = _active_csr(port)
    rng = np.random.default_rng(3)
    for _ in range(2):
        x = rng.standard_normal(op.dim)
        y = op(torch.as_tensor(x))
        assert y.dtype == torch.float64
        y_csr = np.where(active, A @ np.where(active, x, 0.0), x)
        assert rel_err(y_csr, y) < 1e-12
        assert rel_err(ref["op"](jnp.asarray(x)), y) < 1e-12
    # the plan merged the volume and interface batches of the cut cells
    # and compressed the facet pairs' duplicate dofs (6 listed, 4 unique)
    raw = sum(int(r.size) for r in op._rows_host)
    packed = sum(int(r.numel()) for r in op._rows)
    assert packed < raw
    assert packed == sum(int(np.asarray(r).size) for r in ref["op"]._rows)
    # a row-sorted segment sum: the same bits on every apply
    x = torch.as_tensor(rng.standard_normal(op.dim))
    assert torch.equal(op(x), op(x))


def test_diagonal_matches_assembled_matrix_and_reference(ref, port):
    A, active = _active_csr(port)
    d = port["op"].diagonal()
    assert rel_err(np.where(active, A.diagonal(), 1.0), d) < 1e-12
    assert rel_err(ref["op"].diagonal(), d) < 1e-12


def test_power_iteration_matches_reference(ref, port):
    from cutfemx_tpu import la as laj
    from cutfemx_tpu_torch import la as lat
    op = port["op"]
    d = op.diagonal()
    lt = lat.power_iteration_lmax(op, d, op.dim)
    lj = laj.power_iteration_lmax(ref["op"], ref["op"].diagonal(),
                                  op.dim)
    assert abs(float(lj) - float(lt)) < 1e-12 * abs(float(lj))


@pytest.mark.parametrize("precond", ["jacobi", "chebyshev"])
def test_solve_cg_matches_reference(ref, port, precond):
    """The reference's own rtol and maxiter (demos/demo_poisson.py); the
    same count, and x to 1e-10 of its largest entry."""
    xj, itj, resj = ref["op"].solve_cg(ref["b"], rtol=1e-10, maxiter=2000,
                                       precond=precond)
    xt, itt, rest = port["op"].solve_cg(port["b"], rtol=1e-10,
                                        maxiter=2000, precond=precond)
    assert itt == int(itj), (itt, int(itj))
    assert rel_err(xj, xt) < 1e-10
    active = port["dom"].active_mask
    b = np.where(active, host(port["b"]), 0.0)
    r = np.where(active, b - host(port["op"](xt)), 0.0)
    assert np.linalg.norm(r) <= 1e-10 * np.linalg.norm(b) * 1.01


def test_operator_options(port):
    """precond='none' converges, an unknown one raises; an operator built
    with apply_plan=False (the stencil operator's element data) cannot be
    applied, and StencilCutOperator asks for exactly that."""
    op = port["op"]
    x, its, _ = op.solve_cg(port["b"], rtol=1e-8, maxiter=2000,
                            precond="none")
    assert 0 < its < 2000 and torch.isfinite(x).all()
    with pytest.raises(ValueError, match="unknown precond"):
        op.solve_cg(port["b"], precond="ssor")
    bare = ct.fem.CutOperator(port["af"], port["dom"], apply_plan=False)
    assert not hasattr(bare, "_perm")
    for call in (lambda: bare(port["b"]), bare.diagonal,
                 lambda: bare.solve_cg(port["b"])):
        with pytest.raises(RuntimeError, match="apply_plan=False"):
            call()
    import inspect
    from cutfemx_tpu_torch import stencil
    src = inspect.getsource(stencil.StencilCutOperator.__init__)
    assert "CutOperator(form, domain, apply_plan=False)" in src
