"""The slice as it runs: f32 forms, Jacobi CG and the production stack
inside f64 iterative refinement, cutfemx_tpu_torch against cutfemx_tpu on
the bench problem (n = 8, r = 0.46, P2; CPU, the kernel's plain
version)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import cutfemx_tpu as cj  # noqa: E402
import cutfemx_tpu_torch as ct  # noqa: E402
from cutfemx_tpu.stencil import StencilCutOperator as StencilJ  # noqa: E402
from cutfemx_tpu_torch import interop  # noqa: E402
from cutfemx_tpu_torch.stencil import (  # noqa: E402
    StencilCutOperator as StencilT)
from test_torch_core import (bench_problem, reference_grid_state,  # noqa: E402
                             rel_err)

RTOL = 1e-6


@pytest.fixture(scope="module")
def ref():
    P = bench_problem(cj, np.float32)
    P["op"] = StencilJ(P["af"], P["dom"])
    return P


@pytest.fixture(scope="module")
def port():
    P = bench_problem(ct, torch.float32, device="cpu",
                      phi_dtype=torch.float64)
    P["op"] = StencilT(P["af"], P["dom"])
    return P


@pytest.fixture(scope="module")
def ref_its(ref):
    _, its, res = ref["op"].solve_cg(ref["b"], rtol=RTOL, maxiter=2000,
                                     precond="jacobi")
    assert res <= RTOL * float(jnp.linalg.norm(ref["b"]))
    return int(its)


# The IR iteration count at this size is sensitive to the last bit of the
# f32 data: the first inner solve stops where the residual crosses its
# 1e-3 target on a plateau. The reference itself moves between 164 and 169
# iterations when b changes by one f32 ulp in some entries (measured on
# the CPU), and the port sums in another order. Hence 5, not 2.
ITS_SLACK = 5


@pytest.mark.parametrize("state", ["own", "interop"])
def test_ir_solve_iterations_and_true_residual(ref, port, ref_its, state):
    if state == "own":
        op, b = port["op"], port["b"]
    else:
        op = interop.operator_from_reference(reference_grid_state(ref["op"]),
                                             "cpu", torch.float32)
        b = torch.tensor(np.asarray(ref["b"]))
    x, its, res = op.solve_cg(b, rtol=RTOL, maxiter=2000, precond="jacobi")
    assert x.dtype == torch.float32 and torch.isfinite(x).all()
    assert res <= RTOL * float(torch.linalg.norm(b.double()))
    assert abs(its - ref_its) <= ITS_SLACK, (its, ref_its)
    # the solution also solves the reference's assembled system (applied
    # in f64 with the reference's f32 matrices)
    op64 = interop.operator_from_reference(reference_grid_state(ref["op"]),
                                           "cpu", torch.float64)
    bj = torch.tensor(np.asarray(ref["b"]), dtype=torch.float64)
    r = torch.where(op64.active, bj - op64(x.double()), 0.0)
    assert float(torch.linalg.norm(r)) <= 1e-5 * float(torch.linalg.norm(bj))


def test_f32_assembly_matches_to_f32_rounding(ref, port):
    assert rel_err(ref["b"], port["b"]) < 1e-6
    assert rel_err(ref["op"].A_local, port["op"].A_local) < 1e-6
    for mj, mt in zip(ref["op"].rest_mats, port["op"].rest_mats):
        assert rel_err(mj, mt) < 1e-6


def test_grid_apply_is_deterministic(port):
    op = port["op"]
    x = torch.as_tensor(np.random.default_rng(4).standard_normal(
        op.gsize).astype(np.float32))
    Xf = torch.where(op.active_grid, x, 0.0)
    from cutfemx_tpu_torch.stencil import _grid_apply_body
    y1 = _grid_apply_body(*op._grid_statics(), *op._grid_arrays(), Xf)
    y2 = _grid_apply_body(*op._grid_statics(), *op._grid_arrays(), Xf)
    assert torch.equal(y1, y2)


def test_stack_ir_solve_iterations_and_true_residual(ref, port):
    """The production stack as the bench runs it: the reference with
    precond="asm-fold2" (the stack with its interior apply as an einsum;
    its Pallas kernel has only the slow interpret mode here), the port
    with precond="pallas". Both reach the tolerance by their own f64
    measurement, at iteration counts within the slack above."""
    xj, itj, resj = ref["op"].solve_cg(ref["b"], rtol=RTOL, maxiter=2000,
                                       precond="asm-fold2")
    assert resj <= RTOL * float(jnp.linalg.norm(ref["b"]))
    op, b = port["op"], port["b"]
    x, its, res = op.solve_cg(b, rtol=RTOL, maxiter=2000, precond="pallas")
    assert x.dtype == torch.float32 and torch.isfinite(x).all()
    assert res <= RTOL * float(torch.linalg.norm(b.double()))
    assert abs(its - int(itj)) <= ITS_SLACK, (its, int(itj))
    assert [op.build_log[s][0] for s in ("fold", "asm", "coarse")] == \
        ["built"] * 3
    # the true residual once more, by the gather apply in f64
    from cutfemx_tpu_torch.stencil import _grid_apply_body
    bg = op.vec_to_grid(torch.where(op.active, b, 0.0)).double()
    r = bg - _grid_apply_body(*op._grid_statics(), *op._grid_arrays_f64(),
                              op.vec_to_grid(x).double())
    r = torch.where(op.active_grid, r, 0.0)
    assert float(torch.linalg.norm(r)) <= RTOL * float(torch.linalg.norm(bg))
