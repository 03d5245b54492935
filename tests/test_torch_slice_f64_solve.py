"""cutfemx_tpu_torch against cutfemx_tpu on the bench problem in f64
(test_torch_slice_f64.py's fixtures: n = 8, r = 0.46, P2; CPU, the
kernel's plain version): the grid-layout apply, the Function round trip
and the Jacobi solve."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from cutfemx_tpu_torch import interop  # noqa: E402
from test_torch_core import host, reference_grid_state  # noqa: E402
from test_torch_slice_f64 import port, ref  # noqa: E402,F401  (fixtures)


# -- the grid-layout apply ----------------------------------------------------


@pytest.mark.parametrize("state", ["interop", "own"])
def test_grid_apply_matches(ref, port, state):
    """As tests/test_stencil.py::test_stencil_matches_element_apply: three
    seeded vectors, f64, 1e-12 relative."""
    oj = ref["op"]
    ot = port["op"] if state == "own" else interop.operator_from_reference(
        reference_grid_state(oj), "cpu", torch.float64)
    rng = np.random.default_rng(0)
    for _ in range(3):
        x = rng.standard_normal(ref["V"].dim)
        y0 = host(oj(jnp.asarray(x)))
        y1 = host(ot(torch.as_tensor(x)))
        assert np.abs(y0 - y1).max() < 1e-12 * max(np.abs(y0).max(), 1)
    d0, d1 = host(oj.diagonal()), host(ot.diagonal())
    assert np.abs(d0 - d1).max() < 1e-12 * np.abs(d0).max()


def test_function_from_reference_round_trips(ref, port):
    f = interop.function_from_reference(port["phi"].function_space,
                                        np.asarray(ref["phi"].x))
    assert torch.equal(f.x, port["phi"].x)


# -- the f64 Jacobi solve -----------------------------------------------------


def test_jacobi_solve_f64_matches(ref, port):
    """tests/test_stencil.py::test_stencil_solve_matches' oracle: like-
    preconditioned solves follow the same CG trajectory."""
    x0, it0, _ = ref["op"].solve_cg(ref["b"], rtol=1e-9, maxiter=2000,
                                    precond="jacobi", refine=False)
    x1, it1, _ = port["op"].solve_cg(port["b"], rtol=1e-9, maxiter=2000,
                                     precond="jacobi", refine=False)
    mask = ref["dom"].active_mask
    x0, x1 = host(x0), host(x1)
    assert np.abs(x0 - x1)[mask].max() < 1e-6 * np.abs(x0[mask]).max()
    assert abs(int(it0) - it1) <= 2


def test_unknown_precond_raises_value_error(port):
    for pc in ("ilu", "asm3", ""):
        with pytest.raises(ValueError, match="unknown precond"):
            port["op"].solve_cg(port["b"], precond=pc)
