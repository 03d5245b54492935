"""The preconditioner stack's coarse apply and solves in cutfemx_tpu_torch
against cutfemx_tpu on the bench problem in f64 (test_torch_stack.py's
fixtures: n = 8, r = 0.46, P2; CPU tensors)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from cutfemx_tpu import stencil as sj  # noqa: E402
from cutfemx_tpu_torch import stencil as st  # noqa: E402
from test_torch_core import host, rel_err  # noqa: E402
from test_torch_stack import (  # noqa: E402,F401  (fixtures)
    _seeded_grid_vector, port, port_fold2, ref, ref_fold2, twin)


def test_coarse_apply_on_identical_tensors(ref, twin):
    oj = ref["op"]
    r = _seeded_grid_vector(twin, 4)
    zj = sj._coarse_apply_body(oj.N, oj.nch, oj._c_sel, *oj._c_W,
                               oj._c_acinv, oj.active_grid, jnp.asarray(r))
    zt = st._coarse_apply_body(twin.N, twin.nch, twin._c_sel, *twin._c_W,
                               twin._c_acinv, twin.active_grid,
                               torch.as_tensor(r))
    assert float(np.abs(host(zj)).max()) > 0
    assert rel_err(zj, zt) < 1e-12


# -- the solves -----------------------------------------------------------------


@pytest.mark.parametrize("precond", ["asm", "asm-fold2"])
def test_solve_matches_reference(ref, port, ref_fold2, port_fold2, precond):
    """Iterations +-2 and x to 1e-6 on active dofs: the tolerances of
    tests/test_asm_from_fold.py and tests/test_stencil_coarse.py. 'asm' is
    the gather apply under the one-level M, 'asm-fold2' the folded apply
    under the two-level M; 'asm2' pairs the two and is held to 'asm-fold2'
    below."""
    if precond == "asm-fold2":
        (xj, itj), (xt, itt) = ref_fold2, port_fold2
    else:
        xj, itj, _ = ref["op"].solve_cg(ref["b"], rtol=1e-8, maxiter=800,
                                        precond=precond, refine=False)
        xt, itt, _ = port["op"].solve_cg(port["b"], rtol=1e-8, maxiter=800,
                                         precond=precond, refine=False)
    mask = ref["dom"].active_mask
    xj, xt = host(xj), host(xt)
    assert abs(int(itj) - itt) <= 2, (int(itj), itt)
    assert np.abs(xj - xt)[mask].max() < 1e-6 * np.abs(xj[mask]).max()


@pytest.mark.parametrize("precond", ["pallas", "asm2"])
def test_pallas_equals_fold2_in_the_port(port, port_fold2, precond):
    """The same operator under the same two-level M: 'pallas' by the same
    path, 'asm2' with the gather apply in place of the folded one."""
    x, its, _ = port["op"].solve_cg(port["b"], rtol=1e-8, maxiter=800,
                                    precond=precond, refine=False)
    x2, its2 = port_fold2
    assert abs(its - its2) <= 1
    assert rel_err(x2, x) < 1e-8


def test_solve_on_the_reference_stack(port, ref_fold2, twin):
    """The builds held fixed (the reference's tensors through interop):
    the port's apply and CG alone reproduce the reference's count."""
    itj = ref_fold2[1]
    b = port["b"]
    x, its, res = twin.solve_cg(b, rtol=1e-8, maxiter=800, precond="pallas",
                                refine=False)
    assert twin.build_log == {}              # nothing was built or adopted
    assert abs(itj - its) <= 1
    assert res <= 1e-8 * float(torch.linalg.norm(b))


def test_auto_picks_asm_on_cpu_tensors(port):
    op = port["op"]
    assert op._auto_precond() == "asm"
    xa, ita, _ = op.solve_cg(port["b"], rtol=1e-8, maxiter=800, refine=False)
    xb, itb, _ = op.solve_cg(port["b"], rtol=1e-8, maxiter=800,
                             precond="asm", refine=False)
    assert ita == itb and torch.equal(xa, xb)
