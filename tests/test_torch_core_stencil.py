"""The interior-stencil kernel's plain version in cutfemx_tpu_torch: A x
per full cube (against a numpy loop), the reference grid apply's A^T x,
the JAX package's Pallas kernel itself (interpret mode on the CPU) on the
same seeded inputs, and the wrapper's routing and input checks."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from cutfemx_tpu_torch.interior_stencil import (  # noqa: E402
    interior_stencil_apply, interior_stencil_apply_reference)
from test_torch_core import host, rel_err  # noqa: E402
from test_torch_cuda import stencil_inputs as _stencil_inputs  # noqa: E402


# -- the interior-stencil kernel's plain version ----------------------------


def _stencil_loop(n, N, nch, table, A, mask, X):
    """Per-cube numpy loop: y_sp = sum_s A[sp, s] x_s (A x per cube)."""
    Xg = X.reshape(nch, N, N, N)
    Y = np.zeros_like(Xg, dtype=np.float64)
    for q in zip(*np.nonzero(mask)):
        xs = np.array([Xg[ch, q[0] + o[0], q[1] + o[1], q[2] + o[2]]
                       for ch, o in table], np.float64)
        ys = A.astype(np.float64) @ xs
        for (ch, o), y in zip(table, ys):
            Y[ch, q[0] + o[0], q[1] + o[1], q[2] + o[2]] += y
    return Y.reshape(-1)


@pytest.mark.parametrize("deg", [1, 2])
def test_interior_reference_is_A_times_x(deg):
    n = 4
    table, nch, N, A, mask, X = _stencil_inputs(n, deg, np.float64)
    assert not np.allclose(A, A.T)
    y = interior_stencil_apply_reference(
        n, N, nch, table, torch.as_tensor(A),
        torch.as_tensor(mask.astype(np.uint8)), torch.as_tensor(X))
    y_loop = _stencil_loop(n, N, nch, table, A, mask, X)
    assert rel_err(y_loop, y) < 1e-14


def test_reference_grid_apply_uses_A_transpose():
    """cutfemx_tpu's _grid_apply_body contracts "xyzl,lm->xyzm", i.e.
    A^T x per cube, while its Pallas kernel and the element path compute
    A x; they agree only for symmetric A. The port keeps A x: its plain
    version with A^T equals the reference's interior with A."""
    n = 4
    table, nch, N, A, mask, X = _stencil_inputs(n, 2, np.float64, seed=1)
    Xg = jnp.asarray(X).reshape(nch, N, N, N)
    xc = jnp.stack([Xg[ch, dx:dx + n, dy:dy + n, dz:dz + n]
                    for ch, (dx, dy, dz) in table], axis=-1)
    yc = jnp.where(jnp.asarray(mask)[..., None],
                   jnp.einsum("xyzl,lm->xyzm", xc, jnp.asarray(A)), 0.0)
    Y = jnp.zeros_like(Xg)
    for s, (ch, (dx, dy, dz)) in enumerate(table):
        Y = Y.at[ch, dx:dx + n, dy:dy + n, dz:dz + n].add(yc[..., s])
    y_t = interior_stencil_apply_reference(
        n, N, nch, table, torch.as_tensor(A.T.copy()),
        torch.as_tensor(mask.astype(np.uint8)), torch.as_tensor(X))
    assert rel_err(Y.reshape(-1), y_t) < 1e-14


@pytest.mark.parametrize("n,deg,dtype,tol", [
    (6, 2, np.float64, 1e-14), (6, 2, np.float32, 2e-6),
    (5, 1, np.float64, 1e-14)])
def test_interior_stencil_matches_pallas_kernel(n, deg, dtype, tol):
    """The port's interior stencil against the JAX package's Pallas kernel
    itself (interpret mode on the CPU, as tests/test_pallas_stencil.py runs
    it) on the same seeded inputs: a non-symmetric A and a random mask.
    Tolerances times max|y|: 2e-6 in f32 (test_pallas_stencil.py's), 1e-14
    in f64 (both sum 27-term rows, in other orders)."""
    from cutfemx_tpu.pallas_stencil import interior_stencil_apply as pallas
    from cutfemx_tpu.pallas_stencil import pad_mask_for_stencil
    table, nch, N, A, mask, X = _stencil_inputs(n, deg, dtype, seed=3)
    assert not np.allclose(A, A.T)
    y_pl = pallas(n, N, nch, table, A, pad_mask_for_stencil(mask, n, T=8),
                  jnp.asarray(X), T=8, interpret=True)
    y = interior_stencil_apply(n, N, nch, table, torch.as_tensor(A),
                               torch.as_tensor(mask.astype(np.uint8)),
                               torch.as_tensor(X))
    y_pl = host(y_pl)
    assert y_pl.dtype == dtype
    assert np.abs(y_pl).max() > 0
    assert rel_err(y_pl, y) < tol


def test_wrapper_routes_cpu_to_plain_version_and_checks_inputs():
    n = 3
    table, nch, N, A, mask, X = _stencil_inputs(n, 2, np.float32)
    args = (n, N, nch, table, torch.as_tensor(A),
            torch.as_tensor(mask.astype(np.uint8)))
    Xt = torch.as_tensor(X)
    from cutfemx_tpu_torch import interior_stencil as ist
    before = ist.launches
    assert torch.equal(interior_stencil_apply(*args, Xt),
                       interior_stencil_apply_reference(*args, Xt))
    assert ist.launches == before        # the CPU never counts a launch
    with pytest.raises(ValueError):
        interior_stencil_apply(*args, Xt[:-1])
    with pytest.raises(ValueError):
        interior_stencil_apply(*args, Xt.to("meta"))
    with pytest.raises(TypeError):
        interior_stencil_apply(*args, Xt.to(torch.int32))
    with pytest.raises(ValueError):      # A in another dtype than X
        interior_stencil_apply(*args, Xt.double())
