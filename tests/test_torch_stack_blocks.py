"""Host-independent pieces of the preconditioner stack in
cutfemx_tpu_torch: the sorted scatter-add (a fixed summation order) and
the SPD block inverse against cutfemx_tpu's on one batch of good and bad
blocks."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from cutfemx_tpu import stencil as sj  # noqa: E402
from cutfemx_tpu_torch import stencil as st  # noqa: E402
from test_torch_core import host, rel_err  # noqa: E402


def test_sorted_scatter_add_sums_duplicates_in_a_fixed_order():
    rng = np.random.default_rng(8)
    idx = torch.as_tensor(rng.integers(0, 50, 4000))
    vals = torch.as_tensor(rng.standard_normal((4000, 3)).astype(np.float32))
    out = [torch.zeros(64, 3) for _ in range(2)]
    st._sorted_scatter_add(out[0], idx, vals)
    perm = torch.randperm(4000, generator=torch.Generator().manual_seed(1))
    # stable sort: the same multiset in the same per-index order
    order = torch.argsort(perm)
    st._sorted_scatter_add(out[1], idx[perm][order], vals[perm][order])
    assert torch.equal(out[0], out[1])
    want = torch.zeros(64, 3, dtype=torch.float64).index_add_(
        0, idx, vals.double())
    assert rel_err(want, out[0]) < 1e-6
    assert float(out[0][50:].abs().max()) == 0.0


def test_spd_inverse_device_replaces_bad_blocks():
    """A batch with one indefinite and one singular block: neither raises,
    the indefinite one comes back as its diagonal inverse (the scaled
    identity), and every block equals the reference's."""
    rng = np.random.default_rng(11)
    L = 6
    B = rng.standard_normal((5, L, L))
    blocks = B @ B.transpose(0, 2, 1) + L * np.eye(L)
    blocks[1] = np.diag(np.arange(1.0, L + 1))
    blocks[1][0, 1] = blocks[1][1, 0] = 4.0          # det of 2x2 < 0
    blocks[3] = np.ones((L, L))                       # rank one
    inv_t = host(st._spd_inverse_device(torch.as_tensor(blocks)))
    inv_j = host(sj._spd_inverse_device(jnp.asarray(blocks)))
    assert np.isfinite(inv_t).all()
    assert np.allclose(inv_t[1], np.diag(1.0 / np.diag(blocks[1])),
                       rtol=1e-12, atol=0)
    for k in range(5):
        assert rel_err(inv_j[k], inv_t[k]) < 1e-9, k
    good = inv_t[0] @ blocks[0]
    assert np.abs(good - np.eye(L)).max() < 1e-3     # ridge 1e-5, equilibrated
