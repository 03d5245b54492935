"""cutfemx_tpu_torch on a CUDA card: the hand-written kernel against its
plain version, and run-to-run determinism of the grid apply.

Imports neither JAX nor cutfemx_tpu, so it runs on a machine without
them: ``python -m pytest --noconftest tests/test_torch_cuda.py``. Every
test here needs a card and skips without one."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from cutfemx_tpu_torch.interior_stencil import (  # noqa: E402
    interior_stencil_apply, interior_stencil_apply_reference)
from cutfemx_tpu_torch.stencil import _local_dof_table  # noqa: E402


def stencil_inputs(n, deg, dtype, seed=0):
    """Seeded numpy inputs at the kernel's layout: a random cube mask, a
    NON-symmetric A and a random grid vector."""
    rng = np.random.default_rng(seed)
    table = _local_dof_table(deg)
    L, nch, N = len(table), (8 if deg == 2 else 1), n + 1
    A = rng.standard_normal((L, L))
    mask = rng.random((n, n, n)) < 0.6
    X = rng.standard_normal(nch * N ** 3)
    return table, nch, N, A.astype(dtype), mask, X.astype(dtype)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("deg", [1, 2])
@pytest.mark.parametrize("dtype,tol", [(np.float32, 2e-6),
                                       (np.float64, 1e-12)])
def test_kernel_matches_plain_version(cuda_device, deg, dtype, tol):
    """Tolerances: tests/test_pallas_stencil.py's 2e-6 max|y| in f32;
    1e-12 max|y| in f64 (both sum 27-term rows in one order)."""
    from cutfemx_tpu_torch import interior_stencil as ist
    n = 12
    table, nch, N, A, mask, X = stencil_inputs(n, deg, dtype, seed=2)
    args = [torch.as_tensor(a).to(cuda_device)
            for a in (A, mask.astype(np.uint8), X)]
    before = ist.launches
    y = interior_stencil_apply(n, N, nch, table, *args)
    torch.cuda.synchronize()
    assert ist.launches == before + 1
    y_ref = interior_stencil_apply_reference(n, N, nch, table, *args)
    assert float((y - y_ref).abs().max()) <= tol * float(y_ref.abs().max())


@pytest.mark.cuda
def test_grid_apply_is_deterministic_on_the_card(cuda_device):
    """The element path sums with a sorted segment sum, not atomics: two
    applies on one input agree bitwise."""
    import cutfemx_tpu_torch as ct
    from cutfemx_tpu_torch import fem
    from cutfemx_tpu_torch.forms.dsl import (CellDiameter, FacetNormal,
                                             TestFunction, TrialFunction,
                                             avg, dot, grad, inner, jump)
    from cutfemx_tpu_torch.forms.measure import Measure
    from cutfemx_tpu_torch.stencil import (StencilCutOperator,
                                           _grid_apply_body)
    mesh = ct.mesh.create_box((-1, -1, -1), (1, 1, 1), (8, 8, 8))
    Vphi = ct.functionspace(mesh, ("Lagrange", 1), device=cuda_device)
    phi = ct.Function(Vphi, name="phi", dtype=torch.float64)
    phi.interpolate(lambda x: np.sqrt(x[0]**2 + x[1]**2 + x[2]**2) - 0.46)
    V = ct.functionspace(mesh, ("Lagrange", 2), device=cuda_device)
    cd = ct.cut(phi)
    dxo = Measure("dx", domain=mesh, subdomain_data=[
        ct.locate_entities(cd, "phi<0"), ct.runtime_quadrature(cd, "phi<0",
                                                              4)])
    dxg = Measure("dx", domain=mesh,
                  subdomain_data=ct.runtime_quadrature(cd, "phi=0", 4))
    dSg = Measure("dS", domain=mesh,
                  subdomain_data=ct.ghost_penalty_facets(cd, "phi<0"))
    u, v = TrialFunction(V), TestFunction(V)
    ng, nf, h = ct.normal(phi), FacetNormal(mesh), CellDiameter(mesh)
    a = inner(grad(u), grad(v)) * dxo
    a += (-dot(grad(u), ng) * v - dot(grad(v), ng) * u
          + 40.0 / h * u * v) * dxg
    a += 0.1 * avg(h) * inner(jump(grad(u), nf), jump(grad(v), nf)) * dSg
    af = fem.form(a, dtype=torch.float32)
    op = StencilCutOperator(af, fem.active_domain(af))
    x = torch.randn(op.gsize, device=cuda_device)
    y1 = _grid_apply_body(*op._grid_statics(), *op._grid_arrays(), x)
    y2 = _grid_apply_body(*op._grid_statics(), *op._grid_arrays(), x)
    assert torch.equal(y1, y2)
