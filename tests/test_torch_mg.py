"""Geometric multigrid (mg.py) in cutfemx_tpu_torch against cutfemx_tpu,
on the CPU: the grid transfers, the Galerkin hierarchy, one V-cycle and
the preconditioned CG on tests/test_mg.py's problems (at n = 16), and
bench.py's mg solver on the bench problem at n = 8 in f32.

Each problem is assembled by the port (tests/test_mg.py's forms, in
chip_smoke.py's ``mg_problem``) and the reference's hierarchy is built
from the port's CSR and load vector, so both sides start from identical
inputs.
Tolerances: transfers exactly equal; level CSRs, inverse diagonals, lmax,
the coarse inverse and one V-cycle within 1e-12 relative (f64, sums in
another order); CG iterations equal and x within 1e-10 relative; the f32
bench solve within +-2 iterations of the reference's, at a true relative
residual <= 1e-6 (one f64 apply)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import cutfemx_tpu as cj  # noqa: E402
import cutfemx_tpu_torch as ct  # noqa: E402
from cutfemx_tpu import mg as mgj  # noqa: E402
from cutfemx_tpu_torch import mg as mgt  # noqa: E402
from chip_smoke import MG_PARITY, mg_problem, value_summary  # noqa: E402
from test_torch_core import bench_problem, host, rel_err  # noqa: E402

N_2D = 16
HIER_TOL = 1e-12
X_TOL = 1e-10
BENCH_RTOL = 1e-6    # bench.py's
BENCH_ITS_SLACK = 2


def reference_space(V):
    """The reference's space of the port's space V, on a mesh built by the
    same generator call."""
    lo, n_axes, h_axes = mgt.structured_lattice_info(V.mesh)
    hi = lo + n_axes * h_axes
    n = tuple(int(k) for k in n_axes)
    mesh = (cj.mesh.create_box(lo, hi, n) if V.mesh.gdim == 3 else
            cj.mesh.create_rectangle(lo, hi, n))
    return cj.functionspace(mesh, ("Lagrange", V.degree),
                            shape=V.value_shape)


def test_grid_transfers_equal_reference():
    """p1_grid_transfer (triangles and tets) and p2_to_p1_transfer give the
    reference's idx and w exactly, and prolongation interpolates a linear
    field exactly (tests/test_mg.py's check)."""
    cases = [(ct.mesh.create_rectangle((-1, -1), (1, 1), (16, 16)),
              ct.mesh.create_rectangle((-1, -1), (1, 1), (8, 8)),
              cj.mesh.create_rectangle((-1, -1), (1, 1), (16, 16)),
              cj.mesh.create_rectangle((-1, -1), (1, 1), (8, 8))),
             (ct.mesh.create_box((-1, -1, -1), (1, 1, 1), (8, 8, 8)),
              ct.mesh.create_box((-1, -1, -1), (1, 1, 1), (4, 4, 4)),
              cj.mesh.create_box((-1, -1, -1), (1, 1, 1), (8, 8, 8)),
              cj.mesh.create_box((-1, -1, -1), (1, 1, 1), (4, 4, 4)))]
    for ft, ctm, fj, cjm in cases:
        idx, w = mgt.p1_grid_transfer(ft, ctm)
        idx_j, w_j = mgj.p1_grid_transfer(fj, cjm)
        assert np.array_equal(idx, idx_j) and np.array_equal(w, w_j)
        coef = np.array([2.0, -0.7, 0.4])[:ft.gdim]
        uc = ctm.vertices @ coef + 0.3
        assert np.abs((w * uc[idx]).sum(axis=1)
                      - (ft.vertices @ coef + 0.3)).max() < 1e-12
        V2t = ct.functionspace(ft, ("Lagrange", 2), device="cpu")
        V2j = cj.functionspace(fj, ("Lagrange", 2))
        V1j = cj.functionspace(fj, ("Lagrange", 1))
        idx, w = mgt.p2_to_p1_transfer(V2t, None)
        idx_j, w_j = mgj.p2_to_p1_transfer(V2j, V1j)
        assert np.array_equal(idx, idx_j) and np.array_equal(w, w_j)
    # the P2 transfer reads the dof order; a space numbered otherwise raises
    V2t.dofmap = V2t.dofmap[:, ::-1]
    with pytest.raises(ValueError, match="numbered"):
        mgt.p2_to_p1_transfer(V2t, None)


@pytest.mark.parametrize("which", ["p1", "p2", "vector"])
def test_hierarchy_vcycle_and_solve_match_reference(which):
    """tests/test_mg.py's problem (chip_smoke.mg_problem) assembled by the
    port; from its CSR, every level's CSR, inverse diagonal and lmax, the
    coarse inverse, one V-cycle on the same r, and mg_solve_cg, each
    against the reference's built from the same CSR and load vector."""
    V, A, b = mg_problem(ct, which, N_2D, "cpu")
    Vj = reference_space(V)
    Aj = A.to_scipy().copy()
    Mj = mgj.MGPreconditioner(Aj, Vj)
    M = mgt.MGPreconditioner(A, V)
    assert M.n_levels == Mj.n_levels >= 2 and M.device.type == "cpu"
    assert M.dtype == torch.float64
    for lv, lj in zip(M.levels, Mj.levels):
        data, cols, lengths = (host(a) for a in lv["A"])
        dj, cj_, rj = (np.asarray(a) for a in lj["A"])
        assert np.array_equal(cols, cj_)
        assert np.array_equal(np.repeat(np.arange(len(lengths)), lengths),
                              rj)
        assert rel_err(dj, data) <= HIER_TOL
        assert rel_err(lj["dinv"], lv["dinv"]) <= HIER_TOL
        assert abs(lv["lmax"] - lj["lmax"]) <= HIER_TOL * lj["lmax"]
    for got, want in ((M.prolongs, Mj.prolongs),
                      (M.restricts, Mj.restricts)):
        for (data, cols, _), (dj, cj_, _) in zip(got, want):
            assert np.array_equal(host(cols), np.asarray(cj_))
            assert np.array_equal(host(data), np.asarray(dj))
    assert rel_err(Mj.coarse_inv, M.coarse_inv) <= HIER_TOL

    r = np.random.default_rng(8).standard_normal(V.dim)
    assert rel_err(Mj(jnp.asarray(r)), M(torch.as_tensor(r))) <= HIER_TOL

    rtol, maxiter = MG_PARITY[which][1:]
    xj, itj, _ = mgj.mg_solve_cg(Aj, Vj, b, rtol=rtol, maxiter=maxiter)
    x, it, res = mgt.mg_solve_cg(A, V, b, rtol=rtol, maxiter=maxiter)
    assert it == itj, (it, itj)
    assert rel_err(xj, x) <= X_TOL
    assert res <= rtol * np.linalg.norm(b)


def test_bench_mg_leg_f32():
    """bench.py's mg leg (CUTFEMX_BENCH_SOLVER=mg) on the bench problem at
    n = 8 in the port: f32 forms, assemble_matrix, deactivate_outside,
    mg_solve_cg with rtol 1e-6 and nu = 2; the reference's mg_solve_cg on
    the same CSR and load vector with x64 off, as bench.py runs it (its
    f32 V-cycle does not run with x64 on: the coarse levels would be
    f64)."""
    P = bench_problem(ct, torch.float32, device="cpu",
                      phi_dtype=torch.float32)
    A = ct.fem.assemble_matrix(P["af"])
    b = host(P["b"]).copy()
    ct.fem.deactivate_outside(A, b, P["dom"])
    # deactivation keeps the f32 CSR f32, so the hierarchy runs in f32
    assert A.to_scipy().dtype == np.float32
    x, its, _ = mgt.mg_solve_cg(A, P["V"], b, rtol=BENCH_RTOL, maxiter=500,
                                nu=2)
    assert x.dtype == torch.float32 and x.device.type == "cpu"
    with jax.enable_x64(False):
        _, its_j, _ = mgj.mg_solve_cg(A.to_scipy().copy(),
                                      reference_space(P["V"]), b,
                                      rtol=BENCH_RTOL, maxiter=500, nu=2)
    m = A.to_scipy().astype(np.float64)
    rel = np.linalg.norm(m @ host(x).astype(np.float64) - b) \
        / np.linalg.norm(b)
    assert rel <= BENCH_RTOL, rel
    assert abs(its - its_j) <= BENCH_ITS_SLACK, (its, its_j)


# -- the JAX-CPU values chip_smoke.py pins (PERF.md section 4) ---------------


def reference_mg_parity():
    """The reference's numbers of chip_smoke.py's mg_parity phase:
    tests/test_mg.py's problems at its sizes, assembled and solved by
    cutfemx_tpu with x64 (the iterations and the solution's
    value_summary), keyed as its JAX_CPU_MG."""
    out = {}
    with jax.enable_x64(True):
        for which, (n, rtol, maxiter) in MG_PARITY.items():
            V, A, b = mg_problem(cj, which, n)
            x, its, _ = mgj.mg_solve_cg(A, V, b, rtol=rtol,
                                        maxiter=maxiter)
            out[which] = dict(iterations=int(its),
                              x=value_summary(np.asarray(x)))
    return out
