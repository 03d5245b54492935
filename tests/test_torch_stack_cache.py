"""The preconditioner stack's verified-reuse build cache and traffic model
in cutfemx_tpu_torch (test_torch_stack.py's port fixture: the bench
problem in f64, n = 8, r = 0.46, P2; CPU tensors), and dof vectors given
to StencilCutOperator as numpy arrays."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import cutfemx_tpu_torch as ct  # noqa: E402
from cutfemx_tpu_torch import stencil as st  # noqa: E402
from test_torch_core import bench_problem  # noqa: E402
from test_torch_stack import _port_problem, port  # noqa: E402,F401
from test_torch_core import (  # noqa: E402,F401  (autouse)
    _yield_cpu_to_the_critical_file)


# -- the verified-reuse build cache ----------------------------------------------


def test_fp_arrays_sees_every_bit():
    rng = np.random.default_rng(6)
    a = torch.as_tensor(rng.standard_normal((7, 5)))
    m = torch.as_tensor(rng.random(40) < 0.5)
    i = torch.as_tensor(rng.integers(0, 10 ** 6, 30))
    fp = st._fp_arrays([a, m, i, a.float()])
    assert fp.shape == (4, 2) and fp.dtype == np.int64
    assert (fp >= 0).all() and (fp < 2 ** 32).all()
    assert np.array_equal(fp, st._fp_arrays([a.clone(), m, i, a.float()]))
    # the lowest mantissa bit of one f64 entry (lost in a cast to f32)
    b = a.clone()
    b.view(torch.int64)[3, 2] ^= 1
    assert b[3, 2].float() == a[3, 2].float()
    assert not np.array_equal(fp[0], st._fp_arrays([b])[0])
    # two entries swapped: the plain sum holds, the weighted one moves
    c = a.clone()
    c[0, 0], c[0, 1] = a[0, 1], a[0, 0]
    fc = st._fp_arrays([c])[0]
    assert fc[0] == fp[0, 0] and fc[1] != fp[0, 1]
    m2 = m.clone()
    m2[5] = ~m2[5]
    assert not np.array_equal(fp[1], st._fp_arrays([m2])[0])


@pytest.fixture(scope="module")
def cached(port):
    """One port operator built from a cleared cache: it builds all three
    stages and stores them, then solves. The two cache tests below start
    from this cache state (``restore``) instead of building again."""
    st._BUILD_CACHE.clear()
    op = st.StencilCutOperator(port["af"], port["dom"])
    x, its, _ = op.solve_cg(port["b"], rtol=1e-8, maxiter=600,
                            precond="asm-fold2", refine=False)
    assert [op.build_log[s][0] for s in ("fold", "asm", "coarse")] == \
        ["built"] * 3
    (key, entry), = st._BUILD_CACHE.items()
    assert set(entry) == {"fp", "fold", "asm", "coarse"}

    def restore():
        st._BUILD_CACHE.clear()
        st._BUILD_CACHE[key] = dict(entry)

    return dict(op=op, x=x, its=its, restore=restore)


def test_identical_rebuild_adopts_builds(cached):
    """tests/test_stencil_build_cache.py::test_identical_rebuild_adopts_
    builds: a re-cut and re-assembled operator on the same level set adopts
    all three stages by identity and solves bitwise the same."""
    cached["restore"]()
    op1 = cached["op"]
    P2 = _port_problem()
    op2 = P2["op"]
    op2._ensure_band_fold()
    op2._ensure_cube_asm()
    op2._ensure_coarse()
    assert [op2.build_log[s][0] for s in ("fold", "asm", "coarse")] == \
        ["adopted"] * 3
    assert op2._bf_diag is op1._bf_diag
    assert op2._asm_binv is op1._asm_binv
    assert op2._c_acinv is op1._c_acinv
    x2, it2, _ = op2.solve_cg(P2["b"], rtol=1e-8, maxiter=600,
                              precond="asm-fold2", refine=False)
    assert it2 == cached["its"]
    assert torch.equal(x2, cached["x"])


def test_moved_level_set_invalidates_and_matches_cold(cached):
    cached["restore"]()
    op1 = cached["op"]
    # moved interface: fingerprints must differ -> fresh builds
    P2 = _port_problem(radius=0.52)
    op2 = P2["op"]
    op2._ensure_band_fold()
    assert op2.build_log["fold"][0] == "built"
    assert op2._bf_diag is not op1._bf_diag
    x_warm, it_w, _ = op2.solve_cg(P2["b"], rtol=1e-8, maxiter=600,
                                   precond="asm-fold2", refine=False)
    # cold-cache build of the moved problem
    st._BUILD_CACHE.clear()
    op3 = st.StencilCutOperator(P2["af"], P2["dom"])
    x_cold, it_c, _ = op3.solve_cg(P2["b"], rtol=1e-8, maxiter=600,
                                   precond="asm-fold2", refine=False)
    assert it_w == it_c
    assert float(torch.linalg.norm(x_warm - x_cold)) \
        <= 1e-10 * float(torch.linalg.norm(x_cold))


def test_stage_over_the_budget_is_not_cached(port, monkeypatch):
    fold = st._tree_nbytes((port["op"]._bf_diag, port["op"]._bf_fwd))
    asm = st._tree_nbytes(port["op"]._asm_binv)
    assert asm < fold
    monkeypatch.setattr(st, "_BUILD_CACHE_BUDGET_BYTES", (asm + fold) // 2)
    st._BUILD_CACHE.clear()
    op1 = st.StencilCutOperator(port["af"], port["dom"])
    op1._ensure_band_fold()
    op1._ensure_cube_asm()
    (entry,) = st._BUILD_CACHE.values()
    assert "fold" not in entry and "asm" in entry
    op2 = st.StencilCutOperator(port["af"], port["dom"])
    op2._ensure_band_fold()
    op2._ensure_cube_asm()
    assert op2.build_log["fold"][0] == "built"
    assert op2.build_log["asm"][0] == "adopted"
    assert op2._asm_binv is op1._asm_binv
    st._BUILD_CACHE.clear()


# -- the traffic model -----------------------------------------------------------


def test_traffic_model_sums_its_parts(port):
    op = port["op"]
    tm = op.traffic_model()
    parts = ("stencil_bytes", "band_bytes", "asm_bytes", "coarse_bytes",
             "cg_vec_bytes")
    assert all(tm[k] > 0 for k in (*parts, "vec_bytes", "bytes_per_it"))
    assert tm["bytes_per_it"] == sum(tm[k] for k in parts)
    assert tm["vec_bytes"] == op.gsize * 8
    assert tm["band_bytes"] == 4 * op._bf_diag.numel() * 8   # diag + 3 fwd


def test_traffic_model_stencil_bytes_are_the_kernel_bound(port):
    """The K1 term is the bound chip_smoke.py reckons for the kernel."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    op = port["op"]
    n, N, nch, table, _ = op._grid_statics()
    want = chip_smoke.bound_bytes(nch, table, op.cube_mask_t[None], 8,
                                  (N, N, N))
    assert op.traffic_model()["stencil_bytes"] == want


# -- numpy vectors (ROADMAP C6) -----------------------------------------------


def test_numpy_vectors_equal_tensors(port):
    """Every entry point that takes a dof vector (the apply, vec_to_grid,
    solve_cg on the f64 path and through the f32 iterative refinement)
    takes a numpy array as the tensor of the form's dtype: equal results
    bitwise, as the reference takes any array
    (tests/test_stencil_build_cache.py passes numpy)."""
    op, b = port["op"], port["b"]
    bn = b.numpy()
    assert torch.equal(op(bn), op(b))
    assert torch.equal(op.vec_to_grid(bn), op.vec_to_grid(b))
    x, its, res = op.solve_cg(b, rtol=1e-8, maxiter=600, precond="jacobi",
                              refine=False)
    assert (its, res) == op.solve_cg(bn, rtol=1e-8, maxiter=600,
                                     precond="jacobi", refine=False)[1:]
    assert torch.equal(x, op.solve_cg(bn, rtol=1e-8, maxiter=600,
                                      precond="jacobi", refine=False)[0])
    P = bench_problem(ct, torch.float32, device="cpu")
    op32, b32 = st.StencilCutOperator(P["af"], P["dom"]), P["b"]
    want = op32.solve_cg(b32, rtol=1e-6, maxiter=600, precond="jacobi")
    for bn in (b32.numpy(), b32.numpy().astype(np.float64)):
        got = op32.solve_cg(bn, rtol=1e-6, maxiter=600, precond="jacobi")
        assert got[0].dtype == torch.float32 and got[1] == want[1] > 0
        assert torch.equal(got[0], want[0]) and got[2] == want[2]
