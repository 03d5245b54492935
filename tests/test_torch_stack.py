"""The production preconditioner stack of cutfemx_tpu_torch against
cutfemx_tpu on the bench problem in f64 (n = 8, r = 0.46, P2; CPU tensors,
so the interior stencil is the kernel's plain version): the band fold, the
cube-ASM blocks taken from it, the coarse lattice, their applies, the
solves, the verified-reuse build cache and the traffic model."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import cutfemx_tpu as cj  # noqa: E402
import cutfemx_tpu_torch as ct  # noqa: E402
from cutfemx_tpu import stencil as sj  # noqa: E402
from cutfemx_tpu_torch import interop, stencil as st  # noqa: E402
from test_torch_core import (  # noqa: E402
    bench_problem, host, reference_grid_state, rel_err)


def _port_problem(**kw):
    P = bench_problem(ct, torch.float64, device="cpu",
                      phi_dtype=torch.float64, **kw)
    P["op"] = st.StencilCutOperator(P["af"], P["dom"])
    return P


@pytest.fixture(scope="module")
def ref(port):
    """The reference operator with its three stages built: the direct fold
    first, so its ASM blocks come from the fold as the port's always do.
    Its right-hand side is the port's (the two are compared in
    test_torch_slice_f64.py), so both solves start from the same bits."""
    P = bench_problem(cj, np.float64, rhs=False)
    P["b"] = jnp.asarray(host(port["b"]))
    op = P["op"] = sj.StencilCutOperator(P["af"], P["dom"])
    op._ensure_band_fold()
    assert op._bf_direct
    op._ensure_cube_asm()
    op._ensure_coarse()
    return P


@pytest.fixture(scope="module")
def port():
    P = _port_problem()
    op = P["op"]
    op._ensure_band_fold()
    op._ensure_cube_asm()
    op._ensure_coarse()
    return P


@pytest.fixture(scope="module")
def twin(ref):
    """A port operator holding the reference's own grid state and built
    stack: applies and solves on identical tensors."""
    oj = ref["op"]
    state = reference_grid_state(oj)
    state.update(
        _bf_diag=host(oj._bf_diag), _bf_fwd=[host(a) for a in oj._bf_fwd],
        _bf_rev=None, _bf_bbox=oj._bf_bbox, _asm_binv=host(oj._asm_binv),
        _asm_bbox=oj._asm_bbox, _c_W=[host(a) for a in oj._c_W],
        _c_sel=oj._c_sel, _c_acinv=host(oj._c_acinv))
    assert oj._bf_rev is None       # the bench form is symmetric
    return interop.operator_from_reference(state, "cpu", torch.float64)


def _seeded_grid_vector(op, seed):
    x = np.random.default_rng(seed).standard_normal(op.gsize)
    return np.where(host(op.grid_valid).reshape(-1), x, 0.0)


# -- the band fold -------------------------------------------------------------


def test_fold_tensors_match(ref, port):
    oj, ot = ref["op"], port["op"]
    assert tuple(oj._bf_bbox) == ot._bf_bbox
    assert oj._bf_rev is None and ot._bf_rev is None
    assert rel_err(oj._bf_diag, ot._bf_diag) < 1e-12
    for fj, ft in zip(oj._bf_fwd, ot._bf_fwd):
        assert np.abs(host(fj)).max() > 0
        assert rel_err(fj, ft) < 1e-12


def _plane(x):
    # tilted plane: the active domain touches the box boundary, so the fold
    # bbox origin is 0 on two axes and its far side is the lattice edge
    return x[0] + 0.31 * x[1] - 0.13


@pytest.mark.parametrize("case", ["sphere-P2", "plane-P2", "sphere-P1"])
def test_fold_apply_is_exact(port, case):
    """The folded apply equals the gather apply (the oracle of
    tests/test_stencil.py: the fold moves entries, it changes no sum)."""
    if case == "sphere-P2":
        op = port["op"]
    elif case == "plane-P2":
        op = _port_problem(n=6, level_set=_plane)["op"]
        op._ensure_band_fold()
        assert op._bf_bbox[1:3] == (0, 0)
        assert op._bf_bbox[1] + op._bf_bbox[4] == op.n   # clipped at the edge
    else:
        op = _port_problem(degree=1)["op"]
        op._ensure_band_fold()
        assert op.nch == 1 and len(op.table) == 8
    x = torch.as_tensor(_seeded_grid_vector(op, 2))
    stat, arr = op._grid_statics(), op._grid_arrays()
    y_gather = st._grid_apply_body(*stat, *arr, x)
    y_fold = st._grid_apply_fold_body(
        *stat, op._bf_bbox, *arr[:4], op._bf_diag, op._bf_fwd, op._bf_rev, x)
    assert float(y_gather.abs().max()) > 0
    assert rel_err(y_gather, y_fold) < 1e-13


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


# -- cube-block additive Schwarz ------------------------------------------------


def test_asm_blocks_match(ref, port):
    oj, ot = ref["op"], port["op"]
    assert tuple(oj._asm_bbox) == ot._asm_bbox
    assert rel_err(oj._asm_binv, ot._asm_binv) < 1e-8


def test_asm_apply_on_identical_tensors(ref, twin):
    oj = ref["op"]
    r = _seeded_grid_vector(twin, 3)
    n, N, nch, table, _ = oj._grid_statics()
    zj = sj._asm_apply_body(n, N, nch, table, oj._asm_bbox, oj._asm_binv,
                            oj.active_grid, jnp.asarray(r))
    zt = st._asm_apply_body(n, N, nch, table, twin._asm_bbox,
                            twin._asm_binv, twin.active_grid,
                            torch.as_tensor(r))
    assert rel_err(zj, zt) < 1e-12


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


# -- the coarse lattice ---------------------------------------------------------


def test_coarse_operator_matches(ref, port):
    oj, ot = ref["op"], port["op"]
    assert oj._c_sel == ot._c_sel
    assert (oj._c_K, oj._c_m) == (ot._c_K, ot._c_m) == (5, 2)
    for wj, wt in zip(oj._c_W, ot._c_W):
        assert rel_err(wj, wt) < 1e-15
    Aj = oj._coarse_galerkin_fold(oj._c_m)[0]
    At = ot._coarse_galerkin_fold(ot._c_m)[0]
    assert rel_err(Aj, At) < 1e-10
    assert rel_err(oj._c_acinv, ot._c_acinv) < 1e-7


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


@pytest.fixture(scope="module")
def port_fold2(port):
    x, its, _ = port["op"].solve_cg(port["b"], rtol=1e-8, maxiter=800,
                                    precond="asm-fold2", refine=False)
    return host(x), its


@pytest.fixture(scope="module")
def ref_fold2(ref):
    x, its, _ = ref["op"].solve_cg(ref["b"], rtol=1e-8, maxiter=800,
                                   precond="asm-fold2", refine=False)
    return host(x), int(its)


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
    want = chip_smoke.bound_bytes(n, N, nch, table, op.cube_mask_t, 8)
    assert op.traffic_model()["stencil_bytes"] == want
