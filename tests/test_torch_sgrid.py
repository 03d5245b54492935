"""cutfemx_tpu_torch.parallel.gridsolver and .sgrid: the distributed
stencil solver and the distributed production step (owner-computes
per-slab assembly, K1 on each slab's box of cubes, cube-ASM built from the
per-slab band fold, the psum-reduced coarse lattice, f32 CG in f64
refinement), on bench.py's problem at 3D n = 8 over P = 4 slabs of 2 cube
planes.

Held against the port's serial StencilCutOperator (tests/
test_grid_solver.py's and tests/test_sgrid_pipeline.py's tolerances) and,
through interop.operator_from_reference, against the reference's serial
operator. The reference's own ShardedStencilProblem takes minutes to
build on a CPU even at this size, so its iteration counts at n = 8, P = 4
are pinned (JAX_CPU_SGRID_N8; PERF.md section 4 gives the command)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import cutfemx_tpu_torch as ct  # noqa: E402
from test_torch_core import (bench_problem, host,  # noqa: E402
                             reference_grid_state)

N, P = 8, 4
# the reference (cutfemx_tpu on a CPU, x64) at n = 8 over 4 slabs: its
# ShardedStencilSolver.solve_cg and ShardedStencilProblem.solve_cg at
# rtol 1e-10 (PERF.md section 4)
JAX_CPU_SGRID_N8 = {"gridsolver": 85, "sgrid": 85}


def slab_mesh():
    from cutfemx_tpu_torch.parallel import make_device_mesh
    return make_device_mesh(P, devices=["cpu"])


def port_step(fdtype=torch.float64, radius=0.46):
    """bench.py's step at n = 8 on CPU tensors: the serial operator (the
    stack built) and b zeroed off the active domain."""
    from cutfemx_tpu_torch.stencil import StencilCutOperator
    bp = bench_problem(ct, fdtype, n=N, device="cpu", phi_dtype=fdtype,
                       radius=radius)
    b = torch.where(torch.as_tensor(bp["dom"].active_mask), bp["b"], 0.0)
    op = StencilCutOperator(bp["af"], bp["dom"])
    op._ensure_cube_asm()
    op._ensure_coarse()
    return dict(bp, b=b, op=op)


def sgrid_problem(step, fdtype=torch.float64):
    from cutfemx_tpu_torch.parallel import cut_poisson_builder
    from cutfemx_tpu_torch.parallel.sgrid import ShardedStencilProblem
    V, phi = step["V"], step["phi"]
    return ShardedStencilProblem(V, cut_poisson_builder(V, phi),
                                 slab_mesh(), dtype=fdtype)


@pytest.fixture(scope="module")
def step():
    s = port_step()
    s["prob"] = sgrid_problem(s)
    return s


def _rel(got, want):
    return np.abs(host(got) - host(want)).max() / np.abs(host(want)).max()


def test_box_plain_version_is_the_cubic_one_on_slabs():
    """interior_stencil_apply_box_reference on the 4 slab blocks of an
    n = 8 grid (2 cube planes on 4 points each, a random mask, a
    non-symmetric A) plus the halo sum equals the cubic plain version on
    the whole grid bitwise, in f64 and f32; each slab alone equals the
    cubic version with the mask cut to the slab's cubes on its planes."""
    from cutfemx_tpu_torch.interior_stencil import (
        interior_stencil_apply_box, interior_stencil_apply_box_reference,
        interior_stencil_apply_reference)
    from cutfemx_tpu_torch.stencil import _local_dof_table
    rng = np.random.default_rng(4)
    table = _local_dof_table(2)
    n, Nn, nch, W = N, N + 1, 8, N // P
    A = rng.standard_normal((27, 27))
    mask = rng.random((n, n, n)) < 0.6
    X = rng.standard_normal((nch, Nn, Nn, Nn))
    for dt in (torch.float64, torch.float32):
        At = torch.as_tensor(A, dtype=dt)
        Xt = torch.as_tensor(X, dtype=dt)
        full = interior_stencil_apply_reference(
            n, Nn, nch, table, At, torch.as_tensor(mask.astype(np.uint8)),
            Xt.reshape(-1)).reshape(X.shape)
        Xs = torch.zeros((P, nch, W + 2, Nn, Nn), dtype=dt)
        ms = torch.zeros((P, W, n, n), dtype=torch.uint8)
        for p in range(P):
            e = min(p * W + W + 2, Nn)
            Xs[p, :, :e - p * W] = Xt[:, p * W:e]
            ms[p] = torch.as_tensor(mask[p * W:p * W + W].astype(np.uint8))
        Ys = interior_stencil_apply_box_reference(nch, table, At, ms, Xs)
        assert torch.equal(interior_stencil_apply_box(nch, table, At, ms, Xs),
                           Ys)
        G = torch.zeros_like(full)
        for p in range(P):
            e = min(p * W + W + 2, Nn)
            G[:, p * W:e] += Ys[p, :, :e - p * W]
            mp = np.zeros_like(mask)
            mp[p * W:p * W + W] = mask[p * W:p * W + W]
            one = interior_stencil_apply_reference(
                n, Nn, nch, table, At, torch.as_tensor(mp.astype(np.uint8)),
                Xt.reshape(-1)).reshape(X.shape)
            assert torch.equal(Ys[p, :, :e - p * W], one[:, p * W:e])
        assert torch.allclose(G, full, rtol=0,
                              atol=(1e-13 if dt == torch.float64 else 2e-6)
                              * float(full.abs().max()))


def test_grid_solver_matches_serial(step):
    """ShardedStencilSolver: apply and ASM apply within 1e-11 of the max
    (tests/test_grid_solver.py's), the ASM CG at rtol 1e-10 within 1e-8
    (relative, active dofs) of the serial solve_cg(precond="asm"), its
    count the reference's at this size and within the reference test's
    2 * serial + 10; 2 ppermutes per apply and per ASM apply."""
    from cutfemx_tpu_torch.parallel.gridsolver import ShardedStencilSolver
    from cutfemx_tpu_torch.stencil import _asm_apply_body
    op, b = step["op"], step["b"]
    slv = ShardedStencilSolver(op, slab_mesh())
    comm = slv.comm
    rng = np.random.default_rng(7)
    for _ in range(2):
        x = rng.standard_normal(op.dim)
        comm.reset_counts()
        y = slv.apply_global(x)
        assert comm.counts["ppermute"] == 2
        assert _rel(y, op(x)) <= 1e-11
    r = rng.standard_normal(op.dim)
    zg = _asm_apply_body(op.n, op.N, op.nch, op.table, op._asm_bbox,
                         op._asm_binv, op.active_grid, op.vec_to_grid(r))
    comm.reset_counts()
    z = slv.precond_global(r)
    assert comm.counts["ppermute"] == 2
    assert _rel(z, zg[op.dof_to_grid]) <= 1e-11
    x_sh, its, _ = slv.solve_cg(b, rtol=1e-10, maxiter=2000)
    x_se, its_se, _ = op.solve_cg(b, rtol=1e-10, maxiter=2000, precond="asm")
    act = step["dom"].active_mask
    x_se = host(x_se)
    assert np.linalg.norm((x_sh - x_se)[act]) <= \
        1e-8 * np.linalg.norm(x_se[act])
    assert its == JAX_CPU_SGRID_N8["gridsolver"]
    assert its <= 2 * max(int(its_se), 1) + 10


def test_slab_applies_match_the_reference_operator(step):
    """The reference's serial StencilCutOperator at the same inputs: the
    port's ShardedStencilSolver over the reference's own grid state
    (interop.operator_from_reference) and the owner-computes
    ShardedStencilProblem both apply as the reference does, within 1e-11
    of the max (tests/test_sgrid_pipeline.py's)."""
    import jax.numpy as jnp
    import cutfemx_tpu as cj
    from cutfemx_tpu import stencil as sj
    from cutfemx_tpu_torch import interop
    from cutfemx_tpu_torch.parallel.gridsolver import ShardedStencilSolver
    ref = bench_problem(cj, np.float64, rhs=False)
    oj = sj.StencilCutOperator(ref["af"], ref["dom"])
    twin = interop.operator_from_reference(reference_grid_state(oj), "cpu",
                                           torch.float64)
    slv = ShardedStencilSolver(twin, slab_mesh())
    rng = np.random.default_rng(17)
    for _ in range(2):
        x = rng.standard_normal(oj.dim)
        want = np.asarray(oj(jnp.asarray(x)))
        assert _rel(slv.apply_global(x), want) <= 1e-11
        assert _rel(step["prob"].apply_global(x), want) <= 1e-11


def test_sgrid_rhs_active_apply_match_serial(step, monkeypatch):
    """ShardedStencilProblem: rhs within 1e-12 of the max, the active
    mask equal, two applies within 1e-11 (tests/test_sgrid_pipeline.py's),
    each through one call of K1's box entry (its plain version on CPU
    tensors) over all 4 slabs at once, boxes of 3 x 8 x 8 cubes (the
    slabs' widths are 2, 2, 2 and 3 lattice planes: the last also owns
    plane n)."""
    import cutfemx_tpu_torch.parallel.gridsolver as gs
    prob, op, b = step["prob"], step["op"], step["b"]
    assert _rel(prob.b_global(), b) <= 1e-12
    act = prob.to_global(prob.d_active.double()) > 0
    assert np.array_equal(act, step["dom"].active_mask)
    calls = []
    box = gs.interior_stencil_apply_box

    def counted(*args):
        calls.append(tuple(args[3].shape))
        return box(*args)
    monkeypatch.setattr(gs, "interior_stencil_apply_box", counted)
    rng = np.random.default_rng(7)
    for _ in range(2):
        x = rng.standard_normal(op.dim)
        assert _rel(prob.apply_global(x), op(x)) <= 1e-11
    assert calls == [(P, 3, N, N)] * 2


def test_sgrid_asm_and_coarse_match_serial(step):
    """The distributed ASM build (per-slab fold + cube-plane exchange)
    gives the serial ASM apply within 1e-9 of the max once the serial
    coarse correction is taken off, and the psum-reduced coarse inverse
    equals the serial one within 1e-9 (tests/test_sgrid_pipeline.py's);
    one two-level apply costs 2 ppermutes and 1 psum."""
    from cutfemx_tpu_torch.stencil import _asm_apply_body, _coarse_apply_body
    prob, op = step["prob"], step["op"]
    r = np.random.default_rng(11).standard_normal(op.dim)
    rg = op.vec_to_grid(r)
    zg = _asm_apply_body(op.n, op.N, op.nch, op.table, op._asm_bbox,
                         op._asm_binv, op.active_grid, rg)
    n, Nn = op.n, op.N
    x0, y0, z0, nbx, nby, nbz = op._asm_bbox
    cubes = np.zeros((n, n, n), bool)
    cubes[x0:x0 + nbx, y0:y0 + nby, z0:z0 + nbz] = \
        np.abs(host(op._asm_binv)).max(axis=(-1, -2)) > 0
    cov = np.zeros((op.nch, Nn, Nn, Nn), bool)
    for ch, (dx, dy, dz) in op.table:
        cov[ch, dx:dx + n, dy:dy + n, dz:dz + n] |= cubes
    z_se = torch.where(op.active_grid & torch.as_tensor(cov.reshape(-1)),
                       zg, rg)[op.dof_to_grid]
    zc = _coarse_apply_body(op.N, op.nch, op._c_sel, *op._c_W, op._c_acinv,
                            op.active_grid, rg)[op.dof_to_grid]
    prob.comm.reset_counts()
    z = prob.precond_global(r)
    assert prob.comm.counts == {"ppermute": 2, "psum": 1, "pmax": 0}
    assert _rel(z - host(zc), z_se) <= 1e-9
    assert prob._c_acinv.shape == op._c_acinv.shape
    assert _rel(prob._c_acinv, op._c_acinv) <= 1e-9


def test_sgrid_solves_match_serial(step):
    """The distributed two-level CG in f64 at rtol 1e-10: the reference's
    count at this size, within 1e-8 of the serial solve_cg(precond="asm2")
    and a true residual <= 1e-8 through the serial apply
    (tests/test_sgrid_pipeline.py's); then the f32 step (f32 forms, f64
    refinement, rtol 1e-6, as on the card): true residual <= 1e-6 through
    the serial f64 apply, within 1e-5 of the serial f32 solve."""
    prob, op, b = step["prob"], step["op"], step["b"]
    x_sh, its, _ = prob.solve_cg(rtol=1e-10, maxiter=2000)
    x_se, _, _ = op.solve_cg(b, rtol=1e-10, maxiter=2000, precond="asm2")
    x_se = host(x_se)
    assert its == JAX_CPU_SGRID_N8["sgrid"]
    assert np.linalg.norm(x_sh - x_se) <= 1e-8 * np.linalg.norm(x_se)
    r = host(op(x_sh)) - host(b)
    r[~step["dom"].active_mask] = 0.0
    assert np.linalg.norm(r) <= 1e-8 * np.linalg.norm(host(b))

    s32 = port_step(torch.float32)
    p32 = sgrid_problem(s32, torch.float32)
    x32, its32, res32 = p32.solve_cg(rtol=1e-6, maxiter=500)
    assert x32.dtype == np.float32 and its32 > 0
    op32, b32 = s32["op"], s32["b"]
    xs32, _, _ = op32.solve_cg(b32, rtol=1e-6, maxiter=500, precond="asm2")
    bg = op32.vec_to_grid(b32).double()
    from cutfemx_tpu_torch.stencil import _grid_apply_body
    rg = bg - _grid_apply_body(*op32._grid_statics(),
                               *op32._grid_arrays_f64(),
                               op32.vec_to_grid(x32).double())
    rg = torch.where(op32.active_grid, rg, 0.0)
    assert float(rg.norm() / bg.norm()) <= 1e-6
    assert res32 <= 1e-6 * float(bg.norm())
    xs32 = host(xs32).astype(np.float64)
    assert np.linalg.norm(x32 - xs32) <= 1e-5 * np.linalg.norm(xs32)


def test_sgrid_moving_domain_recut():
    """The distributed moving-domain step (tests/test_sgrid_pipeline.py's
    recut test at n = 8, 4 slabs of 2 cube planes): r = 0.46 -> 0.52,
    re-cut, re-assemble, re-solve within 1e-7 of the serial step
    (relative) and a true residual <= 1e-7; the serial build cache must
    not hand the moved cut the previous stages, and an identical repeat
    must take them back and reproduce the solve within 1e-10."""
    from cutfemx_tpu_torch import stencil as st
    st._BUILD_CACHE.clear()
    s1 = port_step()
    x = np.random.default_rng(3).standard_normal(s1["op"].dim)
    assert _rel(sgrid_problem(s1).apply_global(x), s1["op"](x)) <= 1e-11
    assert s1["op"].build_log["asm"][0] == "built"

    s1["phi"].interpolate(
        lambda x: np.sqrt(x[0] ** 2 + x[1] ** 2 + x[2] ** 2) - 0.52)
    p2 = sgrid_problem(s1)
    x_sh, _, _ = p2.solve_cg(rtol=1e-8, maxiter=2000)
    s2 = port_step(radius=0.52)
    op2, b2 = s2["op"], s2["b"]
    assert op2.build_log["asm"][0] == "built"     # no stale adoption
    assert _rel(p2.b_global(), b2) <= 1e-12
    x_se, _, _ = op2.solve_cg(b2, rtol=1e-8, maxiter=2000, precond="asm2")
    x_se = host(x_se)
    assert np.linalg.norm(x_sh - x_se) <= 1e-7 * np.linalg.norm(x_se)
    r = host(op2(x_sh)) - host(b2)
    r[~s2["dom"].active_mask] = 0.0
    assert np.linalg.norm(r) <= 1e-7 * np.linalg.norm(host(b2))

    s3 = port_step(radius=0.52)
    assert s3["op"].build_log["asm"][0] == "adopted"
    x3, _, _ = s3["op"].solve_cg(s3["b"], rtol=1e-8, maxiter=2000,
                                 precond="asm2")
    assert np.linalg.norm(host(x3) - x_se) <= 1e-10 * np.linalg.norm(x_se)
