"""cutfemx_tpu_torch.parallel.spipeline and .operator against
cutfemx_tpu's: the owner-computes ShardedCutProblem (per-slab classify ->
cut -> quadrature -> element kernels -> halo CG) on tests/
test_sharded_pipeline.py's flagship problem at 2D n = 8 (P = 2) and 3D
n = 4 (P = 4), the element data held only on the device, and the psum step
of parallel/operator.py.

Both packages take the same numpy inputs; the port runs on CPU tensors in
f64."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import cutfemx_tpu as cj  # noqa: E402
import cutfemx_tpu_torch as ct  # noqa: E402
from test_torch_core import _yield_cpu_to_the_critical_file  # noqa: E402,F401


def sharded_setup(pkg, n, deg, cell="triangle", r=0.46):
    """tests/test_sharded_pipeline.py's _setup in ``pkg`` (the port on CPU
    tensors in f64)."""
    port = pkg is ct
    kw = {"device": "cpu"} if port else {}
    fkw = {"dtype": torch.float64} if port else {}
    if cell == "triangle":
        mesh = pkg.mesh.create_rectangle((-1.0, -1.0), (1.0, 1.0), (n, n),
                                         cell)
    else:
        mesh = pkg.mesh.create_box((-1, -1, -1), (1, 1, 1), (n, n, n), cell)
    phi = pkg.Function(pkg.functionspace(mesh, ("Lagrange", 1), **kw),
                       name="phi", **fkw)
    phi.interpolate(lambda x: np.sqrt(sum(xi ** 2 for xi in x[:mesh.tdim]))
                    - r)
    return mesh, pkg.functionspace(mesh, ("Lagrange", deg), **kw), phi


@pytest.mark.parametrize("cell,n,deg,ndev", [("triangle", 8, 1, 2),
                                             ("tetrahedron", 4, 2, 4)])
def test_sharded_cut_problem_matches_reference(cell, n, deg, ndev):
    """ShardedCutProblem with activity weights (the port's forms in f64,
    the reference's dtype with x64 on): the weights and element
    counts equal, the active masks equal, the rhs within 1e-11 of the max
    and one apply within 1e-10 of the max (tests/test_sharded_pipeline.py's
    tolerances), the halo CG at rtol 1e-12 within 1e-8 (relative, active
    dofs) with the reference's iteration count."""
    import cutfemx_tpu.parallel as pj
    import cutfemx_tpu_torch.parallel as pt
    from cutfemx_tpu.parallel.spipeline import activity_weights as wj
    from cutfemx_tpu_torch.parallel.spipeline import activity_weights as wt
    _, Vj, phij = sharded_setup(cj, n, deg, cell)
    _, Vt, phit = sharded_setup(ct, n, deg, cell)
    w = wj(phij)
    assert np.array_equal(wt(phit), w)
    prj = pj.ShardedCutProblem(Vj, pj.cut_poisson_builder(Vj, phij),
                               pj.make_device_mesh(ndev), weights=w)
    prt = pt.ShardedCutProblem(Vt, pt.cut_poisson_builder(Vt, phit),
                               pt.make_device_mesh(ndev, devices=["cpu"]),
                               dtype=torch.float64, weights=w)
    assert np.array_equal(prt.element_counts, prj.element_counts)
    assert np.array_equal(prt.op.d_active.numpy(),
                          np.asarray(prj.op.d_active))
    bj = prj.b_global()
    assert np.abs(prt.b_global() - bj).max() <= 1e-11 * np.abs(bj).max()
    x = np.random.default_rng(3).standard_normal(Vj.dim)
    yj = np.asarray(prj.op.apply_global(x))
    assert np.abs(prt.op.apply_global(x) - yj).max() <= \
        1e-10 * np.abs(yj).max()
    xj, its_j, _ = prj.solve_cg(rtol=1e-12, maxiter=2000)
    xt, its_t, _ = prt.solve_cg(rtol=1e-12, maxiter=2000)
    act = np.zeros(Vj.dim, bool)
    gol = prj.part.global_of_local
    sel = prj.op.owned_mask & (gol >= 0)
    act[gol[sel]] = np.asarray(prj.op.d_active)[sel]
    assert its_t == its_j
    assert np.linalg.norm((xt - xj)[act]) <= 1e-8 * np.linalg.norm(xj[act])


def test_element_data_lives_on_the_device_only():
    """The owner-computes path keeps no host copy of the element data: the
    operator's instances are per-slab tensors with the slab axis first,
    on the mesh's device, and their slab counts add up to the forms'."""
    from cutfemx_tpu_torch.parallel import (ShardedCutProblem,
                                            cut_poisson_builder,
                                            make_device_mesh)
    _, V, phi = sharded_setup(ct, 8, 1)
    prob = ShardedCutProblem(V, cut_poisson_builder(V, phi),
                             make_device_mesh(4, devices=["cpu"]))
    assert prob.op.instances is None
    for A, D in prob.op.d_instances:
        assert A.shape[0] == 4 and D.shape[0] == 4
        assert A.device.type == "cpu" and D.dtype == torch.int64
    assert prob.element_counts.sum() > prob.element_counts.max() > 0


def test_psum_step_matches_reference():
    """sharded_cut_poisson_step (cells split over 4 slabs) after at most
    40 Jacobi CG iterations against the reference's step on the same form
    (1e-9, tests/test_sharded_pipeline.py's atol against the serial
    solve); its operator (shard_instances + sharded_matfree_operator)
    applies with one psum, within 1e-12 of the max of the serial
    CutOperator's apply."""
    from cutfemx_tpu.parallel import make_device_mesh as mdj
    from cutfemx_tpu.parallel import sharded_cut_poisson_step as sj
    from cutfemx_tpu_torch.fem import CutOperator
    from cutfemx_tpu_torch.parallel import (make_device_mesh,
                                            shard_instances,
                                            sharded_cut_poisson_step,
                                            sharded_matfree_operator)
    from test_torch_parallel import halo_problem
    _, afj, domj, b = halo_problem(cj, False, n=8, ghost=True)
    _, aft, domt, _ = halo_problem(ct, True, n=8, ghost=True)
    xj, rj = sj(afj, domj, mdj(4), cg_iters=40)(b)
    mesh = make_device_mesh(4, devices=["cpu"])
    xt, rt = sharded_cut_poisson_step(aft, domt, mesh, cg_iters=40)(b)
    assert np.abs(xt.numpy() - np.asarray(xj)).max() <= 1e-9
    assert abs(float(rt) - float(rj)) <= 1e-9 * max(float(rj), 1.0)

    op = CutOperator(aft, domt)
    mats, dofs = shard_instances(op.element_matrices, op._rows_host, mesh)
    assert all(m.shape[0] == 4 for m in mats)
    apply = sharded_matfree_operator(mats, dofs, op.dim, mesh,
                                     active=op.active)
    x = torch.as_tensor(np.random.default_rng(5).standard_normal(op.dim))
    mesh.comm.reset_counts()
    y = apply(x)
    assert mesh.comm.counts == {"ppermute": 0, "psum": 1, "pmax": 0}
    y_se = op(x)
    assert (y - y_se).abs().max() <= 1e-12 * y_se.abs().max()
