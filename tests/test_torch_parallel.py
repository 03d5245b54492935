"""cutfemx_tpu_torch.parallel against cutfemx_tpu.parallel: the slab
partition, the owner-computes HaloOperator and its Jacobi halo CG on the
2D cut Poisson problem of tests/test_parallel.py (n = 16 here), and the
same CG over a two-process gloo group (ProcessGroupComm) against the
slabs stacked in one process (StackedComm).

Both packages take the same numpy inputs; the reference runs its
shard_map bodies on the virtual CPU devices of tests/conftest.py, the port
stacks the slabs on the CPU."""

import inspect
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import cutfemx_tpu as cj  # noqa: E402
import cutfemx_tpu_torch as ct  # noqa: E402

N_2D = 16
N_GLOO = 8


def halo_problem(pkg, port, n=N_2D, degree=1, ghost=False):
    """tests/test_parallel.py's _cut_poisson_problem in ``pkg`` (with
    ``port``, on CPU tensors in f64): V, the form, its active domain and
    b."""
    kw = {"device": "cpu"} if port else {}
    fkw = {"dtype": torch.float64} if port else {}
    d = pkg.ufl
    mesh = pkg.mesh.create_rectangle((-1.0, -1.0), (1.0, 1.0), (n, n))
    phi = pkg.Function(pkg.functionspace(mesh, ("Lagrange", 1), **kw),
                       name="phi", **fkw)
    phi.interpolate(lambda x: np.sqrt(x[0] ** 2 + x[1] ** 2) - 0.6)
    cd = pkg.cut(phi)
    inside = pkg.locate_entities(cd, "phi<0")
    vol = pkg.runtime_quadrature(cd, "phi<0", 2 * degree)
    srf = pkg.runtime_quadrature(cd, "phi=0", 2 * degree)
    dxo = pkg.Measure("dx", domain=mesh, subdomain_data=[inside, vol])
    dxg = pkg.Measure("dx", domain=mesh, subdomain_data=srf)
    V = pkg.functionspace(mesh, ("Lagrange", degree), **kw)
    u, v = d.TrialFunction(V), d.TestFunction(V)
    x = d.SpatialCoordinate(mesh)
    ng = pkg.normal(phi)
    h = d.CellDiameter(mesh)
    ue = d.sin(d.pi * x[0]) * d.sin(d.pi * x[1])
    f = 2 * d.pi ** 2 * ue
    a = d.inner(d.grad(u), d.grad(v)) * dxo
    a += (-d.dot(d.grad(u), ng) * v - d.dot(d.grad(v), ng) * u
          + 40.0 / h * u * v) * dxg
    if ghost:
        gp = pkg.ghost_penalty_facets(cd, "phi<0")
        dSg = pkg.Measure("dS", domain=mesh, subdomain_data=gp)
        nf = d.FacetNormal(mesh)
        a += 0.1 * d.avg(h) * d.inner(d.jump(d.grad(u), nf),
                                      d.jump(d.grad(v), nf)) * dSg
    L = f * v * dxo + (-d.dot(d.grad(v), ng) * ue
                       + 40.0 / h * ue * v) * dxg
    af, Lf = pkg.fem.form(a, **fkw), pkg.fem.form(L, **fkw)
    dom = pkg.fem.active_domain(af)
    b = np.array(pkg.fem.assemble_vector(Lf))
    return V, af, dom, b


@pytest.fixture(scope="module")
def problems():
    """(reference, port) problems, without and with the ghost penalty."""
    return {ghost: (halo_problem(cj, False, ghost=ghost),
                    halo_problem(ct, True, ghost=ghost))
            for ghost in (False, True)}


@pytest.mark.parametrize("ndev", [2, 8])
def test_slab_partition_equals_reference(problems, ndev):
    """build_slab_partition: every array and every per-slab id list
    exactly the reference's, on P1 (the problem's space) and on P2 dofs,
    unweighted and weighted (the fallback over fewer slabs included)."""
    from cutfemx_tpu.parallel.halo import build_slab_partition as bj
    from cutfemx_tpu_torch.parallel.halo import build_slab_partition as bt
    (Vj, *_), (Vt, *_) = problems[False]
    rng = np.random.default_rng(ndev)
    cases = [(Vj, Vt, None),
             (cj.functionspace(Vj.mesh, ("Lagrange", 2)),
              ct.functionspace(Vt.mesh, ("Lagrange", 2), device="cpu"),
              rng.random(Vj.mesh.num_cells) ** 4)]
    for vj, vt, w in cases:
        pj, pt = bj(vj, ndev, weights=w), bt(vt, ndev, weights=w)
        for k in ("nparts", "owned_max", "gl_max", "gr_max", "local_size"):
            assert getattr(pj, k) == getattr(pt, k), k
        for k in ("cell_part", "n_owned", "global_of_local",
                  "send_left_slots", "send_right_slots", "ghostl_valid",
                  "ghostr_valid", "dof_owner"):
            assert np.array_equal(getattr(pj, k), getattr(pt, k)), k
        for k in ("owned_ids", "gl_ids", "gr_ids"):
            assert all(np.array_equal(a, b) for a, b in
                       zip(getattr(pj, k), getattr(pt, k))), k
        g = np.arange(vj.dim)
        for p in range(ndev):
            mine = g[np.isin(pj.dof_owner[g], [p - 1, p, p + 1])]
            try:
                want = pj.locals_of_globals(p, mine)
            except ValueError:
                with pytest.raises(ValueError):
                    pt.locals_of_globals(p, mine)
                continue
            assert np.array_equal(pt.locals_of_globals(p, mine), want)


@pytest.mark.parametrize("ghost,ndev", [(False, 2), (False, 8), (True, 2),
                                        (True, 8)])
def test_halo_operator_matches_reference(problems, ghost, ndev):
    """HaloOperator (oracle path): one apply within 1e-11 of the max
    (tests/test_sharded_pipeline.py's apply tolerance is 1e-10), the halo
    CG at rtol 1e-10 within 1e-8 of the max (tests/test_parallel.py's)
    with the reference's iteration count, and the collectives of one
    apply: 2 + 2 ppermutes, no psum."""
    from cutfemx_tpu.parallel import make_device_mesh as mdj
    from cutfemx_tpu.parallel.halo import HaloOperator as Hj
    from cutfemx_tpu.parallel.halo import build_slab_partition as bj
    from cutfemx_tpu_torch.parallel import make_device_mesh as mdt
    from cutfemx_tpu_torch.parallel.halo import HaloOperator as Ht
    from cutfemx_tpu_torch.parallel.halo import build_slab_partition as bt
    (Vj, afj, domj, b), (Vt, aft, domt, bt_) = problems[ghost]
    assert np.abs(b - bt_).max() <= 1e-12 * np.abs(b).max()
    hj = Hj(afj, domj, bj(Vj, ndev), mdj(ndev))
    ht = Ht(aft, domt, bt(Vt, ndev), mdt(ndev, devices=["cpu"]))
    assert np.array_equal(ht.active_local, hj.active_local)
    x = np.random.default_rng(0).standard_normal(Vj.dim)
    yj = np.asarray(hj.apply_global(x))
    comm = ht.mesh.comm
    comm.reset_counts()
    yt = ht.apply_global(x)
    assert comm.counts == {"ppermute": 4, "psum": 0, "pmax": 0}
    assert np.abs(yt - yj).max() <= 1e-11 * np.abs(yj).max()
    xj, its_j, _ = hj.solve_cg(b, rtol=1e-10, maxiter=400)
    xt, its_t, _ = ht.solve_cg(b, rtol=1e-10, maxiter=400)
    xj = np.asarray(xj)
    mask = domj.active_mask
    assert its_t == its_j
    assert np.abs(xt - xj)[mask].max() <= 1e-8 * np.abs(xj[mask]).max()


_GLOO_WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from datetime import timedelta
torch.set_num_threads(1)
sys.path.insert(0, {repo!r})
sys.path.insert(0, {tests!r})
rank, world, init, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \
    sys.argv[4]
dist.init_process_group("gloo", init_method=init, rank=rank,
                        world_size=world, timeout=timedelta(seconds=60))
import cutfemx_tpu_torch as ct
from cutfemx_tpu_torch.parallel import make_device_mesh
from cutfemx_tpu_torch.parallel.halo import HaloOperator, build_slab_partition
from halo_problem import halo_problem
V, af, dom, b = halo_problem(ct, True, n={n})
mesh = make_device_mesh(devices=["cpu"], process_group=True)
op = HaloOperator(af, dom, build_slab_partition(V, world), mesh)
x, its, res = op.solve_cg(b, rtol=1e-10, maxiter=400)
if rank == 0:
    np.savez(out, x=x, its=its, counts=np.array(
        [mesh.comm.counts[k] for k in ("ppermute", "psum", "pmax")]))
dist.destroy_process_group()
"""


def test_process_group_cg_equals_stacked(tmp_path):
    """The halo CG with one slab in each of two gloo processes
    (ProcessGroupComm) against the two slabs stacked in one process
    (StackedComm), 2D n = 8: the same iteration count, the same collective
    counts, the solution within 1e-12 of the max (the two run the same
    per-slab arithmetic; only the reductions' transport differs)."""
    from cutfemx_tpu_torch.parallel import make_device_mesh
    from cutfemx_tpu_torch.parallel.halo import (HaloOperator,
                                                 build_slab_partition)
    here = os.path.dirname(os.path.abspath(__file__))
    # the worker imports the problem builder without JAX: a copy of its
    # source in a module beside the script
    (tmp_path / "halo_problem.py").write_text(
        "import numpy as np\nimport torch\n\nN_2D = %d\n\n\n%s"
        % (N_2D, inspect.getsource(halo_problem)))
    script = tmp_path / "worker.py"
    script.write_text(_GLOO_WORKER.format(repo=os.path.dirname(here),
                                          tests=str(tmp_path), n=N_GLOO))
    init = f"file://{tmp_path / 'rendezvous'}"
    out = tmp_path / "rank0.npz"
    env = {**os.environ, "PYTHONPATH": ""}
    procs = [subprocess.Popen([sys.executable, str(script), str(r), "2",
                               init, str(out)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=240)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), logs
    got = np.load(out)

    V, af, dom, b = halo_problem(ct, True, n=N_GLOO)
    mesh = make_device_mesh(2, devices=["cpu"])
    op = HaloOperator(af, dom, build_slab_partition(V, 2), mesh)
    x, its, _ = op.solve_cg(b, rtol=1e-10, maxiter=400)
    assert int(got["its"]) == its
    assert list(got["counts"]) == [mesh.comm.counts[k]
                                   for k in ("ppermute", "psum", "pmax")]
    assert np.abs(got["x"] - x).max() <= 1e-12 * np.abs(x).max()
