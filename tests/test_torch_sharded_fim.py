"""cutfemx_tpu_torch.distance.sharded against cutfemx_tpu's: the sharded
Fast Iterative Method (slab sweeps with a ghost min-exchange) on
tests/test_sharded_fim.py's point sources, the STL routing to slabs and
the end-to-end sharded signed distance, against the reference's sharded
solve and the port's serial path.

Both packages take the same numpy inputs; the port stacks the slabs on
the CPU."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import cutfemx_tpu as cj  # noqa: E402
import cutfemx_tpu_torch as ct  # noqa: E402
from test_torch_core import _yield_cpu_to_the_critical_file  # noqa: E402,F401

TOL = 1e-10      # tests/test_sharded_fim.py's sharded-vs-serial gate


def _meshes(n, dim):
    if dim == 2:
        return (cj.mesh.create_rectangle((-1, -1), (1, 1), (n, n)),
                ct.mesh.create_rectangle((-1, -1), (1, 1), (n, n)))
    return (cj.mesh.create_box((-1, -1, -1), (1, 1, 1), (n, n, n)),
            ct.mesh.create_box((-1, -1, -1), (1, 1, 1), (n, n, n)))


@pytest.mark.parametrize("dim,n,r0,ndev", [(2, 24, 0.2, 2), (2, 24, 0.2, 8),
                                           (3, 8, 0.3, 4)])
def test_sharded_eikonal_matches_reference(dim, n, r0, ndev):
    """A point source (tests/test_sharded_fim.py's 2D n = 24 on 2 and 8
    slabs and 3D n = 8 on 4): the reference's sweep count exactly, the
    distances within 1e-10 of the reference's sharded solve and of the
    port's serial eikonal_solve, with 4 ppermutes an exchange and one
    pmax a sweep."""
    from cutfemx_tpu.distance.fim import FMMOptions
    from cutfemx_tpu.distance.sharded import sharded_eikonal_solve as sj
    from cutfemx_tpu.parallel import make_device_mesh as mdj
    from cutfemx_tpu_torch.distance.fim import eikonal_solve
    from cutfemx_tpu_torch.distance.sharded import sharded_eikonal_solve
    from cutfemx_tpu_torch.parallel import make_device_mesh
    mj, mt = _meshes(n, dim)
    r = np.linalg.norm(mj.vertices, axis=1)
    frozen = r < r0
    d0 = np.where(frozen, r, FMMOptions().inf)
    dj, its_j = sj(mj, d0, frozen, mdj(ndev))
    mesh = make_device_mesh(ndev, devices=["cpu"])
    dt, its_t = sharded_eikonal_solve(mt, d0, frozen, mesh)
    assert its_t == int(its_j)
    assert np.abs(dt - np.asarray(dj)).max() < TOL
    assert mesh.comm.counts == {"ppermute": 4 * (its_t + 1), "psum": 0,
                                "pmax": its_t}
    ds, _, _ = eikonal_solve(mt, d0, frozen, device="cpu")
    assert np.abs(dt - ds.numpy()).max() < TOL


def test_sharded_eikonal_accuracy_against_exact():
    """The sharded solution approximates the true distance, not only the
    serial solver (tests/test_sharded_fim.py's gate, 5% of the largest
    distance, at 2D n = 24 on 8 slabs)."""
    from cutfemx_tpu_torch.distance.fim import FMMOptions
    from cutfemx_tpu_torch.distance.sharded import sharded_eikonal_solve
    from cutfemx_tpu_torch.parallel import make_device_mesh
    _, mt = _meshes(24, 2)
    r = np.linalg.norm(mt.vertices, axis=1)
    frozen = r < 0.15
    d0 = np.where(frozen, r, FMMOptions().inf)
    dp, _ = sharded_eikonal_solve(mt, d0, frozen,
                                  make_device_mesh(8, devices=["cpu"]))
    far = r > 0.3
    assert np.abs(dp[far] - r[far]).max() < 0.05 * r[far].max()


@pytest.fixture(scope="module")
def soups():
    """tests/test_distance.py's cube-sphere soup in both packages."""
    from test_distance import _sphere_soup
    from cutfemx_tpu_torch.interop import trisoup_from_reference
    sj = _sphere_soup(r=0.55, n=10)
    return sj, trisoup_from_reference(sj.X, sj.tri, sj.N, sj.tri_gid)


def test_distribute_stl_sharded_matches_reference(soups):
    """The triangles routed to each of 4 slabs of the n = 6 box equal the
    reference's, and every (cell, triangle) candidate of the global broad
    phase is in the owning slab's soup (tests/test_sharded_fim.py)."""
    from cutfemx_tpu.distance.sharded import distribute_stl_sharded as rj
    from cutfemx_tpu.functionspace import FunctionSpace as Fj
    from cutfemx_tpu.parallel.halo import build_slab_partition as bj
    from cutfemx_tpu_torch.distance.sharded import distribute_stl_sharded
    from cutfemx_tpu_torch.distance.stl import build_cell_triangle_map
    from cutfemx_tpu_torch.parallel.halo import build_slab_partition
    sj, st = soups
    mj, mt = _meshes(6, 3)
    part = build_slab_partition(
        ct.functionspace(mt, ("Lagrange", 1), device="cpu"), 4)
    got = distribute_stl_sharded(mt, st, part)
    want = rj(mj, sj, bj(Fj(mj, ("Lagrange", 1)), 4))
    for g, w in zip(got, want):
        assert np.array_equal(g.tri_gid, w.tri_gid)
        assert np.array_equal(g.tri, w.tri)
    ctmap = build_cell_triangle_map(mt, st)
    counts = np.diff(ctmap.offsets)
    for c in np.flatnonzero(counts):
        routed = set(got[part.cell_part[c]].tri_gid.tolist())
        assert set(st.tri_gid[ctmap.links(c)].tolist()) <= routed


def test_sharded_signed_distance_matches_serial_and_reference(soups):
    """The sharded pipeline (routing -> per-slab near field -> sharded FIM
    -> sign) on the n = 8 box over 4 slabs equals the port's serial
    compute_signed_distance(sign_mode="local_normal_band") and the
    reference's sharded_signed_distance within 1e-10, with the serial
    sweep count."""
    from cutfemx_tpu.distance.sharded import sharded_signed_distance as dj
    from cutfemx_tpu.parallel import make_device_mesh as mdj
    from cutfemx_tpu_torch.distance.api import compute_signed_distance
    from cutfemx_tpu_torch.distance.sharded import sharded_signed_distance
    from cutfemx_tpu_torch.parallel import make_device_mesh
    sj, st = soups
    mj, mt = _meshes(8, 3)
    dp, its = sharded_signed_distance(mt, st, make_device_mesh(
        4, devices=["cpu"]))
    ds, its_s = compute_signed_distance(mt, st, sign_mode="local_normal_band",
                                        device="cpu")
    assert its == its_s
    assert np.abs(dp - ds).max() < TOL
    dr, its_r = dj(mj, sj, mdj(4))
    assert its == int(its_r)
    assert np.abs(dp - np.asarray(dr)).max() < TOL
