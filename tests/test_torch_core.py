"""cutfemx_tpu_torch against cutfemx_tpu: host core and the package
boundary (the interior-stencil kernel's plain version is in
test_torch_core_stencil.py).

Also holds the helpers the other test_torch_* files share: the bench
problem (``bench.py``'s moving-domain step) built in either package, and
the numpy copy of a reference StencilCutOperator's grid state."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import cutfemx_tpu as cj  # noqa: E402
import cutfemx_tpu_torch as ct  # noqa: E402

# the bench problem of bench.py, cut to a small box: n = 8 is the smallest
# box at r = 0.46 that still has full interior stencil cubes
N_BOX, RADIUS, GAMMA, DEGREE = 8, 0.46, 40.0, 2


def bench_problem(pkg, fdtype, n=N_BOX, device=None, phi_dtype=None,
                  degree=DEGREE, level_set=None, radius=RADIUS, rhs=True,
                  phi_degree=1, cut_kw=None):
    """bench.py's moving-domain step up to assembly, in ``pkg``
    (cutfemx_tpu or cutfemx_tpu_torch). The port gets ``device`` and
    ``phi_dtype``; the level set (the bench's sphere of ``radius`` unless
    ``level_set`` gives another, interpolated into degree ``phi_degree``)
    and all inputs come from the same numpy expressions in both packages.
    ``cut_kw`` goes to ``cut`` (e.g. ``cut_approximation_order=2``).
    ``rhs=False`` leaves the load vector unassembled (``b`` is None)."""
    if level_set is None:
        def level_set(x):
            return np.sqrt(x[0] ** 2 + x[1] ** 2 + x[2] ** 2) - radius
    import importlib
    fem = importlib.import_module(pkg.__name__ + ".fem")
    d = importlib.import_module(pkg.__name__ + ".forms.dsl")
    Measure = importlib.import_module(pkg.__name__ + ".forms.measure").Measure
    space_kw = {} if device is None else {"device": device}
    fn_kw = {} if phi_dtype is None else {"dtype": phi_dtype}
    mesh = pkg.mesh.create_box((-1, -1, -1), (1, 1, 1), (n, n, n))
    Vphi = pkg.functionspace(mesh, ("Lagrange", phi_degree), **space_kw)
    phi = pkg.Function(Vphi, name="phi", **fn_kw)
    phi.interpolate(level_set)
    V = pkg.functionspace(mesh, ("Lagrange", degree), **space_kw)
    cd = pkg.cut(phi, **(cut_kw or {}))
    inside = pkg.locate_entities(cd, "phi<0")
    vol = pkg.runtime_quadrature(cd, "phi<0", 2 * degree)
    srf = pkg.runtime_quadrature(cd, "phi=0", 2 * degree)
    gp = pkg.ghost_penalty_facets(cd, "phi<0")
    dxo = Measure("dx", domain=mesh, subdomain_data=[inside, vol])
    dxg = Measure("dx", domain=mesh, subdomain_data=srf)
    dSg = Measure("dS", domain=mesh, subdomain_data=gp)
    u, v = d.TrialFunction(V), d.TestFunction(V)
    x = d.SpatialCoordinate(mesh)
    ng = pkg.normal(phi)
    nf = d.FacetNormal(mesh)
    h = d.CellDiameter(mesh)
    ue = d.sin(d.pi * x[0]) * d.sin(d.pi * x[1]) * d.sin(d.pi * x[2])
    f = 3 * d.pi ** 2 * ue
    a = d.inner(d.grad(u), d.grad(v)) * dxo
    a += (-d.dot(d.grad(u), ng) * v - d.dot(d.grad(v), ng) * u
          + GAMMA / h * u * v) * dxg
    a += 0.1 * d.avg(h) * d.inner(d.jump(d.grad(u), nf),
                                  d.jump(d.grad(v), nf)) * dSg
    L = f * v * dxo + (-d.dot(d.grad(v), ng) * ue
                       + GAMMA / h * ue * v) * dxg
    af = fem.form(a, dtype=fdtype)
    dom = fem.active_domain(af)
    b = fem.assemble_vector(fem.form(L, dtype=fdtype)) if rhs else None
    return dict(mesh=mesh, V=V, phi=phi, vol=vol, srf=srf, gp=gp, ng=ng,
                af=af, dom=dom, b=b)


def reference_grid_state(op):
    """numpy copy of a cutfemx_tpu StencilCutOperator's grid state, keyed
    as cutfemx_tpu_torch.interop.operator_from_reference takes it."""
    from cutfemx_tpu_torch.interop import GRID_STATE_KEYS
    state = dict(zip(GRID_STATE_KEYS,
                     (*op._grid_statics(), *op._grid_arrays())))
    for k in ("rest_mats", "rest_rows_grid", "rest_cols_grid"):
        state[k] = [np.asarray(a) for a in state[k]]
    for k in ("A_local", "cube_mask", "active_grid", "identity_grid",
              "permg", "sortedg"):
        state[k] = np.asarray(state[k])
    state.update(grid_valid=np.asarray(op.grid_valid),
                 grid_gather=np.asarray(op.grid_gather),
                 dof_to_grid=np.asarray(op.dof_to_grid),
                 active=None if op.active is None
                 else np.asarray(op.active))
    return state


def host(a):
    """numpy copy of a JAX array or a torch tensor."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def rel_err(ref, got):
    ref, got = host(ref), host(got)
    return np.abs(ref - got).max() / max(np.abs(ref).max(), 1e-300)


# -- host core ---------------------------------------------------------------


def test_mesh_and_dofmaps_bitwise():
    mj = cj.mesh.create_box((-1, -1, -1), (1, 1, 1), (N_BOX,) * 3)
    mt = ct.mesh.create_box((-1, -1, -1), (1, 1, 1), (N_BOX,) * 3)
    for name in ("vertices", "cells", "edges", "facets", "facet_cells",
                 "facet_local_index", "cell_facets", "cell_edges",
                 "interior_facets", "exterior_facets"):
        assert np.array_equal(getattr(mj, name), getattr(mt, name)), name
    assert np.array_equal(mj.cell_diameters(), mt.cell_diameters())
    for deg in (1, 2):
        Vj = cj.functionspace(mj, ("Lagrange", deg))
        Vt = ct.functionspace(mt, ("Lagrange", deg), device="cpu")
        assert Vt.dim == Vj.dim
        assert np.array_equal(Vj.dofmap, Vt.dofmap)
        assert np.array_equal(Vj.dof_coordinates, Vt.dof_coordinates)


def test_structured_lattice_info_matches():
    from cutfemx_tpu.mg import structured_lattice_info as lat_j
    from cutfemx_tpu_torch.mg import structured_lattice_info as lat_t
    mesh = ct.mesh.create_box((-1, -1, -1), (1, 1, 1), (N_BOX,) * 3)
    for a, b in zip(lat_j(mesh), lat_t(mesh)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("deg", [1, 2])
def test_tabulation_torch_branch_matches_jax(deg):
    from cutfemx_tpu.elements import lagrange_element as el_j
    from cutfemx_tpu_torch.elements import lagrange_element as el_t
    pts = np.random.default_rng(3).random((2, 7, 3)) / 3.0
    ej, et = el_j("tetrahedron", deg), el_t("tetrahedron", deg)
    pt = torch.as_tensor(pts)
    assert rel_err(ej.tabulate(jnp.asarray(pts)), et.tabulate(pt)) < 1e-14
    assert rel_err(ej.tabulate_grad(jnp.asarray(pts)),
                   et.tabulate_grad(pt)) < 1e-14
    # numpy in, numpy out, as before
    assert isinstance(et.tabulate(pts), np.ndarray)


def test_function_interpolate_on_device():
    mesh = ct.mesh.create_box((0, 0, 0), (1, 1, 1), (2, 2, 2))
    V = ct.functionspace(mesh, ("Lagrange", 2), device="cpu")
    f = ct.Function(V, dtype=torch.float64)
    f.interpolate(lambda x: x[0] + 2 * x[1])
    assert f.x.device.type == "cpu" and f.x.dtype == torch.float64
    xy = V.dof_coordinates
    assert np.allclose(f.x.numpy(), xy[:, 0] + 2 * xy[:, 1])


def test_cg_matches_reference_iterations():
    """Same SPD system, same stopping rule: same iteration count."""
    from cutfemx_tpu.la import cg as cg_j
    from cutfemx_tpu_torch.la import cg as cg_t
    rng = np.random.default_rng(5)
    B = rng.standard_normal((40, 40))
    A = B @ B.T + 40 * np.eye(40)
    b = rng.standard_normal(40)
    d = np.diag(A).copy()
    xj, itj, _ = cg_j(lambda x: jnp.asarray(A) @ x, jnp.asarray(b),
                      M=lambda r: r / jnp.asarray(d), rtol=1e-10)
    At, dt = torch.as_tensor(A), torch.as_tensor(d)
    xt, itt, _ = cg_t(lambda x: At @ x, torch.as_tensor(b),
                      M=lambda r: r / dt, rtol=1e-10)
    assert int(itj) == itt
    assert rel_err(xj, xt) < 1e-10


# -- the package boundary ---------------------------------------------------


def test_port_imports_no_jax():
    """Every module of the package (pkgutil.walk_packages) imports without
    pulling in jax or cutfemx_tpu."""
    code = (
        "import importlib, pkgutil, sys, torch\n"
        "import cutfemx_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__,"
        " pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert len(names) >= 46 and 'cutfemx_tpu_torch.extensions' in names,"
        " names\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'cutfemx_tpu')]\n"
        "assert not bad, bad\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert not torch.backends.cudnn.allow_tf32\n"
        "assert torch.get_float32_matmul_precision() == 'highest'\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=repo)
