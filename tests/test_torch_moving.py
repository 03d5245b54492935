"""The moving-domain heat equation (BASELINE config 5) in
cutfemx_tpu_torch against cutfemx_tpu, in f64 on the CPU: the re-cut
(``update``) and the whole demo, cut and runtime quadrature included,
step by step against demos/demo_moving_heat.py; and the re-cut loop's
bounds of tests/test_dg_and_moving.py."""

import contextlib
import importlib.util
import io
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import cutfemx_tpu as cj  # noqa: E402
import cutfemx_tpu_torch as ct  # noqa: E402
from cutfemx_tpu_torch.demos import demo_moving_heat  # noqa: E402
from test_torch_core import host, rel_err  # noqa: E402

N_HEAT, STEPS = 12, 3
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _disk(c, r=0.42):
    return lambda x: np.sqrt((x[0] - c[0]) ** 2 + (x[1] - c[1]) ** 2) - r


@pytest.fixture(scope="module")
def ref_heat():
    """demos/demo_moving_heat.py's run(n=12, steps=3) (it prints each
    step; the output is dropped)."""
    spec = importlib.util.spec_from_file_location(
        "demo_moving_heat_reference",
        os.path.join(ROOT, "demos", "demo_moving_heat.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with contextlib.redirect_stdout(io.StringIO()):
        return mod.run(n=N_HEAT, steps=STEPS)


def test_update_reclassifies_like_reference():
    """cut at one disk, move it, update: the classification and the cell
    lists equal the reference's, and equal a fresh cut of the moved
    disk."""
    out = []
    for pkg, kw in ((cj, {}), (ct, {"device": "cpu"})):
        mesh = pkg.mesh.create_rectangle((-1.0, -1.0), (1.0, 1.0),
                                         (N_HEAT, N_HEAT))
        phi = pkg.Function(pkg.functionspace(mesh, ("Lagrange", 1), **kw))
        phi.interpolate(_disk((-0.2, 0.0)))
        cd = pkg.cut(phi)
        before = cd.domains.copy()
        phi.interpolate(_disk((0.15, 0.05)))
        pkg.update(cd)
        assert not np.array_equal(before, cd.domains)
        assert np.array_equal(cd.domains, pkg.cut(phi).domains)
        out.append((cd.domains, pkg.locate_entities(cd, "phi<0"),
                    pkg.locate_entities(cd, "phi=0"),
                    pkg.ghost_penalty_facets(cd, "phi<0")))
    for aj, at in zip(*out):
        assert np.array_equal(aj, at)
    assert ct.update.__module__ == "cutfemx_tpu_torch.cut.api"


def test_runtime_quadrature_matches_reference(ref_heat):
    """The demo's rules at its first position, volume and interface, from
    each package's own cut (after the reference's demo: its programs are
    compiled then)."""
    rules = []
    for pkg, kw in ((cj, {}), (ct, {"device": "cpu",
                                     "dtype": torch.float64})):
        mesh = pkg.mesh.create_rectangle((-1.0, -1.0), (1.0, 1.0),
                                         (N_HEAT, N_HEAT))
        V = pkg.functionspace(mesh, ("Lagrange", 1),
                              **({} if pkg is cj else {"device": "cpu"}))
        phi = pkg.Function(V, **({} if pkg is cj else {"dtype": kw["dtype"]}))
        phi.interpolate(_disk((-0.2, 0.0)))
        cd = pkg.cut(phi)
        rules.append([pkg.runtime_quadrature(cd, s, 2)
                      for s in ("phi<0", "phi=0")])
    for rj, rt in zip(*rules):
        assert np.array_equal(rj.parent_map, rt.parent_map)
        assert rel_err(rj.points_padded, rt.points_padded) < 1e-13
        assert rel_err(rj.weights_padded, rt.weights_padded) < 1e-13


def test_moving_heat_matches_reference_step_by_step(ref_heat):
    out = demo_moving_heat.run(n=N_HEAT, steps=STEPS, device="cpu")
    assert len(out["errors"]) == len(ref_heat) == STEPS
    for ej, et in zip(ref_heat, out["errors"]):
        assert abs(ej - et) < 1e-10 * ej, (ej, et)
    for s in out["split"]:
        assert all(s[k] >= 0 for k in ("recut_s", "quadrature_s",
                                       "assembly_s", "host_csr_s",
                                       "solve_s"))


def test_moving_heat_errors_stay_bounded():
    """tests/test_dg_and_moving.py::test_moving_heat_equation's bound."""
    errors = demo_moving_heat.run(n=24, steps=5, device="cpu")["errors"]
    assert max(errors) < 5e-3, errors


def test_recut_loop_reuses_kernels():
    """tests/test_dg_and_moving.py::test_moving_domain_recut_loop in the
    port: re-cut, re-assemble and solve over a moving disk; the kernel
    cache does not grow after the first step, and the errors stay under
    its bound."""
    from cutfemx_tpu_torch import fem
    from cutfemx_tpu_torch.forms import dsl as d
    from cutfemx_tpu_torch.forms.compile import _KERNEL_CACHE
    from cutfemx_tpu_torch.forms.measure import Measure
    f64 = torch.float64
    n = 24
    mesh = ct.mesh.create_rectangle((-1.0, -1.0), (1.0, 1.0), (n, n))
    phi = ct.Function(ct.functionspace(mesh, ("Lagrange", 1),
                                       device="cpu"), dtype=f64)
    V = ct.functionspace(mesh, ("Lagrange", 1), device="cpu")
    errs, cut_data, n_kernels = [], None, None
    for step, c in enumerate([(0.0, 0.0), (0.1, 0.0), (0.2, 0.05),
                              (0.25, 0.1)]):
        phi.interpolate(_disk(c))
        if cut_data is None:
            cut_data = ct.cut(phi)
        else:
            ct.update(cut_data)
        inside = ct.locate_entities(cut_data, "phi<0")
        vol = ct.runtime_quadrature(cut_data, "phi<0", 2)
        srf = ct.runtime_quadrature(cut_data, "phi=0", 2)
        gp = ct.ghost_penalty_facets(cut_data, "phi<0")
        dxo = Measure("dx", domain=mesh, subdomain_data=[inside, vol])
        dxg = Measure("dx", domain=mesh, subdomain_data=srf)
        dSg = Measure("dS", domain=mesh, subdomain_data=gp)
        u, v = d.TrialFunction(V), d.TestFunction(V)
        x = d.SpatialCoordinate(mesh)
        ng, nf, h = ct.normal(phi), d.FacetNormal(mesh), d.CellDiameter(mesh)
        ue = d.sin(d.pi * x[0]) * d.sin(d.pi * x[1])
        a = d.inner(d.grad(u), d.grad(v)) * dxo
        a += (-d.dot(d.grad(u), ng) * v - d.dot(d.grad(v), ng) * u
              + 40.0 / h * u * v) * dxg
        a += 0.1 * d.avg(h) * d.inner(d.jump(d.grad(u), nf),
                                      d.jump(d.grad(v), nf)) * dSg
        L = 2 * d.pi ** 2 * ue * v * dxo + (-d.dot(d.grad(v), ng) * ue
                                            + 40.0 / h * ue * v) * dxg
        af, Lf = fem.form(a, dtype=f64), fem.form(L, dtype=f64)
        A, b = fem.deactivate_outside(fem.assemble_matrix(af),
                                      fem.assemble_vector(Lf),
                                      fem.active_domain(af))
        uh = ct.Function(V, dtype=f64)
        uh.x = ct.la.direct_solve(A, b)
        e = d.CoefficientExpr(uh) - ue
        errs.append(float(np.sqrt(float(fem.assemble_scalar(
            fem.form(e * e * dxo, dtype=f64))))))
        if step == 0:
            n_kernels = len(_KERNEL_CACHE)
    assert len(_KERNEL_CACHE) == n_kernels
    assert max(errs) < 8e-3, errs
    assert host(uh.x).shape == (V.dim,)
