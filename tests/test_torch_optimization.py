"""The shape-optimization toolkit and the compliance demo of
cutfemx_tpu_torch against cutfemx_tpu, in f64 on the CPU: the numpy
optimizer helpers (L-BFGS, ALM, Barzilai-Borwein, Armijo, CSV writers,
solid components), the Riesz velocity solver, the three advection methods
(with point location and evaluation), checkpoints across the two packages,
and demo_compliance_optimization at n = 8 against the reference demo's
run_optimization. Field values are held to 1e-12 absolute, the demo's
history to 1e-8 relative."""

import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import cutfemx_tpu as cj  # noqa: E402
import cutfemx_tpu_torch as ct  # noqa: E402
from cutfemx_tpu import distance as dist_j  # noqa: E402
from cutfemx_tpu import optimization as oj  # noqa: E402
from cutfemx_tpu_torch import optimization as ot  # noqa: E402
from cutfemx_tpu_torch.demos import \
    demo_compliance_optimization as demo_t  # noqa: E402

TOL = 1e-12
HISTORY_RTOL = 1e-8
HISTORY_KEYS = ("compliance", "volume", "lagrangian", "dt")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = ((cj, oj, {}), (ct, ot, {"device": "cpu"}))
F64 = {"dtype": torch.float64}


def host(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _dsl(pkg):
    return importlib.import_module(pkg.__name__ + ".forms.dsl"), \
        importlib.import_module(pkg.__name__ + ".forms.measure").Measure


def _reference_demo():
    spec = importlib.util.spec_from_file_location(
        "demo_compliance_optimization",
        os.path.join(ROOT, "demos", "demo_compliance_optimization.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_numpy_helpers_match_reference(tmp_path):
    """L-BFGS (updates, the two-loop product, directions and resets, a
    weighted inner product), ALM, Barzilai-Borwein steps, the CFL cap,
    Armijo, the volume shift, the CSV writers and solid components give
    the reference's numbers on the same inputs."""
    rng = np.random.default_rng(1)
    Q = np.diag(np.linspace(1.0, 30.0, 12))
    W = np.diag(np.linspace(0.5, 2.0, 12))
    xs = [rng.standard_normal(12) for _ in range(7)]
    out = {}
    for pkg, opt, _ in PKGS:
        st = opt.LBFGSState()
        step = opt.AdaptiveGradientStepState()
        alm = opt.AugmentedLagrangianState(rho_growth=1.05)
        opt.initialise_augmented_lagrangian_scale(alm, 2.0, 0.3)
        rows = []
        for i, x in enumerate(xs):
            g = Q @ x if i != 3 else -Q @ x         # one bad pair
            opt.lbfgs_update(st, x, g, memory=3,
                             inner_product=lambda a, b: a @ W @ b)
            d, slope, resets = opt.lbfgs_direction(st, g)
            dt_row = opt.adaptive_gradient_dt(step, x, g, 0.1, 0.05,
                                              3.0, 0.5)
            opt.accept_adaptive_gradient_step(step, x, g,
                                              dt_row["dt_next"])
            c = 0.3 / (i + 1)
            mult = opt.alm_velocity_multiplier(alm, c)
            opt.update_augmented_lagrangian(alm, c)
            rows.append((d, slope, resets, st.curvature_sy,
                         st.pair_accepted, len(st.s_hist),
                         tuple(dt_row.values()), mult,
                         opt.lagrangian_value(1.0, c, alm),
                         opt.armijo_rhs(1.0, slope, 0.1, 1e-4),
                         opt.armijo_rhs(1.0, 1.0, 0.1, 1e-4),
                         opt.motion_dt_cap(0.05, 0.0, 0.5),
                         opt.reinit_volume_shift(1.7, 1.6, 2.0, 0.01)))
        out[pkg] = rows
        with opt.ConvergenceWriter(tmp_path / f"{pkg.__name__}.csv",
                                   ("iteration", "x")) as w:
            row = {"iteration": 1}
            with opt.phase(row, "a"):
                pass
            w.write({"iteration": 0, "x": 1.5, "dropped": 3})
            w.write(row)
        mesh = pkg.mesh.create_unit_square(6)
        comps = opt.solid_components(mesh, np.r_[0:10, 40:52], [0], [45])
        out[pkg, "comps"] = [(c.cells.tolist(), c.anchored, c.loaded)
                             for c in comps]
    for rj, rt in zip(out[cj], out[ct]):
        assert np.abs(rj[0] - rt[0]).max() < TOL
        for a, b in zip(rj[1:], rt[1:]):
            assert np.allclose(a, b, rtol=1e-14, atol=0), (a, b)
    assert out[cj, "comps"] == out[ct, "comps"]
    assert (tmp_path / "cutfemx_tpu.csv").read_text() == \
        (tmp_path / "cutfemx_tpu_torch.csv").read_text()


def test_riesz_velocity_solver_matches_reference():
    """Interface forms of a cut circle (12^2, density 1) with and without
    homogeneous Dirichlet facets: the Riesz velocities, their right-hand
    sides and the H1 inner product within 1e-12."""
    out = {}
    for pkg, opt, kw in PKGS:
        d, Measure = _dsl(pkg)
        mesh = pkg.mesh.create_rectangle((-1, -1), (1, 1), (12, 12))
        phi = pkg.Function(pkg.functionspace(mesh, ("Lagrange", 1), **kw),
                           **(F64 if kw else {}))
        phi.interpolate(lambda x: np.sqrt(x[0] ** 2 + x[1] ** 2) - 0.6)
        cd = pkg.cut(phi)
        dxg = Measure("dx", domain=mesh,
                      subdomain_data=pkg.runtime_quadrature(cd, "phi=0", 2))
        res = []
        for zero in (None, mesh.exterior_facets):
            solver = opt.RieszVelocitySolver(mesh, 0.3, zero_facets=zero,
                                             **kw)
            x = d.SpatialCoordinate(mesh)
            shape_rhs, volume_rhs = solver.interface_forms(1.0 + x[0], dxg)
            for f in (shape_rhs, volume_rhs):
                v, b = solver.solve(f)
                res += [host(v.x), host(b)]
            res.append(np.array([solver.h1_inner(res[-2], res[-2])]))
        out[pkg] = res
    for a, b in zip(out[cj], out[ct]):
        assert np.abs(a - b).max() < TOL * max(1.0, np.abs(a).max())


def test_advection_methods_match_reference():
    """SUPG (with fixed inflow facets, and a second dt that reuses every
    compiled kernel), nodal Hamilton-Jacobi and semi-Lagrangian
    characteristics moving a plane with a varying speed (12^2): phi within
    1e-12; locate_cells and evaluate_at_points (outside points take the
    nearest cell) give the reference's cells and values."""
    from cutfemx_tpu_torch.forms.compile import _KERNEL_CACHE
    rng = np.random.default_rng(4)
    pts = np.concatenate([rng.uniform(0, 1, (50, 2)),
                          [[1.2, 0.5], [-0.1, -0.1], [0.5, 0.5]]])
    out = {}
    for pkg, opt, kw in PKGS:
        mesh = pkg.mesh.create_rectangle((0, 0), (1, 1), (12, 12))
        V = pkg.functionspace(mesh, ("Lagrange", 1), **kw)
        Vv = pkg.functionspace(mesh, ("Lagrange", 1), shape=(2,), **kw)

        def fn(space, f):
            u = pkg.Function(space, **(F64 if kw else {}))
            u.interpolate(f)
            return u

        speed = fn(V, lambda x: 1.0 + 0.5 * x[1])
        vel = fn(Vv, lambda x: np.stack([1.0 + 0.5 * x[1], 0.3 * x[0]]))
        res = []
        mid = mesh.midpoints(mesh.tdim - 1, mesh.exterior_facets)
        left = mesh.exterior_facets[np.abs(mid[:, 0]) < 1e-12]
        for method, fixed, dts in (("supg", left, (0.05, 0.037)),
                                   ("nodal", None, (0.025,) * 3),
                                   ("characteristics", None, (0.05,))):
            solver = opt.LevelSetAdvectionSolver(V, fixed_facets=fixed)
            phi = fn(V, lambda x: x[0] - 0.4 + 0.1 * x[1] ** 2)
            ext = dist_j.NormalExtensionResult(speed, vel, None)
            for i, dt in enumerate(dts):
                solver.advect(phi, ext, dt, method=method)
                if pkg is ct and method == "supg":
                    if i == 0:
                        n_kernels = len(_KERNEL_CACHE)
                    else:
                        assert len(_KERNEL_CACHE) == n_kernels
                res.append(host(phi.x))
        cells = opt.locate_cells(mesh, pts)
        res += [cells, opt.evaluate_at_points(vel, pts, cells),
                opt.evaluate_at_points(speed, pts)]
        out[pkg] = res
    for a, b in zip(out[cj], out[ct]):
        assert np.abs(a - b).max() < TOL
    with pytest.raises(ValueError, match="unknown advection"):
        ot.LevelSetAdvectionSolver(V).advect(phi, ext, 0.1, method="x")


def test_checkpoints_cross_packages(tmp_path):
    """A checkpoint written by either package loads in the other: the
    design (a tensor's values copied from its device), the L-BFGS pairs,
    ALM, BB memory, dt and the scalars come back equal; a wrong-sized
    Function is refused."""
    rng = np.random.default_rng(2)
    V = ct.functionspace(ct.mesh.create_unit_square(4), ("Lagrange", 1),
                         device="cpu")
    phi = ct.Function(V, **F64)
    phi.x = torch.as_tensor(rng.standard_normal(V.dim))
    lb = ot.LBFGSState()
    for _ in range(3):
        ot.lbfgs_update(lb, rng.standard_normal(V.dim),
                        rng.standard_normal(V.dim), memory=5,
                        curvature_tol=-1.0)
    alm = ot.AugmentedLagrangianState(1.5, 2.0, 1.1, 50.0, 0.01)
    step = ot.AdaptiveGradientStepState(rng.standard_normal(V.dim),
                                        rng.standard_normal(V.dim), 0.02)
    for writer, reader in ((ot, oj), (oj, ot)):
        path = tmp_path / f"{writer.__name__}.npz"
        writer.save_checkpoint(path, iteration=7, phi=phi, lbfgs=lb,
                               alm=alm, step=step, dt=0.03,
                               scalars={"best": 1.25})
        target = ct.Function(V, **F64)
        ck = reader.load_checkpoint(
            path, phi=target if reader is ot else None)
        assert ck["iteration"] == 7 and ck["dt"] == 0.03
        assert ck["scalars"] == {"best": 1.25}
        assert np.array_equal(ck["phi"], host(phi.x))
        if reader is ot:
            assert torch.equal(target.x, phi.x)
        for a, b in zip(ck["lbfgs"].s_hist + ck["lbfgs"].y_hist,
                        lb.s_hist + lb.y_hist):
            assert np.array_equal(a, b)
        assert ck["lbfgs"].inv_sy == lb.inv_sy
        assert (ck["alm"].multiplier, ck["alm"].slack) == (1.5, 0.01)
        assert np.array_equal(ck["step"].anchor_phi, step.anchor_phi)
    wrong = ct.Function(ct.functionspace(ct.mesh.create_unit_square(3),
                                         ("Lagrange", 1), device="cpu"))
    with pytest.raises(ValueError, match="shape"):
        ot.load_checkpoint(path, phi=wrong)


def test_compliance_demo_matches_reference(tmp_path):
    """demo_compliance_optimization at n = 8, 3 iterations (L-BFGS, SUPG,
    a reinitialization at the third) against the reference demo's
    run_optimization: compliance, volume, Lagrangian and dt of every
    iteration within 1e-8 relative.

    Both start from the reference's initial design (its reinitialized
    level set and ALM scale, passed as a checkpoint that the port resumes
    from): the initial four-hole design is symmetric under a half turn, so
    some vertices lie exactly equidistant from two interface pieces, and
    the closest-piece choice of the normal extension then follows
    last-bit differences of the reinitialized level set (4e-16 here)."""
    ref = _reference_demo()
    args = ref.parse_args(["--n", "8", "--iters", "3", "--quiet"])
    straight = ref.run_optimization(args)
    # the reference's initial design and ALM scale, as its run has them
    mesh = cj.mesh.create_rectangle((0.0, 0.0), (2.0, 1.0), (16, 8))
    phi = cj.Function(cj.functionspace(mesh, ("Lagrange", 1)))
    phi.interpolate(lambda x: np.maximum.reduce(
        [0.15 - np.sqrt((x[0] - cx) ** 2 + (x[1] - cy) ** 2)
         for cx, cy in ((0.5, 0.5), (1.0, 0.25), (1.0, 0.75), (1.5, 0.5))]))
    phi = dist_j.reinitialize(phi)
    state = ref.make_state_solver(mesh, args)[1](phi)
    alm = oj.AugmentedLagrangianState(rho_growth=1.05)
    oj.initialise_augmented_lagrangian_scale(
        alm, state["compliance"], state["volume"] - args.target_volume)
    ck = str(tmp_path / "initial.npz")
    oj.save_checkpoint(ck, iteration=0, phi=phi, alm=alm)
    port = demo_t.run(["--checkpoint", ck, "--resume"], n=8, iters=3,
                      quiet=True, device="cpu")
    assert len(port["history"]) == len(straight["history"]) == 3
    for hj, ht in zip(straight["history"], port["history"]):
        for k in HISTORY_KEYS:
            assert abs(hj[k] - ht[k]) <= HISTORY_RTOL * abs(hj[k]), (k, hj,
                                                                     ht)
    assert port["phi"].x.dtype == torch.float64
    prof = port["profile"][-1]
    assert prof["state_solves"] >= 2 and prof["time_reinit"] > 0


def test_compliance_demo_resume_matches_straight_run(tmp_path):
    """3 straight iterations against 2 + checkpoint + 1 resumed (L-BFGS,
    a reinitialization every 2, CSVs written): the same history, to the
    last bit."""
    base = ["--optimizer", "lbfgs", "--reinit-every", "2",
            "--remove-floating-every", "0"]
    kw = dict(n=8, quiet=True, device="cpu")
    straight = demo_t.run(base, iters=3, **kw)
    ck = str(tmp_path / "ck.npz")
    demo_t.run(base + ["--checkpoint", ck], iters=2,
               output_dir=str(tmp_path / "csv"), **kw)
    assert (tmp_path / "csv" / "convergence.csv").read_text().count("\n") \
        == 3
    resumed = demo_t.run(base + ["--checkpoint", ck, "--resume"], iters=3,
                         **kw)
    assert resumed["history"][-1]["iteration"] == 2
    for k in HISTORY_KEYS:
        assert resumed["history"][-1][k] == straight["history"][-1][k], k


# -- the JAX-CPU values chip_smoke.py pins (PERF.md section 4) ---------------


def reference_compliance(n, iters, checkpoint):
    """The reference demo's run at ``n`` for ``iters`` iterations (its
    other defaults: L-BFGS, SUPG, a reinitialization every 3), with its
    initial design and ALM scale written to ``checkpoint`` (what
    chip_smoke.py's shape_opt phase resumes from): the history's
    compliance, volume, Lagrangian and dt per iteration."""
    ref = _reference_demo()
    args = ref.parse_args(["--n", str(n), "--iters", str(iters), "--quiet"])
    straight = ref.run_optimization(args)
    mesh = cj.mesh.create_rectangle((0.0, 0.0), (2.0, 1.0), (2 * n, n))
    phi = cj.Function(cj.functionspace(mesh, ("Lagrange", 1)))
    phi.interpolate(lambda x: np.maximum.reduce(
        [0.15 - np.sqrt((x[0] - cx) ** 2 + (x[1] - cy) ** 2)
         for cx, cy in ((0.5, 0.5), (1.0, 0.25), (1.0, 0.75), (1.5, 0.5))]))
    phi = dist_j.reinitialize(phi)
    state = ref.make_state_solver(mesh, args)[1](phi)
    alm = oj.AugmentedLagrangianState(rho_growth=1.05)
    oj.initialise_augmented_lagrangian_scale(
        alm, state["compliance"], state["volume"] - args.target_volume)
    oj.save_checkpoint(checkpoint, iteration=0, phi=phi, alm=alm)
    return [[h[k] for k in HISTORY_KEYS] for h in straight["history"]]
