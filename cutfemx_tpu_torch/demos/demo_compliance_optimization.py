"""Level-set compliance (shape) optimization on the
``cutfemx_tpu_torch.optimization`` toolkit: the port of
``demos/demo_compliance_optimization.py``.

Per accepted iteration:

  cut + runtime quadrature -> cut linear-elasticity state solve (traction-
  free hole boundary, clamped left edge, load patch on the right) ->
  compliance / volume objectives -> augmented-Lagrangian volume
  multiplier -> H1 Riesz smoothing of the interface shape gradient ->
  optional L-BFGS direction over the level-set design -> FIM
  normal-velocity extension into the bulk (distance.extend_normal_velocity)
  -> Barzilai-Borwein step proposal capped by an interface-motion CFL ->
  Armijo backtracking on the augmented Lagrangian (each trial re-cuts and
  re-solves the state) -> level-set advection (SUPG transport / nodal HJ /
  semi-Lagrangian characteristics) -> periodic reinitialization with a
  constant-shift volume correction -> floating-island removal.

Forms assemble in float64 on ``--device``; the state, Riesz and SUPG
solves are host sparse direct solves, as in the reference. Profile and
convergence CSVs stream to --output-dir.

Run:  python -m cutfemx_tpu_torch.demos.demo_compliance_optimization
          --n 32 --iters 10 --optimizer lbfgs --advect supg [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

import cutfemx_tpu_torch as cfx
from cutfemx_tpu_torch import distance, fem
from cutfemx_tpu_torch import optimization as opt
from cutfemx_tpu_torch.forms.dsl import (CellDiameter, CoefficientExpr,
                                         FacetNormal, Identity,
                                         TestFunction, TrialFunction,
                                         as_vector, avg, grad, inner, jump,
                                         sym, tr)
from cutfemx_tpu_torch.forms.measure import Measure
from cutfemx_tpu_torch.la import direct_solve

F64 = torch.float64

PROFILE_FIELDS = [
    "iteration", "time_cut", "time_state_solve", "time_gradient",
    "time_extension", "time_line_search", "time_advect", "time_reinit",
    "time_total", "state_solves", "backtracks",
]
CONVERGENCE_FIELDS = [
    "iteration", "compliance", "volume", "lagrangian", "volume_error",
    "multiplier", "dt", "speed_max", "lbfgs_pairs", "lbfgs_reset",
    "armijo_accepted", "components", "floating_removed",
]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--n", type=int, default=32, help="cells across height")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--optimizer", choices=("gradient", "lbfgs"),
                   default="lbfgs")
    p.add_argument("--lbfgs-memory", type=int, default=5)
    p.add_argument("--lbfgs-damping", type=float, default=1.0,
                   help="1 = pure L-BFGS speed, 0 = pure gradient")
    p.add_argument("--lbfgs-curvature-tol", type=float, default=1e-8)
    p.add_argument("--advect",
                   choices=("supg", "nodal", "characteristics"),
                   default="supg")
    p.add_argument("--target-volume", type=float, default=1.6,
                   help="solid volume target (domain area is 2.0)")
    p.add_argument("--motion-cfl", type=float, default=0.5)
    p.add_argument("--armijo-c1", type=float, default=1e-4)
    p.add_argument("--max-backtracks", type=int, default=3)
    p.add_argument("--smoothing-length", type=float, default=2.0,
                   help="Riesz H1 smoothing length in units of h")
    p.add_argument("--reinit-every", type=int, default=3)
    p.add_argument("--reinit-volume-correction-limit", type=float,
                   default=0.0)
    p.add_argument("--remove-floating-every", type=int, default=5)
    p.add_argument("--checkpoint", default=None,
                   help="npz path for restartable optimizer checkpoints")
    p.add_argument("--checkpoint-every", type=int, default=1)
    p.add_argument("--resume", action="store_true",
                   help="resume from --checkpoint if it exists")
    p.add_argument("--output-dir", default=None,
                   help="write profile.csv/convergence.csv here")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def _host(x):
    return x.detach().cpu().numpy()


def make_state_solver(mesh, args):
    """The cut elasticity state problem: returns evaluate(phi) ->
    dict(compliance, volume, interface, uh, measures...)."""
    mu, lam = 1.0, 1.25
    gamma_g = 0.1
    V = cfx.functionspace(mesh, ("Lagrange", 1), shape=(2,),
                          device=args.device)

    def sigma(w):
        e = sym(grad(w))
        return 2 * mu * e + lam * tr(e) * Identity(2)

    ext = mesh.exterior_facets
    mid = mesh.midpoints(mesh.tdim - 1, ext)
    left = ext[np.abs(mid[:, 0]) < 1e-12]
    # load patch: middle third of the right edge
    right = ext[(np.abs(mid[:, 0] - 2.0) < 1e-12)
                & (np.abs(mid[:, 1] - 0.5) < 0.17)]
    bc_dofs = fem.locate_dofs_topological(V, mesh.tdim - 1, left)
    fc = np.asarray(mesh.facet_cells)
    anchored_cells = fc[left, 0]
    loaded_cells = fc[right, 0]
    ds_right = Measure("ds", domain=mesh, subdomain_data=right)
    traction = as_vector([0.0, -0.1])

    def evaluate(phi):
        cd = cfx.cut(phi)
        inside = cfx.locate_entities(cd, "phi<0")
        vol_rules = cfx.runtime_quadrature(cd, "phi<0", 2)
        srf_rules = cfx.runtime_quadrature(cd, "phi=0", 2)
        gp = cfx.ghost_penalty_facets(cd, "phi<0")
        dxo = Measure("dx", domain=mesh,
                      subdomain_data=[inside, vol_rules])
        dxg = Measure("dx", domain=mesh, subdomain_data=srf_rules)
        u, v = TrialFunction(V), TestFunction(V)
        nf = FacetNormal(mesh)
        hh = CellDiameter(mesh)
        a = inner(sigma(u), sym(grad(v))) * dxo
        if gp.size:
            dSg = Measure("dS", domain=mesh, subdomain_data=gp)
            a += gamma_g * avg(hh) * inner(jump(grad(u), nf),
                                           jump(grad(v), nf)) * dSg
        L = inner(traction, v) * ds_right
        af, Lf = fem.form(a, dtype=F64), fem.form(L, dtype=F64)
        bcs = [fem.dirichletbc(0.0, bc_dofs, V)]
        A = fem.assemble_matrix(af, bcs=bcs)
        b = _host(fem.assemble_vector(Lf))
        b = fem.set_bc(b, bcs)
        dom = fem.active_domain(af)
        fem.deactivate_outside(A, b, dom)
        uh = cfx.Function(V, dtype=F64)
        uh.x = torch.as_tensor(direct_solve(A, b), device=uh.x.device)
        ue = CoefficientExpr(uh)
        energy = inner(sigma(ue), sym(grad(ue)))

        def integral(expr):
            return float(fem.assemble_scalar(fem.form(expr, dtype=F64)))

        compliance = integral(energy * dxo)
        volume = integral(1.0 * dxo)
        interface = integral(1.0 * dxg)
        return dict(cd=cd, uh=uh, energy=energy, dxo=dxo, dxg=dxg,
                    compliance=compliance, volume=volume,
                    interface=interface, inside_cells=inside,
                    anchored_cells=anchored_cells,
                    loaded_cells=loaded_cells)

    return V, evaluate


def run_optimization(args) -> dict:
    n = args.n
    mesh = cfx.mesh.create_rectangle((0.0, 0.0), (2.0, 1.0), (2 * n, n))
    h = 1.0 / n
    Vphi = cfx.functionspace(mesh, ("Lagrange", 1), device=args.device)
    phi = cfx.Function(Vphi, name="phi", dtype=F64)

    def init_phi(x):
        holes = [(0.5, 0.5), (1.0, 0.25), (1.0, 0.75), (1.5, 0.5)]
        vals = [0.15 - np.sqrt((x[0] - cx) ** 2 + (x[1] - cy) ** 2)
                for cx, cy in holes]
        return np.maximum.reduce(vals)

    phi.interpolate(init_phi)
    phi = distance.reinitialize(phi)

    Vu, evaluate_state = make_state_solver(mesh, args)
    riesz = opt.RieszVelocitySolver(mesh, args.smoothing_length * h,
                                    device=args.device)
    advector = opt.LevelSetAdvectionSolver(Vphi)
    lbfgs = opt.LBFGSState()
    alm = opt.AugmentedLagrangianState(rho_growth=1.05)
    step = opt.AdaptiveGradientStepState()
    dt = args.motion_cfl * h  # first-step guess, refined by BB

    start_it = 0
    resumed = False
    if args.resume and args.checkpoint:
        import os
        if os.path.exists(args.checkpoint):
            ck = opt.load_checkpoint(args.checkpoint, phi=phi)
            start_it = ck["iteration"]
            lbfgs = ck.get("lbfgs", lbfgs)
            alm = ck.get("alm", alm)
            step = ck.get("step", step)
            dt = ck.get("dt", dt)
            resumed = True
            if not args.quiet:
                print(f"resumed from {args.checkpoint} at iteration "
                      f"{start_it}")

    def evaluate(phi, row=None):
        if row is None:
            return evaluate_state(phi)
        row["state_solves"] += 1
        with opt.phase(row, "state_solve"):
            return evaluate_state(phi)

    state = evaluate(phi)
    if not resumed:
        opt.initialise_augmented_lagrangian_scale(
            alm, state["compliance"], state["volume"] - args.target_volume)

    history = []
    profile_rows = []
    writers_ctx = None
    if args.output_dir:
        from pathlib import Path
        out = Path(args.output_dir)
        pw = opt.ProfileWriter(out / "profile.csv", PROFILE_FIELDS)
        cw = opt.ConvergenceWriter(out / "convergence.csv",
                                   CONVERGENCE_FIELDS)
        writers_ctx = (pw.__enter__(), cw.__enter__())

    if not args.quiet:
        print(f"{'it':>3s} {'compliance':>12s} {'volume':>8s} "
              f"{'L':>12s} {'dt':>9s} {'bt':>2s} {'pairs':>5s}")

    try:
        for it in range(start_it, args.iters):
            row = {"iteration": it, "state_solves": 0}
            conv = {"iteration": it}
            t_total0 = time.perf_counter()

            constraint = state["volume"] - args.target_volume
            multiplier = opt.alm_velocity_multiplier(alm, constraint)
            L0 = opt.lagrangian_value(state["compliance"], constraint,
                                      alm)

            # -- shape gradient: Riesz-smoothed interface density ------
            with opt.phase(row, "gradient"):
                shape_rhs, volume_rhs = riesz.interface_forms(
                    state["energy"], state["dxg"])
                v_shape, b_shape = riesz.solve(shape_rhs, "v_shape")
                v_vol, b_vol = riesz.solve(volume_rhs, "v_vol")
                # descent speed (>0 grows the solid): W - multiplier
                speed_vals = (_host(v_shape.x)
                              + multiplier * _host(v_vol.x))
                gradient = speed_vals.copy()
                conv["lbfgs_pairs"] = 0
                conv["lbfgs_reset"] = 0
                if args.optimizer == "lbfgs":
                    opt.lbfgs_update(
                        lbfgs, _host(phi.x), gradient,
                        memory=args.lbfgs_memory,
                        curvature_tol=args.lbfgs_curvature_tol)
                    direction, _, resets = opt.lbfgs_direction(lbfgs,
                                                               gradient)
                    # blend: speed = (1-d) g + d (-direction) with
                    # direction = -Hg
                    speed_vals = ((1.0 - args.lbfgs_damping) * gradient
                                  - args.lbfgs_damping * direction)
                    conv["lbfgs_pairs"] = len(lbfgs.s_hist)
                    conv["lbfgs_reset"] = resets

            # -- extend speed off the interface ------------------------
            with opt.phase(row, "extension"):
                speed = cfx.Function(Vphi, name="speed", dtype=F64)
                speed.x = torch.as_tensor(speed_vals, device=speed.x.device)
                extension = distance.extend_normal_velocity(phi, speed)
                smax = float(np.abs(_host(extension.speed.x)).max()) + 1e-14

            # predicted d/dt of the Lagrangian when moving with the
            # extended speed: dJ = -int_G s W, dV = +int_G s
            s_used = _host(speed.x)
            rate = -(float(np.dot(s_used, b_shape))
                     + multiplier * float(np.dot(s_used, b_vol)))

            # -- BB dt proposal + Armijo backtracking -------------------
            dt_row = opt.adaptive_gradient_dt(
                step, _host(phi.x), gradient, dt, h, smax,
                args.motion_cfl)
            trial_dt = dt_row["dt_next"]
            accepted = False
            backtracks = 0
            with opt.phase(row, "line_search"):
                for bt in range(args.max_backtracks + 1):
                    phi_trial = phi.copy()
                    with opt.phase(row, "advect"):
                        advector.advect(phi_trial, extension, trial_dt,
                                        method=args.advect)
                    trial_state = evaluate(phi_trial, row)
                    trial_L = opt.lagrangian_value(
                        trial_state["compliance"],
                        trial_state["volume"] - args.target_volume, alm)
                    if trial_L <= opt.armijo_rhs(L0, rate, trial_dt,
                                                 args.armijo_c1):
                        accepted = True
                        break
                    backtracks += 1
                    trial_dt *= 0.5
                # keep the last trial even if Armijo never fired: a
                # nonsmooth re-cut step can reject every dt
                phi, state = phi_trial, trial_state
            dt = trial_dt
            opt.accept_adaptive_gradient_step(step, _host(phi.x),
                                              gradient, dt)
            opt.update_augmented_lagrangian(
                alm, state["volume"] - args.target_volume)

            # -- reinit + volume correction ----------------------------
            if args.reinit_every and (it + 1) % args.reinit_every == 0:
                with opt.phase(row, "reinit"):
                    phi = distance.reinitialize(phi)
                    state = evaluate(phi, row)
                    shift = opt.reinit_volume_shift(
                        state["volume"], args.target_volume,
                        state["interface"],
                        args.reinit_volume_correction_limit)
                    if shift:
                        phi.x = phi.x + shift
                        state = evaluate(phi, row)

            # -- topology diagnostics / island removal -----------------
            comps = opt.solid_components(mesh, state["inside_cells"],
                                         state["anchored_cells"],
                                         state["loaded_cells"])
            conv["components"] = len(comps)
            conv["floating_removed"] = 0
            if args.remove_floating_every and \
                    (it + 1) % args.remove_floating_every == 0:
                removed = opt.remove_floating_components(
                    phi, mesh, comps, clear_value=2.0 * h)
                if removed.size:
                    conv["floating_removed"] = int(removed.size)
                    state = evaluate(phi, row)

            row["time_total"] = time.perf_counter() - t_total0
            row["backtracks"] = backtracks
            conv.update(
                compliance=state["compliance"], volume=state["volume"],
                lagrangian=opt.lagrangian_value(
                    state["compliance"],
                    state["volume"] - args.target_volume, alm),
                volume_error=state["volume"] - args.target_volume,
                multiplier=multiplier, dt=dt, speed_max=smax,
                armijo_accepted=int(accepted))
            history.append(conv)
            profile_rows.append(row)
            if writers_ctx:
                writers_ctx[0].write(row)
                writers_ctx[1].write(conv)
            if args.checkpoint and \
                    (it + 1) % max(args.checkpoint_every, 1) == 0:
                opt.save_checkpoint(
                    args.checkpoint, iteration=it + 1, phi=phi,
                    lbfgs=lbfgs if args.optimizer == "lbfgs" else None,
                    alm=alm, step=step, dt=dt,
                    scalars={"compliance": state["compliance"],
                             "volume": state["volume"]})
            if not args.quiet:
                print(f"{it:3d} {state['compliance']:12.5e} "
                      f"{state['volume']:8.4f} {conv['lagrangian']:12.5e} "
                      f"{dt:9.2e} {backtracks:2d} "
                      f"{conv['lbfgs_pairs']:5d}")
    finally:
        if writers_ctx:
            writers_ctx[0].__exit__(None, None, None)
            writers_ctx[1].__exit__(None, None, None)

    return {"history": history, "profile": profile_rows, "phi": phi,
            "final_compliance": history[-1]["compliance"],
            "final_volume": history[-1]["volume"]}


def run(argv=(), **overrides):
    """run_optimization with the command line's defaults, ``argv`` parsed
    and then ``overrides`` (e.g. ``n=8, iters=3, device="cpu"``) set."""
    args = parse_args(list(argv))
    for k, v in overrides.items():
        setattr(args, k, v)
    return run_optimization(args)


def main(argv=None):
    args = parse_args(argv)
    result = run_optimization(args)
    h0, hN = result["history"][0], result["history"][-1]
    print(f"compliance {h0['compliance']:.5e} -> {hN['compliance']:.5e}, "
          f"volume {hN['volume']:.4f} (target {args.target_volume})")
    return result


if __name__ == "__main__":
    main()
