"""Extension-penalty conditioning study: the cut Poisson problem with the
ghost penalty replaced by the aggregation-based extension penalty,
sweeping beta, reporting L2 errors and condition numbers.

The port of ``demos/demo_poisson_extension_penalty_study.py``: the disk of
radius 0.46 in [-1, 1]^2, Nitsche's method with gamma = 40, the exact
solution u = sin(pi x) sin(pi y); ill-posed cells (phase volume fraction
below 0.5) aggregated to roots, the penalty added for each beta > 0,
deactivation and a direct solve.

Run: python -m cutfemx_tpu_torch.demos.demo_poisson_extension_penalty_study
         [--n 24] [--betas 0 0.1 1 10] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

import cutfemx_tpu_torch as cfx
from cutfemx_tpu_torch import extensions, fem
from cutfemx_tpu_torch.demos import stage_clock
from cutfemx_tpu_torch.forms.dsl import (CellDiameter, CoefficientExpr,
                                         SpatialCoordinate, TestFunction,
                                         TrialFunction, dot, grad, inner, pi,
                                         sin)
from cutfemx_tpu_torch.forms.measure import Measure
from cutfemx_tpu_torch.la import MatrixCSR, direct_solve

BETAS = (0.0, 0.1, 1.0, 10.0)


def run(n=24, betas=BETAS, *, cond=True, r=0.46, gamma=40.0,
        device="cuda"):
    """Assemble once, then for each beta add the penalty (beta > 0),
    deactivate and solve directly in f64. Returns the aggregation's
    counts, each beta's L2 error, the solve's true relative residual and
    (``cond``) the 2-norm condition number of the dense active block,
    and the seconds of each stage (cut, rules, aggregation, forms, matrix,
    penalty, deactivation, solve; the last three summed over betas)."""
    f64 = torch.float64
    clock = stage_clock(device)
    t = {}
    t0 = clock()
    mesh = cfx.mesh.create_rectangle((-1.0, -1.0), (1.0, 1.0), (n, n))
    Vphi = cfx.functionspace(mesh, ("Lagrange", 1), device=device)
    phi = cfx.Function(Vphi, name="phi", dtype=f64)
    phi.interpolate(lambda x: np.sqrt(x[0] ** 2 + x[1] ** 2) - r)
    cd = cfx.cut(phi)
    inside = cfx.locate_entities(cd, "phi<0")
    t1 = clock()
    t["cut"] = t1 - t0
    vol = cfx.runtime_quadrature(cd, "phi<0", 2)
    srf = cfx.runtime_quadrature(cd, "phi=0", 2)
    t2 = clock()
    t["rules"] = t2 - t1
    agg = extensions.create_cell_aggregation(cd, "phi<0", 0.5)
    t3 = clock()
    t["aggregation"] = t3 - t2

    dxo = Measure("dx", domain=mesh, subdomain_data=[inside, vol])
    dxg = Measure("dx", domain=mesh, subdomain_data=srf)
    V = cfx.functionspace(mesh, ("Lagrange", 1), device=device)
    u, v = TrialFunction(V), TestFunction(V)
    x = SpatialCoordinate(mesh)
    ng = cfx.normal(phi)
    h = CellDiameter(mesh)
    ue = sin(pi * x[0]) * sin(pi * x[1])
    f = 2 * pi ** 2 * ue
    a = inner(grad(u), grad(v)) * dxo
    a += (-dot(grad(u), ng) * v - dot(grad(v), ng) * u
          + gamma / h * u * v) * dxg
    L = f * v * dxo + (-dot(grad(v), ng) * ue + gamma / h * ue * v) * dxg
    af, Lf = fem.form(a, dtype=f64), fem.form(L, dtype=f64)
    dom = fem.active_domain(af)
    b0 = fem.assemble_vector(Lf)
    t4 = clock()
    t["forms"] = t4 - t3
    A0 = fem.assemble_matrix(af)
    t["matrix"] = clock() - t4

    t.update(penalty=0.0, deactivation=0.0, solve=0.0)
    errors, conds, residuals = [], [], []
    act = dom.active_mask
    for beta in betas:
        t0 = clock()
        A = MatrixCSR(A0.to_scipy().copy())
        if beta > 0:
            extensions.assemble_extension_penalty(A, V, cd, agg, beta=beta)
        t1 = clock()
        A, b = fem.deactivate_outside(A, b0.clone(), dom)
        t2 = clock()
        uh = cfx.Function(V, dtype=f64)
        uh.x = direct_solve(A, b)
        t3 = clock()
        t["penalty"] += t1 - t0
        t["deactivation"] += t2 - t1
        t["solve"] += t3 - t2
        bh, xh = b.cpu().numpy(), uh.x.cpu().numpy()
        residuals.append(float(np.linalg.norm(A.matvec(xh) - bh)
                               / np.linalg.norm(bh)))
        e = CoefficientExpr(uh) - ue
        err = float(fem.assemble_scalar(fem.form(e * e * dxo, dtype=f64)))
        errors.append(float(np.sqrt(max(err, 0.0))))
        if cond:
            conds.append(float(np.linalg.cond(
                A.to_dense()[np.ix_(act, act)])))
    return dict(n=n, dofs=V.dim, ill_posed=int(agg.ill_posed_cells.size),
                roots=int(agg.well_posed_cells.size),
                max_depth=int(agg.propagation_depth.max()),
                betas=list(betas), l2_errors=errors,
                conds=conds if cond else None, residuals=residuals,
                seconds=t)


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--n", type=int, default=24)
    p.add_argument("--betas", type=float, nargs="*", default=list(BETAS))
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    out = run(args.n, args.betas, device=args.device)
    print(f"Extension-penalty study, n={args.n}; ill-posed cells = "
          f"{out['ill_posed']}, roots = {out['roots']}")
    print(f"{'beta':>8s} {'L2 error':>12s} {'cond(act)':>12s}")
    for beta, err, c in zip(args.betas, out["l2_errors"], out["conds"]):
        print(f"{beta:8.2f} {err:12.4e} {c:12.4e}")


if __name__ == "__main__":
    main()
