"""Poisson on an implicitly defined flower-shaped cut domain.

The port of ``demos/demo_poisson.py``: the physical domain is {phi < 0}
for a polar flower level set on a fixed background mesh; Dirichlet data
are imposed weakly on {phi = 0} with symmetric Nitsche terms and
ghost-penalty stabilization on the cut-cell facet band. Exact solution
u = sin(pi x) sin(pi y).

Run:  python -m cutfemx_tpu_torch.demos.demo_poisson [--n 32] [--degree 1]
          [--solver direct|cg] [--precond jacobi|chebyshev] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

import cutfemx_tpu_torch as cfx
from cutfemx_tpu_torch import fem
from cutfemx_tpu_torch.demos import stage_clock
from cutfemx_tpu_torch.forms.dsl import (CellDiameter, CoefficientExpr,
                                         FacetNormal, SpatialCoordinate,
                                         TestFunction, TrialFunction, avg,
                                         dot, grad, inner, jump, pi, sin)
from cutfemx_tpu_torch.forms.measure import Measure
from cutfemx_tpu_torch.la import direct_solve

BASE_RADIUS, AMPLITUDE, PETALS = 0.46, 0.15, 6
GAMMA, GAMMA_G = 40.0, 0.1
CG_RTOL = 1e-10          # the reference demo's


def flower_level_set(base_radius, amplitude, petals):
    def phi(x):
        theta = np.arctan2(x[1], x[0])
        boundary_radius = base_radius + amplitude * np.cos(petals * theta)
        return np.sqrt(x[0] ** 2 + x[1] ** 2) - boundary_radius
    return phi


def problem(n=32, degree=1, *, device="cuda"):
    """The flower problem on the n x n mesh of [-1, 1]^2 in f64, up to the
    assembled load vector and the active domain. Its ``times`` hold the
    seconds of cut + quadrature and of the forms (the device's queue
    drained at each stage's end)."""
    f64 = torch.float64
    clock = stage_clock(device)
    t0 = clock()
    mesh = cfx.mesh.create_rectangle((-1.0, -1.0), (1.0, 1.0), (n, n))
    V_phi = cfx.functionspace(mesh, ("Lagrange", 1), device=device)
    phi = cfx.Function(V_phi, name="phi", dtype=f64)
    phi.interpolate(flower_level_set(BASE_RADIUS, AMPLITUDE, PETALS))

    cut_data = cfx.cut(phi)
    inside_cells = cfx.locate_entities(cut_data, "phi<0")
    volume_rules = cfx.runtime_quadrature(cut_data, "phi<0", 2 * degree)
    interface_rules = cfx.runtime_quadrature(cut_data, "phi=0", 2 * degree)
    ghost_facets = cfx.ghost_penalty_facets(cut_data, "phi<0")
    t_cut = clock()

    dx_omega = Measure("dx", domain=mesh,
                       subdomain_data=[inside_cells, volume_rules])
    dx_gamma = Measure("dx", domain=mesh, subdomain_data=interface_rules)
    dS_ghost = Measure("dS", domain=mesh, subdomain_data=ghost_facets)

    V = cfx.functionspace(mesh, ("Lagrange", degree), device=device)
    u, v = TrialFunction(V), TestFunction(V)
    x = SpatialCoordinate(mesh)
    n_gamma = cfx.normal(phi)
    n_facet = FacetNormal(mesh)
    h = CellDiameter(mesh)

    u_exact = sin(pi * x[0]) * sin(pi * x[1])
    f = 2.0 * pi ** 2 * u_exact

    a = inner(grad(u), grad(v)) * dx_omega
    a += (-dot(grad(u), n_gamma) * v - dot(grad(v), n_gamma) * u
          + GAMMA / h * u * v) * dx_gamma
    if ghost_facets.size > 0:
        a += (GAMMA_G * avg(h)
              * inner(jump(grad(u), n_facet), jump(grad(v), n_facet))
              ) * dS_ghost
    L = f * v * dx_omega
    L += (-dot(grad(v), n_gamma) * u_exact
          + GAMMA / h * u_exact * v) * dx_gamma

    a_form, L_form = fem.form(a, dtype=f64), fem.form(L, dtype=f64)
    b = fem.assemble_vector(L_form)
    domain = fem.active_domain(a_form)
    t_forms = clock()
    return dict(
        n=n, degree=degree, device=device, V=V, a_form=a_form, b=b,
        domain=domain, u_exact=u_exact, dx_omega=dx_omega,
        counts=dict(dofs=V.dim, active_dofs=V.dim - domain.inactive_dofs.size,
                    inside_cells=int(inside_cells.size),
                    cut_cells=int(interface_rules.parent_map.size),
                    ghost_facets=int(ghost_facets.size)),
        times=dict(cut_quadrature_s=t_cut - t0, forms_s=t_forms - t_cut))


def operator(P):
    """The problem's CutOperator, built once (its seconds in
    ``P["times"]["operator_s"]``)."""
    if "op" not in P:
        clock = stage_clock(P["device"])
        t0 = clock()
        P["op"] = fem.CutOperator(P["a_form"], P["domain"])
        P["times"]["operator_s"] = clock() - t0
    return P["op"]


def solve(P, solver="direct", *, precond="jacobi", maxiter=2000):
    """(uh dofs, solve information). ``"direct"`` assembles the host CSR
    matrix, deactivates and solves with SciPy; ``"cg"`` runs
    ``CutOperator.solve_cg`` on the device (``precond`` 'jacobi',
    'chebyshev' or 'none') and also reports the true relative residual
    from one operator apply."""
    if solver not in ("direct", "cg"):
        raise ValueError(f"solver {solver!r}: 'direct' or 'cg'")
    clock = stage_clock(P["device"])
    if solver == "direct":
        t0 = clock()
        A = fem.assemble_matrix(P["a_form"])
        A, b = fem.deactivate_outside(A, P["b"], P["domain"])
        t_mat = clock()
        x = direct_solve(A, b)
        return x, dict(solver="scipy spsolve", matrix_s=t_mat - t0,
                       solve_s=clock() - t_mat,
                       host_stages=["classify", "assemble_matrix CSR",
                                    "deactivate_outside", "direct_solve"])
    op = operator(P)
    t0 = clock()
    x, its, res = op.solve_cg(P["b"], rtol=CG_RTOL, maxiter=maxiter,
                              precond=precond)
    t_solve = clock()
    bb = torch.where(op.active, P["b"], 0.0)
    r = torch.where(op.active, bb - op(x), 0.0)
    return x, dict(solver=f"matrix-free CG+{precond}", iterations=int(its),
                   residual_norm=float(res), rtol=CG_RTOL, maxiter=maxiter,
                   true_rel_residual=float(torch.linalg.norm(r)
                                           / torch.linalg.norm(bb)),
                   solve_s=t_solve - t0, host_stages=["classify"])


def l2_error(P, uh_x):
    """||uh - u_exact|| over the cut domain, by assemble_scalar."""
    uh = cfx.Function(P["V"], dtype=torch.float64)
    uh.x = uh_x
    err = CoefficientExpr(uh) - P["u_exact"]
    err_sq = float(fem.assemble_scalar(fem.form(err * err * P["dx_omega"],
                                                dtype=torch.float64)))
    return float(np.sqrt(max(err_sq, 0.0)))


def run(n=32, degree=1, solver="direct", *, device="cuda",
        precond="jacobi"):
    """Solve the flower problem (``problem``, ``solve``) and return the L2
    error with the counts, the solve information and the seconds of each
    stage (the device's queue drained at each stage's end)."""
    clock = stage_clock(device)
    t0 = clock()
    P = problem(n, degree, device=device)
    x, info = solve(P, solver, precond=precond)
    t_err = clock()
    err = l2_error(P, x)
    t1 = clock()
    return dict(n=n, degree=degree, l2_error=err, **P["counts"], **info,
                **P["times"], error_s=t1 - t_err, total_s=t1 - t0)


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--n", type=int, default=32)
    p.add_argument("--degree", type=int, default=1)
    p.add_argument("--solver", default="direct", choices=["direct", "cg"])
    p.add_argument("--precond", default="jacobi",
                   choices=["jacobi", "chebyshev", "none"])
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    out = run(args.n, args.degree, args.solver, device=args.device,
              precond=args.precond)
    for key, val in out.items():
        print(f"{key:18s} = {val}")


if __name__ == "__main__":
    main()
