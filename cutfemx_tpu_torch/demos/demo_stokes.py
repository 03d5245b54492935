"""Cut Stokes: equal-order P1-P1 on an unfitted domain.

The port of ``demos/demo_stokes.py`` and of the manufactured problem of
``tests/test_stokes.py``. Both use CIP pressure stabilisation on the
interior facets of the active cells, ghost penalty on the cut band and
symmetric Nitsche velocity conditions (traction coupling) on {phi = 0}:

- ``run``: flow around an implicit cylinder in the channel [-3, 5] x
  [-1, 1] on a (4n, n) mesh, a parabolic inflow and no-slip walls as
  strong conditions (``dirichletbc`` + ``apply_lifting`` + ``set_bc``),
  do-nothing outflow;
- ``run_manufactured``: a divergence-free manufactured solution inside the
  circle r = 0.71 in [-1, 1]^2, one pressure dof pinned, solved through
  ``extract_blocks`` or the monolithic ``MixedCutForm``.

The forms are assembled on the device; the CSR matrices, the boundary
conditions, the deactivation and the direct solve run on the host (SciPy),
by the reference's design.

Run: python -m cutfemx_tpu_torch.demos.demo_stokes [--n 24]
         [--manufactured] [--monolithic] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

import cutfemx_tpu_torch as cfx
from cutfemx_tpu_torch import fem
from cutfemx_tpu_torch.demos import stage_clock
from cutfemx_tpu_torch.forms.dsl import (CellDiameter, CoefficientExpr,
                                         FacetNormal, MixedFunctionSpace,
                                         SpatialCoordinate, TestFunctions,
                                         TrialFunctions, as_vector, avg,
                                         cos, div, dot, grad, inner, jump,
                                         pi, sin)
from cutfemx_tpu_torch.forms.measure import Measure
from cutfemx_tpu_torch.la import direct_solve

NU = 1.0
GAMMA_U, GAMMA_P, GAMMA_G = 100.0, 0.1, 0.1
# the cylinder demo's
CENTER, RADIUS, QUADRATURE_DEGREE = (-1.2, 0.0), 0.3, 4
CHANNEL = ((-3.0, -1.0), (5.0, 1.0))
# tests/test_stokes.py's manufactured problem
MMS_RADIUS, MMS_QUADRATURE_DEGREE = 0.71, 3

F64 = torch.float64


def traction(u, p, nu, n):
    return nu * dot(grad(u), n) - p * n


def stokes_forms(mesh, phi, fluid, degree, device):
    """Cut, quadrature and the Stokes bilinear form on {phi <fluid> 0}
    (``fluid`` is "<" or ">"), with the measures, spaces and test
    functions a right-hand side needs."""
    side = f"phi{fluid}0"
    cd = cfx.cut(phi)
    fluid_cells = cfx.locate_entities(cd, side)
    cut_cells = cfx.locate_entities(cd, "phi=0")
    rules = cfx.runtime_quadrature(cd, side, degree)
    irules = cfx.runtime_quadrature(cd, "phi=0", degree)
    gp = cfx.ghost_penalty_facets(cd, side)
    p_facets = cfx.interior_facets_for_cells(
        mesh, np.union1d(fluid_cells, cut_cells))

    dxo = Measure("dx", domain=mesh, subdomain_data=[fluid_cells, rules])
    dxg = Measure("dx", domain=mesh, subdomain_data=irules)
    dSg = Measure("dS", domain=mesh, subdomain_data=gp)
    dSp = Measure("dS", domain=mesh, subdomain_data=p_facets)

    V = cfx.functionspace(mesh, ("Lagrange", 1), shape=(2,), device=device)
    Q = cfx.functionspace(mesh, ("Lagrange", 1), device=device)
    W = MixedFunctionSpace(V, Q)
    u, p = TrialFunctions(W)
    v, q = TestFunctions(W)
    # outward normal of the fluid: normal(phi) points to phi > 0
    ng = cfx.normal(phi) if fluid == "<" else -1.0 * cfx.normal(phi)
    nf = FacetNormal(mesh)
    h = CellDiameter(mesh)

    a = NU * inner(grad(u), grad(v)) * dxo
    a += -p * div(v) * dxo
    a += div(u) * q * dxo
    a += -inner(traction(u, p, NU, ng), v) * dxg
    a += -inner(traction(v, q, NU, ng), u) * dxg
    a += GAMMA_U * NU / h * inner(u, v) * dxg
    if gp.size:
        a += GAMMA_G * avg(h) * inner(jump(grad(u), nf),
                                      jump(grad(v), nf)) * dSg
    a += GAMMA_P * avg(h) ** 3 * inner(jump(grad(p), nf),
                                       jump(grad(q), nf)) * dSp
    return dict(a=a, V=V, Q=Q, v=v, q=q, ng=ng, nf=nf, h=h, dxo=dxo,
                dxg=dxg, counts=dict(
                    dofs=V.dim + Q.dim, fluid_cells=int(fluid_cells.size),
                    cut_cells=int(cut_cells.size), ghost_facets=int(gp.size)))


def _level_set(mesh, center, radius, device):
    phi = cfx.Function(cfx.functionspace(mesh, ("Lagrange", 1),
                                         device=device), name="phi",
                       dtype=F64)
    phi.interpolate(lambda x: np.sqrt((x[0] - center[0]) ** 2
                                      + (x[1] - center[1]) ** 2) - radius)
    return phi


def _split(sol, V, Q):
    uh = cfx.Function(V, name="u", dtype=F64)
    uh.x = sol[:V.dim]
    ph = cfx.Function(Q, name="p", dtype=F64)
    ph.x = sol[V.dim:]
    return uh, ph


def _counts(P, inactive):
    return dict(**P["counts"], active_dofs=P["counts"]["dofs"]
                - int(inactive))


# -- the manufactured problem (tests/test_stokes.py) --------------------------


def problem(n=16, *, device="cuda", monolithic=False):
    """The manufactured problem on the n x n mesh of [-1, 1]^2 in f64, up
    to its forms (per block, or one MixedCutForm when ``monolithic``), the
    load vector and the active domains. ``times`` holds the seconds of cut
    + quadrature and of the forms (the device's queue drained at each
    stage's end)."""
    clock = stage_clock(device)
    t0 = clock()
    mesh = cfx.mesh.create_rectangle((-1.0, -1.0), (1.0, 1.0), (n, n))
    phi = _level_set(mesh, (0.0, 0.0), MMS_RADIUS, device)
    P = stokes_forms(mesh, phi, "<", MMS_QUADRATURE_DEGREE, device)
    t_cut = clock()

    x = SpatialCoordinate(mesh)
    # divergence-free velocity from psi = sin(pi x) sin(pi y)
    u_ex = as_vector([pi * sin(pi * x[0]) * cos(pi * x[1]),
                      -pi * cos(pi * x[0]) * sin(pi * x[1])])
    p_ex = cos(pi * x[0]) * sin(pi * x[1])
    # f = -nu lap(u) + grad(p), lap(u) = -2 pi^2 u
    f = as_vector([
        2 * NU * pi ** 2 * pi * sin(pi * x[0]) * cos(pi * x[1])
        - pi * sin(pi * x[0]) * sin(pi * x[1]),
        -2 * NU * pi ** 2 * pi * cos(pi * x[0]) * sin(pi * x[1])
        + pi * cos(pi * x[0]) * cos(pi * x[1]),
    ])
    v, q, ng, h, dxo, dxg = (P[k] for k in ("v", "q", "ng", "h", "dxo",
                                             "dxg"))
    L = inner(f, v) * dxo
    L += -inner(traction(v, q, NU, ng), u_ex) * dxg
    L += GAMMA_U * NU / h * inner(u_ex, v) * dxg

    V, Q = P["V"], P["Q"]
    if monolithic:
        a_form = fem.form(P["a"], dtype=F64)
        L_form = fem.form(L, dtype=F64)
        b = fem.assemble_vector(L_form)
        domain = fem.active_domain(a_form)
    else:
        a_form = fem.extract_blocks(P["a"], dtype=F64)
        L_form = fem.extract_blocks(L, dtype=F64)
        b = fem.assemble_vector_block(L_form, (V, Q))
        domain = fem.MixedActiveDomain(
            [fem.active_domain(a_form[0][0]),
             fem.active_domain(a_form[1][1])], fem.block_offsets((V, Q)))
    t_forms = clock()
    P.update(n=n, device=device, monolithic=monolithic, a_form=a_form,
             b=b, domain=domain, u_ex=u_ex, p_ex=p_ex,
             times=dict(cut_quadrature_s=t_cut - t0,
                        forms_s=t_forms - t_cut))
    return P


def matrices(P):
    """The host CSR matrix of the problem: one MatrixCSR for the
    monolithic form, else the 2 x 2 block matrices. Its seconds (element
    matrices on the device, COO -> CSR on the host) in ``P["times"]``."""
    clock = stage_clock(P["device"])
    t0 = clock()
    if P["monolithic"]:
        A = fem.assemble_matrix(P["a_form"])
    else:
        A = [[fem.assemble_matrix(blk) if blk is not None else None
              for blk in row] for row in P["a_form"]]
    P["times"]["matrix_s"] = clock() - t0
    return A


def solve(P, A):
    """Deactivation, one pinned pressure dof, the direct solve and the L2
    errors of velocity and pressure over the fluid."""
    clock = stage_clock(P["device"])
    V, Q = P["V"], P["Q"]
    t0 = clock()
    domain = P["domain"]
    if P["monolithic"]:
        A, b = fem.deactivate_outside(A, P["b"], domain)
    else:
        b_blocks = [P["b"][:V.dim], P["b"][V.dim:]]
        fem.deactivate_outside_blocks(A, domain.domains, b_blocks)
        A = fem.assemble_matrix_block(A, (V, Q))
        b = torch.cat(b_blocks)
    # the pressure is defined up to a constant: pin one active dof to p_ex
    pdof = int(domain.sub(1).active_mask.nonzero()[0][0])
    row = V.dim + pdof
    fem.zero_rows(A, np.array([row]))
    cx, cy = Q.dof_coordinates[pdof]
    b[row] = np.cos(np.pi * cx) * np.sin(np.pi * cy)
    t_bc = clock()
    sol = direct_solve(A, b)
    t_solve = clock()
    uh, ph = _split(sol, V, Q)
    eu = CoefficientExpr(uh) - P["u_ex"]
    ep = CoefficientExpr(ph) - P["p_ex"]

    def l2(expr):
        val = float(fem.assemble_scalar(fem.form(expr * P["dxo"],
                                                 dtype=F64)))
        return float(np.sqrt(max(val, 0.0)))

    err_u, err_p = l2(inner(eu, eu)), l2(ep * ep)
    t_err = clock()
    return dict(err_u=err_u, err_p=err_p, pinned_dof=row,
                bcs_s=t_bc - t0, solve_s=t_solve - t_bc,
                error_s=t_err - t_solve)


def run_manufactured(n=16, *, device="cuda", monolithic=False):
    """Solve the manufactured problem (``problem``, ``matrices``,
    ``solve``). Returns the velocity and pressure L2 errors, the counts and
    the seconds of each stage (the device's queue drained at each stage's
    end)."""
    clock = stage_clock(device)
    t0 = clock()
    P = problem(n, device=device, monolithic=monolithic)
    out = solve(P, matrices(P))
    total = clock() - t0
    return dict(n=n, **out, **_counts(P, P["domain"].inactive_dofs.size),
                path="MixedCutForm" if monolithic else "extract_blocks",
                solver="scipy spsolve", **P["times"], total_s=total,
                host_stages=["classify", "assemble_matrix CSR",
                             "deactivate_outside", "pin", "direct_solve"])


# -- the cylinder (demos/demo_stokes.py) --------------------------------------


def run(n=24, *, device="cuda"):
    """Flow around the cylinder on the (4n, n) channel mesh in f64. Returns
    the flux in and out, the mass defect, |u| on the cylinder (the no-slip
    quality), max |u|, the counts and the seconds of each stage."""
    clock = stage_clock(device)
    t0 = clock()
    mesh = cfx.mesh.create_rectangle(*CHANNEL, (4 * n, n))
    phi = _level_set(mesh, CENTER, RADIUS, device)
    P = stokes_forms(mesh, phi, ">", QUADRATURE_DEGREE, device)
    V, Q = P["V"], P["Q"]
    t_cut = clock()

    L = inner(as_vector([0.0, 0.0]), P["v"]) * P["dxo"]
    a_blocks = fem.extract_blocks(P["a"], dtype=F64)
    L_blocks = fem.extract_blocks(L, dtype=F64)
    b = [fem.assemble_vector(L_blocks[0]),
         torch.zeros(Q.dim, dtype=F64, device=device)]
    domains = [fem.active_domain(a_blocks[0][0]),
               fem.active_domain(a_blocks[1][1])]

    # strong conditions: parabolic inflow on the left, no-slip walls; the
    # outflow is do-nothing (it fixes the pressure level: no pinning)
    ext = mesh.exterior_facets
    mid = mesh.midpoints(mesh.tdim - 1, ext)
    left = ext[np.abs(mid[:, 0] - CHANNEL[0][0]) < 1e-12]
    right = ext[np.abs(mid[:, 0] - CHANNEL[1][0]) < 1e-12]
    walls = ext[np.abs(np.abs(mid[:, 1]) - 1.0) < 1e-12]
    inflow = cfx.Function(V, dtype=F64)
    inflow.interpolate(lambda x: np.stack((1.0 - x[1] ** 2,
                                           np.zeros_like(x[0]))))
    bcs = [fem.dirichletbc(inflow, fem.locate_dofs_topological(
               V, mesh.tdim - 1, left), V),
           fem.dirichletbc(0.0, fem.locate_dofs_topological(
               V, mesh.tdim - 1, walls), V)]
    t_forms = clock()

    A = [[fem.assemble_matrix(blk, bcs=bcs) if blk is not None else None
          for blk in row] for row in a_blocks]
    t_mat = clock()
    fem.deactivate_outside_blocks(A, domains, b)
    b[0] = fem.set_bc(fem.apply_lifting(b[0], [a_blocks[0][0]], [bcs]),
                      bcs)
    b[1] = fem.apply_lifting(b[1], [a_blocks[1][0]], [bcs])
    A = fem.assemble_matrix_block(A, (V, Q))
    t_bc = clock()
    sol = direct_solve(A, torch.cat(b))
    t_solve = clock()

    uh, _ = _split(sol, V, Q)
    ue, nf = CoefficientExpr(uh), P["nf"]

    def integral(expr):
        return float(fem.assemble_scalar(fem.form(expr, dtype=F64)))

    flux_in = integral(dot(ue, nf) * Measure("ds", domain=mesh,
                                             subdomain_data=left))
    flux_out = integral(dot(ue, nf) * Measure("ds", domain=mesh,
                                              subdomain_data=right))
    rate = integral(inner(ue, ue) * P["dxg"])
    max_u = float(torch.linalg.norm(uh.x.reshape(-1, 2), dim=1).max())
    t_err = clock()
    inactive = sum(d.inactive_dofs.size for d in domains)
    return dict(n=n, flux_in=-flux_in, flux_out=flux_out,
                mass_defect=abs(flux_in + flux_out),
                u_gamma=float(np.sqrt(max(rate, 0.0))), max_u=max_u,
                **_counts(P, inactive),
                bc_dofs=int(np.unique(np.concatenate(
                    [bc.dofs for bc in bcs])).size),
                solver="scipy spsolve", cut_quadrature_s=t_cut - t0,
                forms_s=t_forms - t_cut, matrix_s=t_mat - t_forms,
                bcs_s=t_bc - t_mat, solve_s=t_solve - t_bc,
                error_s=t_err - t_solve, total_s=t_err - t0,
                host_stages=["classify", "assemble_matrix CSR + bcs",
                             "deactivate_outside_blocks", "apply_lifting",
                             "bmat", "direct_solve"])


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--n", type=int, default=24)
    p.add_argument("--manufactured", action="store_true",
                   help="the manufactured problem of tests/test_stokes.py")
    p.add_argument("--monolithic", action="store_true",
                   help="(manufactured) solve through one MixedCutForm")
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    if args.manufactured:
        out = run_manufactured(args.n, device=args.device,
                               monolithic=args.monolithic)
    else:
        out = run(args.n, device=args.device)
    for key, val in out.items():
        print(f"{key:18s} = {val}")


if __name__ == "__main__":
    main()
