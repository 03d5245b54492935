"""Two-domain Poisson on an unfitted circular interface.

The port of ``demos/demo_interface_poisson.py``: separate background P1
spaces per phase, coupled with kappa-weighted symmetric Nitsche terms on
{phi = 0}; block assembly, block deactivation and one direct solve of the
assembled block system. Exact solution u1 = r^2,
u2 = (kappa_1/kappa_2) r^2 + R^2 (1 - kappa_1/kappa_2).

Run: python -m cutfemx_tpu_torch.demos.demo_interface_poisson [--n 24]
         [--device cpu]
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
                                         TrialFunctions, avg, dot, grad,
                                         inner, jump)
from cutfemx_tpu_torch.forms.measure import Measure
from cutfemx_tpu_torch.la import direct_solve

RADIUS, CENTER = 0.53, (0.05, -0.03)
KAPPA_1, KAPPA_2 = 1.0, 8.0
G_INT, G_BND, G_GHOST = 40.0, 40.0, 0.1
QUADRATURE_DEGREE = 4    # the reference demo's


def run(n=24, *, device="cuda"):
    """Solve on the n x n mesh of [-1, 1]^2 in f64. Returns the L2 errors
    of both phases and of the interface jump, the rows left empty after
    deactivation, and the time of each stage (seconds, the device's queue
    drained at each stage's end)."""
    f64 = torch.float64
    clock = stage_clock(device)
    t0 = clock()
    mesh = cfx.mesh.create_rectangle((-1.0, -1.0), (1.0, 1.0), (n, n))
    Vphi = cfx.functionspace(mesh, ("Lagrange", 1), device=device)
    phi = cfx.Function(Vphi, name="phi", dtype=f64)
    phi.interpolate(lambda x: np.sqrt((x[0] - CENTER[0]) ** 2
                                      + (x[1] - CENTER[1]) ** 2) - RADIUS)

    cd = cfx.cut(phi)
    inside = cfx.locate_entities(cd, "phi<0")
    outside = cfx.locate_entities(cd, "phi>0")
    q = QUADRATURE_DEGREE
    in_rules = cfx.runtime_quadrature(cd, "phi<0", q)
    out_rules = cfx.runtime_quadrature(cd, "phi>0", q)
    gam_rules = cfx.runtime_quadrature(cd, "phi=0", q)
    gp1 = cfx.ghost_penalty_facets(cd, "phi<0")
    gp2 = cfx.ghost_penalty_facets(cd, "phi>0")
    t_cut = clock()

    dx1 = Measure("dx", domain=mesh, subdomain_data=[inside, in_rules])
    dx2 = Measure("dx", domain=mesh, subdomain_data=[outside, out_rules])
    dgam = Measure("dx", domain=mesh, subdomain_data=gam_rules)
    dS1 = Measure("dS", domain=mesh, subdomain_data=gp1)
    dS2 = Measure("dS", domain=mesh, subdomain_data=gp2)
    ds_out = Measure("ds", domain=mesh)

    V1 = cfx.functionspace(mesh, ("Lagrange", 1), device=device)
    V2 = cfx.functionspace(mesh, ("Lagrange", 1), device=device)
    W = MixedFunctionSpace(V1, V2)
    u1, u2 = TrialFunctions(W)
    v1, v2 = TestFunctions(W)

    x = SpatialCoordinate(mesh)
    r2 = (x[0] - CENTER[0]) ** 2 + (x[1] - CENTER[1]) ** 2
    ratio = KAPPA_1 / KAPPA_2
    u1_ex = r2
    u2_ex = ratio * r2 + RADIUS ** 2 * (1.0 - ratio)
    f1 = -4.0 * KAPPA_1
    f2 = -4.0 * KAPPA_1

    ng = cfx.normal(phi)
    nf = FacetNormal(mesh)
    h = CellDiameter(mesh)
    kh = 2 * KAPPA_1 * KAPPA_2 / (KAPPA_1 + KAPPA_2)
    eta_i, eta_b = G_INT * kh / h, G_BND * KAPPA_2 / h
    w1 = KAPPA_2 / (KAPPA_1 + KAPPA_2)
    w2 = KAPPA_1 / (KAPPA_1 + KAPPA_2)

    ju, jv = u1 - u2, v1 - v2
    flux_u = w1 * KAPPA_1 * dot(grad(u1), ng) \
        + w2 * KAPPA_2 * dot(grad(u2), ng)
    flux_v = w1 * KAPPA_1 * dot(grad(v1), ng) \
        + w2 * KAPPA_2 * dot(grad(v2), ng)

    a = KAPPA_1 * inner(grad(u1), grad(v1)) * dx1
    a += KAPPA_2 * inner(grad(u2), grad(v2)) * dx2
    a += (-flux_u * jv - flux_v * ju + eta_i * ju * jv) * dgam
    if gp1.size:
        a += G_GHOST * KAPPA_1 * avg(h) * inner(
            jump(grad(u1), nf), jump(grad(v1), nf)) * dS1
    if gp2.size:
        a += G_GHOST * KAPPA_2 * avg(h) * inner(
            jump(grad(u2), nf), jump(grad(v2), nf)) * dS2
    a += (-KAPPA_2 * dot(grad(u2), nf) * v2
          - KAPPA_2 * dot(grad(v2), nf) * u2 + eta_b * u2 * v2) * ds_out
    L = f1 * v1 * dx1 + f2 * v2 * dx2
    L += (-KAPPA_2 * dot(grad(v2), nf) * u2_ex
          + eta_b * u2_ex * v2) * ds_out

    a_blocks = fem.extract_blocks(a, dtype=f64)
    L_blocks = fem.extract_blocks(L, dtype=f64)
    b = [fem.assemble_vector(blk) if blk is not None
         else torch.zeros(sp.dim, dtype=f64, device=device)
         for blk, sp in zip(L_blocks, (V1, V2))]
    dom1 = fem.active_domain(a_blocks[0][0])
    dom2 = fem.active_domain(a_blocks[1][1])
    t_forms = clock()

    A = [[fem.assemble_matrix(blk) if blk is not None else None
          for blk in row] for row in a_blocks]
    fem.deactivate_outside_blocks(A, [dom1, dom2], b)
    zrows = fem.zero_block_rows(A)
    if any(r.size > 0 for r in zrows):
        raise RuntimeError("Zero matrix rows remain after deactivation")
    from scipy.sparse import bmat, csr_matrix
    dims = (V1.dim, V2.dim)
    Ah = bmat([[blk.to_scipy().tocsr() if blk is not None else
                csr_matrix((dims[i], dims[j]))
                for j, blk in enumerate(row)]
               for i, row in enumerate(A)], format="csr")
    t_mat = clock()
    sol = direct_solve(Ah, torch.cat(b))
    t_solve = clock()

    u1h = cfx.Function(V1, name="u1_h", dtype=f64)
    u1h.x = sol[:V1.dim]
    u2h = cfx.Function(V2, name="u2_h", dtype=f64)
    u2h.x = sol[V1.dim:]

    e1 = CoefficientExpr(u1h) - u1_ex
    e2 = CoefficientExpr(u2h) - u2_ex
    je = CoefficientExpr(u1h) - CoefficientExpr(u2h)

    def l2(expr, measure):
        val = float(fem.assemble_scalar(fem.form(expr * expr * measure,
                                                 dtype=f64)))
        return float(np.sqrt(max(val, 0.0)))

    err1, err2, jerr = l2(e1, dx1), l2(e2, dx2), l2(je, dgam)
    t_err = clock()
    return dict(
        n=n, err1=err1, err2=err2, jump=jerr,
        zero_rows=[int(r.size) for r in zrows],
        dofs=V1.dim + V2.dim, inside_cells=int(inside.size),
        outside_cells=int(outside.size),
        cut_cells=int(gam_rules.parent_map.size),
        ghost_facets=[int(gp1.size), int(gp2.size)],
        inactive_dofs=[int(dom1.inactive_dofs.size),
                       int(dom2.inactive_dofs.size)],
        solver="scipy spsolve",
        host_stages=["classify", "assemble_matrix CSR",
                     "deactivate_outside_blocks", "bmat", "direct_solve"],
        cut_quadrature_s=t_cut - t0, forms_s=t_forms - t_cut,
        matrix_s=t_mat - t_forms, solve_s=t_solve - t_mat,
        error_s=t_err - t_solve, total_s=t_err - t0)


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--n", type=int, default=24)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    for key, val in run(args.n, device=args.device).items():
        print(f"{key:18s} = {val}")


if __name__ == "__main__":
    main()
