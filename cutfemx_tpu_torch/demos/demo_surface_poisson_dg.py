"""Surface Poisson DG on an implicit circle: -Delta_Gamma u + u = f
solved with SIPG on the cut surface, conormal jumps on the codim-2
skeleton, and normal-gradient ghost stabilization.

The port of ``demos/demo_surface_poisson_dg.py``: the circle of radius
0.62 in [-1, 1]^2 (a P1 level set), a DG1 space, the exact solution
u = x / r; the skeleton is the interior facets between cut cells, its
rules the facet-hosted 'phi=0' crossings (a runtime dS measure).

Run: python -m cutfemx_tpu_torch.demos.demo_surface_poisson_dg [--n 32]
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
                                         FacetNormal, Identity,
                                         SpatialCoordinate, TestFunction,
                                         TrialFunction, avg, dot, grad,
                                         inner, jump, outer)
from cutfemx_tpu_torch.forms.measure import Measure
from cutfemx_tpu_torch.la import direct_solve


def run(n=32, r=0.62, penalty=20.0, ghost=0.1, *, device="cuda"):
    """Assemble, deactivate and solve directly in f64 on the n x n mesh;
    the cut-cell and skeleton-facet counts, the L2(Gamma) error, the
    solve's true relative residual and the seconds of each stage (cut,
    rules, forms, matrix, deactivation, solve)."""
    f64 = torch.float64
    clock = stage_clock(device)
    t = {}
    t0 = clock()
    mesh = cfx.mesh.create_rectangle((-1.0, -1.0), (1.0, 1.0), (n, n))
    Vphi = cfx.functionspace(mesh, ("Lagrange", 1), device=device)
    phi = cfx.Function(Vphi, name="phi", dtype=f64)
    phi.interpolate(lambda x: (x[0] ** 2 + x[1] ** 2) - r ** 2)
    cd = cfx.cut(phi)
    cut_cells = cfx.locate_entities(cd, "phi=0")
    skel = cfx.interior_facets_for_cells(mesh, cut_cells)
    fcd = cfx.cut(phi, skel, mesh.tdim - 1)
    ghost_facets = cfx.locate_entities(fcd, "phi=0")
    t1 = clock()
    t["cut"] = t1 - t0
    gamma_rules = cfx.runtime_quadrature(cd, "phi=0", 4)
    skel_rules = cfx.runtime_quadrature(fcd, "phi=0", 4)
    t2 = clock()
    t["rules"] = t2 - t1

    dxg = Measure("dx", domain=mesh, subdomain_data=gamma_rules)
    dSg = Measure("dS", domain=mesh, subdomain_data=skel_rules)
    dSh = Measure("dS", domain=mesh, subdomain_data=ghost_facets)
    V = cfx.functionspace(mesh, ("DG", 1), device=device)
    u, v = TrialFunction(V), TestFunction(V)
    x = SpatialCoordinate(mesh)
    ng = cfx.normal(phi)
    mu = cfx.conormal(ng)
    nf = FacetNormal(mesh)
    h = CellDiameter(mesh)

    P = Identity(2) - outer(ng, ng)
    gu, gv = dot(P, grad(u)), dot(P, grad(v))
    ngp, ngm = ng("+"), ng("-")
    Pp = Identity(2) - outer(ngp, ngp)
    Pm = Identity(2) - outer(ngm, ngm)
    avg_gu = 0.5 * (dot(Pp, grad(u)("+")) + dot(Pm, grad(u)("-")))
    avg_gv = 0.5 * (dot(Pp, grad(v)("+")) + dot(Pm, grad(v)("-")))
    ju, jv = jump(u, mu), jump(v, mu)
    u_ex = x[0] / r
    f = (1.0 + 1.0 / r ** 2) * u_ex

    a = (inner(gu, gv) + u * v) * dxg
    a += (-inner(avg_gu, jv) - inner(avg_gv, ju)
          + penalty / avg(h) * inner(ju, jv)) * dSg
    a += ghost * inner(jump(grad(u), nf), jump(grad(v), nf)) * dSh
    L = f * v * dxg
    af, Lf = fem.form(a, dtype=f64), fem.form(L, dtype=f64)
    b = fem.assemble_vector(Lf)
    dom = fem.active_domain(af)
    t3 = clock()
    t["forms"] = t3 - t2
    A = fem.assemble_matrix(af)
    t4 = clock()
    t["matrix"] = t4 - t3
    A, b = fem.deactivate_outside(A, b, dom)
    t5 = clock()
    t["deactivation"] = t5 - t4
    uh = cfx.Function(V, dtype=f64)
    uh.x = direct_solve(A, b)
    t["solve"] = clock() - t5
    bh, xh = b.cpu().numpy(), uh.x.cpu().numpy()
    residual = float(np.linalg.norm(A.matvec(xh) - bh) / np.linalg.norm(bh))
    e = CoefficientExpr(uh) - u_ex
    err = float(fem.assemble_scalar(fem.form(e * e * dxg, dtype=f64)))
    return dict(n=n, dofs=V.dim, cut_cells=int(cut_cells.size),
                skeleton_facets=int(skel.size),
                l2_error=float(np.sqrt(max(err, 0.0))), residual=residual,
                seconds=t)


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--n", type=int, default=32)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    out = run(args.n, device=args.device)
    print(f"Surface Poisson DG on the circle, n={args.n}, r=0.62")
    print(f"cut cells        = {out['cut_cells']}")
    print(f"skeleton facets  = {out['skeleton_facets']}")
    print(f"L2(Gamma) error  = {out['l2_error']:.6e}")


if __name__ == "__main__":
    main()
