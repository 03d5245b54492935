"""Linear elasticity on a cut disk: a vector Lagrange space, the
displacement imposed on the embedded boundary by Nitsche's method, and
ghost-penalty stabilization.

The port of ``demos/demo_elasticity.py``: mu = 1, lambda = 1.25 on the
disk of radius 0.46 in [-1, 1]^2, the manufactured displacement
u = (sin(pi x) sin(pi y), x y (1 - x y)) entering weakly through
L(v) = (sigma(u_ex), eps(v)) - <sigma(u_ex) n, v>_Gamma; deactivation and
a direct solve.

Run: python -m cutfemx_tpu_torch.demos.demo_elasticity [--n 32]
         [--degree 1] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

import cutfemx_tpu_torch as cfx
from cutfemx_tpu_torch import fem
from cutfemx_tpu_torch.forms.dsl import (CellDiameter, CoefficientExpr,
                                         FacetNormal, Identity,
                                         SpatialCoordinate, TestFunction,
                                         TrialFunction, as_vector, avg, dot,
                                         grad, inner, jump, pi, sin, sym,
                                         tr)
from cutfemx_tpu_torch.forms.measure import Measure
from cutfemx_tpu_torch.la import direct_solve


def run(n=32, degree=1, r=0.46, gamma=60.0, gamma_g=0.1, mu=1.0,
        lam=1.25, *, device="cuda"):
    """Assemble, deactivate and solve directly in f64 on the n x n mesh;
    the active cell and dof counts and the L2 error."""
    f64 = torch.float64
    mesh = cfx.mesh.create_rectangle((-1.0, -1.0), (1.0, 1.0), (n, n))
    Vphi = cfx.functionspace(mesh, ("Lagrange", 1), device=device)
    phi = cfx.Function(Vphi, name="phi", dtype=f64)
    phi.interpolate(lambda x: np.sqrt(x[0] ** 2 + x[1] ** 2) - r)

    cd = cfx.cut(phi)
    inside = cfx.locate_entities(cd, "phi<0")
    vol = cfx.runtime_quadrature(cd, "phi<0", 2 * degree)
    srf = cfx.runtime_quadrature(cd, "phi=0", 2 * degree)
    gp = cfx.ghost_penalty_facets(cd, "phi<0")

    dxo = Measure("dx", domain=mesh, subdomain_data=[inside, vol])
    dxg = Measure("dx", domain=mesh, subdomain_data=srf)
    dSg = Measure("dS", domain=mesh, subdomain_data=gp)

    V = cfx.functionspace(mesh, ("Lagrange", degree), shape=(2,),
                          device=device)
    u, v = TrialFunction(V), TestFunction(V)
    x = SpatialCoordinate(mesh)
    ng = cfx.normal(phi)
    nf = FacetNormal(mesh)
    h = CellDiameter(mesh)

    def sigma(w):
        e = sym(grad(w))
        return 2 * mu * e + lam * tr(e) * Identity(2)

    u_ex = as_vector([sin(pi * x[0]) * sin(pi * x[1]),
                      x[0] * x[1] * (1 - x[0] * x[1])])
    a = inner(sigma(u), sym(grad(v))) * dxo
    a += (-inner(dot(sigma(u), ng), v) - inner(dot(sigma(v), ng), u)
          + gamma / h * inner(u, v)) * dxg
    if gp.size:
        a += gamma_g * avg(h) * inner(jump(grad(u), nf),
                                      jump(grad(v), nf)) * dSg
    L = inner(sigma(u_ex), sym(grad(v))) * dxo
    L += -inner(dot(sigma(u_ex), ng), v) * dxg  # cancels interface flux
    L += (-inner(dot(sigma(v), ng), u_ex)
          + gamma / h * inner(u_ex, v)) * dxg

    af, Lf = fem.form(a, dtype=f64), fem.form(L, dtype=f64)
    A = fem.assemble_matrix(af)
    b = fem.assemble_vector(Lf)
    dom = fem.active_domain(af)
    A, b = fem.deactivate_outside(A, b, dom)
    uh = cfx.Function(V, dtype=f64)
    uh.x = direct_solve(A, b)

    e = CoefficientExpr(uh) - u_ex
    err = float(fem.assemble_scalar(fem.form(inner(e, e) * dxo, dtype=f64)))
    return dict(n=n, degree=degree, dofs=V.dim,
                active_cells=int(dom.active_cells.size),
                l2_error=float(np.sqrt(max(err, 0.0))))


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--n", type=int, default=32)
    p.add_argument("--degree", type=int, default=1)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    out = run(args.n, args.degree, device=args.device)
    print(f"Cut elasticity, n={args.n}, P{args.degree}")
    print(f"active cells = {out['active_cells']}")
    print(f"L2 error     = {out['l2_error']:.6e}")


if __name__ == "__main__":
    main()
