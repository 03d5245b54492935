"""SIPG discontinuous-Galerkin Poisson on the unit square: a DG space on
the full mesh, interior-facet SIPG terms and Nitsche-type boundary terms.

The port of ``demos/demo_dg_poisson.py``. Exact solution
u = sin(pi x) sin(pi y); penalty sigma p^2 / h.

Run: python -m cutfemx_tpu_torch.demos.demo_dg_poisson [--n 32]
         [--degree 1] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

import cutfemx_tpu_torch as cfx
from cutfemx_tpu_torch import fem
from cutfemx_tpu_torch.forms.dsl import (CellDiameter, CoefficientExpr,
                                         FacetNormal, SpatialCoordinate,
                                         TestFunction, TrialFunction, avg,
                                         dot, grad, inner, jump, pi, sin)
from cutfemx_tpu_torch.forms.measure import dS, ds, dx
from cutfemx_tpu_torch.la import direct_solve


def run(n=32, degree=1, sigma=10.0, *, device="cuda"):
    """Assemble and solve directly in f64 on the n x n unit square; the
    dof count and the L2 error."""
    f64 = torch.float64
    mesh = cfx.mesh.create_unit_square(n)
    V = cfx.functionspace(mesh, ("DG", degree), device=device)
    u, v = TrialFunction(V), TestFunction(V)
    x = SpatialCoordinate(mesh)
    nf = FacetNormal(mesh)
    h = CellDiameter(mesh)
    u_ex = sin(pi * x[0]) * sin(pi * x[1])
    f = 2 * pi ** 2 * u_ex
    pen = sigma * degree ** 2

    a = inner(grad(u), grad(v)) * dx
    a += (-inner(avg(grad(u)), jump(v, nf))
          - inner(avg(grad(v)), jump(u, nf))
          + pen / avg(h) * inner(jump(u, nf), jump(v, nf))) * dS
    a += (-dot(grad(u), nf) * v - dot(grad(v), nf) * u
          + pen / h * u * v) * ds
    L = f * v * dx + (-dot(grad(v), nf) * u_ex + pen / h * u_ex * v) * ds

    A = fem.assemble_matrix(fem.form(a, dtype=f64))
    b = fem.assemble_vector(fem.form(L, dtype=f64))
    uh = cfx.Function(V, dtype=f64)
    uh.x = direct_solve(A, b)
    e = CoefficientExpr(uh) - u_ex
    err = float(fem.assemble_scalar(fem.form(e * e * dx, dtype=f64)))
    return dict(n=n, degree=degree, dofs=V.dim,
                l2_error=float(np.sqrt(max(err, 0.0))))


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--n", type=int, default=32)
    p.add_argument("--degree", type=int, default=1)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    out = run(args.n, args.degree, device=args.device)
    print(f"SIPG DG{args.degree} Poisson, n={args.n}")
    print(f"dofs     = {out['dofs']}")
    print(f"L2 error = {out['l2_error']:.6e}")


if __name__ == "__main__":
    main()
