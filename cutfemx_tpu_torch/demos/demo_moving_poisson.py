"""Moving-domain Poisson: the level set translates each step; the cut
state is refreshed with ``update``, runtime quadrature and forms are
rebuilt, and the system is re-assembled and solved directly.

The port of ``demos/demo_moving_poisson.py``: a disk of radius 0.35 whose
center moves from x = -0.4 to 0.4 over the steps on [-1, 1]^2, with
Nitsche terms (gamma = 40) and ghost penalty; exact solution
u = sin(pi x) sin(pi y).

Run: python -m cutfemx_tpu_torch.demos.demo_moving_poisson [--n 32]
         [--steps 8] [--device cpu]
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


def run(n=32, steps=8, r=0.35, gamma=40.0, *, device="cuda"):
    """Step in f64 on the n x n mesh. Returns, per step, the center, the
    cut-cell count, the L2 error and the step's seconds (the device's
    queue drained at its end)."""
    f64 = torch.float64
    clock = stage_clock(device)
    mesh = cfx.mesh.create_rectangle((-1.0, -1.0), (1.0, 1.0), (n, n))
    Vphi = cfx.functionspace(mesh, ("Lagrange", 1), device=device)
    phi = cfx.Function(Vphi, name="phi", dtype=f64)
    V = cfx.functionspace(mesh, ("Lagrange", 1), device=device)

    out = []
    cut_data = None
    for step in range(steps):
        t0 = clock()
        cx = -0.4 + 0.8 * step / max(steps - 1, 1)
        phi.interpolate(lambda x: np.sqrt((x[0] - cx) ** 2 + x[1] ** 2) - r)
        if cut_data is None:
            cut_data = cfx.cut(phi)
        else:
            cfx.update(cut_data)
        inside = cfx.locate_entities(cut_data, "phi<0")
        vol = cfx.runtime_quadrature(cut_data, "phi<0", 2)
        srf = cfx.runtime_quadrature(cut_data, "phi=0", 2)
        gp = cfx.ghost_penalty_facets(cut_data, "phi<0")
        dxo = Measure("dx", domain=mesh, subdomain_data=[inside, vol])
        dxg = Measure("dx", domain=mesh, subdomain_data=srf)
        dSg = Measure("dS", domain=mesh, subdomain_data=gp)

        u, v = TrialFunction(V), TestFunction(V)
        x = SpatialCoordinate(mesh)
        ng = cfx.normal(phi)
        nf = FacetNormal(mesh)
        h = CellDiameter(mesh)
        ue = sin(pi * x[0]) * sin(pi * x[1])
        f = 2 * pi ** 2 * ue
        a = inner(grad(u), grad(v)) * dxo
        a += (-dot(grad(u), ng) * v - dot(grad(v), ng) * u
              + gamma / h * u * v) * dxg
        a += 0.1 * avg(h) * inner(jump(grad(u), nf),
                                  jump(grad(v), nf)) * dSg
        L = f * v * dxo + (-dot(grad(v), ng) * ue
                           + gamma / h * ue * v) * dxg
        af, Lf = fem.form(a, dtype=f64), fem.form(L, dtype=f64)
        A = fem.assemble_matrix(af)
        b = fem.assemble_vector(Lf)
        A, b = fem.deactivate_outside(A, b, fem.active_domain(af))
        uh = cfx.Function(V, dtype=f64)
        uh.x = direct_solve(A, b)
        e = CoefficientExpr(uh) - ue
        err = float(fem.assemble_scalar(fem.form(e * e * dxo, dtype=f64)))
        out.append(dict(step=step, center=cx,
                        cut_cells=int(srf.parent_map.size),
                        l2_error=float(np.sqrt(max(err, 0.0))),
                        seconds=clock() - t0))
    return dict(n=n, steps=steps, dofs=V.dim, per_step=out)


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--n", type=int, default=32)
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    for s in run(args.n, args.steps, device=args.device)["per_step"]:
        print(f"step {s['step']}: center x = {s['center']:+.2f}, cut cells = "
              f"{s['cut_cells']:4d}, L2 error = {s['l2_error']:.3e}, "
              f"{s['seconds']:.2f}s")


if __name__ == "__main__":
    main()
