"""Moving-domain heat equation: backward-Euler time stepping on a
translating disk, with re-cut, re-assembly and a direct solve at each step.

The port of ``demos/demo_moving_heat.py``. Manufactured solution
u = exp(-t) sin(pi x) sin(pi y), f = u_t - lap(u) = (2 pi^2 - 1) u. The
interface moves less than one cell per step, so every newly activated dof
lies in the previous step's ghost-penalty band and carries meaningful
history.

Run: python -m cutfemx_tpu_torch.demos.demo_moving_heat [--n 32]
         [--steps 10] [--device cpu]
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


def run(n=32, steps=10, r=0.42, gamma=40.0, gamma_g=0.1, speed=0.04, *,
        device="cuda"):
    """Time-step in f64 on the n x n mesh of [-1, 1]^2. Returns the L2
    error of each step (``errors``) and, per step, its time split
    (seconds, the device's queue drained at each stage's end):

    - ``recut_s``: the level set moved and re-classified (``update``);
    - ``quadrature_s``: cell lists, runtime rules and ghost facets;
    - ``assembly_s``: forms, the load vector and the active domain;
    - ``host_csr_s``: ``assemble_matrix`` (element matrices on the device,
      COO -> CSR on the host) and ``deactivate_outside``;
    - ``solve_s``: ``direct_solve`` on the host;
    - ``error_s``: the L2 error."""
    f64 = torch.float64
    clock = stage_clock(device)
    mesh = cfx.mesh.create_rectangle((-1.0, -1.0), (1.0, 1.0), (n, n))
    h = 2.0 / n
    dt = 0.5 * h / max(speed, 1e-12) * 0.5   # interface moves < h/2 per dt
    Vphi = cfx.functionspace(mesh, ("Lagrange", 1), device=device)
    phi = cfx.Function(Vphi, name="phi", dtype=f64)
    V = cfx.functionspace(mesh, ("Lagrange", 1), device=device)
    uh = cfx.Function(V, name="u", dtype=f64)

    x = SpatialCoordinate(mesh)
    space = sin(pi * x[0]) * sin(pi * x[1])

    def exact_np(t):
        c = V.dof_coordinates
        return np.exp(-t) * np.sin(np.pi * c[:, 0]) * np.sin(
            np.pi * c[:, 1])

    errors, split = [], []
    t = 0.0
    cut_data = None
    for step in range(steps + 1):
        t0 = clock()
        cx = -0.2 + speed * t
        phi.interpolate(lambda X: np.sqrt((X[0] - cx) ** 2 + X[1] ** 2)
                        - r)
        if cut_data is None:
            cut_data = cfx.cut(phi)
        else:
            cfx.update(cut_data)
        t_cut = clock()
        inside = cfx.locate_entities(cut_data, "phi<0")
        vol = cfx.runtime_quadrature(cut_data, "phi<0", 2)
        srf = cfx.runtime_quadrature(cut_data, "phi=0", 2)
        gp = cfx.ghost_penalty_facets(cut_data, "phi<0")
        dxo = Measure("dx", domain=mesh, subdomain_data=[inside, vol])
        dxg = Measure("dx", domain=mesh, subdomain_data=srf)
        dSg = Measure("dS", domain=mesh, subdomain_data=gp)
        t_quad = clock()

        if step == 0:
            uh.x = torch.as_tensor(exact_np(0.0), dtype=f64, device=device)
            t += dt
            continue

        u, v = TrialFunction(V), TestFunction(V)
        ng = cfx.normal(phi)
        nf = FacetNormal(mesh)
        hc = CellDiameter(mesh)
        ue = float(np.exp(-t)) * space
        f = (2 * pi ** 2 - 1.0) * ue
        un = CoefficientExpr(uh)

        a = (u * v / dt + inner(grad(u), grad(v))) * dxo
        a += (-dot(grad(u), ng) * v - dot(grad(v), ng) * u
              + gamma / hc * u * v) * dxg
        if gp.size:
            a += gamma_g * avg(hc) * inner(jump(grad(u), nf),
                                           jump(grad(v), nf)) * dSg
        L = (f + un / dt) * v * dxo
        L += (-dot(grad(v), ng) * ue + gamma / hc * ue * v) * dxg

        af, Lf = fem.form(a, dtype=f64), fem.form(L, dtype=f64)
        b = fem.assemble_vector(Lf)
        dom = fem.active_domain(af)
        t_asm = clock()
        A = fem.assemble_matrix(af)
        A, b = fem.deactivate_outside(A, b, dom)
        t_csr = clock()
        uh.x = direct_solve(A, b)
        t_solve = clock()

        e = CoefficientExpr(uh) - ue
        err = np.sqrt(max(float(fem.assemble_scalar(
            fem.form(e * e * dxo, dtype=f64))), 0.0))
        t_err = clock()
        errors.append(float(err))
        split.append(dict(
            step=step, t=t, center=cx, error=float(err),
            recut_s=t_cut - t0, quadrature_s=t_quad - t_cut,
            assembly_s=t_asm - t_quad, host_csr_s=t_csr - t_asm,
            solve_s=t_solve - t_csr, error_s=t_err - t_solve,
            total_s=t_err - t0))
        t += dt
    return dict(n=n, steps=steps, dofs=V.dim, errors=errors, split=split)


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--n", type=int, default=32)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    out = run(args.n, args.steps, device=args.device)
    for s in out["split"]:
        print(f"step {s['step']:3d}: t={s['t']:.3f} "
              f"center={s['center']:+.3f} L2 error={s['error']:.3e}")
    print(f"max L2 error over {args.steps} steps: {max(out['errors']):.3e}")


if __name__ == "__main__":
    main()
