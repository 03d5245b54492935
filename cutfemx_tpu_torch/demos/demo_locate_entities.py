"""Entity classification and boolean selectors: cells classified against
two level sets at once, and combined selectors evaluated on them.

The port of ``demos/demo_locate_entities.py``: a circle of radius 0.6 and
the band |y| < 0.25 on [-1, 1]^2, six selectors over ``cut([circle,
band])``, then the boundary facets classified against the circle alone
(facet-hosted CutData; classification only).

Run: python -m cutfemx_tpu_torch.demos.demo_locate_entities [--n 24]
         [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

import cutfemx_tpu_torch as cfx

SELECTORS = ("circle<0", "circle=0", "band<0", "circle<0 and band<0",
             "circle=0 or band=0", "circle<=0 and band>0")


def run(n=24, *, device="cuda"):
    """The level sets' names, the cell count of each selector and the count
    of boundary facets the circle cuts, on the n x n mesh (f64)."""
    mesh = cfx.mesh.create_rectangle((-1.0, -1.0), (1.0, 1.0), (n, n))
    V = cfx.functionspace(mesh, ("Lagrange", 1), device=device)
    circle = cfx.Function(V, name="circle", dtype=torch.float64)
    circle.interpolate(lambda x: np.sqrt(x[0] ** 2 + x[1] ** 2) - 0.6)
    band = cfx.Function(V, name="band", dtype=torch.float64)
    band.interpolate(lambda x: np.abs(x[1]) - 0.25)

    cd = cfx.cut([circle, band])
    cells = {sel: int(cfx.locate_entities(cd, sel).size)
             for sel in SELECTORS}
    fcd = cfx.cut(circle, mesh.exterior_facets, mesh.tdim - 1)
    boundary = int(cfx.locate_entities(fcd, "circle=0").size)
    return dict(n=n, level_set_names=list(cd.level_set_names), cells=cells,
                boundary_facets_cut=boundary)


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--n", type=int, default=24)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    out = run(args.n, device=args.device)
    print(f"level sets: {out['level_set_names']}")
    for sel, count in out["cells"].items():
        print(f"  {sel:28s} -> {count:5d} cells")
    print(f"boundary facets with circle=0: {out['boundary_facets_cut']}")


if __name__ == "__main__":
    main()
