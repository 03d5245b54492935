"""Cut boundary integrals: the perimeter (surface area) and area (volume)
of a circle (sphere) from interface and volume runtime quadrature.

The port of ``demos/demo_boundary_sphere_perimeter.py``: the level set
|x| - r on [-1, 1]^dim; the ``phi=0`` rule of order 3 sums to the
perimeter, and the ``phi<0`` rule on the cut cells plus the full inside
cells to the area.

Run: python -m cutfemx_tpu_torch.demos.demo_boundary_sphere_perimeter
         [--n 32] [--dim 2|3] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

import cutfemx_tpu_torch as cfx


def run(n=32, dim=2, r=0.43, *, device="cuda"):
    """The cut perimeter (surface area) and area (volume) on the n^dim
    mesh in f64, beside the exact values."""
    if dim == 2:
        mesh = cfx.mesh.create_rectangle((-1, -1), (1, 1), (n, n))
        exact_perim = 2 * np.pi * r
        exact_area = np.pi * r ** 2
    else:
        mesh = cfx.mesh.create_box((-1, -1, -1), (1, 1, 1), (n, n, n))
        exact_perim = 4 * np.pi * r ** 2
        exact_area = 4 / 3 * np.pi * r ** 3

    V = cfx.functionspace(mesh, ("Lagrange", 1), device=device)
    phi = cfx.Function(V, name="phi", dtype=torch.float64)
    phi.interpolate(lambda x: np.sqrt(sum(x[i] ** 2
                                          for i in range(dim))) - r)

    cd = cfx.cut(phi)
    inside = cfx.locate_entities(cd, "phi<0")
    srf = cfx.runtime_quadrature(cd, "phi=0", 3)
    vol = cfx.runtime_quadrature(cd, "phi<0", 3)

    perim = float(srf.weights_padded.sum())
    area_cut = float(vol.weights_padded.sum())
    coords = mesh.cell_vertex_coords[inside]
    if dim == 2:
        E1 = coords[:, 1] - coords[:, 0]
        E2 = coords[:, 2] - coords[:, 0]
        full = 0.5 * np.abs(E1[:, 0] * E2[:, 1] - E1[:, 1] * E2[:, 0]).sum()
    else:
        full = np.abs(np.einsum(
            "ci,ci->c",
            np.cross(coords[:, 1] - coords[:, 0],
                     coords[:, 2] - coords[:, 0]),
            coords[:, 3] - coords[:, 0])).sum() / 6.0
    area = full + area_cut
    return dict(n=n, dim=dim, r=r, perimeter=perim, area=area,
                exact_perimeter=exact_perim, exact_area=exact_area,
                inside_cells=int(inside.size),
                cut_cells=int(srf.parent_map.size))


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--n", type=int, default=32)
    p.add_argument("--dim", type=int, default=2, choices=(2, 3))
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    out = run(args.n, args.dim, device=args.device)
    name = "perimeter" if args.dim == 2 else "surface area"
    vname = "area" if args.dim == 2 else "volume"
    print(f"Cut {name} demo, dim={args.dim}, n={args.n}, r={out['r']}")
    for label, got, want in ((name, out["perimeter"], out["exact_perimeter"]),
                             (vname, out["area"], out["exact_area"])):
        print(f"{label:13s} = {got:.6f}  (exact {want:.6f}, "
              f"err {abs(got - want):.2e})")


if __name__ == "__main__":
    main()
