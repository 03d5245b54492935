"""Level-set reinitialization: a distorted (non-distance) level set with
the zero contour of a circle is rebuilt as the signed distance to its own
zero contour.

The port of ``demos/demo_reinit.py``.

Run:  python -m cutfemx_tpu_torch.demos.demo_reinit [--n 48] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

import cutfemx_tpu_torch as cfx
from cutfemx_tpu_torch import distance
from cutfemx_tpu_torch.demos import stage_clock

RADIUS = 0.5


def run(n=48, *, device="cuda"):
    """Reinitialize phi = |x|^2 - r^2 on an n x n square of [-1, 1]^2;
    returns the max error against |x| - r, the near-band (||x| - r| < 0.1)
    max error, the negative-vertex count, the values and the seconds."""
    clock = stage_clock(device)
    mesh = cfx.mesh.create_rectangle((-1, -1), (1, 1), (n, n))
    V = cfx.functionspace(mesh, ("Lagrange", 1), device=device)
    phi = cfx.Function(V, name="phi", dtype=torch.float64)
    # parabolic profile: the zero contour of a circle, the wrong gradient
    phi.interpolate(lambda x: (x[0] ** 2 + x[1] ** 2) - RADIUS ** 2)
    t0 = clock()
    out = distance.reinitialize(phi)
    seconds = clock() - t0
    vals = out.x.cpu().numpy()
    exact = np.linalg.norm(mesh.vertices, axis=1) - RADIUS
    err = np.abs(vals - exact)
    return {"n": n, "max_error": float(err.max()),
            "band_max_error": float(err[np.abs(exact) < 0.1].max()),
            "negative_vertices": int((vals < 0).sum()), "values": vals,
            "seconds": seconds}


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--n", type=int, default=48)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    out = run(args.n, device=args.device)
    print(f"Reinitialization demo, n={args.n}")
    print(f"|phi - d_exact| max   = {out['max_error']:.4e}")
    print(f"near-band max error   = {out['band_max_error']:.4e}")
    print("gradient before       = 2|x| (non-unit)")


if __name__ == "__main__":
    main()
