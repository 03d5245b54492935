"""Signed distance from an STL surface: STL -> triangle soup ->
cell-triangle map -> exact near field -> Eikonal far field -> sign.

The port of ``demos/demo_stl_distance.py``. Without ``--stl`` a sphere STL
(r = 0.5, 12 x 12 triangle pairs per cube face) is generated.

Run:  python -m cutfemx_tpu_torch.demos.demo_stl_distance [--stl path]
          [--n 16] [--sign-mode component_anchor] [--device cpu]
"""

from __future__ import annotations

import argparse
import tempfile
from pathlib import Path

import numpy as np

import cutfemx_tpu_torch as cfx
from cutfemx_tpu_torch import distance
from cutfemx_tpu_torch.demos import stage_clock
from cutfemx_tpu_torch.distance.stl import TriSoup, write_stl


def _make_sphere_stl(path, r=0.5, n=12):
    """A binary STL of the cube-sphere: each cube face an n x n grid of
    triangle pairs pushed out to radius r, wound outward."""
    verts, tris = [], []
    nverts = 0
    for axis in range(3):
        for s in (-1.0, 1.0):
            base = nverts
            u = np.linspace(-1, 1, n + 1)
            U, W = np.meshgrid(u, u, indexing="ij")
            pts = np.zeros((n + 1, n + 1, 3))
            pts[..., axis] = s
            pts[..., (axis + 1) % 3] = U * s
            pts[..., (axis + 2) % 3] = W
            pts = pts.reshape(-1, 3)
            pts = pts / np.linalg.norm(pts, axis=1, keepdims=True) * r
            verts.append(pts)
            nverts += len(pts)
            for i in range(n):
                for j in range(n):
                    a = base + i * (n + 1) + j
                    b = a + n + 1
                    tris += [[a, a + 1, b + 1], [a, b + 1, b]]
    X = np.concatenate(verts)
    tri = np.asarray(tris, np.int32)
    N = np.cross(X[tri[:, 1]] - X[tri[:, 0]], X[tri[:, 2]] - X[tri[:, 0]])
    cent = X[tri].mean(axis=1)
    flip = np.einsum("ij,ij->i", N, cent) < 0
    tri[flip] = tri[flip][:, [0, 2, 1]]
    N = np.where(flip[:, None], -N, N)
    N /= np.linalg.norm(N, axis=1, keepdims=True)
    write_stl(path, TriSoup(X, tri, N, np.arange(len(tri))))


def run(stl_path=None, n=16, sign_mode="component_anchor", *,
        device="cuda"):
    """from_stl on a box mesh padded around the STL's bounding box by half
    its extent; returns the box, the distance range, the negative-vertex
    count, the values and the seconds. Without ``stl_path`` the sphere STL
    is written to a temporary directory."""
    clock = stage_clock(device)
    with tempfile.TemporaryDirectory() as tmp:
        if stl_path is None:
            stl_path = Path(tmp) / "sphere.stl"
            _make_sphere_stl(stl_path)
        lo, hi = distance.stl_bbox(stl_path)
        pad = 0.5 * (np.asarray(hi) - np.asarray(lo)).max()
        mesh = cfx.mesh.create_box(np.asarray(lo) - pad,
                                   np.asarray(hi) + pad, (n, n, n))
        t0 = clock()
        f = distance.from_stl(mesh, stl_path, sign_mode=sign_mode,
                              device=device)
        seconds = clock() - t0
    vals = f.x.cpu().numpy()
    return {"n": n, "sign_mode": sign_mode, "bbox": (lo, hi),
            "min": float(vals.min()), "max": float(vals.max()),
            "negative_vertices": int((vals < 0).sum()), "values": vals,
            "seconds": seconds}


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--stl", default=None)
    p.add_argument("--n", type=int, default=16)
    p.add_argument("--sign-mode", default="component_anchor",
                   choices=[m.value for m in distance.SignMode])
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    out = run(args.stl, args.n, args.sign_mode, device=args.device)
    lo, hi = out["bbox"]
    print(f"STL signed distance, mesh n={args.n}")
    print(f"bbox                = {np.round(lo, 3)} .. {np.round(hi, 3)}")
    print(f"distance range      = [{out['min']:.4f}, {out['max']:.4f}]")
    print(f"negative (inside) vertices = {out['negative_vertices']}")


if __name__ == "__main__":
    main()
