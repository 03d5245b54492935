"""Fast generalized winding numbers as a two-level clustered reduction.

The torch counterpart of ``cutfemx_tpu.distance.winding``:

- triangles Morton-sort by centroid and group into fixed-size clusters
  (contiguous Morton ranges are spatially compact boxes);
- each cluster carries the first-order multipole of the winding
  integrand: the area-weighted normal sum and the area centroid;
- a query point sums dipole contributions over all far clusters (one
  batched (P, C) contraction) and exact solid angles over the triangles of
  its near clusters (gathered fixed-size blocks).

The clusters are built on the host (numpy); the sums run on the device in
float64: the far field's ``max(r^3, 1e-300)`` guard is zero in float32.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["WindingCluster", "build_winding_clusters", "winding_numbers"]


def _morton3(q):
    """Interleave 10-bit coords -> 30-bit Morton codes. q: (N, 3) int."""
    def spread(x):
        x = x.astype(np.uint64)
        x = (x | (x << 16)) & np.uint64(0x30000FF)
        x = (x | (x << 8)) & np.uint64(0x300F00F)
        x = (x | (x << 4)) & np.uint64(0x30C30C3)
        x = (x | (x << 2)) & np.uint64(0x9249249)
        return x
    return (spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1))
            | (spread(q[:, 2]) << np.uint64(2)))


class WindingCluster:
    """Clustered triangle soup + per-cluster dipoles (host numpy)."""

    def __init__(self, tri_coords, K=64):
        tc = np.asarray(tri_coords, np.float64)      # (NT, 3, 3)
        NT = tc.shape[0]
        cent = tc.mean(axis=1)
        lo = cent.min(axis=0)
        span = np.maximum(cent.max(axis=0) - lo, 1e-300)
        qc = np.minimum((1023 * (cent - lo) / span).astype(np.int64), 1023)
        tc = tc[np.argsort(_morton3(qc), kind="stable")]
        pad = (-NT) % K
        if pad:
            # degenerate (zero-area) copies of the last triangle's corner
            filler = np.repeat(tc[-1:, :1, :], 3, axis=1)[None] \
                .repeat(pad, axis=0).reshape(pad, 3, 3)
            tc = np.concatenate([tc, filler])
        C = tc.shape[0] // K
        self.tri = tc.reshape(C, K, 3, 3)
        e1 = self.tri[:, :, 1] - self.tri[:, :, 0]
        e2 = self.tri[:, :, 2] - self.tri[:, :, 0]
        an = 0.5 * np.cross(e1, e2)                  # area-weighted normals
        area = np.linalg.norm(an, axis=-1)           # (C, K)
        self.dipole = an.sum(axis=1)                 # (C, 3)
        w = area / np.maximum(area.sum(axis=1, keepdims=True), 1e-300)
        ctr = self.tri.mean(axis=2)                  # (C, K, 3)
        self.centroid = (w[..., None] * ctr).sum(axis=1)
        self.radius = np.sqrt(((self.tri
                                - self.centroid[:, None, None, :]) ** 2)
                              .sum(-1).max(axis=(1, 2)))
        self.n_clusters = C
        self.K = K


def build_winding_clusters(soup, K=64):
    return WindingCluster(soup.triangle_coords(), K=K)


def _solid_angles(p, tri):
    """Exact per-triangle solid angle sum (van Oosterom-Strackee).
    p: (P, 3); tri: (P, M, 3, 3) -> (P,)."""
    a = tri[:, :, 0, :] - p[:, None, :]
    b = tri[:, :, 1, :] - p[:, None, :]
    c = tri[:, :, 2, :] - p[:, None, :]
    la = torch.linalg.vector_norm(a, dim=-1)
    lb = torch.linalg.vector_norm(b, dim=-1)
    lc = torch.linalg.vector_norm(c, dim=-1)
    num = (a * torch.linalg.cross(b, c)).sum(-1)
    den = (la * lb * lc + (a * b).sum(-1) * lc + (b * c).sum(-1) * la
           + (a * c).sum(-1) * lb)
    return torch.sum(2.0 * torch.atan2(num, den), dim=1)


def _far_field(p, centroid, dipole, far_mask):
    """Dipole winding contribution of far clusters: (P,)."""
    d = centroid[None, :, :] - p[:, None, :]         # (P, C, 3)
    r2 = torch.sum(d * d, dim=-1)
    r3 = r2 * torch.sqrt(r2)
    contrib = torch.einsum("pcg,cg->pc", d, dipole) / torch.clamp(
        r3, min=1e-300)
    return torch.sum(torch.where(far_mask, contrib, 0.0), dim=1)


def _near_field(p, tri_blocks):
    """Exact winding over gathered near-cluster triangle blocks.
    tri_blocks: (P, M, K, 3, 3); padding blocks are all-zero triangles,
    which contribute nothing."""
    P_, M, K = tri_blocks.shape[:3]
    return _solid_angles(p, tri_blocks.reshape(P_, M * K, 3, 3))


def winding_numbers(points, clusters: WindingCluster, beta=2.0,
                    chunk=4096, device="cuda"):
    """Generalized winding numbers at query points, computed on ``device``
    in chunks of ``chunk`` points. Returns (NP,) float64 numpy."""
    dev = torch.device(device)
    pts = torch.as_tensor(np.asarray(points, np.float64), device=dev)
    C = clusters.n_clusters
    cen = torch.as_tensor(clusters.centroid, device=dev)
    dip = torch.as_tensor(clusters.dipole, device=dev)
    reach2 = torch.as_tensor((beta * clusters.radius) ** 2, device=dev)
    tri = torch.as_tensor(clusters.tri, device=dev)
    tri_pad = torch.cat([tri, torch.zeros((1,) + tuple(tri.shape[1:]),
                                          dtype=tri.dtype, device=dev)])
    out = []
    for s in range(0, pts.shape[0], chunk):
        p = pts[s:s + chunk]
        d2 = ((p[:, None, :] - cen[None]) ** 2).sum(-1)
        near = d2 <= reach2[None]                    # (P, C)
        counts = near.sum(dim=1)
        M = max(int(counts.max()), 1)
        idx = torch.full((p.shape[0], M), C, dtype=torch.int64, device=dev)
        rows, cols = torch.nonzero(near, as_tuple=True)   # row-major
        starts = torch.cumsum(counts, 0) - counts
        slot = torch.arange(rows.shape[0], device=dev) \
            - torch.repeat_interleave(starts, counts)
        idx[rows, slot] = cols                       # C -> the zero block
        out.append(_far_field(p, cen, dip, ~near)
                   + _near_field(p, tri_pad[idx]))
    if not out:
        return np.zeros(0)
    return torch.cat(out).cpu().numpy() / (4.0 * np.pi)
