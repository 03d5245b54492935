"""Eikonal solver: the Fast Iterative Method as masked full-array Jacobi
sweeps.

The torch counterpart of ``cutfemx_tpu.distance.fim``. Every (vertex,
incident virtual simplex) pair computes a candidate distance each sweep
(one-point and planar updates with causality checks), followed by a
scatter-min into the vertices. The sweep loop is a Python loop that reads
the change on the host once per sweep; the sweep count is the reference's:
the first sweep whose change is at or below ``tol`` ends it. The planar
updates' inverse Gram matrices depend on the geometry only, so they are
computed once per solve. An optional payload (speed, normal) rides along
the winning update (barycentric mix of the full-simplex update, else the
nearest source); its per-vertex winner sums are sorted segment sums, so
repeats are bitwise equal on the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from itertools import combinations

import numpy as np
import torch

from ..fem import segment_sum_sorted, sorted_scatter_plan

__all__ = ["FMMOptions", "eikonal_solve", "build_update_stencil"]

_INF = 1e30


@dataclass
class FMMOptions:
    """Sweep cap, convergence tolerance on the largest change of a sweep,
    and the value that stands for 'unknown'."""
    max_iter: int = 1000
    tol: float = 1e-10
    inf: float = _INF


def build_update_stencil(mesh):
    """(upd_v (M,), upd_others (M, d)) vertex-update stencil over all
    virtual simplices: each simplex contributes one entry per vertex with
    the remaining d vertices as known points (host numpy)."""
    split = mesh.ref_cell.simplex_split          # (nsub, d+1)
    simplices = mesh.cells[:, split].reshape(-1, split.shape[1])
    d = mesh.tdim
    upd_v = np.concatenate([simplices[:, i] for i in range(d + 1)])
    upd_others = np.concatenate([np.delete(simplices, i, axis=1)
                                 for i in range(d + 1)])
    return upd_v.astype(np.int32), upd_others.astype(np.int32)


def _inverse_gram(xv, X):
    """Regularised inverse Gram matrix of the rows x_i - x_v of a
    k-simplex of known vertices. xv: (M, g); X: (M, k, g) -> (M, k, k)."""
    P = X - xv[:, None, :]
    G = (P[:, :, None, :] * P[:, None, :, :]).sum(-1)
    k = X.shape[1]
    eye = torch.eye(k, dtype=G.dtype, device=G.device)
    return torch.linalg.solve(G + 1e-30 * eye, eye.expand(G.shape))


class _Planar:
    """The geometry of the planar updates from one sub-simplex of k known
    vertices: the inverse Gram matrix Gi (M, k, k), its row sums Gi 1
    (M, k) and a = 1^T Gi 1 (M,)."""

    def __init__(self, cols, Gi):
        self.cols = cols
        self.Gi = Gi
        self.Gi1 = Gi.sum(dim=2)
        self.a = self.Gi1.sum(dim=1)


def _update_planar(pl, dvals, inf):
    """Planar-wave update from a k-simplex of known vertices: solves
    |grad T| = 1 assuming the front is planar across the simplex; inf when
    the characteristic does not pass through the simplex (causality).
    dvals: (M, k) known values. Returns (T, lam). The quadratic forms are
    written out elementwise (k <= 3), one pass over Gi each."""
    Gd = (pl.Gi * dvals[:, None, :]).sum(dim=2)          # Gi d
    a = pl.a
    b = (pl.Gi1 * dvals).sum(dim=1)                      # 1^T Gi d
    c = (dvals * Gd).sum(dim=1) - 1.0                    # d^T Gi d - 1
    disc = b * b - a * c
    ok = (disc >= 0.0) & (a > 0.0)
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    T = (b + sq) / torch.clamp(a, min=1e-300)
    # causality: the barycentric weights of the characteristic foot,
    # lambda = Gi (T 1 - d), must be nonnegative
    lam = T[:, None] * pl.Gi1 - Gd
    ok = ok & (lam >= -1e-12).all(dim=1) & (T >= dvals.max(dim=1).values)
    return torch.where(ok, T, inf), lam


class _Geometry:
    """What a sweep needs of the mesh: the edge lengths of the one-point
    updates (d_a + |x_v - x_a|) and the planar-update geometry of every
    sub-simplex of known vertices."""

    def __init__(self, xv, X):
        d = X.shape[1]
        self.d = d
        self.edge = torch.linalg.vector_norm(xv[:, None, :] - X, dim=-1)
        self.planar = [_Planar(list(s), _inverse_gram(xv, X[:, list(s), :]))
                       for k in range(2, d + 1)
                       for s in combinations(range(d), k)]


def _all_candidates(geo, dvals, inf):
    """Min over the one-point and every planar sub-simplex update.
    dvals: (M, d). Returns (dist (M,), lam_full (M, d), used_full (M,))."""
    M, d = dvals.shape
    best = torch.full((M,), inf, dtype=dvals.dtype, device=dvals.device)
    for i in range(d):
        best = torch.minimum(best, dvals[:, i] + geo.edge[:, i])
    lam_full = torch.zeros_like(dvals)
    used_full = torch.zeros(M, dtype=torch.bool, device=dvals.device)
    for pl in geo.planar:
        T, lam = _update_planar(pl, dvals[:, pl.cols], inf)
        improved = T < best
        best = torch.where(improved, T, best)
        if len(pl.cols) == d:
            lam_full = torch.where(improved[:, None], lam, lam_full)
            used_full = used_full | improved
    return best, lam_full, used_full


def eikonal_solve(mesh, d0, frozen, options: FMMOptions | None = None,
                  payload=None, dtype=torch.float64, device="cuda"):
    """Solve |grad d| = 1 with fixed values on ``frozen`` vertices.

    d0: (NV,) initial values (inf on unknown vertices); frozen: (NV,) bool
    mask of vertices whose values are boundary data; ``payload``: optional
    (NV, P) values transported from the minimizing update's sources.
    Arrays may be numpy or tensors; the sweeps run on ``device``.

    Returns (d, payload_out, iterations) with d and payload_out tensors on
    ``device`` (payload_out is None without a payload)."""
    opts = options or FMMOptions()
    dev = torch.device(device)
    upd_v, upd_others = build_update_stencil(mesh)
    verts = torch.as_tensor(mesh.vertices, dtype=dtype, device=dev)
    upd_v_t = torch.as_tensor(upd_v, dtype=torch.int64, device=dev)
    upd_o_t = torch.as_tensor(upd_others, dtype=torch.int64, device=dev)
    geo = _Geometry(verts[upd_v_t], verts[upd_o_t])
    frozen_t = torch.as_tensor(np.asarray(frozen) if not isinstance(
        frozen, torch.Tensor) else frozen, dtype=torch.bool, device=dev)
    nv = mesh.num_vertices
    inf = opts.inf
    d = torch.as_tensor(d0, dtype=dtype, device=dev).clone()

    pay = None
    if payload is not None:
        pay = torch.as_tensor(payload, dtype=dtype, device=dev).clone()
        perm, lengths = sorted_scatter_plan(upd_v, nv, dev)
        rows = torch.arange(upd_v.shape[0], device=dev)

    it = 0
    while it < opts.max_iter:
        dvals = d[upd_o_t]                                   # (M, d)
        cand, lam, used_full = _all_candidates(geo, dvals, inf)
        new_d = torch.full((nv,), inf, dtype=dtype, device=dev)
        new_d.scatter_reduce_(0, upd_v_t, cand, "amin")
        new_d = torch.minimum(d, new_d)
        new_d = torch.where(frozen_t, d, new_d)
        known = torch.isfinite(d) & (d < inf * 0.5)
        ch = torch.where(known, torch.abs(new_d - d), 0.0).max()
        big = ((d >= inf * 0.5) & (new_d < inf * 0.5)).any()
        change = torch.maximum(ch, big.to(dtype))
        if pay is not None:
            pv = pay[upd_o_t]                                # (M, d, P)
            lam_n = lam / torch.clamp(lam.sum(dim=1, keepdim=True),
                                      min=1e-30)
            mix = (lam_n[:, :, None] * pv).sum(dim=1)
            nearest = pv[rows, torch.argmin(torch.abs(dvals), dim=1)]
            cand_pay = torch.where(used_full[:, None], mix, nearest)
            win = torch.abs(cand - new_d[upd_v_t]) < 1e-12
            num = segment_sum_sorted(
                torch.where(win[:, None], cand_pay, 0.0)[perm], lengths)
            den = segment_sum_sorted(win.to(dtype)[perm], lengths)
            updated = (~frozen_t) & (den > 0) & (torch.abs(new_d - d) > 0)
            pay = torch.where(updated[:, None],
                              num / torch.clamp(den[:, None], min=1.0), pay)
        d = new_d
        it += 1
        if not bool(change > opts.tol):
            break
    return d, pay, it
