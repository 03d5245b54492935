"""Saye-style implicit quadrature on quadrilateral/hexahedral host cells.

The torch counterpart of ``cutfemx_tpu.cut.saye`` (the ``algoim`` /
``algoim_general`` runtime-quadrature backends, restricted to quad/hex
host cells). Instead of sub-triangulating the cut cell (the ``straight``
backend), the implicitly defined region is integrated by dimension
reduction following R. Saye's algorithm:

1. pick a height direction k where phi is most monotone,
2. integrate over the base (the remaining axes) with Gauss rules whose
   lines are SPLIT at the zero sets of phi restricted to the two k-faces
   (where the interface exits the cell the base integrand is only
   piecewise smooth; splitting restores spectral accuracy),
3. along each height line find the exact roots of the 1D polynomial
   restriction of the level set; sub-segments between roots get scaled
   1D Gauss rules (volume) and the roots themselves become surface points
   weighted by the graph factor |grad phi| / |d_k phi|.

The 1D restriction of a Qk level set along an axis line is a degree-k
polynomial, so roots are exact (closed form for k <= 2).

Height directions are chosen per box with Saye's direction bound: axis k
qualifies iff d_k phi is certifiably sign-consistent on the box
(Bernstein bounds) and |d_k phi| >= theta |grad phi|. Boxes where no axis
qualifies are subdivided into 2^d children; at ``_MAX_DEPTH`` the bound
is relaxed to sign consistency, and cells that still fail fall back to
red-refined marching (``_FALLBACK_LEVELS``) for the whole cell. In 3D the
outer base axis is also split at the zeros of phi on the four box edges
along it (Saye's recursion one dimension down).

Where things run: the box grouping (Bernstein bounds, the subdivision) is
data-dependent and runs on the host in numpy, on one host copy of the cut
cells' dofs. Everything per group (face and edge restrictions, line
values, roots, segment rules, |det J|, normals) runs as torch ops in
float64 on the level set's device; the rules come back in the level
set's dtype. One exception: for a level set of degree > 2 the 1D roots
are found on the host, one ``np.roots`` call per line as the reference
does (``_roots_in_unit``); on a CUDA level set that copies every line's
coefficients to the host and loops in Python, and its cost on the card
is not measured. Output contract as the straight backend: points in
parent-cell reference coordinates, PHYSICAL weights, zero-weight padding.
"""

from __future__ import annotations

import time
from math import comb

import numpy as np
import torch

from ..elements import lagrange_element
from ..quadrature import gauss_legendre
from .quadrature import RuntimeQuadratureRules, interface_rules, volume_rules

__all__ = ["saye_volume_rules", "saye_interface_rules"]

_TENSOR_CELLS = ("quadrilateral", "hexahedron")

_MAX_DEPTH = 2       # box subdivision depth before the marching fallback
_THETA = 0.1         # Saye direction bound: |d_k phi| >= theta |grad phi|
_FALLBACK_LEVELS = 3  # red-refinement depth of the marching fallback

F64 = torch.float64


def _validate_host(mesh):
    """The algoim backends' host-cell validation: quad/hex cells only."""
    if mesh.cell_type not in _TENSOR_CELLS:
        raise ValueError(
            "algoim backends require quadrilateral/hexahedron host cells "
            f"(got '{mesh.cell_type}'); use backend='straight'")


def _npts_1d(order):
    return max(2, (int(order) + 2) // 2)


def _fit_nodes(p):
    """Chebyshev-Lobatto sample nodes on [0,1] (exact poly fit)."""
    if p <= 1:
        return np.array([0.0, 1.0])
    return 0.5 * (1.0 - np.cos(np.pi * np.arange(p + 1) / p))


# -- host: certified box classification and grouping -------------------------


def _mono_tensor(el, dofs, lo, hi):
    """Tensor monomial coefficients of phi restricted to boxes (numpy).

    dofs: (B, nd); lo, hi: (B, d) box corners in cell reference coords.
    Returns C (B, p+1, ..., p+1): phi(lo + u*(hi-lo)) =
    sum C[i0..id] u0^i0 ... — exact (phi is Qp, the restriction is a
    tensor polynomial of per-axis degree p)."""
    p = el.degree
    B, d = lo.shape
    ts = _fit_nodes(p)
    grids = np.meshgrid(*([ts] * d), indexing="ij")
    upts = np.stack([g.ravel() for g in grids], -1)        # (T^d, d)
    pts = lo[:, None, :] + upts[None] * (hi - lo)[:, None, :]
    tab = np.asarray(el.tabulate(pts))                     # (B, T^d, nd)
    vals = np.einsum("btn,bn->bt", tab, dofs).reshape(
        (B,) + (p + 1,) * d)
    Vinv = np.linalg.inv(np.vander(ts, p + 1, increasing=True))
    C = vals
    for a in range(d):
        C = np.moveaxis(np.tensordot(C, Vinv, axes=([1 + a], [1])),
                        -1, 1 + a)
    return C


def _mono_to_bern(q):
    """Monomial -> Bernstein-q change of basis: u^k = sum_i M[i,k] B_i^q.
    M[i,k] = C(i,k)/C(q,k) for i >= k."""
    M = np.zeros((q + 1, q + 1))
    for k in range(q + 1):
        for i in range(k, q + 1):
            M[i, k] = comb(i, k) / comb(q, k)
    return M


def _bern_bounds(C, degs):
    """Certified range bounds of a tensor polynomial from its Bernstein
    coefficients (convex-hull property): true range subset of
    [min coeff, max coeff]."""
    T = C
    for a, q in enumerate(degs):
        M = _mono_to_bern(q)
        T = np.moveaxis(np.tensordot(T, M, axes=([1 + a], [1])), -1, 1 + a)
    flat = T.reshape(len(T), -1)
    return flat.min(1), flat.max(1)


def _box_classify(el, dofs, lo, hi, theta, relax):
    """Certified per-box classification (interval strategy).

    Returns (uni_in, uni_out, valid, score):
    - uni_in / uni_out: phi provably < 0 / > 0 on the whole box
      (Bernstein bounds) — no interface treatment needed;
    - valid (B, d): axis k is a certified height direction (d_k phi
      sign-consistent; unless ``relax``, also |d_k phi| >= theta
      |grad phi| — Saye's direction bound keeps the surface graph
      factor <= 1/theta);
    - score (B, d): worst-case |d_k phi| for picking the best axis."""
    p = el.degree
    B, d = lo.shape
    C = _mono_tensor(el, dofs, lo, hi)
    fmin, fmax = _bern_bounds(C, (p,) * d)
    uni_in = fmax < 0.0
    uni_out = fmin > 0.0
    dmins, dmaxs = [], []
    for k in range(d):
        idx = [slice(None)] * (d + 1)
        idx[1 + k] = slice(1, None)
        mult_shape = [1] * (d + 1)
        mult_shape[1 + k] = p
        Ck = C[tuple(idx)] * np.arange(1, p + 1).reshape(mult_shape)
        degs = tuple(p - 1 if a == k else p for a in range(d))
        mn, mx = _bern_bounds(Ck, degs)
        dmins.append(mn)
        dmaxs.append(mx)
    dmin = np.stack(dmins, 1)
    dmax = np.stack(dmaxs, 1)                              # (B, d)
    # box-parameter derivatives scale the cell derivatives by the box
    # extent, equal on every axis (uniform bisection), so ratios and
    # signs are unaffected
    amax = np.maximum(np.abs(dmin), np.abs(dmax))
    gb = np.linalg.norm(amax, axis=1)                      # |grad| bound
    tol = 1e-12 * np.maximum(gb, 1e-300)[:, None]
    sign_ok = (dmin >= -tol) | (dmax <= tol)
    mag = np.where((dmin >= -tol) & (dmax >= -tol), np.abs(dmin),
                   np.where((dmax <= tol) & (dmin <= tol),
                            np.abs(dmax), 0.0))
    if relax:
        valid = sign_ok & (amax > tol)
    else:
        valid = sign_ok & (mag >= theta * gb[:, None])
    return uni_in, uni_out, valid, np.where(valid, mag, -1.0)


def _host_dofs(phi, cut_cells):
    """The one host copy of the cut cells' level-set dofs, (C, nd) f64."""
    return _device_dofs(phi, cut_cells).cpu().numpy()


def _device_dofs(phi, cut_cells):
    """The cut cells' level-set dofs on the level set's device, (C, nd)
    f64."""
    V = phi.function_space
    idx = torch.as_tensor(np.asarray(V.dofmap)[cut_cells],
                          dtype=torch.int64, device=phi.x.device)
    return phi.x.detach()[idx].to(F64)


def _box_groups(mesh, phi, cut_cells, max_depth=_MAX_DEPTH, theta=_THETA):
    """Partition each cut cell into height-graph and uniform sub-boxes
    (host numpy).

    A box is UNIFORM when phi is certifiably sign-definite on it
    (Bernstein bounds): it needs a plain tensor Gauss rule (volume, if on
    the requested side) and no interface points. Otherwise axis k is a
    valid height direction iff d_k phi is certifiably sign-consistent and
    satisfies Saye's direction bound (see _box_classify). Boxes with no
    valid axis split into 2^d children; at max depth the direction bound
    is relaxed to sign consistency, and cells that still fail are
    returned whole as the fallback set (routed to red-refined marching by
    the callers).

    Returns (groups [(k, rows, lo, hi)], uniform [(sign, rows, lo, hi)]
    with sign '<' for phi<0 boxes, fallback_rows); rows index into
    cut_cells, (lo, hi) are box corners in cell reference coords."""
    el = phi.function_space.element
    d = mesh.tdim
    dofs_all = _host_dofs(phi, cut_cells)
    rows = np.arange(len(cut_cells))
    lo = np.zeros((len(rows), d))
    hi = np.ones((len(rows), d))
    bits = np.array(list(np.ndindex(*([2] * d))))          # (2^d, d)
    groups = []
    uniform = []
    fallback = np.zeros(0, np.int64)
    for depth in range(max_depth + 1):
        if rows.size == 0:
            break
        uni_in, uni_out, valid, score = _box_classify(
            el, dofs_all[rows], lo, hi, theta,
            relax=(depth == max_depth))
        if uni_in.any():
            uniform.append(("<", rows[uni_in], lo[uni_in], hi[uni_in]))
        if uni_out.any():
            uniform.append((">", rows[uni_out], lo[uni_out], hi[uni_out]))
        rem = ~(uni_in | uni_out)
        k = np.argmax(score, axis=1)
        has = valid.any(axis=1) & rem
        for kk in range(d):
            sel = has & (k == kk)
            if sel.any():
                groups.append((kk, rows[sel], lo[sel], hi[sel]))
        rest = rem & ~has
        if depth == max_depth:
            fallback = np.unique(rows[rest])
            break
        mid = 0.5 * (lo[rest] + hi[rest])
        lo_r, hi_r = lo[rest], hi[rest]
        lo = np.where(bits[None] == 1, mid[:, None], lo_r[:, None]) \
            .reshape(-1, d)
        hi = np.where(bits[None] == 1, hi_r[:, None], mid[:, None]) \
            .reshape(-1, d)
        rows = np.repeat(rows[rest], 2 ** d)
    if fallback.size:
        # drop the fallback cells' partial boxes: the whole cell goes
        # through marching instead (no double counting)
        def prune(blocks):
            out = []
            for key, rws, lo_g, hi_g in blocks:
                keep = ~np.isin(rws, fallback)
                if keep.any():
                    out.append((key, rws[keep], lo_g[keep], hi_g[keep]))
            return out
        groups = prune(groups)
        uniform = prune(uniform)
    return groups, uniform, fallback


def _group_stats(groups, uniform, fallback, seconds):
    """What the grouping decided, per cut cell: ``height_cells`` took a
    height direction for the whole cell, ``subdivided_cells`` were split
    into sub-boxes (and kept), ``fallback_cells`` went to marching."""
    whole, split = set(), set()
    for _, rws, lo, hi in list(groups) + list(uniform):
        full = np.all((lo == 0.0) & (hi == 1.0), axis=1)
        whole.update(rws[full].tolist())
        split.update(rws[~full].tolist())
    return dict(box_grouping_s=seconds, height_cells=len(whole),
                subdivided_cells=len(split),
                fallback_cells=int(len(fallback)),
                graph_boxes=int(sum(len(g[1]) for g in groups)),
                uniform_boxes=int(sum(len(u[1]) for u in uniform)))


# -- device: per-group arithmetic --------------------------------------------


def _poly_coeffs(vals, ts):
    """Exact monomial coefficients through degree-p samples.

    vals: (..., p+1) values at shared nodes ts -> (..., p+1) coeffs c
    with poly(t) = sum c_i t^i."""
    V = np.vander(ts, len(ts), increasing=True)
    Vinv_T = torch.as_tensor(np.linalg.inv(V).T, dtype=vals.dtype,
                             device=vals.device)
    return vals @ Vinv_T


def _roots_in_unit(c):
    """Real roots of sum c_i t^i in (0, 1): closed form for degree <= 2,
    on the tensor's device; above that numpy's companion-matrix roots on
    the host, one ``np.roots`` call per line in a Python loop (as the
    reference), so a CUDA tensor makes one device-to-host copy of all
    lines and the loop's time grows with their number.

    c: (..., p+1) -> (roots (..., p), valid (..., p)); invalid slots 1.0.
    """
    p = c.shape[-1] - 1
    eps = 1e-14
    if p == 1:
        c0, c1 = c[..., 0], c[..., 1]
        safe = torch.abs(c1) > eps
        t = torch.where(safe, -c0 / torch.where(safe, c1, 1.0), 2.0)
        valid = safe & (t > 0.0) & (t < 1.0)
        return (torch.where(valid, t, 1.0)[..., None], valid[..., None])
    if p == 2:
        c0, c1, c2 = c[..., 0], c[..., 1], c[..., 2]
        quad = torch.abs(c2) > eps
        disc = c1 * c1 - 4.0 * c2 * c0
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        qq = -0.5 * (c1 + torch.sign(torch.where(c1 == 0, 1.0, c1)) * sq)
        den1 = torch.where(quad, c2, 1.0)
        big = torch.abs(qq) > eps
        den2 = torch.where(big, qq, 1.0)
        ok = quad & (disc > 0)
        r1 = torch.where(ok, qq / den1, 2.0)
        r2 = torch.where(ok & big, c0 / den2, 2.0)
        lin = ~quad & (torch.abs(c1) > eps)
        r1 = torch.where(lin, -c0 / torch.where(lin, c1, 1.0), r1)
        roots = torch.stack([r1, r2], dim=-1)
        valid = (roots > 0.0) & (roots < 1.0)
        return torch.where(valid, roots, 1.0), valid
    flat = c.reshape(-1, p + 1).cpu().numpy()
    roots = np.full((flat.shape[0], p), 1.0)
    valid = np.zeros((flat.shape[0], p), bool)
    for i, ci in enumerate(flat):
        rr = np.roots(ci[::-1])
        rr = rr[np.abs(rr.imag) < 1e-10].real
        rr = rr[(rr > 0.0) & (rr < 1.0)]
        roots[i, :len(rr)] = rr[:p]
        valid[i, :len(rr)] = True
    shape = c.shape[:-1] + (p,)
    return (torch.as_tensor(roots, dtype=c.dtype,
                            device=c.device).reshape(shape),
            torch.as_tensor(valid, device=c.device).reshape(shape))


def _poly_eval(c, t):
    """sum c_i t^i; c: (..., p+1) broadcast against t: (...)."""
    out = torch.zeros(torch.broadcast_shapes(c.shape[:-1], t.shape),
                      dtype=c.dtype, device=c.device)
    for i in range(c.shape[-1] - 1, -1, -1):
        out = out * t + c[..., i]
    return out


def _segments(roots):
    """Sorted segment bounds from padded roots: (..., R) -> lo, hi of
    shape (..., R+1)."""
    shape = roots.shape[:-1] + (1,)
    bnd = torch.cat([torch.zeros(shape, dtype=roots.dtype,
                                 device=roots.device),
                     torch.sort(roots, dim=-1).values,
                     torch.ones(shape, dtype=roots.dtype,
                                device=roots.device)], dim=-1)
    return bnd[..., :-1], bnd[..., 1:]


def _trim_sorted_roots(roots, valid):
    """Sort padded roots ascending and drop all-padding columns.

    Valid roots are < 1.0, padding slots are exactly 1.0, so sorting
    moves every valid root ahead of the padding; keeping the max valid
    count across the group preserves every real split point while
    removing zero-length segments."""
    roots = torch.sort(roots, dim=-1).values
    nv = int(valid.reshape(valid.shape[0], -1).sum(-1).max()) \
        if valid.numel() else 0
    return roots[..., :max(nv, 0)]


def _split_base(mesh, el, dofs, k, order, lo, hi):
    """Base rule of one box group, with lines split at the k-face zero
    sets.

    dofs: (Cg, nd); lo, hi: (Cg, d) box corners in cell reference
    coordinates (tensors). Returns (base_pts (Cg, NB, d) in CELL coords
    with the k coordinate unset, base_w (Cg, NB) in CELL-coordinate
    measure). The base integrand of the dimension-reduction quadrature is
    smooth except where phi vanishes on the k-faces of the box; base
    lines are split at those roots. In 3D the OUTER axis is also split at
    the zero crossings of phi on the four box edges along it (the
    boundary of the 2D face problem), Saye's recursion.
    """
    d = mesh.tdim
    p = el.degree
    n1 = _npts_1d(order)
    gx_np, gw_np = gauss_legendre(n1)
    dt, dev = dofs.dtype, dofs.device
    gx = torch.as_tensor(gx_np, dtype=dt, device=dev)
    gw = torch.as_tensor(gw_np, dtype=dt, device=dev)
    ts_np = _fit_nodes(p)
    ts = torch.as_tensor(ts_np, dtype=dt, device=dev)
    T = len(ts_np)
    Cg = dofs.shape[0]
    other = [a for a in range(d) if a != k]
    ext = hi - lo                                   # (Cg, d)

    if d == 2:
        j = other[0]
        # face restrictions phi(b, t) for t in {lo_k, hi_k}: box-param b
        spts = torch.zeros((Cg, T, 2, d), dtype=dt, device=dev)
        spts[..., j] = (lo[:, None, j]
                        + ts[None, :] * ext[:, None, j])[..., None]
        spts[..., 0, k] = lo[:, None, k]
        spts[..., 1, k] = hi[:, None, k]
        tab = el.tabulate(spts)                     # (Cg, p+1, 2, nd)
        vals = torch.einsum("ctfn,cn->cft", tab, dofs)  # (Cg, 2, p+1)
        coef = _poly_coeffs(vals, ts_np)
        roots, rv = _roots_in_unit(coef)            # (Cg, 2, p)
        roots = _trim_sorted_roots(roots.reshape(Cg, 2 * p),
                                   rv.reshape(Cg, 2 * p))
        lo_s, hi_s = _segments(roots)
        Sb = roots.shape[-1] + 1
        ln = hi_s - lo_s                            # (Cg, Sb) box-param
        b = lo_s[..., None] + ln[..., None] * gx    # (Cg, Sb, n1)
        w = ln[..., None] * gw * ext[:, None, None, j]
        NB = Sb * n1
        pts = torch.zeros((Cg, NB, d), dtype=dt, device=dev)
        pts[:, :, j] = (lo[:, None, j]
                        + b.reshape(Cg, NB) * ext[:, None, j])
        return pts, w.reshape(Cg, NB)

    j1, j2 = other                                  # outer, inner axes
    # recursed outer split: roots of phi on the 4 box edges along j1
    # ((j2, k) in {lo,hi}^2) bound where the face interfaces exit
    # through the base boundary
    epts = torch.zeros((Cg, T, 2, 2, d), dtype=dt, device=dev)
    epts[..., j1] = (lo[:, None, j1]
                     + ts[None, :] * ext[:, None, j1])[..., None, None]
    epts[..., 0, :, j2] = lo[:, None, None, j2]
    epts[..., 1, :, j2] = hi[:, None, None, j2]
    epts[..., 0, k] = lo[:, None, None, k]
    epts[..., 1, k] = hi[:, None, None, k]
    tab_e = el.tabulate(epts)                       # (Cg, p+1, 2, 2, nd)
    vals_e = torch.einsum("ctefn,cn->ceft", tab_e, dofs)
    er, ev = _roots_in_unit(_poly_coeffs(vals_e, ts_np))  # (Cg, 2, 2, p)
    er = _trim_sorted_roots(er.reshape(Cg, 4 * p), ev.reshape(Cg, 4 * p))
    lo_o, hi_o = _segments(er)                      # (Cg, So) box-param
    So = er.shape[-1] + 1
    ln_o = hi_o - lo_o
    a_box = (lo_o[..., None] + ln_o[..., None] * gx).reshape(Cg, So * n1)
    awt = (ln_o[..., None] * gw).reshape(Cg, So * n1) \
        * ext[:, None, j1]                          # cell measure
    a = lo[:, None, j1] + a_box * ext[:, None, j1]  # cell coords
    NO = So * n1                                    # outer points/box

    # phi(a_ci, b, t) restrictions in b for t in {lo_k, hi_k}
    spts = torch.zeros((Cg, NO, T, 2, d), dtype=dt, device=dev)
    spts[..., j1] = a[:, :, None, None]
    spts[..., j2] = (lo[:, None, None, j2]
                     + ts[None, None, :] * ext[:, None, None, j2])[
        ..., None]
    spts[..., 0, k] = lo[:, None, None, k]
    spts[..., 1, k] = hi[:, None, None, k]
    tab = el.tabulate(spts)                         # (Cg, NO, p+1, 2, nd)
    vals = torch.einsum("cotfn,cn->coft", tab, dofs)  # (Cg, NO, 2, p+1)
    coef = _poly_coeffs(vals, ts_np)
    roots, rv = _roots_in_unit(coef)                # (Cg, NO, 2, p)
    roots = roots.reshape(Cg, NO, 2 * p)
    rv = rv.reshape(Cg, NO, 2 * p)
    roots = torch.sort(roots, dim=-1).values
    nvi = int(rv.sum(-1).max()) if rv.numel() else 0
    roots = roots[..., :nvi]
    Sb = roots.shape[-1] + 1
    lo_s, hi_s = _segments(roots)
    ln = hi_s - lo_s                                # (Cg, NO, Sb)
    b = lo_s[..., None] + ln[..., None] * gx        # (Cg, NO, Sb, n1)
    w = ln[..., None] * gw * awt[:, :, None, None] \
        * ext[:, None, None, None, j2]
    NB = NO * Sb * n1
    pts = torch.zeros((Cg, NO, Sb, n1, d), dtype=dt, device=dev)
    pts[..., j1] = a[:, :, None, None]
    pts[..., j2] = (lo[:, None, None, None, j2]
                    + b * ext[:, None, None, None, j2])
    return pts.reshape(Cg, NB, d), w.reshape(Cg, NB)


def _line_values(el, dofs, base_pts, k, lok, extk):
    """Sample phi along the height lines of a box group: coefficient
    array (Cg, NB, p+1) of the degree-p restriction (in the box height
    parameter t in [0,1], cell coordinate lok + t extk) at every base
    point."""
    p = el.degree
    ts_np = _fit_nodes(p)
    ts = torch.as_tensor(ts_np, dtype=dofs.dtype, device=dofs.device)
    Cg, NB, d = base_pts.shape
    pts = base_pts[:, :, None, :].expand(Cg, NB, len(ts_np), d).clone()
    pts[..., k] = (lok[:, None, None]
                   + ts[None, None, :] * extk[:, None, None])
    tab = el.tabulate(pts)                          # (Cg, NB, p+1, nd)
    vals = torch.einsum("cbtn,cn->cbt", tab, dofs)
    return _poly_coeffs(vals, ts_np), pts


def _detJ(mesh, cells, pts):
    """|det J| of the (bi/tri)linear cell map at per-cell reference
    points. pts: (C, Np, d) -> (|det J| (C, Np), J)."""
    el1 = lagrange_element(mesh.cell_type, 1)
    dphi = el1.tabulate_grad(pts)
    coords = torch.as_tensor(mesh.cell_vertex_coords[cells],
                             dtype=pts.dtype, device=pts.device)
    J = torch.einsum("cvg,cpvd->cpgd", coords, dphi)
    if J.shape[-2] == J.shape[-1]:
        return torch.abs(torch.linalg.det(J)), J
    G = torch.einsum("cpgd,cpge->cpde", J, J)
    return torch.sqrt(torch.abs(torch.linalg.det(G))), J


def _merge_rows(C, d, outs, dtype, device, with_normals=False, gdim=None):
    """Concatenate per-group padded outputs (rows, pts, w[, normals])
    into shared (C, Qmax, ...) tensors, each row's blocks in the order
    they come; rows may repeat across AND within groups (one row per
    box). The slots are computed on the host from the row lists."""
    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    if not outs:
        if with_normals:
            return zeros(C, 1, d), zeros(C, 1), zeros(C, 1, gdim)
        return zeros(C, 1, d), zeros(C, 1)
    counts = np.zeros(C, np.int64)
    for o in outs:
        np.add.at(counts, o[0], o[1].shape[1])
    Qmax = max(int(counts.max()), 1)
    points = zeros(C, Qmax, d)
    weights = zeros(C, Qmax)
    normals = zeros(C, Qmax, gdim) if with_normals else None
    cursor = np.zeros(C, np.int64)
    for o in outs:
        rows = np.asarray(o[0], np.int64)
        q = o[1].shape[1]
        # a row's k-th box in this block starts k blocks after its cursor
        order = np.argsort(rows, kind="stable")
        srt = rows[order]
        first = np.searchsorted(srt, srt, "left")
        rank = np.empty_like(rows)
        rank[order] = np.arange(len(rows)) - first
        start = cursor[rows] + q * rank
        np.add.at(cursor, rows, q)
        ri = torch.as_tensor(rows, device=device)[:, None].expand(-1, q)
        ci = (torch.as_tensor(start, device=device)[:, None]
              + torch.arange(q, device=device)[None, :])
        points[ri, ci] = o[1].to(dtype)
        weights[ri, ci] = o[2].to(dtype)
        if with_normals:
            normals[ri, ci] = o[3].to(dtype)
    if with_normals:
        return points, weights, normals
    return points, weights


def _grouped(mesh, phi, cut_cells):
    """The host grouping with its stats, and the cut cells' dofs on the
    device in f64."""
    t0 = time.perf_counter()
    groups, uniform, fallback = _box_groups(mesh, phi, cut_cells)
    stats = _group_stats(groups, uniform, fallback,
                         time.perf_counter() - t0)
    return groups, uniform, fallback, stats, _device_dofs(phi, cut_cells)


def saye_volume_rules(mesh, phi, cut_cells, order, side="<"):
    """Padded volume rules for {phi < 0} / {phi > 0} on cut quad/hex
    cells by dimension-reduction quadrature. Cells where the interface is
    not a well-conditioned height graph are recursively subdivided into
    boxes (_box_groups); residual non-graph cells fall back to red-refined
    marching. The rules carry ``saye_stats`` (see _group_stats)."""
    _validate_host(mesh)
    d = mesh.tdim
    V = phi.function_space
    el = V.element
    p = V.degree
    cut_cells = np.asarray(cut_cells, dtype=np.int32)
    C = len(cut_cells)
    dev = phi.x.device
    n1 = _npts_1d(order)
    gx_np, gw_np = gauss_legendre(n1)
    gx = torch.as_tensor(gx_np, dtype=F64, device=dev)
    gw = torch.as_tensor(gw_np, dtype=F64, device=dev)
    S = p + 1
    sgn = 1.0 if side == "<" else -1.0

    groups, uniform, fallback, stats, dofs_all = _grouped(mesh, phi,
                                                          cut_cells)
    outs = []
    # uniform boxes on the requested side: plain tensor Gauss rule
    ug = np.meshgrid(*([gx_np] * d), indexing="ij")
    upts = torch.as_tensor(np.stack([g.ravel() for g in ug], -1),
                           dtype=F64, device=dev)          # (n1^d, d)
    uw = np.ones(1)
    for _ in range(d):
        uw = np.multiply.outer(uw, gw_np)
    uw = torch.as_tensor(uw.reshape(-1), dtype=F64, device=dev)
    for usgn, rows, lo_np, hi_np in uniform:
        if usgn != side:
            continue
        lo = torch.as_tensor(lo_np, dtype=F64, device=dev)
        hi = torch.as_tensor(hi_np, dtype=F64, device=dev)
        pts = lo[:, None, :] + upts[None] * (hi - lo)[:, None, :]
        w = uw[None] * torch.prod(hi - lo, dim=1)[:, None]
        det, _ = _detJ(mesh, cut_cells[rows], pts)
        outs.append((rows, pts, w * det))
    for k, rows, lo_np, hi_np in groups:
        lo = torch.as_tensor(lo_np, dtype=F64, device=dev)
        hi = torch.as_tensor(hi_np, dtype=F64, device=dev)
        dofs = dofs_all[torch.as_tensor(rows, device=dev)]
        extk = (hi - lo)[:, k]
        base_pts, base_w = _split_base(mesh, el, dofs, k, order, lo, hi)
        coef, _ = _line_values(el, dofs, base_pts, k, lo[:, k], extk)
        coef = sgn * coef
        roots, _ = _roots_in_unit(coef)
        lo_s, hi_s = _segments(roots)               # (Cg, NB, S) box-par
        ln = hi_s - lo_s
        mid = 0.5 * (lo_s + hi_s)
        use = (_poly_eval(coef[..., None, :], mid) < 0.0) & (ln > 1e-14)
        tq = lo_s[..., None] + ln[..., None] * gx   # (Cg, NB, S, n1)
        wq = use[..., None] * ln[..., None] * gw \
            * base_w[:, :, None, None] * extk[:, None, None, None]
        Cg, NBg = base_pts.shape[:2]
        pts = base_pts[:, :, None, None, :].expand(
            Cg, NBg, S, n1, d).clone()
        pts[..., k] = (lo[:, None, None, None, k]
                       + tq * extk[:, None, None, None])
        Qmax = NBg * S * n1
        pts = pts.reshape(Cg, Qmax, d)
        wq = wq.reshape(Cg, Qmax)
        det, _ = _detJ(mesh, cut_cells[rows], pts)
        outs.append((rows, pts, wq * det))
    if fallback.size:
        fbr = volume_rules(mesh, phi, cut_cells[fallback], order,
                           side=side, levels=_FALLBACK_LEVELS)
        outs.append((fallback, fbr.points_padded, fbr.weights_padded))
    points, weights = _merge_rows(C, d, outs, phi.x.dtype, dev)
    rules = RuntimeQuadratureRules(d, cut_cells, points, weights, mesh=mesh)
    rules.saye_stats = stats
    return rules


def saye_interface_rules(mesh, phi, cut_cells, order):
    """Padded interface ({phi = 0}) rules on cut quad/hex cells: surface
    points are the exact line roots, weighted by the graph factor
    |grad phi|/|d_k phi| and the Nanson surface transform
    |det J| |J^-T n_ref|; geometric normals along grad(phi) (outward
    from {phi<0}, as interface_rules). The rules carry ``saye_stats``."""
    _validate_host(mesh)
    d = mesh.tdim
    V = phi.function_space
    el = V.element
    p = V.degree
    cut_cells = np.asarray(cut_cells, dtype=np.int32)
    C = len(cut_cells)
    dev = phi.x.device
    gdim = mesh.gdim

    # uniform (sign-definite) boxes carry no interface points
    groups, _, fallback, stats, dofs_all = _grouped(mesh, phi, cut_cells)
    outs = []
    for k, rows, lo_np, hi_np in groups:
        lo = torch.as_tensor(lo_np, dtype=F64, device=dev)
        hi = torch.as_tensor(hi_np, dtype=F64, device=dev)
        dofs = dofs_all[torch.as_tensor(rows, device=dev)]
        extk = (hi - lo)[:, k]
        base_pts, base_w = _split_base(mesh, el, dofs, k, order, lo, hi)
        coef, _ = _line_values(el, dofs, base_pts, k, lo[:, k], extk)
        roots, valid = _roots_in_unit(coef)         # (Cg, NB, p) box-par
        Cg, NBg = base_pts.shape[:2]
        pts = base_pts[:, :, None, :].expand(Cg, NBg, p, d).clone()
        pts[..., k] = (lo[:, None, None, k]
                       + roots * extk[:, None, None])
        Qmax = NBg * p
        pts = pts.reshape(Cg, Qmax, d)
        gtab = el.tabulate_grad(pts)                # (Cg, Q, nd, d)
        gref = torch.einsum("cqnd,cn->cqd", gtab, dofs)
        gnorm = torch.linalg.norm(gref, dim=-1)
        dk = torch.abs(gref[..., k])
        trans = valid.reshape(Cg, Qmax) & (dk > 1e-12)
        graph = torch.where(trans, gnorm / torch.where(trans, dk, 1.0),
                            0.0)
        wref = base_w[:, :, None].expand(Cg, NBg, p).reshape(Cg, Qmax) \
            * graph
        det, J = _detJ(mesh, cut_cells[rows], pts)
        nref = gref / torch.clamp(gnorm, min=1e-30)[..., None]
        Jinv = torch.linalg.inv(J)
        cov = torch.einsum("cqdg,cqd->cqg", Jinv, nref)
        covn = torch.linalg.norm(cov, dim=-1)
        nphys = cov / torch.clamp(covn, min=1e-30)[..., None]
        outs.append((rows, pts, wref * det * covn,
                     torch.where(trans[..., None], nphys, 0.0)))
    if fallback.size:
        fbr = interface_rules(mesh, phi, cut_cells[fallback], order,
                              levels=_FALLBACK_LEVELS)
        outs.append((fallback, fbr.points_padded, fbr.weights_padded,
                     fbr.normals_padded))
    points, weights, normals = _merge_rows(C, d, outs, phi.x.dtype, dev,
                                           with_normals=True, gdim=gdim)
    rules = RuntimeQuadratureRules(d, cut_cells, points, weights, mesh=mesh,
                                   normals_padded=normals)
    rules.saye_stats = stats
    return rules
