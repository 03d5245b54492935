"""Plain reference of the cut-Poisson step on create_box's Freudenthal tets.

torch and numpy only, and nothing of the program under test. From the
benchmark's own inputs (the lattice size n, the sphere's centre and
radius, the level set's degree and dtype, the form constants and the load
modes) it works out again what the program derives:

- each cell's class against the level set (inside, outside or cut: all of
  its level-set nodes below zero, all above, or neither);
- the cut cells' rules for {phi < 0} and {phi = 0}: the marching-tet parts
  of the linear interpolant of the vertex values (the standard wedge
  split), each mapped as a P2 sub-simplex. With the curved cut
  (``cut_approximation_order`` 2 on a P2 level set) the edge crossings sit
  on the zero set of the true level set and every part edge between two
  crossings has its midpoint projected onto it along the reference-space
  gradient; otherwise the parts are straight. The rules are collapsed
  Gauss-Legendre rules of higher degree than the program's;
- the Nitsche + ghost-penalty P2 form of ``bench.py``: its load vector and
  its operator, as element matrices on the active cells and ghost facets.

Vectors live on the P2 nodes, which are the half lattice (2n + 1)^3 of the
box: node (X, Y, Z) sits at (x_X, y_Y, z_Z), with x_{2i} the i-th vertex
coordinate and x_{2i+1} the midpoint of two.

``store`` rounds what each stage produces to the precision it is kept in:
the identity for the reference (float64), bfloat16 for the control, which
computes in float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# create_box: cube (i, j, k) with i slowest; hex corner v = di + 2 dj + 4 dk;
# six tets per cube along the 0-7 diagonal, in this order (cell = 6 cube + t)
CORNERS = np.array([[v & 1, (v >> 1) & 1, (v >> 2) & 1] for v in range(8)])
SPLIT = np.array([[0, 1, 3, 7], [0, 3, 2, 7], [0, 2, 6, 7], [0, 6, 4, 7],
                  [0, 4, 5, 7], [0, 5, 1, 7]])
TET_OFF = CORNERS[SPLIT]                                   # (6, 4, 3)
TET_EDGES = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))
TRI_EDGES = ((0, 1), (0, 2), (1, 2))
# half-lattice offsets of a tet type's 10 P2 nodes from 2 * cube
NODE_OFF = np.concatenate(
    [2 * TET_OFF, np.stack([TET_OFF[:, a] + TET_OFF[:, b]
                            for a, b in TET_EDGES], 1)], 1)   # (6, 10, 3)
REF_TET = np.array([[0., 0., 0.], [1., 0., 0.], [0., 1., 0.], [0., 0., 1.]])
NEWTON_STEPS = 12
INSIDE, OUTSIDE, CUT = 0, 1, 2


def sphere(center, radius):
    """The level set |x - center| - radius, as ``fn(x)`` with x (3, N)."""
    cx, cy, cz = (float(c) for c in center)
    r = float(radius)

    def fn(x):
        return np.sqrt((x[0] - cx) ** 2 + (x[1] - cy) ** 2
                       + (x[2] - cz) ** 2) - r
    return fn


def manufactured(mode):
    """(ue, f) of u = sin(a pi x) sin(b pi y) sin(c pi z), -lap u = f, as
    torch functions of physical points (..., 3)."""
    a, b, c = (float(m) for m in mode)

    def ue(x):
        return (torch.sin(a * math.pi * x[..., 0])
                * torch.sin(b * math.pi * x[..., 1])
                * torch.sin(c * math.pi * x[..., 2]))

    k2 = (a * a + b * b + c * c) * math.pi ** 2
    return ue, (lambda x: k2 * ue(x))


def simplex_rule(dim, npts):
    """Collapsed Gauss-Legendre rule on the reference simplex: exact to
    degree 2 npts - 1 - (dim - 1). Returns (points (q, dim), weights)."""
    x, w = np.polynomial.legendre.leggauss(npts)
    x, w = 0.5 * (x + 1.0), 0.5 * w
    if dim == 2:
        a, b = np.meshgrid(x, x, indexing="ij")
        wa, wb = np.meshgrid(w, w, indexing="ij")
        pts = np.stack([a * (1 - b), b], -1)
        wt = wa * wb * (1 - b)
    else:
        a, b, c = np.meshgrid(x, x, x, indexing="ij")
        wa, wb, wc = np.meshgrid(w, w, w, indexing="ij")
        pts = np.stack([a * (1 - b) * (1 - c), b * (1 - c), c], -1)
        wt = wa * wb * wc * (1 - b) * (1 - c) ** 2
    return pts.reshape(-1, dim), wt.reshape(-1)


def cut_rule(dim, order):
    """The published rule of a cut part for rule order 4 (the cut rules of
    the configuration): Keast's 15-point degree-5 rule on tets, Dunavant's
    6-point degree-4 rule on triangles. Returns (points (q, dim), weights)
    on the reference simplex."""
    if order != 4:
        raise ValueError(f"no reference cut rule of order {order}")
    if dim == 2:
        a1, a2 = 0.445948490915965, 0.091576213509771
        w1, w2 = 0.223381589678011, 0.109951743655322
        pts = [[a1, a1], [1 - 2 * a1, a1], [a1, 1 - 2 * a1],
               [a2, a2], [1 - 2 * a2, a2], [a2, 1 - 2 * a2]]
        return np.array(pts), 0.5 * np.array([w1] * 3 + [w2] * 3)
    pts, wts = [[0.25, 0.25, 0.25]], [0.030283678097089]
    for a, b, w in ((1 / 3, 0.0, 0.006026785714286),
                    (1 / 11, 8 / 11, 0.011645249086029)):
        for p in ([b, a, a], [a, b, a], [a, a, b], [a, a, a]):
            pts.append(p)
            wts.append(w)
    a, b = 0.066550153573664, 0.433449846426336
    for p in ([a, a, b], [a, b, a], [b, a, a], [a, b, b], [b, a, b],
              [b, b, a]):
        pts.append(p)
        wts.append(0.010949141561386)
    return np.array(pts), np.array(wts)


def p2_shapes(xi):
    """P2 shape functions of the reference simplex of dim k = xi.shape[-1]
    at points xi (..., k), nodes [vertices, then edges (a < b) in
    lexicographic order]: (N (..., nn), dN (..., nn, k))."""
    k = xi.shape[-1]
    lam = torch.cat([1.0 - xi.sum(-1, keepdim=True), xi], -1)
    dlam = torch.cat([-torch.ones(1, k, dtype=xi.dtype, device=xi.device),
                      torch.eye(k, dtype=xi.dtype, device=xi.device)], 0)
    edges = TET_EDGES if k == 3 else TRI_EDGES
    N = [lam[..., i] * (2 * lam[..., i] - 1) for i in range(k + 1)]
    dN = [(4 * lam[..., i] - 1)[..., None] * dlam[i] for i in range(k + 1)]
    for a, b in edges:
        N.append(4 * lam[..., a] * lam[..., b])
        dN.append(4 * (lam[..., a, None] * dlam[b]
                       + lam[..., b, None] * dlam[a]))
    return torch.stack(N, -1), torch.stack(dN, -2)


def p1_shapes(xi):
    lam = torch.cat([1.0 - xi.sum(-1, keepdim=True), xi], -1)
    k = xi.shape[-1]
    dlam = torch.cat([-torch.ones(1, k, dtype=xi.dtype, device=xi.device),
                      torch.eye(k, dtype=xi.dtype, device=xi.device)], 0)
    return lam, dlam.expand(*xi.shape[:-1], k + 1, k)


def _cut_tables():
    """Marching-tet parts per vertex sign case (bit i: vertex i inside):
    volume parts (16, 3, 4) and interface parts (16, 2, 3) over the nodes
    0-3 (vertices) and 4 + e (the crossing on TET_EDGES[e]); -1 pads."""
    def e(a, b):
        return 4 + TET_EDGES.index((min(a, b), max(a, b)))
    vol = -np.ones((16, 3, 4), np.int64)
    srf = -np.ones((16, 2, 3), np.int64)
    for case in range(16):
        ins = [i for i in range(4) if case >> i & 1]
        out = [i for i in range(4) if not case >> i & 1]
        V, S = [], []
        if len(ins) == 4:
            V = [(0, 1, 2, 3)]
        elif len(ins) == 1:
            a, (b, c, d) = ins[0], out
            V = [(a, e(a, b), e(a, c), e(a, d))]
            S = [(e(a, b), e(a, c), e(a, d))]
        elif len(ins) == 3:
            a, (b, c, d) = out[0], ins
            tb, tc, td = e(a, b), e(a, c), e(a, d)
            V = [(b, c, d, tb), (c, d, tb, tc), (d, tb, tc, td)]
            S = [(tb, tc, td)]
        elif len(ins) == 2:
            (a, b), (c, d) = ins, out
            ac, ad, bc, bd = e(a, c), e(a, d), e(b, c), e(b, d)
            V = [(a, ac, ad, b), (ac, ad, b, bc), (ad, b, bc, bd)]
            S = [(ac, bc, bd), (ac, bd, ad)]
        for k, part in enumerate(V):
            vol[case, k] = part
        for k, part in enumerate(S):
            srf[case, k] = part
    return vol, srf


VOL_TABLE, SRF_TABLE = _cut_tables()


class Problem:
    """The reference's whole step at one position of the level set.

    cfg: the configuration (n, phi_degree, phi_dtype, curved, gamma,
    ghost_penalty, degree); center: the sphere's centre; loads: the load
    modes (a, b, c) whose vectors are assembled."""

    def __init__(self, cfg, center, loads, *, device, dtype=torch.float64,
                 store=None):
        self.n = n = int(cfg["n"])
        self.s = 2.0 / n
        self.dev, self.dt = torch.device(device), dtype
        self.store = store or (lambda t: t)
        self.degree_phi = int(cfg["level_set"]["degree"])
        self.curved = bool(cfg["cut"].get("cut_approximation_order", 1) >= 2
                           and self.degree_phi >= 2)
        self.order = int(cfg["cut"]["rule_order"])
        self.gamma = float(cfg["forms"]["nitsche_gamma"])
        self.ghost = float(cfg["forms"]["ghost_penalty"])
        self.h = self.s * math.sqrt(3.0)      # CellDiameter: the cube diagonal
        self.M = 2 * n + 1
        self.radius = float(cfg["level_set"]["radius"])
        self.center = tuple(float(c) for c in center)
        # geometry of the six tet types: Jacobians and their inverses
        J = torch.as_tensor(((TET_OFF[:, 1:] - TET_OFF[:, :1]) * self.s)
                            .transpose(0, 2, 1), dtype=dtype,
                            device=self.dev)                # (6, 3, 3)
        self.J, self.Jinv = J, torch.linalg.inv(J)
        self.detJ = torch.abs(torch.linalg.det(J))
        self._level_set(cfg)
        self._classify()
        self._rules()
        self._operator()
        self.loads = [self._load(m) for m in loads]

    # -- inputs ------------------------------------------------------------

    def _level_set(self, cfg):
        """Level-set node values: the sphere evaluated in float64 on the
        create_box coordinates, kept in the configuration's dtype."""
        n = self.n
        x = np.linspace(-1.0, 1.0, n + 1)
        if self.degree_phi == 2:
            half = np.empty(2 * n + 1)
            half[0::2] = x
            half[1::2] = 0.5 * x[:-1] + 0.5 * x[1:]
            x = half
        X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
        vals = sphere(self.center, self.radius)(
            (X.ravel(), Y.ravel(), Z.ravel())).reshape(X.shape)
        kept = torch.as_tensor(vals).to(getattr(torch, cfg["level_set"]
                                                ["dtype"]))
        self.phi_nodes = self.store(kept.to(self.dev).to(self.dt))

    def _node_values(self, off, cubes=None):
        """Level-set values at one node of every cube's tet (``off``, in
        the level set's lattice), as (n, n, n), or at ``cubes`` (C, 3)."""
        P, n = self.phi_nodes, self.n
        step = 2 if self.degree_phi == 2 else 1
        if cubes is None:
            o = [int(v) for v in off]
            return P[o[0]:o[0] + step * n:step, o[1]:o[1] + step * n:step,
                     o[2]:o[2] + step * n:step]
        idx = step * cubes + torch.as_tensor(off, device=self.dev)
        return P[idx[..., 0], idx[..., 1], idx[..., 2]]

    def _cell_phi(self, cubes, types):
        """(C, 4) vertex values and (C, nn) node values of cells."""
        nodes = NODE_OFF if self.degree_phi == 2 else TET_OFF
        off = torch.as_tensor(nodes, device=self.dev)[types]    # (C, nn, 3)
        step = 2 if self.degree_phi == 2 else 1
        idx = step * cubes[:, None, :] + off
        vals = self.phi_nodes[idx[..., 0], idx[..., 1], idx[..., 2]]
        return vals[:, :4], vals

    # -- classification ----------------------------------------------------

    def _classify(self):
        n = self.n
        nodes = NODE_OFF if self.degree_phi == 2 else TET_OFF
        codes = torch.empty((n, n, n, 6), dtype=torch.int8, device=self.dev)
        for t in range(6):
            neg = torch.ones((n, n, n), dtype=torch.bool, device=self.dev)
            pos = neg.clone()
            for off in nodes[t]:
                v = self._node_values(off)
                neg &= v < 0
                pos &= v > 0
            c = torch.full((n, n, n), CUT, dtype=torch.int8, device=self.dev)
            c[neg] = INSIDE
            c[pos] = OUTSIDE
            codes[..., t] = c
        self.codes = codes.reshape(-1)                 # cell = 6 cube + t
        self.inside = torch.nonzero(self.codes == INSIDE).reshape(-1)
        self.cut = torch.nonzero(self.codes == CUT).reshape(-1)
        # full cubes: all six tets inside (the interior stencil's cubes)
        self.full_cubes = (codes == INSIDE).all(-1)

    def _cells(self, cells):
        """(cube lattice coords (C, 3), types (C,)) of cell indices."""
        n = self.n
        cube, t = cells // 6, cells % 6
        return torch.stack([cube // (n * n), (cube // n) % n, cube % n],
                           -1), t

    def dofs(self, cells):
        """(C, 10) half-lattice node indices of cells' P2 nodes."""
        cubes, t = self._cells(cells)
        idx = 2 * cubes[:, None, :] + torch.as_tensor(
            NODE_OFF, device=self.dev)[t]
        M = self.M
        return (idx[..., 0] * M + idx[..., 1]) * M + idx[..., 2]

    def origin(self, cells):
        cubes, t = self._cells(cells)
        v0 = cubes + torch.as_tensor(TET_OFF[:, 0], device=self.dev)[t]
        return -1.0 + self.s * v0.to(self.dt), t

    # -- cut rules ---------------------------------------------------------

    def _phi_at(self, fnodes, xi):
        """Level set and its reference gradient at xi (C, P, 3)."""
        if self.degree_phi == 2:
            N, dN = p2_shapes(xi)
        else:
            N, dN = p1_shapes(xi)
        return (torch.einsum("cpn,cn->cp", N, fnodes),
                torch.einsum("cpnt,cn->cpt", dN, fnodes))

    def _march(self, fv, fnodes, table):
        """Parts of the {phi < 0} region (``table`` VOL_TABLE) or of the
        interface (SRF_TABLE) as P2 node sets (C, M, nn, 3) in the cell's
        reference coordinates, and which parts exist (C, M)."""
        C = fv.shape[0]
        R = torch.as_tensor(REF_TET, dtype=self.dt, device=self.dev)
        a = [e[0] for e in TET_EDGES]
        b = [e[1] for e in TET_EDGES]
        fa, fb = fv[:, a], fv[:, b]
        den = fa - fb
        t = torch.where(den.abs() > 1e-300, fa / torch.where(
            den.abs() > 1e-300, den, 1.0), 0.5).clamp(0.0, 1.0)
        va, d = R[a][None], (R[b] - R[a])[None]
        if self.curved:     # crossings on the zero set of the true level set
            for _ in range(NEWTON_STEPS):
                p = va + t[..., None] * d
                g, dg = self._phi_at(fnodes, p)
                dgd = (dg * d).sum(-1)
                ok = dgd.abs() > 1e-300
                tn = t - torch.where(ok, g / torch.where(ok, dgd, 1.0), 0.0)
                t = torch.where(torch.isfinite(tn), tn, t).clamp(0.0, 1.0)
        nodes = torch.cat([R[None].expand(C, 4, 3), va + t[..., None] * d], 1)
        case = sum((fv[:, i] < 0).long() << i for i in range(4))
        ids = torch.as_tensor(table, device=self.dev)[case]     # (C, M, m)
        valid = ids[..., 0] >= 0
        X = nodes[torch.arange(C, device=self.dev)[:, None, None],
                  ids.clamp(min=0)]                             # (C,M,m,3)
        edges = TET_EDGES if X.shape[2] == 4 else TRI_EDGES
        ea = [e[0] for e in edges]
        eb = [e[1] for e in edges]
        Xa, Xb = X[:, :, ea], X[:, :, eb]
        mid = 0.5 * (Xa + Xb)
        if self.curved:
            on = (ids[:, :, ea] >= 4) & (ids[:, :, eb] >= 4)
            Mp = mid.shape[1] * mid.shape[2]
            p = mid.reshape(C, Mp, 3)
            for _ in range(NEWTON_STEPS):
                f, g = self._phi_at(fnodes, p)
                gg = (g * g).sum(-1)
                step = torch.where(gg > 1e-300,
                                   f / torch.where(gg > 0, gg, 1.0), 0.0)
                pn = p - step[..., None] * g
                p = torch.where(torch.isfinite(pn).all(-1, keepdim=True),
                                pn, p)
            p = p.reshape(mid.shape)
            near = ((p - mid) ** 2).sum(-1) <= \
                0.25 * ((Xb - Xa) ** 2).sum(-1) + 1e-30
            keep = on & near & torch.isfinite(p).all(-1)
            mid = torch.where(keep[..., None], p, mid)
        return torch.cat([X, mid], 2), valid

    def _part_rule(self, P, valid, types, order):
        """Points (C, M*q, 3) in cell reference coordinates, physical
        weights (C, M*q) and, for interface parts, unit normals of the
        part (C, M*q, 3, unoriented) of the parts P."""
        k = 2 if P.shape[2] == 6 else 3
        rp, rw = cut_rule(k, order)
        rp = torch.as_tensor(rp, dtype=self.dt, device=self.dev)
        rw = torch.as_tensor(rw, dtype=self.dt, device=self.dev)
        N, dN = p2_shapes(rp)                           # (q, nn), (q, nn, k)
        xi = torch.einsum("qn,cmnt->cmqt", N, P)
        T = torch.einsum("qnk,cmnt->cmqtk", dN, P)
        G = torch.einsum("cst,cmqtk->cmqsk", self.J[types], T)
        if k == 3:
            w = rw * torch.abs(torch.linalg.det(G))
        else:
            gram = torch.einsum("cmqsk,cmqsl->cmqkl", G, G)
            w = rw * torch.sqrt(torch.abs(torch.linalg.det(gram)))
        w = torch.where(valid[:, :, None], w, 0.0)
        C = P.shape[0]
        return xi.reshape(C, -1, 3), w.reshape(C, -1)

    def _rules(self):
        cubes, types = self._cells(self.cut)
        fv, fn = self._cell_phi(cubes, types)
        self.cut_types, self.cut_fnodes = types, fn
        P, valid = self._march(fv, fn, VOL_TABLE)
        vol = self._part_rule(P, valid, types, self.order)
        P, valid = self._march(fv, fn, SRF_TABLE)
        srf = self._part_rule(P, valid, types, self.order)
        self.vol = tuple(self.store(a) for a in vol)
        self.srf = tuple(self.store(a) for a in srf)

    def physical(self, cells, xi):
        """Physical points of reference points xi (C, P, 3) of cells."""
        x0, t = self.origin(cells)
        return x0[:, None, :] + torch.einsum("cst,cpt->cps", self.J[t], xi)

    def moments(self, cells, xi, w, scale):
        """Integrals of 1, a linear and a quadratic function over each
        cell's rule, over ``scale``: (C, 3)."""
        x = self.physical(cells, xi)
        x0, t = self.origin(cells)
        c = x0 + self.J[t].sum(-1) / 4.0                # centroid
        d = (x - c[:, None, :]) / self.s
        a = torch.as_tensor([0.3, -0.5, 0.8], dtype=x.dtype, device=x.device)
        b = torch.as_tensor([-0.6, 0.2, 0.7], dtype=x.dtype, device=x.device)
        lin = d @ (a / a.norm())
        quad = (d @ (b / b.norm())) ** 2
        g = torch.stack([torch.ones_like(lin), lin, quad], -1)
        return torch.einsum("cp,cpg->cg", w.to(x.dtype), g) / scale

    # -- forms -------------------------------------------------------------

    def _basis(self, types, xi):
        """P2 basis values (C, P, 10) and physical gradients (C, P, 10, 3)
        at reference points xi (C, P, 3) of cells of ``types``."""
        N, dN = p2_shapes(xi)
        return N, torch.einsum("cpnt,cts->cpns", dN, self.Jinv[types])

    def _normal(self, types, fnodes, xi):
        """grad(phi) / |grad(phi)| at reference points of cut cells."""
        _, g = self._phi_at(fnodes, xi)
        g = torch.einsum("cpt,cts->cps", g, self.Jinv[types])
        return g / torch.clamp(g.norm(dim=-1, keepdim=True), min=1e-14)

    def _operator(self):
        dev, dt = self.dev, self.dt
        blocks = []                                  # (dof idx, matrices)
        # inside cells: one stiffness matrix per tet type
        rp, rw = simplex_rule(3, 4)
        rp = torch.as_tensor(rp, dtype=dt, device=dev)
        rw = torch.as_tensor(rw, dtype=dt, device=dev)
        types_in = self.inside % 6
        for t in range(6):
            tt = torch.full((1,), t, device=dev)
            _, G = self._basis(tt, rp[None])
            K = torch.einsum("q,qas,qbs->ab", rw * self.detJ[t], G[0], G[0])
            cells = self.inside[types_in == t]
            blocks.append((self.dofs(cells), self.store(K)[None].expand(
                len(cells), 10, 10)))
        # cut cells: the volume part, then Nitsche on the interface
        types, fn = self.cut_types, self.cut_fnodes
        xi, w = self.vol
        _, G = self._basis(types, xi)
        K = torch.einsum("cp,cpas,cpbs->cab", w, G, G)
        xi, w = self.srf
        N, G = self._basis(types, xi)
        ng = self._normal(types, fn, xi)
        dn = torch.einsum("cpas,cps->cpa", G, ng)
        K = K + torch.einsum("cp,cpab->cab", w, -dn[..., :, None]
                             * N[..., None, :] - N[..., :, None]
                             * dn[..., None, :] + self.gamma / self.h
                             * N[..., :, None] * N[..., None, :])
        blocks.append((self.dofs(self.cut), self.store(K)))
        blocks.append(self._ghost_penalty())
        self.blocks = blocks
        act = torch.zeros(self.M ** 3, dtype=torch.bool, device=dev)
        act[self.dofs(torch.cat([self.inside, self.cut])).reshape(-1)] = True
        self.active = act

    def _ghost_penalty(self):
        """Interior facets of two active cells, one of them cut: the
        facet matrices 0.1 h [grad u . n][grad v . n] over both cells'
        dofs (F, 20), (F, 20, 20)."""
        dev, dt, n = self.dev, self.dt, self.n
        active = torch.cat([self.inside, self.cut])
        cubes, t = self._cells(active)
        vid = cubes[:, None, :] + torch.as_tensor(TET_OFF, device=dev)[t]
        V1 = n + 1
        vid = (vid[..., 0] * V1 + vid[..., 1]) * V1 + vid[..., 2]  # (A, 4)
        keys, cell_of, loc = [], [], []
        for f in range(4):                     # the face opposite vertex f
            others = [v for v in range(4) if v != f]
            tri = torch.sort(vid[:, others], dim=1).values
            keys.append((tri[:, 0] * V1 ** 3 + tri[:, 1]) * V1 ** 3
                        + tri[:, 2])
            cell_of.append(torch.arange(len(active), device=dev))
            loc.append(torch.full((len(active),), f, device=dev))
        keys, cell_of, loc = (torch.cat(keys), torch.cat(cell_of),
                              torch.cat(loc))
        keys, order = torch.sort(keys)
        cell_of, loc = cell_of[order], loc[order]
        pair = torch.nonzero(keys[1:] == keys[:-1]).reshape(-1)
        cp, cm = cell_of[pair], cell_of[pair + 1]
        lp, lm = loc[pair], loc[pair + 1]
        is_cut = self.codes[active] == CUT
        keep = is_cut[cp] | is_cut[cm]
        cp, cm, lp = active[cp[keep]], active[cm[keep]], lp[keep]
        # facet geometry from the + cell: its vertices but the opposite one
        x0, tp = self.origin(cp)
        Vp = x0[:, None, :] + torch.cat(
            [torch.zeros_like(x0)[:, None, :],
             self.J[tp].transpose(1, 2)], 1)                  # (F, 4, 3)
        mask = torch.ones((len(cp), 4), dtype=torch.bool, device=dev)
        mask[torch.arange(len(cp), device=dev), lp] = False
        tri = Vp[mask].reshape(-1, 3, 3)
        opp = Vp[torch.arange(len(cp), device=dev), lp]
        e1, e2 = tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]
        nrm = torch.linalg.cross(e1, e2, dim=-1)
        area2 = nrm.norm(dim=-1)
        nrm = nrm / area2[:, None]
        nrm = torch.where(((opp - tri[:, 0]) * nrm).sum(-1, keepdim=True) > 0,
                          -nrm, nrm)                  # out of the + cell
        rp, rw = simplex_rule(2, 3)
        rp = torch.as_tensor(rp, dtype=dt, device=dev)
        rw = torch.as_tensor(rw, dtype=dt, device=dev)
        x = tri[:, None, 0] + rp[None, :, :1] * e1[:, None] \
            + rp[None, :, 1:] * e2[:, None]                   # (F, q, 3)
        jumps = []
        for cells, sign in ((cp, 1.0), (cm, -1.0)):
            xo, tc = self.origin(cells)
            xi = torch.einsum("cts,cqs->cqt", self.Jinv[tc],
                              x - xo[:, None, :])
            _, G = self._basis(tc, xi)
            jumps.append(sign * torch.einsum("cqas,cs->cqa", G, nrm))
        jmp = torch.cat(jumps, -1)                            # (F, q, 20)
        w = rw[None] * area2[:, None]
        K = self.ghost * self.h * torch.einsum("cq,cqa,cqb->cab", w, jmp, jmp)
        return torch.cat([self.dofs(cp), self.dofs(cm)], 1), self.store(K)

    def _load(self, mode):
        """The load vector of u = sin(a pi x) sin(b pi y) sin(c pi z):
        f v on {phi < 0} plus Nitsche's -(grad v . n) u + gamma / h u v on
        the interface, on the half lattice."""
        dev, dt = self.dev, self.dt
        ue, f = manufactured(mode)
        b = torch.zeros(self.M ** 3, dtype=dt, device=dev)
        rp, rw = simplex_rule(3, 7)
        rp = torch.as_tensor(rp, dtype=dt, device=dev)
        rw = torch.as_tensor(rw, dtype=dt, device=dev)
        N = p2_shapes(rp)[0]
        for blk in torch.split(self.inside, 1 << 15):
            x = self.physical(blk, rp[None].expand(len(blk), -1, -1))
            w = rw * self.detJ[blk % 6][:, None]
            be = torch.einsum("cq,qa->ca", w * f(x), N)
            b.index_add_(0, self.dofs(blk).reshape(-1), self.store(be)
                         .reshape(-1))
        types, fn = self.cut_types, self.cut_fnodes
        xi, w = self.vol
        x = self.physical(self.cut, xi)
        Nc, _ = self._basis(types, xi)
        be = torch.einsum("cp,cpa->ca", w * f(x), Nc)
        xi, w = self.srf
        x = self.physical(self.cut, xi)
        Nc, G = self._basis(types, xi)
        dn = torch.einsum("cpas,cps->cpa", G, self._normal(types, fn, xi))
        u = ue(x)
        be = be + torch.einsum("cp,cpa->ca", w * u,
                               -dn + self.gamma / self.h * Nc)
        b.index_add_(0, self.dofs(self.cut).reshape(-1),
                     self.store(be).reshape(-1))
        return self.store(torch.where(self.active, b, 0.0))

    def apply(self, v):
        """A v on the half lattice (zero off the active nodes)."""
        v = v.to(self.dt)
        y = torch.zeros(self.M ** 3, dtype=self.dt, device=self.dev)
        for idx, K in self.blocks:
            y.index_add_(0, idx.reshape(-1),
                         torch.einsum("cab,cb->ca", K, v[idx]).reshape(-1))
        return self.store(torch.where(self.active, y, 0.0))

    def diagonal(self):
        d = torch.zeros(self.M ** 3, dtype=self.dt, device=self.dev)
        for idx, K in self.blocks:
            d.index_add_(0, idx.reshape(-1),
                         torch.diagonal(K, dim1=1, dim2=2).reshape(-1))
        return torch.where(self.active, d, 1.0)

    def solve(self, b, rtol=1e-6, maxiter=3000):
        """Jacobi-preconditioned CG from zero on the active nodes."""
        b = torch.where(self.active, b.to(self.dt), 0.0)
        dinv = 1.0 / self.diagonal()
        x = torch.zeros_like(b)
        r = b.clone()
        z = dinv * r
        p = z.clone()
        rz = torch.dot(r, z)
        tol = rtol * torch.linalg.norm(b)
        for _ in range(maxiter):
            q = self.apply(p)
            alpha = rz / torch.dot(p, q)
            x += alpha * p
            r -= alpha * q
            if torch.linalg.norm(r) <= tol:
                break
            z = dinv * r
            rz_new = torch.dot(r, z)
            p = z + (rz_new / rz) * p
            rz = rz_new
        return self.store(x)
