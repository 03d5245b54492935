"""The cut-Poisson problem: cutfemx_tpu_torch driven through its public entry
points, as a user's moving-domain or load-case loop drives it, the mixes'
generator, and the comparison with ``reference/cutpoisson.py``.

The step follows ``bench.py:265-344``: classify, locate the cells, the
ghost-penalty facets, the runtime rules of both parts, the Nitsche +
ghost-penalty forms, the active domain, the load vectors, the
structured-stencil operator and its CG solve. Every stage runs inside a
span of the benchmark's own (``harness/timeline.Recorder``), which drains
the card at its end, so host clocks time whole stages.

A mix (``traffic/<mix>.json``) holds the parameters this module's
``Traffic`` reads; everything that varies is drawn from the run's seed:

- ``geometry`` (moving mixes): ``{"axis": a, "positions": P, "extent":
  e}`` puts the sphere's centre at P positions along axis a, spread evenly
  over [-e, e] about the configuration's centre, each moved toward it to a
  whole number of mesh widths (so each position meets the mesh's vertices
  alike); a step moves it to the next position, and after the last it
  starts again at the first, from a position and a direction drawn from
  the seed: every seed visits the same positions, in another order.
  Without it the centre is the configuration's, and set-up builds cut,
  forms and operator once;
- ``loads``: ``{"modes": "config"}`` is the configuration's manufactured
  load; ``{"modes": "random", "count": K, "choices": [...]}`` draws K
  distinct modes (a, b, c) from choices^3, and each solve takes a
  right-hand side sum_k c_k b_k with fresh N(0, 1) coefficients;
- ``check``: ``{"steps": s, "within": w}``: the comparison takes s steps
  drawn from the seed, before the window, among its first w.

Step -1 is the warm-up, which set-up runs; the window runs steps 0, 1, ...

The interface ``run.py`` uses: ``open_program``, ``Session`` (set-up,
``warmup``, ``step``, ``capture``, ``close``), ``check`` and, for
``calibrate.py``, ``control``.
"""

from __future__ import annotations

import importlib
import math
import os
import shutil
import sys

import numpy as np
import torch

from reference.cutpoisson import CUT, INSIDE, OUTSIDE, Problem, sphere

PORT = "cutfemx_tpu_torch"


def _rng(seed, *stream):
    return np.random.default_rng([int(seed) % 2 ** 63, *stream])


def import_port(root):
    """The port's package from the checkout's root; it must be there."""
    if not os.path.isdir(os.path.join(root, PORT)):
        raise SystemExit(f"cutbench: no {PORT} package in {root}")
    if root not in sys.path:
        sys.path.insert(0, root)
    return importlib.import_module(PORT)


def open_program(root, cfg, device, cache_dir):
    return Program(import_port(root), cfg, device, cache_dir)


class Program:
    """The port's objects for one configuration on one device: the mesh,
    the level set's space and the P2 space (host setup, loaded from the
    setup cache when there is one) and the level set itself."""

    def __init__(self, ct, cfg, device, cache_dir):
        self.ct, self.cfg, self.device = ct, cfg, torch.device(device)
        self.fem = importlib.import_module(PORT + ".fem")
        self.dsl = importlib.import_module(PORT + ".forms.dsl")
        self.Measure = importlib.import_module(
            PORT + ".forms.measure").Measure
        self.StencilCutOperator = importlib.import_module(
            PORT + ".stencil").StencilCutOperator
        self.mesh, self.Vphi, self.V, self.cache_built = self._host_setup(
            cache_dir)
        ls = cfg["level_set"]
        self.phi = ct.Function(self.Vphi, name="phi",
                               dtype=getattr(torch, ls["dtype"]))
        self.form_dtype = getattr(torch, cfg["forms"]["dtype"])

    def _host_setup(self, cache_dir):
        """(mesh, Vphi, V, built): io's setup cache at ``cache_dir`` if it
        holds one, else built and saved there (written beside it, then
        renamed, so a run cut short leaves no half cache)."""
        ct, cfg = self.ct, self.cfg
        io = importlib.import_module(PORT + ".io")
        if cache_dir and os.path.isdir(cache_dir):
            loaded = io.load_setup_cache(cache_dir, device=self.device)
            if loaded is not None:
                mesh, spaces = loaded
                return mesh, spaces[0], spaces[-1], False
        m, n = cfg["mesh"], int(cfg["n"])
        mesh = ct.mesh.create_box(tuple(m["lower"]), tuple(m["upper"]),
                                  (n, n, n), cell_type=m["cell_type"])
        Vphi = ct.functionspace(mesh, ("Lagrange",
                                       int(cfg["level_set"]["degree"])),
                                device=self.device)
        V = Vphi if cfg["space_degree"] == cfg["level_set"]["degree"] \
            else ct.functionspace(mesh, ("Lagrange", int(cfg["space_degree"])),
                                  device=self.device)
        spaces = [Vphi] if V is Vphi else [Vphi, V]
        _ = mesh.facets
        _ = mesh.cell_diameters()
        for sp in spaces:
            _ = sp.dof_coordinates
        if cache_dir:
            part = cache_dir + ".partial"
            shutil.rmtree(part, ignore_errors=True)
            io.save_setup_cache(part, mesh, spaces)
            os.replace(part, cache_dir)
        return mesh, Vphi, V, True

    def place(self, center):
        """Interpolate the sphere at ``center`` into the level set."""
        ls = self.cfg["level_set"]
        self.phi.interpolate(sphere(center, ls["radius"]))

    def cut(self):
        """Classification, cell sets, ghost-penalty facets and the runtime
        rules of {phi < 0} and {phi = 0}."""
        ct, cut = self.ct, self.cfg["cut"]
        kw = {k: v for k, v in cut.items() if k != "rule_order"}
        cd = ct.cut(self.phi, **kw)
        inside = ct.locate_entities(cd, "phi<0")
        gp = ct.ghost_penalty_facets(cd, "phi<0")
        order = int(cut["rule_order"])
        vol = ct.runtime_quadrature(cd, "phi<0", order)
        srf = ct.runtime_quadrature(cd, "phi=0", order)
        return dict(inside=inside, gp=gp, vol=vol, srf=srf)

    def forms(self, C, modes):
        """The bilinear form, its active domain and one load vector per
        manufactured mode (a, b, c)."""
        d, fem, F = self.dsl, self.fem, self.cfg["forms"]
        mesh, V = self.mesh, self.V
        dxo = self.Measure("dx", domain=mesh,
                           subdomain_data=[C["inside"], C["vol"]])
        dxg = self.Measure("dx", domain=mesh, subdomain_data=C["srf"])
        dSg = self.Measure("dS", domain=mesh, subdomain_data=C["gp"])
        u, v = d.TrialFunction(V), d.TestFunction(V)
        x = d.SpatialCoordinate(mesh)
        ng = self.ct.normal(self.phi)
        nf = d.FacetNormal(mesh)
        h = d.CellDiameter(mesh)
        gamma = F["nitsche_gamma"]
        a = d.inner(d.grad(u), d.grad(v)) * dxo
        a += (-d.dot(d.grad(u), ng) * v - d.dot(d.grad(v), ng) * u
              + gamma / h * u * v) * dxg
        a += F["ghost_penalty"] * d.avg(h) * d.inner(
            d.jump(d.grad(u), nf), d.jump(d.grad(v), nf)) * dSg
        af = fem.form(a, dtype=self.form_dtype)
        dom = fem.active_domain(af)
        loads = []
        for ma, mb, mc in modes:
            ue = (d.sin(ma * d.pi * x[0]) * d.sin(mb * d.pi * x[1])
                  * d.sin(mc * d.pi * x[2]))
            f = (ma * ma + mb * mb + mc * mc) * d.pi ** 2 * ue
            L = f * v * dxo + (-d.dot(d.grad(v), ng) * ue
                               + gamma / h * ue * v) * dxg
            loads.append(fem.assemble_vector(fem.form(L,
                                                      dtype=self.form_dtype)))
        return dict(af=af, dom=dom, loads=loads)

    def operator(self, Fm):
        return self.StencilCutOperator(Fm["af"], Fm["dom"])

    def solve(self, op, b):
        """``solve_cg`` as a user calls it: the configuration's rtol and
        maxiter, the port's default preconditioner. Returns (x, its,
        residual norm, seconds its builds took)."""
        s = self.cfg["solve"]
        before = dict(op.build_log)
        x, its, res = op.solve_cg(b, rtol=float(s["rtol"]),
                                  maxiter=int(s["maxiter"]))
        built = sum(sec for stage, (_, sec) in op.build_log.items()
                    if before.get(stage) != op.build_log[stage])
        return x, int(its), float(res), built

    def lattice_index(self):
        """Each P2 dof's node on the half lattice (2n + 1)^3, from the dof
        coordinates: how the reference reads the program's vectors."""
        n = int(self.cfg["n"])
        lo = np.asarray(self.cfg["mesh"]["lower"], dtype=np.float64)
        hi = np.asarray(self.cfg["mesh"]["upper"], dtype=np.float64)
        X = np.rint((self.V.dof_coordinates - lo) / (hi - lo) * 2 * n)
        X = X.astype(np.int64)
        M = 2 * n + 1
        return (X[:, 0] * M + X[:, 1]) * M + X[:, 2]


class Traffic:
    """What the seed draws for one run of one cell (the module's docstring
    gives the mix's parameters)."""

    def __init__(self, spec, cfg, seed):
        self.spec, self.cfg, self.seed = spec, cfg, int(seed)
        self.center0 = tuple(float(c) for c in cfg["level_set"]["center"])
        g = spec.get("geometry")
        self.rebuild = g is not None
        if self.rebuild:
            r = _rng(seed, 1)
            self.start = int(r.integers(int(g["positions"])))
            self.direction = 1 if r.integers(2) else -1
            m, P, e = cfg["mesh"], int(g["positions"]), float(g["extent"])
            h = (m["upper"][g["axis"]] - m["lower"][g["axis"]]) / int(cfg["n"])
            self.offsets = [math.trunc((-e + 2 * e * j / (P - 1)) / h) * h
                            for j in range(P)]
        ld = spec["loads"]
        if ld["modes"] == "config":
            self.modes = [tuple(cfg["forms"]["load_mode"])]
        else:
            choices = ld["choices"]
            every = [(a, b, c) for a in choices for b in choices
                     for c in choices]
            pick = _rng(seed, 2).choice(len(every), int(ld["count"]),
                                        replace=False)
            self.modes = [every[i] for i in pick]
        chk = spec["check"]
        pick = _rng(seed, 4).choice(int(chk["within"]), int(chk["steps"]),
                                    replace=False)
        self.checked = sorted(int(i) for i in pick)

    def center(self, step):
        """The level set's centre at ``step`` (-1: the warm-up)."""
        if not self.rebuild:
            return self.center0
        j = (self.start + self.direction * step) % len(self.offsets)
        c = list(self.center0)
        c[self.spec["geometry"]["axis"]] += self.offsets[j]
        return tuple(c)

    def coefficients(self, step):
        """The load combination of ``step``: None for one load."""
        if len(self.modes) == 1:
            return None
        return _rng(self.seed, 3, step + 1).standard_normal(len(self.modes))

    def rhs(self, step, loads):
        coef = self.coefficients(step)
        if coef is None:
            return loads[0]
        return sum(float(c) * b for c, b in zip(coef, loads))


class Session:
    """One run's set-up and steps. A moving mix builds a step from the cut
    to the solve; a fixed one builds cut, forms and operator in set-up and
    a step is one solve. What the check reads of a checked step is kept
    until ``capture`` copies it to the host, which ``run.py`` times apart
    from the window."""

    def __init__(self, prog, cfg, spec, seed, rec):
        self.prog, self.cfg, self.rec = prog, cfg, rec
        self.tr = tr = Traffic(spec, cfg, seed)
        self.checked = tr.checked
        gen = torch.Generator(device=prog.device).manual_seed(
            int(seed) % 2 ** 63)
        self.v = torch.randn(prog.V.dim, generator=gen, device=prog.device,
                             dtype=prog.form_dtype)
        self.kept, self.captured = None, {}
        self.fixed = None
        if not tr.rebuild:
            self.fixed = self._build(tr.center(-1))
            self.captured["fixed"] = self._geometry(*self.fixed)

    def _build(self, center):
        rec, prog = self.rec, self.prog
        with rec.span("place"):
            prog.place(center)
        with rec.span("cut"):
            C = prog.cut()
        with rec.span("forms"):
            Fm = prog.forms(C, self.tr.modes)
        with rec.span("operator"):
            op = prog.operator(Fm)
        return C, Fm, op

    def _geometry(self, C, Fm, op):
        """What the check reads of a geometry, copied to the host."""
        return dict(inside=C["inside"].copy(),
                    cut=C["vol"].parent_map.copy(),
                    vol=(C["vol"].points_padded.cpu(),
                         C["vol"].weights_padded.cpu()),
                    srf=(C["srf"].points_padded.cpu(),
                         C["srf"].weights_padded.cpu()),
                    loads=[b.cpu() for b in Fm["loads"]],
                    y=op(self.v).cpu())

    def warmup(self):
        self.step(-1)
        self.kept = None

    def step(self, k):
        """One step of the mix; its objects die with it, as in a user's
        loop, unless the check reads it. Returns the step's record:
        ``ok`` (the solve reached rtol by its own residual), ``its``,
        ``build_s``."""
        geo = self._build(self.tr.center(k)) if self.tr.rebuild \
            else self.fixed
        C, Fm, op = geo
        with self.rec.span("combine"):
            b = self.tr.rhs(k, Fm["loads"])
        with self.rec.span("solve"):
            x, its, res, built = self.prog.solve(op, b)
        bn = float(torch.linalg.norm(torch.where(op.active, b, 0.0)))
        ok = math.isfinite(res) and \
            res <= float(self.cfg["solve"]["rtol"]) * bn * (1 + 1e-6) and \
            bool(torch.isfinite(x).all())
        if k in self.checked:
            self.kept = (geo if self.tr.rebuild else None, x)
        return dict(its=its, build_s=built, ok=ok, res=res / bn if bn else
                    math.inf)

    def capture(self, k):
        """Copy what the check reads of step ``k`` to the host."""
        geo, x = self.kept
        self.kept = None
        got = {"x": x.cpu()}
        if geo is not None:
            got["geometry"] = self._geometry(*geo)
        self.captured[k] = got

    def close(self):
        """Free the program's state; returns the host copies the check
        reads."""
        out = dict(self.captured, v=self.v.cpu(),
                   idx=self.prog.lattice_index())
        self.kept = self.fixed = self.prog = None
        return out


# -- the comparison ---------------------------------------------------------
#
# The numbers compared, each the worst over the steps checked:
#
# - class_mismatch: cells whose class (inside, outside, cut) differs; exact;
# - vol_rule / srf_rule: the mean over the cut cells of a cell's largest gap
#   between the program's rule and the reference's on 1, a linear and a
#   quadratic function, over the cell's volume (s^3 / 6) / a cube face (s^2);
# - load: ||b - b_ref|| / ||b_ref|| of each load vector on the active nodes;
# - action: the same for the operator applied to the run's vector v;
# - residual: ||b - A x|| / ||b|| of the program's solution x with the
#   reference's A and b.
#
# Means and 2-norms, not the worst cell or entry: in float32 the program's
# weights of a few ill-conditioned marching parts (slivers) carry gaps of
# 1e-4 to 1e-3 of their cell, which the worst cell reads, while the control
# errs by that much in every cell (PERF.md has the readings).


def to_lattice(vec, idx, ref):
    """A program vector (dof order) on the reference's half lattice."""
    out = torch.zeros(ref.M ** 3, dtype=torch.float64, device=ref.dev)
    out[idx] = vec.to(device=ref.dev, dtype=torch.float64)
    return out


def _rel_norm(got, want, active):
    scale = float(torch.linalg.norm(torch.where(active, want, 0.0)))
    gap = float(torch.linalg.norm(torch.where(active, got - want, 0.0)))
    return gap / scale if scale > 0 else math.inf


def geometry(ref, got):
    """Readings of one geometry: ``got`` holds the cell sets (``inside``,
    ``cut``: cell indices), the rules (``vol``, ``srf``: (points, weights)
    per cut cell), the load vectors and the action ``y`` of the vector
    ``v``, all on the reference's lattice."""
    dev = ref.dev
    codes = torch.full_like(ref.codes, OUTSIDE)
    codes[torch.as_tensor(got["inside"], device=dev).long()] = INSIDE
    cut = torch.as_tensor(got["cut"], device=dev).long()
    codes[cut] = CUT
    out = {"class_mismatch": int((codes != ref.codes).sum())}
    # rules on the cut cells both sides share (a mismatch is counted above)
    both = torch.isin(cut, ref.cut)
    common = cut[both]
    ip = torch.nonzero(both).reshape(-1)
    ir = torch.searchsorted(ref.cut, common)
    s = ref.s
    for key, want, scale in (("vol", ref.vol, s ** 3 / 6.0),
                             ("srf", ref.srf, s ** 2)):
        pts, w = (t.to(dev, torch.float64) for t in got[key])
        gap = (ref.moments(common, pts[ip], w[ip], scale)
               - ref.moments(common, want[0][ir], want[1][ir], scale))
        gap = gap.abs().max(1).values
        out[key + "_rule"] = float(gap.mean()) if gap.numel() else 0.0
    out["load"] = max(_rel_norm(b, want, ref.active)
                      for b, want in zip(got["loads"], ref.loads))
    out["action"] = _rel_norm(got["y"], ref.apply(got["v"]), ref.active)
    return out


def residual(ref, b, x):
    """||b - A x|| / ||b|| on the reference's active nodes."""
    r = torch.where(ref.active, b - ref.apply(x), 0.0)
    nb = float(torch.linalg.norm(torch.where(ref.active, b, 0.0)))
    return float(torch.linalg.norm(r)) / nb if nb > 0 else math.inf


def _worst(readings):
    out = {}
    for r in readings:
        for k, v in r.items():
            v = math.inf if v != v else v
            out[k] = max(out.get(k, -math.inf), v)
    return out


def check(cfg, spec, seed, got, device):
    """(readings, extra): the checked steps' readings against the
    reference, freshly computed on ``device`` from the benchmark's inputs,
    the worst over the steps; ``extra`` holds K1's frozen byte counts on
    the fixed geometry (for its roofline)."""
    from counts.k1_bytes import k1_bytes
    tr = Traffic(spec, cfg, seed)
    idx = torch.as_tensor(got["idx"], device=device)
    readings, extra = [], {}

    def lattice(vec, ref):
        return to_lattice(vec, idx, ref)

    def read_geometry(ref, g):
        g = dict(g, loads=[lattice(b, ref) for b in g["loads"]],
                 y=lattice(g["y"], ref), v=lattice(got["v"], ref))
        return geometry(ref, g)

    if tr.rebuild:
        for k in tr.checked:
            ref = Problem(cfg, tr.center(k), tr.modes, device=device)
            r = read_geometry(ref, got[k]["geometry"])
            r["residual"] = residual(ref, tr.rhs(k, ref.loads),
                                     lattice(got[k]["x"], ref))
            readings.append(r)
            del ref
    else:
        ref = Problem(cfg, tr.center(-1), tr.modes, device=device)
        r = read_geometry(ref, got["fixed"])
        r["residual"] = max(
            residual(ref, tr.rhs(k, ref.loads), lattice(got[k]["x"], ref))
            for k in tr.checked)
        readings.append(r)
        full = ref.full_cubes.cpu().numpy()
        degree = int(cfg["space_degree"])
        extra["k1"] = {"float": k1_bytes(full, degree, 4),
                       "double": k1_bytes(full, degree, 8)}
        del ref
    return _worst(readings), extra


def _bf16(t):
    return t.to(torch.bfloat16).to(t.dtype) if t.is_floating_point() else t


def control(cfg, spec, seed, idx, v, device):
    """The control's readings at the seed's first checked geometry: the
    reference itself put in the program's place, computing in float32 and
    keeping every stage (level set, rules, element matrices, vectors,
    applies, the Jacobi-CG solution) in bfloat16, the precision below the
    configuration's float32, read against the float64 reference by the
    same numbers."""
    tr = Traffic(spec, cfg, seed)
    k = tr.checked[0] if tr.rebuild else -1
    ref = Problem(cfg, tr.center(k), tr.modes, device=device)
    ctl = Problem(cfg, tr.center(k), tr.modes, device=device,
                  dtype=torch.float32, store=_bf16)
    v_lat = to_lattice(v, torch.as_tensor(idx, device=device), ref)
    got = dict(inside=ctl.inside, cut=ctl.cut, vol=ctl.vol, srf=ctl.srf,
               loads=[b.double() for b in ctl.loads],
               y=ctl.apply(v_lat).double(), v=v_lat)
    out = geometry(ref, got)
    step = k if tr.rebuild else tr.checked[0]
    x = ctl.solve(tr.rhs(step, ctl.loads),
                  rtol=float(cfg["solve"]["rtol"]))
    out["residual"] = residual(ref, tr.rhs(step, ref.loads), x.double())
    return out
