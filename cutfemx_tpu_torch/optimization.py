"""Shape / level-set optimization toolkit: the torch counterpart of
``cutfemx_tpu.optimization``.

- ``ProfileWriter`` / ``ConvergenceWriter`` streaming CSVs and ``phase``
  timing contexts,
- ``LBFGSState`` with curvature-guarded history updates and the two-loop
  inverse-Hessian product (Nocedal & Wright alg. 7.4/7.5),
- ``AugmentedLagrangianState`` for volume-type equality constraints (the
  first-order augmented-Lagrangian recursion),
- ``AdaptiveGradientStepState``: Barzilai-Borwein step proposals clipped
  by growth and interface-motion CFL caps, and the Armijo acceptance test,
- ``RieszVelocitySolver``: H1 smoothing of interface shape gradients onto
  a background field,
- ``LevelSetAdvectionSolver``: SUPG-stabilized implicit transport,
  explicit nodal Hamilton-Jacobi, and semi-Lagrangian characteristics,
- ``save_checkpoint`` / ``load_checkpoint``: the whole optimizer state as
  one atomic ``.npz`` file.

The forms are assembled in float64 on the device of their spaces; the
background solves are host sparse direct solves (SciPy), by design. The
optimizer states hold plain numpy arrays, so they compose with any state
solve and cross between this package and ``cutfemx_tpu`` as they are.
"""

from __future__ import annotations

import csv
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from . import fem
from .forms.dsl import (CoefficientExpr, TestFunction, TrialFunction, dot,
                        grad, inner, sqrt)
from .forms.measure import Measure
from .functionspace import Function, functionspace
from .geometry import pullback

__all__ = [
    "phase", "ProfileWriter", "ConvergenceWriter",
    "LBFGSState", "lbfgs_update", "lbfgs_inverse_hessian_product",
    "lbfgs_direction",
    "AugmentedLagrangianState", "update_augmented_lagrangian",
    "alm_velocity_multiplier", "lagrangian_value",
    "initialise_augmented_lagrangian_scale",
    "AdaptiveGradientStepState", "adaptive_gradient_dt",
    "accept_adaptive_gradient_step", "motion_dt_cap", "armijo_rhs",
    "RieszVelocitySolver", "LevelSetAdvectionSolver",
    "locate_cells", "evaluate_at_points",
    "SolidComponent", "solid_components", "remove_floating_components",
    "reinit_volume_shift", "save_checkpoint", "load_checkpoint",
]

F64 = torch.float64


def _host(x):
    """float64 numpy copy of a tensor (or array)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().astype(float)
    return np.array(x, dtype=float)


def _set_values(f: Function, vals):
    """Overwrite a Function's dofs with host values, keeping its dtype and
    device."""
    f.x = torch.as_tensor(np.asarray(vals), dtype=f.x.dtype,
                          device=f.x.device)


# -- profiling / convergence writers ------------------------------------------


@contextmanager
def phase(row: dict, name: str):
    """Add the with-block's wall-clock to ``row['time_<name>']``.

    Re-entering the same phase name on one row accumulates, so split
    phases (e.g. two assembly bursts per iteration) report one total."""
    start = time.perf_counter()
    try:
        yield
    finally:
        key = "time_" + name
        row[key] = float(row.get(key, 0.0)) + (time.perf_counter() - start)


class _StreamingCsv:
    """CSV sink that flushes after every row, so an interrupted run keeps
    everything written so far. Keys outside ``fieldnames`` are dropped;
    missing keys are left blank. Fills the monitoring role of the
    compliance demo's CSV writers, on csv.DictWriter's restval/
    extrasaction handling."""

    def __init__(self, path, fieldnames):
        self.path = Path(path)
        self.fieldnames = tuple(fieldnames)
        self._sink = None
        self._csv = None

    def __enter__(self):
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._sink = self.path.open("w", newline="")
        self._csv = csv.DictWriter(self._sink, fieldnames=self.fieldnames,
                                   restval="", extrasaction="ignore")
        self._csv.writeheader()
        self._sink.flush()
        return self

    def write(self, row: dict) -> None:
        if self._sink is None:
            raise RuntimeError(
                f"{type(self).__name__} used outside its context")
        self._csv.writerow(row)
        self._sink.flush()

    def __exit__(self, *exc):
        sink, self._sink, self._csv = self._sink, None, None
        if sink is not None:
            sink.close()


class ProfileWriter(_StreamingCsv):
    """Per-iteration phase timings + memory rows."""


class ConvergenceWriter(_StreamingCsv):
    """Per-iteration scalar convergence monitoring rows."""


# -- L-BFGS -------------------------------------------------------------------


def _euclid(a, b) -> float:
    return float(np.dot(a, b))


@dataclass
class LBFGSState:
    """Limited-memory BFGS history over design vectors.

    The three parallel lists hold the newest ``memory`` accepted pairs in
    chronological order (oldest first); ``inv_sy[i]`` caches
    ``1 / <s_i, y_i>``. Vectors are whatever flattening the caller uses
    (interface speed dofs, level-set dofs, ...); the textbook two-loop
    method (Nocedal & Wright alg. 7.4/7.5)."""
    s_hist: list = field(default_factory=list)
    y_hist: list = field(default_factory=list)
    inv_sy: list = field(default_factory=list)
    anchor_x: np.ndarray | None = None
    anchor_grad: np.ndarray | None = None
    curvature_sy: float = 0.0
    pair_accepted: bool = False

    def drop_history(self):
        """Forget accepted pairs; keep the (x, g) anchor."""
        del self.s_hist[:]
        del self.y_hist[:]
        del self.inv_sy[:]

    def clear(self):
        self.drop_history()
        self.anchor_x = None
        self.anchor_grad = None
        self.curvature_sy = 0.0
        self.pair_accepted = False


def lbfgs_update(state: LBFGSState, x, gradient, *, memory: int,
                 curvature_tol: float = 1e-8, inner_product=None) -> None:
    """Record the step to (x, gradient) as an (s, y) history pair.

    A pair enters the history only when its curvature <s, y> is positive
    relative to |s||y| (a cosine-style test: tolerance scales with the
    vector magnitudes, so tiny steps are judged fairly). Rejected pairs
    still advance the (x, g) anchor. ``inner_product(a, b)`` defaults to
    the Euclidean dot; pass an H1/mass-weighted dot to optimize in the
    metric the Riesz solver regularizes in."""
    dotp = inner_product or _euclid
    x = np.array(x, dtype=float)
    g = np.array(gradient, dtype=float)
    state.curvature_sy = 0.0
    state.pair_accepted = False
    anchored = (state.anchor_x is not None
                and state.anchor_grad is not None)
    if anchored:
        s = x - state.anchor_x
        y = g - state.anchor_grad
        sy = float(dotp(s, y))
        state.curvature_sy = sy
        magnitude = np.sqrt(max(dotp(s, s), 0.0) * max(dotp(y, y), 0.0))
        admissible = (memory > 0 and np.isfinite(sy)
                      and sy > curvature_tol * max(magnitude, 1e-30))
        if admissible:
            state.s_hist.append(s)
            state.y_hist.append(y)
            state.inv_sy.append(1.0 / sy)
            if len(state.s_hist) > memory:
                del state.s_hist[:-memory]
                del state.y_hist[:-memory]
                del state.inv_sy[:-memory]
            state.pair_accepted = True
    state.anchor_x = x
    state.anchor_grad = g


def lbfgs_inverse_hessian_product(state: LBFGSState, gradient,
                                  inner_product=None) -> np.ndarray:
    """Apply the implicit inverse Hessian: two-loop recursion, seeded
    with H0 = gamma I where gamma = <s,y>/<y,y> of the newest pair
    (equivalently 1/(rho <y,y>), since rho caches 1/<s,y>)."""
    dotp = inner_product or _euclid
    q = np.array(gradient, dtype=float)
    k = len(state.s_hist)
    if k == 0:
        return q
    S, Y, R = state.s_hist, state.y_hist, state.inv_sy
    alpha = np.zeros(k)
    for i in range(k - 1, -1, -1):
        alpha[i] = R[i] * dotp(S[i], q)
        q = q - alpha[i] * Y[i]
    yy = dotp(Y[-1], Y[-1])
    gamma = 1.0 / (R[-1] * yy) if (R[-1] > 0.0 and yy > 0.0) else 1.0
    z = gamma * q
    for i in range(k):
        beta = R[i] * dotp(Y[i], z)
        z = z + (alpha[i] - beta) * S[i]
    return z


def lbfgs_direction(state: LBFGSState, gradient, inner_product=None):
    """Quasi-Newton search direction -H g with a steepest-descent
    safeguard: if the history produces a non-descent (or non-finite)
    slope, the history is discarded and -g is returned instead.
    Returns (direction, <g, d>, n_resets) with n_resets in {0, 1}."""
    dotp = inner_product or _euclid
    g = np.asarray(gradient, dtype=float)
    d = -lbfgs_inverse_hessian_product(state, g, inner_product)
    slope = float(dotp(g, d))
    if np.isfinite(slope) and slope < 0.0:
        return d, slope, 0
    state.drop_history()
    d = -g
    return d, float(dotp(g, d)), 1


# -- augmented Lagrangian -----------------------------------------------------


@dataclass
class AugmentedLagrangianState:
    """State of the classic first-order augmented-Lagrangian method for
    one scalar equality constraint c(x) + slack = 0 (the standard ALM
    recursion lambda_{k+1} = lambda_k + rho_k c_k)."""
    multiplier: float = 0.0
    penalty: float = 1.0
    rho_growth: float = 1.1
    rho_max: float = 1e6
    slack: float = 0.0

    def violation(self, constraint: float) -> float:
        """The slack-shifted constraint value the updates act on."""
        return float(constraint) + self.slack


def update_augmented_lagrangian(alm: AugmentedLagrangianState,
                                constraint: float) -> None:
    """End-of-outer-iteration update: multiplier absorbs rho*c, penalty
    grows geometrically until it hits the cap."""
    c = alm.violation(constraint)
    alm.multiplier = alm.multiplier + alm.penalty * c
    grown = alm.rho_growth * alm.penalty
    alm.penalty = grown if grown < alm.rho_max else alm.rho_max


def alm_velocity_multiplier(alm: AugmentedLagrangianState,
                            constraint: float) -> float:
    """d/dc of the augmented Lagrangian — the factor multiplying the
    constraint's shape derivative in the descent velocity."""
    return float(alm.multiplier
                 + alm.penalty * alm.violation(constraint))


def lagrangian_value(objective: float, constraint: float,
                     alm: AugmentedLagrangianState) -> float:
    """The merit function the line search monitors:
    L = J + lambda c + (rho/2) c^2."""
    c = alm.violation(constraint)
    return float(objective) + alm.multiplier * c \
        + 0.5 * alm.penalty * c * c


def initialise_augmented_lagrangian_scale(alm: AugmentedLagrangianState,
                                          objective: float,
                                          constraint: float) -> None:
    """Choose lambda0 = J0/c0 and rho0 = J0/c0^2 so the multiplier and
    penalty terms both start at the magnitude of the objective (and skip
    the rescale when J0 or c0 makes the ratios meaningless)."""
    j0, c0 = float(objective), float(constraint)
    usable = (np.isfinite(j0) and np.isfinite(c0)
              and j0 > 0.0 and abs(c0) > 1e-14)
    if not usable:
        return
    alm.multiplier = j0 / c0
    alm.penalty = j0 / c0 ** 2
    alm.rho_max = 10.0 * alm.penalty


# -- adaptive step + Armijo ---------------------------------------------------


@dataclass
class AdaptiveGradientStepState:
    """The last *accepted* (design, gradient) pair, from which the next
    Barzilai-Borwein step length is estimated (the BB1 "long" step
    formula)."""
    anchor_phi: np.ndarray | None = None
    anchor_grad: np.ndarray | None = None
    dt_accepted: float = 0.0


def motion_dt_cap(hmin: float, velocity_max: float,
                  motion_cfl: float) -> float:
    """Largest dt moving the interface at most ``motion_cfl`` cell
    widths: dt <= cfl * h_min / |v|_max. Unbounded for a still field."""
    vmax = float(velocity_max)
    if np.isfinite(vmax) and vmax > 0.0:
        return float(motion_cfl) * float(hmin) / vmax
    return float("inf")


def _barzilai_borwein_dt(state: AdaptiveGradientStepState, phi_values,
                         gradient_values):
    """BB1 step <s,s>/<s,y> against the last accepted pair, or None when
    no pair exists / the pair carries no usable positive curvature."""
    if state.anchor_phi is None or state.anchor_grad is None:
        return None
    s = np.asarray(phi_values, float) - state.anchor_phi
    y = np.asarray(gradient_values, float) - state.anchor_grad
    ss = float(s @ s)
    sy = float(s @ y)
    if not (np.isfinite(sy) and sy > 1e-30 and ss > 0.0):
        return None
    dt = ss / sy
    return dt if np.isfinite(dt) and dt > 0.0 else None


def adaptive_gradient_dt(state: AdaptiveGradientStepState, phi_values,
                         gradient_values, previous_dt: float, hmin: float,
                         velocity_max: float, motion_cfl: float, *,
                         enabled: bool = True) -> dict:
    """Propose the next pseudo-time step: the BB estimate bounded by a
    [x0.25, x2] trust window around the previous dt, then by the
    interface-motion CFL cap. Returns a diagnostics row (the CSV columns
    the convergence writer logs)."""
    prev = float(previous_dt)
    bb = _barzilai_borwein_dt(state, phi_values, gradient_values) \
        if enabled else None
    raw = prev if bb is None else float(bb)
    trusted = min(max(raw, 0.25 * prev), 2.0 * prev)
    cap = motion_dt_cap(hmin, velocity_max, motion_cfl)
    dt = min(trusted, cap)
    if not np.isfinite(dt) or dt <= 0.0:
        dt = prev
    return {
        "dt_prev": prev,
        "dt_bb_raw": raw,
        "dt_motion_cap": float(cap),
        "dt_next": float(dt),
        "bb_pair_used": int(bb is not None),
    }


def accept_adaptive_gradient_step(state: AdaptiveGradientStepState,
                                  phi_values, gradient_values,
                                  dt_accepted: float) -> None:
    """Commit an accepted step as the next BB pair's anchor."""
    state.anchor_phi = np.array(phi_values, dtype=float)
    state.anchor_grad = np.array(gradient_values, dtype=float)
    state.dt_accepted = float(dt_accepted)


def armijo_rhs(current_objective: float, predicted_rate: float, dt: float,
               sufficient_decrease: float) -> float:
    """Sufficient-decrease threshold for the merit line search:
    J + c1 * dt * dJ/dt when the model predicts descent; otherwise a
    hair above J so fp-level non-increase still passes."""
    j = float(current_objective)
    expected = float(sufficient_decrease) * float(dt) * predicted_rate
    if np.isfinite(expected) and expected < 0.0:
        return j + expected
    # no predicted descent: accept fp-level non-increase (a few ulps of J)
    return j + 64.0 * np.finfo(float).eps * abs(j)


# -- topology diagnostics -----------------------------------------------------


@dataclass
class SolidComponent:
    """One connected component of the active (solid) cells."""
    cells: np.ndarray
    anchored: bool
    loaded: bool


def solid_components(mesh, active_cells, anchored_cells=None,
                     loaded_cells=None):
    """Connected components of ``active_cells`` under facet adjacency.

    Vectorized min-label propagation. ``anchored_cells`` /
    ``loaded_cells`` mark components that touch supports / loads."""
    active = np.zeros(mesh.num_cells, bool)
    active[np.asarray(active_cells, np.int64)] = True
    fc = np.asarray(mesh.facet_cells)  # (nfacets, 2), -1 on boundary
    interior = (fc[:, 0] >= 0) & (fc[:, 1] >= 0)
    a, b = fc[interior, 0], fc[interior, 1]
    keep = active[a] & active[b]
    a, b = a[keep], b[keep]
    labels = np.where(active, np.arange(mesh.num_cells), -1)
    while True:
        m = np.minimum(labels[a], labels[b])
        new = labels.copy()
        np.minimum.at(new, a, m)
        np.minimum.at(new, b, m)
        if np.array_equal(new, labels):
            break
        labels = new
    anchored = np.zeros(mesh.num_cells, bool)
    loaded = np.zeros(mesh.num_cells, bool)
    if anchored_cells is not None:
        anchored[np.asarray(anchored_cells, np.int64)] = True
    if loaded_cells is not None:
        loaded[np.asarray(loaded_cells, np.int64)] = True
    comps = []
    for lab in np.unique(labels[active]):
        cells = np.flatnonzero(labels == lab)
        comps.append(SolidComponent(
            cells=cells,
            anchored=bool(anchored[cells].any()),
            loaded=bool(loaded[cells].any())))
    return comps


def remove_floating_components(phi: Function, mesh, components,
                               clear_value: float):
    """Void the vertices of components that touch neither supports nor
    loads: phi := max(phi, clear_value) there, protecting vertices shared
    with kept components. Returns the modified P1 dofs."""
    floating = [c for c in components if not c.anchored and not c.loaded]
    if not floating:
        return np.empty(0, np.int64)
    cells = np.asarray(mesh.cells)
    protected = set()
    for c in components:
        if c.anchored or c.loaded:
            protected.update(cells[c.cells].ravel().tolist())
    remove = set()
    for c in floating:
        verts = set(cells[c.cells].ravel().tolist())
        local = verts - protected
        remove.update(local if local else verts)
    if not remove:
        return np.empty(0, np.int64)
    dofs = np.asarray(fem.locate_dofs_topological(
        phi.function_space, 0, np.array(sorted(remove), np.int64)))
    vals = _host(phi.x)
    vals[dofs] = np.maximum(vals[dofs], clear_value)
    _set_values(phi, vals)
    return dofs


def reinit_volume_shift(current_volume: float, target_volume: float,
                        interface_measure: float,
                        limit: float = 0.0) -> float:
    """Constant level-set shift restoring volume after redistancing:
    dV/dc ~= -|Gamma| for phi<0 solid."""
    if interface_measure <= 1e-14:
        return 0.0
    shift = (current_volume - target_volume) / interface_measure
    if limit > 0.0:
        shift = float(np.clip(shift, -limit, limit))
    return float(shift)


# -- point location / evaluation ----------------------------------------------


def _affine_maps(cvx):
    """(origin (nc, gdim), K (nc, tdim, gdim)) of the affine maps of
    simplices with vertex coordinates cvx (nc, nv, gdim): xi = K (x - o)."""
    J = np.swapaxes(cvx[:, 1:, :] - cvx[:, :1, :], 1, 2)   # (nc, g, t)
    K = np.linalg.inv(J) if J.shape[1] == J.shape[2] else np.linalg.pinv(J)
    return cvx[:, 0, :], K


def _reference_coords(mesh, cells, x):
    """Reference coordinates (n, tdim) of physical points x (n, gdim) in
    the given cells (host numpy): the affine inverse on simplices, the
    general pullback (in f64, batched by torch.func.vmap) otherwise."""
    cvx = np.asarray(mesh.cell_vertex_coords)[cells]
    if mesh.ref_cell.is_simplex:
        origin, K = _affine_maps(cvx)
        return np.einsum("ntg,ng->nt", K, x - origin)
    if len(x) == 0:
        return np.zeros((0, mesh.tdim))
    xi = torch.func.vmap(
        lambda c, p: pullback(mesh.cell_type, c, p[None])[0])(
        torch.as_tensor(cvx, dtype=F64), torch.as_tensor(x, dtype=F64))
    return xi.numpy()


def locate_cells(mesh, points, pad: float = 1e-10):
    """Cells containing each physical point: of the cells whose padded box
    holds it and whose reference coordinates put it inside (to 1e-8), the
    one of smallest index; points in no cell take the cell of nearest
    midpoint. Broad phase: uniform bins over the cell boxes, joined to the
    points by a sort (vectorized). points: (N, gdim)."""
    pts = np.asarray(points, float)
    verts = np.asarray(mesh.vertices)
    cvx = np.asarray(mesh.cell_vertex_coords)  # (nc, nv, gdim)
    lo = cvx.min(axis=1)
    hi = cvx.max(axis=1)
    gdim = verts.shape[1]
    dlo, dhi = verts.min(axis=0), verts.max(axis=0)
    ncells = cvx.shape[0]
    nbins = max(1, int(np.floor(ncells ** (1.0 / gdim))))
    width = np.maximum((dhi - dlo) / nbins, 1e-30)

    def bin_of(x):
        return np.clip(((x - dlo) / width).astype(np.int64), 0, nbins - 1)

    strides = nbins ** np.arange(gdim)
    blo, bhi = bin_of(lo - pad), bin_of(hi + pad)
    span = bhi - blo + 1
    per = span.prod(axis=1)
    cell_ids = np.repeat(np.arange(ncells), per)
    rem = np.arange(per.sum()) - np.repeat(np.cumsum(per) - per, per)
    key = np.zeros_like(rem)
    for k in range(gdim):
        sk = span[cell_ids, k]
        key += (blo[cell_ids, k] + rem % sk) * strides[k]
        rem = rem // sk
    order = np.lexsort((cell_ids, key))
    key, cell_ids = key[order], cell_ids[order]
    pkey = bin_of(pts) @ strides
    first = np.searchsorted(key, pkey, "left")
    cnt = np.searchsorted(key, pkey, "right") - first
    P = np.repeat(np.arange(len(pts)), cnt)
    C = cell_ids[np.repeat(first, cnt)
                 + np.arange(cnt.sum()) - np.repeat(np.cumsum(cnt) - cnt,
                                                    cnt)]
    x = pts[P]
    ok = ((lo[C] - pad <= x) & (x <= hi[C] + pad)).all(axis=1)
    P, C, x = P[ok], C[ok], x[ok]
    xi = _reference_coords(mesh, C, x)
    if mesh.ref_cell.is_simplex:
        inside = (xi >= -1e-8).all(axis=1) & (xi.sum(axis=1) <= 1.0 + 1e-8)
    else:
        inside = ((xi >= -1e-8) & (xi <= 1.0 + 1e-8)).all(axis=1)
    out = np.full(pts.shape[0], ncells, dtype=np.int64)
    np.minimum.at(out, P[inside], C[inside])
    missing = np.flatnonzero(out == ncells)
    if missing.size:
        mids = cvx.mean(axis=1)
        for i in missing:
            out[i] = int(np.argmin(np.sum((mids - pts[i]) ** 2, axis=1)))
    return out


def evaluate_at_points(f: Function, points, cells=None):
    """Evaluate a Function at physical points (N, gdim) -> (N,) or
    (N, bs) host values."""
    V = f.function_space
    mesh = V.mesh
    pts = np.asarray(points, float)
    if cells is None:
        cells = locate_cells(mesh, pts)
    cells = np.asarray(cells, np.int64)
    xi = _reference_coords(mesh, cells, pts)
    tab = np.asarray(V.element.tabulate(xi))  # (N, ndof_cell)
    cdofs = np.asarray(V.dofmap)[cells]
    vals = _host(f.x)
    if V.bs == 1:
        return np.einsum("nd,nd->n", tab, vals[cdofs])
    out = np.empty((pts.shape[0], V.bs))
    for b in range(V.bs):
        out[:, b] = np.einsum("nd,nd->n", tab, vals[cdofs * V.bs + b])
    return out


# -- Riesz velocity smoothing -------------------------------------------------


class RieszVelocitySolver:
    """H1 Riesz representative of interface shape gradients.

    Solves (alpha^2 grad v . grad w + v w) dx = <dJ, w> on the background
    mesh with a SciPy factorization made once (the forms assemble in
    float64 on ``device``). Optional homogeneous Dirichlet facets pin the
    velocity at fixed boundaries."""

    def __init__(self, mesh, smoothing_length: float, zero_facets=None,
                 degree: int = 1, device="cuda"):
        self.mesh = mesh
        self.space = functionspace(mesh, ("Lagrange", degree), device=device)
        u = TrialFunction(self.space)
        w = TestFunction(self.space)
        dx = Measure("dx", domain=mesh)
        a = (smoothing_length ** 2 * inner(grad(u), grad(w))
             + u * w) * dx
        self.bcs = []
        if zero_facets is not None and np.asarray(zero_facets).size:
            dofs = fem.locate_dofs_topological(
                self.space, mesh.tdim - 1, np.asarray(zero_facets))
            self.bcs = [fem.dirichletbc(0.0, dofs, self.space)]
        self.bilinear_form = fem.form(a, dtype=F64)
        A = fem.assemble_matrix(self.bilinear_form, bcs=self.bcs)
        from scipy.sparse.linalg import factorized
        self._solve = factorized(A.to_scipy().tocsc())

    def solve(self, rhs_form, name="velocity"):
        """Assemble the rhs form; return (Function, rhs host array)."""
        b = _host(fem.assemble_vector(rhs_form))
        if self.bcs:
            b = fem.apply_lifting(b, [self.bilinear_form], [self.bcs])
            b = fem.set_bc(b, self.bcs)
        v = Function(self.space, name=name, dtype=F64)
        _set_values(v, self._solve(b))
        return v, b

    def interface_forms(self, density_expr, dx_interface):
        """(shape_rhs, volume_rhs) pair over a runtime interface measure."""
        w = TestFunction(self.space)
        shape_rhs = fem.form((density_expr * w) * dx_interface, dtype=F64)
        volume_rhs = fem.form((-1.0 * w) * dx_interface, dtype=F64)
        return shape_rhs, volume_rhs

    def h1_inner(self, a, b):
        """The (alpha^2 K + M)-inner product of two dof vectors: the metric
        L-BFGS should use when its design variable is the smoothed
        velocity."""
        A = fem.assemble_matrix(self.bilinear_form)
        return float(np.dot(_host(a), A.to_scipy() @ _host(b)))


# -- level-set advection ------------------------------------------------------


class LevelSetAdvectionSolver:
    """Transport of the level set by an extended normal-speed field.

    Methods:
      'supg'            — implicit Euler + SUPG-stabilized transport
                          solve on the background mesh,
      'nodal'           — explicit Hamilton-Jacobi update with a nodal
                          gradient-norm estimate (cheap diagnostic),
      'characteristics' — serial semi-Lagrangian RK2 along the velocity
                          field.

    ``fixed_facets`` dofs keep their old phi values (inflow clamps)."""

    def __init__(self, V, fixed_facets=None, tau_scale: float = 1.0):
        self.space = V
        self.mesh = V.mesh
        self.tau_scale = float(tau_scale)
        self.fixed_dofs = np.empty(0, np.int64)
        if fixed_facets is not None and np.asarray(fixed_facets).size:
            self.fixed_dofs = np.asarray(fem.locate_dofs_topological(
                V, self.mesh.tdim - 1, np.asarray(fixed_facets)))
        self._nodal_cache = None
        # dt enters the SUPG form as a DG0 coefficient, not a baked
        # Python number, so a new dt reuses the compiled kernels
        self._dt_fn = Function(functionspace(self.mesh, ("DG", 0),
                                             device=V.device),
                               name="dt", dtype=F64)

    # --- supg ---------------------------------------------------------------

    def advect_supg(self, phi: Function, speed: Function, dt: float):
        """(phi+ + dt w.grad(phi+)) (v + tau w.grad v) = phi (v + tau
        w.grad v) with w = speed * grad(phi)/|grad(phi)|, assembled fresh
        each call (the structural kernel cache absorbs the rebuild) and
        solved on the host."""
        V = self.space
        u, v = TrialFunction(V), TestFunction(V)
        dx = Measure("dx", domain=self.mesh)
        self._dt_fn.x = torch.full_like(self._dt_fn.x, dt)
        dtc = CoefficientExpr(self._dt_fn)
        phie = CoefficientExpr(phi)
        se = CoefficientExpr(speed)
        gnorm = sqrt(inner(grad(phie), grad(phie)) + 1e-14)
        w = [se * grad(phie)[d] / gnorm for d in range(self.mesh.tdim)]
        wnorm = sqrt(sum(wi * wi for wi in w) + 1e-14)
        from .forms.dsl import CellDiameter
        h = CellDiameter(self.mesh)
        tau = self.tau_scale / sqrt((2.0 / dtc) * (2.0 / dtc)
                                    + (2.0 * wnorm / h) ** 2 + 1e-30)

        def transport(q):
            return sum(w[d] * grad(q)[d] for d in range(self.mesh.tdim))

        stream_v = transport(v)
        a = (u * v + dtc * transport(u) * v
             + tau * (u + dtc * transport(u)) * stream_v) * dx
        L = (phie * v + tau * phie * stream_v) * dx
        old = _host(phi.x)
        bcs = []
        if self.fixed_dofs.size:
            bcs = [fem.dirichletbc(old[self.fixed_dofs], self.fixed_dofs,
                                   V)]
        af, Lf = fem.form(a, dtype=F64), fem.form(L, dtype=F64)
        A = fem.assemble_matrix(af, bcs=bcs)
        b = _host(fem.assemble_vector(Lf))
        if bcs:
            b = fem.apply_lifting(b, [af], [bcs])
            b = fem.set_bc(b, bcs)
        from .la import direct_solve
        _set_values(phi, direct_solve(A, b))
        return phi

    # --- nodal ---------------------------------------------------------------

    def _nodal_gradient(self):
        """Per-dof least-squares gradient stencil over the dofs sharing a
        cell: grad ~= W @ (phi[nbrs] - phi[dof]) with W = pinv(D), D the
        neighbours' offsets (ascending neighbour order). Dofs with equal
        neighbour counts are handled as one batch. Returns (nbr_ptr, nbrs,
        groups): CSR neighbour lists and [(dofs, W (n, gdim, k))]."""
        if self._nodal_cache is not None:
            return self._nodal_cache
        V = self.space
        coords = np.asarray(V.dof_coordinates)
        nd = coords.shape[0]
        cd = np.asarray(V.dofmap, np.int64)
        nl = cd.shape[1]
        rows = np.repeat(cd, nl, axis=1).ravel()
        cols = np.tile(cd, (1, nl)).ravel()
        pairs = np.unique(rows * nd + cols)
        r, c = pairs // nd, pairs % nd
        keep = r != c
        r, c = r[keep], c[keep]
        counts = np.bincount(r, minlength=nd)
        ptr = np.concatenate([[0], np.cumsum(counts)])
        groups = []
        for k in np.unique(counts[counts > 0]):
            dofs = np.flatnonzero(counts == k)
            nb = c[ptr[dofs][:, None] + np.arange(k)]          # (n, k)
            D = coords[nb] - coords[dofs][:, None, :]          # (n, k, g)
            groups.append((dofs, nb, np.linalg.pinv(D)))       # (n, g, k)
        self._nodal_cache = groups
        return groups

    def advect_nodal(self, phi: Function, speed: Function, dt: float):
        groups = self._nodal_gradient()
        old = _host(phi.x)
        sp = _host(speed.x)
        gn = np.zeros_like(old)
        for dofs, nb, W in groups:
            df = old[nb] - old[dofs][:, None]
            gn[dofs] = np.linalg.norm(np.einsum("ngk,nk->ng", W, df), axis=1)
        new = old - dt * sp * gn
        if self.fixed_dofs.size:
            new[self.fixed_dofs] = old[self.fixed_dofs]
        _set_values(phi, new)
        return phi

    # --- characteristics -----------------------------------------------------

    def advect_characteristics(self, phi: Function, velocity: Function,
                               dt: float):
        """Semi-Lagrangian RK2: midpoint velocity, then pull phi back
        from the departure points. ``velocity`` is the vector extension
        field (bs = gdim)."""
        V = self.space
        old = _host(phi.x)
        pts = np.asarray(V.dof_coordinates)
        v0 = evaluate_at_points(velocity, pts)
        half = pts - 0.5 * dt * np.atleast_2d(v0)
        vmid = evaluate_at_points(velocity, half)
        dep = pts - dt * np.atleast_2d(vmid)
        # departure points clamped into the mesh box (the nearest-cell
        # fallback handles the rest)
        lo = np.asarray(V.mesh.vertices).min(axis=0)
        hi = np.asarray(V.mesh.vertices).max(axis=0)
        new = np.asarray(evaluate_at_points(phi, np.clip(dep, lo, hi))) \
            .reshape(-1)
        if self.fixed_dofs.size:
            new[self.fixed_dofs] = old[self.fixed_dofs]
        _set_values(phi, new)
        return phi

    def advect(self, phi, extension, dt, method="supg"):
        """Dispatch. ``extension`` is a NormalExtensionResult (or any
        object with .speed / .velocity)."""
        if method == "supg":
            return self.advect_supg(phi, extension.speed, dt)
        if method == "nodal":
            return self.advect_nodal(phi, extension.speed, dt)
        if method == "characteristics":
            return self.advect_characteristics(phi, extension.velocity,
                                               dt)
        raise ValueError(f"unknown advection method {method!r}")


# -- checkpoint / resume ---------------------------------------------------
# The complete optimizer state (design = level-set dofs, L-BFGS pair
# history, ALM multipliers, BB step memory) is plain numpy data, so a
# restartable checkpoint is one atomic .npz file, in the same layout as
# cutfemx_tpu's.


def save_checkpoint(path, *, iteration: int, phi=None,
                    lbfgs: LBFGSState | None = None,
                    alm: AugmentedLagrangianState | None = None,
                    step: AdaptiveGradientStepState | None = None,
                    dt: float | None = None,
                    scalars: dict | None = None) -> None:
    """Write an atomic optimizer checkpoint.

    ``phi`` may be a Function (its dof values are stored, copied to the
    host) or an array.
    ``scalars`` is an optional flat dict of float/int/str metadata
    (e.g. best objective so far). The file is written to a sibling tmp
    path then renamed, so a crash mid-write never corrupts the previous
    checkpoint."""
    import json as _json
    import os as _os

    payload: dict = {"iteration": np.int64(iteration),
                     "version": np.int64(1)}
    if phi is not None:
        vals = getattr(phi, "x", phi)
        if isinstance(vals, torch.Tensor):
            vals = vals.detach().cpu().numpy()
        payload["phi"] = np.asarray(vals)
    if dt is not None:
        payload["dt"] = np.float64(dt)
    if lbfgs is not None:
        k = len(lbfgs.s_hist)
        if k:
            payload["lbfgs_s"] = np.stack(
                [np.asarray(s, float) for s in lbfgs.s_hist])
            payload["lbfgs_y"] = np.stack(
                [np.asarray(y, float) for y in lbfgs.y_hist])
            payload["lbfgs_rho"] = np.asarray(lbfgs.inv_sy, float)
        if lbfgs.anchor_x is not None:
            payload["lbfgs_prev_x"] = np.asarray(lbfgs.anchor_x, float)
        if lbfgs.anchor_grad is not None:
            payload["lbfgs_prev_g"] = np.asarray(lbfgs.anchor_grad,
                                                 float)
        payload["lbfgs_meta"] = np.asarray(
            [float(lbfgs.curvature_sy),
             1.0 if lbfgs.pair_accepted else 0.0])
    if alm is not None:
        payload["alm"] = np.asarray(
            [alm.multiplier, alm.penalty, alm.rho_growth,
             alm.rho_max, alm.slack], float)
    if step is not None:
        if step.anchor_phi is not None:
            payload["step_prev_phi"] = np.asarray(step.anchor_phi, float)
        if step.anchor_grad is not None:
            payload["step_prev_g"] = np.asarray(step.anchor_grad,
                                                float)
        payload["step_dt"] = np.float64(step.dt_accepted)
    if scalars:
        payload["scalars_json"] = np.frombuffer(
            _json.dumps(scalars).encode(), dtype=np.uint8).copy()

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
        f.flush()
        _os.fsync(f.fileno())
    _os.replace(tmp, path)


def load_checkpoint(path, *, phi=None) -> dict:
    """Read a checkpoint written by :func:`save_checkpoint`.

    Returns a dict with keys ``iteration``, and (when present in the
    file) ``phi`` (ndarray), ``dt``, ``lbfgs`` (LBFGSState), ``alm``
    (AugmentedLagrangianState), ``step`` (AdaptiveGradientStepState),
    ``scalars`` (dict). If ``phi`` (a Function) is passed, its dof
    values are restored in place, on its device in its dtype."""
    import json as _json

    with np.load(path, allow_pickle=False) as z:
        out: dict = {"iteration": int(z["iteration"])}
        if "phi" in z:
            out["phi"] = np.asarray(z["phi"])
            if phi is not None:
                if tuple(phi.x.shape) != out["phi"].shape:
                    raise ValueError(
                        f"checkpoint phi has shape {out['phi'].shape}, "
                        f"target Function has {tuple(phi.x.shape)}")
                _set_values(phi, out["phi"])
        if "dt" in z:
            out["dt"] = float(z["dt"])
        if "lbfgs_meta" in z:
            st = LBFGSState()
            if "lbfgs_s" in z:
                st.s_hist = [np.asarray(s) for s in z["lbfgs_s"]]
                st.y_hist = [np.asarray(y) for y in z["lbfgs_y"]]
                st.inv_sy = [float(r) for r in z["lbfgs_rho"]]
            if "lbfgs_prev_x" in z:
                st.anchor_x = np.asarray(z["lbfgs_prev_x"])
            if "lbfgs_prev_g" in z:
                st.anchor_grad = np.asarray(z["lbfgs_prev_g"])
            st.curvature_sy = float(z["lbfgs_meta"][0])
            st.pair_accepted = bool(z["lbfgs_meta"][1] > 0.5)
            out["lbfgs"] = st
        if "alm" in z:
            a = z["alm"]
            out["alm"] = AugmentedLagrangianState(
                multiplier=float(a[0]), penalty=float(a[1]),
                rho_growth=float(a[2]), rho_max=float(a[3]),
                slack=float(a[4]))
        if "step_dt" in z:
            sp = AdaptiveGradientStepState(dt_accepted=float(z["step_dt"]))
            if "step_prev_phi" in z:
                sp.anchor_phi = np.asarray(z["step_prev_phi"])
            if "step_prev_g" in z:
                sp.anchor_grad = np.asarray(z["step_prev_g"])
            out["step"] = sp
        if "scalars_json" in z:
            out["scalars"] = _json.loads(bytes(z["scalars_json"]).decode())
    return out
