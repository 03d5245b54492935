"""Form compiler: expression -> batched torch element kernels.

The torch counterpart of ``cutfemx_tpu.forms.compile``: the element kernel
is a torch function of one entity, and the element matrix/vector is
extracted from the scalar integrand by automatic differentiation
(``torch.func.grad`` and ``jacfwd(jacrev(...))``, vmapped over entities) —
exact for (multi)linear forms. Real dtypes only; complex forms wait for
ROADMAP item 9.

Kernel layout per integral type (single entity; vmapped over entities):

cell:            coords (nv, gdim); points (Q, tdim) [runtime: per entity],
                 weights: reference (shared) or physical (runtime)
exterior_facet:  coords (nv, gdim); local_facet (); facet-ref rule shared,
                 or runtime cell-ref points + physical weights
interior_facet:  coords (2, nv, gdim); local_facet (2,); '+' side maps the
                 shared facet rule, '-' side is the pullback of the same
                 physical points (affine on simplices, Newton's map on
                 quadrilaterals and hexahedra)

Weight convention: runtime quadrature weights are PHYSICAL (they already
include the volume or surface measure), mirroring how the reference's
CutCells rules fold the cut-part measure into the weights; standard rules
are reference weights scaled by |det J| (volume) or the facet Gram
determinant (surface) inside the kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from ..cells import reference_cell
from ..elements import lagrange_element
from ..geometry import (facet_reference_normals, gram_det,
                        map_facet_points, take_row)
from ..quadrature import quadrature_rule
from .dsl import (Argument, extract_arguments, extract_coefficients,
                  extract_qfields, estimate_degree)

__all__ = ["compile_integral", "IntegralKernel", "EvalCtx",
           "expr_signature"]


def _space_sig(space):
    return (space.mesh.cell_type, space.family, space.degree,
            space.value_shape)


def expr_signature(e, _memo=None):
    """Structural signature of an expression for kernel caching — the role
    of the reference's runintgen JIT cache (_runintgen_adapter.py:181-217):
    rebuilding the same weak form on new data reuses the compiled kernel.

    Coefficients and quadrature fields hash by occurrence order and space
    signature (their values are runtime data); Python-number constants hash
    by value (they are baked into the trace)."""
    from .dsl import (Argument, CoefficientExpr, ConstantExpr,
                      QuadratureField, SpatialCoordinate, FacetNormal,
                      CellDiameter, Identity, Indexed, Restricted)
    if _memo is None:
        _memo = {}

    def sig(n):
        t = type(n).__name__
        if isinstance(n, Argument):
            return (t, n.number, n.part, _space_sig(n.space))
        if isinstance(n, CoefficientExpr):
            key = id(n.function)
            ordinal = _memo.setdefault(key, len(_memo))
            return (t, ordinal, _space_sig(n.function.function_space))
        if isinstance(n, ConstantExpr):
            v = np.asarray(n.value)
            return (t, v.shape, v.tobytes() if v.size < 64 else id(n.value))
        if isinstance(n, QuadratureField):
            key = ("qf", n.uid)
            ordinal = _memo.setdefault(key, len(_memo))
            return (t, n.name, n.shape, ordinal)
        if isinstance(n, (SpatialCoordinate, FacetNormal, CellDiameter)):
            return (t, n.mesh.gdim)
        if isinstance(n, Identity):
            return (t, n.d)
        extra = ()
        if isinstance(n, Indexed):
            extra = (n.idx,)
        if isinstance(n, Restricted):
            extra = (n.side,)
        return (t,) + extra + tuple(sig(c) for c in n.children())

    return sig(e)


class EvalCtx:
    """Evaluation context for one entity (vmapped over entities)."""

    def __init__(self, cell_type, gdim, dtype, device, Q, sides,
                 arg_vectors, coeff_map, qfield_map, shared_basis, itype):
        self.cell_type = cell_type
        self.cell = reference_cell(cell_type)
        self.tdim = self.cell.tdim
        self.gdim = gdim
        self.dtype = dtype
        self.device = device
        self.Q = Q
        self.sides = sides          # dict side_key -> dict
        self.arg_vectors = arg_vectors  # {number: flat array}
        self.coeff_map = coeff_map      # {id(func): flat array or (2, ...)}
        self.qfield_map = qfield_map    # {uid: (Q, *shape)}
        self.shared_basis = shared_basis  # {sig: (val, refgrad)} or {}
        self.itype = itype
        self._cache = {}

    # -- side resolution -----------------------------------------------------

    def _key(self, side):
        if self.itype == "cell":
            return "cell"
        if self.itype == "exterior_facet":
            return "+"
        if side is None:
            raise ValueError(
                "interior-facet integrands must be restricted ('+'/'-')")
        return side

    def side(self, side):
        return self.sides[self._key(side)]

    # -- geometry ------------------------------------------------------------

    def J(self, side):
        key = ("J", self._key(side))
        if key not in self._cache:
            s = self.side(side)
            el = lagrange_element(self.cell_type, 1)
            dphi = el.tabulate_grad(s["points"])  # (Q, nv, tdim)
            self._cache[key] = torch.einsum("vg,qvt->qgt", s["coords"],
                                            dphi)
        return self._cache[key]

    def K(self, side):
        key = ("K", self._key(side))
        if key not in self._cache:
            J = self.J(side)
            if J.shape[-1] == J.shape[-2]:
                self._cache[key] = torch.linalg.inv(J)
            else:
                self._cache[key] = torch.linalg.pinv(J)
        return self._cache[key]

    def detJ(self, side):
        key = ("detJ", self._key(side))
        if key not in self._cache:
            self._cache[key] = gram_det(self.J(side))
        return self._cache[key]

    def x(self, side):
        key = ("x", self._key(side))
        if key not in self._cache:
            s = self.side(side)
            el = lagrange_element(self.cell_type, 1)
            phi = el.tabulate(s["points"])
            self._cache[key] = torch.einsum("qv,vg->qg", phi, s["coords"])
        return self._cache[key]

    def cell_diameter(self, side):
        s = self.side(side)
        return torch.broadcast_to(s["h"], (self.Q,))

    def facet_normal(self, side):
        if self.itype == "cell":
            # interface rules: geometric normal unavailable; the reference
            # uses cutfemx.normal(phi) (a QuadratureField) there as well.
            raise ValueError("FacetNormal is not defined on cell integrals; "
                             "use cutfemx_tpu_torch.normal(phi) on "
                             "interface measures")
        key = ("normal", "+")
        if key not in self._cache:
            splus = self.sides["+"]
            ref_normals = torch.as_tensor(
                facet_reference_normals(self.cell_type), dtype=self.dtype,
                device=self.device)
            nref = take_row(ref_normals, splus["local_facet"])
            Kp = self.K("+")  # (Q, tdim, gdim)
            n = torch.einsum("qtg,t->qg", Kp, nref)
            n = n / torch.linalg.norm(n, dim=-1, keepdim=True)
            self._cache[key] = n
        n = self._cache[key]
        if self.itype == "interior_facet" and self._key(side) == "-":
            return -n
        return n

    # -- basis ---------------------------------------------------------------

    def basis(self, space, side):
        sig = _space_sig(space)
        key = ("basis", sig, self._key(side))
        if key not in self._cache:
            s = self.side(side)
            el = space.element
            if sig in self.shared_basis and s.get("points_shared", False):
                val, rg = self.shared_basis[sig]
                val = torch.as_tensor(val, dtype=self.dtype,
                                      device=self.device)
                rg = torch.as_tensor(rg, dtype=self.dtype,
                                     device=self.device)
            else:
                val = el.tabulate(s["points"])
                rg = el.tabulate_grad(s["points"])
            K = self.K(side)  # (Q, tdim, gdim)
            pg = torch.einsum("qnt,qtg->qng", rg, K)
            self._cache[key] = (val, pg)
        return self._cache[key]

    def _field(self, space, flat, side, want_grad):
        """Evaluate a dof vector ``flat`` of ``space`` at quadrature points.

        flat: (nd*bs,) for cell/exterior, (2*nd*bs,) for interior facets.
        """
        nd = space.element.ndofs
        bs = space.bs
        if self.itype == "interior_facet":
            half = nd * bs
            offset = 0 if self._key(side) == "+" else half
            coeffs = flat[offset:offset + half]
        else:
            coeffs = flat
        c = coeffs.reshape(nd, bs)
        val, pg = self.basis(space, side)
        if want_grad:
            out = torch.einsum("qng,nb->qbg", pg, c)
            if not space.value_shape:
                out = out[:, 0, :]
            return out
        out = torch.einsum("qn,nb->qb", val, c)
        if not space.value_shape:
            out = out[:, 0]
        return out

    def arg_value(self, arg, side):
        vec = self.arg_vectors.get(arg.key)
        if vec is None:
            # other block parts are held at zero during block extraction
            return torch.zeros((self.Q,) + arg.shape, dtype=self.dtype,
                               device=self.device)
        return self._field(arg.space, vec, side, want_grad=False)

    def arg_grad(self, arg, side):
        vec = self.arg_vectors.get(arg.key)
        if vec is None:
            return torch.zeros((self.Q,) + arg.shape + (self.gdim,),
                               dtype=self.dtype, device=self.device)
        return self._field(arg.space, vec, side, want_grad=True)

    def coeff_value(self, cexpr, side):
        f = cexpr.function
        return self._field(f.function_space, self.coeff_map[id(f)], side,
                           want_grad=False)

    def coeff_grad(self, cexpr, side):
        f = cexpr.function
        return self._field(f.function_space, self.coeff_map[id(f)], side,
                           want_grad=True)

    def qfield_value(self, qf, side):
        v = self.qfield_map[qf.uid]
        if getattr(qf, "side_dependent", False):
            if self.itype != "interior_facet":
                raise ValueError(
                    f"{qf.name} is side-aware and needs a dS measure")
            v = v[0] if self._key(side) == "+" else v[1]
        return v


# entities per vmapped kernel call: bounds the AD intermediates of the
# matrix kernel (about 2 KB per entity and quadrature point for P2 in f64)
_ENTITY_CHUNK = 1 << 15


def _chunks(data, E, size):
    """Split every leaf of a batched data pytree along the entity axis."""
    def cut(a, lo, hi):
        if isinstance(a, tuple):
            return tuple(cut(x, lo, hi) for x in a)
        return a[lo:hi]
    for lo in range(0, E, size):
        yield {k: cut(v, lo, lo + size) for k, v in data.items()}


class IntegralKernel:
    """Compiled kernel for one integral: callables over batched entity data.

    data pytree (batched over E):
      coords:     (E, nv, g) | (E, 2, nv, g)
      points:     (E, Q, t)   (runtime only)
      weights:    (E, Q)      (runtime only, physical)
      local_facet:(E,) | (E, 2)
      h:          (E,) | (E, 2)
      coeffs:     tuple of (E, nd*bs) | (E, 2*nd*bs)
      qfields:    tuple of (E, Q, *shape)
    """

    def __init__(self, integral, cell_type, gdim, runtime, qdegree=None):
        self.integral = integral
        expr = integral.integrand
        self.cell_type = cell_type
        self.gdim = gdim
        self.itype = integral.integral_type
        self.runtime = runtime
        self.args = extract_arguments(expr)   # {(number, part): Argument}
        self.coefficients = extract_coefficients(expr)
        self.qfields = extract_qfields(expr)
        numbers = sorted({num for num, _ in self.args})
        self.rank = len(numbers)
        if numbers and numbers != list(range(self.rank)):
            raise ValueError("argument numbers must be 0..rank-1")

        cell = reference_cell(cell_type)
        self.tdim = cell.tdim
        md = integral.measure.metadata
        self.qdegree = qdegree or md.get("quadrature_degree") or \
            (estimate_degree(expr) + (cell.tdim if not cell.is_simplex else 0))

        # static quadrature for standard integrals
        if not runtime:
            if self.itype == "cell":
                pts, wts = quadrature_rule(cell_type, self.qdegree)
                self.ref_points = pts
                self.ref_weights = wts
            else:
                fct = cell.facet_cell_type
                pts, wts = quadrature_rule(fct, self.qdegree)
                self.facet_ref_points = pts
                self.ref_weights = wts
            self.Q = len(wts)
        else:
            self.Q = None  # determined by padded rules at call time

        self.fverts_table = reference_cell(cell_type).facet_vertices_coords()

        # shared basis tabulation for standard cell integrals
        self.shared_basis = {}
        if not runtime and self.itype == "cell":
            for sp in self._all_spaces():
                sig = _space_sig(sp)
                if sig not in self.shared_basis:
                    el = sp.element
                    self.shared_basis[sig] = (
                        el.tabulate(self.ref_points),
                        el.tabulate_grad(self.ref_points))

        self._batched = {}

    def _all_spaces(self):
        out = [a.space for a in self.args.values()]
        out += [f.function_space for f in self.coefficients]
        return out

    # -- entity-level evaluation --------------------------------------------

    def _make_sides(self, data, dtype, device):
        """Build per-side geometric data for one entity."""
        ct = self.cell_type

        def const(a):
            return torch.as_tensor(a, dtype=dtype, device=device)

        sides = {}
        if self.itype == "cell":
            pts = data["points"] if self.runtime else const(self.ref_points)
            sides["cell"] = dict(points=pts, coords=data["coords"],
                                 h=data["h"], points_shared=not self.runtime)
        elif self.itype == "exterior_facet":
            if self.runtime:
                pts = data["points"]
            else:
                pts = map_facet_points(ct, data["local_facet"],
                                       const(self.facet_ref_points),
                                       self.fverts_table)
            sides["+"] = dict(points=pts, coords=data["coords"],
                              h=data["h"], local_facet=data["local_facet"])
        else:  # interior facet
            lf = data["local_facet"]
            coords = data["coords"]  # (2, nv, g)
            if self.runtime:
                pts_p = data["points"]
            else:
                pts_p = map_facet_points(ct, lf[0],
                                         const(self.facet_ref_points),
                                         self.fverts_table)
            # physical points from '+' side, pulled back into '-' side
            el1 = lagrange_element(ct, 1)
            phi = el1.tabulate(pts_p)
            xq = torch.einsum("qv,vg->qg", phi, coords[0])
            from ..geometry import pullback
            pts_m = pullback(ct, coords[1], xq)
            sides["+"] = dict(points=pts_p, coords=coords[0], h=data["h"][0],
                              local_facet=lf[0])
            sides["-"] = dict(points=pts_m, coords=coords[1], h=data["h"][1],
                              local_facet=lf[1])
        return sides

    def _weights(self, ctx, data, dtype, device):
        mask = data.get("mask")
        if self.runtime:
            w = data["weights"]
            return w if mask is None else w * mask
        w = torch.as_tensor(self.ref_weights, dtype=dtype, device=device)
        if self.itype == "cell":
            w = w * ctx.detJ(None)
            return w if mask is None else w * mask
        # standard facet rule: reference facet weights * surface measure
        cell = reference_cell(self.cell_type)
        fct = cell.facet_cell_type
        s = ctx.sides["+"]
        if fct == "point":
            return w
        fel = lagrange_element(fct, 1)
        fpts = torch.as_tensor(self.facet_ref_points, dtype=dtype,
                               device=device)
        dphi = fel.tabulate_grad(fpts)  # (Q, nvf, fdim)
        fv = take_row(torch.as_tensor(self.fverts_table, dtype=dtype,
                                      device=device), s["local_facet"])
        T = torch.einsum("qvf,vt->qtf", dphi, fv)       # (Q, tdim, fdim)
        Jf = torch.einsum("qgt,qtf->qgf", ctx.J("+"), T)
        w = w * gram_det(Jf)
        return w if mask is None else w * mask

    def _entity_scalar(self, data, arg_vectors, dtype):
        device = data["coords"].device
        sides = self._make_sides(data, dtype, device)
        Q = sides["+" if self.itype != "cell" else "cell"][
            "points"].shape[0]
        coeff_map = {id(f): c for f, c in zip(self.coefficients,
                                              data.get("coeffs", ()))}
        qfield_map = {qf.uid: v for qf, v in zip(self.qfields,
                                                 data.get("qfields", ()))}
        ctx = EvalCtx(self.cell_type, self.gdim, dtype, device, Q, sides,
                      arg_vectors, coeff_map, qfield_map, self.shared_basis,
                      self.itype)
        vals = self.integral.integrand.eval(ctx, None)
        if vals.ndim != 1:
            raise ValueError(
                f"integrand must be scalar, got shape {vals.shape[1:]}")
        w = self._weights(ctx, data, dtype, device)
        return torch.sum(vals * w)

    def _arg_size(self, arg):
        sp = arg.space
        n = sp.element.ndofs * sp.bs
        return 2 * n if self.itype == "interior_facet" else n

    # -- public batched entry points ----------------------------------------

    def _get(self, kind, dtype, block=(None, None)):
        """The per-entity kernel of ``kind`` ("scalar", "vector" or
        "matrix"), vmapped over entities."""
        key = (kind, str(dtype), block)
        if key in self._batched:
            return self._batched[key]
        if dtype.is_complex:
            raise NotImplementedError(
                "complex forms (ROADMAP item 9: holomorphic AD)")
        if kind == "scalar":
            def one(data):
                return self._entity_scalar(data, {}, dtype)
        elif kind == "vector":
            varg = self.args[(0, block[0])]
            nv = self._arg_size(varg)
            vkey = varg.key

            def one(data):
                z = torch.zeros(nv, dtype=dtype,
                                device=data["coords"].device)
                return torch.func.grad(
                    lambda v: self._entity_scalar(data, {vkey: v}, dtype))(z)
        elif kind == "matrix":
            varg = self.args[(0, block[0])]
            uarg = self.args[(1, block[1])]
            nv, nu = self._arg_size(varg), self._arg_size(uarg)
            vkey, ukey = varg.key, uarg.key

            def one(data):
                dev = data["coords"].device
                zu = torch.zeros(nu, dtype=dtype, device=dev)
                zv = torch.zeros(nv, dtype=dtype, device=dev)

                def f(u, v):
                    return self._entity_scalar(data, {vkey: v, ukey: u},
                                               dtype)
                return torch.func.jacfwd(torch.func.jacrev(f, argnums=1),
                                         argnums=0)(zu, zv)  # (nv, nu)
        else:  # pragma: no cover
            raise ValueError(kind)
        fn = torch.func.vmap(one)
        self._batched[key] = fn
        return fn

    def _run(self, kind, data, dtype, block):
        fn = self._get(kind, dtype, block)
        E = data["coords"].shape[0]
        return torch.cat([fn(d) for d in _chunks(data, E, _ENTITY_CHUNK)])

    def assemble_scalar(self, data, dtype):
        """-> 0-d tensor: the integrand summed over quadrature points and
        entities."""
        return self._run("scalar", data, dtype, (None, None)).sum()

    def assemble_vector(self, data, dtype, block=(None, None)):
        """-> (E, nv) element vectors."""
        return self._run("vector", data, dtype, block)

    def assemble_matrix(self, data, dtype, block=(None, None)):
        """-> (E, nv, nu) element matrices (rows: test, cols: trial)."""
        return self._run("matrix", data, dtype, block)


_KERNEL_CACHE: dict = {}


def compile_integral(integral, cell_type, gdim, runtime, qdegree=None):
    """Build (or fetch) the kernel for an integral. Structurally identical
    integrands share kernels across form rebuilds — coefficient and
    quadrature-field data are passed positionally, so the cached kernel is
    value-independent."""
    key = (expr_signature(integral.integrand), cell_type, gdim,
           integral.integral_type, runtime, qdegree,
           integral.measure.metadata.get("quadrature_degree"))
    kern = _KERNEL_CACHE.get(key)
    if kern is None:
        kern = IntegralKernel(integral, cell_type, gdim, runtime, qdegree)
        _KERNEL_CACHE[key] = kern
    return kern
