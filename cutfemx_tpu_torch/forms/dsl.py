"""Symbolic weak-form expression language (mini-UFL), evaluated with torch.

The torch counterpart of ``cutfemx_tpu.forms.dsl``: expressions are Python
objects evaluated directly as tensor computations at quadrature points.
Nothing here updates a tensor in place, so evaluation runs under
``torch.func.vmap`` and the AD transforms of the form compiler.

Supported value shapes: scalars (), vectors (d,), second-order tensors (d,d).
``grad`` is implemented symbolically via chain/product rules over the node
types that appear in weak forms.

Evaluation contract: ``node.eval(ctx, side)`` returns an array of shape
(Q, *node.shape) for a single entity; batching over entities happens by
``torch.func.vmap`` in the compiler. ``ctx`` is a ``forms.compile.EvalCtx``.
"""

from __future__ import annotations

import numpy as np

import torch

__all__ = [
    "Expr", "Argument", "TrialFunction", "TestFunction", "TrialFunctions",
    "TestFunctions", "MixedFunctionSpace", "CoefficientExpr",
    "ConstantExpr", "SpatialCoordinate", "FacetNormal", "CellDiameter",
    "QuadratureField", "Identity", "grad", "div", "nabla_grad", "inner",
    "dot", "outer", "sym", "tr", "dev", "transpose", "jump", "avg", "sqrt",
    "sin", "cos", "exp", "ln", "as_vector", "as_expr", "conditional", "lt",
    "gt", "le", "ge", "pi",
]

pi = float(np.pi)


def as_expr(v):
    if isinstance(v, Expr):
        return v
    if isinstance(v, (int, float, complex, np.floating, np.integer)):
        return ConstantExpr(v)
    from ..functionspace import Constant, Function
    if isinstance(v, Function):
        return CoefficientExpr(v)
    if isinstance(v, Constant):
        return ConstantExpr(v.value)
    if isinstance(v, (torch.Tensor, np.ndarray)):
        return ConstantExpr(v)
    raise TypeError(f"cannot convert {type(v)} to an expression")


class Expr:
    shape: tuple = ()

    # -- operator sugar -----------------------------------------------------
    def __add__(self, o):
        return Sum(self, as_expr(o))

    def __radd__(self, o):
        return Sum(as_expr(o), self)

    def __sub__(self, o):
        return Sum(self, Neg(as_expr(o)))

    def __rsub__(self, o):
        return Sum(as_expr(o), Neg(self))

    def __mul__(self, o):
        from .measure import Measure
        if isinstance(o, Measure):
            return o.__rmul__(self)
        return Product(self, as_expr(o))

    def __rmul__(self, o):
        return Product(as_expr(o), self)

    def __truediv__(self, o):
        return Division(self, as_expr(o))

    def __rtruediv__(self, o):
        return Division(as_expr(o), self)

    def __pow__(self, o):
        return Power(self, as_expr(o))

    def __neg__(self):
        return Neg(self)

    def __getitem__(self, idx):
        return Indexed(self, idx)

    def __call__(self, side):
        if side not in ("+", "-"):
            raise ValueError(side)
        return Restricted(self, side)

    # -- interface ----------------------------------------------------------
    def children(self):
        return ()

    def eval(self, ctx, side):
        raise NotImplementedError(type(self).__name__)

    def eval_grad(self, ctx, side):
        """Return spatial gradient with shape (Q, *shape, gdim)."""
        raise NotImplementedError(
            f"grad not implemented for {type(self).__name__}")


def _scalar_only(*exprs):
    for e in exprs:
        if e.shape != ():
            raise ValueError(
                f"expected scalar operand, got shape {e.shape} from "
                f"{type(e).__name__}")


# ---------------------------------------------------------------------------
# terminals
# ---------------------------------------------------------------------------


class Argument(Expr):
    """Trial (number=1) or test (number=0) function. ``part`` indexes the
    sub-space in a mixed (block) form; None for plain forms."""

    def __init__(self, space, number, part=None, mixed=None):
        self.space = space
        self.number = number
        self.part = part
        self.mixed = mixed  # owning MixedFunctionSpace for block forms
        self.shape = space.value_shape

    @property
    def key(self):
        return (self.number, self.part)

    def children(self):
        return ()

    def eval(self, ctx, side):
        return ctx.arg_value(self, side)

    def eval_grad(self, ctx, side):
        return ctx.arg_grad(self, side)


def TrialFunction(space):
    return Argument(space, 1)


def TestFunction(space):
    return Argument(space, 0)


class MixedFunctionSpace:
    """Ordered collection of spaces for block forms
    (the role of ufl.MixedFunctionSpace in
    upstream CutFEMx python/demo/demo_interface_poisson.py:190)."""

    def __init__(self, *spaces):
        self.spaces = tuple(spaces)

    def __len__(self):
        return len(self.spaces)

    @property
    def offsets(self):
        """Monolithic dof offsets: part i occupies
        [offsets[i], offsets[i+1])."""
        import numpy as _np
        return _np.concatenate([[0], _np.cumsum(
            [sp.dim for sp in self.spaces])]).astype(_np.int64)

    @property
    def dim(self):
        return int(sum(sp.dim for sp in self.spaces))

    def sub(self, i):
        return self.spaces[i]


def TrialFunctions(W: MixedFunctionSpace):
    return tuple(Argument(sp, 1, part=i, mixed=W)
                 for i, sp in enumerate(W.spaces))


def TestFunctions(W: MixedFunctionSpace):
    return tuple(Argument(sp, 0, part=i, mixed=W)
                 for i, sp in enumerate(W.spaces))


class CoefficientExpr(Expr):
    def __init__(self, function):
        self.function = function
        self.shape = function.function_space.value_shape

    def eval(self, ctx, side):
        return ctx.coeff_value(self, side)

    def eval_grad(self, ctx, side):
        return ctx.coeff_grad(self, side)


class ConstantExpr(Expr):
    def __init__(self, value):
        self.value = value
        v = value if isinstance(value, torch.Tensor) else np.asarray(value)
        self.shape = tuple(v.shape)

    def eval(self, ctx, side):
        v = torch.as_tensor(self.value, dtype=ctx.dtype, device=ctx.device)
        return torch.broadcast_to(v, (ctx.Q,) + self.shape)

    def eval_grad(self, ctx, side):
        return torch.zeros((ctx.Q,) + self.shape + (ctx.gdim,),
                           dtype=ctx.dtype, device=ctx.device)


class SpatialCoordinate(Expr):
    def __init__(self, mesh):
        self.mesh = mesh
        self.shape = (mesh.gdim,)

    def eval(self, ctx, side):
        return ctx.x(side)

    def eval_grad(self, ctx, side):
        eye = torch.eye(ctx.gdim, dtype=ctx.dtype, device=ctx.device)
        return torch.broadcast_to(eye, (ctx.Q, ctx.gdim, ctx.gdim))


class FacetNormal(Expr):
    """Geometric facet normal; on interior facets the '+'-side outward
    normal, with n('-') = -n('+') (UFL convention)."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.shape = (mesh.gdim,)

    def eval(self, ctx, side):
        return ctx.facet_normal(side)


class CellDiameter(Expr):
    def __init__(self, mesh):
        self.mesh = mesh
        self.shape = ()

    def eval(self, ctx, side):
        return ctx.cell_diameter(side)


class QuadratureField(Expr):
    """A field defined by data at runtime quadrature points (the reference's
    QuadratureFunction, _runintgen_adapter.py:131-178): e.g. the level-set
    normal. The evaluator is called once per (rules, field) at assembly."""

    _counter = [0]

    def __init__(self, name, shape, evaluator, mesh=None,
                 side_dependent=False):
        self.name = name
        self.shape = tuple(shape)
        self.evaluator = evaluator  # evaluator(rules[, side]) -> array
        self.mesh = mesh
        self.side_dependent = side_dependent
        QuadratureField._counter[0] += 1
        self.uid = QuadratureField._counter[0]

    def eval(self, ctx, side):
        return ctx.qfield_value(self, side)


class Identity(Expr):
    def __init__(self, d):
        self.d = d
        self.shape = (d, d)

    def eval(self, ctx, side):
        eye = torch.eye(self.d, dtype=ctx.dtype, device=ctx.device)
        return torch.broadcast_to(eye, (ctx.Q, self.d, self.d))

    def eval_grad(self, ctx, side):
        return torch.zeros((ctx.Q, self.d, self.d, ctx.gdim),
                           dtype=ctx.dtype, device=ctx.device)


# ---------------------------------------------------------------------------
# algebraic nodes
# ---------------------------------------------------------------------------


class Sum(Expr):
    def __init__(self, a, b):
        if a.shape != b.shape:
            raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")
        self.a, self.b = a, b
        self.shape = a.shape

    def children(self):
        return (self.a, self.b)

    def eval(self, ctx, side):
        return self.a.eval(ctx, side) + self.b.eval(ctx, side)

    def eval_grad(self, ctx, side):
        return self.a.eval_grad(ctx, side) + self.b.eval_grad(ctx, side)


class Neg(Expr):
    def __init__(self, a):
        self.a = a
        self.shape = a.shape

    def children(self):
        return (self.a,)

    def eval(self, ctx, side):
        return -self.a.eval(ctx, side)

    def eval_grad(self, ctx, side):
        return -self.a.eval_grad(ctx, side)


class Product(Expr):
    """Product where at least one factor is scalar (UFL semantics)."""

    def __init__(self, a, b):
        if a.shape != () and b.shape != ():
            raise ValueError("use inner/dot/outer for tensor products")
        self.a, self.b = a, b
        self.shape = a.shape or b.shape

    def children(self):
        return (self.a, self.b)

    def eval(self, ctx, side):
        av, bv = self.a.eval(ctx, side), self.b.eval(ctx, side)
        if self.a.shape == () and self.b.shape != ():
            av = av.reshape(av.shape + (1,) * len(self.b.shape))
        elif self.b.shape == () and self.a.shape != ():
            bv = bv.reshape(bv.shape + (1,) * len(self.a.shape))
        return av * bv

    def eval_grad(self, ctx, side):
        # product rule; scalar * tensor
        av, bv = self.a.eval(ctx, side), self.b.eval(ctx, side)
        ag, bg = self.a.eval_grad(ctx, side), self.b.eval_grad(ctx, side)
        ra, rb = len(self.a.shape), len(self.b.shape)
        # broadcast scalars over the other's shape (+ gdim axis)
        if ra == 0 and rb > 0:
            av = av.reshape(av.shape + (1,) * rb)
            ag = ag.reshape((ctx.Q,) + (1,) * rb + (ctx.gdim,))
        elif rb == 0 and ra > 0:
            bv = bv.reshape(bv.shape + (1,) * ra)
            bg = bg.reshape((ctx.Q,) + (1,) * ra + (ctx.gdim,))
        return ag * bv[..., None] + av[..., None] * bg


class Division(Expr):
    def __init__(self, a, b):
        _scalar_only(b)
        self.a, self.b = a, b
        self.shape = a.shape

    def children(self):
        return (self.a, self.b)

    def eval(self, ctx, side):
        av, bv = self.a.eval(ctx, side), self.b.eval(ctx, side)
        if self.a.shape != ():
            bv = bv.reshape(bv.shape + (1,) * len(self.a.shape))
        return av / bv

    def eval_grad(self, ctx, side):
        av = self.a.eval(ctx, side)
        bv = self.b.eval(ctx, side)
        ag = self.a.eval_grad(ctx, side)
        bg = self.b.eval_grad(ctx, side)
        ra = len(self.a.shape)
        if ra:
            bv = bv.reshape(bv.shape + (1,) * ra)
            bg = bg.reshape((ctx.Q,) + (1,) * ra + (ctx.gdim,))
        return (ag * bv[..., None] - av[..., None] * bg) / bv[..., None] ** 2


class Power(Expr):
    def __init__(self, a, b):
        _scalar_only(a, b)
        self.a, self.b = a, b
        self.shape = ()

    def children(self):
        return (self.a, self.b)

    def eval(self, ctx, side):
        return self.a.eval(ctx, side) ** self.b.eval(ctx, side)

    def eval_grad(self, ctx, side):
        if not isinstance(self.b, ConstantExpr):
            raise NotImplementedError("grad of a**b with non-constant b")
        p = self.b.eval(ctx, side)
        av = self.a.eval(ctx, side)
        ag = self.a.eval_grad(ctx, side)
        return p[..., None] * av[..., None] ** (p[..., None] - 1.0) * ag


class _UnaryFn(Expr):
    fn = None
    dfn = None

    def __init__(self, a):
        _scalar_only(a)
        self.a = a
        self.shape = ()

    def children(self):
        return (self.a,)

    def eval(self, ctx, side):
        return type(self).fn(self.a.eval(ctx, side))

    def eval_grad(self, ctx, side):
        av = self.a.eval(ctx, side)
        ag = self.a.eval_grad(ctx, side)
        return type(self).dfn(av)[..., None] * ag


class Sqrt(_UnaryFn):
    fn = staticmethod(torch.sqrt)
    dfn = staticmethod(lambda x: 0.5 / torch.sqrt(x))


class Sin(_UnaryFn):
    fn = staticmethod(torch.sin)
    dfn = staticmethod(torch.cos)


class Cos(_UnaryFn):
    fn = staticmethod(torch.cos)
    dfn = staticmethod(lambda x: -torch.sin(x))


class Exp(_UnaryFn):
    fn = staticmethod(torch.exp)
    dfn = staticmethod(torch.exp)


class Ln(_UnaryFn):
    fn = staticmethod(torch.log)
    dfn = staticmethod(lambda x: 1.0 / x)


class Abs(_UnaryFn):
    fn = staticmethod(torch.abs)
    dfn = staticmethod(torch.sign)


def sqrt(a):
    return Sqrt(as_expr(a))


def sin(a):
    return Sin(as_expr(a))


def cos(a):
    return Cos(as_expr(a))


def exp(a):
    return Exp(as_expr(a))


def ln(a):
    return Ln(as_expr(a))


# ---------------------------------------------------------------------------
# tensor algebra
# ---------------------------------------------------------------------------


class Inner(Expr):
    """Full contraction of two equal-shape operands."""

    def __init__(self, a, b):
        if a.shape != b.shape:
            raise ValueError(f"inner: {a.shape} vs {b.shape}")
        self.a, self.b = a, b
        self.shape = ()

    def children(self):
        return (self.a, self.b)

    def eval(self, ctx, side):
        av, bv = self.a.eval(ctx, side), self.b.eval(ctx, side)
        axes = tuple(range(1, av.ndim))
        return torch.sum(av * bv, dim=axes) if axes else av * bv


class Dot(Expr):
    """Contract last axis of a with first axis of b."""

    def __init__(self, a, b):
        if a.shape == () or b.shape == ():
            raise ValueError("dot requires non-scalar operands")
        if a.shape[-1] != b.shape[0]:
            raise ValueError(f"dot: {a.shape} . {b.shape}")
        self.a, self.b = a, b
        self.shape = a.shape[:-1] + b.shape[1:]

    def children(self):
        return (self.a, self.b)

    def eval(self, ctx, side):
        av, bv = self.a.eval(ctx, side), self.b.eval(ctx, side)
        # (Q, ..., k) . (Q, k, ...) -> (Q, ..., ...)
        return _dot(av, bv)


def _dot(av, bv):
    ra = av.ndim - 1
    rb = bv.ndim - 1
    if ra == 1 and rb == 1:
        return torch.sum(av * bv, dim=-1)
    if ra == 2 and rb == 1:
        return torch.einsum("qij,qj->qi", av, bv)
    if ra == 1 and rb == 2:
        return torch.einsum("qi,qij->qj", av, bv)
    if ra == 2 and rb == 2:
        return torch.einsum("qij,qjk->qik", av, bv)
    raise NotImplementedError((ra, rb))


class Outer(Expr):
    def __init__(self, a, b):
        if len(a.shape) != 1 or len(b.shape) != 1:
            raise NotImplementedError("outer supports vectors only")
        self.a, self.b = a, b
        self.shape = a.shape + b.shape

    def children(self):
        return (self.a, self.b)

    def eval(self, ctx, side):
        return torch.einsum("qi,qj->qij", self.a.eval(ctx, side),
                            self.b.eval(ctx, side))


class Grad(Expr):
    def __init__(self, a):
        self.a = a
        gdim = _find_gdim(a)
        self.gdim = gdim
        self.shape = a.shape + (gdim,)

    def children(self):
        return (self.a,)

    def eval(self, ctx, side):
        return self.a.eval_grad(ctx, side)

    def eval_grad(self, ctx, side):
        raise NotImplementedError("second gradients are not supported")


class Div(Expr):
    def __init__(self, a):
        if len(a.shape) == 0:
            raise ValueError("div of scalar")
        self.a = a
        self.shape = a.shape[:-1]

    def children(self):
        return (self.a,)

    def eval(self, ctx, side):
        g = self.a.eval_grad(ctx, side)  # (Q, *shape, gdim)
        # contract last value axis with gdim axis
        return torch.diagonal(g, dim1=-2, dim2=-1).sum(-1)


class Transpose(Expr):
    def __init__(self, a):
        if len(a.shape) != 2:
            raise ValueError("transpose needs a matrix")
        self.a = a
        self.shape = (a.shape[1], a.shape[0])

    def children(self):
        return (self.a,)

    def eval(self, ctx, side):
        return torch.swapaxes(self.a.eval(ctx, side), -1, -2)


class Sym(Expr):
    def __init__(self, a):
        if len(a.shape) != 2 or a.shape[0] != a.shape[1]:
            raise ValueError("sym needs a square matrix")
        self.a = a
        self.shape = a.shape

    def children(self):
        return (self.a,)

    def eval(self, ctx, side):
        v = self.a.eval(ctx, side)
        return 0.5 * (v + torch.swapaxes(v, -1, -2))


class Tr(Expr):
    def __init__(self, a):
        if len(a.shape) != 2:
            raise ValueError("tr needs a matrix")
        self.a = a
        self.shape = ()

    def children(self):
        return (self.a,)

    def eval(self, ctx, side):
        return torch.diagonal(self.a.eval(ctx, side), dim1=-2,
                              dim2=-1).sum(-1)


class Indexed(Expr):
    def __init__(self, a, idx):
        if isinstance(idx, int):
            idx = (idx,)
        idx = tuple(idx)
        if len(idx) > len(a.shape):
            raise ValueError("too many indices")
        self.a, self.idx = a, idx
        self.shape = a.shape[len(idx):]

    def children(self):
        return (self.a,)

    def eval(self, ctx, side):
        v = self.a.eval(ctx, side)
        for k in self.idx:
            v = v[:, k] if v.ndim > 1 else v[:, k]
        return v

    def eval_grad(self, ctx, side):
        g = self.a.eval_grad(ctx, side)  # (Q, *ashape, gdim)
        for k in self.idx:
            g = g[:, k]
        return g


class AsVector(Expr):
    def __init__(self, comps):
        self.comps = [as_expr(c) for c in comps]
        for c in self.comps:
            _scalar_only(c)
        self.shape = (len(self.comps),)

    def children(self):
        return tuple(self.comps)

    def eval(self, ctx, side):
        return torch.stack([c.eval(ctx, side) for c in self.comps], dim=-1)

    def eval_grad(self, ctx, side):
        return torch.stack([c.eval_grad(ctx, side) for c in self.comps],
                           dim=1)


class Restricted(Expr):
    def __init__(self, a, side):
        self.a = a
        self.side = side
        self.shape = a.shape

    def children(self):
        return (self.a,)

    def eval(self, ctx, side):
        return self.a.eval(ctx, self.side)

    def eval_grad(self, ctx, side):
        return self.a.eval_grad(ctx, self.side)


class Conditional(Expr):
    def __init__(self, cond, t, f):
        self.cond, self.t, self.f = cond, t, f
        if t.shape != f.shape:
            raise ValueError("branch shapes differ")
        self.shape = t.shape

    def children(self):
        return (self.cond, self.t, self.f)

    def eval(self, ctx, side):
        c = self.cond.eval(ctx, side)
        t, f = self.t.eval(ctx, side), self.f.eval(ctx, side)
        if self.shape:
            c = c.reshape(c.shape + (1,) * len(self.shape))
        return torch.where(c, t, f)


class _Compare(Expr):
    op = None

    def __init__(self, a, b):
        self.a, self.b = as_expr(a), as_expr(b)
        self.shape = ()

    def children(self):
        return (self.a, self.b)

    def eval(self, ctx, side):
        return type(self).op(self.a.eval(ctx, side), self.b.eval(ctx, side))


class Lt(_Compare):
    op = staticmethod(torch.lt)


class Gt(_Compare):
    op = staticmethod(torch.gt)


class Le(_Compare):
    op = staticmethod(torch.le)


class Ge(_Compare):
    op = staticmethod(torch.ge)


def conditional(c, t, f):
    return Conditional(c, as_expr(t), as_expr(f))


def lt(a, b):
    return Lt(a, b)


def gt(a, b):
    return Gt(a, b)


def le(a, b):
    return Le(a, b)


def ge(a, b):
    return Ge(a, b)


# ---------------------------------------------------------------------------
# free functions (UFL-style API)
# ---------------------------------------------------------------------------


def _find_gdim(e):
    """Find the geometric dimension somewhere in the subtree."""
    from collections import deque
    q = deque([e])
    while q:
        n = q.popleft()
        sp = getattr(n, "space", None)
        if sp is not None:
            return sp.mesh.gdim
        fn = getattr(n, "function", None)
        if fn is not None:
            return fn.function_space.mesh.gdim
        m = getattr(n, "mesh", None)
        if m is not None:
            return m.gdim
        q.extend(n.children())
    raise ValueError("cannot infer gdim for grad()")


def grad(a):
    return Grad(as_expr(a))


def nabla_grad(a):
    g = Grad(as_expr(a))
    if len(g.shape) == 2:
        return Transpose(g)
    return g


def div(a):
    return Div(as_expr(a))


def inner(a, b):
    return Inner(as_expr(a), as_expr(b))


def dot(a, b):
    a, b = as_expr(a), as_expr(b)
    if a.shape == () or b.shape == ():
        return Product(a, b)
    return Dot(a, b)


def outer(a, b):
    return Outer(as_expr(a), as_expr(b))


def sym(a):
    return Sym(as_expr(a))


def tr(a):
    return Tr(as_expr(a))


def dev(a):
    a = as_expr(a)
    d = a.shape[0]
    return Sum(a, Neg(Product(Division(Tr(a), ConstantExpr(float(d))),
                              Identity(d))))


def transpose(a):
    return Transpose(as_expr(a))


def as_vector(comps):
    return AsVector(comps)


def jump(v, n=None):
    """UFL jump: jump(v) = v('+') - v('-');
    jump(v, n) = v('+') n('+') + v('-') n('-')."""
    v = as_expr(v)
    if n is None:
        return Sum(Restricted(v, "+"), Neg(Restricted(v, "-")))
    n = as_expr(n)
    if v.shape == ():
        term_p = Product(Restricted(v, "+"), Restricted(n, "+"))
        term_m = Product(Restricted(v, "-"), Restricted(n, "-"))
    elif len(v.shape) >= 1:
        term_p = Dot(Restricted(v, "+"), Restricted(n, "+"))
        term_m = Dot(Restricted(v, "-"), Restricted(n, "-"))
    return Sum(term_p, term_m)


def avg(v):
    v = as_expr(v)
    return Product(ConstantExpr(0.5),
                   Sum(Restricted(v, "+"), Restricted(v, "-")))


def replace(e, mapping):
    """Reconstruct an expression with nodes substituted (by identity).

    mapping: {node: replacement}. Used for linearization: replacing a
    CoefficientExpr by (coefficient + TrialFunction) turns a nonlinear
    residual into a form whose argument-Jacobian at zero is the Newton
    Jacobian at the coefficient's current state."""
    def go(n):
        for k, v in mapping.items():
            if n is k or (isinstance(n, CoefficientExpr)
                          and isinstance(k, CoefficientExpr)
                          and n.function is k.function):
                return v
        if isinstance(n, (Argument, CoefficientExpr, ConstantExpr,
                          SpatialCoordinate, FacetNormal, CellDiameter,
                          QuadratureField, Identity)):
            return n
        ch = [go(c) for c in n.children()]
        if isinstance(n, Sum):
            return Sum(*ch)
        if isinstance(n, Neg):
            return Neg(*ch)
        if isinstance(n, Product):
            return Product(*ch)
        if isinstance(n, Division):
            return Division(*ch)
        if isinstance(n, Power):
            return Power(*ch)
        if isinstance(n, _UnaryFn):
            return type(n)(*ch)
        if isinstance(n, Inner):
            return Inner(*ch)
        if isinstance(n, Dot):
            return Dot(*ch)
        if isinstance(n, Outer):
            return Outer(*ch)
        if isinstance(n, Grad):
            return Grad(*ch)
        if isinstance(n, Div):
            return Div(*ch)
        if isinstance(n, Transpose):
            return Transpose(*ch)
        if isinstance(n, Sym):
            return Sym(*ch)
        if isinstance(n, Tr):
            return Tr(*ch)
        if isinstance(n, Indexed):
            return Indexed(ch[0], n.idx)
        if isinstance(n, AsVector):
            return AsVector(ch)
        if isinstance(n, Restricted):
            return Restricted(ch[0], n.side)
        if isinstance(n, Conditional):
            return Conditional(*ch)
        if isinstance(n, _Compare):
            return type(n)(*ch)
        raise NotImplementedError(
            f"replace: unsupported node {type(n).__name__}")
    return go(e)


# -- expression introspection ------------------------------------------------


def traverse(e):
    seen = []
    stack = [e]
    while stack:
        n = stack.pop()
        seen.append(n)
        stack.extend(n.children())
    return seen


def extract_arguments(e):
    """{(number, part): Argument} over the expression."""
    args = {}
    for n in traverse(e):
        if isinstance(n, Argument):
            prev = args.get(n.key)
            if prev is not None and prev.space is not n.space:
                raise ValueError(
                    "multiple spaces for the same argument number/part")
            args[n.key] = n
    return args


def extract_coefficients(e):
    out = []
    seen = set()
    for n in traverse(e):
        if isinstance(n, CoefficientExpr) and id(n.function) not in seen:
            seen.add(id(n.function))
            out.append(n.function)
    return out


def extract_qfields(e):
    out = []
    seen = set()
    for n in traverse(e):
        if isinstance(n, QuadratureField) and n.uid not in seen:
            seen.add(n.uid)
            out.append(n)
    return out


def estimate_degree(e, default_geo=1):
    """Polynomial degree estimate for quadrature selection (UFL-style)."""
    def deg(n):
        if isinstance(n, Argument):
            return max(n.space.degree, 1)
        if isinstance(n, CoefficientExpr):
            return max(n.function.function_space.degree, 1)
        if isinstance(n, (ConstantExpr, Identity, CellDiameter)):
            return 0
        if isinstance(n, (SpatialCoordinate, FacetNormal, QuadratureField)):
            return 1
        if isinstance(n, (Sum, Conditional)):
            return max(deg(c) for c in n.children())
        if isinstance(n, (Product, Inner, Dot, Outer)):
            return sum(deg(c) for c in n.children())
        if isinstance(n, Division):
            return deg(n.a) + deg(n.b)
        if isinstance(n, Power):
            if isinstance(n.b, ConstantExpr):
                try:
                    return int(abs(float(np.asarray(n.b.value)))) * deg(n.a)
                except Exception:
                    pass
            return 2 * deg(n.a)
        if isinstance(n, _UnaryFn):
            return deg(n.a) + 2
        if isinstance(n, Grad):
            return max(deg(n.a) - 1, 0)
        if isinstance(n, Div):
            return max(deg(n.a) - 1, 0)
        if isinstance(n, (Neg, Sym, Tr, Transpose, Indexed, Restricted)):
            return deg(n.children()[0])
        if isinstance(n, AsVector):
            return max(deg(c) for c in n.children())
        if isinstance(n, _Compare):
            return max(deg(c) for c in n.children())
        return 2
    return max(deg(e), 1)
