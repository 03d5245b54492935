"""Integration measures and integral containers.

Mirrors the reference's use of ``ufl.Measure`` with runtime quadrature
providers as ``subdomain_data`` (upstream CutFEMx python/demo/demo_poisson.py:
165-169): a measure may carry

- ``None``                      -> all entities, standard quadrature
- an entity index array         -> those entities, standard quadrature
- a RuntimeQuadratureRules      -> runtime (cut) quadrature
- ``[entities, rules]``         -> mixed standard + runtime (two integrals)
"""

from __future__ import annotations

import numpy as np

__all__ = ["Measure", "Integral", "FormExpr", "dx", "ds", "dS", "dP",
           "dr"]

# dP (vertex) and dr (ridge, codim-2) mirror the two extra integral
# types of the reference's custom-data Form
# (upstream CutFEMx cpp/dolfinx_custom_data/fem/Form.h:34-41); they lower
# onto the runtime-quadrature cell path (fem.py _build_instances).
_VALID = {"dx": "cell", "ds": "exterior_facet", "dS": "interior_facet",
          "dP": "vertex", "dr": "ridge"}


class Measure:
    def __init__(self, integral_type, domain=None, subdomain_data=None,
                 subdomain_id=0, metadata=None):
        if integral_type not in _VALID:
            raise ValueError(integral_type)
        self.integral_type = integral_type
        self.domain = domain
        self.subdomain_data = subdomain_data
        self.subdomain_id = subdomain_id
        self.metadata = metadata or {}

    def __call__(self, subdomain_id=None, subdomain_data=None,
                 domain=None, metadata=None):
        return Measure(
            self.integral_type,
            domain=domain if domain is not None else self.domain,
            subdomain_data=(subdomain_data if subdomain_data is not None
                            else self.subdomain_data),
            subdomain_id=(subdomain_id if subdomain_id is not None
                          else self.subdomain_id),
            metadata=metadata if metadata is not None else self.metadata,
        )

    def __rmul__(self, integrand):
        from .dsl import as_expr
        return FormExpr([Integral(as_expr(integrand), self)])


dx = Measure("dx")
ds = Measure("ds")
dS = Measure("dS")
dP = Measure("dP")
dr = Measure("dr")


class Integral:
    def __init__(self, integrand, measure):
        self.integrand = integrand
        self.measure = measure

    @property
    def integral_type(self):
        return _VALID[self.measure.integral_type]


class FormExpr:
    """A sum of integrals (the object returned by ``expr * dx``)."""

    def __init__(self, integrals):
        self.integrals = list(integrals)

    def __add__(self, other):
        if isinstance(other, FormExpr):
            return FormExpr(self.integrals + other.integrals)
        if other == 0:
            return self
        return NotImplemented

    __radd__ = __add__

    def __iadd__(self, other):
        return self.__add__(other)

    def __sub__(self, other):
        if isinstance(other, FormExpr):
            from .dsl import Neg
            neg = [Integral(Neg(i.integrand), i.measure)
                   for i in other.integrals]
            return FormExpr(self.integrals + neg)
        return NotImplemented

    def __neg__(self):
        from .dsl import Neg
        return FormExpr([Integral(Neg(i.integrand), i.measure)
                         for i in self.integrals])

    def __mul__(self, s):
        from .dsl import Product, as_expr
        if isinstance(s, (int, float)):
            return FormExpr([Integral(Product(as_expr(s), i.integrand),
                                      i.measure) for i in self.integrals])
        return NotImplemented

    __rmul__ = __mul__


def split_subdomain_data(sd):
    """Normalize subdomain_data into (entities|None, rules|None)."""
    from ..cut.quadrature import RuntimeQuadratureRules
    if sd is None:
        return None, None
    if isinstance(sd, RuntimeQuadratureRules):
        return None, sd
    if isinstance(sd, (list, tuple)):
        ents, rules = None, None
        for item in sd:
            if isinstance(item, RuntimeQuadratureRules):
                rules = item
            else:
                ents = np.asarray(item, dtype=np.int32)
        return ents, rules
    return np.asarray(sd, dtype=np.int32), None
