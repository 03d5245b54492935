"""Level-set selector language parser.

Mirrors the reference's ``cutcells::parse_selection_expr`` semantics
(upstream CutFEMx cpp/cutfemx/cut/cut.cpp:877-924 and
docs/user-guide/element-classification.md): a selector is an OR of AND-terms
of clauses ``name OP 0`` with OP in {<, <=, =, >=, >}. Keywords ``and``/
``or`` (also ``&``/``|``) combine clauses.

Relation-vs-domain matching (cut.cpp relation_matches_domain):
  <   -> inside          <=  -> inside or intersected
  =   -> intersected
  >   -> outside         >=  -> outside or intersected
"""

from __future__ import annotations

import re

import numpy as np

__all__ = ["parse_selector", "selector_mask", "DOMAIN_INSIDE",
           "DOMAIN_OUTSIDE", "DOMAIN_INTERSECTED"]

DOMAIN_INSIDE = 0
DOMAIN_OUTSIDE = 1
DOMAIN_INTERSECTED = 2

_CLAUSE_RE = re.compile(
    r"^\s*([A-Za-z_][A-Za-z0-9_]*)\s*(<=|>=|=|<|>)\s*0(?:\.0*)?\s*$")


def parse_selector(text: str):
    """Parse into [[(name, op), ...], ...] — OR of AND-terms."""
    if not isinstance(text, str) or not text.strip():
        raise ValueError(f"invalid selector {text!r}")
    # normalize separators
    s = text.replace("||", " or ").replace("&&", " and ")
    s = s.replace("|", " or ").replace("&", " and ")
    terms = []
    for term_text in re.split(r"\bor\b", s):
        clauses = []
        for clause_text in re.split(r"\band\b", term_text):
            m = _CLAUSE_RE.match(clause_text)
            if not m:
                raise ValueError(
                    f"invalid selector clause {clause_text.strip()!r} in "
                    f"{text!r}")
            clauses.append((m.group(1), m.group(2)))
        terms.append(clauses)
    return terms


_REL_DOMAINS = {
    "<": (DOMAIN_INSIDE,),
    "<=": (DOMAIN_INSIDE, DOMAIN_INTERSECTED),
    "=": (DOMAIN_INTERSECTED,),
    ">=": (DOMAIN_OUTSIDE, DOMAIN_INTERSECTED),
    ">": (DOMAIN_OUTSIDE,),
}


def selector_mask(selector, names, domains):
    """Evaluate a selector over per-level-set entity domains.

    names: tuple of level-set names; domains: (n_ls, n_entities) int8.
    Returns a boolean (n_entities,) mask.
    """
    terms = parse_selector(selector)
    name_to_idx = {n: i for i, n in enumerate(names)}
    n = domains.shape[1]
    out = np.zeros(n, dtype=bool)
    for clauses in terms:
        term_mask = np.ones(n, dtype=bool)
        for name, op in clauses:
            if name not in name_to_idx:
                raise ValueError(
                    f"unknown level-set name '{name}' (have {names})")
            d = domains[name_to_idx[name]]
            ok = np.zeros(n, dtype=bool)
            for dom in _REL_DOMAINS[op]:
                ok |= (d == dom)
            term_mask &= ok
        out |= term_mask
    return out
