"""Reference-cell quadrature rules.

Replaces the Basix quadrature role consumed by the reference library
(upstream CutFEMx cpp/cutfemx/extensions/extension_penalty.cpp uses basix
quadrature; runtime rules are generated by CutCells). Rules are host-side
NumPy float64 constants; the torch assembly path treats them as static data.

Simplex rules are built by collapsing tensor Gauss-Legendre rules (Duffy
transform), which is valid for any order; low-order simplex rules use the
standard compact symmetric rules where available.
"""

from __future__ import annotations

import numpy as np

from .cells import CellType

__all__ = ["quadrature_rule", "gauss_legendre"]


def gauss_legendre(n: int):
    """n-point Gauss-Legendre rule on [0, 1]."""
    x, w = np.polynomial.legendre.leggauss(n)
    return 0.5 * (x + 1.0), 0.5 * w


def _npts_1d(order: int) -> int:
    return max(1, (order + 2) // 2)


def _interval_rule(order):
    x, w = gauss_legendre(_npts_1d(order))
    return x.reshape(-1, 1), w


def _perm3(a, b):
    """Permutations of (a, a, a) with one coordinate replaced by b... i.e.
    the 4 barycentric-symmetric points (b, a, a), (a, b, a), (a, a, b),
    (a, a, a-complement handled by caller)."""
    return [[b, a, a], [a, b, a], [a, a, b], [a, a, a]]


def _perm22(a, b):
    """The 6 points with barycentric pattern (a, a, b, b)."""
    return [[a, a, b], [a, b, a], [b, a, a],
            [a, b, b], [b, a, b], [b, b, a]]


def _tensor_rule(order, dim):
    x, w = gauss_legendre(_npts_1d(order))
    grids = np.meshgrid(*([x] * dim), indexing="ij")
    pts = np.stack([g.ravel() for g in grids], axis=-1)
    wts = np.ones(pts.shape[0])
    for axis in range(dim):
        wts *= np.meshgrid(*([w] * dim), indexing="ij")[axis].ravel()
    return pts, wts


def _triangle_rule(order):
    if order <= 1:
        return (np.array([[1.0 / 3.0, 1.0 / 3.0]]), np.array([0.5]))
    if order == 2:
        pts = np.array([[1 / 6, 1 / 6], [2 / 3, 1 / 6], [1 / 6, 2 / 3]])
        return pts, np.full(3, 1.0 / 6.0)
    if order <= 4:
        # Dunavant degree-4, 6 points
        a1, a2 = 0.445948490915965, 0.091576213509771
        w1, w2 = 0.223381589678011, 0.109951743655322
        pts = np.array([
            [a1, a1], [1 - 2 * a1, a1], [a1, 1 - 2 * a1],
            [a2, a2], [1 - 2 * a2, a2], [a2, 1 - 2 * a2]])
        w = 0.5 * np.array([w1, w1, w1, w2, w2, w2])
        return pts, w
    if order <= 5:
        # Dunavant degree-5, 7 points
        a1, a2 = 0.470142064105115, 0.101286507323456
        w0, w1, w2 = 0.225, 0.132394152788506, 0.125939180544827
        pts = np.array([
            [1 / 3, 1 / 3],
            [a1, a1], [1 - 2 * a1, a1], [a1, 1 - 2 * a1],
            [a2, a2], [1 - 2 * a2, a2], [a2, 1 - 2 * a2]])
        w = 0.5 * np.array([w0, w1, w1, w1, w2, w2, w2])
        return pts, w
    # Duffy / collapsed tensor rule: x = a, y = b (1 - a)
    n = _npts_1d(order) + 1
    a, wa = gauss_legendre(n)
    b, wb = gauss_legendre(n)
    A, B = np.meshgrid(a, b, indexing="ij")
    WA, WB = np.meshgrid(wa, wb, indexing="ij")
    x = A * (1.0 - B)
    y = B
    w = WA * WB * (1.0 - B)
    return np.stack([x.ravel(), y.ravel()], -1), w.ravel()


def _tetrahedron_rule(order):
    if order <= 1:
        return (np.array([[0.25, 0.25, 0.25]]), np.array([1.0 / 6.0]))
    if order == 2:
        # 4-point degree-2 rule
        a = (5.0 - np.sqrt(5.0)) / 20.0
        b = (5.0 + 3.0 * np.sqrt(5.0)) / 20.0
        pts = np.array([[a, a, a], [b, a, a], [a, b, a], [a, a, b]])
        return pts, np.full(4, 1.0 / 24.0)
    if order == 3:
        # Keast degree-3, 5 points (one negative weight; fine for
        # assembly)
        pts = np.array([[0.25, 0.25, 0.25],
                        [1 / 6, 1 / 6, 1 / 6], [1 / 2, 1 / 6, 1 / 6],
                        [1 / 6, 1 / 2, 1 / 6], [1 / 6, 1 / 6, 1 / 2]])
        w = np.array([-4.0 / 5.0, 9.0 / 20.0, 9.0 / 20.0, 9.0 / 20.0,
                      9.0 / 20.0]) / 6.0
        return pts, w
    if order <= 5:
        # Keast degree-5, 15 points
        pts = [[0.25, 0.25, 0.25]]
        w = [0.030283678097089 * 6]
        a, wa = (0.0 + 1.0 / 3.0, 0.006026785714286 * 6)
        g1 = 1.0 / 3.0
        for p in _perm3(g1, 0.0):
            pts.append(p)
            w.append(0.006026785714286 * 6)
        g2 = 1.0 / 11.0
        for p in _perm3(g2, 8.0 / 11.0):
            pts.append(p)
            w.append(0.011645249086029 * 6)
        g3, g4 = 0.066550153573664, 0.433449846426336
        for p in _perm22(g3, g4):
            pts.append(p)
            w.append(0.010949141561386 * 6)
        pts = np.array(pts)
        w = np.array(w) / 6.0
        return pts, w
    n = _npts_1d(order) + 1
    a, wa = gauss_legendre(n)
    A, B, C = np.meshgrid(a, a, a, indexing="ij")
    WA, WB, WC = np.meshgrid(wa, wa, wa, indexing="ij")
    # collapsed map: z = c, y = b(1-c), x = a(1-b)(1-c)
    z = C
    y = B * (1.0 - C)
    x = A * (1.0 - B) * (1.0 - C)
    w = WA * WB * WC * (1.0 - B) * (1.0 - C) ** 2
    return np.stack([x.ravel(), y.ravel(), z.ravel()], -1), w.ravel()


def quadrature_rule(cell_type: str, order: int):
    """Return (points (nq, tdim), weights (nq,)) integrating exactly to
    ``order`` on the reference cell, in float64."""
    order = int(order)
    if cell_type == CellType.interval:
        return _interval_rule(order)
    if cell_type == CellType.triangle:
        return _triangle_rule(order)
    if cell_type == CellType.quadrilateral:
        return _tensor_rule(order, 2)
    if cell_type == CellType.tetrahedron:
        return _tetrahedron_rule(order)
    if cell_type == CellType.hexahedron:
        return _tensor_rule(order, 3)
    if cell_type == "point":
        return np.zeros((1, 0)), np.ones(1)
    raise ValueError(f"unknown cell type '{cell_type}'")
