"""Bytes the interior-stencil kernel (K1) must move in one launch.

Frozen here so that the roofline's denominator reads the same work
whatever implements it. The arithmetic is ``chip_smoke.bound_bytes``'s for
the one box of n^3 cubes: every grid value written once, the cube mask and
the local matrix read once, and the values that full cubes touch read
once. It is fed from the grid's sizes and from the set of full interior
cubes (all six tets inside the level set), which the benchmark works out
itself from the level set (``reference.cutpoisson.Problem.full_cubes``).

The grid holds the P2 nodes in 8 channels, one per parity of the half
lattice (X % 2, Y % 2, Z % 2), on (n + 1)^3 points: a cube touches in
channel c the points at offsets d in {0, 1}^3 with 2 d + c <= 2, 27 slots
in all (8 for P1, one channel).
"""

from __future__ import annotations

import itertools

import numpy as np

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, published, at 700 W


def slots(degree):
    """[(channel (cx, cy, cz), offset (dx, dy, dz))] of one cube."""
    cube = list(itertools.product((0, 1), repeat=3))
    if degree == 1:
        return [((0, 0, 0), d) for d in cube]
    return [(c, d) for c in cube for d in cube
            if all(2 * di + ci <= 2 for di, ci in zip(d, c))]


def k1_bytes(full_cubes, degree, itemsize):
    """Bytes of one K1 launch on the (n, n, n) boolean mask of full cubes
    with values of ``itemsize`` bytes."""
    full = np.asarray(full_cubes, dtype=bool)
    n = full.shape[0]
    N = n + 1
    table = slots(degree)
    channels = sorted({c for c, _ in table})
    touched = 0
    for c in channels:
        t = np.zeros((N, N, N), dtype=bool)
        for _, (dx, dy, dz) in [s for s in table if s[0] == c]:
            t[dx:dx + n, dy:dy + n, dz:dz + n] |= full
        touched += int(t.sum())
    L = len(table)
    return (len(channels) * N ** 3 + touched + L * L) * itemsize + n ** 3
