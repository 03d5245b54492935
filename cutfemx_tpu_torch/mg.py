"""Structured-lattice detection for create_box / create_rectangle meshes.

Only ``structured_lattice_info`` is ported so far: the grid-layout stencil
operator needs it. The geometric multigrid of ``cutfemx_tpu.mg`` waits for
ROADMAP item 10.
"""

from __future__ import annotations

import numpy as np

__all__ = ["structured_lattice_info"]


def structured_lattice_info(mesh):
    """Detect a structured lattice: returns (lo, n_axes, h_axes) when every
    vertex sits on lo + (i,j,k)*h for integer lattice sizes, else None."""
    v = mesh.vertices
    lo = v.min(axis=0)
    hi = v.max(axis=0)
    out_n = []
    for ax in range(v.shape[1]):
        vals = np.unique(np.round((v[:, ax] - lo[ax]) * 1e12) / 1e12)
        n = len(vals) - 1
        if n < 1:
            return None
        h = (hi[ax] - lo[ax]) / n
        if not np.allclose(vals, lo[ax] * 0 + np.arange(n + 1) * h,
                           atol=1e-9 * max(abs(hi[ax] - lo[ax]), 1)):
            return None
        out_n.append(n)
    if len(v) != np.prod([n + 1 for n in out_n]):
        return None
    h_axes = (hi - lo) / np.asarray(out_n)
    return lo, np.asarray(out_n, np.int64), h_axes
