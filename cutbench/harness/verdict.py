"""The judgement of a run: each number a problem's check read (its
``check``), and the count of window steps whose solve did not reach the
configuration's tolerance by its own residual, against the cell's limits
(``limits/<cell>.json``). A reading the limits do not name, or a limit
with no reading, fails."""

from __future__ import annotations

import math

UNCONVERGED = "unconverged_steps"


def judge(readings, limits, unconverged):
    """(correct, [(name, reading, limit)]): the limits' numbers in their
    order, then the unconverged steps against 0."""
    rows = [(k, readings.get(k, math.inf), lim) for k, lim in limits.items()]
    rows.append((UNCONVERGED, int(unconverged), 0))
    ok = all(v <= lim for _, v, lim in rows) and set(readings) <= set(limits)
    return ok, rows
