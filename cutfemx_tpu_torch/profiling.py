"""Lightweight timing utilities: named timer spans that log through the
``"cutfemx_tpu_torch"`` logger, an accumulating registry, and a CSV
profile writer for iteration loops (the torch counterpart of
``cutfemx_tpu.profiling``).

Every span is read on the host clock (``time.perf_counter``), and no span
synchronises a device. CUDA work is queued asynchronously, so a span
around code that launches kernels times their enqueue, not their
execution, unless the code inside the span waits for the card itself (a
host copy, ``.item()``, or an explicit ``torch.cuda.synchronize()``).
"""

from __future__ import annotations

import csv
import logging
import time
from collections import defaultdict
from contextlib import contextmanager

logger = logging.getLogger("cutfemx_tpu_torch")

__all__ = ["Timer", "timings", "reset_timings", "list_timings",
           "ProfileWriter"]

_ACCUM: dict = defaultdict(lambda: [0, 0.0])


@contextmanager
def Timer(name: str, log=True):
    """Context-manager span on the host clock (no device sync; see the
    module docstring). Accumulates into the module registry."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        _ACCUM[name][0] += 1
        _ACCUM[name][1] += dt
        if log:
            logger.info("%s: %.4fs", name, dt)


def timings():
    """{name: (count, total_seconds)}."""
    return {k: tuple(v) for k, v in _ACCUM.items()}


def reset_timings():
    _ACCUM.clear()


def list_timings(print_fn=print):
    """Formatted timing table, longest total first."""
    rows = sorted(timings().items(), key=lambda kv: -kv[1][1])
    print_fn(f"{'timer':<40s} {'calls':>7s} {'total':>10s} {'avg':>10s}")
    for name, (count, total) in rows:
        print_fn(f"{name:<40s} {count:7d} {total:10.4f} "
                 f"{total / max(count, 1):10.4f}")


class ProfileWriter:
    """Per-iteration CSV profile rows; columns not in ``fieldnames`` are
    ignored. Each row is flushed as it is written."""

    def __init__(self, path, fieldnames):
        self.path = path
        self.fieldnames = list(fieldnames)
        self._fh = open(path, "w", newline="")
        self._writer = csv.DictWriter(self._fh,
                                      fieldnames=self.fieldnames,
                                      extrasaction="ignore")
        self._writer.writeheader()

    def write(self, **row):
        self._writer.writerow(row)
        self._fh.flush()

    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
