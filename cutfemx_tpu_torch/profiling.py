"""Lightweight timing utilities: named timer spans that log through the
``"cutfemx_tpu_torch"`` logger, the program's spans and counters, one
accumulating registry for both, and a CSV profile writer for iteration
loops (the torch counterpart of ``cutfemx_tpu.profiling``).

``Timer`` is always on and reads ``time.perf_counter``. ``span`` and
``count`` record only while a torch profiler records
(``torch.profiler.profile``); otherwise each is one attribute read and a
shared no-op. A span's interval is read on ``time.time_ns()``, the epoch
clock kineto stamps its events with, so the program's intervals lie on
the profiler's timeline. A span does not emit a ``record_function`` range:
kineto would mirror such a range onto the device's timeline as if it were
device work.

No span synchronises a device. CUDA work is queued asynchronously, so a
span around code that launches kernels times their enqueue, not their
execution, unless the code inside the span waits for the card itself (a
host copy, ``.item()``, or an explicit ``torch.cuda.synchronize()``).
"""

from __future__ import annotations

import csv
import logging
import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext

import torch.autograd.profiler as _autograd_profiler

logger = logging.getLogger("cutfemx_tpu_torch")

__all__ = ["Timer", "span", "count", "record", "spans", "counters",
           "timings", "reset_timings", "list_timings", "ProfileWriter"]

_ACCUM: dict = defaultdict(lambda: [0, 0.0])
_INTERVALS: list = []            # (name, t0_ns, t1_ns) of recorded spans
_COUNTS: dict = defaultdict(int)


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


_OFF = nullcontext()     # the span handed out while no profiler records


class _Span:
    __slots__ = ("name", "t0")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        record(self.name, self.t0, time.time_ns())
        return False


def span(name: str):
    """Context manager: while a torch profiler records, the interval
    (name, t0_ns, t1_ns) on ``time.time_ns()`` goes to ``spans()`` and its
    seconds to ``timings()``; otherwise nothing is read or kept."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def count(name: str, n: int = 1):
    """Add ``n`` to ``counters()[name]`` while a torch profiler records."""
    if _autograd_profiler._is_profiler_enabled:
        _COUNTS[name] += n


def record(name: str, t0_ns: int, t1_ns: int):
    """A span the caller timed with its own two ``time.time_ns()`` reads,
    kept as ``span`` keeps one (only while a torch profiler records)."""
    if _autograd_profiler._is_profiler_enabled:
        _INTERVALS.append((name, t0_ns, t1_ns))
        acc = _ACCUM[name]
        acc[0] += 1
        acc[1] += (t1_ns - t0_ns) / 1e9


def spans():
    """[(name, t0_ns, t1_ns)] of the recorded spans, in the order they
    ended."""
    return list(_INTERVALS)


def counters():
    """{name: total} of the recorded counts."""
    return dict(_COUNTS)


def timings():
    """{name: (count, total_seconds)} of ``Timer`` and recorded spans."""
    return {k: tuple(v) for k, v in _ACCUM.items()}


def reset_timings():
    """Clear the registry: timings, spans and counters."""
    _ACCUM.clear()
    _INTERVALS.clear()
    _COUNTS.clear()


def list_timings(print_fn=print):
    """Formatted timing table, longest total first."""
    rows = sorted(timings().items(), key=lambda kv: -kv[1][1])
    print_fn(f"{'timer':<40s} {'calls':>7s} {'total':>10s} {'avg':>10s}")
    for name, (calls, total) in rows:
        print_fn(f"{name:<40s} {calls:7d} {total:10.4f} "
                 f"{total / max(calls, 1):10.4f}")


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
