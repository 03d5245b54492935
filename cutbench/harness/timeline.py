"""Spans of the benchmark's own and the profiler's device timeline.

A span is a host-clock interval around one call into a layer of the
program; it ends by draining the card, so it holds the layer's device work.
With tracing on, each span is also a ``record_function`` range, which puts
it on the profiler's clock beside the device's operations: an idle gap on
the card is named by the span the host was in.
"""

from __future__ import annotations

import bisect
import contextlib
import time

import torch

PREFIX = "cutbench:"
TRACE_SECONDS = 30.0


class Recorder:
    """Spans [(name, t0, t1)] of one run, in host seconds."""

    def __init__(self, sync, tracing):
        self.sync, self.tracing = sync, tracing
        self.spans = []

    @contextlib.contextmanager
    def span(self, name):
        rf = torch.profiler.record_function(PREFIX + name) \
            if self.tracing else contextlib.nullcontext()
        t0 = time.perf_counter()
        with rf:
            yield
            self.sync()
        self.spans.append((name, t0, time.perf_counter()))


class Profile:
    """torch.profiler over the first ``TRACE_SECONDS`` of the measured
    window (CPU and CUDA activity; whole steps), reduced to the device's
    timeline: busy seconds, operations by name, idle gaps by span. The
    trace's length is bounded so that reading it stays within a run's time
    whatever the step rate."""

    def __init__(self, enabled):
        self.enabled, self.prof, self.running = enabled, None, False

    def start(self):
        if self.enabled:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.__enter__()
            self.running = True

    def stop(self):
        if self.running:
            self.prof.__exit__(None, None, None)
            self.running = False

    def events(self):
        """(device ops [(name, start_ns, end_ns)], host spans [(name,
        start_ns, end_ns)]) of the trace."""
        from torch.autograd import DeviceType
        dev, host = [], []
        for e in self.prof.profiler.kineto_results.events():
            if hasattr(e, "start_ns"):
                t0, dur = e.start_ns(), e.duration_ns()
            else:
                t0, dur = e.start_us() * 1000, e.duration_us() * 1000
            name = e.name()
            if name.startswith(PREFIX):
                # a span; kineto also mirrors it on the device's timeline
                if e.device_type() != DeviceType.CUDA:
                    host.append((name[len(PREFIX):], t0, t0 + dur))
            elif e.device_type() == DeviceType.CUDA:
                dev.append((name, t0, t0 + dur))
        return dev, host


def reduce(dev, host, window_span="step"):
    """The timeline of the window (from the first ``window_span`` span's
    start to the last one's end): busy and window seconds, device seconds
    and counts by operation name, idle seconds by the span the host was in
    (the span around a gap's midpoint, else the step)."""
    steps = [(a, b) for n, a, b in host if n == window_span]
    if not steps or not dev:
        return None
    w0, w1 = min(a for a, _ in steps), max(b for _, b in steps)
    ops = sorted((max(a, w0), min(b, w1), n) for n, a, b in dev
                 if b > w0 and a < w1)
    by_name = {}
    for a, b, n in ops:
        s, c = by_name.get(n, (0.0, 0))
        by_name[n] = (s + (b - a) * 1e-9, c + 1)
    busy, gaps, cur0, cur1 = 0, [], w0, w0
    for a, b, _ in ops:
        if a > cur1:
            busy += cur1 - cur0
            gaps.append((cur1, a))
            cur0 = a
        cur1 = max(cur1, b)
    busy += cur1 - cur0
    if w1 > cur1:
        gaps.append((cur1, w1))
    # a step's spans follow one another: the last to start before a gap's
    # midpoint holds it, if it has not ended
    inner = sorted((a, b, n) for n, a, b in host if n != window_span)
    starts = [a for a, _, _ in inner]
    idle = {}
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        i = bisect.bisect_right(starts, mid) - 1
        name = inner[i][2] if i >= 0 and mid < inner[i][1] else window_span
        idle[name] = idle.get(name, 0.0) + (g1 - g0) * 1e-9
    return dict(busy_s=busy * 1e-9, window_s=(w1 - w0) * 1e-9,
                by_name=by_name, idle_by_span=idle)


def is_kernel(name):
    """A kernel launch, not a copy or a fill."""
    return not name.startswith(("Memcpy", "Memset", "memcpy", "memset"))
