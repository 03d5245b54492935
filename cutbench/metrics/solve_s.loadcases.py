"""solve_s.loadcases: the mean host seconds of a load-case step (the
combination of the loads, solve_cg and the check of its residual) over the
window's steps the profiler did not slow. Per layer: the host's dispatch
speed drifts by 10-15% from run to run, more than an end-to-end bound can
hold (PERF.md)."""


def read(ctx):
    steps = ctx["span_steps"]
    return sum(s["t1"] - s["t0"] for s in steps) / len(steps)
