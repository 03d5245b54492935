"""cg_ms_per_it.loadcases: milliseconds an iteration of the window's solves
the profiler did not slow: the 'solve' spans less the builds they made,
over the iterations solve_cg reported (CG and the f64 refinement
applies)."""


def read(ctx):
    w0, w1 = ctx["span_window"]
    solve = sum(b - a for n, a, b in ctx["spans"]
                if n == "solve" and w0 <= a < w1)
    its = sum(s["its"] for s in ctx["span_steps"])
    if not its:
        return None
    built = sum(s["build_s"] for s in ctx["span_steps"])
    return (solve - built) / its * 1e3
