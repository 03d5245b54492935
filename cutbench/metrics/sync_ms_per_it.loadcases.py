"""sync_ms_per_it.loadcases: milliseconds an iteration the host waited in
the solve's blocking reads (the program's ``solve.sync`` spans) over the
iterations of the traced steps, in which the program recorded them; a
program without the spans reports nothing."""


def read(ctx):
    if ctx["timeline"] is None:
        return None
    try:
        from cutfemx_tpu_torch import profiling
        spans = profiling.spans()
    except (ImportError, AttributeError):
        return None
    sync = [b - a for n, a, b in spans if n == "solve.sync"]
    its = sum(s["its"] for s in ctx["traced_steps"])
    if not sync or not its:
        return None
    return sum(sync) / 1e6 / its
