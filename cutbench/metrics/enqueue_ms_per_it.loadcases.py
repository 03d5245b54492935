"""enqueue_ms_per_it.loadcases: milliseconds an iteration the host spent in
the solve neither waiting on a read nor building the preconditioner: the
program's ``solve`` spans less its ``solve.sync`` and ``solve.build.*``
spans, over the iterations of the traced steps, in which the program
recorded them. That is the host launching while the card waits for it. A
program without the spans reports nothing."""


def read(ctx):
    if ctx["timeline"] is None:
        return None
    try:
        from cutfemx_tpu_torch import profiling
        spans = profiling.spans()
    except (ImportError, AttributeError):
        return None
    solve = sum(b - a for n, a, b in spans if n == "solve")
    sync = sum(b - a for n, a, b in spans if n == "solve.sync")
    built = sum(b - a for n, a, b in spans if n.startswith("solve.build."))
    its = sum(s["its"] for s in ctx["traced_steps"])
    if not solve or not its:
        return None
    return (solve - sync - built) / 1e6 / its
