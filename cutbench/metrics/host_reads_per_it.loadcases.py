"""host_reads_per_it.loadcases: the solve's blocking device-to-host reads
(the program's counter ``solve.host_reads``: the stopping test of every CG
iteration, the residuals of each chunk and refinement step) over the
iterations of the traced steps. The program counts only while the profiler
records, so the traced steps are the ones it counted in; a program without
the counter reports nothing."""


def read(ctx):
    if ctx["timeline"] is None:
        return None
    try:
        from cutfemx_tpu_torch import profiling
        reads = profiling.counters().get("solve.host_reads")
    except (ImportError, AttributeError):
        return None
    its = sum(s["its"] for s in ctx["traced_steps"])
    if reads is None or not its:
        return None
    return reads / its
