"""cut_rules_s.moving: the seconds a traced step spent in the cut's
runtime rules (``runtime_quadrature`` of phi<0 and phi=0, the curved cut's
Newton marching inside them): the program's 'cut.rules' spans over the
traced steps, in which the program recorded them (it records only while
the profiler does). A program without the spans reports nothing."""


def read(ctx):
    if ctx["timeline"] is None or not ctx["traced_steps"]:
        return None
    try:
        from cutfemx_tpu_torch import profiling
        spans = profiling.spans()
    except (ImportError, AttributeError):
        return None
    secs = [b - a for n, a, b in spans if n == "cut.rules"]
    if not secs:
        return None
    return sum(secs) / 1e9 / len(ctx["traced_steps"])
