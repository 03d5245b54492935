"""build_s.moving: the seconds the solve's preconditioner builds took (fold,
ASM, coarse: the seconds of each stage in ``op.build_log`` that the step's
solve built or adopted), averaged over the window's steps the profiler did
not slow (``span_steps``)."""


def read(ctx):
    steps = ctx["span_steps"]
    return sum(s["build_s"] for s in steps) / len(steps)
