"""kernels_per_it.loadcases: CUDA kernels in the profiler's trace over the
iterations of the solves it holds (the stack's dispatch)."""

from harness.timeline import is_kernel


def read(ctx):
    tl = ctx["timeline"]
    its = sum(s["its"] for s in ctx["traced_steps"])
    if tl is None or not its:
        return None
    return sum(c for name, (_, c) in tl["by_name"].items()
               if is_kernel(name)) / its
