"""idle_pct.loadcases: the share of the traced window in which no operation
ran on the card (the profiler's device timeline), in %."""


def read(ctx):
    tl = ctx["timeline"]
    if tl is None or tl["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tl["busy_s"] / tl["window_s"])
