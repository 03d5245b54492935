"""moving_step_s: the window's host seconds over the moving steps it
completed (each from the re-interpolated level set to the solution); the
window's seconds leave out only the benchmark's copies of the checked
steps for the check."""


def read(ctx):
    return ctx["window_s"] / len(ctx["steps"])
