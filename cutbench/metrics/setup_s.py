"""setup_s: process start to the first timed step (CUDA init, the host
setup from io's setup cache or built, the seeded inputs, the warm-up step
of the cell's own shapes), on the host clock."""


def read(ctx):
    return ctx["setup_s"]
