"""forms_s.moving: the seconds a window step spent in the benchmark's 'forms'
span (fem.form of a and L, active_domain, assemble_vector), drained at its
end, averaged over the window's steps the profiler did not slow
(``span_steps``)."""


def read(ctx):
    w0, w1 = ctx["span_window"]
    spans = [b - a for n, a, b in ctx["spans"]
             if n == "forms" and w0 <= a < w1]
    if not spans:
        return None
    return sum(spans) / len(ctx["span_steps"])
