"""forms_compile_s.moving: the seconds a traced step spent compiling its
forms (``fem.form`` of a and of each load): the program's 'forms.compile'
spans over the traced steps, in which the program recorded them (it
records only while the profiler does). A program without the spans
reports nothing."""


def read(ctx):
    if ctx["timeline"] is None or not ctx["traced_steps"]:
        return None
    try:
        from cutfemx_tpu_torch import profiling
        spans = profiling.spans()
    except (ImportError, AttributeError):
        return None
    secs = [b - a for n, a, b in spans if n == "forms.compile"]
    if not secs:
        return None
    return sum(secs) / 1e9 / len(ctx["traced_steps"])
