"""operator_element_s.moving: the seconds a traced step spent in the
element path of the operator build (``CutOperator(..., apply_plan=False)``
and the merge of its instances): the program's 'operator.element_path'
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
    secs = [b - a for n, a, b in spans if n == "operator.element_path"]
    if not secs:
        return None
    return sum(secs) / 1e9 / len(ctx["traced_steps"])
