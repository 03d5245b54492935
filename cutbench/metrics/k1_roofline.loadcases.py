"""k1_roofline.loadcases: K1's share of its bytes roofline in the window,
in %: the bytes its launches must move (``counts/k1_bytes.py``, from the
benchmark's own set of full cubes; f32 CG applies and f64 refinement
applies each at their size) at the H100's published 3.35 TB/s, over the
device time of those launches in the profiler's trace."""

from counts.k1_bytes import HBM_BYTES_PER_S


def read(ctx):
    tl, k1 = ctx["timeline"], ctx.get("k1")
    if tl is None or k1 is None:
        return None
    bound = seconds = 0.0
    for name, (s, count) in tl["by_name"].items():
        if "interior_stencil" not in name:
            continue
        kind = "double" if "double" in name else "float"
        bound += count * k1[kind] / HBM_BYTES_PER_S
        seconds += s
    if seconds <= 0:
        return None
    return 100.0 * bound / seconds
