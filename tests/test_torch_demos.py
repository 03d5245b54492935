"""The reference demos of ROADMAP item 12a in cutfemx_tpu_torch against
the reference demo scripts, on the CPU in f64 at small sizes.

Each reference demo runs as a user runs it: its module is imported from
``demos/`` and ``main()`` is called with ``sys.argv`` patched. Its numbers
come from what it prints (cell counts, dof counts) and, where the print is
rounded, from the values themselves: the locals of ``main()`` at its
return (a profile hook), or the L2 error integrals its
``fem.assemble_scalar`` calls return (a recording wrapper). The
elasticity and moving demos take the port's runtime rules in both
packages (their cost is the reference's quadrature compiles); the
perimeter tests hold the rules themselves. Nothing in ``demos/``
changes. Tolerances (chip_smoke.py's ``hold_demo``, shared
with its demos_12a phase): counts exactly; perimeter, area and volume
within 1e-10; L2 errors within 1e-6 relative (the 2D family's gate).

``reference_demos_12a`` gives the JAX-CPU numbers chip_smoke.py pins for
its demos_12a phase (PERF.md section 4)."""

import contextlib
import importlib
import io
import os
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

import cutfemx_tpu  # noqa: E402
import cutfemx_tpu_torch as ct  # noqa: E402
from chip_smoke import demo_numbers, hold_demo  # noqa: E402
from cutfemx_tpu_torch.demos import (  # noqa: E402
    demo_boundary_sphere_perimeter, demo_dg_poisson, demo_elasticity,
    demo_locate_entities, demo_moving_poisson)
from test_torch_flower import reference_rules  # noqa: E402

DEMOS_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "demos")


def _port_rules(cd, ls_part, order):
    """The port's runtime rules for the reference's CutData ``cd`` (its
    level sets' values on a port mesh of the same arrays), as reference
    rules."""
    mj = cd.mesh
    mesh = ct.mesh.Mesh(mj.vertices, mj.cells, mj.cell_type)
    phis = []
    for f in cd.level_sets:
        V = ct.functionspace(mesh, ("Lagrange", f.function_space.degree),
                             device="cpu")
        g = ct.Function(V, name=f.name, dtype=torch.float64)
        g.x = torch.tensor(np.asarray(f.x))
        phis.append(g)
    return reference_rules(
        ct.runtime_quadrature(ct.cut(phis), ls_part, order), mj)


def _run_main(name, argv, capture_locals=False, record_scalars=False,
              port_rules=False):
    """Run demos/<name>.py's main() with ``argv``: its printed lines, the
    locals of main() at its return (``capture_locals``) and the values
    of its fem.assemble_scalar calls (``record_scalars``). With
    ``port_rules`` its runtime quadrature is the port's (the reference
    then compiles no quadrature; the rules themselves are compared in the
    perimeter tests and in test_torch_moving.py)."""
    if DEMOS_DIR not in sys.path:
        sys.path.insert(0, DEMOS_DIR)
    mod = importlib.import_module(name)
    found, scalars = {}, []

    def hook(frame, event, arg):
        if event == "return" and frame.f_code is mod.main.__code__:
            found.update(frame.f_locals)

    fem = cutfemx_tpu.fem
    assemble_scalar = fem.assemble_scalar

    def recording(*a, **k):
        out = assemble_scalar(*a, **k)
        scalars.append(float(out))
        return out

    buf, argv0 = io.StringIO(), sys.argv
    runtime_quadrature = cutfemx_tpu.runtime_quadrature
    sys.argv = [name + ".py", *map(str, argv)]
    if record_scalars:
        fem.assemble_scalar = recording
    if port_rules:
        cutfemx_tpu.runtime_quadrature = _port_rules
    if capture_locals:
        sys.setprofile(hook)
    try:
        with contextlib.redirect_stdout(buf), jax.enable_x64(True):
            mod.main()
    finally:
        sys.setprofile(None)
        fem.assemble_scalar = assemble_scalar
        cutfemx_tpu.runtime_quadrature = runtime_quadrature
        sys.argv = argv0
    return buf.getvalue().splitlines(), found, scalars


def _ints(pattern, lines):
    return [int(m.group(1)) for ln in lines
            for m in [re.search(pattern, ln)] if m]


def _l2(err):
    return float(np.sqrt(max(err, 0.0)))


def reference_perimeter(n, dim):
    _, loc, _ = _run_main("demo_boundary_sphere_perimeter",
                          ["--n", n, "--dim", dim], capture_locals=True)
    return dict(perimeter=loc["perim"], area=float(loc["area"]),
                inside_cells=int(loc["inside"].size),
                cut_cells=int(loc["srf"].parent_map.size))


def reference_locate(n):
    lines, _, _ = _run_main("demo_locate_entities", ["--n", n])
    counts = _ints(r"->\s+(\d+) cells", lines)
    cells = dict(zip(demo_locate_entities.SELECTORS, counts))
    return dict(cells=cells, boundary_facets_cut=_ints(
        r"boundary facets with circle=0: (\d+)", lines)[0])


def reference_dg(n, degree=1):
    lines, _, sc = _run_main("demo_dg_poisson", ["--n", n, "--degree",
                                                  degree],
                             record_scalars=True)
    return dict(dofs=_ints(r"dofs\s+=\s+(\d+)", lines)[0],
                l2_error=_l2(sc[-1]))


def reference_elasticity(n, degree=1, port_rules=False):
    lines, _, sc = _run_main("demo_elasticity", ["--n", n, "--degree",
                                                  degree],
                             record_scalars=True, port_rules=port_rules)
    return dict(active_cells=_ints(r"active cells = (\d+)", lines)[0],
                l2_error=_l2(sc[-1]))


def reference_moving(n, steps, port_rules=False):
    lines, _, sc = _run_main("demo_moving_poisson",
                             ["--n", n, "--steps", steps],
                             record_scalars=True, port_rules=port_rules)
    return dict(cut_cells=_ints(r"cut cells =\s+(\d+)", lines),
                l2_errors=[_l2(e) for e in sc])


@pytest.mark.parametrize("dim,n", [(2, 8), (3, 6)])
def test_boundary_sphere_perimeter(dim, n):
    got = demo_boundary_sphere_perimeter.run(n, dim, device="cpu")
    hold_demo("perimeter", got, reference_perimeter(n, dim))


def test_locate_entities():
    got = demo_locate_entities.run(12, device="cpu")
    assert got["level_set_names"] == ["circle", "band"]
    hold_demo("locate", got, reference_locate(12))


def test_dg_poisson():
    got = demo_dg_poisson.run(8, device="cpu")
    hold_demo("dg", got, reference_dg(8))


def test_elasticity():
    """On the port's runtime rules in both (the reference's own are held
    by the perimeter tests; chip_smoke.py's demos_12a holds the port's
    demo against the reference's own run)."""
    got = demo_elasticity.run(16, device="cpu")
    hold_demo("elasticity", got, reference_elasticity(16, port_rules=True))


def test_moving_poisson():
    """Two steps: the disk at x = -0.4, then re-cut by ``update`` at
    x = +0.4; on the port's runtime rules in both, as test_elasticity."""
    got = demo_numbers(demo_moving_poisson.run(16, 2, device="cpu"))
    hold_demo("moving", got, reference_moving(16, 2, port_rules=True))


# -- the JAX-CPU values chip_smoke.py pins (PERF.md section 4) ---------------


def reference_demos_12a():
    """The reference demos' numbers at chip_smoke.py's demos_12a sizes, keyed
    as its JAX_CPU_DEMOS."""
    return {
        "perimeter_2d_32": reference_perimeter(32, 2),
        "perimeter_3d_32": reference_perimeter(32, 3),
        "perimeter_2d_512": reference_perimeter(512, 2),
        "locate_24": reference_locate(24),
        "locate_256": reference_locate(256),
        "dg_32": reference_dg(32),
        "dg_128": reference_dg(128),
        "elasticity_32": reference_elasticity(32),
        "elasticity_256": reference_elasticity(256),
        "moving_32": reference_moving(32, 8),
        "moving_128": reference_moving(128, 8),
    }
