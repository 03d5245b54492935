"""The surface fields of cutfemx_tpu_torch.level_set and the two demos of the
unfitted-boundary surface against cutfemx_tpu, in f64 on the CPU.

The fields are evaluated by both packages on identical rules (the port's,
handed to the reference): cell-hosted 'phi=0' rules of a circle for
level_set_value, normal, surface_normal and correction_distance (towards
the zero set of a P2 level set), and the facet-hosted crossings of its
skeleton for conormal's two sides; within 1e-12. Each reference demo runs
as a user runs it, ``main()`` with ``sys.argv`` patched, its numbers read
from what it prints (counts), from its ``fem.assemble_scalar`` calls (the
L2 errors) and from its ``np.linalg.cond`` calls: counts exactly, L2
errors and cond(active) within 1e-6 relative (chip_smoke.py's
unfitted_demos gates).

``reference_unfitted`` gives the JAX-CPU numbers chip_smoke.py pins as
JAX_CPU_UNFITTED (PERF.md section 4)."""

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
import jax.numpy as jnp  # noqa: E402

import cutfemx_tpu as cj  # noqa: E402
import cutfemx_tpu_torch as ct  # noqa: E402
from chip_smoke import (PINNED_RTOL, _hold_pin, compound_numbers,  # noqa: E402
                        facet_3d_numbers)
from cutfemx_tpu_torch.demos import (  # noqa: E402
    demo_poisson_extension_penalty_study, demo_surface_poisson_dg)
from test_torch_core import host  # noqa: E402

DEMOS_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "demos")
TOL = 1e-12
# the pinned 3D numbers: counts and sums of chip_smoke.facet_3d_numbers
FACET_3D_PIN_KEYS = (
    "cells", "cut_cells", "skeleton_facets", "cut_facets", "inside_facets",
    "lo_sum", "hi_sum", "interface_sum", "cut_facet_area", "cut_mesh_cells",
    "cut_mesh_area", "interior_cells", "well_posed", "ill_posed", "rootless",
    "max_depth", "penalty_nnz", "penalty_max")


def _circle(pkg, n, degree=1, r=0.62):
    kw = {"device": "cpu"} if pkg is ct else {}
    fkw = {"dtype": torch.float64} if pkg is ct else {}
    mesh = pkg.mesh.create_rectangle((-1.0, -1.0), (1.0, 1.0), (n, n))
    V = pkg.functionspace(mesh, ("Lagrange", degree), **kw)
    phi = pkg.Function(V, name="phi", **fkw)
    phi.interpolate(lambda x: x[0] ** 2 + x[1] ** 2 - r ** 2)
    return mesh, phi


def _as_reference(rules, mesh):
    """The reference's RuntimeQuadratureRules holding the port's rules."""
    from cutfemx_tpu.cut.quadrature import RuntimeQuadratureRules

    def arr(a):
        return None if a is None else jnp.asarray(host(a))
    return RuntimeQuadratureRules(
        rules.tdim, rules.parent_map, arr(rules.points_padded),
        arr(rules.weights_padded), mesh=mesh,
        parent_cells=rules.parent_cells, local_facets=rules.local_facets,
        normals_padded=arr(rules.normals_padded))


def test_surface_fields_match_reference():
    """level_set_value, normal, surface_normal, correction_distance (to
    the P2 zero set along the P1 normal) on 'phi=0' rules, conormal's
    '+' and '-' sides on the skeleton's crossing points."""
    mesh_j, phi_j = _circle(cj, 12)
    _, phi2_j = _circle(cj, 12, degree=2)
    mesh, phi = _circle(ct, 12)
    _, phi2 = _circle(ct, 12, degree=2)
    cd = ct.cut(phi)
    srf = ct.runtime_quadrature(cd, "phi=0", 2)
    skel = ct.interior_facets_for_cells(mesh, ct.locate_entities(cd,
                                                                "phi=0"))
    fr = ct.runtime_quadrature(ct.cut(phi, skel, 1), "phi=0", 2)
    pairs = [
        (cj.level_set_value(phi_j), ct.level_set_value(phi), srf, ()),
        (cj.normal(phi_j), ct.normal(phi), srf, ()),
        (cj.surface_normal(cj.cut(phi_j)), ct.surface_normal(cd), srf, ()),
        (cj.correction_distance(phi2_j, cj.normal(phi_j)),
         ct.correction_distance(phi2, ct.normal(phi)), srf, ()),
        (cj.conormal(cj.normal(phi_j)), ct.conormal(ct.normal(phi)), fr,
         ("+",)),
        (cj.conormal(cj.normal(phi_j)), ct.conormal(ct.normal(phi)), fr,
         ("-",)),
    ]
    for fj, ft, rules, side in pairs:
        a = np.asarray(fj.evaluator(_as_reference(rules, mesh_j), *side))
        b = host(ft.evaluator(rules, *side))
        assert a.shape == b.shape and np.abs(a - b).max() <= TOL, ft.name
        assert ft.shape == fj.shape and ft.side_dependent == \
            fj.side_dependent
    # rho moves the crossing points onto the P2 circle x^2 + y^2 = r^2
    rho = host(pairs[3][1].evaluator(srf))
    n = host(ct.normal(phi).evaluator(srf))
    el = ct.elements.lagrange_element(mesh.cell_type, 1)
    x = np.einsum("eqv,evg->eqg", host(el.tabulate(srf.points_padded)),
                  mesh.cell_vertex_coords[srf.parent_cells])
    real = host(srf.weights_padded) > 0
    rad = np.linalg.norm(x + rho[..., None] * n, axis=-1)[real]
    assert np.abs(rad - 0.62).max() < 1e-10


def _run_reference(name, argv, skip_cond=False):
    """demos/<name>.py's main() with ``argv`` (x64): its printed lines,
    the values of its fem.assemble_scalar calls and of its np.linalg.cond
    calls. ``skip_cond`` hands its cond a sparse matrix and records nan
    (the dense active block of a large mesh does not fit)."""
    if DEMOS_DIR not in sys.path:
        sys.path.insert(0, DEMOS_DIR)
    mod = importlib.import_module(name)
    scalars, conds = [], []
    fem, la = cj.fem, cj.la
    assemble_scalar, cond, to_dense = (fem.assemble_scalar, np.linalg.cond,
                                       la.MatrixCSR.to_dense)

    def recording(*a, **k):
        out = assemble_scalar(*a, **k)
        scalars.append(float(out))
        return out

    def recording_cond(M, *a, **k):
        conds.append(float("nan") if skip_cond else cond(M, *a, **k))
        return conds[-1]

    buf, argv0 = io.StringIO(), sys.argv
    sys.argv = [name + ".py", *map(str, argv)]
    fem.assemble_scalar, np.linalg.cond = recording, recording_cond
    if skip_cond:
        la.MatrixCSR.to_dense = la.MatrixCSR.to_scipy
    try:
        with contextlib.redirect_stdout(buf), jax.enable_x64(True):
            mod.main()
    finally:
        fem.assemble_scalar, np.linalg.cond = assemble_scalar, cond
        la.MatrixCSR.to_dense = to_dense
        sys.argv = argv0
    return buf.getvalue().splitlines(), scalars, conds


def _ints(pattern, lines):
    return [int(m.group(1)) for ln in lines
            for m in [re.search(pattern, ln)] if m]


def _l2(err):
    return float(np.sqrt(max(err, 0.0)))


def reference_study(n, betas=None, skip_cond=False):
    argv = ["--n", n] + ([] if betas is None else ["--betas", *betas])
    lines, sc, conds = _run_reference(
        "demo_poisson_extension_penalty_study", argv, skip_cond)
    out = dict(ill_posed=_ints(r"ill-posed cells = (\d+)", lines)[0],
               roots=_ints(r"roots = (\d+)", lines)[0],
               l2_errors=[_l2(e) for e in sc])
    if not skip_cond:
        out["conds"] = conds
    return out


def reference_surface(n):
    lines, sc, _ = _run_reference("demo_surface_poisson_dg", ["--n", n])
    return dict(cut_cells=_ints(r"cut cells\s+=\s+(\d+)", lines)[0],
                skeleton_facets=_ints(r"skeleton facets\s+=\s+(\d+)",
                                      lines)[0],
                l2_error=_l2(sc[-1]))


def test_study_demo_matches_reference_script():
    got = demo_poisson_extension_penalty_study.run(16, device="cpu")
    _hold_pin("study_16", got, reference_study(16), PINNED_RTOL)
    assert got["ill_posed"] > 0 and max(got["residuals"]) <= 1e-9


def test_surface_demo_matches_reference_script():
    got = demo_surface_poisson_dg.run(16, device="cpu")
    _hold_pin("surface_16", got, reference_surface(16), PINNED_RTOL)
    assert got["residual"] <= 1e-9


# -- the JAX-CPU values chip_smoke.py pins (PERF.md section 4) ---------------


def reference_unfitted():
    """The reference's numbers at chip_smoke.py's pinned sizes, keyed as
    its JAX_CPU_UNFITTED."""
    facet = facet_3d_numbers(cj, 8)
    compound = compound_numbers(cj, 16)
    del compound["seconds"]
    return {
        "study_24": reference_study(24),
        "study_128": reference_study(128, [1.0], skip_cond=True),
        "surface_16": reference_surface(16),
        "surface_32": reference_surface(32),
        "facet_3d_8": {k: facet[k] for k in FACET_3D_PIN_KEYS},
        "compound_16": compound,
    }
