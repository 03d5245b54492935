"""Saye's dimension-reduction rules (backend="algoim") in
cutfemx_tpu_torch against cutfemx_tpu, in f64 on the CPU: the circle of
tests/test_saye.py on n = 8 quadrilaterals as a Q1 and a Q2 level set, a
sphere on n = 4 hexahedra, a two-cell input whose interfaces are no
height graph (one cell is subdivided, the other falls back to red-refined
marching), the host validation, the facet-hosted algoim branch, and
chip_smoke.py's Saye pins.

Both packages cut the same numpy level sets. Tolerances: points, weights
and normals 1e-12 absolute, the point order included, over the whole
padded arrays; except the Q1 hexahedra, where lines that lie wholly on
one side put their zero-weight padding points where a root within
rounding of 0 falls (ROADMAP C4): there the weights are held over the
whole arrays and the points and normals where the weights are not zero.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import cutfemx_tpu as cj  # noqa: E402
import cutfemx_tpu_torch as ct  # noqa: E402
from cutfemx_tpu.cut import saye as saye_j  # noqa: E402
from cutfemx_tpu_torch.cut import saye as saye_t  # noqa: E402
from chip_smoke import (HIGHER_ORDER_RTOL, JAX_CPU_SAYE,  # noqa: E402
                        _hold_ho, _sphere, ho_mesh_phi, saye_numbers)
from test_torch_core import host  # noqa: E402

TOL = 1e-12
ORDER = 4
SELECTORS = ("phi<0", "phi>0", "phi=0")


@pytest.fixture(autouse=True, scope="module")
def _yield_cpu_to_the_critical_file():
    """Tier-1's wall time is tests/test_sgrid_pipeline.py's, which runs
    beside this file on another worker and slows by about the CPU time
    taken next to it; run this file's tests at a lower priority."""
    os.nice(10)
    yield


def both(cell, n, degree, fn):
    """(reference, port) (mesh, phi, CutData) of the same level set."""
    out = []
    for pkg, kw in ((cj, {}), (ct, {"device": "cpu"})):
        mesh, phi = ho_mesh_phi(pkg, n, cell, degree, fn, **kw)
        out.append((mesh, phi, pkg.cut(phi)))
    return out


def hold_rules(ref, rules, what, padding=True):
    """Points, weights and normals of two rule sets within TOL; without
    ``padding`` the points and normals only where the weights are not
    zero (the nonzero pattern equal)."""
    w_ref = host(ref.weights_padded)
    w = host(rules.weights_padded)
    assert w.shape == w_ref.shape, what
    assert np.abs(w - w_ref).max() < TOL, what
    keep = np.ones(w.shape, bool) if padding else w_ref != 0.0
    assert np.array_equal(w != 0.0, w_ref != 0.0), what
    assert np.abs(host(rules.points_padded)[keep]
                  - host(ref.points_padded)[keep]).max() < TOL, what
    if ref.normals_padded is not None:
        assert np.abs(host(rules.normals_padded)[keep]
                      - host(ref.normals_padded)[keep]).max() < TOL, what


def hold_selectors(ref_cd, port_cd, what, order=ORDER, padding=True):
    for sel in SELECTORS:
        hold_rules(cj.runtime_quadrature(ref_cd, sel, order,
                                         backend="algoim"),
                   ct.runtime_quadrature(port_cd, sel, order,
                                         backend="algoim"),
                   (what, sel, order), padding)


@pytest.mark.parametrize("degree", [1, 2])
def test_quad_circle_rules_match(degree):
    (_, _, cdj), (_, _, cdt) = both("quadrilateral", 8, degree,
                                    _sphere(0.55))
    hold_selectors(cdj, cdt, f"quad Q{degree}")


def test_hex_sphere_rules_match():
    """Q2 over the whole padded arrays (eight cells are subdivided); Q1
    where the weights are not zero (ROADMAP C4)."""
    (mj, pj, cdj), (mt, pt, cdt) = both("hexahedron", 4, 2, _sphere(0.55))
    hold_selectors(cdj, cdt, "hex Q2")
    cells = cdt.hosted_entities[cdt.domains[0] == 2]
    stats = saye_t.saye_volume_rules(mt, pt, cells, ORDER).saye_stats
    assert (stats["subdivided_cells"], stats["fallback_cells"]) == (8, 0)
    (_, _, cdj), (_, _, cdt) = both("hexahedron", 4, 1, _sphere(0.55))
    hold_selectors(cdj, cdt, "hex Q1", padding=False)


def test_nongraph_cells_subdivide_and_fall_back():
    """Two cut cells of a 2 x 2 quad mesh with a Q2 level set: the
    tests/test_saye.py blob in (0, 1)^2 is resolved by subdivision, the
    small circle around (-0.45, -0.45) leaves a depth-2 box with no
    sign-consistent axis, so its cell is integrated by red-refined
    marching (three levels). Orders 4 and 8."""
    def level_set(x):
        return np.where(
            x[0] > 0, np.sqrt((x[0] - 0.5) ** 2 + (x[1] - 0.5) ** 2) - 0.4,
            (x[0] + 0.45) ** 2 + (x[1] + 0.45) ** 2 - 0.01)

    (mj, pj, cdj), (mt, pt, cdt) = both("quadrilateral", 2, 2, level_set)
    cells = cdt.hosted_entities[cdt.domains[0] == 2]
    assert len(cells) == 2
    groups, uniform, fallback = saye_j._box_groups(mj, pj, cells)
    got = saye_t._box_groups(mt, pt, cells)
    assert np.array_equal(fallback, got[2]) and fallback.size == 1
    for (ka, ra, la, ha), (kb, rb, lb, hb) in zip(groups + uniform,
                                                  got[0] + got[1]):
        assert ka == kb and np.array_equal(ra, rb)
        assert np.array_equal(la, lb) and np.array_equal(ha, hb)
    stats = saye_t.saye_interface_rules(mt, pt, cells, ORDER).saye_stats
    assert (stats["subdivided_cells"], stats["fallback_cells"]) == (1, 1)
    for order in (ORDER, 8):
        hold_selectors(cdj, cdt, "non-graph", order=order)


def test_host_validation():
    """The algoim backends refuse simplex host cells, and an unknown
    backend raises, as in the reference."""
    mesh, phi = ho_mesh_phi(ct, 8, "triangle", 1, lambda x: x[0] - 0.5,
                            device="cpu")
    cd = ct.cut(phi)
    for backend in ("algoim", "algoim_general"):
        with pytest.raises(ValueError, match="quadrilateral/hexahedron"):
            ct.runtime_quadrature(cd, "phi<0", 2, backend=backend)
    with pytest.raises(ValueError, match="unknown backend"):
        ct.runtime_quadrature(cd, "phi<0", 2, backend="nope")


def test_facet_hosted_algoim_branch():
    """Facet-hosted CutData with the algoim backend: the interface points
    are the roots of the P2 level set on the facets (polished), the
    facet parts the straight facet rules; n = 4 quads."""
    out = []
    for pkg, kw in ((cj, {}), (ct, {"device": "cpu"})):
        mesh, phi = ho_mesh_phi(pkg, 4, "quadrilateral", 2, _sphere(0.55),
                                **kw)
        facets = np.arange(mesh.num_facets, dtype=np.int32)
        out.append(pkg.cut(phi, entities=facets, entity_dim=1))
    cdj, cdt = out
    for sel in ("phi=0", "phi<0"):
        rj = cj.runtime_quadrature(cdj, sel, ORDER, backend="algoim")
        rt = ct.runtime_quadrature(cdt, sel, ORDER, backend="algoim")
        assert np.array_equal(rj.parent_map, rt.parent_map)
        assert np.array_equal(rj.parent_cells, rt.parent_cells)
        hold_rules(rj, rt, sel)
    # the polished crossings are not the straight backend's
    polished = ct.runtime_quadrature(cdt, "phi=0", ORDER, backend="algoim")
    straight = ct.runtime_quadrature(cdt, "phi=0", ORDER)
    assert np.abs(host(polished.points_padded)
                  - host(straight.points_padded)).max() > 1e-6


def test_saye_numbers_meet_jax_cpu_pins():
    """chip_smoke.py's saye_parity numbers on the CPU: the port against
    the JAX-CPU pins (reference_saye recomputes them)."""
    got = saye_numbers(ct, device="cpu")
    assert _hold_ho("saye_parity", got, JAX_CPU_SAYE) <= HIGHER_ORDER_RTOL


def reference_saye():
    """The JAX-CPU numbers JAX_CPU_SAYE pins (x64; ~15 s)."""
    out = saye_numbers(cj)
    return {k: out[k] for k in JAX_CPU_SAYE}
