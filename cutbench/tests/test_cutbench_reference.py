"""At small n on the CPU the plain reference agrees with the port: the
same classes, rules, load vector and operator, to float64 rounding when
the port runs in float64, on the straight and the curved cut."""

import copy

import pytest
import torch
from conftest import SEED, small

from reference.cutpoisson import Problem


@pytest.mark.parametrize("workload", ["sphere108-moving",
                                      "curved108-moving"])
def test_cutbench_reference_equals_port_f64(bench, workload):
    cell, _ = small(bench, workload)
    cell.cfg = copy.deepcopy(cell.cfg)
    cell.cfg["n"] = 9
    cell.cfg["level_set"]["dtype"] = "float64"
    cell.cfg["forms"]["dtype"] = "float64"
    import run as bench_run
    prog = bench_run.open_program(cell, "cpu", None)
    P = cell.problem
    tr = cell.problem.Traffic(cell.spec, cell.cfg, SEED)
    prog.place(tr.center(0))
    C = prog.cut()
    Fm = prog.forms(C, tr.modes)
    op = prog.operator(Fm)
    ref = Problem(cell.cfg, tr.center(0), tr.modes, device="cpu")
    idx = torch.as_tensor(prog.lattice_index())
    v = torch.randn(prog.V.dim, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(3))
    got = dict(inside=C["inside"], cut=C["vol"].parent_map,
               vol=(C["vol"].points_padded, C["vol"].weights_padded),
               srf=(C["srf"].points_padded, C["srf"].weights_padded),
               loads=[P.to_lattice(b, idx, ref) for b in Fm["loads"]],
               y=P.to_lattice(op(v), idx, ref),
               v=P.to_lattice(v, idx, ref))
    r = P.geometry(ref, got)
    assert r["class_mismatch"] == 0 and len(ref.cut) > 100
    assert max(r["vol_rule"], r["srf_rule"]) < 1e-10, r
    assert max(r["load"], r["action"]) < 1e-10, r
    # the active nodes are the dofs the port keeps active
    act = ref.active[idx]
    assert torch.equal(act, op.active.cpu())


def test_cutbench_full_cubes_are_the_ports(bench):
    """The benchmark's own full cubes (all six tets inside) are the
    port's stencil cubes."""
    cell, prog = small(bench, "sphere108-loadcases")
    tr = cell.problem.Traffic(cell.spec, cell.cfg, SEED)
    prog.place(tr.center(-1))
    op = prog.operator(prog.forms(prog.cut(), tr.modes[:1]))
    ref = Problem(cell.cfg, tr.center(-1), [], device="cpu")
    assert ref.full_cubes.numpy().sum() > 0
    assert (ref.full_cubes.numpy() == op.cube_mask).all()
