"""The comparison fails what it must: the control (the reference kept in
bfloat16) and a run whose timed path is broken underneath, once for each
fault the cells can have: a step that returns its state unchanged, an
answer altered where it is produced, and a solve that stops short of the
configuration's tolerance, whether it reports so or not. (The cells have
no batch to halve and no exchange between chips to leave out.) The limits
are the committed ones, at n = 8 on the CPU."""

import pytest
import torch
from conftest import SEED, small

import run as bench_run
from harness import verdict


def _stale_place(prog):
    """The level set keeps its first position: each step re-cuts and
    re-solves the warm-up's geometry, its state unchanged."""
    place, seen = prog.place, []

    def stale(center):
        if not seen:
            seen.append(center)
            place(center)
    return stale


def _stale_solve(prog):
    """Every solve returns the first solution."""
    solve, first = prog.solve, []

    def stale(op, b):
        out = solve(op, b)
        if not first:
            first.append(out[0])
        return (first[0],) + tuple(out[1:])
    return stale


def _altered_solve(prog):
    """The solution's largest entry is zeroed where the solve returns it."""
    solve = prog.solve

    def altered(op, b):
        x, *rest = solve(op, b)
        x = x.clone()
        x[torch.argmax(x.abs())] = 0.0
        return (x, *rest)
    return altered


def _early_stop(prog):
    """The solve stops after 2 iterations, as a stop at maxiter does, and
    reports the residual it reached."""
    def early(op, b):
        x, its, res = op.solve_cg(b, rtol=1e-6, maxiter=2)
        return x, int(its), float(res), 0.0
    return early


def _loose_rtol_hidden(prog):
    """The solve stops at rtol 1e-5 and reports a zero residual: only the
    reference's residual can see it."""
    def loose(op, b):
        x, its, _ = op.solve_cg(b, rtol=1e-5, maxiter=500)
        return x, int(its), 0.0, 0.0
    return loose


FAULTS = {"stale_place": ("place", _stale_place),
          "stale_solve": ("solve", _stale_solve),
          "altered_solve": ("solve", _altered_solve),
          "early_stop": ("solve", _early_stop),
          "loose_rtol_hidden": ("solve", _loose_rtol_hidden)}


@pytest.mark.parametrize("workload,fault", [
    ("sphere108-moving", "stale_place"),
    ("sphere108-moving", "altered_solve"),
    ("sphere108-moving", "early_stop"),
    ("curved108-moving", "stale_place"),
    ("curved108-moving", "altered_solve"),
    ("curved108-moving", "loose_rtol_hidden"),
    ("sphere108-loadcases", "stale_solve"),
    ("sphere108-loadcases", "altered_solve"),
    ("sphere108-loadcases", "loose_rtol_hidden"),
])
def test_cutbench_fault_is_caught(bench, workload, fault, monkeypatch):
    cell, prog = small(bench, workload)
    attr, make = FAULTS[fault]
    monkeypatch.setattr(prog, attr, make(prog))
    run = bench_run.run_window(prog, cell, SEED, 0.0, False, min_steps=3)
    readings, extra = bench_run.check(cell, run, SEED, "cpu")
    out, _ = bench_run.result(bench, cell, run, readings, extra, False)
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("workload", ["sphere108-moving",
                                      "curved108-moving",
                                      "sphere108-loadcases"])
def test_cutbench_control_fails(bench, workload):
    cell, prog = small(bench, workload)
    gen = torch.Generator().manual_seed(SEED)
    v = torch.randn(prog.V.dim, generator=gen, dtype=prog.form_dtype)
    readings = cell.problem.control(cell.cfg, cell.spec, SEED,
                                    prog.lattice_index(), v, "cpu")
    ok, rows = verdict.judge(readings, cell.limits, 0)
    assert not ok, rows
