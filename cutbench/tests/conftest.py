"""Shared set-up of the benchmark's CPU tests: the benchmark's folder on
the path, its BENCHMARK.json, and small cells (n = 8) on CPU tensors."""

import json
import os
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
if HERE not in sys.path:
    sys.path.insert(0, HERE)

import run as bench_run  # noqa: E402

N_SMALL = 8
SEED = 2 ** 31 + 77          # above 32 signed bits, as a check's seeds are


@pytest.fixture(scope="session")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


_PROGRAMS = {}


def small(bench, workload, n=N_SMALL):
    """(cell, program) of ``workload`` at ``n`` on the CPU, one program a
    configuration and size for the session (no setup cache written). The
    checked steps are drawn among the first 3, so that a window of 3 steps
    holds them."""
    cell = bench_run.Cell(bench, workload, n=n)
    cell.spec = dict(cell.spec, check=dict(cell.spec["check"], within=3))
    key = (cell.entry["config"], n)
    if key not in _PROGRAMS:
        _PROGRAMS[key] = bench_run.open_program(cell, "cpu", None)
    return cell, _PROGRAMS[key]


def small_run(bench, workload, seed=SEED, min_steps=2, trace=False):
    """A run of ``workload`` at n = 8 on the CPU past the harness's look for
    a card: set-up, a window of ``min_steps`` steps, the check, the result."""
    cell, prog = small(bench, workload)
    run = bench_run.run_window(prog, cell, seed, 0.0, trace,
                               min_steps=min_steps)
    readings, extra = bench_run.check(cell, run, seed, "cpu")
    out, rows = bench_run.result(bench, cell, run, readings, extra, trace)
    return out, readings
