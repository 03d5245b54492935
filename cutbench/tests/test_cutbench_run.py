"""A run past the harness's look for a card: its result line has exactly
the result keys a run must print, and the harness refuses to run without a
card."""

import json
import os
import subprocess
import sys

import pytest
import torch
from conftest import HERE, ROOT, small_run


@pytest.mark.parametrize("workload,trace", [("sphere108-moving", False),
                                            ("sphere108-loadcases", False),
                                            ("sphere108-loadcases", True)])
def test_cutbench_result_keys(bench, workload, trace):
    out, readings = small_run(bench, workload, trace=trace)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] >= 2
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    if trace:      # the CPU's trace has no device timeline
        assert set(out["metrics"]) == {"cg_ms_per_it.loadcases",
                                       "solve_s.loadcases"}
    else:      # the CPU has no device memory to read a peak from
        import run as bench_run
        cell = {c["name"]: c for c in bench["workloads"]}[workload]
        listed = {m["name"] for m in bench_run.cell_metrics(bench, cell,
                                                            False)}
        assert "setup_s" in out["metrics"]
        assert set(out["metrics"]) == listed - {"peak_mem_gib"}
    assert all(set(m) == {"value", "unit"} for m in out["metrics"].values())
    assert list(out["checks"])[0] == "class_mismatch"
    assert out["checks"]["unconverged_steps"] == {"value": 0, "limit": 0}
    json.dumps(out)


def test_cutbench_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, os.path.join(HERE, "run.py"),
                          "--workload", "sphere108-moving", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_cutbench_refuses_without_the_program(tmp_path):
    """In a folder that holds only BENCHMARK.json and the benchmark."""
    import shutil
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(HERE, tmp_path / "cutbench",
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    out = subprocess.run([sys.executable, "cutbench/run.py", "--workload",
                          "sphere108-moving", "--seed", "1", "--seconds",
                          "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_cutbench_small_run_on_the_card(bench):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import run as bench_run
    cell = bench_run.Cell(bench, "sphere108-loadcases", n=24)
    prog = bench_run.open_program(cell, "cuda", None)
    run = bench_run.run_window(prog, cell, 5, 0.0, True, min_steps=3)
    readings, extra = bench_run.check(cell, run, 5, "cuda")
    out, _ = bench_run.result(bench, cell, run, readings, extra, True)
    assert out["correct"] is True, out["checks"]
    assert out["device"]["busy_s"] > 0
