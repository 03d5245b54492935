"""The readers of the program's spans and counters on a synthetic run: a
registry filled under a profiler with known intervals and counts, each
metric's value from it, and nothing without a device timeline or from a
program that has no such registry."""

import pytest
import run as bench_run
from torch.profiler import ProfilerActivity, profile

from cutfemx_tpu_torch import profiling

MS = 1_000_000          # ns
S = 1_000_000_000       # ns

LOADCASES = ("host_reads_per_it.loadcases", "sync_ms_per_it.loadcases",
             "enqueue_ms_per_it.loadcases")
MOVING = ("operator_element_s.moving", "cut_rules_s.moving",
          "forms_compile_s.moving")


@pytest.fixture
def registry():
    """Two traced steps: each a cut with two rules, two form compiles, an
    operator build and a solve of 40 iterations with a build and reads."""
    profiling.reset_timings()
    with profile(activities=[ProfilerActivity.CPU]):
        for k in range(2):
            t = k * 100 * S
            profiling.record("cut.rules", t, t + S // 4)
            profiling.record("cut.rules", t + S // 2, t + S)
            profiling.record("forms.compile", t + 2 * S, t + 2 * S + S // 2)
            profiling.record("forms.compile", t + 3 * S, t + 3 * S + S // 4)
            profiling.record("operator.element_path", t + 4 * S,
                             t + 4 * S + 3 * S // 2)
            s0 = t + 10 * S
            profiling.record("solve.build.fold", s0, s0 + 100 * MS)
            for i in range(42):
                a = s0 + 100 * MS + i * 10 * MS
                profiling.record("solve.sync", a, a + 2 * MS)
                profiling.count("solve.host_reads")
            profiling.record("solve", s0, s0 + 100 * MS + 420 * MS)
    yield
    profiling.reset_timings()


def ctx(timeline=True):
    steps = [dict(its=40), dict(its=40), dict(its=40)]
    return dict(timeline={"busy_s": 1.0, "window_s": 2.0} if timeline
                else None, traced_steps=steps[:2], steps=steps)


def test_cutbench_tracing_readers(registry):
    got = {name: bench_run.reader(name)(ctx()) for name in
           LOADCASES + MOVING}
    assert got["host_reads_per_it.loadcases"] == pytest.approx(84 / 80)
    assert got["sync_ms_per_it.loadcases"] == pytest.approx(2 * 84 / 80)
    # 520 ms a solve, less 100 ms of build and 84 ms of reads a solve
    assert got["enqueue_ms_per_it.loadcases"] == pytest.approx(
        2 * (520 - 100 - 84) / 80)
    assert got["operator_element_s.moving"] == pytest.approx(1.5)
    assert got["cut_rules_s.moving"] == pytest.approx(0.75)
    assert got["forms_compile_s.moving"] == pytest.approx(0.75)


def test_cutbench_tracing_readers_report_nothing(registry, monkeypatch):
    for name in LOADCASES + MOVING:
        assert bench_run.reader(name)(ctx(timeline=False)) is None, name
    # a program without the registry (the port before it had one)
    for attr in ("spans", "counters"):
        monkeypatch.delattr(profiling, attr)
    for name in LOADCASES + MOVING:
        assert bench_run.reader(name)(ctx()) is None, name
