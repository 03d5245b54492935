"""The cut-Poisson problem's mix generator: seeded, deterministic, inside
its ranges, every seed doing the same work."""

import numpy as np
import pytest
from conftest import SEED

import run as bench_run


def _traffic(bench, workload, seed):
    cell = bench_run.Cell(bench, workload)
    return cell.problem.Traffic(cell.spec, cell.cfg, seed)


@pytest.mark.parametrize("seed", [SEED, 0, -5, 2 ** 33 + 1])
def test_cutbench_moving_is_seeded_and_in_range(bench, seed):
    a, b = (_traffic(bench, "sphere108-moving", seed) for _ in range(2))
    xs = [a.center(k) for k in range(-1, 200)]
    assert xs == [b.center(k) for k in range(-1, 200)]
    x = np.array(xs)
    assert (np.abs(x[:, 0]) <= 0.4).all() and (x[:, 1:] == 0.0).all()
    h = 2.0 / 108
    # 7 positions on whole mesh widths, spread over [-0.4, 0.4]: any 7
    # steps visit all 7, the same for every seed
    ring = [k * h for k in (-21, -14, -7, 0, 7, 14, 21)]
    assert np.allclose(sorted(set(np.round(x[:, 0], 12))), ring)
    for k in range(0, 190, 13):
        assert np.allclose(sorted(x[k:k + 7, 0]), ring)
    assert a.coefficients(3) is None and a.modes == [(1, 1, 1)]
    assert a.checked == b.checked and len(a.checked) == 2
    assert max(a.checked) < 6


def test_cutbench_seeds_differ(bench):
    orders = {tuple(_traffic(bench, "sphere108-moving", s).center(k)[0]
                    for k in range(3)) for s in range(40)}
    assert len(orders) == 14          # 7 starts, 2 directions


def test_cutbench_loadcases_are_seeded(bench):
    a, b = (_traffic(bench, "sphere108-loadcases", SEED) for _ in range(2))
    assert a.modes == b.modes and len(set(a.modes)) == 4
    assert all(m in (1, 2, 3) for mode in a.modes for m in mode)
    c = [a.coefficients(k) for k in range(-1, 50)]
    assert all(np.array_equal(u, v) for u, v in
               zip(c, (b.coefficients(k) for k in range(-1, 50))))
    # no two solves share a right-hand side
    assert len({tuple(np.round(u, 12)) for u in c}) == len(c)
    assert a.center(7) == (0.0, 0.0, 0.0)
    assert a.checked == b.checked and len(a.checked) == 3
    assert max(a.checked) < 40
