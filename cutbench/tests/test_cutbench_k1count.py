"""The frozen K1 byte count equals chip_smoke.bound_bytes on the port's own
slot table and cube mask."""

import sys

import pytest
import torch
from conftest import ROOT, SEED, small

from counts.k1_bytes import k1_bytes, slots
from reference.cutpoisson import Problem


@pytest.mark.parametrize("itemsize", [4, 8])
def test_cutbench_k1_count_equals_chip_smoke(bench, itemsize):
    sys.path.insert(0, ROOT)
    import chip_smoke
    cell, prog = small(bench, "sphere108-loadcases")
    tr = cell.problem.Traffic(cell.spec, cell.cfg, SEED)
    prog.place(tr.center(-1))
    op = prog.operator(prog.forms(prog.cut(), tr.modes[:1]))
    n = op.n
    mask = torch.as_tensor(op.cube_mask[None].astype("uint8"))
    want = chip_smoke.bound_bytes(op.nch, op.table, mask, itemsize,
                                  (n + 1,) * 3)
    ref = Problem(cell.cfg, tr.center(-1), [], device="cpu")
    assert k1_bytes(ref.full_cubes.numpy(), 2, itemsize) == want
    assert len(slots(2)) == len(op.table) == 27 and len(slots(1)) == 8
