#!/usr/bin/env python3
"""Readings behind the limits of a cell's comparison (``limits/``).

    python3 cutbench/calibrate.py --workload CELL --seeds 1,2,... \
        [--control-seeds 7,8,9] [--within W] [--seconds 0]

In one process (the host setup loaded once): for each of ``--seeds``, the
cell's set-up and a short window of the mix's own steps at the timed size
(the steps the check takes, drawn among the first ``--within``, by default
the mix's), then the check against the reference, one JSON line of the
program's readings a seed; for each of ``--control-seeds``, the problem's
control (``control`` of its module: the reference put in the program's
place one precision lower), read by the same numbers. The limit of each
number lies between the largest reading of the program and the smallest of
the control. Not run by the benchmark's runs; it needs a CUDA card unless
``--cpu``.
"""

import argparse
import gc
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import run as bench_run  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--within", type=int, default=None)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--n", type=int, default=None)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    import torch
    device = "cpu" if args.cpu else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    bench = bench_run._load_json(bench_run.ROOT, "BENCHMARK.json")
    cell = bench_run.Cell(bench, args.workload, n=args.n)
    if args.within:
        cell.spec = dict(cell.spec, check=dict(cell.spec["check"],
                                               within=args.within))
    cache_dir = None if args.cpu else os.path.join(
        HERE, "cache", "setup", f"{cell.entry['config']}-n{cell.cfg['n']}")
    prog = bench_run.open_program(cell, device, cache_dir)
    idx = prog.lattice_index()
    for i, seed in enumerate(int(s) for s in args.seeds.split(",") if s):
        t0 = time.perf_counter()
        # the first seed's warm-up builds what the others use
        run = bench_run.run_window(prog, cell, seed, args.seconds, False,
                                   warm=i == 0)
        readings, _ = bench_run.check(cell, run, seed, device)
        steps = run["steps"]
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "checked": [k for k in run["got"]
                                      if isinstance(k, int)],
                          "its": [s["its"] for s in steps],
                          "res": [s["res"] for s in steps],
                          "ok": [s["ok"] for s in steps],
                          "program": readings,
                          "wall_s": time.perf_counter() - t0}), flush=True)
        del run
        gc.collect()
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        t0 = time.perf_counter()
        gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
        v = torch.randn(prog.V.dim, generator=gen, device=device,
                        dtype=prog.form_dtype)
        out = cell.problem.control(cell.cfg, cell.spec, seed, idx, v, device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": out,
                          "wall_s": time.perf_counter() - t0}), flush=True)
        gc.collect()
    print(json.dumps({"modules_forbidden": bench_run.forbidden_modules()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
