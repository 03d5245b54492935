#!/usr/bin/env python3
"""Join the port's program spans with the card's timeline in one traced
run of a benchmark cell.

    python3 tools/trace_join.py --workload CELL --seed N --seconds S \
        [--out FILE.json]

Runs ``cutbench/run.py``'s ``main`` with ``--trace 1`` (it prints its own
result line), keeping the profiler's raw device operations and the run's
record. Then, over the traced steps:

- ``layers``: each program span name's own seconds (its time less the time
  of the program spans inside it), per traced step, and for ``solve*``
  names per iteration in ms;
- ``idle``: the card's idle seconds named by the innermost program span
  around each gap's midpoint, else by the benchmark's span (``bench:NAME``);
- ``busy``: the card's busy seconds under each innermost program span;
- ``host``: the benchmark's spans (``cut``, ``forms``, ``operator``,
  ``solve``) per step over the traced steps and over the untraced ones.

Writes the JSON object to ``--out`` and prints it last. Needs a CUDA card;
imports neither JAX nor the JAX package. A program without
``profiling.spans`` gives empty program splits.
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BENCH = os.path.join(ROOT, "cutbench")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

import run as bench_run  # noqa: E402
from harness import timeline  # noqa: E402


def idle_gaps(dev, w0, w1):
    """[(g0, g1)] ns: the card's idle gaps in [w0, w1] (as
    ``timeline.reduce`` finds them), and [(a, b)] its busy intervals."""
    ops = sorted((max(a, w0), min(b, w1)) for _, a, b in dev
                 if b > w0 and a < w1)
    gaps, busy, cur0, cur1 = [], [], w0, w0
    for a, b in ops:
        if a > cur1:
            busy.append((cur0, cur1))
            gaps.append((cur1, a))
            cur0 = a
        cur1 = max(cur1, b)
    busy.append((cur0, cur1))
    if w1 > cur1:
        gaps.append((cur1, w1))
    return gaps, busy


def innermost(spans, points):
    """The name of the innermost of the nested intervals ``spans`` [(name,
    t0, t1)] around each of ``points`` (None outside them all)."""
    spans = sorted(spans, key=lambda s: (s[1], -s[2]))
    out, stack, i = [None] * len(points), [], 0
    for j in sorted(range(len(points)), key=points.__getitem__):
        t = points[j]
        while i < len(spans) and spans[i][1] <= t:
            while stack and stack[-1][2] <= spans[i][1]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][2] <= t:
            stack.pop()
        out[j] = stack[-1][0] if stack else None
    return out


def own_seconds(spans):
    """{name: seconds} of each of the nested intervals ``spans`` less the
    intervals directly inside it."""
    own, stack = {}, []
    for name, a, b in sorted(spans, key=lambda s: (s[1], -s[2])):
        while stack and stack[-1][2] <= a:
            stack.pop()
        own[name] = own.get(name, 0.0) + (b - a) * 1e-9
        if stack:
            parent = stack[-1][0]
            own[parent] = own.get(parent, 0.0) - (b - a) * 1e-9
        stack.append((name, a, b))
    return own


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    kept = {}
    reduce, result = timeline.reduce, bench_run.result

    def keep_reduce(dev, host, *a, **k):
        kept["dev"], kept["host"] = dev, host
        return reduce(dev, host, *a, **k)

    def keep_result(bench, cell, run, *a, **k):
        kept["run"] = run
        return result(bench, cell, run, *a, **k)

    timeline.reduce, bench_run.result = keep_reduce, keep_result
    rc = bench_run.main(["--workload", args.workload, "--seed",
                         str(args.seed), "--seconds", str(args.seconds),
                         "--trace", "1"])
    if rc or "dev" not in kept:
        return rc or 1
    from cutfemx_tpu_torch import profiling
    prog = list(getattr(profiling, "spans", list)())
    run, dev, host = kept["run"], kept["dev"], kept["host"]
    steps = [(a, b) for n, a, b in host if n == "step"]
    w0, w1 = min(a for a, _ in steps), max(b for _, b in steps)
    traced = run["traced_steps"]
    nsteps = len(traced)
    its = sum(s["its"] for s in traced)
    inner = [s for s in prog if w0 <= s[1] < w1]
    outer = [(f"bench:{n}", a, b) for n, a, b in host if n != "step"]
    gaps, busy = idle_gaps(dev, w0, w1)
    idle, busy_by = {}, {}
    for pairs, acc in ((gaps, idle), (busy, busy_by)):
        mids = [0.5 * (g0 + g1) for g0, g1 in pairs]
        for (g0, g1), a, b in zip(pairs, innermost(inner, mids),
                                  innermost(outer, mids)):
            name = a or b or "bench:step"
            acc[name] = acc.get(name, 0.0) + (g1 - g0) * 1e-9
    layers = {}
    for name, sec in sorted(own_seconds(inner).items()):
        row = {"own_s_per_step": sec / max(nsteps, 1),
               "calls": sum(n == name for n, _, _ in inner)}
        if name.startswith("solve") and its:
            row["own_ms_per_it"] = sec * 1e3 / its
        layers[name] = row
    # the benchmark's spans (perf_counter seconds) over traced and untraced
    # steps: what tracing costs each layer
    plain0 = run["steps"][nsteps]["t0"] if nsteps < len(run["steps"]) \
        else None
    hostsplit = {}
    for name in ("place", "cut", "forms", "operator", "combine", "solve"):
        tr = [b - a for n, a, b in run["spans"] if n == name
              and run["steps"][0]["t0"] <= a
              and (plain0 is None or a < plain0)]
        un = [b - a for n, a, b in run["spans"] if n == name
              and plain0 is not None and a >= plain0]
        hostsplit[name] = {
            "traced_s_per_step": sum(tr) / max(nsteps, 1),
            "untraced_s_per_step": (sum(un) / (len(run["steps"]) - nsteps)
                                    if un else None)}
    out = dict(workload=args.workload, seed=args.seed, traced_steps=nsteps,
               traced_its=its, window_s=(w1 - w0) * 1e-9,
               busy_s=sum(b - a for a, b in busy) * 1e-9,
               counters=dict(getattr(profiling, "counters", dict)()),
               layers=layers,
               idle=dict(sorted(idle.items(), key=lambda kv: -kv[1])),
               busy=dict(sorted(busy_by.items(), key=lambda kv: -kv[1])),
               host=hostsplit,
               steps=[{k: s[k] for k in ("its", "build_s", "ok")}
                      for s in run["steps"]])
    text = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
