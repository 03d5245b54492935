#!/usr/bin/env python3
"""The benchmark of cutfemx_tpu_torch on one CUDA card.

    python3 cutbench/run.py --workload CELL --seed N --seconds S --trace 0|1

Run from the root of a checkout that holds ``BENCHMARK.json``, this folder
and the ``cutfemx_tpu_torch`` package. The cell names a configuration
(``configs/``), whose ``problem`` names the module in ``problems/`` that
drives the program, and a traffic mix (``traffic/``), the parameters that
module's generator reads. Set-up loads or builds the host setup (io's
setup cache, kept under ``cache/``), draws the cell's inputs from the seed
and runs one warm-up step of the cell's own shapes. The window then
repeats the mix's step for ``--seconds``; the steps the check compares are
drawn from the seed before it, and copying them for the check is taken out
of the window's time. After it the peak device memory is read, the
program's state freed, and those steps are compared with the plain
reference (``reference/``) against the cell's limits (``limits/``); a
window step whose solve did not reach the configuration's tolerance fails
the run too.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics, each read by
``metrics/<name>.py``), ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``: each number compared with its limit. The same numbers end
standard error. It exits nonzero, printing no result, without a CUDA card,
or if JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if HERE not in sys.path:
    sys.path.insert(0, HERE)

FORBIDDEN = ("jax", "jaxlib", "flax", "cutfemx_tpu")


def _load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


_MODULES = {}


def _module(folder, name):
    """``<folder>/<name>.py`` of this folder, loaded once by its path."""
    key = (folder, name)
    if key not in _MODULES:
        path = os.path.join(HERE, folder, name + ".py")
        spec = importlib.util.spec_from_file_location(
            f"cutbench_{folder}_" + name.replace(".", "_").replace("-", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[key] = mod
    return _MODULES[key]


def reader(name):
    """The reader ``metrics/<name>.py`` of a metric, by its name."""
    return _module("metrics", name).read


def problem(cfg):
    """The configuration's problem, ``problems/<problem>.py``: the port's
    adapter, the mixes' generator, the step and the check."""
    return _module("problems", cfg["problem"])


def cell_metrics(bench, cell, trace):
    """The metric entries a run of ``cell`` reports: its end-to-end metrics
    (trace 0) or its per-layer metrics (trace 1)."""
    name = cell["name"]
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Cell:
    """One cell's configuration, problem, mix and limits, found by name."""

    def __init__(self, bench, name, n=None):
        cells = {c["name"]: c for c in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"cutbench: no workload {name!r}")
        self.entry = cells[name]
        conf = {c["name"]: c for c in bench["configs"]}[self.entry["config"]]
        self.cfg = _load_json(ROOT, conf["file"])
        if n is not None:
            self.cfg["n"] = int(n)
        self.problem = problem(self.cfg)
        self.spec = _load_json(HERE, "traffic", self.entry["traffic"] + ".json")
        limits = os.path.join(HERE, "limits", name + ".json")
        self.limits = _load_json(limits) if os.path.exists(limits) else {}


def open_program(cell, device, cache_dir):
    return cell.problem.open_program(ROOT, cell.cfg, device, cache_dir)


def run_window(prog, cell, seed, seconds, trace, min_steps=1, warm=True):
    """Set-up's seeded inputs and warm-up, then the window. Returns the
    run's record: steps, spans, the host copies for the check, the
    timeline. Copying a checked step for the check is the benchmark's
    work, not the program's: its time is taken out of the window's."""
    import torch
    from harness import timeline
    cuda = prog.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    rec = timeline.Recorder(sync, trace)
    sess = cell.problem.Session(prog, cell.cfg, cell.spec, seed, rec)
    if warm:
        with rec.span("warmup"):
            sess.warmup()
    sync()
    setup_s = time.perf_counter() - T_START
    min_steps = max(min_steps, max(sess.checked) + 1)
    steps, traced, paused = [], 0, 0.0
    prof = timeline.Profile(trace)
    w0 = time.perf_counter()
    prof.start()
    while True:
        k = len(steps)
        t0 = time.perf_counter()
        with rec.span("step"):
            out = sess.step(k)
        t1 = time.perf_counter()
        out.update(t0=t0, t1=t1)
        steps.append(out)
        if k in sess.checked:
            with rec.span("capture"):
                sess.capture(k)
            paused += time.perf_counter() - t1
        elapsed = time.perf_counter() - w0 - paused
        if prof.running and elapsed >= timeline.TRACE_SECONDS:
            prof.stop()
            traced = len(steps)
        if elapsed >= seconds and len(steps) >= min_steps:
            break
    w1 = time.perf_counter()
    if prof.running:
        prof.stop()
        traced = len(steps)
    peak = torch.cuda.max_memory_allocated(prog.device) if cuda else 0
    tl = timeline.reduce(*prof.events()) if prof.prof is not None else None
    return dict(setup_s=setup_s, window=(w0, w1), window_s=w1 - w0 - paused,
                steps=steps, traced_steps=steps[:traced], spans=rec.spans,
                peak_bytes=peak, timeline=tl, got=sess.close(),
                device=str(prog.device))


def check(cell, run, seed, device):
    """(readings, extra) of the checked steps against the reference."""
    return cell.problem.check(cell.cfg, cell.spec, seed, run["got"], device)


def card_line():
    """nvidia-smi's name and power limit of the card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def result(bench, cell, run, readings, extra, trace):
    """The result object, and the rows (name, reading, limit) compared."""
    import torch
    from harness import verdict
    steps = run["steps"]
    unconverged = sum(not s["ok"] for s in steps)
    correct, rows = verdict.judge(readings, cell.limits, unconverged)
    w0, w1 = run["window"]
    # the spans' metrics read the window's steps after the trace, which the
    # profiler did not slow, or, if the trace took the window, all of them
    plain = steps[len(run["traced_steps"]):] or steps
    ctx = dict(extra, cell=cell.entry, cfg=cell.cfg, spec=cell.spec,
               setup_s=run["setup_s"], window_s=run["window_s"],
               steps=steps, spans=run["spans"],
               traced_steps=run["traced_steps"], span_steps=plain,
               span_window=(plain[0]["t0"], w1),
               peak_bytes=run["peak_bytes"], timeline=run["timeline"])
    metrics = {}
    for m in cell_metrics(bench, cell.entry, trace):
        value = reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    cuda = run["device"].startswith("cuda")
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
              "count": int(cell.entry["chips"]),
              "memory_peak_bytes": run["peak_bytes"]}
    out = {"correct": bool(correct), "attempted": len(steps),
           "failed": unconverged, "metrics": metrics, "device": device}
    tl = run["timeline"]
    if trace and tl is not None:
        device.update(busy_s=tl["busy_s"], window_s=tl["window_s"])
        ops = sorted(tl["by_name"].items(), key=lambda kv: -kv[1][0])
        gaps = sorted(tl["idle_by_span"].items(), key=lambda kv: -kv[1])
        out["breakdown"] = {
            "device_ops": [[k[:160], s] for k, (s, _) in ops[:10]],
            "idle_gaps": [[k, s] for k, s in gaps[:10]]}
    out["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return out, rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every build and kernel cache at a fixed path inside the checkout
    cache = os.path.join(HERE, "cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    bench = _load_json(ROOT, "BENCHMARK.json")
    cell = Cell(bench, args.workload)
    import torch
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"cutbench: {chips} CUDA card(s) needed, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    if not cell.limits:
        print(f"cutbench: no limits for {args.workload}", file=sys.stderr)
        return 2
    cache_dir = os.path.join(cache, "setup",
                             f"{cell.entry['config']}-n{cell.cfg['n']}")
    prog = open_program(cell, "cuda", cache_dir)
    run = run_window(prog, cell, args.seed, args.seconds, bool(args.trace))
    del prog
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    readings, extra = check(cell, run, args.seed, "cuda")
    check_s = time.perf_counter() - t0
    out, rows = result(bench, cell, run, readings, extra, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"cutbench: loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    card = card_line()
    its = [s["its"] for s in run["steps"]]
    print(f"cutbench: {args.workload} seed {args.seed}: {len(its)} steps"
          f" ({its} iterations), checked {[k for k in run['got'] if isinstance(k, int)]} in"
          f" {check_s:.1f} s; card {card}", file=sys.stderr)
    for k, v, lim in rows:
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
