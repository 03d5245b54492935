"""Every configuration, mix, metric and limit is a file of its own, found
by the name BENCHMARK.json gives it; nothing JAX is loaded, and the
reference imports nothing of the program."""

import ast
import json
import os
import subprocess
import sys

from conftest import HERE, ROOT

import run as bench_run


def test_cutbench_files_found_by_name(bench):
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    for w in bench["workloads"]:
        cell = bench_run.Cell(bench, w["name"])
        assert cell.spec and set(cell.limits) == {
            "class_mismatch", "vol_rule", "srf_rule", "load", "action",
            "residual"}
        for name in ("open_program", "Session", "check", "control"):
            assert callable(getattr(cell.problem, name))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(bench_run.reader(m["name"]))


def test_cutbench_each_cell_reports_what_it_lists(bench):
    for w in bench["workloads"]:
        e2e = bench_run.cell_metrics(bench, w, False)
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2
        assert bench_run.cell_metrics(bench, w, True)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_cutbench_reference_imports_nothing_of_the_program():
    ref = os.path.join(HERE, "reference")
    for name in os.listdir(ref):
        if name.endswith(".py"):
            tops = {m.split(".")[0] for m in _imports(os.path.join(ref,
                                                                 name))}
            assert tops <= {"__future__", "math", "numpy", "torch"}, tops


def test_cutbench_loads_no_jax():
    """The harness's imports, then the port's, in a fresh process: no
    module whose top-level name is jax, jaxlib, flax or cutfemx_tpu (the
    whole name: cutfemx_tpu_torch is the port)."""
    code = ("import sys; sys.path[:0] = [%r, %r]; import run, calibrate; "
            "from harness import timeline, verdict; "
            "from reference import cutpoisson; from counts import k1_bytes; "
            "run.problem({'problem': 'cutpoisson'}).import_port(%r); "
            "import cutfemx_tpu_torch.stencil, cutfemx_tpu_torch.io; "
            "print(run.forbidden_modules())") % (HERE, ROOT, ROOT)
    env = dict(os.environ)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_cutbench_forbidden_compares_whole_names(monkeypatch):
    import types
    for name in ("cutfemx_tpu_torch_probe", "jaxlike", "flaxen.sub"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert not {"cutfemx_tpu", "jax", "flax"} & set(
        bench_run.forbidden_modules())
    monkeypatch.setitem(sys.modules, "jax.numpy",
                        types.ModuleType("jax.numpy"))
    assert "jax" in bench_run.forbidden_modules()
