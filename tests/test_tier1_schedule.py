"""The root conftest's tier-1 scheduler still names tests that exist: a
rename in tests/test_sgrid_pipeline.py fails here instead of silently
putting the recut test back behind the rest of its file."""

import ast
import importlib.util
from collections import OrderedDict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _root_conftest():
    # `import conftest` may resolve to tests/conftest.py
    spec = importlib.util.spec_from_file_location(
        "tier1_root_conftest", ROOT / "conftest.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Node:
    def send_runtest_some(self, indices):
        self.sent = indices


def test_first_scopes_exist_and_go_first():
    mod = _root_conftest()
    for scope in mod._FIRST:
        path, _, func = scope.partition("::")
        assert (ROOT / path).is_file(), scope
        if func:
            tree = ast.parse((ROOT / path).read_text())
            names = {n.name for n in tree.body
                     if isinstance(n, ast.FunctionDef)}
            assert func in names, scope

    sched = mod._CriticalFirstScheduling.__new__(mod._CriticalFirstScheduling)
    recut, sgrid = mod._FIRST
    other = sgrid + "::test_sgrid_rhs_matches_serial"
    assert sched._split_scope(recut) == recut
    assert sched._split_scope(other) == sgrid
    assert (sched._split_scope("tests/test_torch_core.py::test_x")
            == "tests/test_torch_core.py")

    # the two scopes leave the queue first, in _FIRST's order
    collection = ["tests/test_a.py::t1", "tests/test_a.py::t2", other, recut]
    sched.workqueue = OrderedDict()
    for nodeid in collection:
        sched.workqueue.setdefault(sched._split_scope(nodeid), {})[nodeid] = 0
    node = _Node()
    sched.assigned_work, sched.registered_collections = {}, {node: collection}
    handed = []
    for _ in range(3):
        sched._assign_work_unit(node)
        handed.append(collection[node.sent[0]])
    assert handed == [recut, other, "tests/test_a.py::t1"]
