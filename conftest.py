"""Tier-1 scheduling under ``pytest -n N --dist loadfile``.

The wall time of the suite is set by tests/test_sgrid_pipeline.py, which
xdist's loadfile mode would run on one worker in series: its recut test
builds two n = 24 distributed problems of its own (about 885-1125 s on an
8-core host), and its module fixture with the six tests that read it take
another 350-480 s. The scheduler below makes the recut test a work unit
of its own and hands it out first, and the rest of that file second, so
the two halves start at once on two workers; the port's parity files run
at a lower CPU priority beside them.
"""

import functools
import os

import pytest
from xdist.scheduler import LoadFileScheduling

_FIRST = (
    "tests/test_sgrid_pipeline.py::test_sgrid_moving_domain_recut_n24",
    "tests/test_sgrid_pipeline.py",
)


class _CriticalFirstScheduling(LoadFileScheduling):
    """Loadfile scheduling with ``_FIRST``'s scopes split off and first."""

    def _split_scope(self, nodeid):
        return nodeid if nodeid in _FIRST else super()._split_scope(nodeid)

    def _assign_work_unit(self, node):
        for scope in reversed(_FIRST):
            if scope in self.workqueue:
                self.workqueue.move_to_end(scope, last=False)
        super()._assign_work_unit(node)


@pytest.hookimpl(tryfirst=True, optionalhook=True)
def pytest_xdist_make_scheduler(config, log):
    if config.getvalue("dist") == "loadfile":
        return _CriticalFirstScheduling(config, log)
    return None


@functools.cache
def _lower_priority():
    os.nice(10)


@pytest.fixture(autouse=True, scope="module")
def _yield_cpu_to_the_critical_scopes(request):
    """Run the port's parity files (but the card-only test_torch_cuda.py)
    at a lower CPU priority, once per worker process: they share the host
    with the two workers of ``_FIRST``'s scopes, which never run after
    them, since those scopes are handed out first."""
    name = request.module.__name__
    if name.startswith("test_torch_") and name != "test_torch_cuda":
        _lower_priority()
    yield
