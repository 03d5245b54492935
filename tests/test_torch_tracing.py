"""The program's spans and counters (``profiling.span`` / ``count``) on the
bench step at n = 6 on the CPU: a P1 sphere cut, the Nitsche + ghost-penalty
forms of a P2 space in f32 and ``StencilCutOperator.solve_cg(precond=
"pallas")``, whose stack stages run on their CPU twins and whose f32 solve
goes through iterative refinement.

Without a profiler the step leaves the registry empty. Under
``torch.profiler.profile`` every span the step reaches is recorded inside
its parent's interval, ``solve.host_reads`` equals kineto's count of
``aten::_local_scalar_dense`` (the blocking scalar reads) inside the solve,
``build_log`` holds the ``solve.build.*`` spans' own seconds, and the spans
lie on kineto's clock."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import cutfemx_tpu_torch as ct
from cutfemx_tpu_torch import fem, profiling
from cutfemx_tpu_torch.forms import dsl as d
from cutfemx_tpu_torch.forms.measure import Measure
from cutfemx_tpu_torch.stencil import StencilCutOperator

N = 6
MAXITER = 12     # the solve stops early: enough for every span, few events
LAYERS = {
    "cut": ("cut.classify", "cut.locate", "cut.ghost_facets", "cut.rules"),
    "forms": ("forms.compile", "forms.active_domain",
              "forms.assemble_vector"),
    "operator": ("operator.local_matrix", "operator.grid_maps",
                 "operator.element_path", "operator.apply_plan"),
    "solve": ("solve.build.fold", "solve.build.asm", "solve.build.coarse",
              "solve.ir.measure", "solve.stage.k1", "solve.stage.band",
              "solve.stage.asm", "solve.stage.coarse", "solve.sync"),
}
CLOCK_SLACK_NS = 1_000_000


def step():
    """One step on a fresh mesh and space (so the operator builds its grid
    maps), the layers inside outer spans named as the benchmark's: ``cut``,
    ``forms``, ``operator`` (the solve's own span is ``solve``). Returns
    (op, b, iterations)."""
    mesh = ct.mesh.create_box((-1.0,) * 3, (1.0,) * 3, (N,) * 3,
                              cell_type="tetrahedron")
    phi = ct.Function(ct.functionspace(mesh, ("Lagrange", 1), device="cpu"),
                      dtype=torch.float32)
    phi.interpolate(lambda x: np.sqrt((x ** 2).sum(0)) - 0.7)
    V = ct.functionspace(mesh, ("Lagrange", 2), device="cpu")
    with profiling.span("cut"):
        cd = ct.cut(phi)
        inside = ct.locate_entities(cd, "phi<0")
        gp = ct.ghost_penalty_facets(cd, "phi<0")
        vol = ct.runtime_quadrature(cd, "phi<0", 4)
        srf = ct.runtime_quadrature(cd, "phi=0", 4)
    with profiling.span("forms"):
        dxo = Measure("dx", domain=mesh, subdomain_data=[inside, vol])
        dxg = Measure("dx", domain=mesh, subdomain_data=srf)
        dSg = Measure("dS", domain=mesh, subdomain_data=gp)
        u, v = d.TrialFunction(V), d.TestFunction(V)
        ng, nf, h = ct.normal(phi), d.FacetNormal(mesh), d.CellDiameter(mesh)
        a = d.inner(d.grad(u), d.grad(v)) * dxo
        a += (-d.dot(d.grad(u), ng) * v - d.dot(d.grad(v), ng) * u
              + 40.0 / h * u * v) * dxg
        a += 0.1 * d.avg(h) * d.inner(d.jump(d.grad(u), nf),
                                      d.jump(d.grad(v), nf)) * dSg
        af = fem.form(a, dtype=torch.float32)
        dom = fem.active_domain(af)
        b = fem.assemble_vector(fem.form(v * dxo, dtype=torch.float32))
    with profiling.span("operator"):
        op = StencilCutOperator(af, dom)
    _, its, _ = op.solve_cg(b, rtol=1e-6, maxiter=MAXITER,
                            precond="pallas")
    return op, b, its


def test_tracing_off_records_nothing():
    profiling.reset_timings()
    op, _, its = step()
    assert its > 0 and set(op.build_log) == {"fold", "asm", "coarse"}
    assert profiling.spans() == []
    assert profiling.counters() == {}
    assert profiling.timings() == {}


def test_tracing_spans_nest_and_count_reads():
    profiling.reset_timings()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        op, b, its = step()
        first = profiling.counters()["solve.host_reads"]
        with record_function("probe.solve"):
            _, its2, _ = op.solve_cg(b, rtol=1e-6, maxiter=MAXITER,
                                     precond="pallas")
    spans = profiling.spans()
    names = {n for n, _, _ in spans}
    assert names == set(LAYERS).union(*LAYERS.values())
    assert all(t0 <= t1 for _, t0, t1 in spans)
    for layer, inner in LAYERS.items():
        outer = [(a, b) for n, a, b in spans if n == layer]
        for name, t0, t1 in spans:
            if name in inner:
                assert any(a <= t0 and t1 <= b for a, b in outer), name
    calls = {n: sum(m == n for m, _, _ in spans) for n in names}
    assert calls["solve"] == 2 and calls["operator.grid_maps"] == 1
    # an operator apply is k1 + band, a preconditioner apply asm + coarse;
    # the f64 measure of refinement applies k1 with the gathered band
    assert calls["solve.stage.band"] == calls["solve.stage.asm"] \
        == calls["solve.stage.coarse"] > its
    assert calls["solve.stage.k1"] == calls["solve.stage.band"] \
        + calls["solve.ir.measure"]
    # build_log's seconds are the build spans' own two clock reads
    for stage, (_, sec) in op.build_log.items():
        (t0, t1), = [(a, b) for m, a, b in spans
                     if m == "solve.build." + stage]
        assert round(sec * 1e9) == t1 - t0
    # each blocking scalar read of the solve is one solve.sync and one
    # count; kineto's record of the reads of the second solve (no builds)
    # is the oracle
    reads = profiling.counters()["solve.host_reads"]
    assert reads == calls["solve.sync"]
    events = list(prof.profiler.kineto_results.events())
    (p0, p1), = [(e.start_ns(), e.start_ns() + e.duration_ns())
                 for e in events if e.name() == "probe.solve"]
    oracle = sum(e.name() == "aten::_local_scalar_dense"
                 and p0 <= e.start_ns() <= p1 for e in events)
    assert reads - first == oracle > its2
    assert profiling.timings()["solve"][0] == 2


def test_tracing_spans_on_kineto_clock():
    """A span started inside a probe ``record_function`` lies inside the
    probe's kineto interval, widened by a millisecond."""
    profiling.reset_timings()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(5):
            with record_function("probe"):
                with profiling.span("inside"):
                    torch.ones(1000).sum()
    probes = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                    for e in prof.profiler.kineto_results.events()
                    if e.name() == "probe")
    inside = sorted((a, b) for n, a, b in profiling.spans() if n == "inside")
    assert len(probes) == len(inside) == 5
    for (p0, p1), (a, b) in zip(probes, inside):
        assert p0 - CLOCK_SLACK_NS <= a <= b <= p1 + CLOCK_SLACK_NS
    assert not profiling.counters()
    profiling.reset_timings()


@pytest.fixture(autouse=True)
def _clean_registry():
    yield
    profiling.reset_timings()
