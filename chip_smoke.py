#!/usr/bin/env python3
"""Drive cutfemx_tpu_torch's main path once on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one line of numbers:

1. device: the card's name, and ``nvidia-smi``'s name and power limit;
2. build: compiles the hand-written kernels from ``cutfemx_tpu_torch/csrc``;
3. kernel: each kernel against its plain PyTorch version on the card at
   the slice's shapes (n = 48: N = 49, nch = 8, L = 27), f32 and f64, with
   CUDA-event times of both;
4. small: the slice at n = 8 on the card against the same code on the CPU
   (where the interior stencil is the plain version), in f64;
5. slice: bench.py's moving-domain step at n = 48 (912,673 P2 dofs,
   r = 0.46, gamma = 40, f32 forms, Jacobi CG in f64 iterative refinement,
   rtol 1e-6): one warm-up and two timed passes, with the kernel launches
   each pass made.

Then one JSON line of the kernels, the nvidia-smi line, and, last, the JSON
result line. Any failed check raises: the script exits nonzero and prints
no result. It needs a CUDA card and the cutfemx_tpu_torch package beside
it; it imports nothing of JAX.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

# CG iterations of the JAX reference (cutfemx_tpu, on a CPU) for the n = 48
# slice with the same problem and options; PERF.md, "JAX-CPU reference of
# the n = 48 slice", gives the command and the run.
JAX_CPU_ITERATIONS_N48 = 263
ITERATION_BAND = 0.05          # the port must land within +-5% of it

N_SLICE, N_SMALL = 48, 8
RADIUS, GAMMA, DEGREE = 0.46, 40.0, 2
RTOL, MAXITER = 1e-6, 500
KERNEL_TOL = {"float32": 2e-6, "float64": 1e-12}   # times max|y|
TIMING_REPS = 30


def _phase(phase, **numbers):
    print(json.dumps({"phase": phase, **numbers}), flush=True)


def _import_port():
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "cutfemx_tpu_torch")):
        raise SystemExit("chip_smoke.py needs the cutfemx_tpu_torch "
                         "package beside it")
    sys.path.insert(0, here)
    import cutfemx_tpu_torch
    return cutfemx_tpu_torch


def _median_ms(fn, reps=TIMING_REPS, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


def kernel_phase(ct, dev):
    """K1 against its plain version at the slice's shapes."""
    import torch
    from cutfemx_tpu_torch import interior_stencil as ist
    from cutfemx_tpu_torch.stencil import _local_dof_table
    n, N, nch = N_SLICE, N_SLICE + 1, 8
    table = _local_dof_table(DEGREE)
    L = len(table)
    rng = np.random.default_rng(0)
    A = rng.standard_normal((L, L))
    if np.allclose(A, A.T):
        raise RuntimeError("the kernel check needs a non-symmetric A")
    mask = torch.as_tensor((rng.random((n, n, n)) < 0.5).astype(np.uint8),
                           device=dev)
    X = rng.standard_normal(nch * N ** 3)
    out = {}
    for dtype in (torch.float32, torch.float64):
        At = torch.as_tensor(A, dtype=dtype, device=dev)
        Xt = torch.as_tensor(X, dtype=dtype, device=dev)
        args = (n, N, nch, table, At, mask, Xt)
        y = ist.interior_stencil_apply(*args)
        y2 = ist.interior_stencil_apply(*args)
        y_ref = ist.interior_stencil_apply_reference(*args)
        torch.cuda.synchronize()
        err = float((y - y_ref).abs().max())
        scale = float(y_ref.abs().max())
        name = str(dtype).replace("torch.", "")
        if not err <= KERNEL_TOL[name] * scale:
            raise RuntimeError(f"interior_stencil {name}: max|err| {err} > "
                               f"{KERNEL_TOL[name]} * max|y| {scale}")
        if not torch.equal(y, y2):
            raise RuntimeError(f"interior_stencil {name}: two launches "
                               "on one input differ")
        ms = _median_ms(lambda: ist.interior_stencil_apply(*args))
        plain_ms = _median_ms(
            lambda: ist.interior_stencil_apply_reference(*args))
        out[name] = dict(max_abs_err=err, max_abs_y=scale, ms=ms,
                         plain_ms=plain_ms)
        _phase("kernel", kernel="interior_stencil", dtype=name, n=n,
               values=nch * N ** 3, max_abs_err=err, max_abs_y=scale,
               tol=KERNEL_TOL[name], ms=ms, plain_ms=plain_ms)
    return out


def setup(ct, n, device, phi_dtype):
    """Host setup of bench.py: mesh, level set, spaces and topology."""
    mesh = ct.mesh.create_box((-1, -1, -1), (1, 1, 1), (n, n, n))
    Vphi = ct.functionspace(mesh, ("Lagrange", 1), device=device)
    phi = ct.Function(Vphi, name="phi", dtype=phi_dtype)
    phi.interpolate(lambda x: np.sqrt(x[0] ** 2 + x[1] ** 2 + x[2] ** 2)
                    - RADIUS)
    V = ct.functionspace(mesh, ("Lagrange", DEGREE), device=device)
    _ = mesh.facets
    _ = mesh.cell_diameters()
    return mesh, phi, V


def pipeline(ct, mesh, phi, V, form_dtype, rtol=RTOL):
    """One moving-domain step, as bench.py's pipeline(): classify ->
    quadrature -> forms -> assemble -> operator -> solve."""
    import torch
    from cutfemx_tpu_torch import fem
    from cutfemx_tpu_torch.forms.dsl import (CellDiameter, FacetNormal,
                                             SpatialCoordinate, TestFunction,
                                             TrialFunction, avg, dot, grad,
                                             inner, jump, pi, sin)
    from cutfemx_tpu_torch.forms.measure import Measure
    from cutfemx_tpu_torch.stencil import StencilCutOperator
    sync = torch.cuda.synchronize if phi.x.is_cuda else (lambda: None)
    t0 = time.perf_counter()
    cd = ct.cut(phi)
    inside = ct.locate_entities(cd, "phi<0")
    vol = ct.runtime_quadrature(cd, "phi<0", 2 * DEGREE)
    srf = ct.runtime_quadrature(cd, "phi=0", 2 * DEGREE)
    gp = ct.ghost_penalty_facets(cd, "phi<0")
    dxo = Measure("dx", domain=mesh, subdomain_data=[inside, vol])
    dxg = Measure("dx", domain=mesh, subdomain_data=srf)
    dSg = Measure("dS", domain=mesh, subdomain_data=gp)
    u, v = TrialFunction(V), TestFunction(V)
    x = SpatialCoordinate(mesh)
    ng = ct.normal(phi)
    nf = FacetNormal(mesh)
    h = CellDiameter(mesh)
    ue = sin(pi * x[0]) * sin(pi * x[1]) * sin(pi * x[2])
    f = 3 * pi ** 2 * ue
    a = inner(grad(u), grad(v)) * dxo
    a += (-dot(grad(u), ng) * v - dot(grad(v), ng) * u
          + GAMMA / h * u * v) * dxg
    a += 0.1 * avg(h) * inner(jump(grad(u), nf), jump(grad(v), nf)) * dSg
    L = f * v * dxo + (-dot(grad(v), ng) * ue + GAMMA / h * ue * v) * dxg
    af = fem.form(a, dtype=form_dtype)
    Lf = fem.form(L, dtype=form_dtype)
    dom = fem.active_domain(af)
    b = fem.assemble_vector(Lf)
    sync()
    t_forms = time.perf_counter()
    op = StencilCutOperator(af, dom)
    sync()
    t_mid = time.perf_counter()
    xs, its, _ = op.solve_cg(b, rtol=rtol, maxiter=MAXITER,
                             precond="jacobi")
    sync()
    t1 = time.perf_counter()
    return dict(x=xs, its=int(its), b=b, op=op,
                assembly_s=t_mid - t0, forms_s=t_forms - t0,
                operator_s=t_mid - t_forms, solve_s=t1 - t_mid,
                total_s=t1 - t0)


def true_rel_residual(op, b, x):
    """||b - A x|| / ||b|| over active dofs, applied in f64."""
    import torch
    from cutfemx_tpu_torch.stencil import _grid_apply_body
    bg = op.vec_to_grid(torch.where(op.active, b, 0.0)).double()
    xg = op.vec_to_grid(x).double()
    r = bg - _grid_apply_body(*op._grid_statics(), *op._grid_arrays_f64(),
                              xg)
    r = torch.where(op.active_grid, r, 0.0)
    return float(torch.linalg.norm(r) / torch.linalg.norm(bg))


def small_phase(ct, dev):
    """The slice at n = 8 on the card against the same code on the CPU."""
    import torch
    runs = {}
    for d in ("cpu", dev):
        mesh, phi, V = setup(ct, N_SMALL, d, torch.float64)
        runs[str(d)] = pipeline(ct, mesh, phi, V, torch.float64, rtol=1e-9)
    c, g = runs["cpu"], runs[str(dev)]
    b_err = float((g["b"].cpu() - c["b"]).abs().max() / c["b"].abs().max())
    x_c = torch.where(c["op"].active, c["x"], 0.0)
    x_g = torch.where(g["op"].active.cpu(), g["x"].cpu(), 0.0)
    x_err = float((x_g - x_c).abs().max() / x_c.abs().max())
    if not (b_err < 1e-12 and x_err < 1e-6 and abs(g["its"] - c["its"]) <= 2
            and torch.isfinite(g["x"]).all()):
        raise RuntimeError(f"n={N_SMALL}: card and CPU disagree: b {b_err}, "
                           f"x {x_err}, its {g['its']} vs {c['its']}")
    _phase("small", n=N_SMALL, dofs=c["op"].dim, b_rel_err=b_err,
           x_rel_err=x_err, its_cuda=g["its"], its_cpu=c["its"])


def slice_phase(ct, dev):
    """bench.py's step at n = 48 on the card: warm-up + two timed passes."""
    import torch
    from cutfemx_tpu_torch import interior_stencil as ist
    t0 = time.perf_counter()
    # bench.py runs with JAX's default f32: f32 level set and quadrature
    mesh, phi, V = setup(ct, N_SLICE, dev, torch.float32)
    host_setup_s = time.perf_counter() - t0
    passes = []
    ist.launches = 0
    for p in ("warmup", "timed1", "timed2"):
        before = ist.launches
        run = pipeline(ct, mesh, phi, V, torch.float32)
        run["launches"] = ist.launches - before
        passes.append((p, run))
    main_path_launches = ist.launches
    for p, run in passes:
        x, op = run["x"], run["op"]
        rel = true_rel_residual(op, run["b"], x)
        if not (torch.isfinite(x).all() and x.shape == (V.dim,)):
            raise RuntimeError(f"{p}: non-finite or misshapen solution")
        if not rel <= RTOL:
            raise RuntimeError(f"{p}: true relative residual {rel} > {RTOL}")
        if run["launches"] <= 0:
            raise RuntimeError(f"{p}: the interior-stencil kernel was not "
                               "launched")
        _phase("slice", **{"pass": p}, n=N_SLICE, dofs=V.dim,
               iterations=run["its"], true_rel_residual=rel,
               host_setup_s=host_setup_s,
               assembly_s=run["assembly_s"], forms_s=run["forms_s"],
               operator_s=run["operator_s"], solve_s=run["solve_s"],
               total_s=run["total_s"], launches=run["launches"],
               peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 2 ** 30)
    its = [run["its"] for p, run in passes if p != "warmup"]
    if its[0] != its[1]:
        raise RuntimeError(f"timed passes took {its[0]} and {its[1]} "
                           "iterations")
    band = ITERATION_BAND * JAX_CPU_ITERATIONS_N48
    if abs(its[0] - JAX_CPU_ITERATIONS_N48) > band:
        raise RuntimeError(f"{its[0]} iterations, JAX-CPU reference "
                           f"{JAX_CPU_ITERATIONS_N48} (+-{band:.1f})")
    return main_path_launches


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card; none is visible")
    ct = _import_port()
    dev = torch.device("cuda", 0)
    t_all = time.perf_counter()

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    _phase("device", name=name, count=torch.cuda.device_count(),
           nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)

    from cutfemx_tpu_torch import interior_stencil as ist
    t0 = time.perf_counter()
    ist.build()
    _phase("build", kernel="interior_stencil",
           seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    k = kernel_phase(ct, dev)
    _phase("kernel_done", seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    small_phase(ct, dev)
    _phase("small_done", seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    launches = slice_phase(ct, dev)
    _phase("slice_done", seconds=time.perf_counter() - t0,
           total_seconds=time.perf_counter() - t_all)

    f32, f64 = k["float32"], k["float64"]
    print(json.dumps({"kernels": [{
        "name": "interior_stencil", "route": "cuda",
        "source": "cutfemx_tpu_torch/csrc/interior_stencil.cu",
        "replaces": "cutfemx_tpu/pallas_stencil.py:71",
        "launches": launches, "max_abs_err": f32["max_abs_err"],
        "ms": f32["ms"], "plain_ms": f32["plain_ms"],
        "max_abs_err_f64": f64["max_abs_err"], "ms_f64": f64["ms"],
        "plain_ms_f64": f64["plain_ms"]}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
