#!/usr/bin/env python3
"""Drive cutfemx_tpu_torch's main path once on one CUDA card.

    python3 chip_smoke.py [--profile] [--parent-source CU]

Phases, each printing one line of numbers:

1. device: the card's name, and ``nvidia-smi``'s name and power limit;
2. build: compiles the hand-written kernels from ``cutfemx_tpu_torch/csrc``;
3. kernel: each kernel against its plain PyTorch version on the card, f32
   and f64, at three shapes (nch = 8, L = 27): the slice's grid n = 48 with
   its own mask (4,512 full cubes), the same grid at a 50% random mask, and
   bench.py's n = 108 grid with its mask. Per shape: the error, two
   launches bitwise equal, CUDA-event times with the L2 flushed between
   calls (``ms``) and without (``ms_warm``), the plain version's and one
   cuSPARSE ``torch.mv`` on the masked operator in CSR (``library_ms``, a
   yardstick the port never calls), and the bound: the bytes these inputs
   need over the card's published 3.35 TB/s;
4. small: the slice at n = 8 on the card against the same code on the CPU
   (where the interior stencil is the plain version), in f64;
5. slice: bench.py's moving-domain step at n = 48 (912,673 P2 dofs,
   r = 0.46, gamma = 40, f32 forms, Jacobi CG in f64 iterative refinement,
   rtol 1e-6): one warm-up and two timed passes, with the kernel launches
   each pass made; the operator's cube mask must equal the kernel phase's.

``--profile`` adds one pass of the slice under ``torch.profiler`` (device
busy and idle share, K1's device time). ``--parent-source CU`` builds an
earlier ``interior_stencil.cu`` with the same flags and times it in turns
with K1 at each shape (``parent_ms``).

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
import warnings

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
# K1's shapes: the slice's grid with its own mask (full cubes by the corner
# rule), the same grid at a 50% random mask, and bench.py's n = 108 grid
KERNEL_SHAPES = (("n48_bench", 48, "bench"), ("n48_random50", 48, "random"),
                 ("n108_bench", 108, "bench"))
KERNEL_REPS, PLAIN_REPS = 40, 10
FLUSH_BYTES = 256 * 2 ** 20         # rewritten between timed calls > L2
SLEEP_CYCLES_PER_CALL = 4_000_000   # ~2 ms of queue ahead of each call
HBM_BYTES_PER_S = 3.35e12           # H100 SXM published peak, 700 W


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


def _device_times(fn, reps, flush=None):
    """Device time (ms) of each of ``reps`` calls of ``fn``, by CUDA events
    around each call. A sleep kernel queued first keeps the card behind the
    host, so the host's launch overhead never lands between two events.
    With ``flush`` (a buffer of >= 128 MB) rewritten before each call, the
    50 MB L2 holds none of the call's inputs."""
    import torch
    fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(SLEEP_CYCLES_PER_CALL * reps)
    for e0, e1 in ev:
        if flush is not None:
            flush.zero_()
        e0.record()
        fn()
        e1.record()
    torch.cuda.synchronize()
    return [e0.elapsed_time(e1) for e0, e1 in ev]


def corner_rule_mask(n, radius=RADIUS):
    """Full cubes of the bench's sphere on the n^3 create_box lattice:
    a cube is full when phi < 0 at all 8 corners (exact for a P1 level
    set on create_box tets)."""
    x = np.linspace(-1.0, 1.0, n + 1)
    phi = np.sqrt(x[:, None, None] ** 2 + x[None, :, None] ** 2
                  + x[None, None, :] ** 2) - radius
    inside = phi < 0
    full = np.ones((n, n, n), bool)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                full &= inside[dx:dx + n, dy:dy + n, dz:dz + n]
    return full


def bound_bytes(n, N, nch, table, mask, itemsize):
    """Bytes K1 must move on these inputs: the whole output written once,
    the mask and A read once, and the X values that full cubes touch read
    once."""
    import torch
    m = mask.bool()
    touched = torch.zeros((nch, N, N, N), dtype=torch.bool,
                          device=mask.device)
    for ch, (dx, dy, dz) in table:
        touched[ch, dx:dx + n, dy:dy + n, dz:dz + n] |= m
    L = len(table)
    return (nch * N ** 3 + int(touched.sum()) + L * L) * itemsize + n ** 3


def csr_operator(n, N, nch, table, A, mask):
    """The masked interior operator as a CSR matrix on the card (summed
    duplicates), for the cuSPARSE yardstick; the port never builds it."""
    import torch
    q = mask.bool().nonzero()                                  # (nq, 3)
    idx = torch.stack([ch * N ** 3 + ((q[:, 0] + dx) * N + q[:, 1] + dy) * N
                       + q[:, 2] + dz for ch, (dx, dy, dz) in table], 1)
    nq, L = idx.shape
    rows = idx[:, :, None].expand(nq, L, L).reshape(-1)
    cols = idx[:, None, :].expand(nq, L, L).reshape(-1)
    vals = A[None].expand(nq, L, L).reshape(-1)
    M = nch * N ** 3
    with warnings.catch_warnings():   # "CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        coo = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals,
                                      (M, M), check_invariants=False)
        return coo.coalesce().to_sparse_csr()


def kernel_phase(ct, dev, parent_src=None):
    """K1 against its plain version, the cuSPARSE yardstick and its bound
    at each shape of KERNEL_SHAPES, in f32 and f64; with ``parent_src``,
    also the kernel built from that source, timed in turns with K1."""
    import torch
    from cutfemx_tpu_torch import interior_stencil as ist
    from cutfemx_tpu_torch.stencil import _local_dof_table
    table = _local_dof_table(DEGREE)
    L, nch = len(table), 8
    parent = None if parent_src is None else ist._load(parent_src)
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
    rng = np.random.default_rng(0)
    A = rng.standard_normal((L, L))
    if np.allclose(A, A.T):
        raise RuntimeError("the kernel check needs a non-symmetric A")
    out = []
    for shape, n, mask_kind in KERNEL_SHAPES:
        N = n + 1
        if mask_kind == "bench":
            mask_np = corner_rule_mask(n)
        else:
            mask_np = rng.random((n, n, n)) < 0.5
        mask = torch.as_tensor(mask_np.astype(np.uint8), device=dev)
        X = rng.standard_normal(nch * N ** 3)
        for dtype in (torch.float32, torch.float64):
            name = str(dtype).replace("torch.", "")
            At = torch.as_tensor(A, dtype=dtype, device=dev)
            Xt = torch.as_tensor(X, dtype=dtype, device=dev)
            args = (n, N, nch, table, At, mask, Xt)
            y = ist.interior_stencil_apply(*args)
            y2 = ist.interior_stencil_apply(*args)
            y_ref = ist.interior_stencil_apply_reference(*args)
            torch.cuda.synchronize()
            err = float((y - y_ref).abs().max())
            scale = float(y_ref.abs().max())
            tol = KERNEL_TOL[name] * scale
            if not err <= tol:
                raise RuntimeError(f"interior_stencil {shape} {name}: "
                                   f"max|err| {err} > {tol}")
            if not torch.equal(y, y2):
                raise RuntimeError(f"interior_stencil {shape} {name}: two "
                                   "launches on one input differ")
            csr = csr_operator(n, N, nch, table, At, mask)
            lib_err = float((torch.mv(csr, Xt) - y_ref).abs().max())
            if not lib_err <= tol:
                raise RuntimeError(f"cuSPARSE yardstick {shape} {name}: "
                                   f"max|err| {lib_err} > {tol}")
            k1 = lambda: ist.interior_stencil_apply(*args)  # noqa: E731
            row = dict(shape=shape, n=n, dtype=name, values=nch * N ** 3,
                       full_cubes=int(mask_np.sum()), max_abs_err=err,
                       max_abs_y=scale, tol=KERNEL_TOL[name],
                       bitwise_repeat=True)
            if parent is not None:
                p_args = (parent, *args)
                p_err = float((ist._run(*p_args) - y_ref).abs().max())
                if not p_err <= tol:
                    raise RuntimeError(f"parent kernel {shape} {name}: "
                                       f"max|err| {p_err} > {tol}")
                half = KERNEL_REPS // 2
                p1 = _device_times(lambda: ist._run(*p_args), half, flush)
                t = _device_times(k1, KERNEL_REPS, flush)
                p2 = _device_times(lambda: ist._run(*p_args), half, flush)
                row.update(parent_ms=float(np.median(p1 + p2)),
                           parent_max_abs_err=p_err)
            else:
                t = _device_times(k1, KERNEL_REPS, flush)
            ms = float(np.median(t))
            ms_warm = float(np.median(_device_times(k1, KERNEL_REPS)))
            plain_ms = float(np.median(_device_times(
                lambda: ist.interior_stencil_apply_reference(*args),
                PLAIN_REPS, flush)))
            library_ms = float(np.median(_device_times(
                lambda: torch.mv(csr, Xt), KERNEL_REPS, flush)))
            nbytes = bound_bytes(n, N, nch, table, mask, Xt.element_size())
            bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
            row.update(ms=ms, ms_warm=ms_warm, plain_ms=plain_ms,
                       library_ms=library_ms, library_max_abs_err=lib_err,
                       bound_bytes=nbytes, bound_ms=bound_ms,
                       bound_us=bound_ms * 1e3, share=bound_ms / ms)
            del csr
            _phase("kernel", kernel="interior_stencil", **row)
            out.append(row)
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


def profile_pass(ct, mesh, phi, V):
    """One more pass of the slice under torch.profiler: the device's busy
    time and idle share, and K1's device time, launches and share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run = pipeline(ct, mesh, phi, V, torch.float32)
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: an operator's entry repeats its kernels' time
    items = [(e.key, e.self_device_time_total / 1e3, e.count)
             for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA
             and e.self_device_time_total > 0]
    busy_ms = sum(ms for _, ms, _ in items)
    if not busy_ms > 0:
        raise RuntimeError("the profiler saw no device time")
    k1 = [(ms, c) for key, ms, c in items if "interior_stencil" in key]
    k1_ms, k1_count = (sum(m for m, _ in k1), sum(c for _, c in k1))
    if not k1_count:
        raise RuntimeError("the profiled pass launched no K1 kernel")
    top = sorted(items, key=lambda it: -it[1])[:8]
    _phase("profile", n=N_SLICE, iterations=run["its"], wall_ms=wall_ms,
           device_busy_ms=busy_ms, device_idle_share=1 - busy_ms / wall_ms,
           k1_device_ms=k1_ms, k1_launches=k1_count,
           k1_ms_per_launch=k1_ms / k1_count, k1_share_of_busy=k1_ms / busy_ms,
           top=[dict(name=key[:80], ms=ms, count=c) for key, ms, c in top])


def slice_phase(ct, dev, profile=False):
    """bench.py's step at n = 48 on the card: warm-up + two timed passes
    (and, with ``profile``, one profiled pass after them)."""
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
    op_mask = passes[-1][1]["op"].cube_mask
    if not np.array_equal(op_mask, corner_rule_mask(N_SLICE)):
        raise RuntimeError("the slice's cube mask differs from the corner "
                           "rule K1's phase times")
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
    if profile:
        profile_pass(ct, mesh, phi, V)
    return main_path_launches


def main():
    import argparse
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent-source", metavar="CU",
                    help="also time the kernel built from this source (an "
                         "earlier interior_stencil.cu), in turns with K1")
    ap.add_argument("--profile", action="store_true",
                    help="profile one more pass of the slice")
    args = ap.parse_args()
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
    k = kernel_phase(ct, dev, args.parent_source)
    _phase("kernel_done", seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    small_phase(ct, dev)
    _phase("small_done", seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    launches = slice_phase(ct, dev, args.profile)
    _phase("slice_done", seconds=time.perf_counter() - t0,
           total_seconds=time.perf_counter() - t_all)

    # the main path's shape: the slice's grid and mask in f32, the CG's type
    main_row = next(r for r in k if r["shape"] == "n48_bench"
                    and r["dtype"] == "float32")
    print(json.dumps({"kernels": [{
        "name": "interior_stencil", "route": "cuda",
        "source": "cutfemx_tpu_torch/csrc/interior_stencil.cu",
        "replaces": "cutfemx_tpu/pallas_stencil.py:71",
        "launches": launches,
        **{key: main_row[key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "library_ms")},
        "bound_by": "bytes",
        "shapes": [{key: r[key] for key in (
            "shape", "dtype", "max_abs_err", "ms", "ms_warm", "plain_ms",
            "library_ms", "bound_ms", "bound_us", "share", "parent_ms")
            if key in r} for r in k]}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
