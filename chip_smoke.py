#!/usr/bin/env python3
"""Drive cutfemx_tpu_torch's main path once on one CUDA card.

    python3 chip_smoke.py [--profile] [--parent-source CU]
                          [--compare-preconds] [--n72] [--n90] [--n108]

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
   each pass made; the operator's cube mask must equal the kernel phase's;
6. stack_small: the n = 8 step with ``precond="pallas"`` (K1 + folded band
   + cube-ASM + coarse lattice) on the card against the same step on CPU
   tensors;
7. stack: the n = 48 step with ``precond="pallas"``, as bench.py runs it on
   a static level set: one warm-up and two timed passes, which must adopt
   the cached fold, ASM and coarse builds, then one pass with the build
   cache cleared (the cold build times). Gates: true relative residual
   <= 1e-6, equal iterations in the timed passes, a count within +-5% (at
   least +-3) of the JAX-CPU ``asm-fold2`` count, K1 launched once per
   operator apply. Then each torch stage of one iteration (fold apply, ASM
   apply, coarse apply, CG vector updates) and K1 timed alone on the
   pass's tensors, with its calls per pass and the bytes it must move.

8. flower_parity: the 2D flower Poisson problem (BASELINE config 1; P1,
   f64, direct solve) at n = 16, 32 and 64, its L2 error against the
   reference's pinned values (1e-6 relative);
9. flower_large: the flower at n = 1024 (2,097,152 triangles), assembled
   on the card and solved by the element-batched CutOperator's CG
   (Jacobi, then Chebyshev; rtol 1e-10), with the true relative residual
   from one apply, the L2 error, and the n = 512 direct solve's error
   for the convergence rate; then one profiled Jacobi CG pass (device
   idle share) and the apply (``_matfree_apply_sorted``) alone against
   its bytes bound;
10. interface: the two-domain interface problem (config 3) at n = 128 and
    256, block direct solve: both phases' errors, the jump, their rates,
    and no zero rows after deactivation;
11. moving_heat: the moving-domain heat equation (config 5) at n = 256,
    10 steps of re-cut, re-assembly and solve, each step's error below
    5e-3 and its time split.
The 2D phases print which stages ran on the host (classification, the
CSR matrices and the direct solves: host code by the reference's design).

``--profile`` adds one pass of the slice and one of the stack under
``torch.profiler`` (device busy and idle share, K1's device time, the top
device kernels). ``--parent-source CU`` builds an earlier
``interior_stencil.cu`` with the same flags and times it in turns with K1
at each shape (``parent_ms``). ``--compare-preconds`` runs every
preconditioner of ``solve_cg`` on the n = 48 step, cold and adopting (the
numbers behind its 'auto' rule; 'asm-fold2' is left out, it is the path of
'pallas'). ``--n72``, ``--n90`` and ``--n108`` run the stack, 'asm' and 'jacobi' at
n = 72 (3,048,625 dofs), n = 90 (5,929,741 dofs) and n = 108 (10,218,313
dofs), cold and adopting.
None is in the default run's time.

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
# the same for precond="asm-fold2": the operator and preconditioner of
# "pallas" with the interior apply as an einsum (PERF.md, same section)
JAX_CPU_ITERATIONS_N48_FOLD2 = 87
ITERATION_BAND = 0.05          # the port must land within +-5% of it
ITERATION_BAND_MIN = 3         # ... and no band is narrower than +-3
STAGES = ("fold", "asm", "coarse")

N_SLICE, N_SMALL = 48, 8
LARGE_SIZES = (72, 90, 108)         # --n72, --n90, --n108
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

# The 2D family (BASELINE configs 1, 3 and 5), all P1 in f64.
# tests/test_l2_parity.py's pinned L2 errors of the reference's flower
# problem, copied (not imported): the port is held to the same numbers.
FLOWER_PINNED = {16: 1.052731e-02, 32: 2.934306e-03, 64: 7.978235e-04}
PINNED_RTOL = 1e-6
N_FLOWER_LARGE, N_FLOWER_DIRECT = 1024, 512
FLOWER_CG_MAXITER = 50_000
FLOWER_TRUE_RESIDUAL = 1e-9
RATE_BAND = (1.7, 2.2)               # tests/test_l2_parity.py's
N_INTERFACE = (128, 256)
N_HEAT, HEAT_STEPS, HEAT_MAX_ERROR = 256, 10, 5e-3  # test_dg_and_moving


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


def pipeline(ct, mesh, phi, V, form_dtype, rtol=RTOL, precond="jacobi"):
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
                             precond=precond)
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


def profile_pass(ct, mesh, phi, V, precond="jacobi"):
    """One more pass of the step under torch.profiler: the device's busy
    time and idle share, K1's device time, launches and share, and the top
    device kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run = pipeline(ct, mesh, phi, V, torch.float32, precond=precond)
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
    top = sorted(items, key=lambda it: -it[1])[:10]
    _phase("profile", precond=precond, n=N_SLICE, iterations=run["its"],
           wall_ms=wall_ms, solve_ms=run["solve_s"] * 1e3,
           device_busy_ms=busy_ms, device_idle_share=1 - busy_ms / wall_ms,
           device_kernel_launches=sum(c for _, _, c in items),
           k1_device_ms=k1_ms, k1_launches=k1_count,
           k1_ms_per_launch=k1_ms / k1_count, k1_share_of_busy=k1_ms / busy_ms,
           top=[dict(name=key[:80], ms=ms, count=c) for key, ms, c in top])


def slice_phase(ct, dev, mesh, phi, V, host_setup_s, profile=False):
    """bench.py's step at n = 48 on the card with the Jacobi solve: warm-up
    + two timed passes (and, with ``profile``, one profiled pass after
    them). Returns the K1 launches of the three passes."""
    import torch
    from cutfemx_tpu_torch import interior_stencil as ist
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


def stack_small_phase(ct, dev):
    """The n = 8 step with the production stack on the card against the
    same step on CPU tensors (K1's plain version), in f64."""
    import torch
    runs = {}
    for d in ("cpu", dev):
        mesh, phi, V = setup(ct, N_SMALL, d, torch.float64)
        runs[str(d)] = pipeline(ct, mesh, phi, V, torch.float64, rtol=1e-9,
                                precond="pallas")
    c, g = runs["cpu"], runs[str(dev)]
    x_c = torch.where(c["op"].active, c["x"], 0.0)
    x_g = torch.where(g["op"].active.cpu(), g["x"].cpu(), 0.0)
    x_err = float((x_g - x_c).abs().max() / x_c.abs().max())
    if not (x_err < 1e-5 and abs(g["its"] - c["its"]) <= 2
            and torch.isfinite(g["x"]).all()):
        raise RuntimeError(f"stack, n={N_SMALL}: card and CPU disagree: x "
                           f"{x_err}, its {g['its']} vs {c['its']}")
    _phase("stack_small", n=N_SMALL, dofs=c["op"].dim, x_rel_err=x_err,
           its_cuda=g["its"], its_cpu=c["its"])


class count_applies:
    """Counts the operator applies made inside the block: every apply goes
    through exactly one of the gather element path (_grid_apply_body) and
    the folded one (_band_rest_apply)."""

    NAMES = ("_grid_apply_body", "_band_rest_apply")

    def __enter__(self):
        from cutfemx_tpu_torch import stencil as st
        self.n = 0
        self.saved = {name: getattr(st, name) for name in self.NAMES}
        for name, fn in self.saved.items():
            setattr(st, name, self._counting(fn))
        return self

    def _counting(self, fn):
        def counted(*args):
            self.n += 1
            return fn(*args)
        return counted

    def __exit__(self, *exc):
        from cutfemx_tpu_torch import stencil as st
        for name, fn in self.saved.items():
            setattr(st, name, fn)


def stack_pass(ct, dev, mesh, phi, V, name, n, precond="pallas"):
    """One pass of the step with ``precond`` (the production stack unless
    told otherwise): its numbers, checked for a finite solution at a true
    relative residual <= RTOL and for one K1 launch per operator apply."""
    import torch
    from cutfemx_tpu_torch import interior_stencil as ist
    torch.cuda.reset_peak_memory_stats(dev)
    before = ist.launches
    with count_applies() as applies:
        run = pipeline(ct, mesh, phi, V, torch.float32, precond=precond)
    launches = ist.launches - before
    x, op = run["x"], run["op"]
    rel = true_rel_residual(op, run["b"], x)
    if not (torch.isfinite(x).all() and x.shape == (V.dim,)):
        raise RuntimeError(f"{precond} {name}: non-finite or misshapen "
                           "solution")
    if not rel <= RTOL:
        raise RuntimeError(f"{precond} {name}: true relative residual "
                           f"{rel} > {RTOL}")
    # every f32 and f64 operator apply launches K1 once, whatever the
    # preconditioner: one per CG iteration, one per chunk start, one per
    # f64 measurement (the reported count holds all but the chunk starts)
    if not launches == applies.n > run["its"]:
        raise RuntimeError(f"{precond} {name}: {launches} K1 launches for "
                           f"{applies.n} operator applies and {run['its']} "
                           "iterations")
    log = op.build_log                  # stages this preconditioner needs
    build_s = sum(seconds for _, seconds in log.values())
    cg_s = run["solve_s"] - build_s
    nums = dict(
        precond=precond, n=n, dofs=V.dim, iterations=run["its"],
        true_rel_residual=rel, forms_s=run["forms_s"],
        operator_s=run["operator_s"], assembly_s=run["assembly_s"],
        solve_s=run["solve_s"], total_s=run["total_s"], build_s=build_s,
        cg_s=cg_s, ms_per_iteration=cg_s / run["its"] * 1e3,
        launches=launches, applies=applies.n,
        peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
        **{f"{s}_s": log[s][1] for s in STAGES if s in log},
        **{f"{s}_how": log[s][0] for s in STAGES if s in log})
    if precond == "pallas":
        nums["bytes_per_it"] = op.traffic_model()["bytes_per_it"]
    _phase("stack", **{"pass": name}, **nums)
    return dict(nums, op=op, b=run["b"])


def stage_times(op, b, its, launches):
    """Each torch stage of one 'pallas' iteration, and K1, run alone on the
    pass's own tensors (L2 warm, as inside the solve): the device time of
    its kernels and their number (torch.profiler), the host time to enqueue
    it, its calls per pass, the bytes it must move and that bound."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from cutfemx_tpu_torch import stencil as st
    from cutfemx_tpu_torch.interior_stencil import interior_stencil_apply
    n, N, nch, table, _ = op._grid_statics()
    tm = op.traffic_model()
    r = op.vec_to_grid(torch.where(op.active, b, 0.0))
    z = r * 0.5
    rz = torch.dot(r, z)

    def cg_update():   # the vector part of one la.cg_resume iteration
        alpha = rz / torch.dot(r, z)
        x = r + alpha * z
        r2 = r - alpha * z
        beta = torch.dot(r2, z) / rz
        return x, z + beta * r, torch.dot(r2, r2)

    applies = launches            # f32 and f64 applies, one K1 each
    stages = {
        "K1": (lambda: interior_stencil_apply(
            n, N, nch, table, op.A_local, op.cube_mask_t, r),
            applies, tm["stencil_bytes"]),
        "_band_rest_apply": (lambda: st._band_rest_apply(
            n, N, nch, table, op._bf_bbox, op._bf_diag, op._bf_fwd,
            op._bf_rev, r), applies, tm["band_bytes"] + 2 * tm["vec_bytes"]),
        "_asm_apply_body": (lambda: st._asm_apply_body(
            n, N, nch, table, op._asm_bbox, op._asm_binv, op.active_grid,
            r), its, tm["asm_bytes"] + 2 * tm["vec_bytes"]),
        "_coarse_apply_body": (lambda: st._coarse_apply_body(
            N, nch, op._c_sel, *op._c_W, op._c_acinv, op.active_grid, r),
            its, tm["coarse_bytes"] + 2 * tm["vec_bytes"]),
        "cg_update": (cg_update, its, tm["cg_vec_bytes"]),
    }
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    reps = 5
    for name, (fn, calls, nbytes) in stages.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_ms = (time.perf_counter() - t0) / reps * 1e3   # enqueue only
        torch.cuda.synchronize()
        # a stage of ~100 small launches is enqueued slower than it runs, so
        # events around it would time the host: sum its kernels' own times
        with profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0]
        seen = sum(e.count for e in kernels)
        if not seen > 0:
            raise RuntimeError(f"stage {name}: the profiler saw no device "
                               "time")
        # a profile can lose the records of its first kernels (K1 showed 3
        # of its 5 launches): the mean kernel time, times the kernels of a
        # call, does not depend on how many records came through
        per_call = -(-seen // reps)
        ms = sum(e.self_device_time_total for e in kernels) / 1e3 / seen \
            * per_call
        _phase("stage", stage=name, device_ms_per_call=ms,
               kernels_per_call=per_call, kernel_records=seen,
               host_enqueue_ms_per_call=host_ms, calls_per_pass=calls,
               device_ms_per_pass=ms * calls,
               host_enqueue_ms_per_pass=host_ms * calls, bytes=nbytes,
               bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)


def stack_tensors(op):
    return op._bf_diag, op._asm_binv, op._c_acinv


def f32_precision_check(op, tol=2e-6):
    """The stack's f32 apply and preconditioner against the same tensors
    widened to f64, on one seeded vector: a reduced-precision (TF32) matmul
    route would miss ``tol`` (relative to max|y|) by orders of magnitude."""
    import torch
    from cutfemx_tpu_torch import stencil as st

    def wide(v):
        if isinstance(v, torch.Tensor) and v.is_floating_point():
            return v.double()
        if isinstance(v, tuple):
            return tuple(wide(a) for a in v)
        return v

    args = (*op._grid_statics(), op._asm_bbox, op._bf_bbox, op._c_sel,
            op.A_local, op.cube_mask_t, op.active_grid, op.identity_grid,
            op._bf_diag, op._bf_fwd, op._bf_rev, op._asm_binv, *op._c_W,
            op._c_acinv)
    gen = torch.Generator(device=op.device).manual_seed(0)
    x = torch.randn(op.gsize, device=op.device, generator=gen)
    x = torch.where(op.grid_valid.reshape(-1), x, 0.0)
    errs = {}
    for name, f32, f64 in zip(("apply", "M"), st._pallas_ops(*args),
                              st._pallas_ops(*wide(args))):
        want = f64(x.double())
        errs[name] = float((f32(x).double() - want).abs().max()
                           / want.abs().max())
        if not errs[name] <= tol:
            raise RuntimeError(f"stack {name} in f32 is {errs[name]} from "
                               f"f64 (> {tol}): a reduced-precision matmul?")
    _phase("f32_precision", tol=tol, **{f"{k}_rel_err": v
                                        for k, v in errs.items()})


def stack_phase(ct, dev, mesh, phi, V, profile=False):
    """bench.py's step at n = 48 with precond="pallas" on a static level
    set: warm-up + two timed passes that adopt the cached builds, then one
    pass with the cache cleared. Returns the K1 launches of the first
    three passes."""
    import torch
    from cutfemx_tpu_torch import interior_stencil as ist
    from cutfemx_tpu_torch import stencil as st
    st._BUILD_CACHE.clear()
    ist.launches = 0
    passes = [stack_pass(ct, dev, mesh, phi, V, p, N_SLICE)
              for p in ("warmup", "timed1", "timed2")]
    main_path_launches = ist.launches
    t1, t2 = passes[1], passes[2]
    if t1["iterations"] != t2["iterations"]:
        raise RuntimeError(f"stack: timed passes took {t1['iterations']} "
                           f"and {t2['iterations']} iterations")
    band = max(ITERATION_BAND_MIN,
               ITERATION_BAND * JAX_CPU_ITERATIONS_N48_FOLD2)
    if abs(t1["iterations"] - JAX_CPU_ITERATIONS_N48_FOLD2) > band:
        raise RuntimeError(f"stack: {t1['iterations']} iterations, JAX-CPU "
                           f"asm-fold2 reference "
                           f"{JAX_CPU_ITERATIONS_N48_FOLD2} (+-{band:.1f})")
    for t in (t1, t2):
        how = [t[f"{s}_how"] for s in STAGES]
        if how != ["adopted"] * 3:
            raise RuntimeError(f"stack: a timed pass did not adopt every "
                               f"cached build: {dict(zip(STAGES, how))}")
    stage_times(t2["op"], t2["b"], t2["iterations"], t2["launches"])
    f32_precision_check(t2["op"])
    warm = stack_tensors(t2["op"])
    passes.clear()
    del t1, t2
    st._BUILD_CACHE.clear()
    cold = stack_pass(ct, dev, mesh, phi, V, "cold", N_SLICE)
    how = [cold[f"{s}_how"] for s in STAGES]
    if how != ["built"] * 3:
        raise RuntimeError(f"stack: the cold pass built {how}")
    # every scatter of the builds is a sorted sum: a second build of the
    # same cut gives the same bits
    for name, a, b in zip(("fold", "asm", "coarse"), warm,
                          stack_tensors(cold["op"])):
        if a is b or not torch.equal(a, b):
            raise RuntimeError(f"stack: two builds of the {name} tensors "
                               "differ (or the cold pass adopted)")
    del cold, warm
    if profile:
        profile_pass(ct, mesh, phi, V, precond="pallas")
    return main_path_launches


def compare_phase(ct, dev, mesh, phi, V, n, preconds):
    """Each preconditioner on the same step: a first pass from a cleared
    build cache, then one that adopts what it can (the evidence behind
    solve_cg's 'auto' rule)."""
    from cutfemx_tpu_torch import stencil as st
    for precond in preconds:
        st._BUILD_CACHE.clear()
        for name in ("compare_cold", "compare_adopting"):
            stack_pass(ct, dev, mesh, phi, V, name, n, precond)
    st._BUILD_CACHE.clear()


def large_phase(ct, dev, n):
    """A larger box (n = 108 is bench.py's large size, 10,218,313 dofs): the
    stack from a cleared build cache and adopting, then 'asm' and 'jacobi'
    beside it."""
    import torch
    t0 = time.perf_counter()
    mesh, phi, V = setup(ct, n, dev, torch.float32)
    _phase(f"n{n}_setup", host_setup_s=time.perf_counter() - t0, dofs=V.dim)
    compare_phase(ct, dev, mesh, phi, V, n,
                  ("pallas", "asm", "jacobi", "auto"))
    _phase(f"n{n}_done", seconds=time.perf_counter() - t0)


def _rate(coarse, fine, what):
    rate = float(np.log2(coarse / fine))
    if not RATE_BAND[0] < rate < RATE_BAND[1]:
        raise RuntimeError(f"{what}: rate {rate} outside {RATE_BAND}")
    return rate


def flower_parity_phase(dev, card):
    """The flower problem, direct solve, against the reference's pinned
    L2 errors."""
    from cutfemx_tpu_torch.demos import demo_poisson
    for n, pinned in FLOWER_PINNED.items():
        out = demo_poisson.run(n, device=dev)
        rel = abs(out["l2_error"] - pinned) / pinned
        if not rel < PINNED_RTOL:
            raise RuntimeError(f"flower n={n}: L2 error {out['l2_error']} "
                               f"vs pinned {pinned} ({rel} relative)")
        _phase("flower_parity", **out, pinned=pinned, rel_to_pinned=rel,
               card=card)


def _matfree_bytes(op, x):
    """Bytes one apply must move: every input read once (element matrices,
    column maps, the scatter plan, x and the active mask), y written
    once."""
    tensors = [*op._mats, *op._cols, op._perm, op._lengths, op.active, x]
    return sum(t.numel() * t.element_size() for t in tensors) \
        + x.numel() * x.element_size()


def matfree_profile(P, card):
    """One Jacobi CG pass under torch.profiler (the device's busy time and
    idle share), then the apply alone: its device time and kernels per
    call, the host's enqueue time, and its bytes bound."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from cutfemx_tpu_torch import fem
    from cutfemx_tpu_torch.demos import demo_poisson
    op = P["op"]
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        _, its, _ = op.solve_cg(P["b"], rtol=demo_poisson.CG_RTOL,
                                maxiter=FLOWER_CG_MAXITER, precond="jacobi")
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA) / 1e3
    if not busy_ms > 0:
        raise RuntimeError("the profiler saw no device time in the CG pass")
    _phase("matfree_profile", n=P["n"], precond="jacobi", iterations=its,
           wall_ms=wall_ms, device_busy_ms=busy_ms,
           device_idle_share=1 - busy_ms / wall_ms, card=card)

    x = torch.where(op.active, P["b"], 0.0)

    def apply():
        return fem._matfree_apply_sorted(op._mats, op._cols, op._perm,
                                         op._lengths, op.active, x)
    reps = 20
    apply()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        apply()
    host_ms = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        for _ in range(reps):
            apply()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    seen = sum(e.count for e in kernels)
    if not seen > 0:
        raise RuntimeError("the profiler saw no device time in the apply")
    per_call = -(-seen // reps)
    ms = sum(e.self_device_time_total for e in kernels) / 1e3 / seen \
        * per_call
    nbytes = _matfree_bytes(op, x)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    _phase("stage", stage="_matfree_apply_sorted", n=P["n"],
           device_ms_per_call=ms, kernels_per_call=per_call,
           kernel_records=seen, host_enqueue_ms_per_call=host_ms,
           calls_per_pass=its + 1, device_ms_per_pass=ms * (its + 1),
           bytes=nbytes, bound_ms=bound_ms, share=bound_ms / ms,
           top=[dict(name=e.key[:60], ms=e.self_device_time_total / 1e3
                     / reps, count=e.count // reps)
                for e in sorted(kernels,
                                key=lambda e: -e.self_device_time_total)],
           card=card)


def flower_large_phase(dev, card):
    """The flower at n = 1024 on the card: CutOperator CG with Jacobi and
    Chebyshev, the true residual and the L2 error; the n = 512 direct
    solve for the rate; then the profile of one CG pass."""
    import torch
    from cutfemx_tpu_torch.demos import demo_poisson
    P = demo_poisson.problem(N_FLOWER_LARGE, device=dev)
    demo_poisson.operator(P)
    _phase("flower_large_setup", n=N_FLOWER_LARGE, **P["counts"],
           **P["times"], card=card)
    errs = {}
    for precond in ("jacobi", "chebyshev"):
        x, info = demo_poisson.solve(P, "cg", precond=precond,
                                     maxiter=FLOWER_CG_MAXITER)
        if not (torch.isfinite(x).all() and x.shape == (P["V"].dim,)
                and x.device.type == torch.device(dev).type):
            raise RuntimeError(f"flower {precond}: non-finite, misshapen or "
                               "off-card solution")
        if not info["iterations"] < FLOWER_CG_MAXITER:
            raise RuntimeError(f"flower {precond}: no convergence in "
                               f"{FLOWER_CG_MAXITER} iterations")
        if not info["true_rel_residual"] <= FLOWER_TRUE_RESIDUAL:
            raise RuntimeError(f"flower {precond}: true relative residual "
                               f"{info['true_rel_residual']}")
        errs[precond] = demo_poisson.l2_error(P, x)
        _phase("flower_large", n=N_FLOWER_LARGE, precond=precond,
               l2_error=errs[precond], **info, card=card)
    direct = demo_poisson.run(N_FLOWER_DIRECT, device=dev)
    rates = {p: _rate(direct["l2_error"], e, f"flower {p}")
             for p, e in errs.items()}
    _phase("flower_rate", n_coarse=N_FLOWER_DIRECT, n_fine=N_FLOWER_LARGE,
           coarse=direct, rates=rates, card=card)
    matfree_profile(P, card)


def interface_phase(dev, card):
    from cutfemx_tpu_torch.demos import demo_interface_poisson
    outs = []
    for n in N_INTERFACE:
        out = demo_interface_poisson.run(n, device=dev)
        if any(out["zero_rows"]):
            raise RuntimeError(f"interface n={n}: zero rows "
                               f"{out['zero_rows']}")
        if not all(np.isfinite([out["err1"], out["err2"], out["jump"]])):
            raise RuntimeError(f"interface n={n}: non-finite errors")
        outs.append(out)
    c, f = outs
    rates = dict(err1=_rate(c["err1"], f["err1"], "interface err1"),
                 err2=_rate(c["err2"], f["err2"], "interface err2"),
                 jump=float(np.log2(c["jump"] / f["jump"])))
    for out in outs:
        _phase("interface", **out, card=card)
    _phase("interface_rate", n_coarse=N_INTERFACE[0],
           n_fine=N_INTERFACE[1], rates=rates, card=card)


def moving_heat_phase(dev, card):
    from cutfemx_tpu_torch.demos import demo_moving_heat
    out = demo_moving_heat.run(N_HEAT, HEAT_STEPS, device=dev)
    errors = out["errors"]
    if not (len(errors) == HEAT_STEPS and np.all(np.isfinite(errors))
            and max(errors) < HEAT_MAX_ERROR):
        raise RuntimeError(f"moving heat: errors {errors}")
    for step in out["split"]:
        _phase("moving_heat", n=N_HEAT, dofs=out["dofs"], **step,
               host_stages=["classify", "assemble_matrix CSR",
                            "deactivate_outside", "direct_solve"],
               card=card)
    _phase("moving_heat_done", n=N_HEAT, steps=HEAT_STEPS,
           max_error=max(errors), total_s=sum(s["total_s"]
                                              for s in out["split"]),
           card=card)


def main():
    import argparse
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent-source", metavar="CU",
                    help="also time the kernel built from this source (an "
                         "earlier interior_stencil.cu), in turns with K1")
    ap.add_argument("--profile", action="store_true",
                    help="profile one more pass of the slice and of the "
                         "stack")
    ap.add_argument("--compare-preconds", action="store_true",
                    help="also run every preconditioner on the n = 48 step")
    for n in LARGE_SIZES:
        ap.add_argument(f"--n{n}", action="store_true",
                        help=f"also run the stack, 'asm' and 'jacobi' at "
                             f"n = {n}")
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
    # bench.py runs with JAX's default f32: f32 level set and quadrature
    mesh, phi, V = setup(ct, N_SLICE, dev, torch.float32)
    host_setup_s = time.perf_counter() - t0
    jacobi_launches = slice_phase(ct, dev, mesh, phi, V, host_setup_s,
                                  args.profile)
    _phase("slice_done", seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    stack_small_phase(ct, dev)
    launches = stack_phase(ct, dev, mesh, phi, V, args.profile)
    _phase("stack_done", seconds=time.perf_counter() - t0,
           total_seconds=time.perf_counter() - t_all)
    for path, count in (("jacobi", jacobi_launches), ("pallas", launches)):
        if count <= 0:
            raise RuntimeError(f"the {path} path launched no K1 kernel")
    if args.compare_preconds:
        t0 = time.perf_counter()
        compare_phase(ct, dev, mesh, phi, V, N_SLICE, (
            "jacobi", "asm", "asm2", "asm-fold", "pallas", "auto"))
        _phase("compare_done", seconds=time.perf_counter() - t0)
    del mesh, phi, V
    for n in LARGE_SIZES:
        if getattr(args, f"n{n}"):
            large_phase(ct, dev, n)

    # the 2D family: no K1 on this path (the element-batched CutOperator)
    t0 = time.perf_counter()
    before = ist.launches
    flower_parity_phase(dev, smi)
    flower_large_phase(dev, smi)
    interface_phase(dev, smi)
    moving_heat_phase(dev, smi)
    _phase("2d_done", seconds=time.perf_counter() - t0,
           k1_launches=ist.launches - before,
           total_seconds=time.perf_counter() - t_all)

    # the main path's shape: the slice's grid and mask in f32, the CG's type
    main_row = next(r for r in k if r["shape"] == "n48_bench"
                    and r["dtype"] == "float32")
    print(json.dumps({"kernels": [{
        "name": "interior_stencil", "route": "cuda",
        "source": "cutfemx_tpu_torch/csrc/interior_stencil.cu",
        "replaces": "cutfemx_tpu/pallas_stencil.py:71",
        "launches": launches,
        "launches_by_path": {"jacobi": jacobi_launches, "pallas": launches},
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
