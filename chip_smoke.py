#!/usr/bin/env python3
"""Drive cutfemx_tpu_torch's main path once on one CUDA card.

    python3 chip_smoke.py [--profile] [--parent-source CU]
                          [--compare-preconds] [--n72] [--n90] [--n108]

Phases, each printing one line of numbers:

1. device: the card's name, and ``nvidia-smi``'s name and power limit;
2. build: compiles the hand-written kernels from ``cutfemx_tpu_torch/csrc``
   and the host geometry library (g++);
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
   mg_parity: tests/test_mg.py on the card (f64): the P1 transfer
   interpolates exactly, and mg_solve_cg on its P1 and P2 cut Poisson
   (n = 32) and vector elasticity (n = 24) problems gives the JAX-CPU
   iteration counts and solution; mg_bench: bench.py's mg leg
   (CUTFEMX_BENCH_SOLVER=mg) on the same n = 48 problem: f32 forms, host
   CSR, deactivation, the multigrid hierarchy (P2 -> P1 at n = 48, 24, 12)
   and V-cycle-preconditioned CG at rtol 1e-6, nu = 2: a warm-up through
   mg_solve_cg and two timed passes that repeat its iterations and
   solution bitwise, each at a true relative residual <= 1e-6 and within
   +-5% (at least +-3) of the JAX-CPU count, no K1 launch; the time split
   (forms, matrix, deactivation, hierarchy by stage, CG), one V-cycle and
   one fine CSR apply as stage lines, a profiled CG pass;

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
    5e-3 and its time split;
12. stokes_parity: cut Stokes (config 4; P1-P1, f64, the manufactured
    problem of tests/test_stokes.py, block path, direct solve) at n = 16
    and 32, its velocity and pressure errors against the JAX-CPU
    reference's (1e-6 relative), the velocity rate > 1.5, and the
    monolithic MixedCutForm matrix at n = 16 equal to the block
    composition (max difference 0.0);
13. stokes_large: the same at n = 128 and 256 (198,147 dofs): errors,
    rate, time split, the assembly's device-busy share under
    torch.profiler and peak device memory;
14. stokes_cylinder: the flow around a cylinder of demos/demo_stokes.py
    (strong inflow and walls by dirichletbc + apply_lifting) at n = 24
    against the JAX-CPU reference's flux in/out, |u| on the cylinder and
    max |u| (1e-6 relative), then at n = 64 with its time split;
15. newton: both problems of tests/test_nonlinear.py by newton_solve (the
    reference's iteration counts, |F| under its tolerance), and
    la.bicgstab with Jacobi on the flower's n = 256 element-batched
    CutOperator (true relative residual <= 1e-9);
16. distance_parity: the geometry path (f64) against the JAX-CPU values
    (1e-10 absolute, equal FIM sweeps and negative counts): the sphere STL
    of demo_stl_distance (1,728 triangles) on the n = 16 box by from_stl
    in the three sign modes, the 2D point source of tests/test_distance.py
    (n = 40) and demo_reinit (n = 48);
17. distance_large: the n = 96 box (912,673 vertices, 5,308,416 tets,
    21.2 M FIM update entries) and a 27,648-triangle sphere: from_stl's
    stages (read + distribute, cell-triangle map, near field, FIM, sign)
    in each sign mode, reinitialize of |x|^2 - 1/4, one profiled FIM
    solve, the FIM sweep and the clustered winding sum as stage rows
    against their bounds, peak device memory; the gates of
    tests/test_distance.py;
18. extension: extend_normal_velocity off a circle at n = 512 (constant
    and varying speed, tests/test_distance.py's gates) and into P2 at
    n = 128;
19. shape_opt: demo_compliance_optimization at its defaults (n = 32, 10
    iterations) from the reference's initial design against the JAX-CPU
    history (iteration 0 within 1e-10 relative, all within 1e-6), the
    same run from the port's own design beside it, then n = 128 timed by
    stage and a profiled 2-iteration run (device-busy share);
20. demos_12a: the five demos of ROADMAP item 12a (the cut perimeter and
    area in 2D and 3D, entity selectors, SIPG DG Poisson, cut elasticity,
    moving Poisson) at their scripts' default sizes and one larger size,
    against the JAX-CPU numbers (counts exactly, perimeter and area within
    1e-10, L2 errors within 1e-6 relative);
21. unfitted_demos: the extension-penalty study (n = 24, four betas) and
    the surface DG Poisson (n = 16, 32) against the JAX-CPU numbers
    (counts exactly, L2 errors and cond(active) within 1e-6 relative) and
    tests/test_surface.py's gate (error(32) < 2e-2, rate > 1.3);
22. unfitted_large: the study's extension-penalty Poisson (beta = 1) at
    n = 128, 256, 512 and the surface DG at n = 256, 512 (true relative
    residuals <= 1e-9, the time split, peak device memory); bench.py's
    n = 48 box cut on the skeleton of its cut cells (facet-hosted rules
    against the facets' areas, the facet cut mesh, the aggregation, the
    penalty matrix's symmetry and constants); compound and union rules of
    two planes at n = 1024 against the polygon areas; the n = 8, 16 and
    128 sizes against the JAX-CPU numbers;
23. curved_bench: bench.py's n = 48 step with the sphere as a P2 level set
    cut at cut_approximation_order=2 (the curved path: polished crossings,
    isoparametric P2 parts) through solve_cg(precond="pallas"): a warm-up
    and a timed pass, K1 once per operator apply, a true relative residual
    <= 1e-6 and the JAX-CPU iteration count exactly; the cut cells, rule
    points and stage seconds; then the default 'auto' cut of the same
    level set (two red-refinement levels) through rules and forms: its
    points and peak memory;
24. curved_parity and saye_parity: the curved and red-refined volume and
    area of the P2 sphere on n = 8 tets, Saye's (backend="algoim") area
    and perimeter of a circle on n = 16 quads (Q1 and Q2) and volume and
    area of the Q2 sphere on n = 8 hexahedra, and the L2 error of a small
    direct Poisson solve on each path, against the JAX-CPU numbers (1e-10
    relative);
25. saye_large: bench.py's Nitsche + ghost-penalty Poisson on n = 24 and
    48 hexahedra (117,649 Q1 dofs) with the Q2 sphere on Saye's rules,
    solved by fem.CutOperator.solve_cg with Jacobi in f64: the box
    grouping's host seconds and what it decided, the rules', forms' and
    solve's seconds, the true residual, the L2 errors and their rate
    (>= 1.8);
26. surface_io: bench.py's n = 48 host setup built, saved with
    io.save_setup_cache and loaded back onto the card with
    io.load_setup_cache, then the "pallas" step on the built and on the
    loaded objects (each from a cleared build cache): the loaded step must
    take 87 iterations (JAX-CPU's), reach a true relative residual
    <= 1e-6, launch K1 once per operator apply and give the built step's
    solution bitwise (setup seconds built and loaded, the cache's bytes,
    the step by stage); on its rules the compact views (total_points, a
    lazy physical_points) and StencilCutOperator with a numpy b (equal to
    the tensor call bitwise); tests/test_complex_assembly.py's Helmholtz
    form at n = 64 against its real and imaginary parts (1e-13) and a
    complex coefficient on runtime against standard rules (1e-12), a
    complex la.cg on a Hermitian positive-definite system against SciPy's
    spsolve (1e-9); tests/test_vertex_ridge.py's nine cases against their
    exact values (1e-12); petsc's assembly and deactivate_outside equal
    fem's on the n = 64 flower; every part inside a profiling.Timer span,
    all of them in profiling.timings(). No K1 outside the steps.
The 2D phases print which stages ran on the host (classification, the
CSR matrices, the boundary conditions and the direct solves: host code by
the reference's design). K1 must show 0 launches on the mg, geometry,
demo, unfitted, Saye and parity paths, and launch on the curved step.

``--profile`` adds one pass of the slice and one of the stack under
``torch.profiler`` (device busy and idle share, K1's device time, the top
device kernels). ``--parent-source CU`` builds an earlier
``interior_stencil.cu`` with the same flags and times it in turns with K1
at each shape (``parent_ms``). ``--compare-preconds`` runs every
preconditioner of ``solve_cg`` on the n = 48 step, cold and adopting (the
numbers behind its 'auto' rule; 'asm-fold2' is left out, it is the path of
'pallas'). ``--n72``, ``--n90`` and ``--n108`` run the stack, 'asm' and 'jacobi' at
n = 72 (3,048,625 dofs), n = 90 (5,929,741 dofs) and n = 108 (10,218,313
dofs), cold and adopting, and the curved step, its 'auto' cut and the
setup-cache step (105 iterations) at n = 108 too.
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

# Cut Stokes (config 4): the JAX reference's (cutfemx_tpu, x64, on a CPU)
# velocity and pressure L2 errors of tests/test_stokes.py's
# solve_cut_stokes(n), and the values demos/demo_stokes.py prints at its
# default n = 24 (tests/test_torch_stokes.py's reference_cylinder); PERF.md
# section 4 gives the command.
JAX_CPU_STOKES = {16: (0.08469802552587766, 2.1958897399669555),
                  32: (0.01848262488331663, 1.0549549937272797)}
JAX_CPU_CYLINDER_N24 = dict(flux_in=1.3310185185185184,
                            flux_out=1.3314260593338907,
                            u_gamma=0.013384367014708094,
                            max_u=1.3982055045620267)
STOKES_RATE_MIN = 1.5                 # tests/test_stokes.py's
N_STOKES_LARGE = (128, 256)
N_CYLINDER = 64
CYLINDER_MASS_DEFECT = 1e-2
# tests/test_nonlinear.py's problems: (n, the reference's Newton
# iterations, its tolerance on the final |F|); the counts are cutfemx_tpu's
# on a CPU (tests/test_torch_newton.py's newton_problem, PERF.md section 4)
JAX_CPU_NEWTON = {"fitted": (12, 4, 1e-12), "disk": (24, 4, 1e-11)}
N_BICGSTAB, BICGSTAB_MAXITER = 256, 20_000


# The geometry path (distance/, refine.py, optimization.py and their demos),
# all f64. The JAX reference's (cutfemx_tpu, x64, on a CPU) numbers come
# from tests/test_torch_distance.py's reference_distance_parity and
# tests/test_torch_optimization.py's reference_compliance (PERF.md section
# 4 gives the command); a field is held by its value_summary: the sum, sum
# of squares, min, max, nine samples at evenly spaced indices and the
# count of negative values.
DISTANCE_MODES = ("component_anchor", "local_normal_band", "winding_number")
DISTANCE_ABS_TOL = 1e-10
N_SPHERE_PARITY, N_POINT_SOURCE, N_REINIT_DEMO = 16, 40, 48
JAX_CPU_DISTANCE = {
    "sphere": {
        "component_anchor":
            dict(sweeps=15, n_values=4913, sum=2652.4129781764177,
                 sumsq=1883.3652346073868, min=-0.4318140962942925,
                 max=1.2882900986919439, negative=251,
                 samples=[1.2320508165429929, 0.7990381146507737,
                          0.3660254127585544, -0.066757486825208,
                          -0.4318140962942925, -0.06690535076799398,
                          0.3660254127585544, 0.7990381146507737,
                          1.2320508165429929]),
        "local_normal_band":
            dict(sweeps=15, n_values=4913, sum=2652.4129781764177,
                 sumsq=1883.3652346073868, min=-0.4318140962942925,
                 max=1.2882900986919439, negative=251,
                 samples=[1.2320508165429929, 0.7990381146507737,
                          0.3660254127585544, -0.066757486825208,
                          -0.4318140962942925, -0.06690535076799398,
                          0.3660254127585544, 0.7990381146507737,
                          1.2320508165429929]),
        "winding_number":
            dict(sweeps=15, n_values=4913, sum=2652.4129781764177,
                 sumsq=1883.3652346073868, min=-0.4318140962942925,
                 max=1.2882900986919439, negative=251,
                 samples=[1.2320508165429929, 0.7990381146507737,
                          0.3660254127585544, -0.066757486825208,
                          -0.4318140962942925, -0.06690535076799398,
                          0.3660254127585544, 0.7990381146507737,
                          1.2320508165429929]),
    },
    "point_source":
        dict(sweeps=39, n_values=1681, sum=1338.262741615797,
             sumsq=1212.6391639906287, min=0.0, max=1.452144977259558,
             negative=0,
             samples=[1.414213562373095, 1.0606601717798212,
                      0.7071067811865476, 0.3535533905932738, 0.0,
                      0.3535533905932738, 0.7071067811865476,
                      1.0606601717798214, 1.4142135623730954]),
    "reinit":
        dict(n_values=2401, sum=683.4253218018441, sumsq=398.88737551689906,
             min=-0.47170262767661764, max=0.9295811352156887, negative=437,
             samples=[0.9150793638884732, 0.5615259732951995,
                      0.2079725827019257, -0.14555216467747845,
                      -0.47170262767661764, -0.14555216467747845,
                      0.2079725827019257, 0.5615259732951995,
                      0.9150793638884731]),
}
N_DISTANCE_LARGE, SPHERE_LARGE_PER_FACE = 96, 48   # 27,648 triangles
FAR_BAND, LARGE_MAX_ERROR, REINIT_BAND, REINIT_BAND_ERROR = \
    0.15, 0.12, 0.1, 0.01           # tests/test_distance.py:74-104
N_EXTENSION, N_EXTENSION_P2 = 512, 128
N_SHAPE_OPT, SHAPE_OPT_ITERS = 32, 10
N_SHAPE_OPT_LARGE, SHAPE_OPT_LARGE_ITERS = 128, 10
SHAPE_OPT_RTOL_FIRST, SHAPE_OPT_RTOL = 1e-10, 1e-6
# the reference's initial design of the n = 32 run (its reinitialized
# level set and ALM scale), written by reference_compliance
COMPLIANCE_INITIAL = os.path.join("tests", "data",
                                  "compliance_n32_initial.npz")
JAX_CPU_COMPLIANCE_N32 = [  # compliance, volume, Lagrangian, dt
    [0.018220607825567094, 1.6663829240997472,
     0.03556615414736857, 0.007572772508225546],
    [0.01957679228131357, 1.6095866908598753,
     0.02186142413756617, 0.006687557346389277],
    [0.01982917223073797, 1.5999672731450838,
     0.019821322090299333, 0.006687557346389277],
    [0.020238483446611957, 1.583483693755563,
     0.016843940781475848, 0.013375114692778554],
    [0.020252260072340482, 1.5825376622730665,
     0.0171228694287463, 0.013375114692778554],
    [0.01972147701051675, 1.5999189840576464,
     0.019708036743662737, 0.013375114692778554],
    [0.0197213109651489, 1.5998489423370825,
     0.019696296312583156, 0.013375114692778554],
    [0.019717332669653247, 1.59939671773804,
     0.019618275973764886, 0.013375114692778554],
    [0.01967722570608345, 1.600000940923785,
     0.01967737870723023, 0.013375114692778554],
    [0.019668912214151547, 1.5993932068606092,
     0.019571270313532223, 0.013375114692778554],
]
F64_FLOPS_PER_S = 34e12             # H100 SXM published FP64 (non-tensor)

# Geometric multigrid (mg.py; bench.py's CUTFEMX_BENCH_SOLVER=mg). The
# problems of tests/test_mg.py at its sizes, with its rtol and maxiter,
# and the JAX reference's (cutfemx_tpu, x64, on a CPU) iteration counts
# and solution summaries (tests/test_torch_mg.py's reference_mg_parity;
# PERF.md section 4 gives the command). bench.py's mg leg at n = 48: the
# JAX-CPU count with x64 off, as bench.py runs it.
MG_PARITY = {"p1": (32, 1e-10, 200), "p2": (32, 1e-8, 400),
             "vector": (24, 1e-8, 200)}
MG_TRANSFER_TOL = 1e-12
MG_X_RTOL = 1e-8
MG_NU = 2
JAX_CPU_MG_ITERATIONS_N48 = 75
JAX_CPU_MG = {
    "p1": dict(iterations=10, x=dict(
        n_values=1089, sum=10.746794089246988,
        sumsq=96.05182608252133, min=-0.9676795327113978,
        max=1.0120572590982864, negative=536,
        samples=[
            9.721099172071973e-16,
            -2.931239980235241e-14,
            -1.101167709344029e-11,
            0.5003889923540125,
            0.002204020673992307,
            0.5003888484320829,
            -1.100989518320108e-11,
            -2.9308339115474866e-14,
            9.71884294392846e-16,
        ])),
    "p2": dict(iterations=40, x=dict(
        n_values=4225, sum=30.19258252863929,
        sumsq=344.29026299576594, min=-0.9618963859843861,
        max=0.9841438438764402, negative=2073,
        samples=[
            -1.369455319816126e-11,
            9.65069784889237e-12,
            -4.29309528818631e-14,
            0.019126819239811608,
            2.421085554295048e-12,
            0.009615081813591492,
            2.392755044788519e-12,
            1.1132519530300747e-11,
            -1.366622268717251e-11,
        ])),
    "vector": dict(iterations=12, x=dict(
        n_values=1250, sum=-3.0763395533023394,
        sumsq=0.09782031380028938, min=-0.041870967844499216,
        max=0.014226227991192851, negative=697,
        samples=[
            5.942213998904037e-16,
            -4.756684065027054e-14,
            9.386773193346674e-05,
            -6.368977619118787e-05,
            6.847405121432961e-06,
            -6.368977619120837e-05,
            9.386773193347688e-05,
            -4.7566840650273544e-14,
            1.5794965155264362e-15,
        ])),
}
# The demos of ROADMAP item 12a: the reference scripts' numbers (x64, on a
# CPU; tests/test_torch_demos.py's reference_demos_12a, PERF.md section 4)
DEMO_GEOM_TOL = 1e-10
JAX_CPU_DEMOS = {
    "perimeter_2d_32": dict(perimeter=2.699081123541433,
        area=0.5788745431349056, inside_cells=246, cut_cells=90),
    "perimeter_3d_32": dict(perimeter=2.3109424897658197,
        area=0.3295373064231639, inside_cells=6252, cut_cells=3972),
    "perimeter_2d_512": dict(perimeter=2.701759230542459,
        area=0.580872547198562, inside_cells=75402, cut_cells=1506),
    "locate_24": dict(cells={
        "circle<0": 272, "circle=0": 102, "band<0": 192,
        "circle<0 and band<0": 106, "circle=0 or band=0": 274,
        "circle<=0 and band>0": 138}, boundary_facets_cut=0),
    "locate_256": dict(cells={
        "circle<0": 36504, "circle=0": 1046, "band<0": 31744,
        "circle<0 and band<0": 18372, "circle=0 or band=0": 3074,
        "circle<=0 and band>0": 17780}, boundary_facets_cut=0),
    "dg_32": dict(dofs=6144, l2_error=0.000899973976956423),
    "dg_128": dict(dofs=98304, l2_error=5.754689115358866e-05),
    "elasticity_32": dict(active_cells=406, l2_error=0.002613623695632938),
    "elasticity_256": dict(active_cells=22188, l2_error=4.121040337105886e-05),
    "moving_32": dict(cut_cells=[79, 78, 76, 76, 76, 76, 78, 79],
        l2_errors=[0.002899271884870814, 0.0027969071544687407,
        0.002602399143231648, 0.0023709475362793473, 0.0023714053759645985,
        0.0026036046117997335, 0.002797124867030176, 0.0028993258148858384]),
    "moving_128": dict(cut_cells=[309, 306, 306, 308, 308, 306, 306, 309],
        l2_errors=[0.00016591786675810994, 0.00015457051445770339,
        0.00014162038853573634, 0.00013278148136509473, 0.00013279025473758702,
        0.00014162430717667174, 0.00015457571304299534,
        0.00016592449826442082]),
}

# The unfitted-boundary surface (ROADMAP item 10 steps 1-4, item 12's two
# demos): sizes, gates and the JAX-CPU numbers (x64, on a CPU;
# tests/test_torch_unfitted_demos.py's reference_unfitted, PERF.md section
# 4). Rule sums of the pins hold to PIN_SUM_RTOL relative, counts exactly.
N_STUDY_LARGE = (128, 256, 512)      # 263,169 P1 dofs at 512
N_SURFACE_LARGE = (256, 512)
N_FACET_3D = 48                      # bench.py's box: 663,552 tets
N_COMPOUND = 1024
SURFACE_ERROR_MAX = 2e-2             # tests/test_surface.py's gate at 32
SURFACE_RATE_MIN = 1.3               # ... and its rate from 16
FACET_AREA_RTOL = 1e-12              # both volume parts = the facets
CUT_MESH_AREA_RTOL = 1e-10           # cut mesh = 'phi<0' rules + facets
POLYGON_RTOL = 1e-12                 # compound rules + cells = shoelace
PENALTY_SYM_RTOL = 1e-14             # |M - M^T| / max|M|
PENALTY_CONST_RTOL = 1e-12           # |M 1| / max|M|
PIN_SUM_RTOL = 1e-10
JAX_CPU_UNFITTED = {
    "study_24": dict(ill_posed=44, roots=188, l2_errors=[
        0.004140810291294253, 0.004140987708989939, 0.004142571484600244,
        0.004157367193379282], conds=[906.1414159828223, 902.0731189582592,
        867.2606735130139, 628.9871719772412]),
    "study_128": dict(ill_posed=224, roots=5444,
                      l2_errors=[0.00014965322967721412]),
    "surface_16": dict(cut_cells=62, skeleton_facets=62,
                       l2_error=0.01159487161818983),
    "surface_32": dict(cut_cells=134, skeleton_facets=134,
                       l2_error=0.0028612868297608093),
    "facet_3d_8": dict(
        cells=3072, cut_cells=276, skeleton_facets=456, cut_facets=456,
        inside_facets=0, lo_sum=5.974025212902088, hi_sum=11.61557163373099,
        interface_sum=55.98042549839046, cut_facet_area=17.589596846633082,
        cut_mesh_cells=612, cut_mesh_area=5.974025212902088,
        interior_cells=48, well_posed=120, ill_posed=204, rootless=0,
        max_depth=12, penalty_nnz=1680, penalty_max=0.27578125),
    "compound_16": dict(
        and_rules=0.15393423913043464, and_parents=47, and_cells=143,
        and_total=1.2711217391304348, and_polygon=1.2711217391304346,
        or_rules=0.11200326086956522, or_parents=39, or_cells=422,
        or_total=3.4088782608695656, or_polygon=3.408878260869565),
}

# Higher-order cut geometry (ROADMAP item 10): bench.py's step with a P2
# level set on the curved path, Saye's rules on hexahedra, and the JAX-CPU
# numbers of both at small n (x64, on a CPU: tests/test_torch_curved_cut.py's
# reference_curved and tests/test_torch_saye.py's reference_saye; PERF.md
# section 4), held to HIGHER_ORDER_RTOL relative.
# CG iterations of the JAX reference for the n = 48 step with the P2 sphere
# cut at cut_approximation_order=2, x64 off, "asm-fold2" (PERF.md section 4)
JAX_CPU_ITERATIONS_N48_CURVED = 86
CURVED_CUT = {"cut_approximation_order": 2}
N_CURVED_PARITY = 8
CIRCLE_RADIUS = 0.55                 # tests/test_saye.py's circle
N_SAYE_QUAD, N_SAYE_HEX = 16, 8
N_SAYE_LARGE = (24, 48)              # 117,649 Q1 dofs at 48
SAYE_ORDER = 4
SAYE_CG_RTOL = 1e-10
SAYE_RATE_MIN = 1.8
HIGHER_ORDER_RTOL = 1e-10
JAX_CPU_CURVED = {
    "curved_volume": 0.40656659709193704, "curved_area": 2.6150436354425604,
    "auto_volume": 0.4036941877451372, "auto_area": 2.6503806221976443,
    "poisson_l2_error": 0.0038863412696948266, "poisson_dofs": 4913,
    "poisson_cut_cells": 276}
JAX_CPU_SAYE = {
    "quad_q1_volume": 0.9421724646264453, "quad_q1_area": 3.4457008177724253,
    "quad_q2_volume": 0.9503349002423807, "quad_q2_area": 3.455759200618874,
    "hex_q2_volume": 0.4075315452288836, "hex_q2_area": 2.659325059500886,
    "poisson_l2_error": 0.005115690296689805, "poisson_dofs": 729,
    "poisson_cut_cells": 56}

# The rest of the single-card surface (io's setup cache, the compact rule
# views, numpy vectors into StencilCutOperator, complex forms, vertex and
# ridge measures, petsc and profiling). The setup-cache step must take the
# reference's "asm-fold2" count exactly: JAX-CPU's 87 at n = 48 (above),
# and at n = 108 the reference's own bench row (BENCH_r05.json, 105
# iterations), which the port's n = 108 stack passes have also taken.
SETUP_CACHE_ITERATIONS = {N_SLICE: JAX_CPU_ITERATIONS_N48_FOLD2, 108: 105}
N_HELMHOLTZ, N_COMPLEX_RUNTIME, N_HERMITIAN = 64, 32, 64
COMPLEX_SPLIT_TOL = 1e-13       # tests/test_complex_assembly.py's
COMPLEX_RUNTIME_TOL = 1e-12
HERMITIAN_CG_RTOL, HERMITIAN_X_RTOL = 1e-12, 1e-9
VERTEX_RIDGE_TOL = 1e-12
N_PETSC_FLOWER = 64


def _phase(phase, **numbers):
    print(json.dumps({"phase": phase, **numbers}), flush=True)


def _syncer(phi):
    """A function that drains the level set's device queue (a no-op off
    the card), so that host clocks time whole stages."""
    if getattr(phi.x, "is_cuda", False):
        import torch
        return torch.cuda.synchronize
    return lambda: None


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


def setup(ct, n, device, phi_dtype, phi_degree=1):
    """Host setup of bench.py: mesh, level set (the sphere in degree
    ``phi_degree``), spaces and topology."""
    mesh, phi = ho_mesh_phi(ct, n, "tetrahedron", phi_degree, _sphere(RADIUS),
                            device=device, phi_dtype=phi_dtype)
    V = ct.functionspace(mesh, ("Lagrange", DEGREE), device=device)
    _ = mesh.facets
    _ = mesh.cell_diameters()
    return mesh, phi, V


def pipeline(ct, mesh, phi, V, form_dtype, rtol=RTOL, precond="jacobi",
             cut_kw=None):
    """One moving-domain step, as bench.py's pipeline(): classify ->
    quadrature -> forms -> assemble -> operator -> solve."""
    from cutfemx_tpu_torch.stencil import StencilCutOperator
    sync = _syncer(phi)
    t0 = time.perf_counter()
    P = poisson_forms(ct, mesh, phi, V, form_dtype, cut_kw=cut_kw)
    af, b, dom = P["af"], P["b"], P["dom"]
    sync()
    t_forms = time.perf_counter()
    op = StencilCutOperator(af, dom)
    sync()
    t_mid = time.perf_counter()
    xs, its, _ = op.solve_cg(b, rtol=rtol, maxiter=MAXITER,
                             precond=precond)
    sync()
    t1 = time.perf_counter()
    return dict(x=xs, its=int(its), b=b, op=op, forms=P,
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
    return dict(nums, op=op, b=run["b"], x=x, forms=run["forms"])


def stage_times(op, b, its, launches):
    """Each torch stage of one 'pallas' iteration, and K1, run alone on the
    pass's own tensors (L2 warm, as inside the solve): the device time of
    its kernels and their number (torch.profiler), the host time to enqueue
    it, its calls per pass, the bytes it must move and that bound."""
    import torch
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
    for name, (fn, calls, nbytes) in stages.items():
        ms, per_call, seen, host_ms = stage_device_ms(fn)
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


def _rel(got, want):
    return abs(got - want) / abs(want)


def stokes_parity_phase(dev, card):
    """The manufactured cut Stokes problem against the JAX-CPU errors, and
    the monolithic MixedCutForm matrix against the block composition."""
    import torch
    from cutfemx_tpu_torch import fem
    from cutfemx_tpu_torch.demos import demo_stokes
    outs = {}
    for n, (eu, ep) in JAX_CPU_STOKES.items():
        out = demo_stokes.run_manufactured(n, device=dev)
        rel = dict(err_u=_rel(out["err_u"], eu), err_p=_rel(out["err_p"], ep))
        if not max(rel.values()) < PINNED_RTOL:
            raise RuntimeError(f"stokes n={n}: errors {out['err_u']}, "
                               f"{out['err_p']} vs JAX-CPU {eu}, {ep}")
        outs[n] = out
        _phase("stokes_parity", **out, jax_cpu=dict(err_u=eu, err_p=ep),
               rel_to_jax_cpu=rel, card=card)
    (nc, c), (nf, f) = outs.items()
    rate = float(np.log2(c["err_u"] / f["err_u"]))
    if not rate > STOKES_RATE_MIN:
        raise RuntimeError(f"stokes: velocity rate {rate}")
    P = demo_stokes.problem(nc, device=dev, monolithic=True)
    if not (isinstance(P["a_form"], fem.MixedCutForm)
            and P["a_form"].device == torch.device(dev)):
        raise RuntimeError("stokes: the monolithic form is not a "
                           "MixedCutForm on the card")
    mono = fem.assemble_matrix(P["a_form"]).to_scipy()
    block = fem.assemble_matrix_block(
        fem.extract_blocks(P["a"], dtype=torch.float64)).to_scipy()
    diff = float(abs(mono - block).max())
    if not (mono.shape == block.shape and diff == 0.0):
        raise RuntimeError(f"stokes: monolithic matrix differs from the "
                           f"block composition by {diff}")
    _phase("stokes_monolithic", n=nc, shape=list(mono.shape), nnz=mono.nnz,
           max_abs_diff=diff, velocity_rate=rate, card=card)


def stokes_large_phase(dev, card):
    """The manufactured problem at n = 128 and 256: errors, rate, the time
    split, the assembly's device-busy share (torch.profiler, device
    activity only, over cut + quadrature, forms and the host CSR) and the
    peak device memory."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from cutfemx_tpu_torch.demos import demo_stokes
    outs = []
    for n in N_STOKES_LARGE:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            P = demo_stokes.problem(n, device=dev)
            A = demo_stokes.matrices(P)
            torch.cuda.synchronize()
        assembly_ms = (time.perf_counter() - t0) * 1e3
        out = demo_stokes.solve(P, A)
        total = time.perf_counter() - t0
        busy_ms = sum(e.self_device_time_total for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA) / 1e3
        if not busy_ms > 0:
            raise RuntimeError("the profiler saw no device time in the "
                               "Stokes assembly")
        if not np.all(np.isfinite([out["err_u"], out["err_p"]])):
            raise RuntimeError(f"stokes n={n}: non-finite errors")
        inactive = P["domain"].inactive_dofs.size
        out = dict(n=n, **out, **P["counts"],
                   active_dofs=P["counts"]["dofs"] - int(inactive),
                   **P["times"], total_s=total, assembly_ms=assembly_ms,
                   assembly_device_busy_ms=busy_ms,
                   assembly_device_busy_share=busy_ms / assembly_ms,
                   peak_device_bytes=torch.cuda.max_memory_allocated(),
                   host_stages=["classify", "assemble_matrix CSR",
                                "deactivate_outside", "pin",
                                "direct_solve"])
        outs.append(out)
        _phase("stokes_large", **out, card=card)
    c, f = outs
    rate = float(np.log2(c["err_u"] / f["err_u"]))
    if not rate > STOKES_RATE_MIN:
        raise RuntimeError(f"stokes large: velocity rate {rate}")
    _phase("stokes_rate", n_coarse=c["n"], n_fine=f["n"], err_u_rate=rate,
           err_p_rate=float(np.log2(c["err_p"] / f["err_p"])), card=card)


def stokes_cylinder_phase(dev, card):
    """The cylinder demo at the reference's n = 24 against its JAX-CPU
    numbers, then at n = 64."""
    from cutfemx_tpu_torch.demos import demo_stokes
    out = demo_stokes.run(24, device=dev)
    rel = {k: _rel(out[k], v) for k, v in JAX_CPU_CYLINDER_N24.items()}
    if not max(rel.values()) < PINNED_RTOL:
        raise RuntimeError(f"cylinder n=24: {rel} relative to JAX-CPU")
    _phase("stokes_cylinder", **out, jax_cpu=JAX_CPU_CYLINDER_N24,
           rel_to_jax_cpu=rel, card=card)
    out = demo_stokes.run(N_CYLINDER, device=dev)
    nums = [out[k] for k in ("flux_in", "flux_out", "u_gamma", "max_u")]
    if not (np.all(np.isfinite(nums))
            and out["mass_defect"] < CYLINDER_MASS_DEFECT):
        raise RuntimeError(f"cylinder n={N_CYLINDER}: {out}")
    _phase("stokes_cylinder", **out, card=card)


def newton_problem(which, n, dev):
    """tests/test_nonlinear.py's residual F(u; v), its boundary conditions
    and the zero initial guess, on the card in f64."""
    import torch
    import cutfemx_tpu_torch as ct
    from cutfemx_tpu_torch import fem
    from cutfemx_tpu_torch.forms import dsl as d
    from cutfemx_tpu_torch.forms.measure import Measure
    f64 = torch.float64
    if which == "fitted":
        mesh = ct.mesh.create_unit_square(n)
        V = ct.functionspace(mesh, ("Lagrange", 1), device=dev)
        u = ct.Function(V, name="u", dtype=f64)
        v = d.TestFunction(V)
        x = d.SpatialCoordinate(mesh)
        uc = d.CoefficientExpr(u)
        u_ex = x[0] * (1 - x[0]) * x[1] * (1 - x[1])
        dx = Measure("dx", domain=mesh)
        F = d.inner((1.0 + uc * uc) * d.grad(uc), d.grad(v)) * dx
        F -= d.inner((1.0 + u_ex * u_ex) * d.grad(u_ex), d.grad(v)) * dx
        c = V.dof_coordinates
        onb = ((np.abs(c[:, 0]) < 1e-12) | (np.abs(c[:, 0] - 1) < 1e-12)
               | (np.abs(c[:, 1]) < 1e-12) | (np.abs(c[:, 1] - 1) < 1e-12))
        bcs = [fem.dirichletbc(0.0, np.flatnonzero(onb), V)]
    else:
        r, gamma = 0.6, 40.0
        mesh = ct.mesh.create_rectangle((-1, -1), (1, 1), (n, n))
        phi = ct.Function(ct.functionspace(mesh, ("Lagrange", 1), device=dev),
                          name="phi", dtype=f64)
        phi.interpolate(lambda X: np.sqrt(X[0] ** 2 + X[1] ** 2) - r)
        cd = ct.cut(phi)
        dxo = Measure("dx", domain=mesh, subdomain_data=[
            ct.locate_entities(cd, "phi<0"),
            ct.runtime_quadrature(cd, "phi<0", 2)])
        dxg = Measure("dx", domain=mesh,
                      subdomain_data=ct.runtime_quadrature(cd, "phi=0", 2))
        V = ct.functionspace(mesh, ("Lagrange", 1), device=dev)
        u = ct.Function(V, name="u", dtype=f64)
        v = d.TestFunction(V)
        x = d.SpatialCoordinate(mesh)
        ng, h = ct.normal(phi), d.CellDiameter(mesh)
        uc = d.CoefficientExpr(u)
        u_ex = d.sin(d.pi * x[0]) * d.sin(d.pi * x[1])
        f = 2 * d.pi ** 2 * u_ex + u_ex ** 3
        F = d.inner(d.grad(uc), d.grad(v)) * dxo + (uc ** 3 - f) * v * dxo
        F += (-d.dot(d.grad(uc), ng) * v - d.dot(d.grad(v), ng) * (uc - u_ex)
              + gamma / h * (uc - u_ex) * v) * dxg
        probe = fem.form(d.inner(d.grad(ct.ufl.TrialFunction(V)),
                                 d.grad(v)) * dxo)
        bcs = [fem.dirichletbc(0.0, fem.active_domain(probe).inactive_dofs,
                               V)]
    return u, F, bcs


def newton_phase(dev, card):
    """newton_solve on both problems of tests/test_nonlinear.py, then
    la.bicgstab with Jacobi on the flower's element-batched CutOperator."""
    import torch
    from cutfemx_tpu_torch import fem, la
    from cutfemx_tpu_torch.demos import demo_poisson
    for which, (n, its_ref, tol) in JAX_CPU_NEWTON.items():
        u, F, bcs = newton_problem(which, n, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        u, its, hist = fem.newton_solve(F, u, bcs=bcs, tol=tol)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        if not (its == its_ref and hist[-1] < tol
                and u.x.device == torch.device(dev)
                and bool(torch.isfinite(u.x).all())):
            raise RuntimeError(f"newton {which}: {its} iterations (JAX-CPU "
                               f"{its_ref}), |F| {hist}")
        _phase("newton", problem=which, n=n, dofs=u.function_space.dim,
               iterations=its, jax_cpu_iterations=its_ref, history=hist,
               tol=tol, seconds=seconds,
               host_stages=["assemble_matrix CSR + bcs", "direct_solve"],
               card=card)
    P = demo_poisson.problem(N_BICGSTAB, device=dev)
    op = demo_poisson.operator(P)
    d = op.diagonal()
    bb = torch.where(op.active, P["b"], 0.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x, its, res = la.bicgstab(op, bb, M=lambda r: r / d,
                              rtol=demo_poisson.CG_RTOL,
                              maxiter=BICGSTAB_MAXITER)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    r = torch.where(op.active, bb - op(x), 0.0)
    true_rel = float(torch.linalg.norm(r) / torch.linalg.norm(bb))
    if not (its < BICGSTAB_MAXITER and true_rel <= FLOWER_TRUE_RESIDUAL):
        raise RuntimeError(f"bicgstab: {its} iterations, true relative "
                           f"residual {true_rel}")
    _phase("bicgstab", n=N_BICGSTAB, dofs=op.dim, precond="jacobi",
           iterations=its, residual_norm=float(res), rtol=demo_poisson.CG_RTOL,
           true_rel_residual=true_rel, seconds=seconds,
           l2_error=demo_poisson.l2_error(P, x), card=card)


# -- the geometry path -----------------------------------------------------


def value_summary(vals):
    """A field as the JAX-CPU constants hold it (the same function as
    tests/test_torch_distance.py's)."""
    vals = np.asarray(vals, np.float64)
    idx = np.linspace(0, len(vals) - 1, 9).astype(int)
    return dict(n_values=len(vals), sum=float(vals.sum()),
                sumsq=float((vals ** 2).sum()), min=float(vals.min()),
                max=float(vals.max()), samples=[float(v) for v in vals[idx]],
                negative=int((vals < 0).sum()))


def _hold_field(what, vals, want, tol=DISTANCE_ABS_TOL):
    """Raise unless a field matches the JAX-CPU summary: every sample, the
    min and the max within ``tol``, the sum within n * tol, the sum of
    squares within 2 n max|v| tol, the same count of negative values (and
    of FIM sweeps where given). Returns the largest sample error."""
    got = value_summary(vals)
    n = want["n_values"]
    if got["n_values"] != n or got["negative"] != want["negative"]:
        raise RuntimeError(f"{what}: {got['n_values']} values, "
                           f"{got['negative']} negative; JAX-CPU {n}, "
                           f"{want['negative']}")
    pts = np.asarray(got["samples"] + [got["min"], got["max"]])
    ref = np.asarray(want["samples"] + [want["min"], want["max"]])
    err = float(np.abs(pts - ref).max())
    vmax = max(abs(want["min"]), abs(want["max"]))
    if not (err <= tol and abs(got["sum"] - want["sum"]) <= n * tol
            and abs(got["sumsq"] - want["sumsq"]) <= 2 * n * vmax * tol):
        raise RuntimeError(f"{what}: off the JAX-CPU values by {err} "
                           f"(sum {got['sum']} vs {want['sum']})")
    return err


def _sphere_mesh(ct, n):
    return ct.mesh.create_box((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0),
                              (n, n, n))


def distance_parity_phase(ct, dev, card):
    """The sphere STL of demo_stl_distance (1,728 triangles) on the n = 16
    box in each sign mode (compute_signed_distance, and from_stl the same),
    the 2D point source of tests/test_distance.py (n = 40) and demo_reinit
    (n = 48), against the JAX-CPU values: 1e-10 absolute, equal sweeps and
    negative counts."""
    import tempfile
    import torch
    from cutfemx_tpu_torch import distance
    from cutfemx_tpu_torch.demos import demo_reinit, demo_stl_distance
    ref = JAX_CPU_DISTANCE
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "sphere.stl")
        demo_stl_distance._make_sphere_stl(path)
        mesh = _sphere_mesh(ct, N_SPHERE_PARITY)
        soup = distance.read_stl(path)
        ctmap = distance.build_cell_triangle_map(mesh, soup)
        for mode in DISTANCE_MODES:
            d, its = distance.compute_signed_distance(
                mesh, soup, ctmap, sign_mode=mode, device=dev)
            f = distance.from_stl(mesh, path, sign_mode=mode, device=dev,
                                  log_timings=False)
            if f.x.device.type != torch.device(dev).type \
                    or f.x.dtype != torch.float64 \
                    or not np.array_equal(f.x.cpu().numpy(), d):
                raise RuntimeError(f"from_stl ({mode}) differs from "
                                   "compute_signed_distance")
            want = ref["sphere"][mode]
            if its != want["sweeps"]:
                raise RuntimeError(f"sphere {mode}: {its} FIM sweeps, "
                                   f"JAX-CPU {want['sweeps']}")
            err = _hold_field(f"sphere {mode}", d, want)
            _phase("distance_parity", case="sphere_stl", mode=mode,
                   n=N_SPHERE_PARITY, triangles=soup.num_triangles,
                   sweeps=its, negative=int((d < 0).sum()),
                   max_abs_err=err, card=card)
    m2 = ct.mesh.create_rectangle((-1, -1), (1, 1),
                                  (N_POINT_SOURCE, N_POINT_SOURCE))
    r = np.linalg.norm(m2.vertices, axis=1)
    frozen = r < 0.15
    d, _, its = distance.eikonal_solve(
        m2, np.where(frozen, r, distance.FMMOptions().inf), frozen,
        device=dev)
    if its != ref["point_source"]["sweeps"]:
        raise RuntimeError(f"point source: {its} sweeps")
    err = _hold_field("point source", d.cpu().numpy(), ref["point_source"])
    _phase("distance_parity", case="point_source", n=N_POINT_SOURCE,
           sweeps=its, max_abs_err=err, card=card)
    out = demo_reinit.run(N_REINIT_DEMO, device=dev)
    err = _hold_field("demo_reinit", out["values"], ref["reinit"])
    if not (out["max_error"] < 0.06 and out["band_max_error"] < 0.01):
        raise RuntimeError(f"demo_reinit: errors {out['max_error']}, "
                           f"{out['band_max_error']}")
    _phase("distance_parity", case="demo_reinit", n=N_REINIT_DEMO,
           max_abs_err=err, negative=out["negative_vertices"],
           max_error=out["max_error"], band_max_error=out["band_max_error"],
           seconds=out["seconds"], card=card)


def _fim_sweep_bytes(mesh):
    """Bytes one FIM sweep must move without payload: d and the frozen
    mask read and d written per vertex; per update entry its vertex and
    its d known vertices (int64), d edge lengths and the inverse Gram
    matrices of every planar sub-simplex (f64), each read once."""
    d = mesh.tdim
    M = mesh.num_cells * len(mesh.ref_cell.simplex_split) * (d + 1)
    from itertools import combinations
    gram = sum(len(s) ** 2 for k in range(2, d + 1)
               for s in combinations(range(d), k))
    return M, M * 8 * ((d + 1) + d + gram) + mesh.num_vertices * 17


def _fim_sweep_flops(mesh):
    """Floating-point operations of one sweep's candidates: a one-point
    update per known vertex (d adds and compares) and a planar update per
    sub-simplex of k vertices (the three quadratic forms, the root and
    the causality weights: 3 k^2 + k^2 + ~12)."""
    d = mesh.tdim
    M = mesh.num_cells * len(mesh.ref_cell.simplex_split) * (d + 1)
    from itertools import combinations
    per = 2 * d + sum(4 * len(s) ** 2 + 12 for k in range(2, d + 1)
                      for s in combinations(range(d), k))
    return M * per


def distance_large_phase(ct, dev, card):
    """from_stl's stages at n = 96 (912,673 vertices, 5,308,416 tets) for
    a 27,648-triangle sphere in each sign mode, reinitialize of |x|^2 -
    1/4, one profiled FIM solve (device-busy share), the FIM sweep and the
    winding sum as stage rows, and peak device memory. Gates of
    tests/test_distance.py: the sign of |x| - 1/2 where ||x| - 1/2| >
    0.15, the error against it below 0.12, the reinitialized field's
    below 0.01 in the band ||x| - 1/2| < 0.1."""
    import tempfile
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from cutfemx_tpu_torch import distance
    from cutfemx_tpu_torch.demos import demo_stl_distance
    from cutfemx_tpu_torch.demos import stage_clock
    from cutfemx_tpu_torch.distance import api, winding
    clock = stage_clock(dev)
    torch.cuda.reset_peak_memory_stats()
    t0 = clock()
    mesh = _sphere_mesh(ct, N_DISTANCE_LARGE)
    exact = np.linalg.norm(mesh.vertices, axis=1) - 0.5
    far = np.abs(exact) > FAR_BAND
    M, sweep_bytes = _fim_sweep_bytes(mesh)
    _phase("distance_large_setup", n=N_DISTANCE_LARGE,
           vertices=mesh.num_vertices, cells=mesh.num_cells,
           update_entries=M, seconds=clock() - t0)
    fields = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "sphere.stl")
        demo_stl_distance._make_sphere_stl(path, n=SPHERE_LARGE_PER_FACE)
        for mode in DISTANCE_MODES:
            t = [clock()]
            soup = distance.distribute_stl(mesh, path)
            t.append(clock())
            ctmap = distance.build_cell_triangle_map(mesh, soup)
            t.append(clock())
            d0, frozen, closest, nrm = api._near_field(mesh, soup, ctmap,
                                                       dev)
            t.append(clock())
            d, _, its = distance.eikonal_solve(mesh, d0, frozen,
                                               device=dev)
            d = d.cpu().numpy()
            t.append(clock())
            if mode == "component_anchor":
                sign = api._sign_component_anchor(mesh, soup, ctmap, d,
                                                  closest, nrm, frozen)
            elif mode == "local_normal_band":
                sign = api._sign_local_normal_band(mesh, d, closest, nrm,
                                                   frozen, dev)
            else:
                sign = api._sign_winding_number(mesh, soup, dev)
            t.append(clock())
            vals = sign * d
            err = float(np.abs(vals - exact).max())
            wrong = int((np.sign(vals[far]) != np.sign(exact[far])).sum())
            if wrong or not err < LARGE_MAX_ERROR:
                raise RuntimeError(f"distance_large {mode}: {wrong} wrong "
                                   f"signs, max error {err}")
            s = np.diff(t)
            _phase("distance_large", mode=mode, n=N_DISTANCE_LARGE,
                   triangles=soup.num_triangles,
                   candidate_pairs=int(ctmap.offsets[-1]),
                   frozen_vertices=int(frozen.sum()), sweeps=its,
                   read_distribute_s=s[0], cell_triangle_map_s=s[1],
                   near_field_s=s[2], fim_s=s[3],
                   fim_ms_per_sweep=s[3] * 1e3 / its, sign_s=s[4],
                   total_s=float(t[-1] - t[0]), max_error=err,
                   negative=int((vals < 0).sum()), card=card)
            fields[mode] = vals
        # from_stl itself gives the split's field
        f = distance.from_stl(mesh, path, device=dev, log_timings=False)
        if not np.array_equal(f.x.cpu().numpy(), fields[DISTANCE_MODES[0]]):
            raise RuntimeError("from_stl differs from its stages at "
                               f"n = {N_DISTANCE_LARGE}")
        clusters = winding.build_winding_clusters(soup)
    # the winding sum alone, as a stage
    pts = torch.as_tensor(mesh.vertices, device=dev)
    reach2 = torch.as_tensor((2.0 * clusters.radius) ** 2, device=dev)
    cen = torch.as_tensor(clusters.centroid, device=dev)
    near_pairs = 0
    for i in range(0, pts.shape[0], 1 << 14):
        dd = ((pts[i:i + (1 << 14), None, :] - cen[None]) ** 2).sum(-1)
        near_pairs += int((dd <= reach2[None]).sum())
    wt = _device_times(lambda: winding.winding_numbers(
        mesh.vertices, clusters, device=dev), 2)
    P, C, K = mesh.num_vertices, clusters.n_clusters, clusters.K
    w_bytes = P * 3 * 8 + C * K * 9 * 8 + C * 7 * 8 + P * 8
    w_flops = P * C * 12 + near_pairs * K * 40
    w_bound = max(w_bytes / HBM_BYTES_PER_S, w_flops / F64_FLOPS_PER_S) * 1e3
    _phase("stage", stage="winding_numbers", n=N_DISTANCE_LARGE, points=P,
           clusters=C, near_cluster_pairs=near_pairs,
           device_ms_per_call=min(wt), calls=1, bytes=w_bytes,
           flops=w_flops, bound_ms=w_bound,
           bound_by="operations" if w_flops / F64_FLOPS_PER_S
           > w_bytes / HBM_BYTES_PER_S else "bytes", card=card)
    # reinitialize of the P1 field |x|^2 - 1/4
    V = ct.functionspace(mesh, ("Lagrange", 1), device=dev)
    phi = ct.Function(V, dtype=torch.float64)
    phi.interpolate(lambda x: x[0] ** 2 + x[1] ** 2 + x[2] ** 2 - 0.25)
    t0 = clock()
    out = distance.reinitialize(phi).x.cpu().numpy()
    reinit_s = clock() - t0
    band = np.abs(exact) < REINIT_BAND
    band_err = float(np.abs(out - exact)[band].max())
    if not band_err < REINIT_BAND_ERROR:
        raise RuntimeError(f"reinitialize n={N_DISTANCE_LARGE}: band "
                           f"error {band_err}")
    # one FIM solve profiled, and its sweep as a stage
    inf = distance.FMMOptions().inf
    d0 = np.where(np.abs(exact) < 0.03, np.abs(exact), inf)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, _, its = distance.eikonal_solve(mesh, d0, d0 < inf, device=dev)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA) / 1e3
    if not busy_ms > 0:
        raise RuntimeError("the profiler saw no device time in the FIM")
    ms = _device_times(lambda: distance.eikonal_solve(
        mesh, d0, d0 < inf, device=dev), 1)[0]
    flops = _fim_sweep_flops(mesh)
    bound = max(sweep_bytes / HBM_BYTES_PER_S,
                flops / F64_FLOPS_PER_S) * 1e3
    _phase("distance_large_reinit", n=N_DISTANCE_LARGE, seconds=reinit_s,
           band_max_error=band_err,
           max_error=float(np.abs(out - exact).max()),
           fim_profiled_wall_ms=wall_ms, fim_device_busy_ms=busy_ms,
           fim_device_busy_share=busy_ms / wall_ms,
           peak_device_bytes=torch.cuda.max_memory_allocated(), card=card)
    _phase("stage", stage="fim_sweep", n=N_DISTANCE_LARGE,
           update_entries=M, sweeps=its, device_ms_per_call=ms / its,
           calls=its, solve_ms=ms, bytes=sweep_bytes, flops=flops,
           bound_ms=bound, bound_by="bytes" if sweep_bytes /
           HBM_BYTES_PER_S > flops / F64_FLOPS_PER_S else "operations",
           share=bound / (ms / its), card=card)


def extension_phase(ct, dev, card):
    """extend_normal_velocity off the circle r = 1/2 at n = 512 with the
    constant (2.5) and the varying (x/|x|) speed of tests/test_distance.py
    and their gates, then target_space=P2 at n = 128 (unit speed)."""
    import torch
    from cutfemx_tpu_torch import distance
    from cutfemx_tpu_torch.demos import stage_clock
    clock = stage_clock(dev)

    def setup(n):
        mesh = ct.mesh.create_rectangle((-1, -1), (1, 1), (n, n))
        V = ct.functionspace(mesh, ("Lagrange", 1), device=dev)
        phi = ct.Function(V, dtype=torch.float64)
        phi.interpolate(lambda x: np.sqrt(x[0] ** 2 + x[1] ** 2) - 0.5)
        return mesh, V, phi

    mesh, V, phi = setup(N_EXTENSION)
    rad = np.linalg.norm(mesh.vertices, axis=1)
    for case, fn in (("constant", lambda x: np.full(x.shape[1], 2.5)),
                     ("varying", lambda x: x[0] / np.maximum(
                         np.sqrt(x[0] ** 2 + x[1] ** 2), 1e-12))):
        speed = ct.Function(V, dtype=torch.float64)
        speed.interpolate(fn)
        t0 = clock()
        res = distance.extend_normal_velocity(phi, speed)
        seconds = clock() - t0
        sv = res.speed.x.cpu().numpy()
        vel = res.velocity.x.cpu().numpy().reshape(-1, 2)
        if case == "constant":
            far = rad > 0.2
            vmag = np.linalg.norm(vel, axis=1)
            align = np.einsum("ij,ij->i", vel / np.maximum(
                vmag[:, None], 1e-12), mesh.vertices / np.maximum(
                rad[:, None], 1e-12))
            err = float(np.abs(sv - 2.5).max())
            ok = err < 1e-6 and np.abs(vmag[far] - 2.5).max() < 1e-5 \
                and (align[far] > 0.95).all()
        else:
            sel = (rad > 0.25) & (rad < 0.9)
            err = float(np.abs(sv - mesh.vertices[:, 0] / np.maximum(
                rad, 1e-12))[sel].max())
            ok = err < 0.12
        if not ok:
            raise RuntimeError(f"extension {case}: speed error {err}")
        _phase("extension", case=case, n=N_EXTENSION,
               vertices=mesh.num_vertices, speed_error=err,
               seconds=seconds, card=card)
    mesh, V, phi = setup(N_EXTENSION_P2)
    speed = ct.Function(V, dtype=torch.float64)
    speed.interpolate(lambda x: 1.0 + 0.0 * x[0])
    V2 = ct.functionspace(mesh, ("Lagrange", 2), device=dev)
    t0 = clock()
    res = distance.extend_normal_velocity(phi, speed, target_space=V2)
    seconds = clock() - t0
    s = res.speed.x.cpu().numpy()
    mag = np.linalg.norm(res.velocity.x.cpu().numpy().reshape(-1, 2),
                         axis=1)
    if not (res.speed.function_space is V2 and np.abs(s - 1.0).max() < 0.05
            and abs(np.median(mag) - 1.0) < 0.05):
        raise RuntimeError("extension target_space=P2 fails its gates")
    _phase("extension", case="target_p2", n=N_EXTENSION_P2, dofs=V2.dim,
           speed_error=float(np.abs(s - 1.0).max()), seconds=seconds,
           card=card)


def _history(res):
    return [[h[k] for k in ("compliance", "volume", "lagrangian", "dt")]
            for h in res["history"]]


def shape_opt_phase(ct, dev, card):
    """demo_compliance_optimization at its defaults (n = 32, 10 L-BFGS
    iterations, SUPG, reinitialization every 3) from the reference's
    initial design (a checkpoint) against the JAX-CPU history: iteration 0
    within 1e-10 relative, every iteration within 1e-6. The same run from
    the port's own initial design is reported beside it. Then n = 128
    (65,536 triangles) timed by stage, and a 2-iteration run under
    torch.profiler for the device-busy share."""
    import shutil
    import tempfile
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from cutfemx_tpu_torch.demos import demo_compliance_optimization as demo
    here = os.path.dirname(os.path.abspath(__file__))
    want = np.asarray(JAX_CPU_COMPLIANCE_N32)
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "initial.npz")
        shutil.copy(os.path.join(here, COMPLIANCE_INITIAL), ck)
        t0 = time.perf_counter()
        res = demo.run(["--checkpoint", ck, "--resume"], n=N_SHAPE_OPT,
                       iters=SHAPE_OPT_ITERS, quiet=True, device=dev)
        seconds = time.perf_counter() - t0
    got = np.asarray(_history(res))
    rel = np.abs(got - want) / np.abs(want)
    if got.shape != want.shape or not (
            rel[0].max() <= SHAPE_OPT_RTOL_FIRST
            and rel.max() <= SHAPE_OPT_RTOL):
        raise RuntimeError(f"shape_opt n={N_SHAPE_OPT}: history off the "
                           f"JAX-CPU run by {rel.max(axis=1).tolist()}")
    t0 = time.perf_counter()
    own = np.asarray(_history(demo.run(n=N_SHAPE_OPT, iters=SHAPE_OPT_ITERS,
                                       quiet=True, device=dev)))
    own_s = time.perf_counter() - t0
    own_rel = (np.abs(own - want) / np.abs(want)).max(axis=1)
    _phase("shape_opt", n=N_SHAPE_OPT, iterations=len(got),
           max_rel_err_by_iteration=rel.max(axis=1).tolist(),
           final=dict(zip(("compliance", "volume", "lagrangian", "dt"),
                          got[-1].tolist())), seconds=seconds,
           own_design_max_rel_err_by_iteration=own_rel.tolist(),
           own_design_seconds=own_s, card=card)
    t0 = time.perf_counter()
    res = demo.run(n=N_SHAPE_OPT_LARGE, iters=SHAPE_OPT_LARGE_ITERS,
                   quiet=True, device=dev)
    seconds = time.perf_counter() - t0
    hist = np.asarray(_history(res))
    if not np.isfinite(hist).all():
        raise RuntimeError(f"shape_opt n={N_SHAPE_OPT_LARGE}: non-finite "
                           "history")
    split = {k: sum(r.get(f"time_{k}", 0.0) for r in res["profile"])
             for k in ("state_solve", "gradient", "extension", "advect",
                       "reinit", "line_search", "total")}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        demo.run(n=N_SHAPE_OPT_LARGE, iters=2, quiet=True, device=dev)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA) / 1e3
    if not busy_ms > 0:
        raise RuntimeError("the profiler saw no device time in shape_opt")
    _phase("shape_opt", n=N_SHAPE_OPT_LARGE,
           triangles=4 * N_SHAPE_OPT_LARGE ** 2,
           iterations=len(hist), seconds=seconds,
           stage_s=split, state_solves=sum(r["state_solves"]
                                           for r in res["profile"]),
           first=hist[0].tolist(), final=hist[-1].tolist(),
           profiled_iterations=2, profiled_wall_ms=wall_ms,
           device_busy_ms=busy_ms, device_busy_share=busy_ms / wall_ms,
           host_stages=["classify", "assemble_matrix CSR", "spsolve",
                        "Riesz factorization", "cell-triangle map"],
           card=card)


# -- geometric multigrid (mg.py) and the demos of ROADMAP item 12a ----------


def _host(a):
    """numpy copy of a tensor (on any device) or an array."""
    return a.detach().cpu().numpy() if hasattr(a, "detach") else \
        np.asarray(a)


def mg_problem(pkg, which, n, device=None):
    """tests/test_mg.py's systems in ``pkg``: the stabilized cut Poisson
    problem in P1 or P2 (``which`` "p1", "p2") or the cut elasticity
    problem in vector P1 ("vector"), on the n x n mesh of [-1, 1]^2 with a
    disk of radius 0.6; f64 (the port on ``device``). Returns the space V,
    the deactivated host CSR A and load vector b (numpy)."""
    import importlib
    fem = importlib.import_module(pkg.__name__ + ".fem")
    d = importlib.import_module(pkg.__name__ + ".forms.dsl")
    Measure = importlib.import_module(pkg.__name__ + ".forms.measure").Measure
    if device is None:                 # the reference: x64 gives f64
        kw, fkw, dkw = {}, {}, {}
    else:
        import torch
        kw, fkw, dkw = ({"device": device}, {"dtype": torch.float64},
                        {"dtype": torch.float64})
    deg = 2 if which == "p2" else 1
    mesh = pkg.mesh.create_rectangle((-1.0, -1.0), (1.0, 1.0), (n, n))
    Vphi = pkg.functionspace(mesh, ("Lagrange", 1), **kw)
    phi = pkg.Function(Vphi, name="phi", **fkw)
    phi.interpolate(lambda x: np.sqrt(x[0] ** 2 + x[1] ** 2) - 0.6)
    cd = pkg.cut(phi)
    inside = pkg.locate_entities(cd, "phi<0")
    vol = pkg.runtime_quadrature(cd, "phi<0", 2 * deg)
    srf = pkg.runtime_quadrature(cd, "phi=0", 2 * deg)
    gpf = pkg.ghost_penalty_facets(cd, "phi<0")
    dxo = Measure("dx", domain=mesh, subdomain_data=[inside, vol])
    dxg = Measure("dx", domain=mesh, subdomain_data=srf)
    dSg = Measure("dS", domain=mesh, subdomain_data=gpf)
    V = pkg.functionspace(mesh, ("Lagrange", deg),
                          shape=(2,) if which == "vector" else (), **kw)
    u, v = d.TrialFunction(V), d.TestFunction(V)
    ng = pkg.normal(phi)
    nf = d.FacetNormal(mesh)
    h = d.CellDiameter(mesh)
    if which == "vector":
        def sigma(w):
            e = d.sym(d.grad(w))
            return 2 * e + 1.3 * d.tr(e) * d.Identity(2)
        a = d.inner(sigma(u), d.sym(d.grad(v))) * dxo
        a += (-d.inner(d.dot(sigma(u), ng), v)
              - d.inner(d.dot(sigma(v), ng), u)
              + 60.0 / h * d.inner(u, v)) * dxg
        L = d.inner(d.as_vector([0.0, -1.0]), v) * dxo
    else:
        x = d.SpatialCoordinate(mesh)
        ue = d.sin(d.pi * x[0]) * d.sin(d.pi * x[1])
        f = 2 * d.pi ** 2 * ue
        a = d.inner(d.grad(u), d.grad(v)) * dxo
        a += (-d.dot(d.grad(u), ng) * v - d.dot(d.grad(v), ng) * u
              + 40.0 / h * u * v) * dxg
        L = f * v * dxo + (-d.dot(d.grad(v), ng) * ue
                           + 40.0 / h * ue * v) * dxg
    a += 0.1 * d.avg(h) * d.inner(d.jump(d.grad(u), nf),
                                  d.jump(d.grad(v), nf)) * dSg
    af, Lf = fem.form(a, **dkw), fem.form(L, **dkw)
    dom = fem.active_domain(af)
    A = fem.assemble_matrix(af)
    b = np.array(_host(fem.assemble_vector(Lf)))
    fem.deactivate_outside(A, b, dom)
    return V, A, b


def csr_true_rel_residual(A, x, b):
    """||b - A x|| / ||b||, one apply of the host CSR in f64."""
    m = A.to_scipy().astype(np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(b - m @ _host(x).astype(np.float64))
                 / np.linalg.norm(b))


def _hold_summary(what, vals, want, rtol):
    """Raise unless a field's value_summary matches the JAX-CPU one: the
    samples, min and max within rtol * max|v|, the sum within
    rtol * n * max|v| and the sum of squares within 2 rtol n max|v|^2.
    Returns the largest sample error over max|v|."""
    got = value_summary(vals)
    vmax = max(abs(want["min"]), abs(want["max"]))
    pts = np.asarray(got["samples"] + [got["min"], got["max"]])
    ref = np.asarray(want["samples"] + [want["min"], want["max"]])
    err = float(np.abs(pts - ref).max() / vmax)
    n = want["n_values"]
    if not (got["n_values"] == n and err <= rtol
            and abs(got["sum"] - want["sum"]) <= rtol * n * vmax
            and abs(got["sumsq"] - want["sumsq"]) <= 2 * rtol * n * vmax ** 2):
        raise RuntimeError(f"{what}: off the JAX-CPU values by {err} of "
                           f"max|v| (sum {got['sum']} vs {want['sum']})")
    return err


def mg_parity_phase(ct, dev, card):
    """tests/test_mg.py on the card: the P1 transfer interpolates exactly,
    and mg_solve_cg on its P1 and P2 cut Poisson and vector elasticity
    problems at its sizes gives the JAX-CPU iteration counts and solution
    (f64)."""
    import torch
    from cutfemx_tpu_torch import mg
    for gen, nf, nc in ((ct.mesh.create_rectangle, (16, 16), (8, 8)),
                        (ct.mesh.create_box, (8, 8, 8), (4, 4, 4))):
        lo, hi = (-1.0,) * len(nf), (1.0,) * len(nf)
        fine, coarse = gen(lo, hi, nf), gen(lo, hi, nc)
        idx, w = mg.p1_grid_transfer(fine, coarse)
        coef = np.array([2.0, -0.7, 0.4])[:len(nf)]
        err = float(np.abs((w * (coarse.vertices @ coef + 0.3)[idx])
                           .sum(axis=1) - (fine.vertices @ coef + 0.3)).max())
        if not err < MG_TRANSFER_TOL:
            raise RuntimeError(f"p1_grid_transfer {nf}: interpolation error "
                               f"{err}")
        _phase("mg_parity", case="p1_transfer", fine=list(nf),
               coarse=list(nc), max_interpolation_error=err)
    for which, (n, rtol, maxiter) in MG_PARITY.items():
        t0 = time.perf_counter()
        V, A, b = mg_problem(ct, which, n, dev)
        t1 = time.perf_counter()
        x, its, res = mg.mg_solve_cg(A, V, b, rtol=rtol, maxiter=maxiter)
        t2 = time.perf_counter()
        want = JAX_CPU_MG[which]
        rel = csr_true_rel_residual(A, x, b)
        if not (x.device == torch.device(dev) and x.dtype == torch.float64):
            raise RuntimeError(f"mg {which}: solution not f64 on the card")
        if its != want["iterations"] or not rel <= rtol * 1.01:
            raise RuntimeError(f"mg {which} n={n}: {its} iterations (JAX-CPU "
                               f"{want['iterations']}), true residual {rel}")
        err = _hold_summary(f"mg {which} n={n}", _host(x), want["x"],
                            MG_X_RTOL)
        _phase("mg_parity", case=which, n=n, dofs=V.dim, rtol=rtol,
               iterations=its, jax_cpu_iterations=want["iterations"],
               true_rel_residual=rel, x_rel_err=err, problem_s=t1 - t0,
               solve_s=t2 - t1, card=card)


def poisson_forms(pkg, mesh, phi, V, form_dtype, *, cut_kw=None,
                  backend="straight", order=2 * DEGREE):
    """bench.py's step up to the load vector in ``pkg`` (cutfemx_tpu_torch,
    or cutfemx_tpu for a JAX-CPU reference): classify (``cut_kw`` to
    ``cut``), the runtime rules of ``order`` from ``backend``, the Nitsche
    + ghost-penalty forms of u = sin(pi x) sin(pi y) sin(pi z) in
    ``form_dtype``, the active domain and b on the level set's device.
    Returns the forms, rules and measures, with the seconds of the cut
    (classification and cell sets), of the rules and of the forms."""
    import importlib
    fem = importlib.import_module(pkg.__name__ + ".fem")
    d = importlib.import_module(pkg.__name__ + ".forms.dsl")
    Measure = importlib.import_module(pkg.__name__ + ".forms.measure").Measure
    sync = _syncer(phi)
    t0 = time.perf_counter()
    cd = pkg.cut(phi, **(cut_kw or {}))
    inside = pkg.locate_entities(cd, "phi<0")
    gp = pkg.ghost_penalty_facets(cd, "phi<0")
    t1 = time.perf_counter()
    vol = pkg.runtime_quadrature(cd, "phi<0", order, backend=backend)
    srf = pkg.runtime_quadrature(cd, "phi=0", order, backend=backend)
    sync()
    t2 = time.perf_counter()
    dxo = Measure("dx", domain=mesh, subdomain_data=[inside, vol])
    dxg = Measure("dx", domain=mesh, subdomain_data=srf)
    dSg = Measure("dS", domain=mesh, subdomain_data=gp)
    u, v = d.TrialFunction(V), d.TestFunction(V)
    x = d.SpatialCoordinate(mesh)
    ng = pkg.normal(phi)
    nf = d.FacetNormal(mesh)
    h = d.CellDiameter(mesh)
    ue = d.sin(d.pi * x[0]) * d.sin(d.pi * x[1]) * d.sin(d.pi * x[2])
    f = 3 * d.pi ** 2 * ue
    a = d.inner(d.grad(u), d.grad(v)) * dxo
    a += (-d.dot(d.grad(u), ng) * v - d.dot(d.grad(v), ng) * u
          + GAMMA / h * u * v) * dxg
    a += 0.1 * d.avg(h) * d.inner(d.jump(d.grad(u), nf),
                                  d.jump(d.grad(v), nf)) * dSg
    L = f * v * dxo + (-d.dot(d.grad(v), ng) * ue
                       + GAMMA / h * ue * v) * dxg
    af = fem.form(a, dtype=form_dtype)
    Lf = fem.form(L, dtype=form_dtype)
    dom = fem.active_domain(af)
    b = fem.assemble_vector(Lf)
    sync()
    t3 = time.perf_counter()
    return dict(af=af, Lf=Lf, b=b, dom=dom, vol=vol, srf=srf, inside=inside,
                gp=gp, dxo=dxo, ue=ue, form_dtype=form_dtype,
                cut_s=t1 - t0, rules_s=t2 - t1, forms_s=t3 - t2)


def mg_pass(ct, dev, mesh, phi, V, entry=False):
    """bench.py's mg leg once: f32 forms, ``assemble_matrix`` (element
    matrices on the card, the CSR on the host), ``deactivate_outside``,
    then ``mg.mg_solve_cg`` (``entry``) or its two stages timed apart: the
    hierarchy (``MGPreconditioner``) and the CG (``solve_cg``)."""
    import torch
    from cutfemx_tpu_torch import fem, mg
    torch.cuda.reset_peak_memory_stats(dev)
    sync = torch.cuda.synchronize
    t0 = time.perf_counter()
    P = poisson_forms(ct, mesh, phi, V, torch.float32)
    af, b, dom = P["af"], P["b"], P["dom"]
    sync()
    t1 = time.perf_counter()
    A = fem.assemble_matrix(af)
    t2 = time.perf_counter()
    bb = _host(b).copy()
    fem.deactivate_outside(A, bb, dom)
    t3 = time.perf_counter()
    M = None
    if entry:
        x, its, res = mg.mg_solve_cg(A, V, bb, rtol=RTOL, maxiter=MAXITER,
                                     nu=MG_NU)
        sync()
        t4 = t5 = time.perf_counter()
    else:
        M = mg.MGPreconditioner(A, V, nu=MG_NU)
        t4 = time.perf_counter()
        x, its, res = M.solve_cg(bb, rtol=RTOL, maxiter=MAXITER)
        sync()
        t5 = time.perf_counter()
    return dict(x=x, its=its, res=res, A=A, b=bb, M=M,
                true_rel_residual=csr_true_rel_residual(A, x, bb),
                forms_s=t1 - t0, matrix_s=t2 - t1, deactivate_s=t3 - t2,
                hierarchy_s=t4 - t3, cg_s=t5 - t4, total_s=t5 - t0,
                peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 2 ** 30)


def stage_device_ms(fn, reps=5):
    """One call of ``fn`` timed alone (L2 warm): (device ms from the
    profiler's kernel records, kernels per call, kernel records seen, host
    ms to enqueue it)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) / reps * 1e3   # enqueue only
    torch.cuda.synchronize()
    # a stage of ~100 small launches is enqueued slower than it runs, so
    # events around it would time the host: sum its kernels' own times
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    seen = sum(e.count for e in kernels)
    if not seen > 0:
        raise RuntimeError("the profiler saw no device time")
    # a profile can lose the records of its first kernels (K1 showed 3 of
    # its 5 launches): the mean kernel time, times the kernels of a call,
    # does not depend on how many records came through
    per_call = -(-seen // reps)
    ms = sum(e.self_device_time_total for e in kernels) / 1e3 / seen \
        * per_call
    return ms, per_call, seen, host_ms


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def mg_vcycle_bytes(M):
    """The bytes one V-cycle must move: every smoothed level's CSR (values,
    columns, row lengths) and inverse diagonal, the transfers, the coarse
    inverse, and each level's right-hand side and correction once."""
    isz = M.levels[0]["dinv"].element_size()
    out = _nbytes(M.coarse_inv)
    for k, lv in enumerate(M.levels):
        out += 2 * M._sizes[k] * isz
        if k < M.n_levels - 1:
            out += _nbytes(*lv["A"], lv["dinv"])
    for P, R in zip(M.prolongs, M.restricts):
        out += _nbytes(*P, *R)
    return out


def mg_stage_lines(M, x, b, its, card):
    """One V-cycle and one fine CSR apply alone on the pass's tensors:
    device ms, kernels and host enqueue ms per call, calls per pass, the
    bytes each must move and that bound; for the apply also one cuSPARSE
    ``torch.mv`` of the same CSR (a yardstick the port never calls)."""
    import torch
    from cutfemx_tpu_torch import mg
    r = torch.as_tensor(b, device=M.device)
    A0 = M.levels[0]["A"]
    n0 = M._sizes[0]
    data, cols, lengths = A0
    crow = torch.cat([lengths.new_zeros(1), torch.cumsum(lengths, 0)]).to(
        torch.int32)
    csr = torch.sparse_csr_tensor(crow, cols, data, size=(n0, n0))
    lib = _device_times(lambda: torch.mv(csr, x), 20)
    if not torch.allclose(torch.mv(csr, x), mg._csr_apply(A0, x),
                          rtol=1e-5, atol=1e-6 * float(r.abs().max())):
        raise RuntimeError("cuSPARSE mv and the port's CSR apply disagree")
    # a pass: one V-cycle per iteration and one for the start; each
    # applies the fine CSR 2 nu + 1 times, and CG once more
    stages = {
        "mg_vcycle": (lambda: M(r), its + 1, mg_vcycle_bytes(M), None),
        "mg_fine_csr_apply": (lambda: mg._csr_apply(A0, x),
                              (its + 1) * (2 * M.nu + 2),
                              _nbytes(*A0) + 2 * n0 * x.element_size(),
                              float(np.median(lib))),
    }
    for name, (fn, calls, nbytes, library_ms) in stages.items():
        ms, per_call, seen, host_ms = stage_device_ms(fn)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        _phase("stage", stage=name, n=N_SLICE, levels=list(M._sizes),
               device_ms_per_call=ms, kernels_per_call=per_call,
               kernel_records=seen, host_enqueue_ms_per_call=host_ms,
               calls_per_pass=calls, device_ms_per_pass=ms * calls,
               bytes=nbytes, bound_ms=bound_ms, share=bound_ms / ms,
               library_ms=library_ms, card=card)


def mg_bench_phase(ct, dev, mesh, phi, V, card):
    """bench.py's mg leg at n = 48 (912,673 P2 dofs): a warm-up through
    ``mg_solve_cg``, two timed passes with the hierarchy and the CG timed
    apart, which must repeat the warm-up's iterations and solution
    bitwise; every pass at a true relative residual <= 1e-6 and within
    +-5% (at least +-3) of the JAX-CPU count; no K1 launch. Then one
    V-cycle and one fine CSR apply as stage lines, and one profiled CG
    pass (device busy and idle share)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from cutfemx_tpu_torch import interior_stencil as ist
    before = ist.launches
    runs = [("warmup", mg_pass(ct, dev, mesh, phi, V, entry=True))]
    for p in ("timed1", "timed2"):
        runs.append((p, mg_pass(ct, dev, mesh, phi, V)))
    k1 = ist.launches - before
    band = max(ITERATION_BAND * JAX_CPU_MG_ITERATIONS_N48,
               ITERATION_BAND_MIN)
    x0 = runs[0][1]["x"]
    for p, run in runs:
        x = run["x"]
        if not (torch.isfinite(x).all() and x.shape == (V.dim,)
                and x.device == torch.device(dev)):
            raise RuntimeError(f"mg {p}: non-finite or misshapen solution")
        if not run["true_rel_residual"] <= RTOL:
            raise RuntimeError(f"mg {p}: true relative residual "
                               f"{run['true_rel_residual']} > {RTOL}")
        if abs(run["its"] - JAX_CPU_MG_ITERATIONS_N48) > band:
            raise RuntimeError(f"mg {p}: {run['its']} iterations, JAX-CPU "
                               f"{JAX_CPU_MG_ITERATIONS_N48} (+-{band})")
        if run["its"] != runs[0][1]["its"] or not torch.equal(x, x0):
            raise RuntimeError(f"mg {p}: {run['its']} iterations or x "
                               "differ from the warm-up's")
        M = run["M"]
        nums = {k: run[k] for k in ("forms_s", "matrix_s", "deactivate_s",
                                    "hierarchy_s", "cg_s", "total_s",
                                    "true_rel_residual", "peak_mem_gb")}
        if M is not None:
            nums.update(levels=list(M._sizes),
                        nnz=[int(lv["A"][0].numel()) for lv in M.levels],
                        lmax=[lv["lmax"] for lv in M.levels],
                        hierarchy_split_s=M.build_times)
        _phase("mg_bench", **{"pass": p}, n=N_SLICE, dofs=V.dim,
               iterations=run["its"], residual_norm=run["res"],
               jax_cpu_iterations=JAX_CPU_MG_ITERATIONS_N48,
               ms_per_iteration=run["cg_s"] / run["its"] * 1e3, **nums,
               card=card)
    if k1:
        raise RuntimeError(f"the mg path launched K1 {k1} times")
    run = runs[-1][1]
    M = run["M"]
    mg_stage_lines(M, run["x"], run["b"], run["its"], card)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, its, _ = M.solve_cg(run["b"], rtol=RTOL, maxiter=MAXITER)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    items = [e for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA
             and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in items) / 1e3
    if not busy_ms > 0:
        raise RuntimeError("the profiler saw no device time in the mg CG")
    _phase("mg_profile", n=N_SLICE, iterations=its, wall_ms=wall_ms,
           device_busy_ms=busy_ms, device_idle_share=1 - busy_ms / wall_ms,
           device_kernel_launches=sum(e.count for e in items),
           launches_per_iteration=sum(e.count for e in items) / its,
           k1_launches=k1, card=card)


def demo_numbers(out):
    """A demo's run(...) output with per-step records (the moving demo)
    flattened into lists, as JAX_CPU_DEMOS keys them."""
    steps = out.pop("per_step", None)
    if steps is not None:
        out.update(cut_cells=[s["cut_cells"] for s in steps],
                   l2_errors=[s["l2_error"] for s in steps],
                   step_s=[s["seconds"] for s in steps])
    return out


def hold_demo(case, got, want):
    """Raise unless a demo's numbers match the reference's (the keys of
    ``want``): counts exactly, perimeter and area within DEMO_GEOM_TOL, L2
    errors within PINNED_RTOL relative. Returns the largest error."""
    worst = 0.0
    for key, ref in want.items():
        val = got[key]
        if key in ("perimeter", "area"):
            err = abs(val - ref)
            ok = err <= DEMO_GEOM_TOL
        elif key in ("l2_error", "l2_errors"):
            err = float((np.abs(np.asarray(val) - ref) / np.abs(ref)).max())
            ok = err <= PINNED_RTOL
        else:
            err, ok = 0.0, val == ref
        if not ok:
            raise RuntimeError(f"demo {case}: {key} {val}, reference {ref}")
        worst = max(worst, err)
    return worst


def demos_12a_phase(dev, card):
    """The five demos of ROADMAP item 12a on the card (f64), at the
    reference scripts' default sizes and one larger size each, against
    the JAX-CPU numbers: counts exactly, perimeter and area within 1e-10,
    L2 errors within 1e-6 relative."""
    from cutfemx_tpu_torch.demos import (demo_boundary_sphere_perimeter,
                                         demo_dg_poisson, demo_elasticity,
                                         demo_locate_entities,
                                         demo_moving_poisson)
    cases = {
        "perimeter_2d_32": lambda: demo_boundary_sphere_perimeter.run(
            32, 2, device=dev),
        "perimeter_3d_32": lambda: demo_boundary_sphere_perimeter.run(
            32, 3, device=dev),
        "perimeter_2d_512": lambda: demo_boundary_sphere_perimeter.run(
            512, 2, device=dev),
        "locate_24": lambda: demo_locate_entities.run(24, device=dev),
        "locate_256": lambda: demo_locate_entities.run(256, device=dev),
        "dg_32": lambda: demo_dg_poisson.run(32, device=dev),
        "dg_128": lambda: demo_dg_poisson.run(128, device=dev),
        "elasticity_32": lambda: demo_elasticity.run(32, device=dev),
        "elasticity_256": lambda: demo_elasticity.run(256, device=dev),
        "moving_32": lambda: demo_moving_poisson.run(32, 8, device=dev),
        "moving_128": lambda: demo_moving_poisson.run(128, 8, device=dev),
    }
    for case, fn in cases.items():
        t0 = time.perf_counter()
        out = demo_numbers(fn())
        seconds = time.perf_counter() - t0
        worst = hold_demo(case, out, JAX_CPU_DEMOS[case])
        _phase("demos_12a", case=case, **out, seconds=seconds,
               max_err_vs_jax_cpu=worst, card=card)



# -- the unfitted-boundary surface (ROADMAP item 10 steps 1-4, item 12) ------


def _simplex_measure(verts):
    """Lengths, areas or volumes of simplices (E, k+1, gdim), on the
    host."""
    E = verts[:, 1:, :] - verts[:, :1, :]
    gram = np.einsum("eig,ejg->eij", E, E)
    k = E.shape[1]
    return np.sqrt(np.abs(np.linalg.det(gram))) / [1, 1, 2, 6][k]


def _clip(poly, c):
    """Sutherland-Hodgman: the part of polygon ``poly`` where
    c[0] x + c[1] y + c[2] <= 0."""
    f = [c[0] * p[0] + c[1] * p[1] + c[2] for p in poly]
    out = []
    for i, p in enumerate(poly):
        j = (i + 1) % len(poly)
        if f[i] <= 0:
            out.append(p)
        if f[i] * f[j] < 0:
            t = f[i] / (f[i] - f[j])
            out.append(p + t * (poly[j] - p))
    return out


def _shoelace(poly):
    x = np.array([p[0] for p in poly])
    y = np.array([p[1] for p in poly])
    return 0.5 * abs(float(np.dot(x, np.roll(y, -1))
                           - np.dot(np.roll(x, -1), y)))


# two planar P1 level sets on [-1, 1]^2: {a < 0} and {b < 0} half-planes
COMPOUND_PLANES = {"a": (1.0, 0.5, -0.13), "b": (0.3, -1.0, -0.21)}


def compound_numbers(pkg, n, device=None):
    """The rules of 'a<0 and b<0' and 'a<0 or b<0' on the n x n mesh of
    [-1, 1]^2 in ``pkg`` (the port on ``device``, f64): their weight sums
    and parent counts, the cells locate_entities gives for each selector,
    and rules + cells against the polygon's area (shoelace)."""
    from cutfemx_tpu_torch.demos import stage_clock
    clock = stage_clock(device)
    kw, fkw = ({}, {}) if device is None else (
        {"device": device}, {"dtype": __import__("torch").float64})
    t0 = clock()
    mesh = pkg.mesh.create_rectangle((-1.0, -1.0), (1.0, 1.0), (n, n))
    V = pkg.functionspace(mesh, ("Lagrange", 1), **kw)
    phis = []
    for name, c in COMPOUND_PLANES.items():
        f = pkg.Function(V, name=name, **fkw)
        f.interpolate(lambda x, c=c: c[0] * x[0] + c[1] * x[1] + c[2])
        phis.append(f)
    cd = pkg.cut(phis)
    square = [np.array(p, float) for p in ((-1, -1), (1, -1), (1, 1),
                                           (-1, 1))]
    half = {k: _shoelace(_clip(square, c))
            for k, c in COMPOUND_PLANES.items()}
    both = _shoelace(_clip(_clip(square, COMPOUND_PLANES["a"]),
                           COMPOUND_PLANES["b"]))
    polygon = {"and": both, "or": half["a"] + half["b"] - both}
    out, t = {}, {"setup": clock() - t0}
    for key in ("and", "or"):
        sel = f"a<0 {key} b<0"
        t0 = clock()
        rules = pkg.runtime_quadrature(cd, sel, 2)
        wsum = float(_host(rules.weights_padded).sum())
        t[key] = clock() - t0
        cells = pkg.locate_entities(cd, sel)
        cells_area = float(_simplex_measure(
            mesh.cell_vertex_coords[cells]).sum())
        out.update({f"{key}_rules": wsum,
                    f"{key}_parents": int(rules.parent_map.size),
                    f"{key}_cells": int(cells.size),
                    f"{key}_total": wsum + cells_area,
                    f"{key}_polygon": polygon[key]})
    out["seconds"] = t
    return out


def facet_3d_numbers(pkg, n, device=None):
    """bench.py's geometry (create_box of [-1, 1]^3, n^3 x 6 tets, the P1
    sphere r = 0.46) in ``pkg``: the interior facets of the cut cells as
    facet-hosted CutData, their 'phi<0', 'phi>0', 'phi=0' rules (weight
    sums) against the cut facets' areas, the facet-hosted cut mesh of
    'phi<0', the cell aggregation of 'phi<0' at 0.5 and the P1 extension
    penalty with beta = 1 (symmetry and constants, relative to max|M|).
    Returns the numbers and the seconds of each stage."""
    import importlib
    from cutfemx_tpu_torch.demos import stage_clock
    clock = stage_clock(device)
    ext = importlib.import_module(pkg.__name__ + ".extensions")
    kw, fkw = ({}, {}) if device is None else (
        {"device": device}, {"dtype": __import__("torch").float64})
    t, t0 = {}, clock()
    mesh = pkg.mesh.create_box((-1, -1, -1), (1, 1, 1), (n, n, n))
    V = pkg.functionspace(mesh, ("Lagrange", 1), **kw)
    phi = pkg.Function(V, name="phi", **fkw)
    phi.interpolate(lambda x: np.sqrt(x[0] ** 2 + x[1] ** 2 + x[2] ** 2)
                    - 0.46)
    t1 = clock()
    t["mesh"] = t1 - t0
    cd = pkg.cut(phi)
    cut_cells = pkg.locate_entities(cd, "phi=0")
    skel = pkg.interior_facets_for_cells(mesh, cut_cells)
    fcd = pkg.cut(phi, skel, mesh.tdim - 1)
    cut_f = pkg.locate_entities(fcd, "phi=0")
    in_f = pkg.locate_entities(fcd, "phi<0")
    t2 = clock()
    t["cut"] = t2 - t1
    rules = pkg.runtime_quadratures(fcd, ("phi<0", "phi>0", "phi=0"), 2)
    sums = {k: float(_host(r.weights_padded).sum()) for k, r in rules.items()}
    t3 = clock()
    t["rules"] = t3 - t2
    cm = pkg.create_cut_mesh(fcd, "phi<0")
    t4 = clock()
    t["cut_mesh"] = t4 - t3
    agg = ext.create_cell_aggregation(cd, "phi<0", 0.5)
    t5 = clock()
    t["aggregation"] = t5 - t4
    M = ext.extension_penalty_matrix(V, cd, agg, beta=1.0).to_scipy()
    t["penalty"] = clock() - t5
    mmax = float(np.abs(M.data).max())
    area = lambda f: float(_simplex_measure(  # noqa: E731
        mesh.vertices[mesh.facets[f]]).sum())
    return dict(
        cells=mesh.num_cells, cut_cells=int(cut_cells.size),
        skeleton_facets=int(skel.size), cut_facets=int(cut_f.size),
        inside_facets=int(in_f.size), lo_sum=sums["phi<0"],
        hi_sum=sums["phi>0"], interface_sum=sums["phi=0"],
        cut_facet_area=area(cut_f), inside_facet_area=area(in_f),
        cut_mesh_cells=int(cm.mesh.num_cells),
        cut_mesh_area=float(_simplex_measure(
            cm.mesh.vertices[cm.mesh.cells]).sum()),
        interior_cells=int(agg.interior_cells.size),
        well_posed=int(agg.well_posed_cells.size),
        ill_posed=int(agg.ill_posed_cells.size),
        rootless=int(agg.rootless_cells.size),
        max_depth=int(agg.propagation_depth.max()),
        penalty_nnz=int(M.nnz), penalty_max=mmax,
        penalty_asymmetry=float(abs(M - M.T).max()) / mmax,
        penalty_constants=float(np.abs(M @ np.ones(M.shape[0])).max())
        / mmax, seconds=t)


def _hold_pin(case, got, want, rtol):
    """Raise unless ``got`` matches a JAX-CPU pin: integers exactly, the
    rest within ``rtol`` relative (lists element by element). Returns the
    largest relative error."""
    worst = 0.0
    for key, ref in want.items():
        val = got[key]
        if isinstance(ref, int):
            if val != ref:
                raise RuntimeError(f"{case}: {key} {val}, JAX-CPU {ref}")
            continue
        err = float((np.abs(np.asarray(val, float) - ref)
                     / np.abs(np.asarray(ref, float))).max())
        if not err <= rtol:
            raise RuntimeError(f"{case}: {key} {val}, JAX-CPU {ref}")
        worst = max(worst, err)
    return worst


def _check_residual(case, residuals):
    worst = float(np.max(residuals))
    if not worst <= FLOWER_TRUE_RESIDUAL:
        raise RuntimeError(f"{case}: direct solve's true relative residual "
                           f"{worst}")
    return worst


def unfitted_demos_phase(dev, card):
    """The two demos of the unfitted-boundary surface at their scripts'
    defaults (f64) against the JAX-CPU numbers: the extension-penalty
    study (n = 24, beta = 0, 0.1, 1, 10; counts exactly, L2 errors and
    cond(active) within 1e-6 relative) and the surface DG (n = 32; counts
    exactly, the L2(Gamma) error within 1e-6 relative; tests/
    test_surface.py's gate from n = 16: error < 2e-2, rate > 1.3)."""
    from cutfemx_tpu_torch.demos import (demo_poisson_extension_penalty_study
                                         as study, demo_surface_poisson_dg
                                         as surface)
    t0 = time.perf_counter()
    out = study.run(24, device=dev)
    seconds = time.perf_counter() - t0
    worst = _hold_pin("study_24", out, JAX_CPU_UNFITTED["study_24"],
                      PINNED_RTOL)
    res = _check_residual("study_24", out["residuals"])
    _phase("unfitted_demos", case="study_24", **out, total_s=seconds,
           max_residual=res, max_rel_err_vs_jax_cpu=worst, card=card)
    errs = {}
    for n in (16, 32):
        t0 = time.perf_counter()
        out = surface.run(n, device=dev)
        seconds = time.perf_counter() - t0
        res = _check_residual(f"surface_{n}", [out["residual"]])
        worst = _hold_pin(f"surface_{n}", out,
                          JAX_CPU_UNFITTED.get(f"surface_{n}", {}),
                          PINNED_RTOL)
        errs[n] = out["l2_error"]
        _phase("unfitted_demos", case=f"surface_{n}", **out, total_s=seconds,
               max_rel_err_vs_jax_cpu=worst, card=card)
    rate = float(np.log2(errs[16] / errs[32]))
    if not (errs[32] < SURFACE_ERROR_MAX and rate > SURFACE_RATE_MIN):
        raise RuntimeError(f"surface DG: error {errs[32]}, rate {rate}")
    _phase("unfitted_demos", case="surface_rate", rate=rate, card=card)


def unfitted_large_phase(ct, dev, card):
    """The slice at full width (f64): the study's extension-penalty
    Poisson (beta = 1, no cond) at n = 128, 256, 512 and the surface DG at
    n = 256, 512, each with its time split, peak device memory and a true
    relative residual <= 1e-9 (n = 128 against the JAX-CPU pin); the
    facet-hosted rules, cut mesh, aggregation and penalty on bench.py's
    n = 48 geometry (n = 8 against the JAX-CPU pin); the compound and
    union rules at n = 1024 against the polygon areas (n = 16 against the
    JAX-CPU pin)."""
    import torch
    from cutfemx_tpu_torch.demos import (demo_poisson_extension_penalty_study
                                         as study, demo_surface_poisson_dg
                                         as surface)

    def measured(fn):
        """``fn()``, its seconds and its own peak device memory: the peak
        above what earlier phases still held when it started."""
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(dev)
        return out, dict(total_s=time.perf_counter() - t0,
                         peak_device_bytes=torch.cuda.max_memory_allocated(
                             dev) - held, held_before_bytes=held)

    errs = {}
    for n in N_STUDY_LARGE:
        out, m = measured(lambda: study.run(n, (1.0,), cond=False,
                                            device=dev))
        res = _check_residual(f"study_{n}", out["residuals"])
        pin = JAX_CPU_UNFITTED.get(f"study_{n}")
        worst = _hold_pin(f"study_{n}", out, pin, PINNED_RTOL) if pin \
            else None
        errs[n] = out["l2_errors"][0]
        _phase("unfitted_large", case=f"study_{n}", **out, **m,
               max_residual=res, max_rel_err_vs_jax_cpu=worst,
               host_stages=["cut", "aggregation", "assemble_matrix CSR",
                            "penalty CSR", "deactivate_outside",
                            "direct_solve"], card=card)
    _phase("unfitted_large", case="study_rates", rates=[
        float(np.log2(errs[c] / errs[f]))
        for c, f in zip(N_STUDY_LARGE, N_STUDY_LARGE[1:])], card=card)
    errs = {}
    for n in N_SURFACE_LARGE:
        out, m = measured(lambda: surface.run(n, device=dev))
        res = _check_residual(f"surface_{n}", [out["residual"]])
        errs[n] = out["l2_error"]
        _phase("unfitted_large", case=f"surface_{n}", **out, **m,
               host_stages=["cut", "assemble_matrix CSR",
                            "deactivate_outside", "direct_solve"],
               card=card)
    c, f = N_SURFACE_LARGE
    _phase("unfitted_large", case="surface_rate",
           rate=float(np.log2(errs[c] / errs[f])), card=card)

    for n in (8, N_FACET_3D):
        out, m = measured(lambda: facet_3d_numbers(ct, n, dev))
        parts = out["lo_sum"] + out["hi_sum"]
        checks = dict(
            parts_vs_facet_area=abs(parts - out["cut_facet_area"])
            / out["cut_facet_area"],
            cut_mesh_vs_rules=abs(out["cut_mesh_area"] - out["lo_sum"]
                                  - out["inside_facet_area"])
            / out["cut_mesh_area"])
        if not (checks["parts_vs_facet_area"] <= FACET_AREA_RTOL
                and checks["cut_mesh_vs_rules"] <= CUT_MESH_AREA_RTOL
                and out["rootless"] == 0
                and out["penalty_asymmetry"] <= PENALTY_SYM_RTOL
                and out["penalty_constants"] <= PENALTY_CONST_RTOL):
            raise RuntimeError(f"facet_3d n={n}: {out}, {checks}")
        pin = JAX_CPU_UNFITTED.get(f"facet_3d_{n}")
        worst = _hold_pin(f"facet_3d_{n}", out, pin, PIN_SUM_RTOL) if pin \
            else None
        _phase("unfitted_large", case=f"facet_3d_{n}", **out, **checks, **m,
               max_rel_err_vs_jax_cpu=worst,
               host_stages=["cut", "interior_facets_for_cells",
                            "aggregation sweep", "penalty CSR"], card=card)

    for n in (16, N_COMPOUND):
        out, m = measured(lambda: compound_numbers(ct, n, dev))
        checks = {f"{k}_vs_polygon": abs(out[f"{k}_total"]
                                         - out[f"{k}_polygon"])
                  / out[f"{k}_polygon"] for k in ("and", "or")}
        if not max(checks.values()) <= POLYGON_RTOL:
            raise RuntimeError(f"compound n={n}: {out}")
        pin = JAX_CPU_UNFITTED.get(f"compound_{n}")
        worst = _hold_pin(f"compound_{n}", out, pin, PIN_SUM_RTOL) if pin \
            else None
        _phase("unfitted_large", case=f"compound_{n}", **out, **checks, **m,
               max_rel_err_vs_jax_cpu=worst, card=card)

# -- higher-order cut geometry (ROADMAP item 10) ------------------------------


def _f64_kw(pkg, device):
    """(space kwargs, function kwargs) of an f64 problem in ``pkg``: the
    port takes ``device`` and torch.float64, the reference (x64 on) its
    defaults."""
    if not pkg.__name__.endswith("_torch"):
        return {}, {}
    import torch
    return {"device": device}, {"dtype": torch.float64}


def _form_dtype(pkg):
    if not pkg.__name__.endswith("_torch"):
        return np.float64
    import torch
    return torch.float64


def _sphere(radius, center=0.0):
    def level_set(x):
        return np.sqrt(sum((xi - center) ** 2 for xi in x)) - radius
    return level_set


def ho_mesh_phi(pkg, n, cell_type, phi_degree, level_set, *, device=None,
                phi_dtype=None):
    """The [-1, 1]^d mesh of ``cell_type`` (n per side) and the level set
    interpolated into degree ``phi_degree`` (f64 unless ``phi_dtype``)."""
    skw, fkw = _f64_kw(pkg, device)
    if phi_dtype is not None:
        fkw = {"dtype": phi_dtype}
    if cell_type in ("triangle", "quadrilateral"):
        mesh = pkg.mesh.create_rectangle((-1.0, -1.0), (1.0, 1.0), (n, n),
                                         cell_type=cell_type)
    else:
        mesh = pkg.mesh.create_box((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0),
                                   (n, n, n), cell_type=cell_type)
    Vphi = pkg.functionspace(mesh, ("Lagrange", phi_degree), **skw)
    phi = pkg.Function(Vphi, name="phi", **fkw)
    phi.interpolate(level_set)
    return mesh, phi


def cut_measures(pkg, mesh, phi, order, *, cut_kw=None, backend="straight"):
    """|{phi < 0}| (the inside cells and the cut rules, by assemble_scalar)
    and |{phi = 0}| (the sum of the interface weights) in f64, with the
    rules' nonzero point counts."""
    import importlib
    fem = importlib.import_module(pkg.__name__ + ".fem")
    Measure = importlib.import_module(pkg.__name__ + ".forms.measure").Measure
    cd = pkg.cut(phi, **(cut_kw or {}))
    inside = pkg.locate_entities(cd, "phi<0")
    vol = pkg.runtime_quadrature(cd, "phi<0", order, backend=backend)
    srf = pkg.runtime_quadrature(cd, "phi=0", order, backend=backend)
    dx = Measure("dx", domain=mesh, subdomain_data=[inside, vol])
    volume = float(fem.assemble_scalar(fem.form(1.0 * dx,
                                                dtype=_form_dtype(pkg))))
    ws = _host(srf.weights_padded)
    return dict(volume=volume, area=float(ws.sum()),
                volume_points=int((_host(vol.weights_padded) != 0).sum()),
                area_points=int((ws != 0).sum()))


def sphere_poisson(pkg, n, cell_type, phi_degree, degree, *, device=None,
                   **forms_kw):
    """bench.py's Poisson problem (poisson_forms) on the n^3 box of
    ``cell_type`` with the bench sphere interpolated into degree
    ``phi_degree``, in f64, solved directly on the host (assemble_matrix,
    deactivate_outside, SciPy): its L2 error, true relative residual and
    sizes."""
    import importlib
    fem = importlib.import_module(pkg.__name__ + ".fem")
    la = importlib.import_module(pkg.__name__ + ".la")
    skw, _ = _f64_kw(pkg, device)
    mesh, phi = ho_mesh_phi(pkg, n, cell_type, phi_degree, _sphere(RADIUS),
                            device=device)
    V = pkg.functionspace(mesh, ("Lagrange", degree), **skw)
    P = poisson_forms(pkg, mesh, phi, V, _form_dtype(pkg), **forms_kw)
    A = fem.assemble_matrix(P["af"])
    b = np.array(_host(P["b"]), dtype=np.float64)
    fem.deactivate_outside(A, b, P["dom"])
    x = la.direct_solve(A, b)
    P.update(V=V, mesh=mesh, phi=phi)
    return dict(l2_error=l2_error(pkg, P, x),
                true_rel_residual=csr_true_rel_residual(A, x, b),
                dofs=int(V.dim), cut_cells=int(len(P["srf"].parent_map)))


def l2_error(pkg, P, x):
    """||uh - u|| over {phi < 0} of the dofs ``x`` (numpy or a tensor) by
    assemble_scalar in f64."""
    import importlib
    fem = importlib.import_module(pkg.__name__ + ".fem")
    d = importlib.import_module(pkg.__name__ + ".forms.dsl")
    _, fkw = _f64_kw(pkg, None)
    uh = pkg.Function(P["V"], **fkw)
    if pkg.__name__.endswith("_torch"):
        import torch
        uh.x = torch.as_tensor(_host(x), dtype=torch.float64,
                               device=P["phi"].x.device)
    else:
        uh.x = np.asarray(_host(x), dtype=np.float64)
    err = d.CoefficientExpr(uh) - P["ue"]
    sq = float(fem.assemble_scalar(fem.form(err * err * P["dxo"],
                                            dtype=_form_dtype(pkg))))
    return float(np.sqrt(max(sq, 0.0)))


def curved_numbers(pkg, n=N_CURVED_PARITY, device=None):
    """The bench sphere as a P2 level set on the n^3 tets (f64): volume and
    area by the curved rules (cut_approximation_order=2) and by the
    default red-refined ones ('auto': two levels), and the Poisson L2
    error of bench.py's problem (P2) on the curved rules."""
    out = {}
    for name, cut_kw in (("curved", CURVED_CUT), ("auto", {})):
        mesh, phi = ho_mesh_phi(pkg, n, "tetrahedron", 2, _sphere(RADIUS),
                                device=device)
        m = cut_measures(pkg, mesh, phi, 2 * DEGREE, cut_kw=cut_kw)
        out.update({f"{name}_{k}": v for k, v in m.items()})
    P = sphere_poisson(pkg, n, "tetrahedron", 2, DEGREE, device=device,
                       cut_kw=CURVED_CUT)
    out.update({f"poisson_{k}": v for k, v in P.items()})
    return out


def saye_numbers(pkg, device=None):
    """Saye's rules (backend="algoim") in f64: the tests/test_saye.py
    circle on n = 16 quads as a Q1 and a Q2 level set, and the bench
    sphere as a Q2 level set on n = 8 hexahedra (area or volume, and
    perimeter or area); and the Poisson L2 error of bench.py's problem
    (Q1) on the hexahedra with Saye's rules."""
    out = {}
    for deg in (1, 2):
        mesh, phi = ho_mesh_phi(pkg, N_SAYE_QUAD, "quadrilateral", deg,
                                _sphere(CIRCLE_RADIUS), device=device)
        m = cut_measures(pkg, mesh, phi, SAYE_ORDER, backend="algoim")
        out.update({f"quad_q{deg}_{k}": v for k, v in m.items()})
    mesh, phi = ho_mesh_phi(pkg, N_SAYE_HEX, "hexahedron", 2,
                            _sphere(RADIUS), device=device)
    m = cut_measures(pkg, mesh, phi, SAYE_ORDER, backend="algoim")
    out.update({f"hex_q2_{k}": v for k, v in m.items()})
    P = sphere_poisson(pkg, N_SAYE_HEX, "hexahedron", 2, 1, device=device,
                       backend="algoim", order=SAYE_ORDER)
    out.update({f"poisson_{k}": v for k, v in P.items()})
    return out


def _hold_ho(case, out, want):
    """Hold the float numbers of a higher-order parity phase to their
    JAX-CPU pins (HIGHER_ORDER_RTOL relative), the point counts and sizes
    exactly."""
    if not want:
        raise RuntimeError(f"{case}: no JAX-CPU pins")
    return _hold_pin(case, {k: out[k] for k in want}, want,
                     HIGHER_ORDER_RTOL)


def curved_parity_phase(dev, card):
    """curved_numbers at n = 8 on the card against the JAX-CPU pins."""
    t0 = time.perf_counter()
    out = curved_numbers(_import_port(), device=dev)
    worst = _hold_ho("curved_parity", out, JAX_CPU_CURVED)
    _check_residual("curved_parity", [out["poisson_true_rel_residual"]])
    _phase("curved_parity", n=N_CURVED_PARITY, **out,
           max_rel_err_vs_jax_cpu=worst, seconds=time.perf_counter() - t0,
           card=card)


def saye_parity_phase(dev, card):
    """saye_numbers on the card against the JAX-CPU pins."""
    t0 = time.perf_counter()
    out = saye_numbers(_import_port(), device=dev)
    worst = _hold_ho("saye_parity", out, JAX_CPU_SAYE)
    _check_residual("saye_parity", [out["poisson_true_rel_residual"]])
    _phase("saye_parity", **out, max_rel_err_vs_jax_cpu=worst,
           seconds=time.perf_counter() - t0, card=card)


def curved_bench_phase(ct, dev, card, sizes=(N_SLICE,)):
    """bench.py's step with the P2 sphere on the curved path
    (cut_approximation_order=2) through StencilCutOperator.solve_cg(
    precond="pallas"): a warm-up and a timed pass at each size, K1
    launched once per operator apply, a true relative residual <= 1e-6
    and, at n = 48, the JAX-CPU iteration count exactly. Then, at each
    size, the default 'auto' cut of the same level set (two
    red-refinement levels) through rules and forms only: its point count
    and peak memory. Returns K1's launches in the timed passes."""
    import torch
    from cutfemx_tpu_torch import interior_stencil as ist
    total = 0
    for n in sizes:
        t0 = time.perf_counter()
        mesh, phi, V = setup(ct, n, dev, torch.float32, phi_degree=2)
        host_setup_s = time.perf_counter() - t0
        for name in ("warmup", "timed"):
            torch.cuda.reset_peak_memory_stats(dev)
            before = ist.launches
            with count_applies() as applies:
                run = pipeline(ct, mesh, phi, V, torch.float32,
                               precond="pallas", cut_kw=CURVED_CUT)
            launches = ist.launches - before
            x, op, F = run["x"], run["op"], run["forms"]
            rel = true_rel_residual(op, run["b"], x)
            if not (torch.isfinite(x).all() and x.shape == (V.dim,)):
                raise RuntimeError(f"curved n={n}: non-finite or misshapen "
                                   "solution")
            if not rel <= RTOL:
                raise RuntimeError(f"curved n={n}: true relative residual "
                                   f"{rel} > {RTOL}")
            if not launches == applies.n > run["its"]:
                raise RuntimeError(f"curved n={n}: {launches} K1 launches "
                                   f"for {applies.n} applies")
            nums = dict(
                n=n, dofs=V.dim, phi_dofs=phi.function_space.dim,
                cut_cells=int(len(F["srf"].parent_map)),
                volume_points=int((F["vol"].weights_padded != 0).sum()),
                interface_points=int((F["srf"].weights_padded != 0).sum()),
                iterations=run["its"], true_rel_residual=rel,
                launches=launches, applies=applies.n,
                host_setup_s=host_setup_s, cut_s=F["cut_s"],
                rules_s=F["rules_s"], forms_s=F["forms_s"],
                operator_s=run["operator_s"], solve_s=run["solve_s"],
                total_s=run["total_s"],
                peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 2 ** 30)
            if n == N_SLICE:
                pin = JAX_CPU_ITERATIONS_N48_CURVED
                if run["its"] != pin:
                    raise RuntimeError(f"curved: {run['its']} iterations, "
                                       f"JAX-CPU {pin}")
                nums.update(jax_cpu_iterations=pin)
            _phase("curved_bench", **{"pass": name}, **nums, card=card)
            if name == "timed":
                total += launches
            del run, x, op, F
        curved_auto_pass(ct, dev, n, mesh, phi, V, card)
        del mesh, phi, V
    return total


def curved_auto_pass(ct, dev, n, mesh, phi, V, card):
    """The default cut of the P2 level set (cut_approximation='auto': two
    red-refinement levels) through rules and forms: point counts, stage
    seconds and peak device memory above what was held at its start."""
    import torch
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    F = poisson_forms(ct, mesh, phi, V, torch.float32)
    _phase("curved_auto", n=n, cut_cells=int(len(F["srf"].parent_map)),
           volume_points=int((F["vol"].weights_padded != 0).sum()),
           interface_points=int((F["srf"].weights_padded != 0).sum()),
           volume_points_padded=int(F["vol"].weights_padded.numel()),
           interface_points_padded=int(F["srf"].weights_padded.numel()),
           cut_s=F["cut_s"], rules_s=F["rules_s"], forms_s=F["forms_s"],
           held_before_bytes=held,
           card_total_bytes=torch.cuda.get_device_properties(dev)
           .total_memory,
           peak_mem_gb=(torch.cuda.max_memory_allocated(dev) - held)
           / 2 ** 30, card=card)


def saye_large_phase(ct, dev, card):
    """A cut Poisson problem on create_box hexahedra at n = 24 and 48: the
    bench sphere as a Q2 level set, V = Q1, bench.py's Nitsche and
    ghost-penalty forms on Saye's rules (backend="algoim"), solved by
    fem.CutOperator.solve_cg with Jacobi in f64. Per size: the box
    grouping's host seconds and the rules' rest, what the grouping
    decided, forms, operator and solve seconds, the true relative residual
    and the L2 error; then the rate, which must be >= 1.8."""
    import torch
    from cutfemx_tpu_torch import fem
    errs = {}
    for n in N_SAYE_LARGE:
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        mesh, phi = ho_mesh_phi(ct, n, "hexahedron", 2, _sphere(RADIUS),
                                device=dev)
        V = ct.functionspace(mesh, ("Lagrange", 1), device=dev)
        _ = mesh.facets
        host_setup_s = time.perf_counter() - t0
        P = poisson_forms(ct, mesh, phi, V, torch.float64, backend="algoim",
                          order=SAYE_ORDER)
        P.update(V=V, mesh=mesh, phi=phi)
        t1 = time.perf_counter()
        op = fem.CutOperator(P["af"], P["dom"])
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        x, its, _ = op.solve_cg(P["b"], rtol=SAYE_CG_RTOL,
                                maxiter=FLOWER_CG_MAXITER, precond="jacobi")
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        bb = torch.where(op.active, P["b"], 0.0)
        r = torch.where(op.active, bb - op(x), 0.0)
        rel = float(torch.linalg.norm(r) / torch.linalg.norm(bb))
        if not (torch.isfinite(x).all() and int(its) < FLOWER_CG_MAXITER
                and rel <= FLOWER_TRUE_RESIDUAL):
            raise RuntimeError(f"saye n={n}: CG {its} iterations, true "
                               f"relative residual {rel}")
        errs[n] = l2_error(ct, P, x)
        sv, ss = P["vol"].saye_stats, P["srf"].saye_stats
        grouping_s = sv["box_grouping_s"] + ss["box_grouping_s"]
        _phase("saye_large", n=n, cells=mesh.num_cells, dofs=V.dim,
               cut_cells=int(len(P["srf"].parent_map)),
               volume_points=int((P["vol"].weights_padded != 0).sum()),
               interface_points=int((P["srf"].weights_padded != 0).sum()),
               volume_points_padded=int(P["vol"].weights_padded.numel()),
               grouping=sv, host_setup_s=host_setup_s, cut_s=P["cut_s"],
               rules_s=P["rules_s"], box_grouping_host_s=grouping_s,
               rules_rest_s=P["rules_s"] - grouping_s,
               forms_s=P["forms_s"], operator_s=t2 - t1,
               solve_s=t3 - t2, iterations=int(its),
               true_rel_residual=rel, l2_error=errs[n],
               held_before_bytes=held,
               peak_mem_gb=(torch.cuda.max_memory_allocated(dev) - held)
               / 2 ** 30, card=card)
        del P, op, x, mesh, phi, V
    coarse, fine = N_SAYE_LARGE
    rate = float(np.log(errs[coarse] / errs[fine]) / np.log(fine / coarse))
    if not rate >= SAYE_RATE_MIN:
        raise RuntimeError(f"saye: L2 rate {rate} < {SAYE_RATE_MIN}")
    _phase("saye_rate", n_coarse=coarse, n_fine=fine, rate=rate, card=card)


# -- the rest of the single-card surface (io, petsc, profiling, complex
#    forms, vertex and ridge measures) --------------------------------------


def setup_cache_pass(ct, dev, n, card):
    """bench.py's host setup at ``n`` built, saved by io.save_setup_cache
    and loaded back onto the card by io.load_setup_cache; then the
    'pallas' step (each from a cleared build cache) on the built objects
    and on the loaded ones. Gates: the loaded step takes the reference's
    count exactly, at a true relative residual <= RTOL, with one K1 launch
    per operator apply, and its solution equals the built step's bitwise.
    Returns the loaded step's pass and its K1 launches (counted from 0
    just before the step and read just after it, before its true-residual
    check)."""
    import tempfile
    import torch
    from cutfemx_tpu_torch import interior_stencil as ist
    from cutfemx_tpu_torch import io as cio
    from cutfemx_tpu_torch import stencil as st
    t0 = time.perf_counter()
    mesh, phi, V = setup(ct, n, dev, torch.float32)
    built_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        cio.save_setup_cache(d, mesh, [phi.function_space, V])
        save_s = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(os.path.join(d, f))
                     for f in os.listdir(d))
        t0 = time.perf_counter()
        loaded = cio.load_setup_cache(d, device=dev)
        if loaded is None:
            raise RuntimeError(f"n={n}: load_setup_cache found no cache")
        mesh2, (Vphi2, V2) = loaded
        phi2 = ct.Function(Vphi2, name="phi", dtype=torch.float32)
        phi2.interpolate(_sphere(RADIUS))
        loaded_s = time.perf_counter() - t0
    for got, want in ((Vphi2, phi.function_space), (V2, V)):
        if not (got.device == want.device
                and np.array_equal(got.dofmap, want.dofmap)
                and got.dim == want.dim):
            raise RuntimeError(f"n={n}: a loaded space differs from the "
                               f"built one (device {got.device})")
    if not torch.equal(phi2.x, phi.x):
        raise RuntimeError(f"n={n}: the level set on the loaded mesh "
                           "differs from the built one")
    st._BUILD_CACHE.clear()
    built = stack_pass(ct, dev, mesh, phi, V, "setup_cache_built", n)
    x_built, its_built = built["x"], built["iterations"]
    del built, mesh, phi, V
    st._BUILD_CACHE.clear()
    ist.launches = 0
    run = stack_pass(ct, dev, mesh2, phi2, V2, "setup_cache_loaded", n)
    launches = run["launches"]          # the step's own, one per apply
    want = SETUP_CACHE_ITERATIONS[n]
    if not run["iterations"] == its_built == want:
        raise RuntimeError(f"n={n}: the loaded step took {run['iterations']}"
                           f" iterations, the built one {its_built}, the "
                           f"reference {want}")
    if not torch.equal(run["x"], x_built):
        diff = float((run["x"] - x_built).abs().max())
        raise RuntimeError(f"n={n}: the loaded step's solution differs "
                           f"from the built one's (max |dx| {diff})")
    _phase("surface_io", part="setup_cache", n=n, dofs=V2.dim,
           host_setup_built_s=built_s, cache_save_s=save_s,
           host_setup_loaded_s=loaded_s, cache_bytes=nbytes,
           iterations=run["iterations"], reference_iterations=want,
           true_rel_residual=run["true_rel_residual"],
           k1_launches=launches, applies=run["applies"],
           forms_s=run["forms_s"], operator_s=run["operator_s"],
           solve_s=run["solve_s"], build_s=run["build_s"], cg_s=run["cg_s"],
           total_s=run["total_s"], bitwise_equal_to_built=True, card=card)
    return run, launches


def c5_c6_checks(run, card):
    """On the loaded n = 48 step: the compact views of its volume and
    interface rules (``total_points`` = the nonzero weights, a lazy
    ``physical_points``) and StencilCutOperator taking a numpy right-hand
    side (solve_cg and the apply equal the tensor calls bitwise)."""
    import torch
    out = {}
    for name in ("vol", "srf"):
        rules = run["forms"][name]
        nonzero = int((rules.weights_padded != 0).sum())
        lazy = rules._physical_points is None
        pts = rules.with_physical_points().physical_points
        if not (lazy and rules.total_points == nonzero == pts.shape[1]
                and pts.shape[0] == 3 and np.isfinite(pts).all()
                and rules.offsets[-1] == nonzero):
            raise RuntimeError(f"c5: {name} rules: total_points "
                               f"{rules.total_points}, nonzero weights "
                               f"{nonzero}, physical_points {pts.shape}, "
                               f"lazy {lazy}")
        out[f"{name}_total_points"] = nonzero
        out[f"{name}_max_radius"] = float(np.linalg.norm(pts, axis=0).max())
    op, b = run["op"], run["b"]
    x_t, it_t, _ = op.solve_cg(b, rtol=RTOL, maxiter=MAXITER,
                               precond="pallas")
    x_n, it_n, _ = op.solve_cg(b.cpu().numpy(), rtol=RTOL, maxiter=MAXITER,
                               precond="pallas")
    y_t, y_n = op(x_t), op(x_t.cpu().numpy())
    if not (it_t == it_n and torch.equal(x_t, x_n) and torch.equal(y_t, y_n)):
        raise RuntimeError(f"c6: a numpy b gives {it_n} iterations against "
                           f"{it_t}, or another solution or apply")
    _phase("surface_io", part="c5_c6", **out, solve_iterations=int(it_t),
           numpy_b_bitwise=True, card=card)


def _complex_kw(pkg, device):
    """(complex128 dtype, host array -> the package's vector) of ``pkg``:
    torch's on ``device`` for the port, numpy's for the reference (which
    takes numpy arrays and dtypes)."""
    if not pkg.__name__.endswith("_torch"):
        return np.complex128, np.asarray
    import torch
    return torch.complex128, lambda a: torch.as_tensor(a, device=device)


def complex_cases(pkg, n_helm, n_runtime, device=None):
    """tests/test_complex_assembly.py's two cases in ``pkg`` (x64 for the
    reference; the port on ``device``), at sizes ``n_helm`` and
    ``n_runtime``: the complex Helmholtz matrix with its real and
    imaginary parts assembled as real forms, and a complex P2 coefficient
    through full-cell runtime rules and through standard rules (matrix,
    vector, scalar). Host SciPy matrices and numpy arrays."""
    import importlib
    fem = importlib.import_module(pkg.__name__ + ".fem")
    d = importlib.import_module(pkg.__name__ + ".forms.dsl")
    Measure = importlib.import_module(pkg.__name__ + ".forms.measure").Measure
    full_cell_rules = importlib.import_module(
        pkg.__name__ + ".cut.quadrature").full_cell_rules
    skw, _ = _f64_kw(pkg, device)
    cdt, to_dev = _complex_kw(pkg, device)
    rkw = skw
    mesh = pkg.mesh.create_unit_square(n_helm)
    V = pkg.functionspace(mesh, ("Lagrange", 1), **skw)
    u, v = d.TrialFunction(V), d.TestFunction(V)
    dxs = Measure("dx", domain=mesh, metadata={"quadrature_degree": 2})
    k2 = 1.0 + 2.0j
    out = {"helmholtz": fem.assemble_matrix(fem.form(
        d.inner(d.grad(u), d.grad(v)) * dxs - k2 * u * v * dxs,
        dtype=cdt)).to_scipy()}
    real = _form_dtype(pkg)
    out["helmholtz_real"] = fem.assemble_matrix(fem.form(
        d.inner(d.grad(u), d.grad(v)) * dxs - 1.0 * u * v * dxs,
        dtype=real)).to_scipy()
    out["helmholtz_imag"] = fem.assemble_matrix(fem.form(
        -2.0 * u * v * dxs, dtype=real)).to_scipy()

    mesh = pkg.mesh.create_unit_square(n_runtime)
    V = pkg.functionspace(mesh, ("Lagrange", 2), **skw)
    u, v = d.TrialFunction(V), d.TestFunction(V)
    rules = full_cell_rules(mesh, np.arange(mesh.num_cells), 4, **rkw)
    dxr = Measure("dx", domain=mesh, subdomain_data=rules,
                  metadata={"quadrature_degree": 4})
    dxs = Measure("dx", domain=mesh, metadata={"quadrature_degree": 4})
    f = pkg.Function(V, dtype=cdt)
    f.x = to_dev(np.random.default_rng(0).standard_normal(V.dim)
                 + 1j * np.random.default_rng(1).standard_normal(V.dim))
    c = d.CoefficientExpr(f)
    for tag, dxm in (("runtime", dxr), ("standard", dxs)):
        out[f"{tag}_matrix"] = fem.assemble_matrix(
            fem.form(c * u * v * dxm, dtype=cdt)).to_scipy()
        out[f"{tag}_vector"] = np.array(_host(fem.assemble_vector(
            fem.form(c * v * dxm, dtype=cdt))))
        out[f"{tag}_scalar"] = complex(_host(fem.assemble_scalar(
            fem.form(c * dxm, dtype=cdt))))
    return out


def hold_complex_cases(out):
    """The gates of tests/test_complex_assembly.py on complex_cases'
    output: -> the largest error of each comparison."""
    A = out["helmholtz"]
    errs = dict(
        helmholtz_real=abs(A.real - out["helmholtz_real"]).max(),
        helmholtz_imag=abs(A.imag - out["helmholtz_imag"]).max(),
        runtime_matrix=abs(out["runtime_matrix"]
                           - out["standard_matrix"]).max(),
        runtime_vector=np.abs(out["runtime_vector"]
                              - out["standard_vector"]).max(),
        runtime_scalar=abs(out["runtime_scalar"] - out["standard_scalar"]))
    tols = dict(helmholtz_real=COMPLEX_SPLIT_TOL,
                helmholtz_imag=COMPLEX_SPLIT_TOL,
                runtime_matrix=COMPLEX_RUNTIME_TOL,
                runtime_vector=COMPLEX_SPLIT_TOL,
                runtime_scalar=COMPLEX_SPLIT_TOL)
    errs = {k: float(v) for k, v in errs.items()}
    for k, err in errs.items():
        if not err <= tols[k]:
            raise RuntimeError(f"complex {k}: {err} > {tols[k]}")
    return errs


def hermitian_cg(pkg, n, device=None):
    """A Hermitian positive-definite complex system on the n x n unit
    square in P1: stiffness + mass + 0.5i (u_x v - u v_x) (real part
    symmetric, imaginary part antisymmetric; the skew term is bounded by
    half the real part), solved by ``la.cg`` on the element-batched
    CutOperator to rtol HERMITIAN_CG_RTOL from a seeded right-hand side.
    -> (host CSR, b, x, iterations)."""
    import importlib
    fem = importlib.import_module(pkg.__name__ + ".fem")
    la = importlib.import_module(pkg.__name__ + ".la")
    d = importlib.import_module(pkg.__name__ + ".forms.dsl")
    Measure = importlib.import_module(pkg.__name__ + ".forms.measure").Measure
    skw, _ = _f64_kw(pkg, device)
    cdt, to_dev = _complex_kw(pkg, device)
    mesh = pkg.mesh.create_unit_square(n)
    V = pkg.functionspace(mesh, ("Lagrange", 1), **skw)
    u, v = d.TrialFunction(V), d.TestFunction(V)
    dx = Measure("dx", domain=mesh)
    a = (d.inner(d.grad(u), d.grad(v)) + u * v
         + 0.5j * (d.grad(u)[0] * v - u * d.grad(v)[0])) * dx
    af = fem.form(a, dtype=cdt)
    rng = np.random.default_rng(3)
    b = rng.standard_normal(V.dim) + 1j * rng.standard_normal(V.dim)
    x, its, _ = la.cg(fem.CutOperator(af), to_dev(b),
                      rtol=HERMITIAN_CG_RTOL, maxiter=5000)
    return fem.assemble_matrix(af).to_scipy(), b, _host(x), int(its)


def vertex_ridge_cases(pkg, device=None):
    """The nine cases of tests/test_vertex_ridge.py in ``pkg`` (f64; the
    port on ``device``): case -> (value, exact value) as numpy arrays.
    ``vertex_requires_entities`` is 1.0 when the form raised ValueError."""
    import importlib
    fem = importlib.import_module(pkg.__name__ + ".fem")
    d = importlib.import_module(pkg.__name__ + ".forms.dsl")
    Measure = importlib.import_module(pkg.__name__ + ".forms.measure").Measure
    skw, fkw = _f64_kw(pkg, device)

    def form(expr):      # a form with no argument names no device
        return fem.form(expr, dtype=_form_dtype(pkg), **skw)

    def rect(n):
        return pkg.mesh.create_rectangle((0, 0), (1, 1), (n, n))

    def box(n):
        return pkg.mesh.create_box((0, 0, 0), (1, 1, 1), (n, n, n))

    def scalar(expr):
        return np.array(float(_host(fem.assemble_scalar(form(expr)))))

    def x_axis_edges(mesh):
        ev, xy = np.asarray(mesh.edges), np.asarray(mesh.vertices)
        on = (np.abs(xy[:, 1]) < 1e-12) & (np.abs(xy[:, 2]) < 1e-12)
        return np.flatnonzero(on[ev[:, 0]] & on[ev[:, 1]])

    out = {}
    mesh = rect(4)
    verts = np.array([0, 7, 12], np.int64)
    xy = np.asarray(mesh.vertices)[verts]
    x = d.SpatialCoordinate(mesh)
    dP = Measure("dP", domain=mesh, subdomain_data=verts)
    out["vertex_functional"] = (scalar((x[0] ** 2 + 3.0 * x[1]) * dP),
                                np.array((xy[:, 0] ** 2 + 3 * xy[:, 1]).sum()))

    mesh = rect(3)
    V = pkg.functionspace(mesh, ("Lagrange", 1), **skw)
    verts = np.array([5, 9], np.int64)
    u, v = d.TrialFunction(V), d.TestFunction(V)
    x = d.SpatialCoordinate(mesh)
    dP = Measure("dP", domain=mesh, subdomain_data=verts)
    b = np.array(_host(fem.assemble_vector(form((x[0] + 2.0) * v * dP))))
    exact = np.zeros(V.dim)
    exact[verts] = np.asarray(mesh.vertices)[verts, 0] + 2.0
    out["vertex_load_vector"] = (b, exact)
    verts = np.array([2, 11], np.int64)
    dP = Measure("dP", domain=mesh, subdomain_data=verts)
    A = fem.assemble_matrix(form(u * v * dP)).to_dense()
    exact = np.zeros_like(A)
    exact[verts, verts] = 1.0
    out["vertex_mass_matrix"] = (np.asarray(A), exact)

    V2 = pkg.functionspace(mesh, ("Lagrange", 2), **skw)
    f = pkg.Function(V2, **fkw)
    f.interpolate(lambda x: x[0] ** 2 - x[1] ** 2 + 0.5)
    verts = np.array([4, 8], np.int64)
    xy = np.asarray(mesh.vertices)[verts]
    dP = Measure("dP", domain=mesh, subdomain_data=verts)
    out["vertex_p2_point_evaluation"] = (
        scalar(d.CoefficientExpr(f) * dP),
        np.array((xy[:, 0] ** 2 - xy[:, 1] ** 2 + 0.5).sum()))

    mesh = box(3)
    dr = Measure("dr", domain=mesh, subdomain_data=x_axis_edges(mesh))
    out["ridge_length_3d"] = (
        scalar((d.SpatialCoordinate(mesh)[0] * 0 + 1.0) * dr),
        np.array(1.0))
    mesh = box(2)
    edges = x_axis_edges(mesh)
    dr = Measure("dr", domain=mesh, subdomain_data=edges,
                 metadata={"quadrature_degree": 3})
    out["ridge_polynomial_3d"] = (
        scalar(d.SpatialCoordinate(mesh)[0] ** 3 * dr), np.array(0.25))
    V = pkg.functionspace(mesh, ("Lagrange", 1), **skw)
    dr = Measure("dr", domain=mesh, subdomain_data=edges)
    b = np.array(_host(fem.assemble_vector(
        form((1.0 * d.TestFunction(V)) * dr))))
    xyz = np.asarray(mesh.vertices)
    on = (np.abs(xyz[:, 1]) < 1e-12) & (np.abs(xyz[:, 2]) < 1e-12)
    out["ridge_rank1_3d"] = (np.array([b.sum(), np.abs(b[~on]).max()]),
                             np.array([1.0, 0.0]))

    mesh = rect(3)
    verts = np.array([1, 6], np.int64)
    dr = Measure("dr", domain=mesh, subdomain_data=verts)
    xy = np.asarray(mesh.vertices)[verts]
    out["ridge_2d_falls_back_to_vertices"] = (
        scalar((d.SpatialCoordinate(mesh)[0] + 1.0) * dr),
        np.array((xy[:, 0] + 1.0).sum()))
    mesh = rect(2)
    try:
        form(d.SpatialCoordinate(mesh)[0] * Measure("dP", domain=mesh))
        raised = 0.0
    except ValueError:
        raised = 1.0
    out["vertex_requires_entities"] = (np.array(raised), np.array(1.0))
    return out


def petsc_profiling_checks(dev):
    """The petsc layer on the flower problem at N_PETSC_FLOWER:
    petsc.assemble_matrix and assemble_vector equal fem's exactly, and
    deactivate_outside through petsc (matrix + numpy vector) equals fem's.
    -> the numbers of the part."""
    from cutfemx_tpu_torch import fem, petsc
    from cutfemx_tpu_torch.demos import demo_poisson
    from cutfemx_tpu_torch.forms.dsl import TestFunction
    P = demo_poisson.problem(N_PETSC_FLOWER, device=dev)
    a, dom = P["a_form"], P["domain"]
    A1, A2 = fem.assemble_matrix(a), petsc.assemble_matrix(a)
    L = fem.form(1.0 * TestFunction(P["V"]) * P["dx_omega"],
                 dtype=P["b"].dtype)
    b1, b2 = _host(fem.assemble_vector(L)), petsc.assemble_vector(L)
    if abs(A1.to_scipy() - A2.to_scipy()).max() != 0 or \
            not np.array_equal(b1, b2):
        raise RuntimeError("petsc: assembly differs from fem's")
    b3 = _host(P["b"]).copy()
    if petsc.deactivate_outside(A2, b3, dom) is not dom:
        raise RuntimeError("petsc.deactivate_outside returned no domain")
    A1, b4 = fem.deactivate_outside(A1, P["b"], dom)
    if abs(A1.to_scipy() - A2.to_scipy()).max() != 0 or \
            not np.array_equal(b3, _host(b4)):
        raise RuntimeError("petsc: deactivate_outside differs from fem's")
    return dict(dofs=P["V"].dim, nnz=int(A2.to_scipy().nnz),
                inactive_dofs=int(dom.inactive_dofs.size),
                zero_rows=int(petsc.zero_rows(A2).size))


def surface_io_phase(ct, dev, card, sizes=(N_SLICE,)):
    """The rest of the single-card surface: the setup cache driving the
    step at each of ``sizes`` (K1 on it; its launches are returned), then
    C5/C6, complex forms, vertex and ridge measures, petsc and profiling
    (no K1). Each part runs inside a profiling.Timer span, and the
    registry must hold every span at the end."""
    from cutfemx_tpu_torch import interior_stencil as ist
    from cutfemx_tpu_torch import profiling
    profiling.reset_timings()
    spans = []

    def span(name):
        spans.append(name)
        return profiling.Timer(f"surface_io.{name}", log=False)

    launches = 0
    for n in sizes:
        with span(f"setup_cache_n{n}"):
            run, k1 = setup_cache_pass(ct, dev, n, card)
        launches += k1
        if n == N_SLICE:
            with span("c5_c6"):
                c5_c6_checks(run, card)
        del run
    before = ist.launches
    with span("complex"):
        errs = hold_complex_cases(complex_cases(
            ct, N_HELMHOLTZ, N_COMPLEX_RUNTIME, device=dev))
        A, b, x, its = hermitian_cg(ct, N_HERMITIAN, device=dev)
        from scipy.sparse.linalg import spsolve
        xs = spsolve(A.tocsc(), b)
        herm = float(abs(A - A.conj().T).max())
        x_err = float(np.abs(x - xs).max() / np.abs(xs).max())
        if not (herm == 0.0 and x_err <= HERMITIAN_X_RTOL):
            raise RuntimeError(f"complex cg: |A - A^H| {herm}, x against "
                               f"spsolve {x_err} > {HERMITIAN_X_RTOL}")
        _phase("surface_io", part="complex", n_helmholtz=N_HELMHOLTZ,
               n_runtime=N_COMPLEX_RUNTIME, **errs, n_hermitian=N_HERMITIAN,
               hermitian_dofs=int(b.size), cg_iterations=its,
               cg_x_rel_err=x_err, card=card)
    with span("vertex_ridge"):
        errs = {}
        for case, (got, exact) in vertex_ridge_cases(ct, device=dev).items():
            errs[case] = float(np.abs(got - exact).max())
            if not errs[case] <= VERTEX_RIDGE_TOL:
                raise RuntimeError(f"{case}: {errs[case]} from the exact "
                                   f"value (> {VERTEX_RIDGE_TOL})")
        _phase("surface_io", part="vertex_ridge", **errs, card=card)
    with span("petsc"):
        nums = petsc_profiling_checks(dev)
    held = profiling.timings()
    missing = [s for s in spans if f"surface_io.{s}" not in held]
    if missing:
        raise RuntimeError(f"profiling.timings() lacks the spans {missing}")
    _phase("surface_io", part="petsc_profiling", **nums,
           spans={k: v[1] for k, v in held.items()}, card=card)
    k1 = ist.launches - before
    if k1:
        raise RuntimeError(f"the complex, vertex, ridge and petsc parts "
                           f"launched K1 {k1} times")
    return launches


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
    from cutfemx_tpu_torch import native
    t0 = time.perf_counter()
    ist.build()
    _phase("build", kernel="interior_stencil",
           seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    native.build()
    _phase("build", library="geometry_kernels",
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

    # geometric multigrid: tests/test_mg.py's problems, then bench.py's mg
    # leg on the slice's n = 48 problem; no K1 on this path
    t0 = time.perf_counter()
    ist.launches = 0
    mg_parity_phase(ct, dev, smi)
    mg_bench_phase(ct, dev, mesh, phi, V, smi)
    mg_k1 = ist.launches
    if mg_k1:
        raise RuntimeError(f"the mg path launched K1 {mg_k1} times")
    _phase("mg_done", seconds=time.perf_counter() - t0, k1_launches=mg_k1,
           total_seconds=time.perf_counter() - t_all)
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

    # cut Stokes (config 4) and the nonlinear solvers: no K1 either
    t0 = time.perf_counter()
    before = ist.launches
    stokes_parity_phase(dev, smi)
    stokes_large_phase(dev, smi)
    stokes_cylinder_phase(dev, smi)
    newton_phase(dev, smi)
    _phase("stokes_done", seconds=time.perf_counter() - t0,
           k1_launches=ist.launches - before,
           total_seconds=time.perf_counter() - t_all)

    # the geometry path: signed distance, reinitialization, extension and
    # the shape-optimization loop; no K1 on it
    t0 = time.perf_counter()
    before = ist.launches
    distance_parity_phase(ct, dev, smi)
    distance_large_phase(ct, dev, smi)
    extension_phase(ct, dev, smi)
    shape_opt_phase(ct, dev, smi)
    geometry_k1 = ist.launches - before
    if geometry_k1:
        raise RuntimeError(f"the geometry path launched K1 {geometry_k1} "
                           "times")
    _phase("geometry_done", seconds=time.perf_counter() - t0,
           k1_launches=geometry_k1,
           total_seconds=time.perf_counter() - t_all)

    # the demos of ROADMAP item 12a: no K1 either
    t0 = time.perf_counter()
    ist.launches = 0
    demos_12a_phase(dev, smi)
    demos_k1 = ist.launches
    if demos_k1:
        raise RuntimeError(f"the demos launched K1 {demos_k1} times")
    _phase("demos_done", seconds=time.perf_counter() - t0,
           k1_launches=demos_k1, total_seconds=time.perf_counter() - t_all)

    # the unfitted-boundary surface: facet-hosted and compound rules,
    # runtime dS, surface fields, aggregation and the extension penalty;
    # no K1 either
    t0 = time.perf_counter()
    ist.launches = 0
    unfitted_demos_phase(dev, smi)
    unfitted_large_phase(ct, dev, smi)
    unfitted_k1 = ist.launches
    if unfitted_k1:
        raise RuntimeError(f"the unfitted path launched K1 {unfitted_k1} "
                           "times")
    _phase("unfitted_done", seconds=time.perf_counter() - t0,
           k1_launches=unfitted_k1,
           total_seconds=time.perf_counter() - t_all)

    # higher-order cut geometry: the curved P2 cut on the step (K1 in every
    # iteration), then Saye's rules on hexahedra and the parity phases
    # (no K1)
    t0 = time.perf_counter()
    ist.launches = 0
    curved_launches = curved_bench_phase(
        ct, dev, smi, (N_SLICE, 108) if args.n108 else (N_SLICE,))
    if curved_launches <= 0:
        raise RuntimeError("the curved path launched no K1 kernel")
    before = ist.launches
    curved_parity_phase(dev, smi)
    saye_parity_phase(dev, smi)
    saye_large_phase(ct, dev, smi)
    saye_k1 = ist.launches - before
    if saye_k1:
        raise RuntimeError(f"the Saye and parity phases launched K1 "
                           f"{saye_k1} times")
    _phase("higher_order_done", seconds=time.perf_counter() - t0,
           k1_launches_curved=curved_launches, k1_launches_saye=saye_k1,
           total_seconds=time.perf_counter() - t_all)

    # the rest of the single-card surface: the step from io's setup cache
    # (K1 in every iteration), then the compact rule views, numpy vectors,
    # complex forms, vertex and ridge measures, petsc and profiling (no K1)
    t0 = time.perf_counter()
    io_launches = surface_io_phase(
        ct, dev, smi, (N_SLICE, 108) if args.n108 else (N_SLICE,))
    if io_launches <= 0:
        raise RuntimeError("the setup-cache step launched no K1 kernel")
    _phase("surface_io_done", seconds=time.perf_counter() - t0,
           k1_launches_setup_cache=io_launches,
           total_seconds=time.perf_counter() - t_all)

    # the main path's shape: the slice's grid and mask in f32, the CG's type
    main_row = next(r for r in k if r["shape"] == "n48_bench"
                    and r["dtype"] == "float32")
    print(json.dumps({"kernels": [{
        "name": "interior_stencil", "route": "cuda",
        "source": "cutfemx_tpu_torch/csrc/interior_stencil.cu",
        "replaces": "cutfemx_tpu/pallas_stencil.py:71",
        "launches": launches,
        "launches_by_path": {"jacobi": jacobi_launches, "pallas": launches,
                             "mg": mg_k1, "demos_12a": demos_k1,
                             "unfitted": unfitted_k1,
                             "curved_bench": curved_launches,
                             "saye_and_parity": saye_k1,
                             "setup_cache": io_launches},
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
