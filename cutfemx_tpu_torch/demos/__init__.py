"""The port's counterparts of the reference's 2D cut-Poisson demos.

Each module has the reference script's parameters and a ``run(...)`` that
returns the errors and the solve information instead of printing them:

- ``demo_poisson``: Poisson on a flower-shaped cut domain (BASELINE
  config 1), direct or matrix-free CG solve;
- ``demo_interface_poisson``: two-domain Poisson on a circular interface
  (config 3), block assembly and a block direct solve;
- ``demo_moving_heat``: backward-Euler heat on a translating disk (config
  5), re-cut, re-assembly and a direct solve per step.

``run`` works on the CUDA card unless called with ``device="cpu"``.
Run one as ``python -m cutfemx_tpu_torch.demos.demo_poisson --n 32``.
"""

import time

import torch


def stage_clock(device):
    """A clock for stage timings: it waits for the device's queued work
    before it reads the host's time."""
    if torch.device(device).type == "cuda":
        def clock():
            torch.cuda.synchronize(device)
            return time.perf_counter()
        return clock
    return time.perf_counter
