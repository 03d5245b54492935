"""The port's counterparts of the reference's demos.

Each module has the reference script's parameters and a ``run(...)`` that
returns the errors and the solve information instead of printing them:

- ``demo_poisson``: Poisson on a flower-shaped cut domain (BASELINE
  config 1), direct or matrix-free CG solve;
- ``demo_interface_poisson``: two-domain Poisson on a circular interface
  (config 3), block assembly and a block direct solve;
- ``demo_moving_heat``: backward-Euler heat on a translating disk (config
  5), re-cut, re-assembly and a direct solve per step;
- ``demo_stokes``: cut Stokes (config 4), the flow around a cylinder with
  strong inflow and wall conditions (``run``) and a manufactured problem
  through block or monolithic mixed forms (``run_manufactured``);
- ``demo_stl_distance``: the signed distance to an STL surface (a sphere
  by default) on a box mesh;
- ``demo_reinit``: reinitialization of a non-distance level set;
- ``demo_compliance_optimization``: the level-set compliance (shape)
  optimization loop (``run`` takes the command line's options);
- ``demo_boundary_sphere_perimeter``: the perimeter (surface area) and
  area (volume) of a circle (sphere) from ``phi=0`` and ``phi<0`` rules of
  order 3, in 2D or 3D;
- ``demo_locate_entities``: cells classified against two level sets at
  once, compound and union selectors, and boundary facets classified
  against one level set (facet-hosted CutData);
- ``demo_dg_poisson``: SIPG Poisson on a DG space with interior-facet
  ``dS`` and boundary ``ds`` terms, no cut;
- ``demo_elasticity``: linear elasticity on a cut disk in vector P1
  (``sym``, ``tr``, ``Identity``), Nitsche and ghost penalty,
  deactivation and a direct solve;
- ``demo_moving_poisson``: Poisson on a translating disk, re-cut by
  ``update`` and solved directly each step.

``run`` works on the CUDA card unless called with ``device="cpu"``.
Run one as ``python -m cutfemx_tpu_torch.demos.demo_poisson --n 32``.
"""

import time

import torch


def stage_clock(device):
    """A clock for stage timings: it waits for the device's queued work
    before it reads the host's time (``device=None``: the host's time)."""
    if device is not None and torch.device(device).type == "cuda":
        def clock():
            torch.cuda.synchronize(device)
            return time.perf_counter()
        return clock
    return time.perf_counter
