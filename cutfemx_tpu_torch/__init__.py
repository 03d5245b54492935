"""cutfemx_tpu_torch — the CutFEM framework on PyTorch and CUDA.

The PyTorch counterpart of ``cutfemx_tpu``: the same module names and
public functions, with device data held in torch tensors. Every entry point
that creates device data takes a ``device``, which is the CUDA card unless
the caller asks for another (``device="cpu"``). The interior-stencil apply
on the card is a hand-written CUDA kernel (``interior_stencil.py``,
``csrc/``).
"""

import importlib as _importlib

import torch as _torch

# FEM operators are f32 contracts. Reduced-precision matmuls (TF32 on
# Hopper, bf16 passes on a TPU) leave element matrices and every operator
# apply about 1e-3 fuzzy, and the f32 CG recurrence then drifts from the
# true residual by orders of magnitude within ~60 iterations. Force
# true-f32 matmuls and convolutions library-wide.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

import sys as _sys  # noqa: E402

from . import la, mesh  # noqa: E402,F401
from .functionspace import (  # noqa: E402,F401
    Constant, Function, FunctionSpace, functionspace)
from .forms.measure import Measure, dS, ds, dx  # noqa: E402,F401
from .forms import dsl as ufl  # noqa: E402,F401  (UFL-like namespace)
from .forms.dsl import QuadratureField  # noqa: E402,F401

# the reference's name for the quadrature-point field type
QuadratureFunction = QuadratureField

_sys.modules[__name__ + ".ufl"] = ufl  # `from cutfemx_tpu_torch.ufl import`

# The public `cut(...)` entry point shadows the `cut` subpackage attribute,
# as in cutfemx_tpu: the function wins at package level.
from .cut import api as _cut_api  # noqa: E402

cut = _cut_api.cut
update = _cut_api.update
locate_entities = _cut_api.locate_entities
runtime_quadrature = _cut_api.runtime_quadrature
runtime_quadratures = _cut_api.runtime_quadratures
ghost_penalty_facets = _cut_api.ghost_penalty_facets
interior_facets_for_cells = _cut_api.interior_facets_for_cells
CutData = _cut_api.CutData
CutMesh = _cut_api.CutMesh
create_cut_mesh = _cut_api.create_cut_mesh

__version__ = "0.1.0"

_LAZY_MODULES = ("fem", "level_set", "mg", "stencil", "interior_stencil",
                 "interop", "demos", "distance", "extensions", "native",
                 "optimization", "refine", "io", "petsc", "profiling")
# the reference's modules that the port does not have yet, and the
# ROADMAP item that ports them
_UNPORTED = {"parallel": "ROADMAP item 13"}
_LEVELSET_API = ("normal", "level_set_value", "surface_normal", "conormal",
                 "correction_distance")


def __getattr__(name):
    # Lazy imports keep `import cutfemx_tpu_torch` light and avoid cycles.
    if name == "cut_function":
        return _importlib.import_module(".fem", __name__).cut_function
    if name in _LAZY_MODULES:
        mod = _importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    if name in _LEVELSET_API:
        mod = _importlib.import_module(".level_set", __name__)
        return getattr(mod, name)
    if name in _UNPORTED:
        raise AttributeError(
            f"cutfemx_tpu_torch.{name} is not ported yet ({_UNPORTED[name]})")
    raise AttributeError(
        f"module 'cutfemx_tpu_torch' has no attribute '{name}'")
