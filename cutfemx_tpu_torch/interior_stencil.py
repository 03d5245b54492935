"""Interior-stencil apply: the hand-written CUDA kernel and its plain twin.

``interior_stencil_apply`` computes the interior part of the grid-layout
operator apply (the part of ``stencil._grid_apply_body`` covered by full
standard cubes). On a CUDA tensor it launches the kernel of
``csrc/interior_stencil.cu``, which replaces the Pallas TPU kernel
``cutfemx_tpu/pallas_stencil.py::_kernel``; on a CPU tensor it runs
``interior_stencil_apply_reference``, the plain torch version. Any other
device raises, and there is no fallback from one to the other.

On the H100 the apply is bound by bytes, not flops (2 L^2 flops per cube
against one read and one write of the grid); see the kernel source for the
design. The kernel is compiled with nvcc for sm_90a at first use into
``build/cutfemx_tpu_torch/`` beside the package, keyed by a hash of its
source, and bound through ctypes.

Convention: per cube y = A x, rows of ``A_local`` being the test slots (the
element path's ``eij,ej->ei``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import torch

__all__ = ["interior_stencil_apply", "interior_stencil_apply_reference",
           "build", "launches"]

# kernel launches made by interior_stencil_apply (CUDA tensors only)
launches = 0

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                    "interior_stencil.cu")
_BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build",
    "cutfemx_tpu_torch")
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC")
_MAX_SLOTS = 27

_lib = None
_lib_lock = threading.Lock()


class _SlotTable(ctypes.Structure):
    _fields_ = [("n_slots", ctypes.c_int),
                ("slot", ctypes.c_int * _MAX_SLOTS)]


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the interior-stencil kernel "
                           "is built from source on the CUDA machine")
    return path


def build():
    """Compile (once per source hash) and load the kernel library."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        with open(_SRC, "rb") as fh:
            src = fh.read()
        key = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()) \
            .hexdigest()[:16]
        so = os.path.join(_BUILD_DIR, f"libinterior_stencil_{key}.so")
        if not os.path.exists(so):
            os.makedirs(_BUILD_DIR, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
            os.close(fd)
            try:
                subprocess.run([_nvcc(), *_NVCC_FLAGS, "-o", tmp, _SRC],
                               check=True, capture_output=True, text=True)
                os.replace(tmp, so)  # atomic: concurrent builders agree
            except subprocess.CalledProcessError as e:
                raise RuntimeError(
                    f"nvcc failed on {_SRC}:\n{e.stderr}") from None
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
        lib = ctypes.CDLL(so)
        for name in ("interior_stencil_f32", "interior_stencil_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, _SlotTable,
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def _check(n, N, nch, table, A_local, cube_mask, Xin):
    if N != n + 1:
        raise ValueError(f"N must be n + 1 (got n={n}, N={N})")
    L = len(table)
    if not 1 <= L <= _MAX_SLOTS:
        raise ValueError(f"slot table of {L} entries (1..{_MAX_SLOTS})")
    for ch, off in table:
        if not 0 <= ch < nch or any(o not in (0, 1) for o in off):
            raise ValueError(f"bad slot {(ch, off)} for nch={nch}")
    if Xin.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"Xin dtype {Xin.dtype} (float32/float64 only)")
    if Xin.dim() != 1 or Xin.numel() != nch * N ** 3:
        raise ValueError(f"Xin must be flat ({nch * N ** 3},), got "
                         f"{tuple(Xin.shape)}")
    if tuple(A_local.shape) != (L, L) or A_local.dtype != Xin.dtype:
        raise ValueError(f"A_local must be ({L}, {L}) {Xin.dtype}, got "
                         f"{tuple(A_local.shape)} {A_local.dtype}")
    if tuple(cube_mask.shape) != (n, n, n) or \
            cube_mask.dtype != torch.uint8:
        raise ValueError(f"cube_mask must be ({n}, {n}, {n}) uint8, got "
                         f"{tuple(cube_mask.shape)} {cube_mask.dtype}")
    for t in (A_local, cube_mask):
        if t.device != Xin.device:
            raise ValueError(f"operands on {t.device} and {Xin.device}")


def interior_stencil_apply(n, N, nch, table, A_local, cube_mask, Xin):
    """Interior stencil apply on a masked flat grid vector.

    n: cubes per axis; N = n + 1 points per axis; nch: channels; table:
    [(channel, (dx, dy, dz))] for the L cube slots, offsets in {0, 1};
    A_local: (L, L); cube_mask: (n, n, n) uint8; Xin: (nch*N^3,).
    Returns Y, flat (nch*N^3,)."""
    global launches
    _check(n, N, nch, table, A_local, cube_mask, Xin)
    if Xin.device.type == "cpu":
        return interior_stencil_apply_reference(n, N, nch, table, A_local,
                                                cube_mask, Xin)
    if Xin.device.type != "cuda":
        raise ValueError(f"no interior-stencil kernel for {Xin.device}")
    for t in (Xin, A_local, cube_mask):
        if not t.is_contiguous():
            raise ValueError("interior_stencil_apply needs contiguous "
                             "operands")
    lib = build()
    tab = _SlotTable()
    tab.n_slots = len(table)
    for i, (ch, (dx, dy, dz)) in enumerate(table):
        tab.slot[i] = (ch << 3) | (dx << 2) | (dy << 1) | dz
    Y = torch.empty_like(Xin)
    fn = lib.interior_stencil_f32 if Xin.dtype == torch.float32 \
        else lib.interior_stencil_f64
    with torch.cuda.device(Xin.device):
        stream = torch.cuda.current_stream(Xin.device).cuda_stream
        err = fn(Xin.data_ptr(), A_local.data_ptr(), cube_mask.data_ptr(),
                 Y.data_ptr(), n, N, nch, tab, stream)
    if err:
        raise RuntimeError(f"interior_stencil kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1
    return Y


def interior_stencil_apply_reference(n, N, nch, table, A_local, cube_mask,
                                     Xin):
    """Plain torch version of the kernel: slice-stack, per-cube matvec,
    cube mask, slice-add."""
    X = Xin.reshape(nch, N, N, N)
    xc = torch.stack([X[ch, dx:dx + n, dy:dy + n, dz:dz + n]
                      for (ch, (dx, dy, dz)) in table], dim=-1)
    yc = torch.einsum("xyzl,ml->xyzm", xc, A_local)      # y = A x per cube
    yc = torch.where(cube_mask.bool()[..., None], yc, 0.0)
    Y = torch.zeros_like(X)
    for s, (ch, (dx, dy, dz)) in enumerate(table):
        Y[ch, dx:dx + n, dy:dy + n, dz:dz + n] += yc[..., s]
    return Y.reshape(-1)
