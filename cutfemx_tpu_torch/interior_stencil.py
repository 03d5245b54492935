"""Interior-stencil apply: the hand-written CUDA kernel and its plain twin.

``interior_stencil_apply`` computes the interior part of the grid-layout
operator apply (the part of ``stencil._grid_apply_body`` covered by full
standard cubes). On a CUDA tensor it launches the kernel of
``csrc/interior_stencil.cu``, which replaces the Pallas TPU kernel
``cutfemx_tpu/pallas_stencil.py::_kernel``; on a CPU tensor it runs
``interior_stencil_apply_reference``, the plain torch version. Any other
device raises, and there is no fallback from one to the other.

On the H100 the apply is bound by bytes, not flops (2 L^2 flops per full
cube against one write of the grid, one read of the mask and one read of
the values full cubes touch). The kernel works on output tiles staged in
shared memory and skips tiles whose cube window holds no full cube; see its
source for the design. It is compiled with nvcc for sm_90a at first use
into ``build/cutfemx_tpu_torch/`` beside the package, keyed by a hash of
its source, and bound through ctypes.

``interior_stencil_apply_box`` is the same function on a batch of boxes
of cubes that need not be cubic: ``(B, nx, ny, nz)`` cube masks on
``(B, nch, Nx, Ny, Nz)`` grids with ``N_a >= n_a + 1``, the slabs of the
distributed solve (``parallel/gridsolver.py``) stacked on one card in one
launch. The cubic call is the one box ``n^3`` cubes on ``(n + 1)^3``
points.

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
           "interior_stencil_apply_box",
           "interior_stencil_apply_box_reference", "build", "launches"]

# kernel launches made by interior_stencil_apply_box, so also by the
# cubic interior_stencil_apply (CUDA tensors only)
launches = 0

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                    "interior_stencil.cu")
_BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build",
    "cutfemx_tpu_torch")
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC")
_MAX_SLOTS = 27
_MAX_CH = 8

_lib = None
_lib_lock = threading.Lock()


class _SlotTable(ctypes.Structure):
    _fields_ = [("n_slots", ctypes.c_int),
                ("slot", ctypes.c_int * _MAX_SLOTS)]


class _Box(ctypes.Structure):
    _fields_ = [(k, ctypes.c_int)
                for k in ("nb", "nx", "ny", "nz", "Nx", "Ny", "Nz")]


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


def _load(src):
    """Compile ``src`` (once per source hash) and load its library."""
    with open(src, "rb") as fh:
        code = fh.read()
    key = hashlib.sha256(code + " ".join(_NVCC_FLAGS).encode()) \
        .hexdigest()[:16]
    stem = os.path.splitext(os.path.basename(src))[0]
    so = os.path.join(_BUILD_DIR, f"lib{stem}_{key}.so")
    if not os.path.exists(so):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run([_nvcc(), *_NVCC_FLAGS, "-o", tmp, src],
                           check=True, capture_output=True, text=True)
            os.replace(tmp, so)  # atomic: concurrent builds agree
        except subprocess.CalledProcessError as e:
            raise RuntimeError(f"nvcc failed on {src}:\n{e.stderr}") from None
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    lib = ctypes.CDLL(so)
    # the cubic entry points: every version of the source has them, so
    # chip_smoke.py --parent-source times an earlier one through them
    for name in ("interior_stencil_f32", "interior_stencil_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, _SlotTable, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    # the box entry points, which the wrappers launch (absent from an
    # earlier source)
    for name in ("interior_stencil_box_f32", "interior_stencil_box_f64"):
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_void_p, _Box, ctypes.c_int, _SlotTable,
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return lib


def build():
    """Compile (once per source hash) and load the kernel library."""
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = _load(_SRC)
        return _lib


def _check_table(nch, table):
    L = len(table)
    if not 1 <= L <= _MAX_SLOTS:
        raise ValueError(f"slot table of {L} entries (1..{_MAX_SLOTS})")
    for ch, off in table:
        if not 0 <= ch < nch or any(o not in (0, 1) for o in off):
            raise ValueError(f"bad slot {(ch, off)} for nch={nch}")
    return L


def interior_stencil_apply(n, N, nch, table, A_local, cube_mask, Xin):
    """Interior stencil apply on a masked flat grid vector: the one-box
    case of ``interior_stencil_apply_box``.

    n: cubes per axis; N = n + 1 points per axis; nch: channels; table:
    [(channel, (dx, dy, dz))] for the L cube slots, offsets in {0, 1};
    A_local: (L, L); cube_mask: (n, n, n) uint8; Xin: (nch*N^3,).
    Returns Y, flat (nch*N^3,)."""
    if N != n + 1:
        raise ValueError(f"N must be n + 1 (got n={n}, N={N})")
    if Xin.dim() != 1 or Xin.numel() != nch * N ** 3:
        raise ValueError(f"Xin must be flat ({nch * N ** 3},), got "
                         f"{tuple(Xin.shape)}")
    if tuple(cube_mask.shape) != (n, n, n):
        raise ValueError(f"cube_mask must be ({n}, {n}, {n}), got "
                         f"{tuple(cube_mask.shape)}")
    return interior_stencil_apply_box(
        nch, table, A_local, cube_mask.reshape(1, n, n, n),
        Xin.reshape(1, nch, N, N, N)).reshape(-1)


def _slot_table(table):
    tab = _SlotTable()
    tab.n_slots = len(table)
    for i, (ch, (dx, dy, dz)) in enumerate(table):
        tab.slot[i] = (ch << 3) | (dx << 2) | (dy << 1) | dz
    return tab


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


def _check_box(nch, table, A_local, cube_mask, Xin):
    L = _check_table(nch, table)
    if Xin.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"Xin dtype {Xin.dtype} (float32/float64 only)")
    if cube_mask.dim() != 4 or cube_mask.dtype != torch.uint8:
        raise ValueError(f"cube_mask must be (B, nx, ny, nz) uint8, got "
                         f"{tuple(cube_mask.shape)} {cube_mask.dtype}")
    B, nx, ny, nz = cube_mask.shape
    if Xin.dim() != 5 or Xin.shape[:2] != (B, nch) or min(nx, ny, nz) < 1:
        raise ValueError(f"Xin must be ({B}, {nch}, Nx, Ny, Nz), got "
                         f"{tuple(Xin.shape)}")
    if any(P < c + 1 for P, c in zip(Xin.shape[2:], (nx, ny, nz))):
        raise ValueError(f"points {tuple(Xin.shape[2:])} must exceed the "
                         f"cubes {(nx, ny, nz)} by >= 1 per axis")
    if tuple(A_local.shape) != (L, L) or A_local.dtype != Xin.dtype:
        raise ValueError(f"A_local must be ({L}, {L}) {Xin.dtype}, got "
                         f"{tuple(A_local.shape)} {A_local.dtype}")
    for t in (A_local, cube_mask):
        if t.device != Xin.device:
            raise ValueError(f"operands on {t.device} and {Xin.device}")


def interior_stencil_apply_box(nch, table, A_local, cube_mask, Xin):
    """Interior stencil apply on a batch of boxes of cubes, one launch.

    cube_mask: (B, nx, ny, nz) uint8; Xin: (B, nch, Nx, Ny, Nz) masked
    grid values with N_a >= n_a + 1 (cube q touches points q .. q + 1);
    table and A_local as for ``interior_stencil_apply``. Returns Y of
    Xin's shape (zeros where no full cube touches)."""
    global launches
    _check_box(nch, table, A_local, cube_mask, Xin)
    if Xin.device.type == "cpu":
        return interior_stencil_apply_box_reference(nch, table, A_local,
                                                    cube_mask, Xin)
    if Xin.device.type != "cuda":
        raise ValueError(f"no interior-stencil kernel for {Xin.device}")
    for t in (Xin, A_local, cube_mask):
        if not t.is_contiguous():
            raise ValueError("interior_stencil_apply_box needs contiguous "
                             "operands")
    if nch > _MAX_CH:
        raise ValueError(f"the kernel takes at most {_MAX_CH} channels, "
                         f"got {nch}")
    if Xin[0, 0].numel() >= 2 ** 31:
        raise ValueError("a box of 2^31 points or more")
    lib = build()
    box = _Box(*cube_mask.shape, *Xin.shape[2:])
    Y = torch.empty_like(Xin)
    fn = lib.interior_stencil_box_f32 if Xin.dtype == torch.float32 \
        else lib.interior_stencil_box_f64
    with torch.cuda.device(Xin.device):
        stream = torch.cuda.current_stream(Xin.device).cuda_stream
        err = fn(Xin.data_ptr(), A_local.data_ptr(), cube_mask.data_ptr(),
                 Y.data_ptr(), box, nch, _slot_table(table), stream)
    if err:
        raise RuntimeError(f"interior_stencil box kernel launch failed: "
                           f"CUDA error {err}")
    launches += 1
    return Y


def interior_stencil_apply_box_reference(nch, table, A_local, cube_mask,
                                         Xin):
    """Plain torch version of the box kernel: the cubic plain version
    with a leading box axis and per-axis extents."""
    B, nx, ny, nz = cube_mask.shape
    xc = torch.stack([Xin[:, ch, dx:dx + nx, dy:dy + ny, dz:dz + nz]
                      for (ch, (dx, dy, dz)) in table], dim=-1)
    yc = torch.einsum("bxyzl,ml->bxyzm", xc, A_local)    # y = A x per cube
    yc = torch.where(cube_mask.bool()[..., None], yc, 0.0)
    Y = torch.zeros_like(Xin)
    for s, (ch, (dx, dy, dz)) in enumerate(table):
        Y[:, ch, dx:dx + nx, dy:dy + ny, dz:dz + nz] += yc[..., s]
    return Y
