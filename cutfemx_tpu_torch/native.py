"""Host C++ geometry kernels (robust orientation predicates, the binary
STL record parser, the separating-axis cell/triangle overlap test and the
exact segment/triangle and triangle/triangle intersection tests) bound with
ctypes.

The source, ``csrc/geometry_kernels.cpp``, is plain host C++ (a copy of
``cutfemx_tpu``'s native library: the same code). It is compiled with
``g++ -O3 -shared -fPIC -std=c++17`` at first use into
``build/cutfemx_tpu_torch/`` beside the package, keyed by a hash of the
source and the flags; the compiler writes a temporary file that is then
renamed into place, so concurrent first uses never load a half-written
library. There is no silent fallback: a failed build raises with the
compiler's messages, because the numpy stand-ins would give a different
answer (a conservative cut-facet marking instead of the exact one).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import sys
import tempfile
import threading

import numpy as np

__all__ = ["build", "get_lib", "native_available", "orient3d",
           "orient3d_batch", "parse_stl_records", "tri_cell_overlap",
           "tri_tri_isect_batch", "seg_tri_isect_batch"]

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                    "geometry_kernels.cpp")
_BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build",
    "cutfemx_tpu_torch")
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lib = None
_lib_lock = threading.Lock()


def _compile():
    with open(_SRC, "rb") as fh:
        code = fh.read()
    key = hashlib.sha256(code + " ".join(_FLAGS).encode()).hexdigest()[:16]
    so = os.path.join(
        _BUILD_DIR, f"libgeometry_kernels_{sys.implementation.cache_tag}_"
        f"{platform.machine()}_{key}.so")
    if os.path.exists(so):
        return so
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run(["g++", *_FLAGS, _SRC, "-o", tmp],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"g++ failed on {_SRC} (exit {res.returncode}):\n"
                f"{res.stderr}")
        os.replace(tmp, so)  # atomic: concurrent builds agree
    except FileNotFoundError:
        raise RuntimeError("g++ not found: the geometry library is built "
                           "from source at first use") from None
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return so


def build():
    """Compile (once per source hash) and load the geometry library."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(_compile())
        dp = ctypes.POINTER(ctypes.c_double)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        sigs = {
            "cutfemx_orient2d": (ctypes.c_double, [dp, dp, dp]),
            "cutfemx_orient3d": (ctypes.c_double, [dp, dp, dp, dp]),
            "cutfemx_seg_tri_isect": (ctypes.c_int, [dp, dp, dp, dp, dp]),
            "cutfemx_tri_tri_isect": (ctypes.c_int, [dp, dp]),
            "cutfemx_orient3d_batch": (None, [dp, dp, dp, dp,
                                              ctypes.c_int64, dp]),
            "cutfemx_parse_stl_records": (None, [u8p, ctypes.c_int64, dp,
                                                 dp]),
            "cutfemx_tri_cell_overlap": (None, [dp, dp, ctypes.c_int64,
                                                ctypes.c_int, u8p]),
            "cutfemx_seg_tri_isect_batch": (None, [dp, dp, ctypes.c_int64,
                                                   u8p]),
            "cutfemx_tri_tri_isect_batch": (None, [dp, dp, ctypes.c_int64,
                                                   u8p]),
        }
        for name, (res, args) in sigs.items():
            fn = getattr(lib, name)
            fn.restype = res
            fn.argtypes = args
        _lib = lib
        return _lib


def get_lib():
    """The loaded library, or None when it cannot be built here (the
    reference's contract; ``build`` raises with the compiler's
    messages instead)."""
    try:
        return build()
    except RuntimeError:
        return None


def native_available():
    return get_lib() is not None


def _f64(a):
    return np.ascontiguousarray(a, dtype=np.float64)


def _dp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _u8p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def orient3d(a, b, c, d):
    """Robust orientation of point d against the plane abc."""
    a, b, c, d = (_f64(v) for v in (a, b, c, d))
    return float(build().cutfemx_orient3d(_dp(a), _dp(b), _dp(c), _dp(d)))


def orient3d_batch(pa, pb, pc, pd):
    """orient3d over rows of four (n, 3) arrays."""
    pa, pb, pc, pd = (_f64(v) for v in (pa, pb, pc, pd))
    out = np.empty(pa.shape[0])
    build().cutfemx_orient3d_batch(_dp(pa), _dp(pb), _dp(pc), _dp(pd),
                                   pa.shape[0], _dp(out))
    return out


def parse_stl_records(raw):
    """(n*50,) uint8 binary STL records -> (normals (n, 3), verts
    (n, 3, 3)) float64."""
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    n = len(raw) // 50
    normals = np.empty((n, 3))
    verts = np.empty((n, 3, 3))
    build().cutfemx_parse_stl_records(_u8p(raw), n, _dp(normals),
                                      _dp(verts))
    return normals, verts


def tri_cell_overlap(cells, tris):
    """Separating-axis overlap flags. cells: (m, nv, 3); tris: (m, 3, 3)."""
    cells, tris = _f64(cells), _f64(tris)
    m, nv = cells.shape[0], cells.shape[1]
    out = np.zeros(max(m, 1), dtype=np.uint8)
    if m:
        build().cutfemx_tri_cell_overlap(_dp(cells), _dp(tris), m, nv,
                                         _u8p(out))
    return out[:m].astype(bool)


def tri_tri_isect_batch(t1, t2):
    """Exact (predicate-only) closed triangle-triangle intersection flags.
    t1, t2: (m, 3, 3)."""
    t1, t2 = _f64(t1), _f64(t2)
    m = t1.shape[0]
    out = np.zeros(max(m, 1), dtype=np.uint8)
    if m:
        build().cutfemx_tri_tri_isect_batch(_dp(t1), _dp(t2), m, _u8p(out))
    return out[:m].astype(bool)


def seg_tri_isect_batch(segs, tris):
    """Exact closed segment-triangle intersection flags. segs: (m, 2, 3);
    tris: (m, 3, 3)."""
    segs, tris = _f64(segs), _f64(tris)
    m = segs.shape[0]
    out = np.zeros(max(m, 1), dtype=np.uint8)
    if m:
        build().cutfemx_seg_tri_isect_batch(_dp(segs), _dp(tris), m,
                                            _u8p(out))
    return out[:m].astype(bool)
