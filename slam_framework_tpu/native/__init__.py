"""Native (C++) host-runtime components, loaded via ctypes.

The device compute path is JAX/XLA; these are the host-side hot loops that mirror the
reference's C++ map backend (SURVEY.md §2: map bookkeeping is first-party C++
there). Compiled on first use with the toolchain baked into the image (g++); a
pure-numpy fallback keeps the package importable without a compiler.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_HERE = os.path.dirname(__file__)
_SRC = os.path.join(_HERE, "arena_ops.cpp")
_LOCK = threading.Lock()
_LIB = None
_TRIED = False


def _build_lib_path() -> str:
    """Build directory: SLAM_NATIVE_CACHE, else `.native_build` in the checkout."""
    cache = os.environ.get(
        "SLAM_NATIVE_CACHE",
        os.path.join(os.path.dirname(os.path.dirname(_HERE)), ".native_build"),
    )
    os.makedirs(cache, exist_ok=True)
    return os.path.join(cache, "arena_ops.so")


def load_arena_ops():
    """Return the ctypes library (compiling on first call) or None on failure."""
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        so = _build_lib_path()
        try:
            if not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(_SRC):
                subprocess.run(
                    ["g++", "-O3", "-march=native", "-shared", "-fPIC", _SRC, "-o", so],
                    check=True, capture_output=True,
                )
            lib = ctypes.CDLL(so)
        except (OSError, subprocess.CalledProcessError):
            return None

        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32, i64 = ctypes.c_int32, ctypes.c_int64

        lib.register_observations.restype = i64
        lib.register_observations.argtypes = [i32, i32p, i64, i32p, i32p, i32p, i64]
        lib.erase_keyframe_observations.restype = None
        lib.erase_keyframe_observations.argtypes = [i32, i32p, i64, i32p, i32p, i32p, i64]
        lib.covisibility_counts.restype = None
        lib.covisibility_counts.argtypes = [i32, i32p, i64, i32p, i32p, i64, i64p, i64]
        lib.merge_points.restype = i32
        lib.merge_points.argtypes = [
            i32, i32, i32p, i64, i32p, i32p, i32p, i32p, i32p, u8p, i64,
        ]
        _LIB = lib
        return _LIB


def as_i32p(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def as_i64p(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def as_u8p(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
