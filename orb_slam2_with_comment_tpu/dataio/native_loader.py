"""ctypes bindings for the native C++ frame loader (native/frame_loader.cc).

Compiles the shared library on first use (g++ + libpng) into
``.native_build/`` at the root of the checkout (listed in .gitignore).
dataio.datasets reads frames through PIL when the toolchain or libpng is
unavailable.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_LOCK = threading.Lock()
_LIB = None
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_ROOT, "native", "frame_loader.cc")
_BUILD = os.path.join(_ROOT, ".native_build")


def _build() -> str | None:
    os.makedirs(_BUILD, exist_ok=True)
    so = os.path.join(_BUILD, "libframeloader.so")
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(_SRC):
        return so
    # build under a private name, then rename: processes that build at the
    # same time never load a half-written library
    tmp = f"{so}.{os.getpid()}"
    cmd = ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
           _SRC, "-o", tmp, "-lpng", "-lpthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (subprocess.SubprocessError, FileNotFoundError):
        return None
    os.replace(tmp, so)
    return so


def get_lib():
    """Load (building if needed) the native library; None if unavailable."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB or None
        so = _build()
        if so is None:
            _LIB = False
            return None
        lib = ctypes.CDLL(so)
        lib.fl_create.restype = ctypes.c_void_p
        lib.fl_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float]
        lib.fl_next.restype = ctypes.c_int
        lib.fl_next.argtypes = [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_float)]
        lib.fl_destroy.argtypes = [ctypes.c_void_p]
        lib.fl_decode_gray.restype = ctypes.c_int
        lib.fl_decode_gray.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_float]
        _LIB = lib
        return lib


class NativeSequenceLoader:
    """In-order threaded prefetch over a list of PNG paths."""

    def __init__(self, paths: list[str], height: int, width: int,
                 n_threads: int = 4, is_depth: bool = False,
                 depth_factor: float = 5000.0):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native loader unavailable")
        self._lib = lib
        self.height, self.width = height, width
        arr = (ctypes.c_char_p * len(paths))(
            *[p.encode() for p in paths])
        self._paths_keepalive = arr
        self._h = lib.fl_create(arr, len(paths), height, width, n_threads,
                                int(is_depth), float(depth_factor))
        self.n = len(paths)
        self._emitted = 0

    def next(self) -> np.ndarray | None:
        if self._emitted >= self.n:
            return None
        out = np.empty((self.height, self.width), np.float32)
        idx = self._lib.fl_next(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if idx < 0:
            return None
        self._emitted += 1
        return out

    def close(self):
        if self._h:
            self._lib.fl_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def decode_gray(path: str, height: int, width: int, is_depth: bool = False,
                depth_factor: float = 5000.0) -> np.ndarray | None:
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty((height, width), np.float32)
    rc = lib.fl_decode_gray(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        height, width, int(is_depth), float(depth_factor))
    return out if rc == 0 else None
