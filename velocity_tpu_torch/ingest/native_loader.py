"""ctypes binding for the native C++ frame staging pipeline (native/frame_loader.cpp).

A copy of ``velocity_tpu/ingest/native_loader.py`` with two differences:
where ``native/libvelocity_host.so`` is missing, the library is built with
``make`` into ``build/native/`` (``native/`` is never written), and a
library that cannot be built or loaded (no OpenCV on the machine) raises
``OSError``, which ``available()`` answers with False. Callers then decode
with the Python ``VideoReader``.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parent.parent.parent
_NATIVE_DIR = _ROOT / "native"
_SO = _NATIVE_DIR / "libvelocity_host.so"
BUILD_DIR = _ROOT / "build" / "native"
_lib = None


def _library_path() -> Path:
    """The shared object: the one in ``native/``, else one built from its
    sources into ``BUILD_DIR``."""
    if _SO.exists():
        return _SO
    built = BUILD_DIR / _SO.name
    if not built.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        try:
            subprocess.run(["make", "-C", str(BUILD_DIR), "-f", str(_NATIVE_DIR / "Makefile"),
                            f"--eval=vpath %.cpp {_NATIVE_DIR}"],
                           check=True, capture_output=True)
        except (OSError, subprocess.CalledProcessError) as e:
            detail = getattr(e, "stderr", b"") or b""
            raise OSError(f"cannot build the native loader: {e} "
                          f"{detail.decode(errors='replace')[-400:]}") from e
    return built


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(_library_path()))
    lib.vh_open.restype = ctypes.c_void_p
    lib.vh_open.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64),
    ]
    lib.vh_start.restype = ctypes.c_int
    lib.vh_start.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                             ctypes.c_int64, ctypes.c_int]
    lib.vh_next.restype = ctypes.c_int
    lib.vh_next.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64),
    ]
    lib.vh_close.restype = None
    lib.vh_close.argtypes = [ctypes.c_void_p]
    lib.vh_small_dims.restype = ctypes.c_int
    lib.vh_small_dims.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
                                  ctypes.POINTER(ctypes.c_int)]
    _lib = lib
    return lib


class NativeVideoStream:
    """Background-threaded native decode stream yielding (gray, small, t, idx):
    the grayscale frame, its 1/4-scale nearest decimation, ``idx / fps`` and
    the frame index."""

    def __init__(self, path: str, start: int = 0, count: int = -1,
                 step: int = 1, depth: int = 6):
        self._h = None
        lib = _load()
        w = ctypes.c_int(); h = ctypes.c_int()
        fps = ctypes.c_double(); fc = ctypes.c_int64()
        self._lib = lib
        self._h = lib.vh_open(str(path).encode(), ctypes.byref(w),
                              ctypes.byref(h), ctypes.byref(fps), ctypes.byref(fc))
        if not self._h:
            raise OSError(f"native loader cannot open {path}")
        self.width, self.height = w.value, h.value
        self.fps, self.frame_count = fps.value, fc.value
        sw = ctypes.c_int(); sh = ctypes.c_int()
        lib.vh_small_dims(self._h, ctypes.byref(sw), ctypes.byref(sh))
        self.small_size = (sh.value, sw.value)
        rc = lib.vh_start(self._h, start, count, step, depth)
        if rc != 0:
            self.close()
            raise OSError("native loader start failed")

    def __iter__(self):
        lib = self._lib
        H, W = self.height, self.width
        sh, sw = self.small_size
        while True:
            gray = np.empty((H, W), np.uint8)
            small = np.empty((sh, sw), np.uint8)
            t = ctypes.c_double(); idx = ctypes.c_int64()
            rc = lib.vh_next(
                self._h,
                gray.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                small.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                ctypes.byref(t), ctypes.byref(idx),
            )
            if rc != 1:
                return
            yield gray, small, t.value, idx.value

    def close(self):
        if self._h:
            self._lib.vh_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()


def available() -> bool:
    """Whether the native loader builds and loads on this machine."""
    try:
        _load()
        return True
    except OSError:
        return False
