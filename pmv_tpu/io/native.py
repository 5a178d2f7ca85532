"""ctypes bindings for the native C++ frame-decode runtime (native/).

The reference's hot ingest path is OpenCV's C++ ``imread`` inside the
producer thread (Frame.cpp:33, OdometryPipeline.cpp:216). Here the
equivalent is a small C++ library (``native/frame_loader.cpp``): a zlib-based
PNG decoder plus a multithreaded prefetch pool, loaded via ctypes.

The library is built on the machine that uses it (the Makefile compiles
with ``-march=native``): the first use runs ``make -C native``, which
rebuilds it when the source is newer. Without a toolchain (make, a C++
compiler, zlib headers) ``available()`` is False and the pure-Python codec
takes over.
"""

from __future__ import annotations

import ctypes
import fcntl
import shutil
import subprocess
from pathlib import Path

import numpy as np

_LIB = None
_TRIED = False

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
LIB_PATH = NATIVE_DIR / "libframe_loader.so"


def build(native_dir: Path = NATIVE_DIR) -> bool:
    """Run ``make -C native_dir`` (a no-op when the library is up to date).
    Returns whether the library exists afterwards. A lock serialises
    concurrent builders (parallel test workers)."""
    if shutil.which("make") is not None and (native_dir / "Makefile").is_file():
        with open(native_dir / ".build.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            subprocess.run(
                ["make", "-s", "-C", str(native_dir)],
                capture_output=True,
                timeout=300,
                check=False,
            )
    return (native_dir / LIB_PATH.name).is_file()


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if not build():
        return None
    try:
        lib = ctypes.CDLL(str(LIB_PATH))
    except OSError:
        return None
    lib.fl_decode_gray.restype = ctypes.c_int
    lib.fl_decode_gray.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


_MAX_PIXELS = 4096 * 4096


def load_grayscale(path: str | Path) -> np.ndarray:
    """Decode an 8-bit PNG to float32 grayscale via the native library."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native frame loader not built")
    buf = np.empty(_MAX_PIXELS, dtype=np.float32)
    h = ctypes.c_int(0)
    w = ctypes.c_int(0)
    rc = lib.fl_decode_gray(
        str(path).encode(),
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        _MAX_PIXELS,
        ctypes.byref(h),
        ctypes.byref(w),
    )
    if rc != 0:
        raise ValueError(f"native decode failed ({rc}): {path}")
    return buf[: h.value * w.value].reshape(h.value, w.value).copy()
