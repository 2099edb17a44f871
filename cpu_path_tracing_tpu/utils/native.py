"""ctypes binding for the native I/O runtime (native/src/ptio.cpp).

The reference's output path is native C++ (``src/utils.cpp:11-16`` gamma,
``src/main.cpp:240-247`` PPM via fmt); this is its counterpart here.  The
library is built on demand with ``make -C native`` and loaded lazily; every
entry point has a byte-compatible Python fallback in utils/image.py, which is
also the oracle the parity tests compare against.

Set ``PT_NATIVE=0`` to force the pure-Python path.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_LIB_PATH = os.path.join(_REPO_ROOT, "native", "build", "libptio.so")
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if os.environ.get("PT_NATIVE", "1") == "0":
        return None
    if not os.path.exists(_LIB_PATH):
        make_dir = os.path.join(_REPO_ROOT, "native")
        if not os.path.exists(os.path.join(make_dir, "Makefile")):
            return None
        try:
            subprocess.run(
                ["make", "-C", make_dir], check=True,
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL, timeout=120,
            )
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
        lib.ptio_tonemap_u8.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.ptio_write_ppm.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int32, ctypes.c_int32,
        ]
        lib.ptio_write_ppm.restype = ctypes.c_int
        lib.ptio_write_png.argtypes = list(lib.ptio_write_ppm.argtypes)
        lib.ptio_write_png.restype = ctypes.c_int
        lib.ptio_async_submit.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ]
        lib.ptio_async_pending.restype = ctypes.c_int
        lib.ptio_async_wait.restype = ctypes.c_int
        _lib = lib
    except OSError:
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def _as_f32(image) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(image), dtype=np.float32)


def tonemap_u8(image) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    img = _as_f32(image)
    out = np.empty(img.size, np.uint8)
    lib.ptio_tonemap_u8(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(img.size),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out.reshape(img.shape)


def write_ppm(path: str, image) -> bool:
    lib = _load()
    if lib is None:
        return False
    img = _as_f32(image)
    h, w = img.shape[:2]
    rc = lib.ptio_write_ppm(
        path.encode(), img.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), w, h
    )
    return rc == 0


def write_png(path: str, image) -> bool:
    lib = _load()
    if lib is None:
        return False
    img = _as_f32(image)
    h, w = img.shape[:2]
    rc = lib.ptio_write_png(
        path.encode(), img.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), w, h
    )
    return rc == 0


def async_submit(path: str, image, png: bool = True) -> bool:
    """Enqueue a frame on the native writer thread (the buffer is copied in
    C++, so the caller's array may be reused immediately).  Returns False if
    the native runtime is unavailable — callers fall back to a synchronous
    write."""
    lib = _load()
    if lib is None:
        return False
    img = _as_f32(image)
    h, w = img.shape[:2]
    lib.ptio_async_submit(
        path.encode(), img.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        w, h, 1 if png else 0,
    )
    return True


def async_wait() -> int:
    """Block until all queued frames are on disk; returns the failure count."""
    lib = _load()
    if lib is None:
        return 0
    return int(lib.ptio_async_wait())
