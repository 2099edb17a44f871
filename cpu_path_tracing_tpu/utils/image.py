"""Image output: gamma transfer, PPM and PNG writers.

Reproduces the reference's output path exactly: ``pt::color_to_int`` =
``round(clamp(x)^(1/2.2) * 255)`` (``src/utils.cpp:11-16``) and the P3 PPM
format ``P3\\n{w} {h}\\n255\\n`` followed by space-separated ints
(``src/main.cpp:240-247``).  A dependency-free PNG writer is added because the
reference repo's golden artifacts are PNGs (``samples/*.png``).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from . import native as _native


def color_to_int(x: np.ndarray) -> np.ndarray:
    """Gamma-2.2 transfer, vectorized ``pt::color_to_int`` (src/utils.cpp:11-16)."""
    corrected = np.clip(np.asarray(x, np.float64), 0.0, 1.0) ** (1.0 / 2.2)
    return np.rint(corrected * 255.0).astype(np.int32)


def tonemap(image) -> np.ndarray:
    """Linear [H,W,3] -> uint8 [H,W,3] via the reference transfer."""
    return color_to_int(np.asarray(image)).astype(np.uint8)


def write_ppm(path: str, image) -> None:
    """P3 PPM, byte-compatible with ``src/main.cpp:240-247`` ("{} " per channel).

    Delegates to the native C++ writer (native/src/ptio.cpp) when available
    and the input is float32; the Python path below is the byte-compatible
    fallback/oracle.
    """
    img = np.asarray(image)
    if img.dtype == np.float32 and _native.write_ppm(path, img):
        return
    h, w = img.shape[:2]
    ints = color_to_int(img).reshape(-1)
    with open(path, "w") as f:
        f.write(f"P3\n{w} {h}\n255\n")
        f.write(" ".join(str(v) for v in ints))
        f.write(" ")


def write_png(path: str, image) -> None:
    """Minimal RGB8 PNG writer (zlib only, no external deps).

    Delegates to the native C++ encoder when available (same deflate level
    and filter strategy — identical bytes).
    """
    arr = np.asarray(image)
    if arr.dtype == np.float32 and _native.write_png(path, arr):
        return
    img = tonemap(image)
    h, w = img.shape[:2]
    raw = b"".join(b"\x00" + img[i].tobytes() for i in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data))
            + tag
            + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    png = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )
    with open(path, "wb") as f:
        f.write(png)


def write_png_async(path: str, image) -> None:
    """Hand the frame to the native writer thread so encoding/IO overlaps
    with device compute (progressive previews, checkpoint-time snapshots).
    Falls back to a synchronous write without the native runtime."""
    arr = np.asarray(image)
    if not (arr.dtype == np.float32 and _native.async_submit(path, arr, png=True)):
        write_png(path, arr)


def flush_async_writes() -> None:
    """Wait for all async frames to reach disk; raises on writer errors."""
    errs = _native.async_wait()
    if errs:
        raise IOError(f"{errs} async image write(s) failed")


def read_ppm(path: str) -> np.ndarray:
    """Read a P3 PPM back into uint8 [H,W,3] (for tests/round-trips)."""
    with open(path) as f:
        tokens = f.read().split()
    assert tokens[0] == "P3"
    w, h, maxv = int(tokens[1]), int(tokens[2]), int(tokens[3])
    vals = np.array(tokens[4 : 4 + w * h * 3], dtype=np.int32)
    assert maxv == 255
    return vals.reshape(h, w, 3).astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """Read an RGB8 PNG written by ``write_png`` back into uint8 [H,W,3]
    (filter type 0 rows, as both writers emit; for tests and checks)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        tag, body = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + n]
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", body[:10])
            if (depth, ctype) != (8, 2):
                raise ValueError(f"{path}: not an RGB8 PNG")
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    if np.any(rows[:, 0]):
        raise ValueError(f"{path}: filtered rows are not supported")
    return rows[:, 1:].reshape(h, w, 3).copy()
