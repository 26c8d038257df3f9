"""8-bit PNG reading and writing without cv2 or PIL (the reference reads
and writes its TUM directories with cv2.imread/imwrite).

`read_gray` decodes 8-bit greyscale and 8-bit RGB files (no interlacing)
with the standard library's zlib, undoes the five row filters and turns
RGB into grey as `cv2.imread(path, cv2.IMREAD_GRAYSCALE)` does: cv2 hands
the conversion to libpng's `png_set_rgb_to_gray(0.299, 0.587)`, whose
15-bit coefficients are truncated from 1e-5 units (9797, 19234, and 3737
for blue) and whose sum is truncated, `(9797 R + 19234 G + 3737 B) >> 15`
(measured equal to cv2 5.0 on random images; cvtColor's rounded 14-bit
coefficients differ in the last bit). `write_gray` writes a greyscale file
and `write_bgr` a colour one from a BGR array (cv2.imwrite's order), with
filter 0 on every row.

The Average and Paeth filters depend on the reconstructed byte to the left.
The rows are undone by `native/png_unfilter.cpp`, built with g++ at first
use as `native/mapgraph.cpp` is; `unfilter_py` is the plain version (the
same result, tens of times slower) and serves where there is no toolchain.
"""
from __future__ import annotations

import ctypes
import struct
import threading
import zlib
from pathlib import Path

import numpy as np

from ..native import load_library

_SIG = b"\x89PNG\r\n\x1a\n"
_SRC = Path(__file__).resolve().parents[1] / "native" / "png_unfilter.cpp"
_lock = threading.Lock()
_lib = None
_failed = False


def _native():
    """The loaded unfilter library, or None without a toolchain."""
    global _lib, _failed
    with _lock:
        if _lib is None and not _failed:
            lib = load_library(_SRC)
            if lib is None:
                _failed = True
            else:
                u8p = ctypes.POINTER(ctypes.c_uint8)
                lib.png_unfilter.restype = ctypes.c_int
                lib.png_unfilter.argtypes = [u8p, u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
                _lib = lib
        return _lib


def unfilter_py(raw: np.ndarray, height: int, rowbytes: int, bpp: int) -> np.ndarray:
    """The plain version of the row unfiltering: None, Sub and Up row by row
    in numpy, Average and Paeth byte by byte."""
    rows = raw.reshape(height, rowbytes + 1)
    out = np.zeros((height, rowbytes), np.uint8)
    prev = np.zeros(rowbytes, np.int64)
    for y in range(height):
        ftype, f = int(rows[y, 0]), rows[y, 1:].astype(np.int64)
        if ftype == 0:
            cur = f
        elif ftype == 1:
            cur = np.cumsum(f.reshape(-1, bpp), axis=0).reshape(-1) & 255
        elif ftype == 2:
            cur = (f + prev) & 255
        elif ftype in (3, 4):
            cur = np.zeros(rowbytes, np.int64)
            for x in range(rowbytes):
                a = int(cur[x - bpp]) if x >= bpp else 0
                b = int(prev[x])
                if ftype == 3:
                    p = (a + b) >> 1
                else:
                    c = int(prev[x - bpp]) if x >= bpp else 0
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    p = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                cur[x] = (int(f[x]) + p) & 255
        else:
            raise ValueError(f"PNG row {y} has unknown filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


def _unfilter(raw: np.ndarray, height: int, rowbytes: int, bpp: int) -> np.ndarray:
    if raw.size != height * (rowbytes + 1):
        raise ValueError(f"{raw.size} bytes of image data for {height} rows of {rowbytes}")
    lib = _native()
    if lib is None:
        return unfilter_py(raw, height, rowbytes, bpp)
    raw = np.ascontiguousarray(raw, np.uint8)
    out = np.empty((height, rowbytes), np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    bad = lib.png_unfilter(raw.ctypes.data_as(u8p), out.ctypes.data_as(u8p), height,
                           rowbytes, bpp)
    if bad:
        raise ValueError(f"PNG row {bad - 1} has an unknown filter type")
    return out


def _chunks(data: bytes):
    if data[:8] != _SIG:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        n, typ = struct.unpack(">I4s", data[pos:pos + 8])
        yield typ, data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if typ == b"IEND":
            return


def read_gray(path: str) -> np.ndarray:
    """A (H, W) uint8 image from an 8-bit greyscale or RGB PNG, RGB turned
    into grey as cv2.imread(path, IMREAD_GRAYSCALE) does."""
    with open(path, "rb") as f:
        data = f.read()
    ihdr, idat = None, []
    for typ, body in _chunks(data):
        if typ == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif typ == b"IDAT":
            idat.append(body)
    if ihdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, _, _, interlace = ihdr
    if depth != 8 or color not in (0, 2) or interlace != 0:
        raise ValueError(f"{path}: only 8-bit greyscale or RGB PNGs without interlacing "
                         f"are read (bit depth {depth}, colour type {color}, "
                         f"interlace {interlace})")
    bpp = 1 if color == 0 else 3
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    px = _unfilter(raw, h, w * bpp, bpp)
    if color == 0:
        return px
    rgb = px.reshape(h, w, 3).astype(np.int64)
    return ((9797 * rgb[..., 0] + 19234 * rgb[..., 1] + 3737 * rgb[..., 2]) >> 15).astype(np.uint8)


def _write(path: str, rows: np.ndarray, color_type: int):
    """Write (H, W * channels) uint8 rows as an 8-bit PNG, filter 0."""
    h, rowbytes = rows.shape
    w = rowbytes // (3 if color_type == 2 else 1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()

    def chunk(typ: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + typ + body
                + struct.pack(">I", zlib.crc32(typ + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(_SIG + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def write_gray(path: str, img: np.ndarray):
    """Write a (H, W) uint8 image as an 8-bit greyscale PNG (filter 0)."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 2:
        raise ValueError(f"write_gray takes a (H, W) image, got {img.shape}")
    _write(path, img, 0)


def write_bgr(path: str, img: np.ndarray):
    """Write a (H, W, 3) uint8 BGR image (cv2's channel order, as
    cv2.imwrite takes it) as an 8-bit RGB PNG (filter 0)."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"write_bgr takes a (H, W, 3) image, got {img.shape}")
    _write(path, np.ascontiguousarray(img[..., ::-1]).reshape(img.shape[0], -1), 2)
