"""Image files to RGB pixels on the host, with no Pillow.

``decode_image_bytes(data)`` gives the uint8 ``[H, W, 3]`` array that
``np.asarray(Image.open(f).convert("RGB"))`` gives under Pillow with
libjpeg-turbo's decoding defaults, bit for bit, for

- JPEG: baseline, extended and progressive Huffman coding, 8-bit samples,
  restart intervals, 1 (gray), 3 (YCbCr, or RGB by Adobe transform 0 or
  component ids 'R', 'G', 'B') or 4 (Adobe CMYK / YCCK) components, any
  integral sampling ratio; a progressive file must be fully refined in its
  first AC coefficients (libjpeg smooths the blocks of one that is not);
- PNG: gray, gray + alpha, RGB, RGBA and palette at every bit depth the
  format allows, Adam7 interlaced or not (alpha and ``tRNS`` are dropped,
  as ``convert("RGB")`` drops them).

Anything else raises ``ValueError`` naming the file and what it is: GIF,
WebP, BMP, TIFF, arithmetic-coded, lossless or 12-bit JPEG, motion JPEG
without Huffman tables, and a truncated or corrupt stream (a truncated
file is never padded). No EXIF orientation is applied, as Pillow's
``open`` + ``convert`` applies none.

The JPEG decoder and the PNG unfiltering are C++ (``native/imagecodec.cc``),
built at first use with one ``g++`` call into ``native/build/`` beside it
(``native_build``: gitignored, named by a hash of the source, the
compiler, the flags and the host) and bound with ``ctypes``; a ctypes
call releases the GIL, so
decoding on a prefetch thread overlaps the device. A failed build raises:
there is no Python decoder. PNG chunks are parsed, and inflated with the
standard library's ``zlib``, here.
"""

from __future__ import annotations

import ctypes
import struct
import threading
import zlib
from pathlib import Path
from typing import Optional

import numpy as np

from mllm_sparse_retrieval_tpu_torch import native_build

SOURCE = Path(__file__).resolve().parent / "native" / "imagecodec.cc"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")
_ERR_LEN = 512
# Pillow's decompression-bomb limit (2 * Image.MAX_IMAGE_PIXELS): larger
# images are refused, as Pillow refuses them
MAX_PIXELS = 2 * 89_478_485

_lock = threading.Lock()
_libs = {}

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
# (PNG color type) -> (name, allowed bit depths)
_PNG_TYPES = {0: ("gray", (1, 2, 4, 8, 16)), 2: ("RGB", (8, 16)),
              3: ("palette", (1, 2, 4, 8)), 4: ("gray+alpha", (8, 16)),
              6: ("RGBA", (8, 16))}


def compiler() -> str:
    """The C++ compiler: ``$CXX``, else ``g++``."""
    return native_build.compiler()


def build() -> Path:
    """Compile the library unless it exists; raises with the compiler's
    output when the build fails."""
    return native_build.build(SOURCE, "libimagecodec", CXX_FLAGS,
                              "image codec")


def load() -> ctypes.CDLL:
    """Build (first use) and load the library; cached per process and per
    library path."""
    with _lock:
        so = build()
        lib = _libs.get(so)
        if lib is None:
            lib = ctypes.CDLL(str(so))
            buf, i32 = ctypes.c_char_p, ctypes.c_int
            ip = ctypes.POINTER(ctypes.c_int)
            i64 = ctypes.c_long
            lib.ic_jpeg_size.argtypes = [buf, i64, i64, ip, ip, buf, i32]
            lib.ic_jpeg_decode.argtypes = [buf, i64, i64, ctypes.c_void_p,
                                           buf, i32]
            lib.ic_png_pixels.argtypes = [
                buf, ctypes.c_long, i32, i32, i32, i32, i32, buf, i32,
                ctypes.c_void_p, buf, i32]
            for f in (lib.ic_jpeg_size, lib.ic_jpeg_decode,
                      lib.ic_png_pixels):
                f.restype = i32
            _libs[so] = lib
        return lib


def _check(rc: int, err, name: str) -> None:
    if rc != 0:
        raise ValueError(f"{name}: {err.value.decode(errors='replace')}")


def _check_size(width: int, height: int, name: str) -> None:
    if width * height > MAX_PIXELS:
        raise ValueError(f"{name}: {width} x {height} pixels exceed the "
                         f"limit of {MAX_PIXELS}")


def _format_name(data: bytes) -> Optional[str]:
    """The name of a format the decoder refuses, from its signature."""
    if data[:6] in (b"GIF87a", b"GIF89a"):
        return "GIF"
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "WebP"
    if data[:2] == b"BM":
        return "BMP"
    if data[:4] in (b"II*\0", b"MM\0*"):
        return "TIFF"
    if data[:4] == b"\0\0\1\0":
        return "ICO"
    return None


def _decode_jpeg(data: bytes, name: str) -> np.ndarray:
    lib = load()
    err = ctypes.create_string_buffer(_ERR_LEN)
    w, h = ctypes.c_int(), ctypes.c_int()
    # the frame header is checked against MAX_PIXELS before the decoder
    # allocates anything
    _check(lib.ic_jpeg_size(data, len(data), MAX_PIXELS, ctypes.byref(w),
                            ctypes.byref(h), err, _ERR_LEN), err, name)
    out = np.empty((h.value, w.value, 3), np.uint8)
    _check(lib.ic_jpeg_decode(data, len(data), MAX_PIXELS, out.ctypes.data,
                              err, _ERR_LEN), err, name)
    return out


def _png_raw_size(width: int, height: int, depth: int, color: int,
                  interlace: int) -> int:
    """Bytes of the inflated IDAT stream: each (Adam7 pass's) row with its
    filter byte."""
    chans = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    passes = ([(0, 0, 1, 1)] if not interlace else
              [(0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
               (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2)])
    size = 0
    for x0, y0, dx, dy in passes:
        w = (width - x0 + dx - 1) // dx
        h = (height - y0 + dy - 1) // dy
        if w > 0 and h > 0:
            size += h * (1 + (w * chans * depth + 7) // 8)
    return size


def _png_chunks(data: bytes, name: str):
    pos = len(_PNG_SIG)
    while True:
        if pos + 8 > len(data):
            raise ValueError(f"{name}: truncated PNG: no IEND chunk")
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 8 + length
        if end + 4 > len(data):
            raise ValueError(f"{name}: truncated PNG chunk "
                             f"{ctype.decode('latin-1')!r}")
        body = data[pos + 8:end]
        crc = struct.unpack(">I", data[end:end + 4])[0]
        if zlib.crc32(ctype + body) != crc:
            raise ValueError(f"{name}: corrupt PNG: bad checksum in chunk "
                             f"{ctype.decode('latin-1')!r}")
        yield ctype, body
        if ctype == b"IEND":
            return
        pos = end + 4


def _decode_png(data: bytes, name: str) -> np.ndarray:
    header = palette = None
    idat = []
    for ctype, body in _png_chunks(data, name):
        if ctype == b"IHDR":
            if len(body) != 13:
                raise ValueError(f"{name}: corrupt PNG header")
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            palette = body
        elif ctype == b"IDAT":
            idat.append(body)
    if header is None or not idat:
        raise ValueError(f"{name}: corrupt PNG: no IHDR or no IDAT chunk")
    width, height, depth, color, comp, filt, interlace = header
    kind = _PNG_TYPES.get(color)
    if kind is None or depth not in kind[1]:
        raise ValueError(f"{name}: PNG of color type {color} at bit depth "
                         f"{depth} is not a valid PNG")
    if comp != 0 or filt != 0 or interlace > 1 or width == 0 or height == 0:
        raise ValueError(f"{name}: corrupt PNG header")
    _check_size(width, height, name)
    if color == 3 and (palette is None or len(palette) % 3):
        raise ValueError(f"{name}: corrupt PNG: palette image without a "
                         f"valid PLTE chunk")
    # inflate no more than the image holds (a deflate bomb stops there);
    # data past it is ignored and a missing stream end accepted, as Pillow
    # ignores and accepts them
    need = _png_raw_size(width, height, depth, color, interlace)
    try:
        raw = zlib.decompressobj().decompress(b"".join(idat), need)
    except zlib.error as e:
        raise ValueError(f"{name}: corrupt PNG image data: {e}") from None
    if len(raw) < need:
        raise ValueError(f"{name}: truncated PNG image data")
    lib = load()
    err = ctypes.create_string_buffer(_ERR_LEN)
    out = np.empty((height, width, 3), np.uint8)
    pal = palette or b""
    _check(lib.ic_png_pixels(raw, len(raw), width, height, depth, color,
                             interlace, pal, len(pal) // 3, out.ctypes.data,
                             err, _ERR_LEN), err, name)
    return out


def decode_image_bytes(data: bytes, name: str = "<image bytes>"
                       ) -> np.ndarray:
    """A JPEG or PNG file's bytes -> uint8 ``[H, W, 3]`` RGB, bit-equal to
    Pillow's ``open`` + ``convert("RGB")``. Raises ``ValueError`` naming
    ``name`` and the refused format or fault."""
    data = bytes(data)
    if data[:3] == b"\xff\xd8\xff":
        return _decode_jpeg(data, name)
    if data[:8] == _PNG_SIG:
        return _decode_png(data, name)
    fmt = _format_name(data)
    if fmt is not None:
        raise ValueError(f"{name}: {fmt} files are not decoded (JPEG and "
                         f"PNG only)")
    raise ValueError(f"{name}: not a JPEG or PNG file")


def load_rgb(path) -> np.ndarray:
    """Read and decode an image file: uint8 ``[H, W, 3]``."""
    with open(path, "rb") as f:
        data = f.read()
    return decode_image_bytes(data, str(path))
