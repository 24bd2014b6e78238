"""Film output writers.

The reference's writer (src/Image.cpp:26-107) clamps to 255 and emits a
text P3 PPM when the name contains ".png" (misnamed on purpose there), else a
half-float BGR EXR (src/Helper.cpp:361-412). Here ".png" produces a real PNG
with the same clamp+truncate LDR semantics, ".ppm" the reference-compatible
text PPM, and anything else the EXR path. The PNG codec is the standard
library's zlib + struct over numpy: 8-bit, non-interlaced images, which is
what the renderer writes and what its texture images are.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from raytracer795.utils import exr

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
# channels per PNG colour type: gray, RGB, palette, gray+alpha, RGBA
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def to_ldr(image: np.ndarray) -> np.ndarray:
    """Clamp to 255 and truncate to uint8 ((unsigned char) cast semantics,
    src/Image.cpp:64-69,95)."""
    return np.clip(np.asarray(image), 0, 255).astype(np.uint8)


def write_ppm(path: str, image: np.ndarray) -> None:
    """Text P3 PPM, byte-identical layout to SavePng (src/Image.cpp:62-103)."""
    ldr = to_ldr(image)
    h, w = ldr.shape[:2]
    with open(path, "w") as f:
        f.write("P3\n")
        f.write(f"{w} {h}\n")
        f.write("255\n")
        for y in range(h):
            f.write(" ".join(str(int(v)) for v in ldr[y].reshape(-1)))
            f.write(" \n")


def read_ppm(path: str) -> np.ndarray:
    """Read a text P3 PPM into [H, W, 3] float32 (for golden comparisons)."""
    with open(path) as f:
        tok = f.read().split()
    assert tok[0] == "P3"
    w, h = int(tok[1]), int(tok[2])
    data = np.asarray(tok[4:4 + w * h * 3], dtype=np.float32)
    return data.reshape(h, w, 3)


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(tag + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", crc)


def write_png(path: str, image: np.ndarray) -> None:
    """8-bit RGB PNG of the clamped, truncated LDR image (filter 0 rows)."""
    ldr = np.ascontiguousarray(to_ldr(image)[..., :3])
    h, w = ldr.shape[:2]
    raw = np.zeros((h, 1 + w * 3), np.uint8)   # leading 0 = filter "None"
    raw[:, 1:] = ldr.reshape(h, w * 3)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_PNG_SIG + _png_chunk(b"IHDR", header)
                + _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + _png_chunk(b"IEND", b""))


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(data: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters (None, Sub, Up, Average, Paeth)."""
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    pos = 0
    for y in range(h):
        ftype = data[pos]
        row = np.frombuffer(data, np.uint8, stride, pos + 1).copy()
        pos += 1 + stride
        if ftype == 2:                              # Up
            row = (row.astype(np.uint16) + prev).astype(np.uint8)
        elif ftype in (1, 3, 4):                    # Sub, Average, Paeth
            r = bytearray(row)
            up = prev.tobytes()
            for i in range(stride):
                left = r[i - bpp] if i >= bpp else 0
                if ftype == 1:
                    pred = left
                elif ftype == 3:
                    pred = (left + up[i]) >> 1
                else:
                    pred = _paeth(left, up[i], up[i - bpp] if i >= bpp else 0)
                r[i] = (r[i] + pred) & 0xFF
            row = np.frombuffer(bytes(r), np.uint8)
        elif ftype != 0:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = row
        prev = row
    return out


def read_png(path: str) -> np.ndarray:
    """Decode an 8-bit non-interlaced PNG to [H, W, 3] uint8 RGB (alpha
    dropped, gray replicated, palette expanded)."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    idat = []
    palette = None
    header = None
    while pos < len(buf):
        (n,) = struct.unpack(">I", buf[pos:pos + 4])
        tag = buf[pos + 4:pos + 8]
        data = buf[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif tag == b"PLTE":
            palette = np.frombuffer(data, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(data)
        elif tag == b"IEND":
            break
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or interlace != 0 or ctype not in _PNG_CHANNELS:
        raise ValueError(f"{path}: only 8-bit non-interlaced PNG is "
                         f"supported (depth {depth}, colour type {ctype}, "
                         f"interlace {interlace})")
    ch = _PNG_CHANNELS[ctype]
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w * ch, ch)
    px = px.reshape(h, w, ch)
    if ctype == 3:
        return palette[px[..., 0]]
    if ch <= 2:                                     # gray (+ alpha)
        return np.repeat(px[..., :1], 3, axis=-1)
    return np.ascontiguousarray(px[..., :3])


def save_image(path: str, image: np.ndarray) -> None:
    """Name-dispatched writer mirroring Image::saveImage (src/Image.cpp:26-33)."""
    lower = path.lower()
    if lower.endswith(".ppm"):
        write_ppm(path, image)
    elif ".png" in lower:
        write_png(path, image)
    else:
        exr.write_exr(path, np.asarray(image, np.float32))
