"""A small PNG codec: 8-bit greyscale (L), RGB and RGBA images,
non-interlaced, read and written with the standard library's ``zlib``
and ``struct`` and numpy.

The JAX package's programs read and write PNG through PIL
(``cli/dmap2nmap.py``, ``cli/nmap2leanmap.py``, ``cli/render.py``); the
port's programs use this codec, so they need no imaging package. Reading
undoes all five row filters (None, Sub, Up, Average, Paeth), so files
written by other encoders load; writing uses filter None on every row.
:func:`to_luma` and :func:`to_rgb` convert as PIL's ``convert("L")`` and
``convert("RGB")`` do, bit for bit.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
#: PNG colour type -> channels (0 greyscale, 2 truecolour, 6 truecolour
#: with alpha)
CHANNELS = {0: 1, 2: 3, 6: 4}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, img) -> None:
    """Write an (H, W) greyscale, (H, W, 3) RGB or (H, W, 4) RGBA uint8
    image."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"write_png takes uint8 images, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    kinds = {c: t for t, c in CHANNELS.items()}
    if img.ndim != 3 or img.shape[2] not in kinds or 0 in img.shape[:2]:
        raise ValueError(f"write_png takes (H, W), (H, W, 3) or (H, W, 4) "
                         f"images, got {img.shape}")
    h, w, c = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),     # filter None
                           img.reshape(h, w * c)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, kinds[c], 0, 0, 0)
    with open(path, "wb") as fh:
        fh.write(SIGNATURE + _chunk(b"IHDR", header)
                 + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                 + _chunk(b"IEND", b""))


def _chunks(data: bytes):
    pos = len(SIGNATURE)
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if len(body) != length or zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {kind!r}: truncated or bad CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG: no IEND chunk")


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters (PNG spec 9.2): ``raw`` is h rows of a
    filter-type byte and ``stride`` filtered bytes."""
    rows = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.int32)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:].astype(np.int32)
        if kind == 0:
            cur = line
        elif kind == 1:                                   # Sub
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1)
        elif kind == 2:                                   # Up
            cur = line + prior
        elif kind in (3, 4):                              # Average, Paeth
            cur = line.copy()
            left = np.zeros(bpp, np.int32)
            for x in range(0, stride, bpp):
                up = prior[x:x + bpp]
                if kind == 3:
                    pred = (left + up) >> 1
                else:
                    upleft = prior[x - bpp:x] if x else np.zeros(bpp,
                                                                 np.int32)
                    pred = _paeth(left, up, upleft)
                left = (cur[x:x + bpp] + pred) & 0xFF
                cur[x:x + bpp] = left
        else:
            raise ValueError(f"PNG: unknown row filter {kind}")
        prior = cur & 0xFF
        out[y] = prior
    return out


def read_png(path: str) -> np.ndarray:
    """Read an 8-bit non-interlaced greyscale, RGB or RGBA PNG: uint8
    (H, W), (H, W, 3) or (H, W, 4). Other kinds raise ``ValueError``."""
    with open(path, "rb") as fh:
        data = fh.read()
    if not data.startswith(SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in CHANNELS or interlace != 0:
        raise ValueError(
            f"{path}: only 8-bit non-interlaced L, RGB and RGBA PNGs are "
            f"read, got bit depth {depth}, colour type {ctype}, interlace "
            f"{interlace}")
    c = CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (w * c + 1):
        raise ValueError(f"{path}: PNG image data of the wrong size")
    img = _unfilter(raw, h, w * c, c).reshape(h, w, c)
    return img[..., 0] if c == 1 else img


def to_luma(img: np.ndarray) -> np.ndarray:
    """uint8 greyscale of an image :func:`read_png` returns, as PIL's
    ``convert("L")``: ITU-R 601-2 luma, L = (19595 R + 38470 G + 7471 B
    + 0x8000) >> 16; alpha is dropped."""
    if img.ndim == 2:
        return img
    rgb = img[..., :3].astype(np.uint32)
    return ((19595 * rgb[..., 0] + 38470 * rgb[..., 1] + 7471 * rgb[..., 2]
             + 0x8000) >> 16).astype(np.uint8)


def to_rgb(img: np.ndarray) -> np.ndarray:
    """uint8 (H, W, 3) of an image :func:`read_png` returns, as PIL's
    ``convert("RGB")``: greyscale repeated, alpha dropped."""
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])
