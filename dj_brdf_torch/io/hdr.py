"""Radiance RGBE (.hdr) image I/O.

The reference's environment emitters are HDR lat-long images
(mitsuba/README:21-23). :func:`load_hdr` is a numpy decoder that
rejects every malformed scanline the native decoder
(:func:`dj_brdf_torch.io.native.load_hdr`, ``csrc/djbio.cpp``) rejects,
with a ``ValueError``: a run or literal span past the end of the
scanline, an empty literal span, a flat-scanline repeat with nothing to
repeat or past the end, a truncated file. (The JAX package's numpy
decoder accepts some of these, ``dj_brdf_tpu/io/hdr.py:64``.)
:func:`write_hdr` is a minimal encoder (flat scanlines, which every
Radiance reader accepts).

Counterpart of ``dj_brdf_tpu/io/hdr.py``.
"""

from __future__ import annotations

import numpy as np


def _read_header(f):
    magic = f.readline()
    if not magic.startswith(b"#?"):
        raise ValueError("not a Radiance file (missing #? magic)")
    exposure = 1.0
    while True:
        line = f.readline()
        if not line:
            raise ValueError("truncated .hdr header")
        if line in (b"\n", b"\r\n"):
            break
        if line.startswith(b"EXPOSURE="):
            e = float(line[9:])
            if e > 0:
                exposure *= e
        if line.startswith(b"FORMAT=") and b"rgbe" not in line:
            raise ValueError(f"unsupported .hdr format: {line!r}")
    res = f.readline().split()
    if len(res) != 4 or res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError(f"unsupported .hdr resolution line: {res!r}")
    h, w = int(res[1]), int(res[3])
    if h <= 0 or w <= 0:
        raise ValueError(f"bad .hdr resolution {h} x {w}")
    return h, w, exposure


def _decode_rgbe(rgbe, inv_exposure):
    rgbe = rgbe.astype(np.int32)
    scale = np.where(rgbe[..., 3] == 0, 0.0,
                     np.ldexp(1.0, rgbe[..., 3] - 136)) * inv_exposure
    return (rgbe[..., :3] * scale[..., None]).astype(np.float32)


def _malformed(j, what):
    raise ValueError(f"malformed .hdr scanline {j}: {what}")


def _rle_scanline(data, pos, w, j, row):
    """One adaptive-RLE scanline (4 component planes of runs and literal
    spans) into ``row`` (w, 4); returns the new position."""
    for comp in range(4):
        i = 0
        while i < w:
            if pos >= len(data):
                _malformed(j, "truncated")
            count = data[pos]
            pos += 1
            if count > 128:                      # run
                count -= 128
                if pos >= len(data):
                    _malformed(j, "truncated run")
                if i + count > w:
                    _malformed(j, "run past the end of the scanline")
                row[i:i + count, comp] = data[pos]
                pos += 1
            else:                                # literal span
                if count == 0 or i + count > w:
                    _malformed(j, "empty literal span or one past the end")
                if pos + count > len(data):
                    _malformed(j, "truncated literal span")
                row[i:i + count, comp] = np.frombuffer(data, np.uint8,
                                                       count, pos)
                pos += count
            i += count
    return pos


def _flat_scanline(data, pos, w, j, row):
    """One flat / old-style scanline with (1, 1, 1, n) repeats of the
    previous pixel into ``row``; returns the new position."""
    i = 0
    shift = 0
    while i < w:
        if pos + 4 > len(data):
            _malformed(j, "truncated")
        px = np.frombuffer(data, np.uint8, 4, pos)
        pos += 4
        if px[0] == 1 and px[1] == 1 and px[2] == 1:
            count = int(px[3]) << shift
            if i == 0 or i + count > w:
                _malformed(j, "repeat with nothing to repeat or past the "
                              "end of the scanline")
            row[i:i + count] = row[i - 1]
            i += count
            shift += 8
        else:
            row[i] = px
            i += 1
            shift = 0
    return pos


def load_hdr(path: str) -> np.ndarray:
    """Decode a .hdr file to (h, w, 3) float32 radiance with numpy;
    raises ``ValueError`` for a malformed file."""
    with open(path, "rb") as f:
        h, w, exposure = _read_header(f)
        data = f.read()
    out = np.empty((h, w, 4), np.uint8)
    pos = 0
    for j in range(h):
        if (pos + 4 <= len(data) and data[pos] == 2 and data[pos + 1] == 2
                and (data[pos + 2] << 8 | data[pos + 3]) == w
                and 8 <= w < 32768):
            pos = _rle_scanline(data, pos + 4, w, j, out[j])
        else:
            pos = _flat_scanline(data, pos, w, j, out[j])
    return _decode_rgbe(out, 1.0 / exposure)


def write_hdr(path: str, img) -> None:
    """Encode (h, w, 3) float radiance (numpy or a tensor) as .hdr (flat
    scanlines)."""
    if hasattr(img, "detach"):
        img = img.detach().cpu().numpy()
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    m = img.max(-1)
    exp = np.where(m > 1e-32, np.floor(np.log2(np.maximum(m, 1e-32))) + 1, 0)
    # max channel's mantissa lands in [128, 256): full 8-bit precision
    mant = np.clip(img * np.exp2(8.0 - exp)[..., None], 0, 255)
    rgbe = np.empty((h, w, 4), np.uint8)
    rgbe[..., :3] = mant.astype(np.uint8)
    rgbe[..., 3] = np.where(m > 1e-32, exp + 128, 0).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())


def load_radiance_any(path: str) -> np.ndarray:
    """Load an (h, w, 3) radiance image from .npy or .hdr (the front
    door for environment maps). A .hdr goes through the native decoder;
    a file it rejects raises."""
    if str(path).endswith(".npy"):
        return np.load(path).astype(np.float32)
    from dj_brdf_torch.io import native
    return native.load_hdr(path)
