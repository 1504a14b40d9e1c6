"""Port parity, the native data plane and .hdr I/O: the port's djbio
library (dj_brdf_torch/csrc/djbio.cpp through io.native) against the
JAX package's native library, numpy and the port's torch map builders;
io.hdr against both of JAX's decoders, and its rejection of malformed
scanlines, which JAX's numpy decoder accepts."""

import logging

import numpy as np
import pytest
import torch

from dj_brdf_tpu.io import hdr as jhdr
from dj_brdf_tpu.io import native as jnative
from dj_brdf_torch.io import hdr as thdr
from dj_brdf_torch.io import merl_io, native, utia_io
from dj_brdf_torch.lean import maps
from dj_brdf_torch.ops import _build


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_merl_parser_matches_jax_native_and_numpy(tmp_path):
    table = np.random.default_rng(0).uniform(0, 2, (3, 90, 90, 180))
    path = str(tmp_path / "t.binary")
    merl_io.save_merl(path, table)
    got = merl_io.load_merl(path)                     # native by default
    assert got.dtype == np.float32 and got.shape == (3, 90, 90, 180)
    np.testing.assert_array_equal(got, jnative.load_merl(path))
    np.testing.assert_array_equal(got, merl_io.load_merl(path,
                                                         use_native=False))


def test_utia_parser_matches_jax_native_and_numpy(tmp_path, caplog):
    """Bit for bit the JAX package's native parser; numpy within rtol
    1e-6 (the native scale is the float 1/140); negatives clamped and
    counted in the debug log."""
    table = np.random.default_rng(1).uniform(-0.5, 3, (3, 6, 48, 6, 48))
    path = str(tmp_path / "u.bin")
    utia_io.save_utia(path, table)
    with caplog.at_level(logging.DEBUG, logger="dj_brdf_torch"):
        got = utia_io.load_utia(path)
    assert f"clamped {int((table < 0).sum())} negative" in caplog.text
    assert got.min() >= 0.0
    np.testing.assert_array_equal(got, jnative.load_utia(path))
    np.testing.assert_allclose(got, utia_io.load_utia(path, use_native=False),
                               rtol=1e-6)


def test_a_file_the_parser_rejects_raises(tmp_path):
    short = tmp_path / "short.bin"
    short.write_bytes(np.zeros(100).tobytes())
    with pytest.raises(ValueError, match="djbt_load_utia"):
        utia_io.load_utia(str(short))
    with pytest.raises(ValueError, match="djbt_load_merl"):
        merl_io.load_merl(str(short))
    with pytest.raises(ValueError, match="djbt_load_merl"):
        merl_io.load_merl(str(tmp_path / "missing.binary"))


def test_a_failed_build_raises(tmp_path, monkeypatch):
    """No compiler: the library cannot be built, and loading a file
    raises instead of falling back to numpy."""
    def no_compiler():
        raise RuntimeError("g++ not found")

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_cxx", no_compiler)
    path = str(tmp_path / "u.bin")
    utia_io.save_utia(path, np.zeros((3, 6, 48, 6, 48)))
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        utia_io.load_utia(path)
    assert utia_io.load_utia(path, use_native=False).shape == (3, 6, 48, 6, 48)


@pytest.mark.parametrize("clamp", [False, True], ids=["repeat", "clamp"])
def test_dmap_to_nmap_matches_jax_native_and_torch(clamp):
    dmap = np.random.default_rng(2).uniform(0, 1, (64, 48)).astype(np.float32)
    got = native.dmap_to_nmap(dmap, 0.05, clamp)
    np.testing.assert_array_equal(got, jnative.dmap_to_nmap(dmap, 0.05, clamp))
    want = maps.dmap_to_nmap(torch.from_numpy(dmap), 0.05, clamp).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_lean_builders_match_jax_native_and_torch():
    """nmap_to_lean (biased) and one mip level: bit for bit JAX's native
    library, rtol 1e-5 (atol 1e-5) the torch versions, as
    tests/test_native.py holds JAX's."""
    dmap = np.random.default_rng(3).uniform(0, 1, (32, 32)).astype(np.float32)
    nmap = native.dmap_to_nmap(dmap, 0.1)
    lean = native.nmap_to_lean(nmap, 0.05, 25.0)
    np.testing.assert_array_equal(lean, jnative.nmap_to_lean(nmap, 0.05,
                                                             25.0))
    want = maps.nmap_to_lean(torch.from_numpy(nmap), 0.05, 25.0)
    planes = (want.E1, want.E2, want.E3, want.E4, want.E5)
    for k, plane in enumerate(planes):
        np.testing.assert_allclose(lean[k], plane.numpy(), rtol=1e-5,
                                   atol=1e-5)
    red = native.lean_mip_reduce(lean)
    np.testing.assert_array_equal(red, jnative.lean_mip_reduce(lean))
    want = maps.mip_reduce(want)
    for k, plane in enumerate((want.E1, want.E2, want.E3, want.E4, want.E5)):
        np.testing.assert_allclose(red[k], plane.numpy(), rtol=1e-5,
                                   atol=1e-5)


# ------------------------------------------------------------------- hdr

def rle_plane(values):
    """One component plane of an adaptive-RLE scanline: runs of 3 or more
    equal bytes (at most 127), literal spans (at most 128) between."""
    out, i, n = bytearray(), 0, len(values)
    while i < n:
        j = i
        while j < n and j - i < 127 and values[j] == values[i]:
            j += 1
        if j - i >= 3:
            out += bytes([128 + j - i, values[i]])
            i = j
            continue
        j = i
        while j < n and j - i < 128 and not (
                j + 2 < n and values[j] == values[j + 1] == values[j + 2]):
            j += 1
        out += bytes([j - i]) + bytes(values[i:j])
        i = j
    return bytes(out)


def hdr_bytes(scanlines, w, header=b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n"):
    return header + b"\n" + f"-Y {len(scanlines)} +X {w}\n".encode() \
        + b"".join(scanlines)


def rle_scanline(rgbe_row):
    w = rgbe_row.shape[0]
    return bytes([2, 2, w >> 8, w & 255]) + b"".join(
        rle_plane(rgbe_row[:, c].tolist()) for c in range(4))


def rgbe_image(rng, h, w):
    """RGBE texels with runs (a constant band) and literal spans."""
    px = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    px[..., 3] = rng.integers(120, 140, (h, w))
    px[:, 5:15] = px[:, 5:6]
    return px


def all_decoders(path):
    return {"port numpy": thdr.load_hdr(path),
            "port native": native.load_hdr(path),
            "jax numpy": jhdr.load_hdr(path),
            "jax native": jnative.load_hdr(path)}


def test_hdr_round_trip_and_decoders_agree_bit_for_bit(tmp_path):
    rng = np.random.default_rng(4)
    img = (rng.uniform(0, 1, (16, 32, 3)).astype(np.float32) ** 2) * 30.0
    path = str(tmp_path / "probe.hdr")
    thdr.write_hdr(path, torch.from_numpy(img))
    jhdr.write_hdr(str(tmp_path / "jax.hdr"), img)
    assert (tmp_path / "jax.hdr").read_bytes() == (tmp_path /
                                                   "probe.hdr").read_bytes()
    decoded = all_decoders(path)
    for name, got in decoded.items():
        np.testing.assert_array_equal(got, decoded["jax native"], name)
    # shared-exponent RGBE: error bounded by max-channel / 128
    bound = img.max(-1, keepdims=True) / 128.0 + 1e-9
    assert (np.abs(decoded["port numpy"] - img) <= bound).all()


def test_rle_and_exposure_decode_like_jax(tmp_path):
    """Adaptive-RLE scanlines (runs and literal spans) under an EXPOSURE
    header: all four decoders bit for bit."""
    px = rgbe_image(np.random.default_rng(5), 6, 40)
    path = tmp_path / "rle.hdr"
    path.write_bytes(hdr_bytes([rle_scanline(row) for row in px], 40,
                               b"#?RADIANCE\nEXPOSURE=2.5\n"
                               b"FORMAT=32-bit_rle_rgbe\n"))
    decoded = all_decoders(str(path))
    for name, got in decoded.items():
        np.testing.assert_array_equal(got, decoded["jax native"], name)
    assert decoded["port numpy"].shape == (6, 40, 3)


def malformed(w=8):
    """Scanlines the native decoder rejects (djbio.cpp's
    hdr_read_scanline): a run and a literal span past the end of the
    scanline, an empty literal span, a flat repeat with nothing to
    repeat, a file cut short."""
    head = bytes([2, 2, 0, w])
    good_plane = bytes([w]) + bytes(range(w))
    return {
        "run past the end": head + bytes([128 + w + 1, 7]),
        "literal past the end": head + bytes([w + 1]) + bytes(w + 1),
        "empty literal span": head + bytes([0]),
        "repeat with nothing to repeat": bytes([1, 1, 1, 3]) + bytes(4 * w),
        "truncated": head + good_plane * 2 + bytes([w]),
    }


@pytest.mark.parametrize("case", sorted(malformed()))
def test_malformed_scanlines_raise(tmp_path, case):
    """Where the native decoders return an error, the port's numpy
    decoder raises ValueError too. (JAX's numpy decoder accepts the run
    past the end, dj_brdf_tpu/io/hdr.py:64: its parity is not held on
    these inputs.)"""
    path = tmp_path / "bad.hdr"
    path.write_bytes(hdr_bytes([malformed()[case]], 8))
    with pytest.raises(ValueError, match="malformed"):
        thdr.load_hdr(str(path))
    with pytest.raises(ValueError, match="djbt_load_hdr"):
        native.load_hdr(str(path))
    with pytest.raises(ValueError):
        jnative.load_hdr(str(path))


def test_bad_headers_raise(tmp_path):
    path = tmp_path / "bad.hdr"
    for data in (b"P6\n", b"#?RADIANCE\nFORMAT=32-bit_rle_xyze\n\n-Y 1 +X 8\n",
                 b"#?RADIANCE\n\n+Y 1 -X 8\n", b"#?RADIANCE\n\n-Y 0 +X 8\n"):
        path.write_bytes(data)
        with pytest.raises(ValueError):
            thdr.load_hdr(str(path))
        with pytest.raises(ValueError):
            native.load_hdr(str(path))


def test_load_radiance_any(tmp_path):
    img = np.random.default_rng(6).uniform(0, 4, (8, 16, 3)).astype(
        np.float32)
    np.save(tmp_path / "env.npy", img)
    np.testing.assert_array_equal(
        thdr.load_radiance_any(str(tmp_path / "env.npy")), img)
    thdr.write_hdr(str(tmp_path / "env.hdr"), img)
    np.testing.assert_array_equal(
        thdr.load_radiance_any(str(tmp_path / "env.hdr")),
        jhdr.load_radiance_any(str(tmp_path / "env.hdr")))
