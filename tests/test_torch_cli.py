"""Port parity, programs: dj_brdf_torch.cli.render (every --model through
the sphere renderer, the path tracer, PNG output, the parse-time
errors), cli.plot_cdf, cli.dmap2nmap and cli.nmap2leanmap against the
JAX package's programs on the same files, and the port's PNG codec
(dj_brdf_torch.io.png) against PIL bit for bit.

The programs run in-process on the CPU (``--device cpu``). Tolerances:
the sphere images at the render parity tests' f32 tolerances (rtol 1e-4,
atol 1e-5 of the image's maximum), where a MERL lookup an ulp from a bin
edge, or a table entry one grid step off, may move a pixel: at most
MAX_FLIPS of them (tests/test_torch_render.py, tests/test_torch_merl.py).
"""

import os
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from dj_brdf_tpu.cli import dmap2nmap as jdmap
from dj_brdf_tpu.cli import nmap2leanmap as jlean
from dj_brdf_tpu.cli import plot_cdf as jplot
from dj_brdf_tpu.cli import render as jrender
from dj_brdf_torch import fresnel
from dj_brdf_torch.cli import dmap2nmap as tdmap
from dj_brdf_torch.cli import nmap2leanmap as tlean
from dj_brdf_torch.cli import plot_cdf as tplot
from dj_brdf_torch.cli import render as trender
from dj_brdf_torch.fit.tabular import microfacet_eval_fn
from dj_brdf_torch.io import merl_io, png, synth, utia_io
from dj_brdf_torch.microfacet.ndf import GGX, Beckmann
from dj_brdf_torch.microfacet.params import MicrofacetParams
from dj_brdf_torch.render import pathtrace
from dj_brdf_torch.render.envmap import EnvMap
from dj_brdf_torch.render.materials import MicrofacetMaterial

MAX_FLIPS = 1 / 256
RES = 24


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A MERL file (GGX 0.3, Schlick), a UTIA file (anisotropic GGX), a
    displacement PNG written by PIL, LEAN maps, roughness maps and an
    envmap, all from numpy seeds."""
    d = tmp_path_factory.mktemp("cli")
    out = {"dir": d}
    ggx = microfacet_eval_fn(GGX(), fresnel.Schlick(
        f0=torch.tensor([0.9, 0.6, 0.3])), MicrofacetParams.isotropic(
            torch.tensor(0.3)))
    out["merl"] = str(d / "m.binary")
    merl_io.save_merl(out["merl"], synth.bake_merl(ggx, "cpu"))
    aniso = microfacet_eval_fn(GGX(), fresnel.Schlick(
        f0=torch.tensor([0.6, 0.6, 0.6])), MicrofacetParams.elliptic(
            torch.tensor(0.4), torch.tensor(0.2), torch.tensor(0.5)))
    out["utia"] = str(d / "u.bin")
    utia_io.save_utia(out["utia"], synth.bake_utia(aniso, "cpu"))
    h = w = 32
    y, x = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    dmap = (127.5 + 127.5 * np.sin(2 * np.pi * x / w)
            * np.cos(2 * np.pi * y / h)).astype(np.uint8)
    out["dmap"] = str(d / "dmap.png")
    Image.fromarray(dmap, "L").save(out["dmap"])
    out["nmap"] = str(d / "nmap.png")
    assert jdmap.main([out["dmap"], "--scale", "0.08", "-o",
                       out["nmap"]]) == 0
    out["l1"], out["l2"] = str(d / "l1.npy"), str(d / "l2.npy")
    assert jlean.main([out["nmap"], "--base-roughness", "0.15", "--out1",
                       out["l1"], "--out2", out["l2"]]) == 0
    a1 = (0.05 + 0.5 * ((x[:16, :16] + y[:16, :16]) % 2)).astype(np.float32)
    out["a1"] = str(d / "a1.npy")
    np.save(out["a1"], a1)
    out["env"] = str(d / "env.npy")
    np.save(out["env"], np.random.default_rng(0).uniform(
        0.2, 1.5, (8, 16, 3)).astype(np.float32))
    return out


MODELS = {
    "ggx": ["--alpha1", "0.3", "--alpha2", "0.1", "--alpha-angle", "0.4"],
    "beckmann": ["--alpha1", "0.25", "--f0", "0.9", "0.6", "0.3"],
    "lambert": ["--f0", "0.5", "0.6", "0.7"],
    "merl": ["--file", "{merl}"],
    "utia": ["--file", "{utia}"],
    "sgd": ["--material", "gold-metallic-paint"],
    "abc": ["--material", "alum-bronze"],
    "merl_fit": ["--file", "{merl}", "--fit-res", "32"],
    "merl_tab": ["--file", "{merl}", "--fit-res", "32"],
    "utia_fit": ["--file", "{utia}", "--fit-res", "8"],
    "utia_tab": ["--file", "{utia}", "--fit-res", "8"],
    "lean": ["--leanmap1", "{l1}", "--leanmap2", "{l2}", "--alpha1", "0.1",
             "--mip", "1"],
    "ggx-textured": ["--alpha1-map", "{a1}", "--alpha2", "0.1"],
    "merl_tab-textured": ["--file", "{merl}", "--fit-res", "24",
                          "--alpha1-map", "{a1}"],
    "ggx-conductor": ["--alpha1", "0.2", "--conductor"],
}


def argv(case, files, out, *extra):
    model = case.split("-")[0]
    args = [a.format(**files) for a in MODELS[case]]
    return ["--model", model, *args, "--res", str(RES), "-o", out, *extra]


def image_close(got, want, rtol=1e-4, atol_rel=1e-5):
    assert got.shape == want.shape and np.isfinite(got).all()
    bad = np.abs(got - want) > atol_rel * np.abs(want).max() + rtol * np.abs(
        want)
    flips = bad.any(-1).sum()
    assert flips <= MAX_FLIPS * bad[..., 0].size, (
        flips, float(np.abs(got - want).max()))


@pytest.mark.parametrize("case", sorted(MODELS))
def test_render_sphere_matches_jax(case, files, tmp_path):
    """Each model through the sphere renderer, to .npy, against the JAX
    program on the same files."""
    tout, jout = str(tmp_path / "t.npy"), str(tmp_path / "j.npy")
    assert trender.main(argv(case, files, tout, "--device", "cpu")) == 0
    assert jrender.main(argv(case, files, jout)) == 0
    got, want = np.load(tout), np.load(jout)
    assert got.shape == (RES, RES, 3) and got.max() > 0.0
    image_close(got, want)


def test_render_png_is_the_tonemapped_image(files, tmp_path):
    """PNG output through the port's codec: the clipped, gamma-encoded
    image quantised as the JAX program quantises it, readable by PIL."""
    npy, out = str(tmp_path / "r.npy"), str(tmp_path / "r.png")
    args = argv("ggx", files, npy, "--device", "cpu", "--exposure", "1.5")
    assert trender.main(args) == 0
    assert trender.main(args[:-4] + ["-o", out, "--device", "cpu",
                                     "--exposure", "1.5"]) == 0
    img = torch.from_numpy(np.load(npy))
    want = ((torch.clamp(img * 1.5, 0.0, 1.0) ** (1 / 2.2)).numpy()
            * 255).astype(np.uint8)
    np.testing.assert_array_equal(np.asarray(Image.open(out)), want)
    np.testing.assert_array_equal(png.read_png(out), want)
    assert want.max() > 30


def pt_scene(floor_model):
    sphere = MicrofacetMaterial(
        dist=GGX(), fres=fresnel.Schlick(f0=torch.ones(3)),
        params=MicrofacetParams.elliptic(torch.tensor(0.3),
                                         torch.tensor(0.1),
                                         torch.tensor(0.0)))
    floor = MicrofacetMaterial(
        dist=GGX() if floor_model == "ggx" else Beckmann(),
        fres=fresnel.Schlick(f0=torch.full((3,), 0.35)),
        params=MicrofacetParams.isotropic(torch.tensor(0.4)))
    return sphere, floor


@pytest.mark.parametrize("envmap", [False, True], ids=["light", "envmap"])
def test_render_pathtrace_is_the_render_call(files, tmp_path, envmap):
    """``--pathtrace``: the program's image is the port's ``render`` of
    the same materials with a generator seeded 0 (the RNGs differ from
    JAX's, so there is no JAX image to compare); and JAX's program takes
    the same arguments and gives a finite image of the shape."""
    out = str(tmp_path / "pt.npy")
    extra = ["--pathtrace", "--spp", "2", "--bounces", "2",
             "--floor-model", "beckmann"]
    if envmap:
        extra += ["--envmap", files["env"], "--envmap-rot-z", "30"]
    args = argv("ggx", files, out, *extra)
    args[args.index("--alpha-angle") + 1] = "0.0"
    args[args.index("--alpha2") + 1] = "0.1"
    assert trender.main(args + ["--device", "cpu"]) == 0
    em = None
    if envmap:
        em = EnvMap.build(torch.from_numpy(np.load(files["env"])),
                          rotation=EnvMap.rotation_z(np.deg2rad(30.0),
                                                     device="cpu"),
                          device="cpu")
    want = pathtrace.render(*pt_scene("beckmann"), (0.3, 0.4, 0.8),
                            (3.0, 3.0, 3.0), (0.3, 0.38, 0.5), res=RES,
                            spp=2, max_bounces=2, envmap=em,
                            generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(np.load(out), want.numpy())
    jout = str(tmp_path / "j.npy")
    assert jrender.main(args[:args.index("-o")] + ["-o", jout]
                        + args[args.index("-o") + 2:]) == 0
    j = np.load(jout)
    assert j.shape == (RES, RES, 3) and np.isfinite(j).all()


@pytest.mark.parametrize("case", [
    ["--model", "lean"],                                   # no maps
    ["--model", "ggx", "--alpha1-map", "{a1}", "--pathtrace"],
    ["--model", "lambert", "--alpha1-map", "{a1}"],
    ["--model", "ggx", "--envmap", "{env}"],
    ["--model", "merl_tab", "--file", "{merl}", "--alpha1-map", "{a1}",
     "--pathtrace", "--floor-model", "lean", "--floor-leanmap1", "{l1}",
     "--floor-leanmap2", "{l2}"],
], ids=["lean-maps", "textured-lambert-floor", "textured-model",
        "envmap-sphere", "textured-tab-lean-floor"])
def test_render_parse_time_errors_match_jax(case, files, tmp_path):
    """What the JAX program refuses before rendering, the port refuses
    (exit code 2 from argparse)."""
    args = [a.format(**files) for a in case] + ["-o", str(tmp_path / "x")]
    with pytest.raises(SystemExit) as e:
        trender.main(args + ["--device", "cpu"])
    assert e.value.code == 2
    with pytest.raises(SystemExit) as e:
        jrender.main(args)
    assert e.value.code == 2


def test_render_refuses_conductor_on_textured_pathtrace(files, tmp_path):
    """The reference's fault (dj_brdf_tpu/cli/render.py:319): there
    --conductor is ignored without a word for a textured --pathtrace
    material. The port refuses it at parse time; no parity with JAX is
    asked for this input."""
    args = ["--model", "ggx", "--alpha1-map", files["a1"], "--pathtrace",
            "--floor-model", "ggx", "--conductor", "-o",
            str(tmp_path / "x.npy"), "--device", "cpu"]
    with pytest.raises(SystemExit) as e:
        trender.main(args)
    assert e.value.code == 2


@pytest.mark.parametrize("qf", [False, True], ids=["cdf", "qf"])
def test_plot_cdf_matches_jax(qf, tmp_path):
    """The four text files against the JAX program's, rtol 1e-5."""
    tdir, jdir = tmp_path / "t", tmp_path / "j"
    tdir.mkdir()
    jdir.mkdir()
    extra = ["--qf"] if qf else []
    assert tplot.main(["--res", "48", "--outdir", str(tdir), "--device",
                       "cpu", *extra]) == 0
    assert jplot.main(["--res", "48", "--outdir", str(jdir), *extra]) == 0
    kind = "qf" if qf else "cdf"
    names = [f"eval_{kind}_{d}{t}.txt" for d in ("beckmann", "ggx")
             for t in ("", "_tab")]
    assert sorted(os.listdir(tdir)) == sorted(names)
    for name in names:
        got, want = np.loadtxt(tdir / name), np.loadtxt(jdir / name)
        assert got.shape == (89, 2)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7,
                                   err_msg=name)


@pytest.mark.parametrize("clamp", [False, True], ids=["repeat", "clamp"])
def test_dmap2nmap_matches_jax(files, tmp_path, clamp):
    """The normal map PNG of the same displacement PNG: the packed
    normals within one 8-bit step of JAX's (0.5 n + 0.5 rounds in f32 in
    another order before the truncation to uint8), nearly all equal."""
    tout, jout = str(tmp_path / "t.png"), str(tmp_path / "j.png")
    extra = ["--clamp_to_border"] if clamp else []
    assert tdmap.main([files["dmap"], "--scale", "0.08", "-o", tout,
                       "--device", "cpu", *extra]) == 0
    assert jdmap.main([files["dmap"], "--scale", "0.08", "-o", jout,
                       *extra]) == 0
    got = np.asarray(Image.open(tout)).astype(int)
    want = np.asarray(Image.open(jout)).astype(int)
    assert got.shape == want.shape == (32, 32, 3)
    assert np.abs(got - want).max() <= 1
    assert (got != want).mean() <= 0.01


@pytest.mark.parametrize("biased", [False, True], ids=["plain", "biased"])
def test_nmap2leanmap_matches_jax(files, tmp_path, biased):
    """The two LEAN map planes of the same normal-map PNG, rtol 1e-5."""
    outs = {k: str(tmp_path / f"{k}.npy") for k in ("t1", "t2", "j1", "j2")}
    extra = ["--biased"] if biased else []
    assert tlean.main([files["nmap"], "--base-roughness", "0.15", "--out1",
                       outs["t1"], "--out2", outs["t2"], "--device", "cpu",
                       *extra]) == 0
    assert jlean.main([files["nmap"], "--base-roughness", "0.15", "--out1",
                       outs["j1"], "--out2", outs["j2"], *extra]) == 0
    for k in ("1", "2"):
        got, want = np.load(outs["t" + k]), np.load(outs["j" + k])
        assert got.shape == (32, 32, 4) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_cli_refuses_a_missing_card(files, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without CUDA")
    for main, args in ((trender.main, ["--model", "ggx"]),
                       (tdmap.main, [files["dmap"]]),
                       (tplot.main, [])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(args + ["-o" if main is not tplot.main else "--outdir",
                         str(tmp_path)])


# ---------------------------------------------------------- the codec

def images(seed=0):
    rng = np.random.default_rng(seed)
    for shape in ((1, 1), (7, 13), (32, 33), (5, 9, 3), (16, 31, 3),
                  (3, 4, 4), (17, 6, 4)):
        yield rng.integers(0, 256, shape, dtype=np.uint8)


def mode(img):
    return "L" if img.ndim == 2 else {3: "RGB", 4: "RGBA"}[img.shape[2]]


@pytest.mark.parametrize("k", range(7))
def test_codec_writes_what_pil_reads(k, tmp_path):
    img = list(images())[k]
    path = str(tmp_path / "a.png")
    png.write_png(path, img)
    pil = Image.open(path)
    assert pil.mode == mode(img)
    np.testing.assert_array_equal(np.asarray(pil), img)
    np.testing.assert_array_equal(png.read_png(path), img)


@pytest.mark.parametrize("k", range(7))
@pytest.mark.parametrize("optimize", [False, True])
def test_codec_reads_what_pil_writes(k, optimize, tmp_path):
    img = list(images(1))[k]
    path = str(tmp_path / "b.png")
    Image.fromarray(img).save(path, optimize=optimize)
    np.testing.assert_array_equal(png.read_png(path), img)


def filtered_png(path, img, kinds):
    """A PNG whose rows use the given filter types in turn, encoded here
    from the specification (9.2), to reach every filter on read."""
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    rows = img.reshape(h, w * c).astype(np.int32)
    out = []
    for y in range(h):
        kind = kinds[y % len(kinds)]
        cur = rows[y]
        prior = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(c, np.int32), cur[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int32), prior[:-c]])
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prior
        elif kind == 3:
            pred = (left + prior) // 2
        else:
            p = left + prior - upleft
            pa, pb, pc = (np.abs(p - left), np.abs(p - prior),
                          np.abs(p - upleft))
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prior, upleft))
        out.append(bytes([kind]) + ((cur - pred) & 0xFF).astype(
            np.uint8).tobytes())

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    ctype = {1: 0, 3: 2, 4: 6}[c]
    raw = zlib.compress(b"".join(out))
    with open(path, "wb") as fh:
        fh.write(png.SIGNATURE + chunk(b"IHDR", struct.pack(
            ">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", raw[:len(raw) // 2])      # two IDAT chunks
            + chunk(b"IDAT", raw[len(raw) // 2:]) + chunk(b"IEND", b""))


@pytest.mark.parametrize("kinds", [[0], [1], [2], [3], [4], [0, 1, 2, 3, 4]],
                         ids=["none", "sub", "up", "average", "paeth",
                              "mixed"])
def test_codec_undoes_every_row_filter(kinds, tmp_path):
    for k, img in enumerate(images(2)):
        path = str(tmp_path / f"f{k}.png")
        filtered_png(path, img, kinds)
        np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
        np.testing.assert_array_equal(png.read_png(path), img)


def test_codec_conversions_match_pil(tmp_path):
    """``to_luma``/``to_rgb`` against PIL's ``convert("L")`` and
    ``convert("RGB")``."""
    for img in images(3):
        pil = Image.fromarray(img)
        np.testing.assert_array_equal(png.to_luma(img),
                                      np.asarray(pil.convert("L")))
        np.testing.assert_array_equal(png.to_rgb(img),
                                      np.asarray(pil.convert("RGB")))


def test_codec_refuses_what_it_does_not_read(tmp_path):
    path = str(tmp_path / "p.png")
    Image.fromarray(np.zeros((4, 4), np.uint8)).convert("P").save(path)
    with pytest.raises(ValueError, match="colour type 3"):
        png.read_png(path)
    Image.fromarray(np.zeros((4, 4), np.uint16)).save(path)
    with pytest.raises(ValueError, match="bit depth 16"):
        png.read_png(path)
    good = str(tmp_path / "g.png")
    png.write_png(good, np.zeros((4, 4), np.uint8))
    data = bytearray(open(good, "rb").read())
    data[-20] ^= 0xFF                                  # inside IDAT
    open(path, "wb").write(bytes(data))
    with pytest.raises(ValueError):
        png.read_png(path)
    with pytest.raises(TypeError):
        png.write_png(path, np.zeros((4, 4), np.float32))
