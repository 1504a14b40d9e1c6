"""Port parity, measured data: dj_brdf_torch.models.merl, models.lambert,
io.merl_io, io.synth.bake_merl and fit.batch.merl_targets against the
JAX package on the same numpy inputs (f32), plus the fit on MERL
targets."""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dj_brdf_tpu import fresnel as jfres
from dj_brdf_tpu.core import math as jcm
from dj_brdf_tpu.fit import batch as jbatch
from dj_brdf_tpu.fit import tabular as jtab
from dj_brdf_tpu.io import merl_io as jio
from dj_brdf_tpu.io import synth as jsynth
from dj_brdf_tpu.microfacet import brdf as jmf
from dj_brdf_tpu.microfacet import ndf as jndf
from dj_brdf_tpu.microfacet.params import MicrofacetParams as JParams
from dj_brdf_tpu.models import merl as jmerl
from dj_brdf_tpu.models.lambert import Lambert as JLambert
from dj_brdf_torch import config, convert
from dj_brdf_torch import fresnel as tfres
from dj_brdf_torch.core import math as tcm
from dj_brdf_torch.fit import batch as tbatch
from dj_brdf_torch.fit import lsq as tlsq
from dj_brdf_torch.fit import tabular as ttab
from dj_brdf_torch.io import merl_io as tio
from dj_brdf_torch.io import synth as tsynth
from dj_brdf_torch.microfacet import brdf as tmf
from dj_brdf_torch.microfacet import ndf as tndf
from dj_brdf_torch.microfacet.params import MicrofacetParams as TParams
from dj_brdf_torch.models import merl as tmerl
from dj_brdf_torch.models.lambert import Lambert as TLambert
from dj_brdf_torch.ops import merl_gather as mg

# A direction within an ulp of a bin edge may land in the neighbouring
# bin in the other package (arccos/atan2 differ by an ulp between XLA
# and PyTorch): at most this share of samples may differ.
INDEX_MISMATCH = 1e-3
F0 = (0.9, 0.6, 0.3)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def hemi_dirs(rng, n, lo=0.0, hi=1.57):
    th = rng.uniform(lo, hi, n)
    ph = rng.uniform(0, 2 * np.pi, n)
    return np.stack([np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph),
                     np.cos(th)], -1).astype(np.float32)


def jax_ggx(alpha, f0=F0, kd=None):
    def eval_fn(i, o):
        spec = jmf.eval(jndf.GGX(), jfres.Schlick(f0=jnp.asarray(f0)),
                        JParams.isotropic(alpha), i, o)
        if kd is None:
            return spec
        return spec + JLambert(reflectance=jnp.asarray(kd)).eval(i, o)
    return eval_fn


def torch_ggx(alpha, f0=F0, kd=None):
    def eval_fn(i, o):
        spec = tmf.eval(tndf.GGX(), tfres.Schlick(f0=torch.tensor(f0)),
                        TParams.isotropic(alpha), i, o)
        if kd is None:
            return spec
        return spec + TLambert(reflectance=torch.tensor(kd)).eval(i, o)
    return eval_fn


@pytest.fixture(scope="module")
def baked():
    """JAX-baked raw tables (float32) of GGX+Schlick at two alphas."""
    return np.stack([jsynth.bake_merl(jax_ggx(a)).astype(np.float32)
                     for a in (0.2, 0.45)])


def both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays])


def test_hd_angles_match_jax():
    """rtol 1e-5, atol 1e-6 where arccos is well conditioned. Within
    0.15 rad of a pole an ulp of the cosine (6e-8) moves the angle by
    6e-8 / sin(theta), over 1e-5 of it, in either package (each lies
    up to 1.4e-5 from a float64 evaluation there), so there the cosines
    are held to atol 1e-6 instead."""
    rng = np.random.default_rng(0)
    (ji, jo), (ti, to) = both(hemi_dirs(rng, 20000), hemi_dirs(rng, 20000))
    want = [np.asarray(a) for a in jmerl.hd_angles(ji, jo)]
    got = [a.numpy() for a in tmerl.hd_angles(ti, to)]
    (jth, jtd, jpd), (tth, ttd, tpd) = want, got
    conditioned = (np.sin(jth) > 0.15) & (np.sin(jtd) > 0.15)
    assert conditioned.mean() > 0.8
    for w, g in ((jth, tth), (jtd, ttd), (jpd, tpd)):
        np.testing.assert_allclose(g[conditioned], w[conditioned],
                                   rtol=1e-5, atol=1e-6)
    for w, g in ((jth, tth), (jtd, ttd)):
        np.testing.assert_allclose(np.cos(g), np.cos(w), rtol=0, atol=1e-6)


def test_flat_index_and_bin_warps_match_jax():
    rng = np.random.default_rng(1)
    (ji, jo), (ti, to) = both(hemi_dirs(rng, 20000), hemi_dirs(rng, 20000))
    want = np.asarray(jmerl.merl_flat_index(ji, jo))
    got = tmerl.merl_flat_index(ti, to)
    assert got.dtype == torch.int32
    assert (got.numpy() != want).mean() <= INDEX_MISMATCH
    assert got.min() >= 0 and got.max() < tmerl.PLANE
    angles = rng.uniform(-3.2, 3.2, 20000).astype(np.float32)
    (ja,), (ta,) = both(angles)
    for name in ("theta_half_index", "theta_diff_index", "phi_diff_index"):
        w = np.asarray(getattr(jmerl, name)(ja))
        g = getattr(tmerl, name)(ta).numpy()
        assert (g != w).mean() <= INDEX_MISMATCH, name


def test_structured_grids_give_the_jax_bins():
    """The tabulation's quadrature directions: the retro-reflective
    slice of the kernel matrix (theta_h bin floor(90 k / 89) except at
    the pole clamp, hz > 0.99999, which puts k <= 4 in bin 0) and the
    Fresnel grid with i := z."""
    cnt = 89
    t = (np.arange(cnt, dtype=np.float32) / cnt) * np.float32(
        np.sqrt(np.pi * 0.5))
    theta = t * t
    d = np.stack([np.sin(theta), np.zeros_like(theta), np.cos(theta)], -1)
    (jd,), (td,) = both(d.astype(np.float32))
    got = tmerl.merl_flat_index(td, td).numpy()
    np.testing.assert_array_equal(got, np.asarray(jmerl.merl_flat_index(jd, jd)))
    k = np.arange(cnt)
    want_h = np.where(k <= 4, 0, np.floor(90 * k / 89)).astype(np.int32)
    np.testing.assert_array_equal(got // (90 * 180), want_h)

    half_pi = np.float32(np.pi * 0.5)
    th = (np.arange(2 * cnt, dtype=np.float32) / cnt) ** 2 * half_pi
    td_ = (np.arange(cnt, dtype=np.float32) / cnt) * half_pi
    TH, TD = np.meshgrid(th, td_)
    (jh, jdd), (th_, tdd) = both(TH, TD)
    _, jo = jcm.hd_to_io(jcm.from_spherical(jh, jnp.zeros_like(jh)),
                         jcm.from_spherical(jdd, jnp.full_like(jdd, half_pi)))
    _, to = tcm.hd_to_io(
        tcm.from_spherical(th_, torch.zeros_like(th_)),
        tcm.from_spherical(tdd, torch.full_like(tdd, float(half_pi))))
    jz = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), jo.shape)
    tz = torch.tensor([0.0, 0.0, 1.0]).expand(to.shape)
    got = tmerl.merl_flat_index(tz, to).numpy()
    want = np.asarray(jmerl.merl_flat_index(jz, jo))
    assert (got != want).mean() <= INDEX_MISMATCH


@pytest.mark.parametrize("fn", ["eval", "evalp"])
def test_merl_eval_matches_jax_where_indices_agree(baked, fn):
    rng = np.random.default_rng(2)
    # theta up to 1.6 rad: some directions lie below the horizon
    i, o = hemi_dirs(rng, 20000, hi=1.6), hemi_dirs(rng, 20000, hi=1.6)
    (ji, jo, jt), (ti, to, tt) = both(i, o, baked[0])
    want = np.asarray(getattr(jmerl.Merl(table=jt), fn)(ji, jo))
    got = getattr(tmerl.Merl(table=tt), fn)(ti, to).numpy()
    assert got.shape == (20000, 3) and got.dtype == np.float32
    same = (tmerl.merl_flat_index(ti, to).numpy()
            == np.asarray(jmerl.merl_flat_index(ji, jo)))
    assert same.mean() >= 1 - INDEX_MISMATCH
    np.testing.assert_array_equal(got[same], want[same])
    # below-horizon bins (raw -1) evaluate to exactly 0
    idx = tmerl.merl_flat_index(ti, to).numpy()
    below = baked[0].reshape(3, -1)[0, idx] < 0
    assert below.sum() > 100
    assert np.all(got[below] == 0.0)


def test_merl_stack_is_each_table(baked):
    rng = np.random.default_rng(3)
    i, o = (torch.from_numpy(hemi_dirs(rng, 3000)) for _ in range(2))
    tables = torch.from_numpy(baked)
    stack = tmerl.Merl(table=tables).evalp(i, o)
    assert stack.shape == (2, 3000, 3)
    for k in range(2):
        assert torch.equal(stack[k], tmerl.Merl(table=tables[k]).evalp(i, o))
    with pytest.raises(ValueError, match="MERL table"):
        tmerl.Merl(table=tables[..., :90]).eval(i, o)


def test_merl_debug_count_only_at_debug_level(baked, caplog):
    rng = np.random.default_rng(4)
    i, o = (torch.from_numpy(hemi_dirs(rng, 2000, hi=1.6)) for _ in range(2))
    model = tmerl.Merl(table=torch.from_numpy(baked[0]))
    with caplog.at_level(logging.INFO, logger=config.logger.name):
        model.eval(i, o)
    assert not caplog.records
    with caplog.at_level(logging.DEBUG, logger=config.logger.name):
        model.eval(i, o)
    assert any("below-horizon" in r.getMessage() for r in caplog.records)


@pytest.mark.parametrize("kd", [None, (0.2, 0.1, 0.05)],
                         ids=["ggx", "ggx+lambert"])
def test_bake_merl_matches_jax(kd):
    """rtol 1e-5, atol 1e-6 up to theta_d bin 71; in the grazing bins
    (theta_d > 72 deg) the f32 geometry is ill conditioned and each
    package lies up to 4e-4 from a float64 bake (measured at alpha 0.3),
    so there the two are held to rtol 1e-4 of each other. The -1 mask is
    the same everywhere."""
    want = jsynth.bake_merl(jax_ggx(0.3, kd=kd))
    got = tsynth.bake_merl(torch_ggx(0.3, kd=kd), "cpu")
    assert got.dtype == torch.float64 and got.shape == (3, 90, 90, 180)
    got = got.numpy()
    np.testing.assert_array_equal(got == -1.0, want == -1.0)
    assert (want == -1.0).any()
    np.testing.assert_allclose(got[:, :, :72], want[:, :, :72], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_lambert_matches_jax():
    rng = np.random.default_rng(5)
    (ji, jo), (ti, to) = both(hemi_dirs(rng, 100), hemi_dirs(rng, 100))
    kd = np.asarray([0.2, 0.5, 0.7], np.float32)
    for fn in ("eval", "evalp"):
        want = getattr(JLambert(reflectance=jnp.asarray(kd)), fn)(ji, jo)
        got = getattr(TLambert(reflectance=torch.from_numpy(kd)), fn)(ti, to)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_merl_files_round_trip_with_jax(baked, tmp_path):
    """Byte-equal files from both packages; a JAX-written file loads
    equal; the port's own round trip is exact."""
    tpath, jpath = tmp_path / "t.binary", tmp_path / "j.binary"
    tio.save_merl(str(tpath), torch.from_numpy(baked[0]))
    jio.save_merl(str(jpath), baked[0])
    assert tpath.read_bytes() == jpath.read_bytes()
    got = tio.load_merl(str(jpath))
    assert got.dtype == np.float32 and got.shape == (3, 90, 90, 180)
    np.testing.assert_array_equal(got, jio.load_merl(str(jpath),
                                                     use_native=False))
    tio.save_merl(str(tpath), got)
    assert tpath.read_bytes() == jpath.read_bytes()


def test_load_merl_refuses_bad_files(baked, tmp_path):
    path = tmp_path / "m.binary"
    tio.save_merl(str(path), baked[0])
    data = path.read_bytes()
    (tmp_path / "short.binary").write_bytes(data[:-8])
    with pytest.raises(ValueError, match="truncated"):
        tio.load_merl(str(tmp_path / "short.binary"))
    (tmp_path / "dims.binary").write_bytes(
        np.asarray([90, 90, 90], "<i4").tobytes() + data[12:])
    with pytest.raises(ValueError, match="dims"):
        tio.load_merl(str(tmp_path / "dims.binary"))
    (tmp_path / "empty.binary").write_bytes(b"")
    with pytest.raises(ValueError, match="header"):
        tio.load_merl(str(tmp_path / "empty.binary"))
    with pytest.raises(ValueError, match="MERL table"):
        tio.save_merl(str(path), baked[0, :2])


def test_merl_targets_match_jax_where_indices_agree(baked):
    rng = np.random.default_rng(6)
    (ji, jo, jt), (ti, to, tt) = both(hemi_dirs(rng, 4096),
                                      hemi_dirs(rng, 4096), baked)
    want = np.asarray(jbatch.merl_targets(jt, ji, jo))
    got = tbatch.merl_targets(tt, ti, to).numpy()
    assert got.shape == (2, 4096, 3)
    same = (tmerl.merl_flat_index(ti, to).numpy()
            == np.asarray(jmerl.merl_flat_index(ji, jo)))
    assert same.mean() >= 1 - INDEX_MISMATCH
    np.testing.assert_array_equal(got[:, same], want[:, same])


def test_fit_materials_on_merl_targets_matches_jax(baked):
    """M = 2, N = 2048, 50 steps, from the JAX package's targets."""
    rng = np.random.default_rng(7)
    i, o = hemi_dirs(rng, 2048, 0.03, 1.5), hemi_dirs(rng, 2048, 0.03, 1.5)
    (ji, jo, jt), (ti, to, _) = both(i, o, baked)
    targets = np.array(jbatch.merl_targets(jt, ji, jo))
    jp, _, jl = jbatch.fit_materials(jnp.asarray(targets), ji, jo, steps=50)
    tp, _, tl = tbatch.fit_materials(torch.from_numpy(targets), ti, to,
                                     steps=50)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-3)
    np.testing.assert_allclose(tp.ax.numpy(), np.asarray(jp.ax), rtol=1e-3)


def test_convert_merl_keeps_the_table(baked):
    model = convert.merl_from_jax(jmerl.Merl(table=jnp.asarray(baked[1])))
    assert model.table.dtype == torch.float32
    np.testing.assert_array_equal(model.table.numpy(), baked[1])


def test_microfacet_eval_fn_matches_jax():
    rng = np.random.default_rng(8)
    (ji, jo), (ti, to) = both(hemi_dirs(rng, 500), hemi_dirs(rng, 500))
    want = jtab.microfacet_eval_fn(
        jndf.GGX(), jfres.Schlick(f0=jnp.asarray(F0)),
        JParams.isotropic(0.3))(ji, jo)
    got = ttab.microfacet_eval_fn(
        tndf.GGX(), tfres.Schlick(f0=torch.tensor(F0)),
        TParams.isotropic(0.3))(ti, to)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=1e-6)


def test_lookup_stays_off_the_kernel_counter_on_cpu(baked):
    before = dict(mg.LAUNCHES)
    rng = np.random.default_rng(9)
    i, o = (torch.from_numpy(hemi_dirs(rng, 100)) for _ in range(2))
    tbatch.merl_targets(torch.from_numpy(baked), i, o)
    assert mg.LAUNCHES == before


def same_index(ti, to, ji, jo):
    return (tmerl.merl_flat_index(ti, to).numpy()
            == np.asarray(jmerl.merl_flat_index(ji, jo)))


@pytest.fixture(scope="module")
def baked64():
    """float64 bakes of the same two materials by each package (those of
    test_bake_merl_matches_jax): JAX's numpy table and the port's
    tensor, neither cast."""
    kds = (None, (0.2, 0.1, 0.05))
    jt = np.stack([jsynth.bake_merl(jax_ggx(0.3, kd=kd)) for kd in kds])
    tt = torch.stack([tsynth.bake_merl(torch_ggx(0.3, kd=kd), "cpu")
                      for kd in kds])
    assert jt.dtype == np.float64 and tt.dtype == torch.float64
    return jt, tt


def test_float64_bake_goes_through_targets_and_fit_without_a_cast(baked64):
    """bake -> merl_targets -> fit_materials on float64 stacks: the
    targets are float32 as JAX's are; from JAX's own table they equal
    JAX's bit for bit where the indices agree, from the port's bake at
    test_bake_merl_matches_jax's tolerance (rtol 1e-4); the fit runs
    and agrees with JAX's as test_fit_materials_on_merl_targets_matches_jax
    holds it (rtol 1e-3)."""
    jt, tt = baked64
    rng = np.random.default_rng(10)
    i, o = hemi_dirs(rng, 2048, 0.03, 1.5), hemi_dirs(rng, 2048, 0.03, 1.5)
    (ji, jo), (ti, to) = both(i, o)
    want = jbatch.merl_targets(jt, ji, jo)
    got = tbatch.merl_targets(tt, ti, to)
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    same = same_index(ti, to, ji, jo)
    assert same.mean() >= 1 - INDEX_MISMATCH
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy()[:, same], want[:, same],
                               rtol=1e-4, atol=1e-6)
    from_jax = tbatch.merl_targets(torch.from_numpy(jt), ti, to).numpy()
    np.testing.assert_array_equal(from_jax[:, same], want[:, same])

    jp, _, jl = jbatch.fit_materials(jnp.asarray(want), ji, jo, steps=30)
    tp, tf, tl = tbatch.fit_materials(got, ti, to, steps=30)
    assert tl.dtype == torch.float32 and torch.isfinite(tl).all()
    assert torch.isfinite(tf.f0).all()
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-3)
    np.testing.assert_allclose(tp.ax.numpy(), np.asarray(jp.ax), rtol=1e-3)
    # fit_lsq takes the same float64 data as well
    _, _, losses = tlsq.fit_lsq(tndf.GGX(), ti.double(), to.double(),
                                tt_targets(tt, ti, to), steps=3)
    assert losses.dtype == torch.float32 and torch.isfinite(losses).all()


def tt_targets(tt, ti, to):
    """Table 0's targets in float64, as a caller might hand them over."""
    return tbatch.merl_targets(tt[:1], ti, to)[0].double()


@pytest.fixture
def x64():
    """Both packages in float64 (JAX's x64, the port's use_x64), undone
    after the test."""
    jax.config.update("jax_enable_x64", True)
    config.use_x64(True)
    try:
        yield
    finally:
        config.use_x64(False)
        jax.config.update("jax_enable_x64", False)


def test_use_x64_keeps_merl_in_float64_on_the_cpu(baked64, x64):
    """Under x64 the JAX package looks the table up in float64 and its
    fit_materials fails; the port does both the same way on the CPU: a
    float64 lookup equal to JAX's where the indices agree, and a fit
    that raises a TypeError naming use_x64."""
    jt, tt = baked64
    rng = np.random.default_rng(11)
    (ji, jo), (ti, to) = both(hemi_dirs(rng, 1024, 0.03, 1.5),
                              hemi_dirs(rng, 1024, 0.03, 1.5))
    want = jbatch.merl_targets(jt, ji, jo)
    got = tbatch.merl_targets(torch.from_numpy(jt), ti, to)
    assert want.dtype == jnp.float64 and got.dtype == torch.float64
    same = same_index(ti, to, ji, jo)
    np.testing.assert_array_equal(got.numpy()[:, same],
                                  np.asarray(want)[:, same])
    # a float32 table takes float64 too
    assert tmerl.Merl(table=tt.float()).table.dtype == torch.float64
    with pytest.raises(ValueError, match="float32"):
        jbatch.fit_materials(want, ji, jo, steps=2)
    with pytest.raises(TypeError, match="use_x64"):
        tbatch.fit_materials(got, ti, to, steps=2)


def test_lookup_gradient_wrt_the_table_matches_jax_grad(baked):
    """The CPU lookup's backward (a scatter-add through the gather)
    against jax.grad of JAX's Merl.eval, at directions whose indices
    agree: rtol 1e-5 (sums in another order)."""
    rng = np.random.default_rng(12)
    i, o = hemi_dirs(rng, 6000, hi=1.6), hemi_dirs(rng, 6000, hi=1.6)
    (ji, jo), (ti, to) = both(i, o)
    keep = same_index(ti, to, ji, jo)
    i, o = i[keep], o[keep]
    w = rng.uniform(-1.0, 1.0, (i.shape[0], 3)).astype(np.float32)
    (ji, jo, jw, jt), (ti, to, tw, tt) = both(i, o, w, baked[0])

    def jloss(table):
        return jnp.sum(jmerl.Merl(table=table).evalp(ji, jo) * jw)

    want = np.asarray(jax.grad(jloss)(jt))
    tt.requires_grad_(True)
    torch.sum(tmerl.Merl(table=tt).evalp(ti, to) * tw).backward()
    got = tt.grad.numpy()
    assert np.count_nonzero(want) > 1000
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-12)
