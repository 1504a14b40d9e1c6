"""Port parity, K4: ``ggx_lsq_value_and_grad(..., adjoint="ad")``, the
autodiff cross-check of the fit step, against the JAX package's Pallas
kernel ``_kernel_ad`` in interpret mode (run as tests/test_ops.py runs
it), and against the port's own hand adjoint (K1's plain version).

The JAX side is imported inside a fixture, so that on a machine without
JAX (the GPU machine) those cases skip and the GPU-only cases run:
``python -m pytest --noconftest -q tests/test_torch_fused_ad.py``."""

import numpy as np
import pytest
import torch

from dj_brdf_torch.ops import fused_fit as ff
from dj_brdf_torch.ops import soa

TRUTH = [0.25, 0.25, 0.0, 0.0, 0.0, 0.9, 0.6, 0.3]
# raw_init's point, a moderate anisotropic one, an anisotropic
# off-centre one, and the extreme one of tests/test_ops.py
PVECS = [[0.3, 0.3, 0.0, 0.0, 0.0, 0.5, 0.5, 0.5],
         [0.4, 0.3, 0.1, 0.02, -0.03, 0.5, 0.5, 0.5],
         [0.35, 0.18, 0.25, 0.06, -0.04, 0.8, 0.5, 0.2],
         [0.05, 0.8, -0.7, 0.3, -0.2, 0.99, 0.01, 0.5]]
# The JAX kernel and the port's plain version both take exact divides
# and differentiate the same f32 loss; sums run in another order.
LOSS_RTOL = 1e-5
GRAD_RTOL = 3e-4
GRAD_ATOL_REL = 1e-5            # times max |grad| (K1's bound on the card)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's fused fit and SoA modules (JAX on the CPU)."""
    jax = pytest.importorskip("jax")
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from dj_brdf_tpu.ops import fused_fit as jff
    from dj_brdf_tpu.ops import soa as jsoa
    return jax, jnp, jff, jsoa


def batch(n, seed=0, device="cpu"):
    """Six (n,) f32 direction components (random, so no sample sits on
    a gate or a floor exactly: there forward and reverse mode split a
    tie differently) and the TRUTH material's GGX targets."""
    rng = np.random.default_rng(seed)
    th = rng.uniform(0.02, 1.55, (2, n))
    ph = rng.uniform(0, 2 * np.pi, (2, n))
    comp = [np.sin(th[0]) * np.cos(ph[0]), np.sin(th[0]) * np.sin(ph[0]),
            np.cos(th[0]), np.sin(th[1]) * np.cos(ph[1]),
            np.sin(th[1]) * np.sin(ph[1]), np.cos(th[1])]
    dirs = [torch.tensor(c, dtype=torch.float32, device=device) for c in comp]
    tgts = [t.contiguous() for t in soa.ggx_evalp_soa(
        torch.tensor(TRUTH, device=device), *dirs)]
    return dirs, tgts


def assert_grad_close(got, want, rtol=GRAD_RTOL):
    got, want = (x.double().cpu() if isinstance(x, torch.Tensor)
                 else torch.tensor(np.array(x), dtype=torch.float64)
                 for x in (got, want))
    atol = GRAD_ATOL_REL * float(want.abs().max())
    assert ((got - want).abs() <= atol + rtol * want.abs()).all(), \
        (got.tolist(), want.tolist())


@pytest.mark.parametrize("pv", range(len(PVECS)))
def test_ad_matches_pallas_interpret(jx, pv):
    jax, jnp, jff, jsoa = jx
    n = 3000                                  # not a multiple of the block
    dirs, tgts = batch(n, seed=pv)
    pvec = np.asarray(PVECS[pv], np.float32)
    arrays, targets, n_valid = jff.pad_to_block(
        [jnp.asarray(d.numpy()) for d in dirs],
        [jnp.asarray(t.numpy()) for t in tgts], 8)
    want_l, want_g = jff.ggx_lsq_value_and_grad(
        jnp.asarray(pvec), *arrays, *targets, block_rows=8, interpret=True,
        n_valid=n_valid, adjoint="ad")
    got_l, got_g = ff.ggx_lsq_value_and_grad(torch.from_numpy(pvec), *dirs,
                                             *tgts, adjoint="ad")
    np.testing.assert_allclose(float(got_l), float(want_l), rtol=LOSS_RTOL)
    assert_grad_close(got_g, np.asarray(want_g))


def test_ad_matches_jax_value_and_grad(jx):
    """The same cross-check as tests/test_ops.py:50-59: against
    jax.value_and_grad of the JAX loss, unpadded."""
    jax, jnp, jff, jsoa = jx
    dirs, tgts = batch(4096, seed=7)
    pvec = np.asarray(PVECS[1], np.float32)
    want_l, want_g = jax.value_and_grad(jsoa.ggx_lsq_loss_soa)(
        jnp.asarray(pvec), *(jnp.asarray(x.numpy()) for x in dirs + tgts))
    got_l, got_g = ff.ggx_lsq_value_and_grad(torch.from_numpy(pvec), *dirs,
                                             *tgts, adjoint="ad")
    np.testing.assert_allclose(float(got_l), float(want_l), rtol=LOSS_RTOL)
    assert_grad_close(got_g, np.asarray(want_g))


@pytest.mark.parametrize("pv", range(len(PVECS)))
def test_ad_matches_hand_adjoint(pv):
    dirs, tgts = batch(8192, seed=10 + pv)
    pvec = torch.tensor(PVECS[pv])
    ad_l, ad_g = ff.ggx_lsq_value_and_grad(pvec, *dirs, *tgts, adjoint="ad")
    hd_l, hd_g = ff.ggx_lsq_value_and_grad(pvec, *dirs, *tgts)
    np.testing.assert_allclose(float(ad_l), float(hd_l), rtol=LOSS_RTOL)
    assert_grad_close(ad_g, hd_g)


def test_ad_divides_by_n_valid():
    dirs, tgts = batch(1000, seed=3)
    pvec = torch.tensor(PVECS[2])
    l1, g1 = ff.ggx_lsq_value_and_grad(pvec, *dirs, *tgts, adjoint="ad")
    l2, g2 = ff.ggx_lsq_value_and_grad(pvec, *dirs, *tgts, adjoint="ad",
                                       n_valid=500)
    np.testing.assert_allclose(float(l2), 2 * float(l1), rtol=1e-6)
    np.testing.assert_allclose(g2.numpy(), 2 * g1.numpy(), rtol=1e-6)


def test_ad_is_ggx_only_and_adjoint_is_checked():
    dirs, tgts = batch(64)
    pvec = torch.tensor(PVECS[0])
    with pytest.raises(ValueError, match="GGX loss only"):
        ff.ggx_lsq_value_and_grad(pvec, *dirs, *tgts, family="beck",
                                  adjoint="ad")
    with pytest.raises(ValueError, match="adjoint"):
        ff.ggx_lsq_value_and_grad(pvec, *dirs, *tgts, adjoint="vjp")


def test_cpu_ad_takes_the_plain_version_and_launches_nothing():
    dirs, tgts = batch(256)
    pvec = torch.tensor(PVECS[1])
    before, before_hand = ff.LAUNCHES_AD, ff.LAUNCHES
    ff.ggx_lsq_value_and_grad(pvec, *dirs, *tgts, adjoint="ad")
    assert (ff.LAUNCHES_AD, ff.LAUNCHES) == (before, before_hand)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ff.kernel_ad_sums(pvec, dirs, tgts)


@pytest.mark.parametrize("ctas_per_sm", [1, 2, 3])
@pytest.mark.parametrize("n", [1, 255, 256, 257, 67_584, 2 ** 23 + 1000])
def test_ad_schedule_covers_every_unit_once(n, ctas_per_sm):
    """K4's persistent launch on an H100's 132 SMs: no more CTAs than the
    card holds or than units; the CTAs' contiguous runs of units cover
    each unit once and differ by at most one."""
    unit, sms = 256, 132
    sched = ff.ad_schedule(n, unit, sms, ctas_per_sm)
    assert sched.units == -(-n // unit) and sched.units * unit >= n
    assert 1 <= sched.grid == min(sms * ctas_per_sm, sched.units)
    bounds = [sched.units * b // sched.grid for b in range(sched.grid + 1)]
    sizes = np.diff(bounds)
    assert bounds[0] == 0 and bounds[-1] == sched.units
    assert sizes.min() >= 1 and sizes.max() - sizes.min() <= 1


def test_ad_schedule_raises_when_no_cta_fits():
    with pytest.raises(RuntimeError, match="no CTA"):
        ff.ad_schedule(1000, 256, 132, 0)


@pytest.mark.skipif("not torch.cuda.is_available()")
@pytest.mark.parametrize("n", [1, 1023, 1025, 2 ** 20 + 7])
def test_k4_one_launch_bitwise_repeats_and_plain_and_k1_on_the_card(n):
    dirs, tgts = batch(n, seed=n % 97, device="cuda")
    pvec = torch.tensor(PVECS[2], device="cuda")
    before = ff.LAUNCHES_AD
    l1, g1 = ff.kernel_ad_sums(pvec, dirs, tgts)
    l2, g2 = ff.kernel_ad_sums(pvec, dirs, tgts)
    torch.cuda.synchronize()
    assert ff.LAUNCHES_AD == before + 2
    assert torch.equal(l1, l2) and torch.equal(g1, g2)
    lp, gp = ff.plain_ad_sums(pvec, dirs, tgts)
    np.testing.assert_allclose(float(l1), float(lp), rtol=LOSS_RTOL)
    assert_grad_close(g1, gp)
    _, g_hand = ff.ggx_lsq_value_and_grad(pvec, *dirs, *tgts)
    assert_grad_close(g1 / n, g_hand)


@pytest.mark.skipif("not torch.cuda.is_available()")
def test_k4_gated_samples_add_exactly_nothing_on_the_card():
    """Samples the loss gates out (o below the horizon, i == -o) with zero
    targets: loss and every tangent exactly 0."""
    n = 3000
    rng = np.random.default_rng(5)
    th = rng.uniform(0.02, 1.5, n)
    ph = rng.uniform(0, 2 * np.pi, n)
    o = np.stack([np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph),
                  np.cos(th)])
    below = np.arange(n) % 2 == 0
    o[2, below] *= -1                                  # o below the horizon
    i = -o                                             # i == -o elsewhere
    i[:, below] = np.array([[0.0], [0.0], [1.0]])
    dirs = [torch.tensor(c, dtype=torch.float32, device="cuda")
            for c in (*i, *o)]
    zeros = [torch.zeros(n, device="cuda") for _ in range(3)]
    for pv in PVECS:
        loss, grad = ff.kernel_ad_sums(torch.tensor(pv, device="cuda"), dirs,
                                       zeros)
        assert float(loss) == 0.0 and float(grad.abs().max()) == 0.0


@pytest.mark.skipif("not torch.cuda.is_available()")
@pytest.mark.parametrize("pv", range(len(PVECS) - 1))
def test_k4_matches_its_plain_version_on_the_card(pv):
    n = 2 ** 20 + 77                           # a ragged tail
    dirs, tgts = batch(n, seed=pv, device="cuda")
    pvec = torch.tensor(PVECS[pv], device="cuda")
    before = ff.LAUNCHES_AD
    lk, gk = ff.ggx_lsq_value_and_grad(pvec, *dirs, *tgts, adjoint="ad")
    torch.cuda.synchronize()
    assert ff.LAUNCHES_AD == before + 1
    lp, gp = ff.plain_ad_sums(pvec, dirs, tgts)
    np.testing.assert_allclose(float(lk), float(lp) / n, rtol=LOSS_RTOL)
    assert_grad_close(gk, gp / n)


@pytest.mark.skipif("not torch.cuda.is_available()")
@pytest.mark.parametrize("pv", range(len(PVECS) - 1))
def test_k4_matches_k1_on_the_card(pv):
    dirs, tgts = batch(2 ** 20 + 77, seed=20 + pv, device="cuda")
    pvec = torch.tensor(PVECS[pv], device="cuda")
    _, g_ad = ff.ggx_lsq_value_and_grad(pvec, *dirs, *tgts, adjoint="ad")
    _, g_hand = ff.ggx_lsq_value_and_grad(pvec, *dirs, *tgts)
    assert_grad_close(g_ad, g_hand)
