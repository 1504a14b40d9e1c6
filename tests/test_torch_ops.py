"""Port parity, ops layer: dj_brdf_torch.ops.soa (the fused fit kernel's
plain version) and ops.fused_fit against the JAX package, including the
JAX Pallas kernel in interpret mode, on the same numpy inputs (f32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dj_brdf_tpu.ops import fused_fit as jff
from dj_brdf_tpu.ops import soa as jsoa
from dj_brdf_torch.ops import fused_fit as tff
from dj_brdf_torch.ops import soa as tsoa

FAMILIES = ["ggx", "beck"]
EVALP = {"ggx": "ggx_evalp_soa", "beck": "beckmann_evalp_soa"}
FWDBWD = {"ggx": "ggx_lsq_fwdbwd_soa", "beck": "beckmann_lsq_fwdbwd_soa"}
LOSS = {"ggx": "ggx_lsq_loss_soa", "beck": "beckmann_lsq_loss_soa"}
TRUTH = np.asarray([0.25, 0.25, 0.0, 0.0, 0.0, 0.9, 0.6, 0.3], np.float32)
# a moderate anisotropic pvec and the extreme one of tests/test_ops.py
PVECS = [[0.4, 0.3, 0.1, 0.02, -0.03, 0.5, 0.5, 0.5],
         [0.05, 0.8, -0.7, 0.3, -0.2, 0.99, 0.01, 0.5]]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def batch(n, seed=0):
    """Six (n,) f32 direction components and the TRUTH material's GGX
    and Beckmann targets, as numpy arrays."""
    rng = np.random.default_rng(seed)
    th = rng.uniform(0.02, 1.55, (2, n))
    ph = rng.uniform(0, 2 * np.pi, (2, n))
    comp = [np.sin(th[0]) * np.cos(ph[0]), np.sin(th[0]) * np.sin(ph[0]),
            np.cos(th[0]), np.sin(th[1]) * np.cos(ph[1]),
            np.sin(th[1]) * np.sin(ph[1]), np.cos(th[1])]
    comp = [c.astype(np.float32) for c in comp]
    tgts = {f: [np.array(t) for t in getattr(jsoa, EVALP[f])(
        jnp.asarray(TRUTH), *comp)] for f in FAMILIES}
    return comp, tgts


def t(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("pv", [0, 1])
def test_evalp_soa_matches_jax(family, pv):
    comp, _ = batch(4096)
    pvec = np.asarray(PVECS[pv], np.float32)
    want = getattr(jsoa, EVALP[family])(jnp.asarray(pvec), *comp)
    got = getattr(tsoa, EVALP[family])(torch.from_numpy(pvec), *t(comp))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5,
                                   atol=1e-7 * float(np.abs(w).max()))


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("pv", [0, 1])
def test_fwdbwd_soa_matches_jax(family, pv):
    n = 8192
    comp, tgts = batch(n)
    pvec = np.asarray(PVECS[pv], np.float32)
    want_l, want_g = getattr(jsoa, FWDBWD[family])(
        jnp.asarray(pvec), *comp, *tgts[family])
    got_l, got_g = getattr(tsoa, FWDBWD[family])(
        torch.from_numpy(pvec), *t(comp), *t(tgts[family]))
    np.testing.assert_allclose(float(got_l), float(want_l), rtol=2e-5)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g),
                               rtol=2e-4, atol=1e-7 * n)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("pv", [0, 1])
def test_fwdbwd_soa_matches_torch_autograd(family, pv):
    """The hand adjoint == torch.autograd of the port's own loss."""
    n = 8192
    comp, tgts = batch(n)
    pvec = torch.tensor(PVECS[pv], requires_grad=True)
    data = (*t(comp), *t(tgts[family]))
    loss = getattr(tsoa, LOSS[family])(pvec, *data)
    (want_g,) = torch.autograd.grad(loss, pvec)
    got_l, got_g = getattr(tsoa, FWDBWD[family])(pvec.detach(), *data)
    np.testing.assert_allclose(float(got_l) / n, loss.item(), rtol=2e-5)
    np.testing.assert_allclose(got_g.numpy() / n, want_g.numpy(),
                               rtol=2e-4, atol=1e-7)


def _interpret_inputs(n, m, seed):
    """Numpy inputs for M materials at n (ragged) samples, the JAX side
    padded to whole 128 x 8 blocks (pad_to_block) as its kernel needs;
    the port takes them unpadded."""
    rng = np.random.default_rng(seed)
    comp, tgts = batch(n, seed)
    pvecs = np.asarray(PVECS[:1] + [[0.3, 0.2, -0.2, -0.05, 0.04, 0.7, 0.4,
                                     0.2]] * (m - 1), np.float32)
    pvecs[1:, :2] *= rng.uniform(0.8, 1.3, (m - 1, 2)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, (m, 1)).astype(np.float32)
    tg = {f: [scale * c[None] for c in tgts[f]] for f in FAMILIES}
    return comp, tg, pvecs


@pytest.mark.parametrize("family", FAMILIES)
def test_value_and_grad_matches_pallas_interpret(family):
    n = 3000
    comp, tg, pvecs = _interpret_inputs(n, 1, 1)
    tgts = [c[0] for c in tg[family]]
    arrays, targets, n_valid = jff.pad_to_block(
        [jnp.asarray(c) for c in comp], [jnp.asarray(c) for c in tgts], 8)
    want_l, want_g = jff.ggx_lsq_value_and_grad(
        jnp.asarray(pvecs[0]), *arrays, *targets, block_rows=8,
        interpret=True, n_valid=n_valid, family=family)
    got_l, got_g = tff.ggx_lsq_value_and_grad(
        torch.from_numpy(pvecs[0]), *t(comp), *t(tgts), family=family)
    # JAX's kernel takes the approximate reciprocal: its own test's bounds
    np.testing.assert_allclose(float(got_l), float(want_l), rtol=1e-4)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g),
                               rtol=3e-4, atol=1e-6)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("mean", [False, True])
def test_batched_value_and_grad_matches_pallas_interpret(family, mean):
    n, m = 3000, 3
    comp, tg, pvecs = _interpret_inputs(n, m, 2)
    arrays, targets, n_valid = jff.pad_to_block(
        [jnp.asarray(c) for c in comp], [jnp.asarray(c) for c in tg[family]],
        8)
    want_l, want_g = jff.ggx_lsq_value_and_grad_batched(
        jnp.asarray(pvecs), *arrays, *targets, block_rows=8, interpret=True,
        n_valid=n_valid, mean_over_materials=mean, family=family)
    got_l, got_g = tff.ggx_lsq_value_and_grad_batched(
        torch.from_numpy(pvecs), *t(comp), *t(tg[family]),
        mean_over_materials=mean, family=family)
    assert got_l.shape == (m,) and got_g.shape == (m, 8)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), rtol=1e-4)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g),
                               rtol=3e-4, atol=1e-6)


@pytest.mark.parametrize("family", FAMILIES)
def test_plain_batched_matches_per_material(family):
    n, m = 2048, 3
    comp, tg, pvecs = _interpret_inputs(n, m, 3)
    dirs, tgts = t(comp), t(tg[family])
    ls, gs = tff.plain_fwdbwd_sums(torch.from_numpy(pvecs), dirs, tgts,
                                   family, chunk=2)
    for k in range(m):
        lk, gk = getattr(tsoa, FWDBWD[family])(
            torch.from_numpy(pvecs[k]), *dirs, *(c[k] for c in tgts))
        np.testing.assert_allclose(float(ls[k]), float(lk), rtol=1e-6)
        np.testing.assert_allclose(gs[k].numpy(), gk.numpy(), rtol=1e-5,
                                   atol=1e-6 * float(gk.abs().max()))


@pytest.mark.parametrize("family", FAMILIES)
def test_gated_samples_contribute_exactly_zero(family):
    """o below the horizon and i == -o, with zero targets: loss and every
    gradient component exactly 0 (not merely small), and finite."""
    comp, _ = batch(64)
    ix, iy, iz, ox, oy, oz = t(comp)
    below = torch.arange(64) % 2 == 0
    oz = torch.where(below, -oz, oz)
    ix = torch.where(below, ix, -ox)
    iy = torch.where(below, iy, -oy)
    iz = torch.where(below, iz, -oz)
    z = torch.zeros(64)
    for pv in PVECS:
        loss, grad = getattr(tsoa, FWDBWD[family])(
            torch.tensor(pv), ix, iy, iz, ox, oy, oz, z, z, z)
        assert float(loss) == 0.0
        assert torch.equal(grad, torch.zeros(8))


def test_fused_fit_loss_autograd_is_the_kernel_gradient():
    n, m = 2048, 3
    comp, tg, pvecs = _interpret_inputs(n, m, 4)
    data = (*t(comp), *t(tg["ggx"]))
    pv = torch.from_numpy(pvecs).requires_grad_(True)
    per_mat = tff.fused_fit_loss(pv, *data, family="ggx")
    per_mat.mean().backward()
    want_l, want_g = tff.ggx_lsq_value_and_grad_batched(
        pv.detach(), *data, mean_over_materials=True, family="ggx")
    assert torch.equal(per_mat.detach(), want_l)
    torch.testing.assert_close(pv.grad, want_g, rtol=1e-6, atol=0)


def test_split_dirs_and_raw_to_pvec_match_jax():
    from dj_brdf_tpu.fit.lsq import RawFit as JRaw
    from dj_brdf_torch.fit.lsq import RawFit as TRaw

    rng = np.random.default_rng(8)
    i, o = rng.normal(size=(2, 16, 3)).astype(np.float32)
    for g, w in zip(tsoa.split_dirs(*t([i, o])),
                    jsoa.split_dirs(jnp.asarray(i), jnp.asarray(o))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    leaves = [rng.normal(size=(4,)).astype(np.float32) for _ in range(5)]
    leaves.append(rng.normal(size=(4, 3)).astype(np.float32))
    want = jax.vmap(jsoa.raw_to_pvec)(JRaw(*[jnp.asarray(x) for x in leaves]))
    got = tsoa.raw_to_pvec(TRaw(*t(leaves)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
