"""The MERL lookup's backward (dj_brdf_torch.ops.merl_gather.
MerlLookupGrad, the card's path when the table or ``iz`` requires grad)
against ``jax.grad`` of the JAX package's ``Merl.evalp``.

On the CPU the Function runs with the plain forward; the card's kernel
forward is held against the CPU autograd in tests/test_torch_gather_kernel.py
and in chip_smoke.py (phase 19)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dj_brdf_tpu.models import merl as jmerl
from dj_brdf_torch.models import merl as tmerl
from dj_brdf_torch.ops import merl_gather as mg

SCALES = tmerl.SCALES


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def case():
    """Random tables with ~10% negative (below-horizon) entries, M = 2, at
    directions over the hemisphere (grazing ones included), and a random
    output weight; the flat indices are JAX's, so both packages look up
    the same cells."""
    rng = np.random.default_rng(3)
    tables = rng.uniform(0.0, 3000.0, (2,) + tmerl.TABLE_SHAPE)
    tables[rng.uniform(size=tables.shape) < 0.1] = -1.0
    n = 4000
    th_i, th_o = rng.uniform(0, 1.6, n), rng.uniform(0, 1.6, n)
    ph_i, ph_o = rng.uniform(0, 2 * np.pi, (2, n))

    def sph(t, p):
        return np.stack([np.sin(t) * np.cos(p), np.sin(t) * np.sin(p),
                         np.cos(t)], -1).astype(np.float32)

    i, o = sph(th_i, ph_i), sph(th_o, ph_o)
    w = rng.uniform(-1.0, 1.0, (2, n, 3)).astype(np.float32)
    return tables.astype(np.float32), i, o, w


def jax_grads(tables, i, o, w):
    """jax.grad of sum(w * evalp) w.r.t. each table and i (JAX's Merl holds
    one table: the two are summed)."""
    def loss(tabs, i):
        return sum(jnp.sum(jmerl.Merl(table=tabs[k]).evalp(i, jnp.asarray(o))
                           * w[k]) for k in range(tabs.shape[0]))

    gt, gi = jax.grad(loss, argnums=(0, 1))(jnp.asarray(tables),
                                            jnp.asarray(i))
    return np.asarray(gt), np.asarray(gi)


def port_grads(tables, i, o, w, lookup):
    idx = torch.from_numpy(np.asarray(jmerl.merl_flat_index(
        jnp.asarray(i), jnp.asarray(o))).astype(np.int32))
    tt = torch.from_numpy(tables).reshape(2, 3, -1).requires_grad_(True)
    iz = torch.from_numpy(i[:, 2].copy()).requires_grad_(True)
    out = mg.MerlLookupGrad.apply(tt, iz, idx, SCALES, lookup)
    torch.sum(out * torch.from_numpy(w)).backward()
    return tt.grad.reshape(tables.shape).numpy(), iz.grad.numpy(), out


def test_backward_matches_jax_grad(case):
    """W.r.t. the tables and i: rtol 1e-5 (the scatter sums in another
    order than XLA's); every gradient w.r.t. i but its z is 0 in JAX, and
    the port has no other path to i than ``iz``."""
    tables, i, o, w = case
    want_t, want_i = jax_grads(tables, i, o, w)
    got_t, got_iz, _ = port_grads(tables, i, o, w, mg.plain_merl_lookup)
    assert np.count_nonzero(want_t) > 10000
    below = np.any(tables * np.asarray(SCALES, np.float32)[:, None, None,
                                                          None] < 0, axis=1)
    assert (want_t[np.broadcast_to(below[:, None], want_t.shape)] == 0).all()
    np.testing.assert_allclose(got_t, want_t, rtol=1e-5, atol=1e-12)
    np.testing.assert_array_equal(want_i[:, :2], 0.0)
    np.testing.assert_allclose(got_iz, want_i[:, 2], rtol=1e-5, atol=1e-9)


def test_backward_equals_cpu_autograd(case):
    """The Function on the plain forward gives the CPU path's autograd:
    the same forward bits, gradients within rtol 1e-6."""
    tables, i, o, w = case
    got_t, got_iz, out = port_grads(tables, i, o, w, mg.plain_merl_lookup)
    idx = torch.from_numpy(np.asarray(jmerl.merl_flat_index(
        jnp.asarray(i), jnp.asarray(o))).astype(np.int32))
    tt = torch.from_numpy(tables).reshape(2, 3, -1).requires_grad_(True)
    iz = torch.from_numpy(i[:, 2].copy()).requires_grad_(True)
    ref = mg.merl_lookup(tt, idx, SCALES, iz)
    torch.sum(ref * torch.from_numpy(w)).backward()
    assert torch.equal(out, ref.detach())
    np.testing.assert_allclose(got_t, tt.grad.reshape(tables.shape).numpy(),
                               rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(got_iz, iz.grad.numpy(), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("which", ["tables", "iz"])
def test_backward_of_one_input(which):
    """Only the input that requires grad gets one; without iz (``eval``)
    the table gradient has no iz factor."""
    rng = np.random.default_rng(5)
    tables = torch.tensor(rng.uniform(-100, 2000, (3, 3, 50)),
                          dtype=torch.float32)
    idx = torch.tensor(rng.integers(-3, 53, 300), dtype=torch.int32)
    iz = torch.tensor(rng.uniform(0, 1, 300), dtype=torch.float32)
    g = torch.tensor(rng.uniform(-1, 1, (3, 300, 3)), dtype=torch.float32)
    gt, giz = mg.lookup_backward(tables, idx, SCALES, iz, g,
                                 mg.plain_merl_lookup,
                                 need_tables=which == "tables",
                                 need_iz=which == "iz")
    assert (gt is None) == (which == "iz") and (giz is None) == (
        which == "tables")
    ref_t = tables.clone().requires_grad_(which == "tables")
    ref_iz = iz.clone().requires_grad_(which == "iz")
    out = mg.plain_merl_lookup(ref_t, idx, SCALES, ref_iz)
    torch.sum(out * g).backward()
    got, want = (gt, ref_t.grad) if which == "tables" else (giz, ref_iz.grad)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-9)
    gt0, _ = mg.lookup_backward(tables, idx, SCALES, None, g,
                                mg.plain_merl_lookup, need_iz=False)
    ref = tables.clone().requires_grad_(True)
    torch.sum(mg.plain_merl_lookup(ref, idx, SCALES) * g).backward()
    torch.testing.assert_close(gt0, ref.grad, rtol=1e-6, atol=1e-9)
