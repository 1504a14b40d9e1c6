"""Port parity, utilities: dj_brdf_torch.utils.checkpoint round trips of
the pytrees tests/test_batch_ckpt.py saves with the JAX package (made
from the same numpy inputs, converted with dj_brdf_torch.convert), and
dj_brdf_torch.utils.profiling's Throughput meter and trace()."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dj_brdf_tpu import fresnel as jfres
from dj_brdf_tpu.lean.filtered import FilteredBeckmannMaterial as JLean
from dj_brdf_tpu.lean.lrep import Lrep as JLrep
from dj_brdf_tpu.microfacet.ndf import GGX as JGGX
from dj_brdf_tpu.microfacet.params import MicrofacetParams as JParams
from dj_brdf_tpu.render.envmap import EnvMap as JEnvMap
from dj_brdf_tpu.render.materials import TexturedMicrofacetMaterial as JTex
from dj_brdf_torch import convert
from dj_brdf_torch import fresnel as tfres
from dj_brdf_torch.core.pytree import tree_leaves
from dj_brdf_torch.fit import lsq
from dj_brdf_torch.lean.filtered import FilteredBeckmannMaterial
from dj_brdf_torch.microfacet.params import MicrofacetParams
from dj_brdf_torch.render.envmap import EnvMap
from dj_brdf_torch.render.materials import TexturedMicrofacetMaterial
from dj_brdf_torch.utils import checkpoint, profiling


def identical(got, want):
    """Every leaf equal bit for bit (compared as raw bytes: the envmap's
    alias column holds int32 bit patterns in float32)."""
    a, b = tree_leaves(got), tree_leaves(want)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.numpy().tobytes() == y.numpy().tobytes()


def test_checkpoint_roundtrip(tmp_path):
    """tests/test_batch_ckpt.py:49-62: params and a spline Fresnel in a
    dict, restored into their types with ``like``; without ``like`` the
    file reads back as dicts of the fields."""
    params = convert.params_from_jax(JParams.elliptic(0.4, 0.2, 0.7))
    fres = tfres.SplineFresnel(points=torch.from_numpy(np.array(
        jnp.linspace(0, 1, 30).reshape(10, 3))))
    state = {"params": params, "fresnel": fres}
    path = str(tmp_path / "ckpt.pt")
    checkpoint.save_checkpoint(path, state)
    back = checkpoint.load_checkpoint(path, like=state)
    assert isinstance(back["params"], MicrofacetParams)
    assert isinstance(back["fresnel"], tfres.SplineFresnel)
    identical(back, state)
    np.testing.assert_allclose(back["params"].ax.numpy(),
                               np.asarray(JParams.elliptic(0.4, 0.2, 0.7).ax))
    plain = checkpoint.load_checkpoint(path, map_location="cpu")
    assert sorted(plain) == ["fresnel", "params"]
    assert torch.equal(plain["params"]["ax"], params.ax)
    assert torch.equal(plain["fresnel"]["points"], fres.points)


def test_checkpoint_roundtrip_render_pytrees(tmp_path):
    """tests/test_batch_ckpt.py:117: an EnvMap (alias tables, rotation),
    a TexturedMicrofacetMaterial and a full-map FilteredBeckmannMaterial
    with its static fields, built by the JAX package and converted."""
    rng = np.random.default_rng(0)
    em = JEnvMap.build(jnp.asarray(rng.uniform(0.1, 1, (8, 16, 3)),
                                   jnp.float32),
                       rotation=JEnvMap.rotation_z(0.5))
    tex = JTex(dist=JGGX(), fres=jfres.Schlick(f0=jnp.asarray([0.9, 0.6,
                                                               0.3])),
               alpha1=jnp.asarray(rng.uniform(0.1, 0.5, (4, 4)), jnp.float32),
               alpha2=jnp.asarray(0.2, jnp.float32),
               alpha_angle=jnp.asarray(0.0, jnp.float32))
    e1 = jnp.asarray(rng.normal(0, 0.1, (4, 4)), jnp.float32)
    lean = JLean(lean=JLrep(E1=e1, E2=e1, E3=e1 * e1 + 0.02,
                            E4=e1 * e1 + 0.02, E5=e1 * e1),
                 base_params=JParams.isotropic(0.1),
                 eta=jnp.asarray([0.1, 0.3, 1.4]),
                 k=jnp.asarray([3.9, 2.4, 1.6]), mip_lod=True)
    state = {"envmap": convert.envmap_from_jax(em, "cpu"),
             "sphere": convert.material_from_jax(tex, "cpu"),
             "floor": convert.material_from_jax(lean, "cpu")}
    path = str(tmp_path / "scene.pt")
    checkpoint.save_checkpoint(path, state)
    back = checkpoint.load_checkpoint(path, like=state)
    identical(back, state)
    assert isinstance(back["envmap"], EnvMap)
    assert isinstance(back["sphere"], TexturedMicrofacetMaterial)
    assert isinstance(back["floor"], FilteredBeckmannMaterial)
    assert back["floor"].mip_lod is True           # static fields kept
    np.testing.assert_array_equal(back["envmap"].alias.numpy().view(
        np.int32), np.asarray(em.alias).view(np.int32))


def test_checkpoint_roundtrip_fit_state(tmp_path):
    """A fit state (a RawFit NamedTuple of (M,) leaves) and a tuple."""
    raw = lsq.RawFit(*(torch.full((3,) + t.shape, 0.5) + k
                       for k, t in enumerate(lsq.raw_init(device="cpu"))))
    state = (raw, torch.arange(3.0))
    path = str(tmp_path / "fit.pt")
    checkpoint.save_checkpoint(path, state)
    back = checkpoint.load_checkpoint(path, like=state)
    assert isinstance(back, tuple) and isinstance(back[0], lsq.RawFit)
    identical(back, state)
    with pytest.raises(ValueError, match="leaves"):
        checkpoint.load_checkpoint(path, like=(raw,))


def test_throughput_meter():
    meter = profiling.Throughput(items_per_call=100)
    x = torch.ones(100)
    for _ in range(3):
        with meter:
            y = x * 2
            meter.sync(y)
            meter.sync((y, None))
    assert meter.calls == 3 and meter.rate() > 0


def test_trace_writes_a_chrome_trace(tmp_path):
    logdir = str(tmp_path / "prof")
    with profiling.trace(logdir) as prof:
        torch.ones(64).mul(2.0).sum()
    names = {e.key for e in prof.key_averages()}
    assert "aten::mul" in names
    with open(os.path.join(logdir, "trace.json")) as fh:
        events = json.load(fh)["traceEvents"]
    assert any(e.get("name") == "aten::mul" for e in events)
