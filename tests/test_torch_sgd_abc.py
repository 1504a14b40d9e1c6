"""Port parity, the SGD and ABC fits of the MERL materials:
dj_brdf_torch.models.sgd and models.abc_model against the JAX package,
with the port's own copy of the parameter tables."""

import dataclasses
import hashlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dj_brdf_tpu.models import abc_model as jabc
from dj_brdf_tpu.models import sgd as jsgd
from dj_brdf_torch import convert
from dj_brdf_torch.models import abc_model as tabc
from dj_brdf_torch.models import sgd as tsgd

ROOT = Path(__file__).resolve().parents[1]
TABLES = "models/data/material_tables.npz"
MODELS = {"SGD": (jsgd, tsgd, "SGD"), "ABC": (jabc, tabc, "ABC")}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def dirs(rng, n):
    th = rng.uniform(0.15, 1.5, n)
    ph = rng.uniform(-np.pi, np.pi, n)
    return np.stack([np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph),
                     np.cos(th)], -1).astype(np.float32)


def per_material(model):
    """A stacked model with a unit axis after the material axis, so its
    (M, ...) leaves broadcast against (N, 3) directions to (M, N, 3)."""
    return type(model)(**{f.name: getattr(model, f.name)[:, None]
                          for f in dataclasses.fields(model)})


def test_the_copied_tables_equal_the_jax_package_file():
    ours = (ROOT / "dj_brdf_torch" / TABLES).read_bytes()
    theirs = (ROOT / "dj_brdf_tpu" / TABLES).read_bytes()
    assert hashlib.sha256(ours).hexdigest() == \
        hashlib.sha256(theirs).hexdigest()


@pytest.mark.parametrize("name", sorted(MODELS))
def test_material_names_match_jax(name):
    jmod, tmod, _ = MODELS[name]
    assert tmod.material_names() == jmod.material_names()
    assert len(tmod.material_names()) == 100


def sgd_lookups():
    t = tsgd.load_tables()
    names = [str(n) for n in t["sgd_names"]]
    other = [str(n) for n in t["sgd_other_names"]]
    return [names[0], names[57], names[-1], other[3], other[-1]]


@pytest.mark.parametrize("name", sgd_lookups())
def test_sgd_from_name_matches_jax_in_both_name_columns(name):
    want = jsgd.SGD.from_name(name)
    got = tsgd.SGD.from_name(name, device="cpu")
    assert got.params.dtype == torch.float32 and got.params.shape == (12, 3)
    np.testing.assert_array_equal(got.params.numpy(), np.asarray(want.params))


@pytest.mark.parametrize("row", [0, 42, 99])
def test_abc_from_name_matches_jax(row):
    name = tabc.material_names()[row]
    want = jabc.ABC.from_name(name)
    got = tabc.ABC.from_name(name, device="cpu")
    for f in ("kd", "a", "b", "c", "ior"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_unknown_material_raises_key_error_naming_it(name):
    _, tmod, cls = MODELS[name]
    with pytest.raises(KeyError, match="no-such-paint"):
        getattr(tmod, cls).from_name("no-such-paint", device="cpu")


@pytest.mark.parametrize("name", sorted(MODELS))
def test_all_materials_evalp_matches_jax(name):
    """All 100 materials at 2,000 direction pairs off the pole (f32
    arccos is ill conditioned there in both packages). Near-specular
    pairs put 1 - cos^2 theta_h through a cancellation that the NDF's
    exponent of the narrowest fits (SGD alpha ~1e-4, ABC's large B) turns
    into relative differences of up to ~1e-2 between XLA's and PyTorch's
    roundings (31 of 600,000 beyond rtol 1e-4 here): at most 1 in 1,000
    entries beyond rtol 1e-4 (atol 1e-6 of the max), none beyond rtol
    0.05."""
    jmod, tmod, cls = MODELS[name]
    rng = np.random.default_rng(9)
    i, o = dirs(rng, 2000), dirs(rng, 2000)
    want = np.asarray(per_material(getattr(jmod, cls).all_materials())
                      .evalp(jnp.asarray(i), jnp.asarray(o)))
    stacked = getattr(tmod, cls).all_materials(device="cpu")
    got = per_material(stacked).evalp(torch.from_numpy(i),
                                      torch.from_numpy(o)).numpy()
    assert got.shape == want.shape == (100, 2000, 3)
    assert np.isfinite(got).all()
    atol = 1e-6 * np.abs(want).max()
    diff = np.abs(got - want)
    assert (diff > atol + 1e-4 * np.abs(want)).mean() <= 1e-3
    np.testing.assert_allclose(got, want, rtol=0.05, atol=atol)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_one_material_eval_and_convert_match_jax(name):
    """One material's eval (no material axis), and the model carried
    across from JAX by ``convert``: rtol 1e-4 as above."""
    jmod, tmod, cls = MODELS[name]
    mat = tmod.material_names()[7]
    jm = getattr(jmod, cls).from_name(mat)
    tm = getattr(convert, f"{name.lower()}_from_jax")(jm)
    assert type(tm) is getattr(tmod, cls)
    rng = np.random.default_rng(10)
    i, o = dirs(rng, 500), dirs(rng, 500)
    want = np.asarray(jm.eval(jnp.asarray(i), jnp.asarray(o)))
    for model in (tm, getattr(tmod, cls).from_name(mat, device="cpu")):
        got = model.eval(torch.from_numpy(i), torch.from_numpy(o)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("name", sorted(MODELS))
def test_below_the_horizon_is_zero(name):
    _, tmod, cls = MODELS[name]
    model = getattr(tmod, cls).from_name(tmod.material_names()[3],
                                         device="cpu")
    i = torch.tensor([[0.3, 0.0, -0.95], [0.3, 0.0, 0.95]])
    o = torch.tensor([[0.0, 0.3, 0.95], [0.0, 0.3, -0.95]])
    assert (model.evalp(i, o) == 0.0).all()
