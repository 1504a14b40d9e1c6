"""The port's entry points that make their own tensors run on the card
unless the caller asks for the CPU: ``entry()``, ``sample_direction_set``,
``bake_merl``, ``raw_init``; ``build_tabular``, ``compute_p22_smith`` and
``MeasuredMaterial.from_model`` of a bare eval function; ``render`` of
materials that hold no tensor; ``render_sphere`` with a light direction
that is not a tensor; ``EnvMap.build`` of a numpy image; ``bake_utia``,
``build_tabular_anisotropic`` and ``kernel_matrix`` of a bare eval
function, ``furnace_test``, ``SGD`` and ``ABC``'s ``from_name`` and
``all_materials``. Called without a device they put their tensors on
the card, and on a machine without one they raise; they never quietly
fall back to the CPU. Whether there is a card is decided inside each
test."""

import dataclasses
import math

import numpy as np
import pytest
import torch

from dj_brdf_torch import fresnel
from dj_brdf_torch.entry import entry
from dj_brdf_torch.fit import tabular, tabular_aniso
from dj_brdf_torch.fit.batch import sample_direction_set
from dj_brdf_torch.fit.lsq import raw_init
from dj_brdf_torch.io.synth import bake_merl, bake_utia
from dj_brdf_torch.microfacet import brdf
from dj_brdf_torch.microfacet.ndf import GGX
from dj_brdf_torch.microfacet.params import MicrofacetParams
from dj_brdf_torch.models.abc_model import ABC
from dj_brdf_torch.models.sgd import SGD
from dj_brdf_torch.parallel.integrals import furnace_test
from dj_brdf_torch.render import pathtrace
from dj_brdf_torch.render.envmap import EnvMap
from dj_brdf_torch.render.materials import CosineMaterial, MeasuredMaterial
from dj_brdf_torch.render.sphere import render_sphere

LIGHT, LIGHT_RAD, SKY = (0.3, 0.4, 0.8), (4.0, 4.0, 4.0), (0.3, 0.35, 0.4)
SUN_SKY = np.random.default_rng(0).uniform(0.5, 2.0, (4, 8, 3)).astype(
    np.float32)


def ggx_eval(i, o):
    dev = i.device
    return brdf.eval(GGX(), fresnel.Schlick(
        f0=torch.tensor([0.9, 0.6, 0.3], device=dev)),
        MicrofacetParams.isotropic(torch.tensor(0.3, device=dev)), i, o)


def ggx_evalp(i, o):
    return ggx_eval(i, o) * i[..., 2:3]


@dataclasses.dataclass(frozen=True)
class Grey:
    """A Lambertian model that holds no tensor."""

    def evalp(self, i, o):
        return torch.clamp(i[..., 2:3], min=0.0).expand(
            i.shape[:-1] + (3,)) * (0.5 / math.pi)


def tensors_of_tabular(dist):
    return [dist.p22, dist.sigma, dist.cdf, dist.qf]


def tensors_of_aniso(dist):
    return [dist.p22, dist.sigma, dist.pdf1, dist.qf2_table]


def furnace(**kw):
    """The directions ``furnace_test`` integrates over."""
    seen = []

    def evalp(i, o):
        seen.append(i)
        return Grey().evalp(i, o)

    furnace_test(evalp, 2, 2, **kw)
    return seen[:1]


def abc_leaves(abc):
    return [abc.kd, abc.a, abc.b, abc.c, abc.ior]


SGD_NAME = "gold-metallic-paint"


def proxy_of(material):
    p = material.proxy_params
    return [getattr(p, f.name) for f in dataclasses.fields(p)]


def grey_render(**kw):
    mat = CosineMaterial(model=Grey())
    return [pathtrace.render(mat, mat, LIGHT, LIGHT_RAD, SKY, res=4, spp=1,
                             max_bounces=1, **kw)]


def envmap_tables(**kw):
    em = EnvMap.build(SUN_SKY, **kw)
    return [em.radiance, em.packed, em.alias]


def default_directions():
    gen = torch.Generator("cuda" if torch.cuda.is_available() else "cpu")
    return list(sample_direction_set(64, gen.manual_seed(0)))


DEFAULTS = {
    "entry": lambda: list(entry()[1][1:]),
    "envmap_build": envmap_tables,
    "sample_direction_set": default_directions,
    "bake_merl": lambda: [bake_merl(ggx_eval)],
    "build_tabular": lambda: tensors_of_tabular(
        tabular.build_tabular(ggx_eval, 8)[0]),
    "compute_p22_smith": lambda: [tabular.compute_p22_smith(ggx_eval, 8)],
    "from_model": lambda: proxy_of(MeasuredMaterial.from_model(ggx_eval, 8)),
    "render": grey_render,
    "render_sphere": lambda: [render_sphere(ggx_evalp, LIGHT, res=8)],
    "raw_init": lambda: list(raw_init()),
    "bake_utia": lambda: [bake_utia(ggx_eval)],
    "build_tabular_anisotropic": lambda: tensors_of_aniso(
        tabular_aniso.build_tabular_anisotropic(ggx_eval, 5, 6)[0]),
    "kernel_matrix": lambda: [tabular_aniso.kernel_matrix(ggx_eval, 5, 6)],
    "furnace_test": furnace,
    "sgd": lambda: [SGD.from_name(SGD_NAME).params,
                    SGD.all_materials().params],
    "abc": lambda: abc_leaves(ABC.from_name(SGD_NAME))
    + abc_leaves(ABC.all_materials()),
}

ON_THE_CPU = {
    "entry": lambda: [entry("cpu")[1][0].ax, *entry("cpu")[1][1:]],
    "envmap_build": lambda: envmap_tables(device="cpu"),
    "sample_direction_set": lambda: list(sample_direction_set(
        64, torch.Generator().manual_seed(0), "cpu")),
    "bake_merl": lambda: [bake_merl(ggx_eval, "cpu")],
    "build_tabular": lambda: tensors_of_tabular(
        tabular.build_tabular(ggx_eval, 8, device="cpu")[0]),
    "compute_p22_smith": lambda: [tabular.compute_p22_smith(
        ggx_eval, 8, device="cpu")],
    "from_model": lambda: proxy_of(MeasuredMaterial.from_model(
        ggx_eval, 8, device="cpu")),
    "render": lambda: grey_render(generator=torch.Generator()),
    "render_sphere": lambda: [render_sphere(ggx_evalp, LIGHT, res=8,
                                            device="cpu")],
    "raw_init": lambda: list(raw_init(device="cpu")),
    "bake_utia": lambda: [bake_utia(ggx_eval, "cpu")],
    "build_tabular_anisotropic": lambda: tensors_of_aniso(
        tabular_aniso.build_tabular_anisotropic(ggx_eval, 5, 6,
                                                device="cpu")[0]),
    "kernel_matrix": lambda: [tabular_aniso.kernel_matrix(
        ggx_eval, 5, 6, device="cpu")],
    "furnace_test": lambda: furnace(device="cpu"),
    "sgd": lambda: [SGD.from_name(SGD_NAME, device="cpu").params,
                    SGD.all_materials(device="cpu").params],
    "abc": lambda: abc_leaves(ABC.from_name(SGD_NAME, device="cpu"))
    + abc_leaves(ABC.all_materials(device="cpu")),
}


@pytest.mark.parametrize("name", sorted(DEFAULTS))
def test_default_device_is_the_card(name):
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            DEFAULTS[name]()
        return
    for t in DEFAULTS[name]():
        assert t.device.type == "cuda"


@pytest.mark.parametrize("name", sorted(ON_THE_CPU))
def test_cpu_when_asked(name):
    tensors = ON_THE_CPU[name]()
    assert tensors and all(t.device.type == "cpu" for t in tensors)
    assert all(torch.isfinite(t).all() for t in tensors)
