"""The program's own spans (dj_brdf_torch.utils.profiling.span): with no
profiler running no call of the package opens a ``record_function``
range; under ``utils.trace()`` the exported trace holds each span where
the package opens it, nested as the calls nest: a fit step around its
fused kernel call, the MERL lookup inside the tabulation's stages, the
BSDF inside each bounce of every render loop, the environment map's
spans under a map alone."""

import json

import numpy as np
import pytest
import torch

from dj_brdf_torch import fresnel
from dj_brdf_torch.fit import batch, lsq
from dj_brdf_torch.microfacet.ndf import GGX, Beckmann
from dj_brdf_torch.microfacet.params import MicrofacetParams
from dj_brdf_torch.models.lambert import Lambert
from dj_brdf_torch.render import pathtrace
from dj_brdf_torch.render.envmap import EnvMap
from dj_brdf_torch.render.materials import CosineMaterial, MicrofacetMaterial
from dj_brdf_torch.utils import profiling

#: the spans a caller of the package may open around its calls (the
#: benchmark's), which no span of the package may be named
CALLER_SPANS = ("window", "make_inputs", "merl_targets", "fit_materials",
                "tabulate_merl_batch", "render", "readback")
STEPS, BOUNCES, TAB_RES = 3, 3, 12


def _directions(n, seed=0):
    return batch.sample_direction_set(
        n, torch.Generator().manual_seed(seed), device="cpu")


def _fit_materials():
    i, o = _directions(256)
    targets = 0.05 + torch.rand((2, 256, 3),
                                generator=torch.Generator().manual_seed(1))
    batch.fit_materials(targets, i, o, steps=STEPS)


def _fit_lsq():
    i, o = _directions(256)
    target = 0.05 + torch.rand((256, 3),
                               generator=torch.Generator().manual_seed(2))
    lsq.fit_lsq(GGX(), i, o, target, steps=STEPS)


def _tabulate():
    rng = np.random.default_rng(3)
    tables = torch.from_numpy(
        rng.uniform(0.01, 1.0, (2, 3, 90, 90, 180)).astype(np.float32))
    batch.tabulate_merl_batch(tables, TAB_RES)


def _microfacet(dist, alpha, f0):
    return MicrofacetMaterial(dist=dist, fres=fresnel.Schlick(
        f0=torch.tensor(f0)), params=MicrofacetParams.elliptic(*alpha))


def _scene(kind):
    """(sphere, floor): the preview's GGX sphere over a Beckmann floor
    (the SoA loop with its spp-deduplicated first bounce), two GGX
    materials (the SoA loop without it), or cosine materials (the
    generic loops)."""
    if kind == "generic":
        lam = Lambert(reflectance=torch.tensor([0.4, 0.5, 0.6]))
        return CosineMaterial(model=lam), CosineMaterial(model=lam)
    sphere = _microfacet(GGX(), (0.3, 0.15, 0.7), [0.9, 0.6, 0.3])
    floor = (_microfacet(Beckmann(), (0.5, 0.5, 0.0), [0.3, 0.3, 0.3])
             if kind == "dedup" else
             _microfacet(GGX(), (0.4, 0.4, 0.0), [0.3, 0.3, 0.3]))
    return sphere, floor


def _render(kind, envmap):
    def run():
        res, spp = 8, 2
        n = res * res * spp
        gen = torch.Generator().manual_seed(4)
        em = u_env = None
        if envmap:
            img = np.abs(np.random.default_rng(5).normal(
                1.0, 0.5, (8, 16, 3))).astype(np.float32)
            em = EnvMap.build(img, device="cpu")
            u_env = torch.rand((BOUNCES, n, 3), generator=gen)
        pathtrace.render(*_scene(kind), torch.tensor([0.3, 0.4, 0.8]),
                         torch.tensor([4.0, 4.0, 4.0]),
                         torch.tensor([0.3, 0.35, 0.4]), res=res, spp=spp,
                         max_bounces=BOUNCES,
                         u=torch.rand((BOUNCES, n, 2), generator=gen),
                         envmap=em, u_env=u_env)
    return run


CASES = {
    "fit_materials": _fit_materials,
    "fit_lsq": _fit_lsq,
    "tabulate_merl_batch": _tabulate,
    "render_delta": _render("dedup", False),
    "render_delta_ggx": _render("ggx", False),
    "render_delta_generic": _render("generic", False),
    "render_map": _render("dedup", True),
    "render_map_generic": _render("generic", True),
}


def _spans(path):
    """The trace's ``record_function`` ranges as (name, start, end) in
    us, sorted by start."""
    events = json.loads(path.read_text())["traceEvents"]
    return sorted((e["name"], float(e["ts"]), float(e["ts"]) + e["dur"])
                  for e in events
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation")


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def _inside(spans, name, outer):
    """The spans ``name`` inside the span ``outer``."""
    return [s for s in _named(spans, name)
            if outer[1] <= s[1] and s[2] <= outer[2]]


def _check_fit(spans, name):
    steps = _named(spans, "dj.fit.step")
    assert len(steps) == STEPS
    for step in steps:
        assert len(_inside(spans, "dj.fit.kernel", step)) == 1
    assert len(_named(spans, "dj.fit.kernel")) == STEPS


def _check_tabulate(spans, name):
    for stage in ("kernel_matrix", "power", "sigma", "fresnel", "cdf",
                  "moments"):
        assert len(_named(spans, f"dj.tab.{stage}")) == 1, stage
    for stage in ("kernel_matrix", "fresnel"):
        (outer,) = _named(spans, f"dj.tab.{stage}")
        assert _inside(spans, "dj.merl.lookup", outer), stage


def _check_render(spans, name):
    bounces = _named(spans, "dj.render.bounce")
    assert len(bounces) == BOUNCES
    for bounce in bounces:
        assert _inside(spans, "dj.render.bsdf", bounce)
    if "generic" not in name:
        assert all(_inside(spans, "dj.render.intersect", b)
                   for b in bounces)
    env = _named(spans, "dj.render.envmap")
    if "map" in name:
        assert all(_inside(spans, "dj.render.envmap", b) for b in bounces)
    else:
        assert env == []


CHECKS = {"fit_materials": _check_fit, "fit_lsq": _check_fit,
          "tabulate_merl_batch": _check_tabulate}


@pytest.mark.parametrize("name", list(CASES))
def test_no_span_without_a_profiler(name, monkeypatch):
    """With no profiler running, the package never opens a
    ``record_function`` range: a span costs a check of the profiler's
    state and nothing more."""
    assert not torch.autograd._profiler_enabled()

    def refuse(*args, **kwargs):
        raise AssertionError(f"record_function{args} with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    CASES[name]()


@pytest.mark.parametrize("name", list(CASES))
def test_trace_holds_the_spans(name, tmp_path):
    """Under ``utils.trace()`` the exported ``trace.json`` holds the
    call's spans, each where the package opens it, and none but the
    names of ``profiling.SPANS``."""
    with profiling.trace(str(tmp_path)):
        CASES[name]()
    spans = _spans(tmp_path / "trace.json")
    ours = {s[0] for s in spans if s[0].startswith("dj.")}
    assert ours and ours <= set(profiling.SPANS)
    CHECKS.get(name, _check_render)(spans, name)


def test_span_names():
    """Every span's name starts with ``dj.``, none repeats, and none
    equals a span a caller opens around its calls."""
    assert len(set(profiling.SPANS)) == len(profiling.SPANS)
    assert all(n.startswith("dj.") for n in profiling.SPANS)
    assert not set(profiling.SPANS) & set(CALLER_SPANS)
    assert profiling.span("dj.fit.step") is profiling.span("dj.render.bsdf")
