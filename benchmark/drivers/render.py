"""Path-traced preview frames: the closed loop of ``preview512.frame``
(delta light) and ``preview512.envmap`` (the traffic's ``light`` is
``"envmap"``).

One unit is one frame: the uniforms ``u`` (bounces, res*res*spp, 2),
and under the map ``u_env`` (bounces, res*res*spp, 3), drawn from (seed,
frame) by the benchmark, then the program's ``render`` of the
configuration's scene, ending in a synchronize. A frame's latency runs
from the call to its image being ready on the device. A unit's item is
its frame.

The check: frames kept from the whole window by reservoir sampling from
the seed, as the program returned them, against the reference's frame
from the same uniforms (and the same map's image).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import Reservoir, generator, sub_seed

ENV_IMAGE, UNIFORMS, CHECK_FRAMES, WARM = range(4)


def _vec(x, device):
    return torch.tensor(x, dtype=torch.float32, device=device)


def setup(ctx):
    from dj_brdf_torch import fresnel
    from dj_brdf_torch.microfacet.ndf import GGX, Beckmann
    from dj_brdf_torch.microfacet.params import MicrofacetParams
    from dj_brdf_torch.render.materials import MicrofacetMaterial
    from dj_brdf_torch.render.pathtrace import render

    cfg, tr, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    dists = {"ggx": GGX, "beckmann": Beckmann}

    def material(m):
        a = _vec(m["alpha"], dev)            # a1, a2, phi of the ellipse
        return MicrofacetMaterial(
            dist=dists[m["dist"]](),
            fres=fresnel.Schlick(f0=_vec(m["f0"], dev)),
            params=MicrofacetParams.elliptic(a[0], a[1], a[2]))

    state = {"render": render, "sphere": material(cfg["sphere"]),
             "floor": material(cfg["floor"]), "env_image": None,
             "envmap": None}
    light = cfg["light"]
    if tr["light"] == "envmap":
        from dj_brdf_torch.render.envmap import EnvMap

        env = cfg["envmap"]
        img = ctx.cell.reference.env_image(
            env["height"], env["width"],
            np.random.default_rng(sub_seed(ctx.seed, ENV_IMAGE)))
        state["env_image"] = img
        state["envmap"] = EnvMap.build(img, filter=env["filter"], device=dev)
        zero = _vec([0.0, 0.0, 0.0], dev)
        state["light"] = (_vec(light["dir"], dev), zero, zero)
    else:
        state["light"] = (_vec(light["dir"], dev),
                          _vec(light["radiance"], dev),
                          _vec(light["sky"], dev))
    state["kept"] = Reservoir(ctx.seed, CHECK_FRAMES,
                              tr["check"]["frames"])
    return state


def uniforms(ctx, key, k):
    """(u, u_env) of frame ``k``: u_env is None under the delta light."""
    cfg = ctx.cell.config
    n = cfg["res"] * cfg["res"] * cfg["spp"]
    gen = generator(ctx.seed, key, k, device=ctx.device)
    u = torch.rand((cfg["bounces"], n, 2), generator=gen, device=ctx.device)
    u_env = None
    if ctx.cell.traffic["light"] == "envmap":
        u_env = torch.rand((cfg["bounces"], n, 3), generator=gen,
                           device=ctx.device)
    return u, u_env


def _frame(ctx, state, u, u_env):
    cfg = ctx.cell.config
    ldir, lrad, sky = state["light"]
    with ctx.spans("render"):
        return state["render"](state["sphere"], state["floor"], ldir, lrad,
                               sky, res=cfg["res"], spp=cfg["spp"],
                               max_bounces=cfg["bounces"], u=u,
                               jitter=False, envmap=state["envmap"],
                               u_env=u_env)


def warmup(ctx, state):
    _frame(ctx, state, *uniforms(ctx, WARM, 0))


def unit(ctx, state, k):
    with ctx.spans("make_inputs"):
        u, u_env = uniforms(ctx, UNIFORMS, k)
    t0 = time.perf_counter()
    img = _frame(ctx, state, u, u_env)
    with ctx.spans("readback"):
        ctx.spans.sync()
    t1 = time.perf_counter()
    state["kept"].offer(k, img)
    return {"items": 1, "k": k, "latency_s": t1 - t0}


def release(ctx, state):
    """Hand on the map's image and the kept frames."""
    img, kept = state["env_image"], state["kept"].kept
    state.clear()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    return img, kept


def check(ctx, inputs, records):
    """(numbers, failed): ``image_rel_l1``, the widest sum of absolute
    pixel gaps over the sum of the reference's pixels of a kept frame;
    ``pixel_gap_share``, the widest share of a kept frame's pixels whose
    gap passes a hundredth of the reference's mean pixel. ``failed``
    counts the kept frames beyond a limit."""
    env_image, kept = inputs
    ref, cfg = ctx.cell.reference, ctx.cell.config
    limits = ctx.cell.traffic["limits"]
    env = (ref.EnvMap(env_image, torch.float64, ctx.device)
           if env_image is not None else None)
    env_low = (ref.EnvMap(env_image, torch.bfloat16, ctx.device)
               if env_image is not None and ctx.control else None)
    worst_l1 = worst_px = 0.0
    bad = 0
    for k, image in sorted(kept.items()):
        u, u_env = uniforms(ctx, UNIFORMS, k)
        want = ref.render(cfg, u, u_env, env)
        if ctx.control:
            got = ref.render(cfg, u, u_env, env_low, dtype=torch.bfloat16)
        else:
            got = image.double()
        gap = (got - want).abs()
        l1 = float(gap.sum() / want.abs().sum().clamp_min(1e-30))
        px = float((gap.amax(-1) > 1e-2 * want.abs().mean()).double().mean())
        worst_l1, worst_px = max(worst_l1, l1), max(worst_px, px)
        bad += l1 > limits["image_rel_l1"] or px > limits["pixel_gap_share"]
        ctx.log(f"render check: frame {k} of {len(records)}: rel l1 {l1!r}, pixel "
                f"gap share {px!r}")
    return {"image_rel_l1": worst_l1, "pixel_gap_share": worst_px}, bad
