"""Entry points. ``entry()`` returns the flagship forward: a
differentiable sphere render of an anisotropic GGX with Schlick Fresnel
at res 256.

    forward, args = entry()         # on the card; entry("cpu") on the CPU
    img = forward(*args)            # (256, 256, 3)

``dryrun_multichip(n)`` runs the data-parallel paths once each, on tiny
shapes, over :func:`~dj_brdf_torch.parallel.mesh.make_mesh` of n ranks.

Counterpart of ``__graft_entry__.py``; the JAX package jits the forward,
here it runs eagerly on the device of its arguments.
"""

from __future__ import annotations

import torch

from dj_brdf_torch import fresnel
from dj_brdf_torch.microfacet import brdf
from dj_brdf_torch.microfacet.ndf import GGX
from dj_brdf_torch.microfacet.params import MicrofacetParams
from dj_brdf_torch.render.sphere import render_sphere


def entry(device="cuda"):
    """``(forward, example_args)``: ``forward(params, f0, light_dir)``
    renders the sphere; the example arguments live on ``device``, the
    card unless the caller asks for ``"cpu"`` (without a card the default
    raises)."""
    dist = GGX()

    def forward(params, f0, light_dir):
        fres = fresnel.Schlick(f0=f0)
        return render_sphere(
            lambda i, o: brdf.evalp(dist, fres, params, i, o),
            light_dir, res=256)

    def scalar(x):
        return torch.tensor(x, dtype=torch.float32, device=device)

    example_args = (
        MicrofacetParams.elliptic(scalar(0.3), scalar(0.1), scalar(0.5)),
        torch.tensor([0.95, 0.64, 0.54], dtype=torch.float32, device=device),
        torch.tensor([0.3, 0.4, 0.8], dtype=torch.float32, device=device),
    )
    return forward, example_args


def _check(ok, what):
    if not bool(ok):
        raise RuntimeError(f"dryrun_multichip: {what}")


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """Every sharded path once on tiny shapes, over ``make_mesh(n_devices)``
    (the process group torchrun started, or a world of one in-process on
    ``device``): a fused fit step with an Adam update on sample-sharded
    data, the layered loss, a row-sharded matvec with a mean all-reduce,
    the column-sharded anisotropic builder, a MERL fit step, the
    material-sharded tabulation and three pixel-sharded path traces
    (delta light, envmap MIS, textured sphere over a LEAN floor under the
    envmap). Raises on a non-finite or misshapen result. Counterpart of
    ``__graft_entry__.py::dryrun_multichip``."""
    from dj_brdf_torch.core.math import from_spherical
    from dj_brdf_torch.fit import lsq
    from dj_brdf_torch.fit.batch import tabulate_merl_batch
    from dj_brdf_torch.fit.tabular_aniso import build_tabular_anisotropic
    from dj_brdf_torch.lean.filtered import FilteredBeckmannMaterial
    from dj_brdf_torch.lean.lrep import Lrep
    from dj_brdf_torch.models.merl import Merl
    from dj_brdf_torch.parallel.mesh import make_mesh
    from dj_brdf_torch.render import pathtrace
    from dj_brdf_torch.render.envmap import EnvMap
    from dj_brdf_torch.render.materials import (MicrofacetMaterial,
                                                TexturedMicrofacetMaterial)

    mesh = make_mesh(n_devices, device)
    dev = mesh.device
    f32 = dict(dtype=torch.float32, device=dev)

    def vec(*xs):
        return torch.tensor(xs, **f32)

    # tiny synthetic targets: evalp of a known GGX
    n = 16 * n_devices
    gen = torch.Generator(device=dev).manual_seed(0)
    t_i = 0.05 + 1.35 * torch.rand(n, generator=gen, **f32)
    t_o = 0.05 + 1.35 * torch.rand(n, generator=gen, **f32)
    i = from_spherical(t_i, torch.linspace(0.0, 6.0, n, **f32))
    o = from_spherical(t_o, torch.linspace(3.0, 9.0, n, **f32))
    dist = GGX()
    target = brdf.evalp(dist, fresnel.Schlick(f0=vec(0.9, 0.6, 0.3)),
                        MicrofacetParams.isotropic(vec(0.25)[0]), i, o)

    # the product fit step: samples sharded, the loss and gradient
    # all-reduced, one Adam update identical on every rank
    vg, data = lsq.fit_step(dist, i, o, target, mesh=mesh)
    raw, vals = lsq.adam_loop(vg, lsq.raw_init(device=dev), data, 1, 1e-2)
    _check(torch.isfinite(vals).all(), "train step produced a non-finite "
           "loss")
    _check(all(torch.isfinite(t).all() for t in raw), "non-finite params")

    # the layered autodiff loss on the same shards
    _, _, val_l = lsq.fit_lsq(dist, i, o, target, steps=1, fused="never",
                              mesh=mesh)
    _check(torch.isfinite(val_l).all(), "non-finite layered loss")

    # a row-sharded matvec (no communication) and a mean all-reduce
    rows = 8 * n_devices
    a_blk = mesh.shard(torch.ones((rows, rows), **f32) / rows)
    out_blk = a_blk @ torch.ones(rows, **f32)
    out = mesh.all_gather(out_blk, n=rows)
    _check(out.shape == (rows,) and torch.isfinite(out).all(), "matvec")
    _check(torch.isfinite(mesh.all_reduce_mean(out_blk.mean())),
           "mean all-reduce")

    # the anisotropic builder: kernel column blocks per rank + the
    # all-gathered iterate, stage 2 and the Fresnel on the whole table
    def ganiso(di, do):
        return brdf.eval(GGX(), fresnel.Ideal(), MicrofacetParams.elliptic(
            vec(0.3)[0], vec(0.15)[0], vec(0.4)[0]), di, do)

    tab, tab_fres = build_tabular_anisotropic(ganiso, 5, 2 * n_devices,
                                              mesh=mesh, device=dev)
    _check(tab.p22.shape == (2 * n_devices, 5), "aniso table shape")
    _check(torch.isfinite(tab.p22).all() and float(tab.p22.max()) > 0.0,
           "aniso table values")
    _check(torch.isfinite(tab_fres.points).all(), "aniso Fresnel")

    # a MERL fit step on sharded samples (the lookup on the card), then
    # the material-sharded tabulation
    merl = Merl(table=torch.rand((3, 90, 90, 180), generator=gen, **f32))
    params_m, _, val_m = lsq.fit_lsq(dist, i, o, merl.evalp(i, o), steps=1,
                                     init=raw, fused="never", mesh=mesh)
    _check(torch.isfinite(val_m).all() and torch.isfinite(params_m.ax),
           "MERL fit step")
    tables = torch.stack([merl.table * (1.0 + 0.1 * k)
                          for k in range(n_devices)])
    dists, _, ab, ag = tabulate_merl_batch(tables, res=8, mesh=mesh)
    _check(dists.p22.shape == (n_devices, 8), "tabulation shape")
    _check(torch.isfinite(ab).all() and torch.isfinite(ag).all(),
           "tabulated alphas")

    # pixel-sharded path traces
    sphere = MicrofacetMaterial(
        dist=GGX(), fres=fresnel.Schlick(f0=vec(0.9, 0.6, 0.3)),
        params=MicrofacetParams.elliptic(vec(0.3)[0], vec(0.15)[0],
                                         vec(0.7)[0]))
    floor = MicrofacetMaterial(
        dist=GGX(), fres=fresnel.Schlick(f0=vec(0.3, 0.3, 0.3)),
        params=MicrofacetParams.isotropic(vec(0.5)[0]))
    kw = dict(res=8, spp=n_devices, max_bounces=2, mesh=mesh,
              generator=torch.Generator(device=dev).manual_seed(0))
    light = (vec(0.3, 0.4, 0.8), vec(4.0, 4.0, 4.0), vec(0.3, 0.35, 0.4))
    img = pathtrace.render(sphere, floor, *light, **kw)
    _check(img.shape == (8, 8, 3) and torch.isfinite(img).all(),
           "delta-light frame")
    em = EnvMap.build(torch.ones((4, 8, 3)) + torch.linspace(0, 1, 8)[
        None, :, None], device=dev)
    dark = (vec(0.3, 0.4, 0.8), vec(0.0, 0.0, 0.0), vec(0.0, 0.0, 0.0))
    img = pathtrace.render(sphere, floor, *dark, envmap=em, **kw)
    _check(img.shape == (8, 8, 3) and torch.isfinite(img).all()
           and float(img.mean()) > 0.0, "envmap frame")
    amap = torch.linspace(0.1, 0.5, 64, **f32).reshape(8, 8)
    tex_sphere = TexturedMicrofacetMaterial(
        dist=GGX(), fres=fresnel.Schlick(f0=vec(0.9, 0.6, 0.3)),
        alpha1=amap, alpha2=amap, alpha_angle=vec(0.0)[0])
    e1 = torch.zeros((4, 4), **f32)
    lean_floor = FilteredBeckmannMaterial(
        lean=Lrep(E1=e1, E2=e1, E3=e1 + 0.04, E4=e1 + 0.04, E5=e1),
        base_params=MicrofacetParams.isotropic(vec(0.1)[0]),
        eta=vec(0.143, 0.375, 1.442), k=vec(3.983, 2.386, 1.603))
    img = pathtrace.render(tex_sphere, lean_floor, *dark, envmap=em, **kw)
    _check(img.shape == (8, 8, 3) and torch.isfinite(img).all()
           and float(img.mean()) > 0.0, "matpreview frame")
