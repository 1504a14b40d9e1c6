"""Card against CPU for chip_smoke.py's envmap frames, and the emitter
row gathers alone, on a CUDA card.

Part 1 renders phase 15's two maps (bench.py's GGX sphere over its
Beckmann floor) and phase 16's matpreview frame at res 32, spp 4 on the
card and on the CPU with the same uniforms, for several uniform seeds,
and counts the pixels beyond phase 13's tolerances (rtol and atol 1e-4).
The matpreview frame also runs under the delta light, without mip
selection, with a constant alpha map and with zero LEAN means, which
tells which of its parts the differing pixels come from.

Part 2 times the row gathers of an envmap frame (524,288 rows of the
alias table, (H*W, 4), and of the packed table, (H*W, 16) bilinear or
(H*W, 4) nearest) by ``index_select``, as the port reads them, against
``torch.take`` of the flat table at the rows' element indices, in device
time (torch.profiler), in turns.

    python scripts/envmap_parity.py [--seeds 8] [--out results.json]
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from dj_brdf_torch.render import pathtrace  # noqa: E402
from dj_brdf_torch.render.envmap import EnvMap  # noqa: E402

RES, SPP = 32, 4
BLACK = (0.0, 0.0, 0.0)


def flips(render_on, seed):
    """Pixels of ``render_on(device, u, u_env)`` beyond phase 13's
    tolerances, card against CPU, and the largest difference."""
    gen = torch.Generator().manual_seed(seed)
    n = RES * RES * SPP
    u = torch.rand((cs.ENV_BOUNCES, n, 2), generator=gen)
    u_env = torch.rand((cs.ENV_BOUNCES, n, 3), generator=gen)
    img = {d: render_on(d, u.to(d), u_env.to(d)).detach().cpu()
           for d in ("cuda", "cpu")}
    diff = (img["cuda"] - img["cpu"]).abs()
    bad = (diff > cs.PT_ATOL + cs.PT_RTOL * img["cpu"].abs()).any(-1)
    return int(bad.sum()), float(diff.max())


def phase15_render(img):
    maps = {d: EnvMap.build(img, device=d) for d in ("cuda", "cpu")}

    def render_on(device, u, u_env):
        s_mat, f_mat = cs.pt_scene("beck", device)
        return pathtrace.render(s_mat, f_mat, cs.PT_LIGHT, BLACK, BLACK,
                                res=RES, spp=SPP, max_bounces=cs.ENV_BOUNCES,
                                u=u, u_env=u_env, envmap=maps[device])
    return render_on


def matpreview_render(variant):
    rng = np.random.default_rng(0)        # chip_smoke.py phase 16's draws
    img = np.abs(rng.normal(1.0, 0.5, (256, 512, 3))).astype(np.float32)
    img[50:60, 160:170] *= 60.0
    amap = rng.uniform(0.05, 0.6, (512, 512)).astype(np.float32)
    e1 = rng.normal(0, 0.15, (512, 512)).astype(np.float32)
    if variant == "constant alpha":
        amap = np.full_like(amap, 0.3)
    if variant == "zero LEAN means":
        e1 = np.zeros_like(e1)
    maps = {d: EnvMap.build(img, device=d) for d in ("cuda", "cpu")}

    def render_on(device, u, u_env):
        s_mat, f_mat = cs.matpreview_scene(
            device, torch.from_numpy(amap).to(device),
            torch.from_numpy(e1).to(device))
        if variant == "no mip selection":
            f_mat = f_mat.replace(mip_lod=False)
        if variant == "delta light":
            return pathtrace.render(s_mat, f_mat, cs.PT_LIGHT,
                                    cs.PT_LIGHT_RAD, cs.PT_SKY, res=RES,
                                    spp=SPP, max_bounces=cs.ENV_BOUNCES, u=u)
        return pathtrace.render(s_mat, f_mat, cs.PT_LIGHT, BLACK, BLACK,
                                res=RES, spp=SPP, max_bounces=cs.ENV_BOUNCES,
                                u=u, u_env=u_env, envmap=maps[device])
    return render_on


def gather_ms(fn, reps=20):
    """Device ms of one call of ``fn``: the kernels' summed time over
    ``reps`` calls under torch.profiler, divided by ``reps``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(e.time_range.elapsed_us() for e in kernels) / reps / 1e3, \
        sorted({e.name[:60] for e in kernels})


def gathers():
    out = {}
    n = cs.ENV_RES * cs.ENV_RES * cs.ENV_SPP
    gen = torch.Generator(device="cuda").manual_seed(0)
    for (h, w), width in (((32, 64), 16), ((1024, 2048), 4), ((32, 64), 4)):
        table = torch.rand((h * w, width), generator=gen, device="cuda")
        idx = torch.randint(0, h * w, (n,), generator=gen, device="cuda",
                            dtype=torch.int32)
        flat = (idx.long()[:, None] * width
                + torch.arange(width, device="cuda")).reshape(-1)

        def by_select():
            return table.index_select(0, idx)

        def by_take():
            return torch.take(table, flat).reshape(n, width)

        if not torch.equal(by_select(), by_take()):
            raise AssertionError("take and index_select disagree")
        times = {"index_select": [], "take": []}
        names = {}
        for name in ("index_select", "take", "take", "index_select"):
            ms, names[name] = gather_ms(by_select if name == "index_select"
                                        else by_take)
            times[name].append(ms)
        key = f"{h}x{w} rows of {width} f32"
        nbytes = n * width * 4 * 2 + n * 4
        out[key] = {"index_select_ms": min(times["index_select"]),
                    "take_ms": min(times["take"]),
                    "bound_ms": nbytes / cs.HBM_BYTES_PER_S * 1e3,
                    "kernels": names}
        print(f"gather {n} {key}: index_select "
              f"{min(times['index_select']):.4f} ms ({names['index_select']}),"
              f" take {min(times['take']):.4f} ms ({names['take']}); byte "
              f"bound {out[key]['bound_ms']:.4f} ms", flush=True)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seeds", type=int, default=8)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("envmap_parity: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip(),
          flush=True)
    cases = {f"phase 15 {h}x{w}": phase15_render(cs.env_image(h, w))
             for h, w in cs.ENV_SIZES}
    for variant in ("envmap", "delta light", "no mip selection",
                    "constant alpha", "zero LEAN means"):
        cases[f"phase 16 {variant}"] = matpreview_render(variant)
    results = {}
    for name, render_on in cases.items():
        runs = [flips(render_on, seed) for seed in range(1, args.seeds + 1)]
        results[name] = runs
        print(f"{name}: pixels beyond tolerance over seeds 1-{args.seeds} "
              f"{[f for f, _ in runs]}, largest difference "
              f"{max(d for _, d in runs):.3e}", flush=True)
    results["gathers"] = gathers()
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(results, fh, indent=1)


if __name__ == "__main__":
    main()
