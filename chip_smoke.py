#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one GPU: the fitting step,
measured MERL data through tabulation to fitted roughness, the autodiff
cross-check of the fit step, and rendering.

    python3 chip_smoke.py [--seed 0] [--out results.json] [--baseline DIR]

``--baseline DIR``: a checkout of another commit of the port (for
example ``git archive REV | tar -x -C build/baseline``); phase 14 then
times its MERL lookup and K4 against this checkout's, in turns.

Phases, one line each; any failure raises and exits non-zero:

0. device check (a CUDA card is required: there is no CPU fallback);
   prints ``nvidia-smi``'s name and power limit; TF32 off.
1. build every kernel source (``dj_brdf_torch/csrc/*.cu``) from source
   into ``build/dj_brdf_torch/``, one ``nvcc`` per source, in parallel;
   beside them, count the f32 operations of one evaluation of each
   kernel in the SASS of these sources (``cuobjdump -sass``): the
   operation side of every fused-fit and K4 bound below.
2. kernel against its plain PyTorch version on the card, both
   families, at the main path's shapes: one material at N = 2^23 + 1000
   (a ragged tail), and M = 100 materials at N = 1,458,000 (one sample
   per MERL table cell); a second launch on the same inputs must give
   the same (M, 9) bit for bit; degenerate samples must add exactly 0.
3. ``fit_materials`` on 100 random isotropic GGX materials at
   1,458,000 directions, 1000 steps: parameter recovery.
4. the same with 100 Beckmann materials, 150 steps.
5. ``fit_lsq`` on one GGX material at N = 2^23, 400 steps.
6. kernel and plain version timed with CUDA events at those shapes,
   each beside its bound (the least time the card could take: bytes
   over the HBM rate or f32 operations over the f32 rate, the larger),
   with the kernel's grid and resident CTAs per SM.
7. the MERL gather kernels against their plain versions, bit for bit:
   K5 (flat index) and K6 (row/lane index into the padded plane) at
   2^22 uniform-random indices into one uniform-random 1,458,000-entry
   plane (``tools/gather_experiments.py``'s shapes), timed beside the
   one PyTorch call that computes each (``plane[idx]``, ``plane2d[row,
   lane]``); then the gather path itself, K5 and K6 in turn as that
   script runs them.
8. MERL targets -> fit: phase 3's 100 GGX+Schlick materials baked into
   100 MERL tables on the card (``io.synth.bake_merl``); the lookup
   against its plain version at M = 100 x N = 1,458,000 (phase 3's
   directions), bit for bit, timed; each of its two paths (direct,
   packed) at N = P/16, P/4 and P, bit for bit and timed in turns, with
   the L2 sectors per lookup and the kernel launches per call of each;
   ``tables.index_select(2, k)`` timed as a yardstick for the lookup's
   gather half; then ``merl_targets`` and ``fit_materials`` (GGX, 1000
   steps) with phase 3's recovery bounds.
9. ``tabulate_merl_batch(tables, 90)`` on the 100 tables on the card,
   held against the port's CPU path on the first 4; GGX alphas of the
   materials with alpha <= 0.3 within 6%.
10. ``python -m dj_brdf_torch.cli.merl_params --device cuda`` in a
   subprocess on 4 of those tables written as .binary files; its
   params.txt must agree with phase 9 to the printed 3 decimals.
11. K4, ``ggx_lsq_value_and_grad(..., adjoint="ad")``, at N = 2^23 + 1000
   and three parameter points (raw_init, phase 5's fit, an anisotropic
   off-centre point): against its plain version (torch.autograd of the
   eager loss) and against K1, one launch per call, two launches equal
   bit for bit, timed; its registers, spills and resident CTAs per SM,
   and its share of two bounds (this build's SASS count and the 1,702
   operations per sample of its first design, one exact divide per
   tangent); ``family="beck"`` must raise.
12. the ``entry()`` sphere (res 256) on the card against the port's CPU
   path, and one gradient of the image mean w.r.t. the params against
   the CPU gradient; timed and profiled.
13. the path tracer at res 512, spp 8, 3 bounces on a GGX sphere over a
   Beckmann floor and over a GGX floor: median frame ms, samples/s,
   kernels per frame (torch.profiler), finite images, sky pixels equal
   to the sky, no device-to-host copy in a frame; card vs CPU at res
   32, spp 4 with the same uniforms; one backward at res 256; and
   ``MeasuredMaterial.from_merl`` on a phase-8 table through the
   generic loop at res 128, spp 4.
14. with ``--baseline DIR`` only, the A/B: the MERL lookup (at phase 8's
   shape by CUDA events, at the tabulation's and the path tracer's by
   device time) and K4 (at phase 11's shape), each checkout's in a
   process of its own, in turns (baseline, this, this, baseline), on
   the same inputs made from the seed; through the public entry points
   ``kernel_merl_lookup`` and ``kernel_ad_sums``, which both keep, so
   any two commits of the port compare. The lookups must agree bit for
   bit, K4 within phase 11's tolerances.

Each main path (phases 3-5, the gather path of 7, 8, 9, 11 and the
measured render of 13) runs with the launch counts of the wrappers set
to 0 just before it and read just after; each kernel must have launched
on its path (the fused fit exactly once per step, K4 once per call). The line before the last is a JSON summary of
the kernels; the last line is the device record
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import collections
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import torch
from torch.optim.optimizer import register_optimizer_step_post_hook

N_MERL = 90 * 90 * 180          # one direction pair per MERL table cell
M_MERL = 100                    # materials in the MERL database
N_SINGLE = 2 ** 23
N_RAGGED = 2 ** 23 + 1000
# Kernel vs plain: the kernel takes approximate reciprocals (+1 Newton
# step) and sums in another order; the tolerances of the JAX package's
# own kernel test (tests/test_ops.py:54-59).
LOSS_RTOL = 1e-4
GRAD_RTOL = 3e-4
GRAD_ATOL_REL = 1e-5            # times max |grad| of the material
# Phase 3's materials and steps. From alpha 0.3, f0 0.5, Adam at lr
# 5e-2 needs more than 300 steps for the extremes (alpha near 0.1, f0
# near 0.05): at N = 2048 the JAX package's fit_materials misses the
# recovery bounds on 4 of 100 such materials at 300 steps, with the same
# numbers as the port. At N = 1,458,000, materials rougher than alpha
# ~0.63 stall in a local minimum (anisotropic, off-centre) where the
# fitted mean normal gates grazing samples out of G1; the plain version
# stalls identically. Up to alpha 0.6, 1000 steps recover every
# material of three seeds with ax within 0.9%, f0 within 0.02.
ALPHA_RANGE_GGX = (0.1, 0.6)
STEPS_GGX_BATCH = 1000

SOURCE = "dj_brdf_torch/csrc/fused_fit.cu"
REPLACES = "dj_brdf_tpu/ops/fused_fit.py:51"
AD_SOURCE = "dj_brdf_torch/csrc/fused_fit_ad.cu"
AD_REPLACES = "dj_brdf_tpu/ops/fused_fit.py:63"
LOSS_RTOL_AD = 1e-5             # K4 and its plain version: exact divides
OPS_AD_SAMPLE_FIRST = 1702      # K4's f32 operations per sample in the SASS
                                # of its first design (an exact divide per
                                # tangent): the same work, whatever
                                # implements it, for the second share
# K4's targets and timed point (phases 11 and 14): targets of another
# material than phase 5's (at phase 5's fitted point its own targets have
# a loss of ~1e-10 and gradients at f32 rounding level, where no relative
# bound means anything), and an anisotropic off-centre point
AD_TRUTH = (0.2, 0.3, -0.15, -0.03, 0.02, 0.85, 0.55, 0.35)
AD_POINT = (0.35, 0.18, 0.25, 0.06, -0.04, 0.8, 0.5, 0.2)
# phase 14's lookups, as (M, N, with iz): merl_targets' and those of
# tabulate_merl_batch(tables, 90) (two per call) and of the path tracer's
# measured material (phase 13)
AB_LOOKUPS = ((M_MERL, N_MERL, True), (M_MERL, 89, False),
              (M_MERL, 15842, False), (1, 65536, True))
# the path tracer: bench.py's scene and sizes (bench.py:467-499)
PT_RES, PT_SPP, PT_BOUNCES = 512, 8, 3
PT_FRAMES = 7
PT_LIGHT = (0.3, 0.4, 0.8)
PT_LIGHT_RAD = (4.0, 4.0, 4.0)
PT_SKY = (0.3, 0.35, 0.4)
# card vs CPU: pixels whose path flips an f32 branch (a grazing hit or a
# horizon test an ulp from its edge) may differ; at most 1 in 256
PT_RTOL, PT_ATOL, PT_MAX_FLIPS = 1e-4, 1e-4, 1 / 256
GATHER_SOURCE = "dj_brdf_torch/csrc/merl_gather.cu"
N_GATHER = 2 ** 22              # tools/gather_experiments.py:23
GATHER_ITERS = 20               # its timed() iterations
RES_TAB = 90                    # the merl_params program's resolution
N_CLI = 4                       # tables handed to the CLI in phase 10
ROOT = os.path.dirname(os.path.abspath(__file__))
# Bounds: published peaks of one H100 SXM (NVIDIA's data sheet), HBM
# bytes/s and f32 operations/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
OPS_LOOKUP = 6                  # 3 scale and 3 cosine products per lookup
# f32 operations of each SASS opcode (an FMA counts two, a MUFU one)
SASS_FLOPS = {"FADD": 1, "FMUL": 1, "FFMA": 2, "MUFU": 1}
# Kernels that run, once each, on values loaded from memory: one
# `accumulate` of csrc/fused_fit.cu per family (a sample and a material),
# one `load_dir` (a sample), and one sample of csrc/fused_fit_ad.cu (the
# difference of a kernel that loads a material and runs one sample and
# one that only loads the material). Phase 1 compiles them with the
# kernel sources and counts their SASS.
SASS_FUSED = r"""
#include "fused_fit.cu"
template <bool kBeck>
__device__ void one_accumulate(const float* in, float* out) {
  Material p;
  float* pf = reinterpret_cast<float*>(&p);
  for (int c = 0; c < 15; ++c) pf[c] = in[c];
  Dir d;
  d.ix = in[15]; d.iy = in[16]; d.iz = in[17];
  d.ox = in[18]; d.oy = in[19]; d.oz = in[20];
  d.bsx = in[21]; d.bsy = in[22]; d.inv_hz4 = in[23];
  d.c5 = in[24]; d.r_oz4 = in[25];
  d.valid_h = in[26] > 0.0f; d.ok_oz = in[27] > 0.0f;
  float acc[kTerms] = {};
  accumulate<kBeck>(p, d, in[28], in[29], in[30], acc);
  for (int c = 0; c < kTerms; ++c) out[c] = acc[c];
}
extern "C" __global__ void count_accumulate_ggx(const float* in, float* out) {
  one_accumulate<false>(in, out);
}
extern "C" __global__ void count_accumulate_beck(const float* in, float* out) {
  one_accumulate<true>(in, out);
}
extern "C" __global__ void count_load_dir(const float* in, float* out) {
  const Dir d = load_dir(in[0], in[1], in[2], in[3], in[4], in[5]);
  out[0] = d.bsx; out[1] = d.bsy; out[2] = d.inv_hz4; out[3] = d.c5;
  out[4] = d.r_oz4; out[5] = d.valid_h; out[6] = d.ok_oz;
}
"""
SASS_AD = r"""
#include "fused_fit_ad.cu"
extern "C" __global__ void count_ad_material(const float* in, float* out) {
  const Material m = load_material(in);
  const float* mf = reinterpret_cast<const float*>(&m);
  for (int c = 0; c < static_cast<int>(sizeof(Material) / 4); ++c)
    out[c] = mf[c];
}
extern "C" __global__ void count_ad_sample(const float* in, float* out) {
  const Material m = load_material(in);
  float acc[kTerms] = {};
  accumulate(m, in[8], in[9], in[10], in[11], in[12], in[13], in[14],
             in[15], in[16], acc);
  for (int c = 0; c < kTerms; ++c) out[c] = acc[c];
}
"""


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps):
    """Mean device milliseconds of ``fn()`` over ``reps`` calls."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def random_pvecs(m, gen):
    """(m, 8) constrained parameters over the range a fit passes
    through: anisotropy, slope correlation, off-centre mean normals and
    Fresnel. (Far outside it, e.g. alpha 0.05 with a mean-normal slope
    of 0.3 against another material's targets, single samples near the
    h.z > 1e-4 gate reach losses of 1e9 and both f32 versions stray
    from a float64 evaluation by percents.)"""
    u = torch.rand((m, 8), generator=gen)
    lo = torch.tensor([0.1, 0.1, -0.3, -0.1, -0.1, 0.05, 0.05, 0.05])
    hi = torch.tensor([0.7, 0.7, 0.3, 0.1, 0.1, 0.95, 0.95, 0.95])
    return (lo + (hi - lo) * u).cuda()


def targets_for(dist, alphas, f0s, i, o, chunk=8):
    """(M, N, 3) targets from the generic ``brdf.evalp``, a few
    materials at a time."""
    from dj_brdf_torch import fresnel
    from dj_brdf_torch.microfacet import brdf
    from dj_brdf_torch.microfacet.params import MicrofacetParams

    out = torch.empty((alphas.shape[0], i.shape[0], 3), device=i.device)
    for k in range(0, alphas.shape[0], chunk):
        a = alphas[k:k + chunk, None]
        params = MicrofacetParams.pdfparams(a, a)
        fres = fresnel.Schlick(f0=f0s[k:k + chunk, None, :])
        out[k:k + chunk] = brdf.evalp(dist, fres, params, i, o)
    return out


def bound(nbytes, ops):
    """The least time (ms) the card could take to move ``nbytes`` and do
    ``ops`` f32 operations, and which of the two sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fused_fit_bound(ops, family, m, n):
    """The fused fit kernel's bound: directions, targets and parameters
    read once, (M, 9) written; accumulate per (sample, material) and
    load_dir per sample (``ops``: phase 1's counts)."""
    return bound(24 * n + 12 * m * n + 32 * m + 36 * m,
                 ops[f"accumulate_{family}"] * m * n + ops["load_dir"] * n)


def start_sass_counts(_build):
    """Starts nvcc on the counting kernels (SASS_FUSED, SASS_AD) beside
    the kernel sources; returns the processes and their cubins."""
    out = _build.BUILD_DIR / "sass"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in (("fused", SASS_FUSED), ("ad", SASS_AD)):
        cu, cubin = out / f"count_{name}.cu", out / f"count_{name}.cubin"
        cu.write_text(text)
        procs[name] = (cubin, subprocess.Popen(
            [_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "-cubin", "-I", str(_build.CSRC), "-o",
             str(cubin), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return procs


def sass_ops(_build, procs):
    """f32 operations of one evaluation of each kernel, from the SASS of
    the counting kernels: {accumulate_ggx, accumulate_beck, load_dir,
    ad_sample}."""
    cubins = {}
    for name, (cubin, proc) in procs.items():
        report, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {name} counting "
                               f"kernels:\n{report}")
        cubins[name] = cubin
    cuobjdump = (shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(_build._nvcc()), "cuobjdump"))

    def opcodes(cubin, function):
        sass = subprocess.run([cuobjdump, "-sass", "-fun", function,
                               str(cubin)], check=True, capture_output=True,
                              text=True, timeout=120).stdout
        ops = collections.Counter()
        for ln in sass.splitlines():
            mt = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?"
                          r"([A-Z][A-Z0-9_]*)", ln)
            if mt:
                ops[mt.group(1).split(".")[0]] += 1
        if not ops:
            raise RuntimeError(f"cuobjdump found no SASS for {function}")
        return ops

    def flops(ops):
        return sum(SASS_FLOPS.get(k, 0) * v for k, v in ops.items())
    out = {name: flops(opcodes(cubins["fused"], f"count_{name}"))
           for name in ("accumulate_ggx", "accumulate_beck", "load_dir")}
    sample = opcodes(cubins["ad"], "count_ad_sample")
    sample.subtract(opcodes(cubins["ad"], "count_ad_material"))
    out["ad_sample"] = flops(+sample)
    return out


def device_ms(fn, reps):
    """Device milliseconds of one ``fn()``: the summed durations of the
    kernels it launches (torch.profiler) over ``reps`` calls; for calls
    too short for CUDA events to see past the host. A session that
    recorded no kernel, or not the same number for every call, is run
    again (seen once on an H100 in a few dozen sessions)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.name.startswith(("Memcpy", "Memset"))]
        if kernels and len(kernels) % reps == 0:
            return sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / reps
    raise AssertionError("torch.profiler recorded no whole set of CUDA "
                         "kernels in three sessions")


def compare(name, family, pvecs, dirs, tgts, n):
    """Kernel vs plain version on the same inputs, and a second launch
    equal to the first bit for bit; returns the largest absolute error of
    the normalized loss and gradient."""
    from dj_brdf_torch.ops import fused_fit as ff

    lk, gk = ff.kernel_fwdbwd_sums(pvecs, dirs, tgts, family)
    lk2, gk2 = ff.kernel_fwdbwd_sums(pvecs, dirs, tgts, family)
    if not (torch.equal(lk, lk2) and torch.equal(gk, gk2)):
        raise AssertionError(f"{name}: two launches on the same inputs "
                             "differ")
    lp, gp = ff.plain_fwdbwd_sums(pvecs, dirs, tgts, family)
    lk, gk, lp, gp = (t.double() / n for t in (lk, gk, lp, gp))
    if not (torch.isfinite(lk).all() and torch.isfinite(gk).all()):
        raise AssertionError(f"{name}: kernel output not finite")
    atol = GRAD_ATOL_REL * gp.abs().amax(dim=1, keepdim=True)
    loss_ok = ((lk - lp).abs() <= LOSS_RTOL * lp.abs()).all()
    grad_ok = ((gk - gp).abs() <= atol + GRAD_RTOL * gp.abs()).all()
    err = max(float((lk - lp).abs().max()), float((gk - gp).abs().max()))
    rel = float(((lk - lp).abs() / lp.abs()).max())
    log(f"phase 2 {name}: max|loss rel err| {rel:.3e}, max abs err {err:.3e}"
        f", a second launch equal bit for bit -> "
        f"{'ok' if loss_ok and grad_ok else 'MISMATCH'}")
    if not (loss_ok and grad_ok):
        bad = ((gk - gp).abs() - atol - GRAD_RTOL * gp.abs()).amax(dim=1)
        raise AssertionError(f"{name}: kernel disagrees with plain "
                             f"(loss ok {bool(loss_ok)}, worst grad excess "
                             f"per material {bad.max().item():.3e})")
    return err


def degenerate_check(family):
    """Samples the fit must ignore: o below the horizon, i == -o. With
    zero targets their loss and every gradient term must be exactly 0."""
    from dj_brdf_torch.ops import fused_fit as ff

    gen = torch.Generator(device="cuda").manual_seed(7)
    n = 3000
    th = torch.rand(n, generator=gen, device="cuda") * 1.5
    ph = torch.rand(n, generator=gen, device="cuda") * 2 * math.pi
    ox, oy, oz = th.sin() * ph.cos(), th.sin() * ph.sin(), th.cos()
    below = torch.arange(n, device="cuda") % 2 == 0
    oz = torch.where(below, -oz, oz)              # o below the horizon
    ix, iy, iz = -ox, -oy, -oz                    # i == -o
    ix = torch.where(below, torch.zeros_like(ix), ix)
    iy = torch.where(below, torch.zeros_like(iy), iy)
    iz = torch.where(below, torch.ones_like(iz), iz)
    dirs = tuple(t.contiguous() for t in (ix, iy, iz, ox, oy, oz))
    zeros = torch.zeros((2, n), device="cuda")
    pvecs = torch.tensor([[0.4, 0.3, 0.1, 0.0, 0.0, 0.5, 0.5, 0.5],
                          [0.05, 0.8, -0.7, 0.3, -0.2, 0.99, 0.01, 0.5]],
                         device="cuda")
    loss, grad = ff.kernel_fwdbwd_sums(pvecs, dirs, (zeros,) * 3, family)
    if loss.abs().max().item() != 0.0 or grad.abs().max().item() != 0.0:
        raise AssertionError(f"degenerate {family}: loss {loss.tolist()}, "
                             f"grad {grad.tolist()}: not exactly 0")
    log(f"phase 2 degenerate {family}: {n} gated samples add exactly 0")


class StepTimer:
    """CUDA events recorded after every optimizer step; intervals
    between consecutive events are step times on the device clock."""

    def __enter__(self):
        self.events = []

        def hook(opt, args, kwargs):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.append(ev)

        self.handle = register_optimizer_step_post_hook(hook)
        return self

    def __exit__(self, *exc):
        self.handle.remove()
        torch.cuda.synchronize()

    def median_ms(self):
        return statistics.median(a.elapsed_time(b) for a, b
                                 in zip(self.events, self.events[1:]))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default=None,
                        help="also write the full results to this JSON file")
    parser.add_argument("--baseline", default=None,
                        help="a checkout of another commit of the port to "
                             "time the MERL lookup and K4 against (phase 14)")
    parser.add_argument("--ab-times", default=None, metavar="ROOT",
                        help=argparse.SUPPRESS)  # one process of phase 14
    args = parser.parse_args(argv)
    if args.ab_times:
        print(json.dumps(ab_times(args.ab_times, args.seed)))
        return

    # ---- phase 0: device
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; the port's kernels need an "
                 "NVIDIA GPU and there is no CPU fallback")
    import dj_brdf_torch  # noqa: F401  (fails outside a checkout)
    from dj_brdf_torch.fit.batch import fit_materials, sample_direction_set
    from dj_brdf_torch.fit.lsq import fit_lsq
    from dj_brdf_torch.microfacet.ndf import GGX, Beckmann
    from dj_brdf_torch.ops import _build, soa
    from dj_brdf_torch.ops import fused_fit as ff
    from dj_brdf_torch.ops import merl_gather as mg

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    log(smi.splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    log(f"phase 0 device: {kind}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; TF32 off for matmul and cuDNN")
    results = {"device": kind, "nvidia_smi": smi, "seed": args.seed}

    # ---- phase 1: build every kernel source, one nvcc each, in parallel
    t0 = time.perf_counter()
    counting = start_sass_counts(_build)
    _build.build_all(["fused_fit", "merl_gather", "fused_fit_ad"])
    ff._lib()
    mg._lib()
    ff._lib_ad()
    ops = sass_ops(_build, counting)
    build_s = time.perf_counter() - t0
    regs = {name: [ln.strip() for ln in _build.ptxas_report(name).splitlines()
                   if "registers" in ln or "spill" in ln]
            for name in ("fused_fit", "merl_gather", "fused_fit_ad")}
    nvcc_s = {k: round(v, 2) for k, v in _build.BUILD_SECONDS.items()}
    log(f"phase 1 build: {build_s:.1f} s (nvcc {nvcc_s}); "
        + " | ".join(r for name in regs for r in regs[name]))
    log(f"phase 1 f32 operations per evaluation, counted in the SASS: {ops}")
    results["build_s"] = build_s
    results["ptxas"] = regs
    results["sass_f32_ops"] = ops

    # ---- phase 2: kernel vs plain at the main path's shapes
    gen = torch.Generator().manual_seed(args.seed)
    dgen = torch.Generator(device="cuda").manual_seed(args.seed)
    errs = {"ggx": 0.0, "beck": 0.0}
    evalp_soa = {"ggx": soa.ggx_evalp_soa, "beck": soa.beckmann_evalp_soa}
    truth = torch.tensor([0.25, 0.25, 0.0, 0.0, 0.0, 0.9, 0.6, 0.3],
                         device="cuda")
    i, o = sample_direction_set(N_RAGGED, dgen, "cuda")
    dirs = tuple(c.contiguous() for c in soa.split_dirs(i, o))
    for family in ("ggx", "beck"):
        tgts = tuple(t[None].contiguous() for t in evalp_soa[family](truth, *dirs))
        for pv in ([0.4, 0.3, 0.1, 0.02, -0.03, 0.5, 0.5, 0.5],
                   [0.05, 0.8, -0.7, 0.3, -0.2, 0.99, 0.01, 0.5]):
            pvecs = torch.tensor([pv], device="cuda")
            errs[family] = max(errs[family], compare(
                f"{family} M=1 N={N_RAGGED}", family, pvecs, dirs, tgts,
                N_RAGGED))
    del i, o, dirs, tgts

    i, o = sample_direction_set(N_MERL, dgen, "cuda")
    dirs = tuple(c.contiguous() for c in soa.split_dirs(i, o))
    for family in ("ggx", "beck"):
        tp = random_pvecs(M_MERL, gen)
        tgts = tuple(torch.stack(ch) for ch in zip(*(
            evalp_soa[family](tp[k], *dirs) for k in range(M_MERL))))
        pvecs = random_pvecs(M_MERL, gen)
        errs[family] = max(errs[family], compare(
            f"{family} M={M_MERL} N={N_MERL}", family, pvecs, dirs, tgts,
            N_MERL))
        degenerate_check(family)
    del tgts

    # ---- phase 3: main path, batched GGX at MERL scale
    ff.LAUNCHES = 0
    launches = {"ggx": 0, "beck": 0}
    dirgen = torch.Generator(device="cuda").manual_seed(0)
    i, o = sample_direction_set(N_MERL, dirgen, "cuda")
    lo, hi = ALPHA_RANGE_GGX
    alphas = (lo + (hi - lo) * torch.rand(M_MERL, generator=gen)).cuda()
    f0s = (0.05 + 0.9 * torch.rand((M_MERL, 3), generator=gen)).cuda()
    targets = targets_for(GGX(), alphas, f0s, i, o)
    torch.cuda.synchronize()
    before = ff.LAUNCHES
    with StepTimer() as timer:
        t0 = time.perf_counter()
        params, fres, losses = fit_materials(targets, i, o,
                                             steps=STEPS_GGX_BATCH)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches["ggx"] += ff.LAUNCHES - before
    step_ms = timer.median_ms()
    ax_err = float(((params.ax - alphas).abs() / alphas).max())
    f0_err = float((fres.f0 - f0s).abs().max())
    log(f"phase 3 fit_materials GGX M={M_MERL} N={N_MERL} "
        f"{STEPS_GGX_BATCH} steps: "
        f"{wall:.2f} s, median step {step_ms:.3f} ms, "
        f"{M_MERL * N_MERL / (step_ms * 1e-3):.4g} evals/s, launches "
        f"{ff.LAUNCHES - before}, max loss {float(losses.max()):.3e}, "
        f"max ax rel err {ax_err:.4f}, max f0 abs err {f0_err:.4f}")
    if ff.LAUNCHES - before != STEPS_GGX_BATCH:
        raise AssertionError(f"phase 3: {ff.LAUNCHES - before} kernel "
                             f"launches for {STEPS_GGX_BATCH} steps")
    if not (torch.isfinite(losses).all() and ax_err <= 0.08
            and f0_err <= 0.08 and float(losses.max()) < 5e-3):
        raise AssertionError("phase 3: GGX batch fit did not recover the "
                             "materials within ax rtol 0.08, f0 atol 0.08, "
                             "max loss < 5e-3")
    results["fit_materials_ggx"] = {
        "wall_s": wall, "median_step_ms": step_ms,
        "evals_per_s": M_MERL * N_MERL / (step_ms * 1e-3),
        "max_loss": float(losses.max()), "max_ax_rel_err": ax_err,
        "max_f0_abs_err": f0_err}
    del targets

    # ---- phase 4: main path, batched Beckmann
    alphas_b = (0.15 + 0.35 * torch.rand(M_MERL, generator=gen)).cuda()
    f0_b = torch.tensor([0.9, 0.6, 0.3], device="cuda").expand(M_MERL, 3)
    targets = targets_for(Beckmann(), alphas_b, f0_b, i, o)
    torch.cuda.synchronize()
    before = ff.LAUNCHES
    with StepTimer() as timer:
        t0 = time.perf_counter()
        params, fres, losses = fit_materials(targets, i, o, steps=150,
                                             dist=Beckmann())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches["beck"] += ff.LAUNCHES - before
    step_ms_b = timer.median_ms()
    ax_err = float(((params.ax - alphas_b).abs() / alphas_b).max())
    log(f"phase 4 fit_materials Beckmann M={M_MERL} N={N_MERL} 150 steps: "
        f"{wall:.2f} s, median step {step_ms_b:.3f} ms, "
        f"{M_MERL * N_MERL / (step_ms_b * 1e-3):.4g} evals/s, launches "
        f"{ff.LAUNCHES - before}, max loss {float(losses.max()):.3e}, "
        f"max ax rel err {ax_err:.4f}")
    if ff.LAUNCHES - before != 150:
        raise AssertionError(f"phase 4: {ff.LAUNCHES - before} kernel "
                             "launches for 150 steps")
    if not (torch.isfinite(losses).all() and ax_err <= 0.1):
        raise AssertionError("phase 4: Beckmann batch fit did not recover "
                             "alpha within rtol 0.1")
    results["fit_materials_beck"] = {
        "wall_s": wall, "median_step_ms": step_ms_b,
        "evals_per_s": M_MERL * N_MERL / (step_ms_b * 1e-3),
        "max_loss": float(losses.max()), "max_ax_rel_err": ax_err}
    del targets

    # ---- phase 5: main path, one GGX material at N = 2^23
    i1, o1 = sample_direction_set(N_SINGLE, dirgen, "cuda")
    true_f0 = torch.tensor([0.9, 0.6, 0.3], device="cuda")
    target = targets_for(GGX(), torch.tensor([0.25], device="cuda"),
                         true_f0[None], i1, o1)[0]
    torch.cuda.synchronize()
    before = ff.LAUNCHES
    with StepTimer() as timer:
        t0 = time.perf_counter()
        params, fres, losses = fit_lsq(GGX(), i1, o1, target, steps=400,
                                       lr=5e-2)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches["ggx"] += ff.LAUNCHES - before
    step_ms_1 = timer.median_ms()
    ax_err = abs(float(params.ax) - 0.25) / 0.25
    f0_err = float((fres.f0 - true_f0).abs().max())
    log(f"phase 5 fit_lsq GGX N={N_SINGLE} 400 steps: {wall:.2f} s, median "
        f"step {step_ms_1:.3f} ms, {N_SINGLE / (step_ms_1 * 1e-3):.4g} "
        f"evals/s, launches {ff.LAUNCHES - before}, last loss "
        f"{float(losses[-1]):.3e}, ax rel err {ax_err:.4f}, f0 abs err "
        f"{f0_err:.4f}")
    if ff.LAUNCHES - before != 400:
        raise AssertionError(f"phase 5: {ff.LAUNCHES - before} kernel "
                             "launches for 400 steps")
    if not (float(losses[-1]) < 1e-3 and ax_err <= 0.05 and f0_err <= 0.05):
        raise AssertionError("phase 5: fit_lsq did not recover alpha 0.25 "
                             "and f0 within the bounds")
    results["fit_lsq_ggx"] = {
        "wall_s": wall, "median_step_ms": step_ms_1,
        "evals_per_s": N_SINGLE / (step_ms_1 * 1e-3),
        "last_loss": float(losses[-1]), "ax_rel_err": ax_err,
        "f0_abs_err": f0_err}
    fitted_pvec = torch.stack([params.ax, params.ay, params.rho, params.txn,
                               params.tyn, *fres.f0]).reshape(8).detach()

    # ---- phase 6: kernel and plain version, CUDA events
    timings = {}
    shapes = (("ggx", M_MERL, N_MERL), ("beck", M_MERL, N_MERL),
              ("ggx", 1, N_SINGLE), ("beck", 1, N_SINGLE))
    for family, m, n in shapes:
        ii, oo = (i, o) if n == N_MERL else (i1, o1)
        dirs = tuple(c.contiguous() for c in soa.split_dirs(ii, oo))
        tp = random_pvecs(m, gen)
        tgts = tuple(torch.stack(ch) for ch in zip(*(
            evalp_soa[family](tp[k], *dirs) for k in range(m))))
        pvecs = random_pvecs(m, gen)

        def kernel():
            ff.kernel_fwdbwd_sums(pvecs, dirs, tgts, family)

        def plain():
            ff.plain_fwdbwd_sums(pvecs, dirs, tgts, family, chunk=10)

        k_ms, p_ms, k_runs, p_runs = timed_pair(kernel, plain, 20, 3)
        nbytes = 24 * n + 12 * n * m
        b_ms, b_by = fused_fit_bound(ops, family, m, n)
        sched = ff.schedule_for(pvecs.device, n, m, family)
        timings[f"{family}_M{m}_N{n}"] = {
            "kernel_ms": k_ms, "plain_ms": p_ms, "kernel_runs_ms": k_runs,
            "plain_runs_ms": p_runs, "kernel_GB_per_s": nbytes / k_ms / 1e6,
            "kernel_evals_per_s": m * n / (k_ms * 1e-3), "bound_ms": b_ms,
            "bound_by": b_by, "bound_share": b_ms / k_ms,
            "grid": sched.grid, "ctas_per_sm": sched.ctas_per_sm}
        log(f"phase 6 {family} M={m} N={n}: kernel {k_ms:.4f} ms "
            f"({nbytes / k_ms / 1e6:.1f} GB/s, {m * n / (k_ms * 1e-3):.4g} "
            f"evals/s), plain {p_ms:.3f} ms, plain/kernel {p_ms / k_ms:.1f}x; "
            f"bound {b_ms:.4f} ms (set by {b_by}), {b_ms / k_ms:.1%} of it; "
            f"grid {sched.grid} CTAs, {sched.ctas_per_sm} resident per SM")
    results["timings"] = timings

    gather = phase7_gathers(mg, ff, dgen, results)
    tables = phase8_merl_fit(mg, ff, alphas, f0s, i, o, launches, results)
    ab, ag, lookup_launches = phase9_tabulate(mg, ff, tables, alphas, results)
    phase10_cli(tables, ab, ag, results)
    k4 = phase11_k4(mg, ff, dgen, fitted_pvec, ops, results)
    phase12_entry(results)
    measured_lookups = phase13_pathtrace(mg, ff, tables, results)
    del tables
    phase14_ab(args.baseline, args.seed, results)
    main_launches = dict(launches)
    main_launches["merl_lookup"] = (results["merl_fit"]["launches_lookup"]
                                    + lookup_launches + measured_lookups)
    main_launches["fused_fit_ad"] = k4["launches"]
    results["launches"] = main_launches
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(results, fh, indent=1)

    kernels = []
    for family in ("ggx", "beck"):
        t = timings[f"{family}_M{M_MERL}_N{N_MERL}"]
        kernels.append({"name": f"fused_fit[{family}]", "route": "cuda",
                        "source": SOURCE, "replaces": REPLACES,
                        "launches": main_launches[family],
                        "max_abs_err": errs[family], "ms": t["kernel_ms"],
                        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                        "bound_by": t["bound_by"], "library_ms": None})
    kernels.append({"name": "fused_fit_ad", "route": "cuda",
                    "source": AD_SOURCE, "replaces": AD_REPLACES,
                    "launches": main_launches["fused_fit_ad"],
                    "max_abs_err": k4["max_abs_err"], "ms": k4["kernel_ms"],
                    "plain_ms": k4["plain_ms"], "bound_ms": k4["bound_ms"],
                    "bound_by": k4["bound_by"], "library_ms": None})
    lk = results["merl_fit"]["lookup"]
    kernels.append({"name": "merl_lookup", "route": "cuda",
                    "source": GATHER_SOURCE,
                    "replaces": "tools/gather_experiments.py:113",
                    "launches": main_launches["merl_lookup"],
                    "max_abs_err": lk["max_abs_err"], "ms": lk["kernel_ms"],
                    "plain_ms": lk["plain_ms"], "bound_ms": lk["bound_ms"],
                    "bound_by": lk["bound_by"], "library_ms": None})
    for name, replaces in (("gather_plane", "tools/gather_experiments.py:113"),
                           ("gather_rowlane", "tools/gather_experiments.py:142")):
        g = gather[name]
        kernels.append({"name": name, "route": "cuda",
                        "source": GATHER_SOURCE, "replaces": replaces,
                        "launches": g["launches"],
                        "max_abs_err": g["max_abs_err"], "ms": g["kernel_ms"],
                        "plain_ms": g["plain_ms"], "bound_ms": g["bound_ms"],
                        "bound_by": g["bound_by"],
                        "library_ms": g["library_ms"]})
    for k in kernels:
        if k["launches"] == 0:
            raise AssertionError(f"{k['name']} never launched on the main path")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


def reset_counts(mg, ff):
    """Every kernel wrapper's launch count to 0."""
    ff.LAUNCHES = 0
    ff.LAUNCHES_AD = 0
    for name in mg.LAUNCHES:
        mg.LAUNCHES[name] = 0


def timed_pair(kernel, plain, kernel_reps, plain_reps):
    """Kernel and plain version in turns (plain, kernel, kernel, plain)
    after a warm-up; the better of each pair, in ms, and all four runs."""
    kernel(), plain()
    p1 = cuda_ms(plain, plain_reps)
    k1 = cuda_ms(kernel, kernel_reps)
    k2 = cuda_ms(kernel, kernel_reps)
    p2 = cuda_ms(plain, plain_reps)
    return min(k1, k2), min(p1, p2), [k1, k2], [p1, p2]


def exact(name, got, want):
    """Bit-for-bit agreement of a kernel with its plain version."""
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version (max abs err {err:.3e})")
    return err


def phase7_gathers(mg, ff, dgen, results):
    """K5 and K6 against their plain versions at the shapes of
    tools/gather_experiments.py, timed; then the gather path."""
    plane = torch.rand(N_MERL, generator=dgen, device="cuda")
    idx = torch.randint(0, N_MERL, (N_GATHER,), generator=dgen,
                        device="cuda", dtype=torch.int32)
    plane2d = mg.pad_plane(plane)
    row, lane = mg.row_lane(idx)
    out = {}
    nbytes = 8 * N_GATHER + 4 * N_MERL     # index + value per lookup, plane
    # the plane entries this run's indices touch, each read once
    touched = int(idx.unique().numel())
    for name, shape, kernel, plain, library, index_bytes in (
            ("gather_plane", (N_MERL,),
             lambda: mg.kernel_gather_plane(plane, idx),
             lambda: mg.plain_gather_plane(plane, idx),
             lambda: plane[idx], 4),
            ("gather_rowlane", tuple(plane2d.shape),
             lambda: mg.kernel_gather_rowlane(plane2d, row, lane),
             lambda: mg.plain_gather_rowlane(plane2d, row, lane),
             lambda: plane2d[row, lane], 8)):
        err = exact(name, kernel(), plain())
        exact(f"{name} library call", library(), plain())
        k_ms, p_ms, k_runs, p_runs = timed_pair(kernel, plain, 20, 5)
        lib_runs = [cuda_ms(library, 20) for _ in range(2)]
        lib_ms = min(lib_runs)
        b_ms, b_by = bound((index_bytes + 4) * N_GATHER + 4 * touched, 0)
        out[name] = {"max_abs_err": err, "kernel_ms": k_ms, "plain_ms": p_ms,
                     "kernel_runs_ms": k_runs, "plain_runs_ms": p_runs,
                     "library_ms": lib_ms, "library_runs_ms": lib_runs,
                     "bound_ms": b_ms, "bound_by": b_by,
                     "lookups_per_s": N_GATHER / (k_ms * 1e-3),
                     "GB_per_s": nbytes / k_ms / 1e6}
        log(f"phase 7 {name} N={N_GATHER} into {shape}: bit for bit (max "
            f"abs err {err}); kernel {k_ms:.4f} ms "
            f"({N_GATHER / (k_ms * 1e-3):.4g} lookups/s, "
            f"{nbytes / k_ms / 1e6:.1f} GB/s), plain {p_ms:.4f} ms, one "
            f"PyTorch call {lib_ms:.4f} ms; bound {b_ms:.4f} ms (set by "
            f"{b_by}, {touched} plane entries touched), {b_ms / k_ms:.1%} "
            "of it")

    # the gather path: K5, then K6, GATHER_ITERS times each
    reset_counts(mg, ff)
    for _ in range(GATHER_ITERS):
        mg.gather_plane(plane, idx)
    for _ in range(GATHER_ITERS):
        mg.gather_rowlane(plane2d, row, lane)
    torch.cuda.synchronize()
    for name in ("gather_plane", "gather_rowlane"):
        out[name]["launches"] = mg.LAUNCHES[name]
        if mg.LAUNCHES[name] != GATHER_ITERS:
            raise AssertionError(f"phase 7: {name} launched "
                                 f"{mg.LAUNCHES[name]} times for "
                                 f"{GATHER_ITERS} gathers")
    log(f"phase 7 gather path: launches {dict(mg.LAUNCHES)}")
    results["gathers"] = out
    return out


def packed_launches(m):
    """Kernels one packed lookup call launches: the mark, then a pack and
    a lookup per pair of tables (the last of an odd ``m`` alone)."""
    return 1 + 2 * -(-m // 2)


def lookup_sectors(packed, m, n, p, idx):
    """32-B L2 sectors per lookup and table of a lookup path, counted
    from this run's indices (not measured): the direct kernel reads 3
    (one per channel plane); the packed path 1 / G for G = min(m, 2)
    tables to a record, plus its pack spread over the N lookups: the
    touched sectors of three planes, one record write per two touched
    cells and the mark (a byte per cell, once per pair). Index, cosine
    and output traffic is the same on both paths."""
    if not packed:
        return 3.0
    group = min(m, 2)
    k = idx.clamp(0, p - 1).long()
    cells = int(k.unique().numel())
    plane_sectors = int((k // 8).unique().numel())   # 8 f32 per sector
    per_table = (n / group + 3 * plane_sectors + cells / 2
                 + p / (32 * group))
    return per_table / n


def phase8_paths(mg, flat, idx, iz):
    """Both lookup paths at N = P/16, P/4 and P against the plain
    version (bit for bit), timed in turns."""
    from dj_brdf_torch.models import merl as merl_mod

    m, _, p = flat.shape
    plans = {"direct": False, "packed": True}
    kernels = {"direct": 1, "packed": packed_launches(m)}
    out = {}
    for label, n in (("P/16", p // 16), ("P/4", p // 4), ("P", p)):
        x, z = idx[:n].contiguous(), iz[:n].contiguous()
        want = mg.plain_merl_lookup(flat, x, merl_mod.SCALES, z, chunk=10)
        fns = {}
        for name, packed in plans.items():
            fns[name] = (lambda packed=packed: mg.launch_merl_lookup(
                flat, x, merl_mod.SCALES, z, packed))
            exact(f"merl_lookup {name} M={m} N={n}", fns[name](), want)
        del want
        reps = 10 if n == p else 20
        runs = {"direct": [], "packed": []}
        for name in ("direct", "packed", "packed", "direct"):
            runs[name].append(cuda_ms(fns[name], reps))
        row = {name: {"ms": min(runs[name]), "runs_ms": runs[name],
                      "kernel_launches_per_call": kernels[name],
                      "sectors_per_lookup": lookup_sectors(packed, m, n, p,
                                                           x)}
               for name, packed in plans.items()}
        row["chosen"] = "packed" if mg.lookup_packs(m, n, p) else "direct"
        out[label] = row
        log(f"phase 8 lookup paths M={m} N={n} ({label}): direct "
            f"{row['direct']['ms']:.4f} ms ({row['direct']['sectors_per_lookup']:.2f}"
            f" sectors/lookup, 1 kernel per call), packed "
            f"{row['packed']['ms']:.4f} ms ({row['packed']['sectors_per_lookup']:.2f}"
            f" sectors/lookup, {kernels['packed']} kernels per call); "
            f"lookup_packs chooses {row['chosen']}; both bit for bit")
    return out


def phase8_merl_fit(mg, ff, alphas, f0s, i, o, launches, results):
    """Bake phase 3's materials into MERL tables on the card, check the
    lookup at full size on both its paths, then fit on the MERL
    targets."""
    from dj_brdf_torch import fresnel
    from dj_brdf_torch.fit.batch import fit_materials, merl_targets
    from dj_brdf_torch.io.synth import bake_merl
    from dj_brdf_torch.microfacet import brdf
    from dj_brdf_torch.microfacet.ndf import GGX
    from dj_brdf_torch.microfacet.params import MicrofacetParams
    from dj_brdf_torch.models import merl as merl_mod

    t0 = time.perf_counter()
    tables = torch.empty((M_MERL, 3, 90, 90, 180), device="cuda")
    for k in range(M_MERL):
        def eval_fn(ii, oo, a=alphas[k], f0=f0s[k]):
            return brdf.eval(GGX(), fresnel.Schlick(f0=f0),
                             MicrofacetParams.isotropic(a), ii, oo)
        tables[k] = bake_merl(eval_fn, device="cuda")
    torch.cuda.synchronize()
    bake_s = time.perf_counter() - t0
    below = float((tables[:, 0] < 0).float().mean())
    log(f"phase 8 bake: {M_MERL} MERL tables on the card in {bake_s:.2f} s "
        f"({below:.4f} of the bins below the horizon)")

    # the lookup kernel against its plain version at the main path's shape
    flat = tables.reshape(M_MERL, 3, -1)
    idx = merl_mod.merl_flat_index(i, o).reshape(-1).contiguous()
    iz = i[:, 2].contiguous()

    def kernel():
        return mg.kernel_merl_lookup(flat, idx, merl_mod.SCALES, iz)

    def plain():
        return mg.plain_merl_lookup(flat, idx, merl_mod.SCALES, iz, chunk=10)

    packed = mg.lookup_packs(M_MERL, N_MERL, flat.shape[-1])
    kernels = packed_launches(M_MERL) if packed else 1
    err = exact(f"merl_lookup M={M_MERL} N={N_MERL}", kernel(), plain())
    k_ms, p_ms, k_runs, p_runs = timed_pair(kernel, plain, 10, 3)
    # targets written, indices and cosines read, each table read once
    nbytes = 12 * M_MERL * N_MERL + 8 * N_MERL + 12 * M_MERL * N_MERL
    # the bound counts only the table cells this run's indices touch
    touched = int(idx.clamp(0, flat.shape[-1] - 1).unique().numel())
    b_ms, b_by = bound(12 * M_MERL * N_MERL + 8 * N_MERL
                       + 12 * M_MERL * touched, OPS_LOOKUP * M_MERL * N_MERL)
    lookup = {"max_abs_err": err, "kernel_ms": k_ms, "plain_ms": p_ms,
              "kernel_runs_ms": k_runs, "plain_runs_ms": p_runs,
              "GB_per_s": nbytes / k_ms / 1e6, "bound_ms": b_ms,
              "bound_by": b_by, "cells_touched": touched,
              "lookups_per_s": M_MERL * N_MERL / (k_ms * 1e-3),
              "path": "packed" if packed else "direct",
              "kernel_launches_per_call": kernels}
    log(f"phase 8 merl_lookup M={M_MERL} N={N_MERL}: the "
        f"{lookup['path']} path, {kernels} kernel "
        f"launches per call (LAUNCHES counts 1); bit for bit (max abs "
        f"err {err}); kernel {k_ms:.4f} ms ({nbytes / k_ms / 1e6:.1f} GB/s, "
        f"{M_MERL * N_MERL / (k_ms * 1e-3):.4g} lookups/s), plain "
        f"{p_ms:.3f} ms, plain/kernel {p_ms / k_ms:.1f}x; bound {b_ms:.4f} "
        f"ms (set by {b_by}, {touched} of {flat.shape[-1]} cells touched), "
        f"{b_ms / k_ms:.1%} of it")
    lookup["paths"] = phase8_paths(mg, flat, idx, iz)
    k = idx.clamp(0, flat.shape[-1] - 1).long()
    lookup["index_select_ms"] = [cuda_ms(lambda: flat.index_select(2, k), 5)
                                 for _ in range(2)]
    log(f"phase 8 yardstick for the lookup's gather half (not the lookup: "
        f"no scale, horizon or cosine, (M, 3, N) out): tables.index_select("
        f"2, k) {min(lookup['index_select_ms']):.4f} ms")

    # the main path: MERL targets -> fit_materials
    torch.cuda.synchronize()
    reset_counts(mg, ff)
    with StepTimer() as timer:
        t0 = time.perf_counter()
        targets = merl_targets(tables, i, o)
        params, fres, losses = fit_materials(targets, i, o,
                                             steps=STEPS_GGX_BATCH)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    fused, looked = ff.LAUNCHES, mg.LAUNCHES["merl_lookup"]
    launches["ggx"] += fused
    step_ms = timer.median_ms()
    ax_err = float(((params.ax - alphas).abs() / alphas).max())
    f0_err = float((fres.f0 - f0s).abs().max())
    log(f"phase 8 merl_targets + fit_materials GGX M={M_MERL} N={N_MERL} "
        f"{STEPS_GGX_BATCH} steps: {wall:.2f} s, median step {step_ms:.3f} "
        f"ms, launches fused {fused} lookup {looked}, max loss "
        f"{float(losses.max()):.3e}, max ax rel err {ax_err:.4f}, max f0 "
        f"abs err {f0_err:.4f}")
    if fused != STEPS_GGX_BATCH or looked < 1:
        raise AssertionError(f"phase 8: {fused} fused fit launches for "
                             f"{STEPS_GGX_BATCH} steps, {looked} lookups")
    if not (torch.isfinite(losses).all() and ax_err <= 0.08
            and f0_err <= 0.08 and float(losses.max()) < 5e-3):
        raise AssertionError("phase 8: the fit on MERL targets did not "
                             "recover the materials within ax rtol 0.08, "
                             "f0 atol 0.08, max loss < 5e-3")
    results["merl_fit"] = {
        "bake_s": bake_s, "below_horizon_share": below, "lookup": lookup,
        "wall_s": wall, "median_step_ms": step_ms,
        "launches_fused": fused, "launches_lookup": looked,
        "max_loss": float(losses.max()), "max_ax_rel_err": ax_err,
        "max_f0_abs_err": f0_err}
    return tables


def phase9_tabulate(mg, ff, tables, alphas, results):
    """The tabulation pipeline on all tables on the card, held against
    the port's CPU path on the first 4."""
    from dj_brdf_torch.fit.batch import tabulate_merl_batch

    walls = []
    for _ in range(2):          # the first call includes one-off set-up
        torch.cuda.synchronize()
        reset_counts(mg, ff)
        t0 = time.perf_counter()
        dists, fres_pts, ab, ag = tabulate_merl_batch(tables, RES_TAB)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        looked = mg.LAUNCHES["merl_lookup"]
        if looked < 1:
            raise AssertionError("phase 9: the lookup kernel never launched")
    t0 = time.perf_counter()
    cd, cf, cab, cag = tabulate_merl_batch(tables[:4].cpu(), RES_TAB)
    cpu_s = time.perf_counter() - t0

    def close(name, got, want, rtol, atol=0.0):
        got = got.detach().cpu().double()
        want = want.detach().double()
        bad = (got - want).abs() > atol + rtol * want.abs()
        if bad.any():
            raise AssertionError(f"phase 9: {name} on the card disagrees with "
                                 f"the CPU path (max abs err "
                                 f"{float((got - want).abs().max()):.3e})")
        return float(((got - want).abs() / want.abs().clamp(min=1e-30)).max())

    rels = {"ab": close("ab", ab[:4], cab, 1e-4),
            "ag": close("ag", ag[:4], cag, 1e-4),
            "p22": close("p22", dists.p22[:4], cd.p22, 1e-4),
            "fresnel": close("fresnel points", fres_pts[:4], cf, 1e-4, 1e-5)}
    smooth = alphas <= 0.3
    ag_err = ((ag - alphas).abs() / alphas)[smooth]
    log(f"phase 9 tabulate_merl_batch res {RES_TAB}: {M_MERL} materials in "
        f"{walls[0]:.3f} s (first call), {walls[1]:.3f} s (second); "
        f"lookups {looked}; CPU path on 4 in {cpu_s:.2f} s, max rel err "
        f"vs card {rels}; GGX alpha of {int(smooth.sum())} materials with "
        f"alpha <= 0.3 within {float(ag_err.max()):.4f}")
    if float(ag_err.max()) > 0.06:
        raise AssertionError("phase 9: a GGX alpha <= 0.3 came out more "
                             "than 6% off")
    results["tabulate"] = {"wall_s_first": walls[0], "wall_s": walls[1],
                           "launches_lookup": looked, "cpu_4_s": cpu_s,
                           "max_rel_err_vs_cpu": rels,
                           "max_ag_rel_err_alpha_le_0.3": float(ag_err.max())}
    return ab.cpu(), ag.cpu(), looked


def phase10_cli(tables, ab, ag, results):
    """The merl_params program on the card, in a subprocess."""
    from dj_brdf_torch.io.merl_io import save_merl

    with tempfile.TemporaryDirectory() as tmp:
        files = []
        for k in range(N_CLI):
            files.append(os.path.join(tmp, f"synth-{k:03d}.binary"))
            save_merl(files[-1], tables[k])
        out = os.path.join(tmp, "params.txt")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "dj_brdf_torch.cli.merl_params",
             "--device", "cuda", "-o", out, *files], cwd=ROOT,
            env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
            text=True, timeout=600)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"phase 10: merl_params exited "
                                 f"{proc.returncode}:\n{proc.stderr}")
        with open(out) as fh:
            lines = fh.read().splitlines()
    rows = [ln.split() for ln in lines[1:]]
    want = [(f"synth-{k:03d}", float(ab[k]), float(ag[k]))
            for k in range(N_CLI)]
    ok = (lines[0] == "# MERL Beckmann GGX" and len(rows) == N_CLI
          and all(r[0] == w[0] and abs(float(r[1]) - w[1]) <= 5e-4 + 1e-6
                  and abs(float(r[2]) - w[2]) <= 5e-4 + 1e-6
                  for r, w in zip(rows, want)))
    log(f"phase 10 merl_params --device cuda on {N_CLI} files: exit 0 in "
        f"{wall:.1f} s ({proc.stderr.splitlines()[0]}); params.txt {rows}; "
        f"phase 9 "
        f"{[(w[0], round(w[1], 4), round(w[2], 4)) for w in want]}")
    if not ok:
        raise AssertionError("phase 10: params.txt disagrees with phase 9")
    results["cli"] = {"wall_s": wall, "rows": rows}


def phase11_k4(mg, ff, dgen, fitted_pvec, ops, results):
    """K4, the autodiff cross-check, against its plain version and K1."""
    from dj_brdf_torch.ops import _build
    from dj_brdf_torch.fit.batch import sample_direction_set
    from dj_brdf_torch.fit.lsq import raw_init
    from dj_brdf_torch.ops import soa

    i, o = sample_direction_set(N_RAGGED, dgen, "cuda")
    dirs = tuple(c.contiguous() for c in soa.split_dirs(i, o))
    truth = torch.tensor(AD_TRUTH, device="cuda")
    tgts = tuple(t.contiguous() for t in soa.ggx_evalp_soa(truth, *dirs))
    points = {"raw_init": soa.raw_to_pvec(raw_init(device="cuda")),
              "fit_lsq": fitted_pvec.to("cuda").contiguous(),
              "aniso_offcentre": torch.tensor(AD_POINT, device="cuda")}
    try:
        ff.ggx_lsq_value_and_grad(points["raw_init"], *dirs, *tgts,
                                  family="beck", adjoint="ad")
    except ValueError as exc:
        log(f"phase 11 family='beck' with adjoint='ad' raises: {exc}")
    else:
        raise AssertionError("phase 11: adjoint='ad' accepted family='beck'")

    # the main path: the adjoint="ad" entry point, once per point
    torch.cuda.synchronize()
    reset_counts(mg, ff)
    out = {}
    for name, pv in points.items():
        before = ff.LAUNCHES_AD
        out[name] = ff.ggx_lsq_value_and_grad(pv, *dirs, *tgts,
                                              adjoint="ad")
        if ff.LAUNCHES_AD != before + 1:
            raise AssertionError(f"phase 11: K4 launched "
                                 f"{ff.LAUNCHES_AD - before} times in one "
                                 "call")
    torch.cuda.synchronize()
    launches = ff.LAUNCHES_AD

    err, rows = 0.0, {}
    for name, pv in points.items():
        lk, gk = (x.double() for x in out[name])
        lp, gp = (x.double() / N_RAGGED for x in ff.plain_ad_sums(
            pv, dirs, tgts))
        _, gh = ff.ggx_lsq_value_and_grad(pv, *dirs, *tgts, adjoint="hand")
        gh = gh.double()
        if not (torch.isfinite(lk) and torch.isfinite(gk).all()):
            raise AssertionError(f"phase 11 {name}: K4 output not finite")
        loss_rel = float((lk - lp).abs() / lp.abs())
        ok_plain = bool(((gk - gp).abs() <= GRAD_ATOL_REL * gp.abs().max()
                         + GRAD_RTOL * gp.abs()).all())
        ok_k1 = bool(((gk - gh).abs() <= GRAD_ATOL_REL * gh.abs().max()
                      + GRAD_RTOL * gh.abs()).all())
        err = max(err, float((lk - lp).abs()), float((gk - gp).abs().max()))
        rows[name] = {"loss": float(lk), "loss_rel_err": loss_rel,
                      "grad_max_abs_err_vs_plain": float(
                          (gk - gp).abs().max()),
                      "grad_max_abs_err_vs_k1": float((gk - gh).abs().max())}
        log(f"phase 11 K4 {name} N={N_RAGGED}: loss {float(lk):.6e} (rel "
            f"err vs plain {loss_rel:.3e}), max |grad err| vs plain "
            f"{rows[name]['grad_max_abs_err_vs_plain']:.3e}, vs K1 "
            f"{rows[name]['grad_max_abs_err_vs_k1']:.3e} -> "
            f"{'ok' if loss_rel <= LOSS_RTOL_AD and ok_plain and ok_k1 else 'MISMATCH'}")
        if not (loss_rel <= LOSS_RTOL_AD and ok_plain and ok_k1):
            raise AssertionError(f"phase 11 {name}: K4 disagrees (loss rel "
                                 f"{loss_rel:.3e}, grad vs plain {ok_plain}, "
                                 f"grad vs K1 {ok_k1})")

    pv = points["aniso_offcentre"]
    l1, g1 = ff.kernel_ad_sums(pv, dirs, tgts)
    l2, g2 = ff.kernel_ad_sums(pv, dirs, tgts)
    if not (torch.equal(l1, l2) and torch.equal(g1, g2)):
        raise AssertionError("phase 11: two K4 launches on the same inputs "
                             "differ")
    k_ms, p_ms, k_runs, p_runs = timed_pair(
        lambda: ff.kernel_ad_sums(pv, dirs, tgts),
        lambda: ff.plain_ad_sums(pv, dirs, tgts), 20, 3)
    sched = ff.ad_schedule_for(pv.device, N_RAGGED)
    regs = [ln.strip() for ln in _build.ptxas_report("fused_fit_ad")
            .splitlines() if "registers" in ln or "spill" in ln]
    log(f"phase 11 K4 N={N_RAGGED}: launches {launches} for "
        f"{len(points)} calls, two launches equal bit for bit; kernel "
        f"{k_ms:.4f} ms ({N_RAGGED / (k_ms * 1e-3):.4g} evals/s), plain "
        f"{p_ms:.3f} ms, plain/kernel {p_ms / k_ms:.1f}x; grid {sched.grid} "
        f"CTAs, {ff.occupancy_ad(pv.device.index)} resident per SM; "
        + " | ".join(regs))
    b_ms, b_by = bound(36 * N_RAGGED + 32 + 36, ops["ad_sample"] * N_RAGGED)
    b_first, b_by_first = bound(36 * N_RAGGED + 32 + 36,
                                OPS_AD_SAMPLE_FIRST * N_RAGGED)
    log(f"phase 11 K4 bound {b_ms:.4f} ms (set by {b_by}: "
        f"{ops['ad_sample']} operations per sample in this build's SASS), "
        f"{b_ms / k_ms:.1%} of it; against the first design's "
        f"{OPS_AD_SAMPLE_FIRST} operations per sample {b_first:.4f} ms (set "
        f"by {b_by_first}), {b_first / k_ms:.1%} of it")
    k4 = {"launches": launches, "max_abs_err": err, "kernel_ms": k_ms,
          "plain_ms": p_ms, "kernel_runs_ms": k_runs, "plain_runs_ms": p_runs,
          "bound_ms": b_ms, "bound_by": b_by, "bound_ms_first_design_ops": b_first,
          "grid": sched.grid, "ctas_per_sm": ff.occupancy_ad(pv.device.index),
          "ptxas": regs, "points": rows}
    results["k4"] = k4
    return k4


def profile_frame(fn):
    """One call of ``fn`` under torch.profiler: kernels launched, device
    busy ms (their summed durations), the largest kernel by total time,
    and device-to-host copies."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [e for e in device if not e.name.startswith("Memcpy")
               and not e.name.startswith("Memset")]
    if not kernels:
        raise AssertionError("torch.profiler recorded no CUDA kernel")
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = max(by_name, key=by_name.get)
    return {"kernels": len(kernels),
            "device_busy_ms": sum(by_name.values()) / 1e3,
            "largest_kernel": top[:80],
            "largest_kernel_ms": by_name[top] / 1e3,
            "dtoh_copies": sum("DtoH" in e.name for e in device)}


def phase12_entry(results):
    """The flagship sphere render on the card against the CPU path."""
    from dj_brdf_torch.entry import entry
    from dj_brdf_torch.microfacet.params import MicrofacetParams

    def leaves(params, device):
        return MicrofacetParams(**{k: getattr(params, k).detach().to(device)
                                   .requires_grad_(True)
                                   for k in ("ax", "ay", "rho", "txn",
                                             "tyn")})

    out = {}
    for device in ("cuda", "cpu"):
        fwd, args = entry(device)
        params = leaves(args[0], device)
        img = fwd(params, *args[1:])
        img.mean().backward()
        out[device] = (img.detach().cpu().double(), torch.stack(
            [getattr(params, k).grad for k in ("ax", "ay", "rho", "txn",
                                               "tyn")]).cpu().double())
    (img, grad), (img_c, grad_c) = out["cuda"], out["cpu"]
    visible = img_c.abs().sum(-1) > 0
    scale = float(img_c.abs().max())
    bad_px = ((img - img_c).abs() > 1e-5 * img_c.abs() + 1e-7 * scale)
    rel = float(((img - img_c).abs() / img_c.abs().clamp(min=1e-30))[
        visible].max())
    grad_ok = bool(((grad - grad_c).abs() <= 1e-4 * grad_c.abs()
                    + 1e-6 * grad_c.abs().max()).all())
    fwd, args = entry()                 # the default device is the card
    if args[1].device.type != "cuda":
        raise AssertionError("phase 12: entry() did not default to the card")
    with torch.no_grad():
        fwd(*args)
        ms = cuda_ms(lambda: fwd(*args), 20)
        prof = profile_frame(lambda: fwd(*args))
    log(f"phase 12 entry() res 256: {int(visible.sum())} visible pixels, "
        f"max rel err vs CPU {rel:.3e}, {int(bad_px.sum())} pixels beyond "
        f"rtol 1e-5 (+1e-7 of the max); grad of the mean w.r.t. (ax, ay, "
        f"rho, txn, tyn) {grad.tolist()} vs CPU {grad_c.tolist()} -> "
        f"{'ok' if grad_ok and not bad_px.any() else 'MISMATCH'}; "
        f"forward {ms:.4f} ms, {prof['kernels']} kernels, device busy "
        f"{prof['device_busy_ms']:.4f} ms, largest {prof['largest_kernel']} "
        f"{prof['largest_kernel_ms']:.4f} ms")
    if not (torch.isfinite(grad).all() and grad_ok and not bad_px.any()):
        raise AssertionError("phase 12: the entry() render or its gradient "
                             "on the card disagrees with the CPU path")
    results["entry"] = {"max_rel_err": rel, "grad": grad.tolist(),
                        "grad_cpu": grad_c.tolist(), "forward_ms": ms,
                        "profile": prof}


def pt_scene(floor, device, f0=None, a1=None):
    """bench.py's path-tracer scene: a GGX+Schlick sphere over a
    Beckmann or GGX floor."""
    from dj_brdf_torch import fresnel
    from dj_brdf_torch.microfacet.ndf import GGX, Beckmann
    from dj_brdf_torch.microfacet.params import MicrofacetParams
    from dj_brdf_torch.render.materials import MicrofacetMaterial

    def vec(*x):
        return torch.tensor(x, dtype=torch.float32, device=device)

    f0 = vec(0.9, 0.6, 0.3) if f0 is None else f0
    a1 = vec(0.3)[0] if a1 is None else a1
    sphere = MicrofacetMaterial(GGX(), fresnel.Schlick(f0=f0),
                                MicrofacetParams.elliptic(a1, vec(0.15)[0],
                                                          vec(0.7)[0]))
    floor_mat = MicrofacetMaterial(
        Beckmann() if floor == "beck" else GGX(),
        fresnel.Schlick(f0=vec(0.3, 0.3, 0.3)),
        MicrofacetParams.isotropic(vec(0.5)[0]))
    return sphere, floor_mat


def phase13_pathtrace(mg, ff, tables, results):
    """The path tracer at bench.py's sizes, card vs CPU parity, a
    backward, and a measured material through the generic loop."""
    from dj_brdf_torch.render import pathtrace
    from dj_brdf_torch.render.materials import MeasuredMaterial

    sky = torch.tensor(PT_SKY, device="cuda")
    out = {}
    for floor in ("beck", "ggx"):
        sphere, floor_mat = pt_scene(floor, "cuda")
        gen = torch.Generator(device="cuda").manual_seed(0)

        def frame():
            return pathtrace.render(sphere, floor_mat, PT_LIGHT, PT_LIGHT_RAD,
                                    PT_SKY, res=PT_RES, spp=PT_SPP,
                                    max_bounces=PT_BOUNCES, generator=gen)

        with torch.no_grad():
            img = frame()                              # warm-up
            torch.cuda.synchronize()
            walls = []
            for _ in range(PT_FRAMES):
                t0 = time.perf_counter()
                img = frame()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            prof = profile_frame(frame)
        ms = statistics.median(walls)
        rays = PT_RES * PT_RES * PT_SPP
        corners = torch.stack([img[0, 0], img[0, -1]])
        sky_ok = bool(((corners - sky).abs() <= 1e-6).all())
        finite = bool(torch.isfinite(img).all())
        log(f"phase 13 pathtrace GGX sphere / {floor} floor res {PT_RES} spp "
            f"{PT_SPP} {PT_BOUNCES} bounces: median frame {ms:.3f} ms over "
            f"{PT_FRAMES} ({[round(w, 3) for w in walls]}), "
            f"{rays / (ms * 1e-3):.4g} samples/s, {prof['kernels']} kernels "
            f"per frame, device busy {prof['device_busy_ms']:.3f} ms, "
            f"largest {prof['largest_kernel']} {prof['largest_kernel_ms']:.3f}"
            f" ms, DtoH copies {prof['dtoh_copies']}; mean "
            f"{float(img.mean()):.5f}, finite {finite}, sky corners {sky_ok}")
        if not (finite and sky_ok and img.device.type == "cuda"
                and prof["dtoh_copies"] == 0 and float(img.mean()) > 0.05):
            raise AssertionError(f"phase 13 {floor}: the frame is not finite, "
                                 "its sky pixels differ from the sky, or it "
                                 "copied data to the host")

        # the card against the CPU path, same uniforms
        res, spp = 32, 4
        u = torch.rand((PT_BOUNCES, res * res * spp, 2),
                       generator=torch.Generator().manual_seed(1))
        small = {}
        for device in ("cuda", "cpu"):
            s_mat, f_mat = pt_scene(floor, device)
            small[device] = pathtrace.render(
                s_mat, f_mat, PT_LIGHT, PT_LIGHT_RAD, PT_SKY, res=res,
                spp=spp, max_bounces=PT_BOUNCES, u=u.to(device)).cpu()
        diff = (small["cuda"] - small["cpu"]).abs()
        flips = int((diff > PT_ATOL + PT_RTOL * small["cpu"].abs()).any(-1)
                    .sum())
        log(f"phase 13 {floor} res {res} spp {spp}: card vs CPU max abs err "
            f"{float(diff.max()):.3e}, {flips} of {res * res} pixels beyond "
            f"rtol {PT_RTOL} + atol {PT_ATOL} (allowed "
            f"{int(PT_MAX_FLIPS * res * res)})")
        if flips > PT_MAX_FLIPS * res * res:
            raise AssertionError(f"phase 13 {floor}: the card's render "
                                 "disagrees with the CPU path")
        out[floor] = {"median_frame_ms": ms, "frames_ms": walls,
                      "samples_per_s": rays / (ms * 1e-3), "profile": prof,
                      "mean": float(img.mean()),
                      "cpu_parity_max_abs_err": float(diff.max()),
                      "cpu_parity_flips": flips}

    # one backward of the image mean w.r.t. the sphere's params, res 256
    f0 = torch.tensor([0.9, 0.6, 0.3], device="cuda", requires_grad=True)
    a1 = torch.tensor(0.3, device="cuda", requires_grad=True)
    sphere, floor_mat = pt_scene("beck", "cuda", f0=f0, a1=a1)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    img = pathtrace.render(sphere, floor_mat, PT_LIGHT, PT_LIGHT_RAD, PT_SKY,
                           res=256, spp=PT_SPP, max_bounces=PT_BOUNCES,
                           generator=torch.Generator(device="cuda")
                           .manual_seed(2))
    img.mean().backward()
    torch.cuda.synchronize()
    bwd_s = time.perf_counter() - t0
    grads = torch.cat([f0.grad, a1.grad[None]])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"phase 13 backward res 256 spp {PT_SPP}: d mean / d (f0, alpha1) "
        f"{grads.tolist()} in {bwd_s:.3f} s (forward + backward), peak "
        f"{peak_gb:.2f} GB")
    if not (torch.isfinite(grads).all() and grads.abs().max() > 0):
        raise AssertionError("phase 13: the render gradient is not finite "
                             "or all zero")

    # a measured material through the generic loop
    torch.cuda.synchronize()
    reset_counts(mg, ff)
    t0 = time.perf_counter()
    measured = MeasuredMaterial.from_merl(tables[0])
    _, floor_mat = pt_scene("ggx", "cuda")
    with torch.no_grad():
        img = pathtrace.render(measured, floor_mat, PT_LIGHT, PT_LIGHT_RAD,
                               PT_SKY, res=128, spp=4,
                               max_bounces=PT_BOUNCES,
                               generator=torch.Generator(device="cuda")
                               .manual_seed(3))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    looked = mg.LAUNCHES["merl_lookup"]
    log(f"phase 13 MeasuredMaterial.from_merl (phase 8 table 0, proxy alpha "
        f"{float(measured.proxy_params.ax):.4f}) through the generic loop "
        f"res 128 spp 4: {wall:.3f} s with the proxy fit, lookups {looked}, "
        f"mean {float(img.mean()):.5f}, finite "
        f"{bool(torch.isfinite(img).all())}")
    if not (torch.isfinite(img).all() and looked > 0):
        raise AssertionError("phase 13: the measured-material render is not "
                             "finite or never ran the lookup kernel")
    out["backward"] = {"grads": grads.tolist(), "wall_s": bwd_s,
                       "peak_gb": peak_gb}
    out["measured"] = {"wall_s": wall, "lookups": looked,
                       "proxy_alpha": float(measured.proxy_params.ax)}
    results["pathtrace"] = out
    return looked


def ab_times(root, seed):
    """One process of phase 14: the MERL lookup at ``AB_LOOKUPS`` and K4
    at N = 2^23 + 1000, of the ``dj_brdf_torch`` in the checkout
    ``root``, through its public entry points, on inputs made on the card
    from ``seed`` (random tables with below-horizon entries, phase 8's
    and phase 11's directions); the better of two timings of each, a
    digest of each lookup's output bits and K4's sums."""
    import hashlib

    sys.path.insert(0, os.path.abspath(root))
    import dj_brdf_torch
    from dj_brdf_torch.fit.batch import sample_direction_set
    from dj_brdf_torch.models import merl as merl_mod
    from dj_brdf_torch.ops import _build, soa
    from dj_brdf_torch.ops import fused_fit as ff
    from dj_brdf_torch.ops import merl_gather as mg

    pkg = os.path.dirname(os.path.dirname(os.path.abspath(
        dj_brdf_torch.__file__)))
    if pkg != os.path.abspath(root):
        raise RuntimeError(f"phase 14 imported dj_brdf_torch from {pkg}, "
                           f"not {root}")
    dgen = torch.Generator(device="cuda").manual_seed(seed)
    i, o = sample_direction_set(N_MERL, dgen, "cuda")
    idx = merl_mod.merl_flat_index(i, o).reshape(-1).contiguous()
    iz = i[:, 2].contiguous()
    tables = torch.rand((M_MERL, 3, merl_mod.PLANE), generator=dgen,
                        device="cuda") - 0.05
    out = {"root": pkg, "lookup": {}}
    for m, n, with_iz in AB_LOOKUPS:
        tab, x = tables[:m], idx[:n].contiguous()
        z = iz[:n].contiguous() if with_iz else None

        def fn():
            return mg.kernel_merl_lookup(tab, x, merl_mod.SCALES, z)

        digest = hashlib.sha256(fn().cpu().numpy().tobytes()).hexdigest()
        ms = [cuda_ms(fn, 10) if n == N_MERL else device_ms(fn, 30)
              for _ in range(2)]
        out["lookup"][f"M{m}_N{n}"] = {"ms": min(ms), "sha256": digest}
    del tables
    i, o = sample_direction_set(N_RAGGED, dgen, "cuda")
    dirs = tuple(c.contiguous() for c in soa.split_dirs(i, o))
    tgts = tuple(t.contiguous() for t in soa.ggx_evalp_soa(
        torch.tensor(AD_TRUTH, device="cuda"), *dirs))
    pv = torch.tensor(AD_POINT, device="cuda")
    loss, grad = ff.kernel_ad_sums(pv, dirs, tgts)
    ms = [cuda_ms(lambda: ff.kernel_ad_sums(pv, dirs, tgts), 20)
          for _ in range(2)]
    out["k4"] = {"ms": min(ms), "sums": [float(loss), *grad.tolist()],
                 "ptxas": [ln.strip() for ln in _build.ptxas_report(
                     "fused_fit_ad").splitlines()
                     if "registers" in ln or "spill" in ln]}
    return out


def phase14_ab(baseline, seed, results):
    """The MERL lookup and K4 of this checkout against those of the
    checkout ``baseline``, each in processes of its own, in turns."""
    if baseline is None:
        log("phase 14 A/B: not run (no --baseline)")
        return
    baseline = os.path.abspath(baseline)
    torch.cuda.empty_cache()
    runs = []
    for root in (baseline, ROOT, ROOT, baseline):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--seed", str(seed),
             "--ab-times", root], capture_output=True, text=True,
            timeout=600, cwd=root)
        if proc.returncode != 0:
            raise RuntimeError(f"phase 14 on {root} failed:\n{proc.stderr}")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    base = [r for k, r in enumerate(runs) if k in (0, 3)]
    this = [r for k, r in enumerate(runs) if k in (1, 2)]
    out = {"baseline": baseline, "lookup": {}}
    for key in runs[0]["lookup"]:
        if len({r["lookup"][key]["sha256"] for r in runs}) != 1:
            raise AssertionError(f"phase 14: the lookups {key} of the two "
                                 "checkouts differ")
        b = [r["lookup"][key]["ms"] for r in base]
        t = [r["lookup"][key]["ms"] for r in this]
        out["lookup"][key] = {"baseline_runs_ms": b, "current_runs_ms": t,
                              "current_over_baseline": min(t) / min(b)}
        log(f"phase 14 A/B lookup {key} "
            f"({'CUDA events' if key.endswith(str(N_MERL)) else 'device time'}"
            f"): baseline {b} ms, this {t} ms, this/baseline "
            f"{min(t) / min(b):.4f}; bit for bit")
    a = torch.tensor(base[0]["k4"]["sums"], dtype=torch.float64)
    c = torch.tensor(this[0]["k4"]["sums"], dtype=torch.float64)
    if not (abs(float(a[0] - c[0])) <= LOSS_RTOL_AD * abs(float(a[0]))
            and ((a[1:] - c[1:]).abs() <= GRAD_ATOL_REL * a[1:].abs().max()
                 + GRAD_RTOL * a[1:].abs()).all()):
        raise AssertionError("phase 14: K4 of the two checkouts disagrees")
    b = [r["k4"]["ms"] for r in base]
    t = [r["k4"]["ms"] for r in this]
    out["k4"] = {"baseline_runs_ms": b, "current_runs_ms": t,
                 "current_over_baseline": min(t) / min(b),
                 "baseline_ptxas": base[0]["k4"]["ptxas"],
                 "current_ptxas": this[0]["k4"]["ptxas"]}
    log(f"phase 14 A/B K4 N={N_RAGGED}: baseline {b} ms "
        f"({' | '.join(base[0]['k4']['ptxas'])}), this {t} ms "
        f"({' | '.join(this[0]['k4']['ptxas'])}), this/baseline "
        f"{min(t) / min(b):.4f}; within phase 11's tolerances")
    results["ab"] = out


if __name__ == "__main__":
    main()
