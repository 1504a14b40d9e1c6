#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one GPU: the fitting step,
measured MERL data through tabulation to fitted roughness, the autodiff
cross-check of the fit step, rendering, UTIA data through the
anisotropic tabulation to a fit and a render, the SGD/ABC fits with
the native file I/O, the MERL lookup's backward, the sharded paths over
an NCCL process group, the programs and utilities, and the port's bench
and tools.

    python3 chip_smoke.py [--seed 0] [--out results.json] [--baseline DIR]

``--baseline DIR``: a checkout of another commit of the port (for
example ``git archive REV | tar -x -C build/baseline``); phase 14 then
times its MERL lookup, K5, K6 and K4 against this checkout's, in turns.

On a host with N GPUs, phase 20's sharded calls run alone over N ranks:

    python3 -m torch.distributed.run --nproc-per-node N chip_smoke.py \
        --mesh-only [--out results.json]

Phases, one line each; any failure raises and exits non-zero:

0. device check (a CUDA card is required: there is no CPU fallback);
   prints ``nvidia-smi``'s name and power limit; TF32 off.
1. build every kernel source (``dj_brdf_torch/csrc/*.cu``) from source
   into ``build/dj_brdf_torch/``, and phase 7's probes, one ``nvcc`` per
   source, in parallel;
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
   plane (``tools/gather_experiments.py``'s shapes), timed in device time
   beside the one PyTorch call that computes each (``plane[idx]``,
   ``plane2d[row, lane]``); beside them the probes of the floors under
   them (``PROBE_CU``: a coalesced copy of the index stream, random 4-B
   loads through L2 on every SM and on half of them, random 4-B loads
   over a 16-CTA cluster's shared memory, and both kinds at once); then
   the gather path itself, K5 and K6 in turn as that script runs them.
8. MERL targets -> fit: phase 3's 100 GGX+Schlick materials baked into
   100 MERL tables on the card (``io.synth.bake_merl``); the lookup
   against its plain version at M = 100 x N = 1,458,000 (phase 3's
   directions), bit for bit, timed; a float64 bake through
   ``merl_targets`` with no cast, equal to the table cast by hand; each
   of its two paths (direct, packed) at N = P/16, P/4 and P, bit for
   bit and timed in turns, with
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
   device time), K5 and K6 (at phase 7's shape, device time) and K4 (at
   phase 11's shape), each checkout's in a process of its own, in turns
   (baseline, this, this, baseline), on the same inputs made from the
   seed; through the public entry points ``kernel_merl_lookup``,
   ``kernel_gather_plane``, ``kernel_gather_rowlane`` and
   ``kernel_ad_sums``, which both keep, so any two commits of the port
   compare. The lookups and gathers must agree bit for bit (sha256 of
   the outputs), K4 within phase 11's tolerances.
15. environment-map MIS at ``bench.py:508-537``'s scenes: lat-long maps
   of 32x64 and 1024x2048 (one synthetic image from ``default_rng(0)``,
   the 2M-bin one with nearest rows), bench.py's GGX sphere over its
   Beckmann floor at res 256, spp 8, 3 bounces: ``EnvMap.build`` host
   seconds, median frame ms of 5, samples/s, kernels per frame, device
   busy ms and the share of the row gathers (alias, packed, texture
   rows: the kernels of index_select and of indexing) in it, no
   device-to-host copy; card vs CPU at res 32, spp 4 with the same
   uniforms within phase 13's flip budget; a backward through
   ``EnvMap.rebind`` at res 64; and a MERL ``MeasuredMaterial`` (phase
   8's table 0) lit by the 32x64 map through the generic loop at res
   128, spp 4, which must launch the lookup.
16. ``bench.py:542-580``'s matpreview frame: a 512x512 alpha-textured
   GGX sphere over a 512x512 LEAN-mapped Beckmann conductor floor with
   ray-cone mip selection, lit by a 256x512 map, at phase 15's res, spp
   and bounces: the same numbers; card vs CPU under the envmap (within
   ``ENV_MAX_FLIPS``) and under the delta light (phase 13's budget);
   and a backward w.r.t. the alpha map and the LEAN E1 map at res 64.
17. UTIA and the anisotropic path at ``bench.py``'s sizes: its
   anisotropic GGX (elliptic 0.3, 0.15, 0.4, Ideal Fresnel) baked into a
   UTIA table on the card (against the CPU bake), written and read back
   by the native parser and by numpy (rtol 1e-6); ``Utia.build`` and
   ``evalp`` at N = 2^23 (evals/s beside the byte bound, kernels, the
   CPU path on 2^16 of them) and the three plain forms of its (N, 48) row
   gather (``index_select``, indexing, a flat ``take``) timed in turns,
   bit for bit; ``nrm_utia --device cuda`` in a subprocess at its
   default 64x256 x 64x256 grid on the GGX bake and a 0.7 Lambert bake
   (ok) and on a 3.0 Lambert bake (exit 1); ``build_tabular_anisotropic``
   at 90x90 (the device f32 power stage) of the analytic GGX
   (``aniso_fit90_wall_seconds``, best of two after a warm run) and of
   the ``Utia``, its peak memory, both against the CPU path (rtol 1e-4;
   qf entries may move by one grid step, counted);
   ``power_iteration_matvecs_per_s_n8010``; both anisotropic moment
   fits on both tables against the CPU path; ``fit_lsq`` (K1, GGX) on
   ``Utia.evalp`` targets at N = 2^22, 200 steps, one launch a step, the
   loss falling, and card vs CPU at 2^16 over 50 steps; renders of
   ``utia_fit``'s (Beckmann with the table's Fresnel and moment-fit
   parameters) and ``utia_tab``'s (the table itself) materials over
   phase 13's GGX floor through the generic loop at res 256, spp 8, 3
   bounces (frame ms, kernels, finite) and card vs CPU at res 32, spp 4.
18. ``SGD.all_materials()`` and ``ABC.all_materials()`` at phase 3's
   1,458,000 directions, a few materials at a time, against the CPU path
   on 4 materials; ``fit_materials`` (K3, GGX) on the 100 SGD targets,
   300 steps, one launch a step, every loss finite and falling; the
   native ``djbio`` MERL and UTIA parsers, HDR decoder and LEAN map
   builders against numpy and the torch maps on the card (HDR and MERL
   bit for bit).
19. the MERL lookup's backward (``MerlLookupGrad``: the kernel forward,
   a scatter-add of torch ops backward) at M = 100 x N = 1,458,000 on
   phase 8's tables, a random output gradient: the gradients w.r.t. the
   tables and ``iz`` against the CPU path's autograd (rtol 1e-5: atomics
   reorder the f32 sums), two lookup launches, the backward's ms beside
   the bytes it must move.
20. the mesh: an NCCL process group of one rank on ``cuda:0``, started
   in-process by ``make_mesh(1)`` (NCCL's init and each collective's
   ms); each sharded call against its unsharded call, the two in turns
   (unsharded, sharded, sharded, unsharded; the shorter wall of each):
   ``fit_materials(mesh=)`` on phase 3's materials (100 steps, bit for
   bit, K3 once a step), ``fit_lsq(mesh=)`` on phase 5's problem (100
   steps, rtol 1e-6, atol 1e-7, K1 once a step, the step time against
   phase 5's), ``build_tabular_anisotropic(mesh=)`` at 90x90 against the
   device power stage (phase 17's tolerance), ``furnace_test(mesh=)`` at
   64x256 on a UTIA bake, ``render(mesh=)`` of a MERL sphere at res 512,
   spp 8, 3 bounces (the lookup) and of an envmap frame, equal to the
   unsharded frames, a backward through the sharded MERL frame w.r.t.
   the table and the floor's f0 (rtol 1e-5), ``dryrun_multichip(1)``;
   then ``merl_params --mesh 1`` and ``nrm_utia --mesh 1`` in
   subprocesses against phases 10 and 20. ``--mesh-only`` under
   torchrun runs the same calls (``mesh_checks``) at its world size.
21. the programs and utilities on the card: ``cli/render.py --device
   cuda`` at res 512 for merl, merl_fit, utia_tab, lean and a
   ``--pathtrace --envmap`` frame, each against the same render called
   directly, and one PNG against its image; ``dmap2nmap`` and
   ``nmap2leanmap`` on a 512x512 PNG written by the port's codec against
   the CPU; checkpoint round trips of phase 20's fitted M = 100 state and
   90x90 table; a ``trace()`` of one fit step, which must show the fit
   kernel.
22. the port's programs at the repo root. First the kernels they run,
   at their shapes and on their own inputs, against the plain versions
   (phase 2's tolerances; the lookup bit for bit): K1 at the headline's
   2^23, K2 at ``fit_step_beckmann``'s, K3 at ``fit_batch_step``'s 16 x
   2^20, the lookup at ``merl_eval``'s one table x 2^23, K1 at
   ``bench_scaling``'s 2^20. Then ``python -m dj_brdf_torch.bench``
   in a subprocess at ``bench.py``'s sizes (exit 0, one line under 2,000
   characters, every metric of ``bench.py`` finite and positive, none
   failed, the headline consistent with the fit step; per its stderr
   records the fused fit kernel launched in the headline, both fit steps
   and the batched step, the lookup in ``merl_eval`` and the tabulation;
   the bench's SASS counts equal to phase 1's); each rate beside the
   earlier phase's timing of the same call at the same shape, as a ratio;
   ``tools.bench_scaling --devices 1`` (an NCCL world of one card) equal
   to the unsharded step bit for bit; ``tools.validate_merl_fits`` on
   the synthetic corpus on the card (exit 0, three materials pinned ok).
   The bench's stderr (every metric's record) goes into ``--out``'s
   results.

Each main path (phases 3-5, the gather path of 7, 8, 9, 11, the
measured render of 13, the measured envmap render of 15, the UTIA fit
of 17, the SGD fit of 18, the backward of 19 and the sharded calls of
20) runs with
the launch counts of the wrappers set to 0 just before it and read just
after; each kernel must have launched on its path (the fused fit
exactly once per step, K4 once per call). Phase 22's bench runs in a
process of its own, whose counts start at 0; each metric's record
carries the launches it made, which the kernels line adds. The line
before the last is a JSON summary of the kernels; the last line is the
device record
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
# environment-map MIS and the matpreview frame (bench.py:508-580)
ENV_SIZES = ((32, 64), (1024, 2048))
ENV_RES, ENV_SPP, ENV_BOUNCES, ENV_FRAMES = 256, 8, 3, 5
GOLD_ETA, GOLD_K = (0.143, 0.375, 1.442), (3.983, 2.386, 1.603)
# the matpreview frame under its envmap, card vs CPU: a lookup whose
# arccos/arctan2 (the card's and the CPU's differ by an ulp or two) lands
# across a half-texel edge of the 256x512 map reads another pdf bin, and
# so another MIS weight; one across an edge of the 512x512 alpha map
# reads another roughness. At res 32, spp 4 that flips 2-7 pixels over
# eight uniform seeds, while the same textured frame under the delta
# light flips none (scripts/envmap_parity.py on an H100): the envmap
# comparison allows 1 pixel in 64
ENV_MAX_FLIPS = 1 / 64
GATHER_SOURCE = "dj_brdf_torch/csrc/merl_gather.cu"
N_GATHER = 2 ** 22              # tools/gather_experiments.py:23
GATHER_ITERS = 20               # its timed() iterations
RES_TAB = 90                    # the merl_params program's resolution
N_CLI = 4                       # tables handed to the CLI in phase 10
# UTIA and the anisotropic path (phase 17): bench.py's sizes
UTIA_PARAMS = (0.3, 0.15, 0.4)  # MicrofacetParams.elliptic, bench.py:654-659
N_UTIA = 2 ** 23                # utia_eval's directions
N_UTIA_FIT = 2 ** 22
N_SLICE = 2 ** 16               # the CPU path's share of the card's work
UTIA_FIT_STEPS = 200
RES_ANISO = 90                  # aniso_fit90_wall_seconds, bench.py:648-669
UTIA_RES, UTIA_SPP = 256, 8
SGD_STEPS = 300                 # phase 18's fit_materials on SGD targets
MESH_STEPS = 100                # phase 20's sharded fits, each way
BWD_RES = 256                   # phase 20's backward through a frame
# a direction within an ulp of a pole or a bin edge evaluates differently
# on the card and on the CPU (arccos near 1 is ill conditioned in f32):
# at most this share of evaluations may stray beyond the tolerance
EVAL_MAX_FLIPS = 1e-3
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


# Probes of the floors under K5 and K6 (phase 7), built in phase 1 beside
# the kernel sources: a coalesced 16-B copy (the floor of an index stream
# in and an output stream out, with no gather between); random 4-B loads
# from a plane through L2 (one 32-B sector each), on every SM and on half
# of them (one CTA an SM); random 4-B loads over a cluster's shared memory
# (mode 0: any CTA of the cluster by ld.shared::cluster; 1: the own CTA
# by the same instruction; 2: the own CTA by ld.shared); and the two
# kinds at once, cluster loads by the first `split` warps of each CTA and
# L2 loads by the others, against each kind alone. Addresses come from a
# generator in registers, eight independent loads in flight per thread.
PROBE_CU = r"""
#include <cuda_runtime.h>
#include <cstdint>

__device__ __forceinline__ unsigned lcg(unsigned x) {
  return x * 1664525u + 1013904223u;
}

__global__ void __launch_bounds__(256)
copy_kernel(const int4* __restrict__ in, int4* __restrict__ out, long long n4) {
  const long long stride = static_cast<long long>(gridDim.x) * 256;
  for (long long j = blockIdx.x * 256LL + threadIdx.x; j < n4; j += stride)
    __stcs(out + j, __ldcs(in + j));
}

__device__ __forceinline__ float l2_loads(const float* __restrict__ buf,
                                          unsigned len, int steps,
                                          unsigned t) {
  unsigned x[8];
  for (int u = 0; u < 8; ++u) x[u] = (t * 8u + u) * 2654435761u + 12345u;
  float acc = 0.0f;
  for (int s = 0; s < steps; ++s) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      x[u] = lcg(x[u]);
      v[u] = __ldg(buf + __umulhi(x[u], len));
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) acc += v[u];
  }
  return acc;
}

__global__ void __launch_bounds__(1024)
l2_random_kernel(const float* __restrict__ buf, unsigned len, int steps,
                 float* __restrict__ sink) {
  const unsigned t = blockIdx.x * blockDim.x + threadIdx.x;
  sink[t] = l2_loads(buf, len, steps, t);
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__global__ void __launch_bounds__(1024, 1)
dsmem_random_kernel(const float* __restrict__ buf, unsigned len,
                    unsigned words, int steps, int mode, unsigned cluster,
                    int split, int dsm, int l2, float* __restrict__ sink) {
  extern __shared__ float held[];
  for (unsigned w = threadIdx.x; w < words; w += 1024) held[w] = w;
  cluster_sync();
  unsigned rank;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(rank));
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(held));
  const unsigned t = blockIdx.x * 1024 + threadIdx.x;
  float acc = 0.0f;
  if (static_cast<int>(threadIdx.x >> 5) >= split) {
    if (l2) acc = l2_loads(buf, len, steps, t);
  } else if (dsm) {
    unsigned x[8];
    for (int u = 0; u < 8; ++u) x[u] = (t * 8u + u) * 2654435761u + 777u;
    for (int s = 0; s < steps; ++s) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        x[u] = lcg(x[u]);
        const unsigned off = __umulhi(x[u] << 4, words);
        if (mode == 2) {
          v[u] = held[off];
        } else {
          uint32_t remote;
          asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                       : "=r"(remote)
                       : "r"(base + 4 * off),
                         "r"(mode == 0 ? (x[u] >> 28) % cluster : rank));
          asm volatile("ld.shared::cluster.f32 %0, [%1];"
                       : "=f"(v[u]) : "r"(remote) : "memory");
        }
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) acc += v[u];
    }
  }
  cluster_sync();
  sink[t] = acc;
}

static cudaLaunchConfig_t dsmem_config(int clusters, unsigned cluster,
                                       unsigned words, cudaStream_t s,
                                       cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * cluster, 1, 1);
  cfg.blockDim = dim3(1024, 1, 1);
  cfg.dynamicSmemBytes = words * 4;
  cfg.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

extern "C" {

int probe_copy(const void* in, void* out, long long bytes, int blocks,
               void* stream) {
  copy_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(in), static_cast<int4*>(out), bytes / 16);
  return static_cast<int>(cudaGetLastError());
}

// `smem` bytes of shared memory a CTA: enough of it (over half an SM's)
// holds each SM to one CTA
int probe_l2_random(const void* buf, unsigned len, int steps, int blocks,
                    int threads, int smem, void* sink, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      l2_random_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  l2_random_kernel<<<blocks, threads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(buf), len, steps, static_cast<float*>(sink));
  return static_cast<int>(cudaGetLastError());
}

int probe_dsmem_clusters(unsigned cluster, unsigned words, int* clusters) {
  cudaError_t err = cudaFuncSetAttribute(
      dsmem_random_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dsmem_random_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             words * 4);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = dsmem_config(1, cluster, words, 0, &attr);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(
      clusters, dsmem_random_kernel, &cfg));
}

int probe_dsmem(const void* buf, unsigned len, unsigned cluster,
                unsigned words, int steps, int mode, int split, int dsm,
                int l2, int clusters, void* sink, void* stream) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = dsmem_config(
      clusters, cluster, words, static_cast<cudaStream_t>(stream), &attr);
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, dsmem_random_kernel, static_cast<const float*>(buf), len, words,
      steps, mode, cluster, split, dsm, l2, static_cast<float*>(sink));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}
"""
PROBE_CLUSTER = 16              # CTAs of the probed clusters
PROBE_WORDS = 31 * 1024         # 4-B words of shared memory a probed CTA
PROBE_SPLIT = 12                # warps of 32 that load over the cluster


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


def start_probe_build(_build):
    """Starts nvcc on PROBE_CU; returns the library's path and the
    process."""
    out = _build.BUILD_DIR / "probe"
    out.mkdir(parents=True, exist_ok=True)
    cu, lib = out / "gather_probe.cu", out / "libgather_probe.so"
    cu.write_text(PROBE_CU)
    return lib, subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(cu)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def probe_lib(lib, proc):
    """The probe library of :func:`start_probe_build`, loaded, with its
    C signatures declared."""
    import ctypes

    report, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the gather probes:\n{report}")
    probe = ctypes.CDLL(str(lib))
    ptr, i64, i32, u32 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                          ctypes.c_uint)
    probe.probe_copy.argtypes = [ptr, ptr, i64, i32, ptr]
    probe.probe_l2_random.argtypes = [ptr, u32, i32, i32, i32, i32, ptr, ptr]
    probe.probe_dsmem_clusters.argtypes = [u32, u32, ctypes.POINTER(i32)]
    probe.probe_dsmem.argtypes = [ptr, u32, u32, u32, i32, i32, i32, i32, i32,
                                  i32, ptr, ptr]
    for fn in (probe.probe_copy, probe.probe_l2_random,
               probe.probe_dsmem_clusters, probe.probe_dsmem):
        fn.restype = ctypes.c_int
    return probe


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


def compare(name, family, pvecs, dirs, tgts, n, phase=2):
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
    log(f"phase {phase} {name}: max|loss rel err| {rel:.3e}, max abs err {err:.3e}"
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
                             "time the MERL lookup, K5, K6 and K4 against "
                             "(phase 14)")
    parser.add_argument("--ab-times", default=None, metavar="ROOT",
                        help=argparse.SUPPRESS)  # one process of phase 14
    parser.add_argument("--mesh-only", action="store_true",
                        help="run phase 20's sharded calls alone, over the "
                             "ranks that torchrun --nproc-per-node N "
                             "started (one card a rank)")
    args = parser.parse_args(argv)
    if args.ab_times:
        print(json.dumps(ab_times(args.ab_times, args.seed)))
        return

    # ---- phase 0: device
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; the port's kernels need an "
                 "NVIDIA GPU and there is no CPU fallback")
    import dj_brdf_torch  # noqa: F401  (fails outside a checkout)
    if args.mesh_only:
        mesh_only(args)
        return
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
    probing = start_probe_build(_build)
    _build.build_all(["fused_fit", "merl_gather", "fused_fit_ad", "alias",
                      "djbio"])
    ff._lib()
    mg._lib()
    ff._lib_ad()
    ops = sass_ops(_build, counting)
    probe = probe_lib(*probing)
    build_s = time.perf_counter() - t0
    regs = {name: [ln.strip() for ln in _build.ptxas_report(name).splitlines()
                   if "registers" in ln or "spill" in ln]
            for name in ("fused_fit", "merl_gather", "fused_fit_ad")}
    nvcc_s = {k: round(v, 2) for k, v in _build.BUILD_SECONDS.items()}
    log(f"phase 1 build: {build_s:.1f} s (nvcc, g++ for alias and djbio: "
        f"{nvcc_s}); "
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

    gather = phase7_gathers(mg, ff, dgen, probe, results)
    tables = phase8_merl_fit(mg, ff, alphas, f0s, i, o, launches, results)
    ab, ag, lookup_launches = phase9_tabulate(mg, ff, tables, alphas, results)
    phase10_cli(tables, ab, ag, results)
    k4 = phase11_k4(mg, ff, dgen, fitted_pvec, ops, results)
    phase12_entry(results)
    measured_lookups = phase13_pathtrace(mg, ff, tables, results)
    measured_lookups += phase19_lookup_backward(mg, tables, i, o, results)
    table0 = tables[0].clone()
    cli_tables = tables[:N_CLI].clone()
    del tables
    phase14_ab(args.baseline, args.seed, results)
    measured_lookups += phase15_envmap(mg, ff, table0, results)
    phase16_matpreview(results)
    launches["ggx"] += phase17_utia(mg, ff, dgen, results)
    launches["ggx"] += phase18_sgd_abc_native(mg, ff, i, o, results)
    sharded, fitted, aniso = phase20_mesh(mg, ff, alphas, f0s, i, o, i1, o1,
                                          table0, cli_tables, results)
    launches["ggx"] += sharded["ggx"]
    measured_lookups += sharded["merl_lookup"]
    phase21_cli_utils(mg, ff, table0, fitted, aniso, i, o, alphas, f0s,
                      results)
    benched, bench_errs = phase22_bench(ops, results)
    for family in ("ggx", "beck"):
        errs[family] = max(errs[family], bench_errs[family])
    launches["ggx"] += benched["ggx"]
    launches["beck"] += benched["beck"]
    main_launches = dict(launches)
    main_launches["merl_lookup"] = (results["merl_fit"]["launches_lookup"]
                                    + lookup_launches + measured_lookups
                                    + benched["merl_lookup"])
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
                    "max_abs_err": max(lk["max_abs_err"],
                                       bench_errs["merl_lookup"]),
                    "ms": lk["kernel_ms"],
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


def run_module(module, *args, timeout=600):
    """``python -m module args`` from the checkout's root; returns the
    finished process and its wall seconds."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=ROOT),
                          capture_output=True, text=True, timeout=timeout)
    return proc, time.perf_counter() - t0


def exact(name, got, want):
    """Bit-for-bit agreement of a kernel with its plain version."""
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version (max abs err {err:.3e})")
    return err


def phase7_probes(probe, plane, idx):
    """The floors under K5 and K6, measured: a coalesced copy of the
    index stream (16 MB in, 16 MB out: the traffic with no gather);
    random 4-B loads from the plane through L2 (one 32-B sector each), on
    every SM and on half of them; random 4-B loads over the shared memory
    of 16-CTA clusters; and cluster loads and L2 loads by separate warps
    at once, against each alone (whether the two rates add)."""
    import ctypes

    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def run(what, err):
        if err != 0:
            raise RuntimeError(f"phase 7 probe {what}: CUDA error {err}")

    copied = torch.empty_like(idx)
    copy_runs = [cuda_ms(lambda: run("copy", probe.probe_copy(
        idx.data_ptr(), copied.data_ptr(), 4 * idx.numel(), sms * 8,
        stream)), 20) for _ in range(2)]
    if not torch.equal(copied, idx):
        raise AssertionError("phase 7: the copy probe did not copy")
    steps = 64
    sink = torch.empty(sms * 2048, device="cuda")
    l2 = {}
    for label, blocks, threads, smem in (
            ("all_sms", sms * 8, 256, 0),
            ("half_the_sms", sms // 2, 1024, 120 * 1024)):
        runs = [cuda_ms(lambda: run("l2", probe.probe_l2_random(
            plane.data_ptr(), plane.numel(), steps, blocks, threads, smem,
            sink.data_ptr(), stream)), 5) for _ in range(2)]
        l2[label] = {"runs_ms": runs, "G_sectors_per_s":
                     blocks * threads * steps * 8 / min(runs) / 1e6}
    size, words = PROBE_CLUSTER, PROBE_WORDS
    clusters = ctypes.c_int()
    run("cluster query", probe.probe_dsmem_clusters(size, words,
                                                   ctypes.byref(clusters)))
    c, dsteps = clusters.value, 32
    sink = torch.empty(c * size * 1024, device="cuda")

    def dsmem_ms(mode, split, dsm, l2_on):
        return min(cuda_ms(lambda: run("cluster", probe.probe_dsmem(
            plane.data_ptr(), plane.numel(), size, words, dsteps, mode,
            split, dsm, l2_on, c, sink.data_ptr(), stream)), 5)
            for _ in range(2))

    per_warp = c * size * 32 * dsteps * 8      # loads of one warp slot
    dsmem = {}
    for mode, label in ((0, "cluster_random"), (1, "own_cta_by_cluster_load"),
                        (2, "own_cta_by_shared_load")):
        ms = dsmem_ms(mode, 32, 1, 0)
        dsmem[label] = {"ms": ms, "G_loads_per_s": 32 * per_warp / ms / 1e6}
    alone_c = dsmem_ms(0, PROBE_SPLIT, 1, 0)
    alone_l = dsmem_ms(0, PROBE_SPLIT, 0, 1)
    both = dsmem_ms(0, PROBE_SPLIT, 1, 1)
    split = {"cluster_warps": PROBE_SPLIT, "cluster_alone_ms": alone_c,
             "l2_alone_ms": alone_l, "both_ms": both,
             "both_G_loads_per_s": 32 * per_warp / both / 1e6}
    out = {"copy_ms": min(copy_runs), "copy_runs_ms": copy_runs,
           "copy_GB_per_s": 2 * 4 * idx.numel() / min(copy_runs) / 1e6,
           "l2_random": l2,
           "l2_random_G_sectors_per_s": l2["all_sms"]["G_sectors_per_s"],
           "dsmem_clusters": c, "dsmem_bytes_per_cta": 4 * words,
           "dsmem": dsmem, "split": split}
    log(f"phase 7 probes (measured): coalesced copy of {4 * idx.numel()} B "
        f"in and out {out['copy_ms']:.4f} ms ({out['copy_GB_per_s']:.1f} "
        f"GB/s); random 4-B loads from the {4 * plane.numel()}-B plane "
        f"through L2: {l2['all_sms']['G_sectors_per_s']:.1f} G sectors/s "
        f"on {sms} SMs, {l2['half_the_sms']['G_sectors_per_s']:.1f} on "
        f"{sms // 2}; over {c} {size}-CTA clusters of {4 * words} B a CTA: "
        + ", ".join(f"{k} {v['G_loads_per_s']:.1f} G/s"
                    for k, v in dsmem.items())
        + f"; {PROBE_SPLIT} warps of 32 on cluster loads, the rest on L2: "
        f"alone {alone_c:.4f} / {alone_l:.4f} ms, at once {both:.4f} ms "
        f"({split['both_G_loads_per_s']:.1f} G loads/s in all)")
    return out


def phase7_gathers(mg, ff, dgen, probe, results):
    """K5 and K6 against their plain versions and the library calls at
    the shapes of tools/gather_experiments.py, bit for bit, timed in
    turns; the probes of the floors under them; then the gather path."""
    plane = torch.rand(N_MERL, generator=dgen, device="cuda")
    idx = torch.randint(0, N_MERL, (N_GATHER,), generator=dgen,
                        device="cuda", dtype=torch.int32)
    plane2d = mg.pad_plane(plane)
    row, lane = mg.row_lane(idx)
    out = {}
    nbytes = 8 * N_GATHER + 4 * N_MERL     # index + value per lookup, plane
    # the plane entries this run's indices touch, each read once
    touched = int(idx.unique().numel())
    probes = phase7_probes(probe, plane, idx)
    for name, length, kernel, plain, library, index_bytes in (
            ("gather_plane", N_MERL,
             lambda: mg.kernel_gather_plane(plane, idx),
             lambda: mg.plain_gather_plane(plane, idx),
             lambda: plane[idx], 4),
            ("gather_rowlane", plane2d.numel(),
             lambda: mg.kernel_gather_rowlane(plane2d, row, lane),
             lambda: mg.plain_gather_rowlane(plane2d, row, lane),
             lambda: plane2d[row, lane], 8)):
        want = plain()
        err = exact(name, kernel(), want)
        exact(f"{name} library call", library(), want)
        del want
        # CUDA events over whole calls, in turns (plain, kernel, kernel,
        # plain); then device time (torch.profiler: the kernels' own
        # durations, without the launch gaps events see at this size), in
        # the same turns, and the library call's: the kernels line's
        e_ms, _, event_runs, _ = timed_pair(kernel, plain, 20, 5)
        p_runs = [device_ms(plain, 5)]
        k_runs = [device_ms(kernel, 20), device_ms(kernel, 20)]
        p_runs.append(device_ms(plain, 5))
        lib_runs = [device_ms(library, 20) for _ in range(2)]
        k_ms, p_ms, lib_ms = min(k_runs), min(p_runs), min(lib_runs)
        b_ms, b_by = bound((index_bytes + 4) * N_GATHER + 4 * touched, 0)
        out[name] = {"max_abs_err": err, "kernel_ms": k_ms, "plain_ms": p_ms,
                     "kernel_runs_ms": k_runs, "plain_runs_ms": p_runs,
                     "events_runs_ms": event_runs,
                     "library_ms": lib_ms, "library_runs_ms": lib_runs,
                     "bound_ms": b_ms, "bound_by": b_by,
                     "lookups_per_s": N_GATHER / (k_ms * 1e-3),
                     "GB_per_s": nbytes / k_ms / 1e6}
        log(f"phase 7 {name} N={N_GATHER} into {length} entries (one "
            f"kernel path, through L2): bit for bit (max abs err {err}); "
            f"kernel {k_ms:.4f} ms device time "
            f"({N_GATHER / (k_ms * 1e-3):.4g} lookups/s; CUDA events over "
            f"20 calls {e_ms:.4f} ms); plain {p_ms:.4f} ms, one "
            f"PyTorch call {lib_ms:.4f} ms; coalesced-copy floor "
            f"{probes['copy_ms']:.4f} ms, random-sector floor "
            f"{N_GATHER / probes['l2_random_G_sectors_per_s'] / 1e6:.4f} ms; "
            f"bound {b_ms:.4f} ms (set by {b_by}, {touched} plane entries "
            f"touched), {b_ms / k_ms:.1%} of it")

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
    out["probes"] = probes
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

    def eval_fn(k):
        return lambda ii, oo: brdf.eval(
            GGX(), fresnel.Schlick(f0=f0s[k]),
            MicrofacetParams.isotropic(alphas[k]), ii, oo)

    t0 = time.perf_counter()
    tables = torch.empty((M_MERL, 3, 90, 90, 180), device="cuda")
    for k in range(M_MERL):
        tables[k] = bake_merl(eval_fn(k), device="cuda")  # cast to f32 here
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

    # the no-cast path: a float64 bake into merl_targets as it comes; the
    # table takes float32 where it enters, as the cast above made it
    raw64 = bake_merl(eval_fn(0), device="cuda")
    got = merl_targets(raw64[None], i, o)
    if not (raw64.dtype == torch.float64 and got.dtype == torch.float32
            and torch.equal(got, merl_targets(tables[:1], i, o))):
        raise AssertionError("phase 8: merl_targets of a float64 bake "
                             "differs from that of the table cast by hand")
    log(f"phase 8 merl_targets of a {raw64.dtype} bake, no cast: "
        f"{got.dtype} targets, equal bit for bit to those of the table "
        "cast to float32 by hand")
    del raw64, got

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
        proc, wall = run_module("dj_brdf_torch.cli.merl_params", "--device",
                                "cuda", "-o", out, *files)
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


# the kernels of index_select and of indexing (the row gathers)
GATHER_KERNELS = r"gather_kernel|indexSelect|index_elementwise_kernel"


def profile_frame(fn):
    """One call of ``fn`` under torch.profiler: kernels launched, device
    busy ms (their summed durations), the largest kernel by total time,
    the five largest, the ms of the row gathers (the kernels of
    ``index_select`` and of indexing), and device-to-host copies."""
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
    top = sorted(by_name, key=by_name.get, reverse=True)
    return {"kernels": len(kernels),
            "device_busy_ms": sum(by_name.values()) / 1e3,
            "largest_kernel": top[0][:80],
            "largest_kernel_ms": by_name[top[0]] / 1e3,
            "gather_ms": sum(us for name, us in by_name.items()
                             if re.search(GATHER_KERNELS, name)) / 1e3,
            "gather_launches": sum(bool(re.search(GATHER_KERNELS, e.name))
                                   for e in kernels),
            "top5": [(name[:70], by_name[name] / 1e3) for name in top[:5]],
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


def env_image(h, w):
    """bench.py's synthetic lat-long map (bench.py:512-515): |N(1, 0.5)|
    texels from ``default_rng(0)`` with a 60x brighter sun patch."""
    import numpy as np

    rng = np.random.default_rng(0)
    img = np.abs(rng.normal(1.0, 0.5, (h, w, 3))).astype(np.float32)
    img[h // 5:h // 5 + max(1, h // 10), w // 3:w // 3 + max(1, w // 12)] *= 60.0
    return img


def env_frames(label, frame, rays):
    """A warm-up, ``ENV_FRAMES`` timed frames and one profiled frame of
    ``frame`` (no grad); logs and returns their numbers. Fails for a
    frame that is not finite, lies off the card, is black or copied
    data to the host."""
    with torch.no_grad():
        img = frame()
        torch.cuda.synchronize()
        walls = []
        for _ in range(ENV_FRAMES):
            t0 = time.perf_counter()
            img = frame()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        prof = profile_frame(frame)
    ms = statistics.median(walls)
    finite = bool(torch.isfinite(img).all())
    share = prof["gather_ms"] / prof["device_busy_ms"]
    log(f"{label} res {ENV_RES} spp {ENV_SPP} {ENV_BOUNCES} bounces: median "
        f"frame {ms:.3f} ms over {ENV_FRAMES} ({[round(w, 3) for w in walls]}),"
        f" {rays / (ms * 1e-3):.4g} samples/s, {prof['kernels']} kernels per "
        f"frame, device busy {prof['device_busy_ms']:.3f} ms, row gathers "
        f"{prof['gather_ms']:.3f} ms in {prof['gather_launches']} launches "
        f"({share:.1%} of busy), largest "
        f"{prof['largest_kernel']} {prof['largest_kernel_ms']:.3f} ms, DtoH "
        f"copies {prof['dtoh_copies']}; mean {float(img.mean()):.5f}, finite "
        f"{finite}")
    if not (finite and img.device.type == "cuda" and prof["dtoh_copies"] == 0
            and float(img.mean()) > 0.05):
        raise AssertionError(f"{label}: the frame is not finite, not on the "
                             "card, black, or copied data to the host")
    return {"median_frame_ms": ms, "frames_ms": walls,
            "samples_per_s": rays / (ms * 1e-3), "profile": prof,
            "gather_share": share, "mean": float(img.mean())}


def card_vs_cpu(label, render_on, max_flips=PT_MAX_FLIPS):
    """``render_on(device, res, spp, u, u_env)`` at res 32, spp 4 on the
    card and on the CPU with the same uniforms: the pixels beyond phase
    13's tolerances must be at most ``max_flips`` of the image."""
    res, spp = 32, 4
    gen = torch.Generator().manual_seed(1)
    u = torch.rand((ENV_BOUNCES, res * res * spp, 2), generator=gen)
    u_env = torch.rand((ENV_BOUNCES, res * res * spp, 3), generator=gen)
    small = {device: render_on(device, res, spp, u.to(device),
                               u_env.to(device)).detach().cpu()
             for device in ("cuda", "cpu")}
    diff = (small["cuda"] - small["cpu"]).abs()
    flips = int((diff > PT_ATOL + PT_RTOL * small["cpu"].abs()).any(-1).sum())
    log(f"{label} res {res} spp {spp}: card vs CPU max abs err "
        f"{float(diff.max()):.3e}, {flips} of {res * res} pixels beyond rtol "
        f"{PT_RTOL} + atol {PT_ATOL} (allowed {int(max_flips * res * res)})")
    if flips > max_flips * res * res:
        raise AssertionError(f"{label}: the card's render disagrees with the "
                             "CPU path")
    return {"cpu_parity_max_abs_err": float(diff.max()),
            "cpu_parity_flips": flips}


def phase15_envmap(mg, ff, table0, results):
    """Environment-map MIS at bench.py's two map sizes: build time, frame
    numbers, card vs CPU, a backward through ``EnvMap.rebind``, and a
    measured material through the generic MIS loop."""
    from dj_brdf_torch.render import pathtrace
    from dj_brdf_torch.render.envmap import EnvMap
    from dj_brdf_torch.render.materials import MeasuredMaterial

    black = (0.0, 0.0, 0.0)
    rays = ENV_RES * ENV_RES * ENV_SPP
    out = {}
    for h, w in ENV_SIZES:
        img = env_image(h, w)
        t0 = time.perf_counter()
        em = EnvMap.build(img)             # host tables, then to the card
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        filt = "nearest" if em.packed.shape[-1] == 4 else "bilinear"
        log(f"phase 15 EnvMap.build {h}x{w} ({h * w} bins, {filt} rows): "
            f"{build_s:.4f} s on the host")
        sphere, floor_mat = pt_scene("beck", "cuda")
        gen = torch.Generator(device="cuda").manual_seed(0)

        def frame():
            return pathtrace.render(sphere, floor_mat, PT_LIGHT, black, black,
                                    res=ENV_RES, spp=ENV_SPP,
                                    max_bounces=ENV_BOUNCES, envmap=em,
                                    generator=gen)

        def render_on(device, res, spp, u, u_env):
            s_mat, f_mat = pt_scene("beck", device)
            return pathtrace.render(
                s_mat, f_mat, PT_LIGHT, black, black, res=res, spp=spp,
                max_bounces=ENV_BOUNCES, u=u, u_env=u_env,
                envmap=EnvMap.build(img, device=device))

        rec = env_frames(f"phase 15 envmap {h}x{w}", frame, rays)
        rec.update(card_vs_cpu(f"phase 15 envmap {h}x{w}", render_on))
        rec["build_s"] = build_s
        rec["filter"] = filt
        out[f"{h}x{w}"] = rec
        if (h, w) == ENV_SIZES[0]:
            em_small, img_small = em, img

    # a backward through rebind: d mean / d radiance, res 64
    rad = torch.tensor(img_small, device="cuda", requires_grad=True)
    sphere, floor_mat = pt_scene("beck", "cuda")
    t0 = time.perf_counter()
    pathtrace.render(sphere, floor_mat, PT_LIGHT, black, black, res=64,
                     spp=ENV_SPP, max_bounces=ENV_BOUNCES,
                     envmap=em_small.rebind(rad),
                     generator=torch.Generator(device="cuda").manual_seed(2)
                     ).mean().backward()
    torch.cuda.synchronize()
    bwd_s = time.perf_counter() - t0
    g = rad.grad
    log(f"phase 15 rebind backward res 64 spp {ENV_SPP}: d mean / d radiance "
        f"{tuple(g.shape)}, |grad| sum {float(g.abs().sum()):.5e}, max "
        f"{float(g.abs().max()):.5e}, {bwd_s:.3f} s (forward + backward)")
    if not (torch.isfinite(g).all() and g.abs().max() > 0):
        raise AssertionError("phase 15: the radiance gradient is not finite "
                             "or all zero")
    out["rebind_backward"] = {"grad_abs_sum": float(g.abs().sum()),
                              "grad_abs_max": float(g.abs().max()),
                              "wall_s": bwd_s}

    # phase 8's MERL table 0 under the 32x64 map: the generic MIS loop
    torch.cuda.synchronize()
    reset_counts(mg, ff)
    t0 = time.perf_counter()
    measured = MeasuredMaterial.from_merl(table0)
    _, floor_mat = pt_scene("ggx", "cuda")
    with torch.no_grad():
        img = pathtrace.render(measured, floor_mat, PT_LIGHT, black, black,
                               res=128, spp=4, max_bounces=ENV_BOUNCES,
                               envmap=em_small,
                               generator=torch.Generator(device="cuda")
                               .manual_seed(3))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    looked = mg.LAUNCHES["merl_lookup"]
    log(f"phase 15 MeasuredMaterial.from_merl (phase 8 table 0) under the "
        f"32x64 map through the generic MIS loop res 128 spp 4: {wall:.3f} s "
        f"with the proxy fit, lookups {looked}, mean {float(img.mean()):.5f}, "
        f"finite {bool(torch.isfinite(img).all())}")
    if not (torch.isfinite(img).all() and looked > 0
            and float(img.mean()) > 0):
        raise AssertionError("phase 15: the measured-material envmap render "
                             "is not finite, black, or never ran the lookup "
                             "kernel")
    out["measured"] = {"wall_s": wall, "lookups": looked,
                       "mean": float(img.mean())}
    results["envmap"] = out
    return looked


def matpreview_scene(device, amap, e1):
    """bench.py:555-567's matpreview materials: an alpha-textured GGX
    sphere over a LEAN-mapped Beckmann conductor with ray-cone mip
    selection, on ``device``, from the (512, 512) maps ``amap``, ``e1``."""
    from dj_brdf_torch import fresnel
    from dj_brdf_torch.lean.filtered import FilteredBeckmannMaterial
    from dj_brdf_torch.lean.lrep import Lrep
    from dj_brdf_torch.microfacet.ndf import GGX
    from dj_brdf_torch.microfacet.params import MicrofacetParams
    from dj_brdf_torch.render.materials import TexturedMicrofacetMaterial

    def vec(*x):
        return torch.tensor(x, dtype=torch.float32, device=device)

    sphere = TexturedMicrofacetMaterial(
        dist=GGX(), fres=fresnel.Schlick(f0=vec(0.9, 0.6, 0.3)), alpha1=amap,
        alpha2=amap, alpha_angle=vec(0.0)[0])
    floor = FilteredBeckmannMaterial(
        lean=Lrep(E1=e1, E2=e1 * 0.5, E3=e1 * e1 + 0.02,
                  E4=0.25 * e1 * e1 + 0.02, E5=0.5 * e1 * e1),
        base_params=MicrofacetParams.isotropic(vec(0.1)[0]),
        eta=vec(*GOLD_ETA), k=vec(*GOLD_K), mip_lod=True)
    return sphere, floor


def phase16_matpreview(results):
    """bench.py's matpreview frame: per-hit alpha-texture and LEAN-moment
    reads inside the envmap MIS loop, card vs CPU, and a backward w.r.t.
    the alpha map and the LEAN E1 map."""
    import numpy as np

    from dj_brdf_torch.render import pathtrace
    from dj_brdf_torch.render.envmap import EnvMap

    black = (0.0, 0.0, 0.0)
    rng = np.random.default_rng(0)        # bench.py:550-560's draw order
    img = np.abs(rng.normal(1.0, 0.5, (256, 512, 3))).astype(np.float32)
    img[50:60, 160:170] *= 60.0
    amap = rng.uniform(0.05, 0.6, (512, 512)).astype(np.float32)
    e1 = rng.normal(0, 0.15, (512, 512)).astype(np.float32)
    t0 = time.perf_counter()
    em = EnvMap.build(img)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    sphere, floor = matpreview_scene("cuda", torch.from_numpy(amap).cuda(),
                                     torch.from_numpy(e1).cuda())
    gen = torch.Generator(device="cuda").manual_seed(0)

    def frame():
        return pathtrace.render(sphere, floor, PT_LIGHT, black, black,
                                res=ENV_RES, spp=ENV_SPP,
                                max_bounces=ENV_BOUNCES, envmap=em,
                                generator=gen)

    def render_on(device, res, spp, u, u_env, envmap=True):
        s_mat, f_mat = matpreview_scene(device, torch.from_numpy(amap).to(
            device), torch.from_numpy(e1).to(device))
        if not envmap:
            return pathtrace.render(s_mat, f_mat, PT_LIGHT, PT_LIGHT_RAD,
                                    PT_SKY, res=res, spp=spp,
                                    max_bounces=ENV_BOUNCES, u=u)
        return pathtrace.render(s_mat, f_mat, PT_LIGHT, black, black, res=res,
                                spp=spp, max_bounces=ENV_BOUNCES, u=u,
                                u_env=u_env,
                                envmap=EnvMap.build(img, device=device))

    log(f"phase 16 matpreview: EnvMap.build 256x512 {build_s:.4f} s on the "
        "host; 512x512 alpha map, 512x512 LEAN moments with mip_lod, "
        "conductor eta/k")
    out = env_frames("phase 16 matpreview", frame, ENV_RES * ENV_RES * ENV_SPP)
    out.update(card_vs_cpu("phase 16 matpreview", render_on, ENV_MAX_FLIPS))
    # the textures, LEAN moments, mip levels and conductor Fresnel under
    # the delta light: phase 13's budget
    out["delta_light"] = card_vs_cpu(
        "phase 16 matpreview materials under the delta light",
        lambda *a: render_on(*a, envmap=False))
    out["build_s"] = build_s

    a = torch.from_numpy(amap).cuda().requires_grad_(True)
    e = torch.from_numpy(e1).cuda().requires_grad_(True)
    s_mat, f_mat = matpreview_scene("cuda", a, e)
    t0 = time.perf_counter()
    pathtrace.render(s_mat, f_mat, PT_LIGHT, black, black, res=64,
                     spp=ENV_SPP, max_bounces=ENV_BOUNCES, envmap=em,
                     generator=torch.Generator(device="cuda").manual_seed(2)
                     ).mean().backward()
    torch.cuda.synchronize()
    bwd_s = time.perf_counter() - t0
    grads = {"alpha": a.grad, "E1": e.grad}
    log("phase 16 backward res 64 spp "
        f"{ENV_SPP}: " + ", ".join(
            f"d mean / d {k} |grad| sum {float(g.abs().sum()):.5e} max "
            f"{float(g.abs().max()):.5e} on {int((g != 0).sum())} texels"
            for k, g in grads.items()) + f"; {bwd_s:.3f} s (forward + backward)")
    if not all(torch.isfinite(g).all() and g.abs().max() > 0
               for g in grads.values()):
        raise AssertionError("phase 16: a map gradient is not finite or all "
                             "zero")
    out["backward"] = {k: {"grad_abs_sum": float(g.abs().sum()),
                           "grad_abs_max": float(g.abs().max())}
                       for k, g in grads.items()}
    out["backward"]["wall_s"] = bwd_s
    results["matpreview"] = out


def within(name, got, want, rtol, atol=0.0, max_share=0.0):
    """``got`` (the card's) against ``want`` (the CPU path's): at most
    ``max_share`` of the entries beyond ``atol + rtol * |want|``; returns
    the max abs error and the share beyond."""
    got = got.detach().cpu().double()
    want = torch.as_tensor(want).detach().cpu().double()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} on the card, "
                             f"{tuple(want.shape)} on the CPU")
    diff = (got - want).abs()
    share = float((diff > atol + rtol * want.abs()).double().mean())
    err = float(diff.max()) if diff.numel() else 0.0
    if not torch.isfinite(got).all() or share > max_share:
        raise AssertionError(f"{name}: the card disagrees with the CPU path "
                             f"(max abs err {err:.3e}, {share:.3e} of the "
                             f"entries beyond rtol {rtol} + atol {atol:.3e})")
    return err, share


def utia_ggx_eval(device):
    """bench.py's analytic anisotropic GGX with Ideal Fresnel
    (bench.py:654-659), on ``device``."""
    from dj_brdf_torch import fresnel
    from dj_brdf_torch.microfacet import brdf
    from dj_brdf_torch.microfacet.ndf import GGX
    from dj_brdf_torch.microfacet.params import MicrofacetParams

    p = MicrofacetParams.elliptic(*(torch.tensor(x, device=device)
                                    for x in UTIA_PARAMS))

    def eval_fn(i, o):
        return brdf.eval(GGX(), fresnel.Ideal(), p, i, o)
    return eval_fn


def to_device(obj, device):
    """A frozen dataclass (distribution, Fresnel, parameters) with its
    tensor fields on ``device``."""
    import dataclasses

    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).to(device)
        for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor)})


def tables_within(label, card, cpu):
    """The eight tables of two ``TabularAnisotropic`` at the JAX tests'
    tolerance (rtol 1e-4, tests/test_render_fit_parallel.py:124-144); a
    qf entry comes from ``searchsorted`` on spline values, so an ulp may
    move it by one grid step 1/(8 cnt): exactly that is allowed, and
    counted. Returns the max relative error and the moved entries."""
    rel, moved = 0.0, 0
    for name in ("p22", "sigma", "pdf1", "cdf1", "pdf2", "cdf2"):
        a, b = getattr(card, name), getattr(cpu, name)
        err, _ = within(f"{label} {name}", a, b, 1e-4,
                        1e-4 * float(b.abs().max()))
        rel = max(rel, err / max(float(b.abs().max()), 1e-30))
    for name in ("qf1_table", "qf2_table"):
        a = getattr(card, name).detach().cpu().double()
        b = getattr(cpu, name).detach().double()
        step = 1.0 / (8 * (b.shape[-1] - 1))
        d = (a - b).abs()
        off = (d - step).abs() <= 1e-6
        if not bool(((d <= 1e-6) | off).all()):
            raise AssertionError(f"{label} {name}: the card disagrees with "
                                 f"the CPU path by more than one grid step "
                                 f"(max abs err {float(d.max()):.3e})")
        moved += int((off & (d > 1e-6)).sum())
    return rel, moved


def phase17_utia(mg, ff, dgen, results):
    """UTIA data and the anisotropic path at bench.py's sizes: bake, file
    and parsers, ``Utia.evalp`` and its row gather, ``nrm_utia``, the
    90x90 anisotropic tabulation and its moment fits, ``fit_lsq`` (K1)
    on UTIA targets and renders of ``utia_fit`` and ``utia_tab``.
    Returns K1's launches on its main path."""
    import numpy as np

    from dj_brdf_torch.fit import moments, tabular_aniso
    from dj_brdf_torch.fit.batch import sample_direction_set
    from dj_brdf_torch.fit.lsq import fit_lsq
    from dj_brdf_torch.io.synth import bake_utia
    from dj_brdf_torch.io.utia_io import load_utia, save_utia
    from dj_brdf_torch.microfacet.ndf import GGX, Beckmann
    from dj_brdf_torch.microfacet.params import MicrofacetParams
    from dj_brdf_torch.models import utia as utia_mod
    from dj_brdf_torch.models.lambert import Lambert
    from dj_brdf_torch.render import pathtrace
    from dj_brdf_torch.render.materials import MicrofacetMaterial

    out = {}
    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    # -- bake on the card, write, read through both parsers
    eval_fn = utia_ggx_eval("cuda")
    t0 = time.perf_counter()
    raw = bake_utia(eval_fn)
    torch.cuda.synchronize()
    bake_s = time.perf_counter() - t0
    bake_err, _ = within("phase 17 bake_utia", raw, bake_utia(
        utia_ggx_eval("cpu"), device="cpu"), 1e-4, 1e-6 * float(raw.max()))
    path = os.path.join(tmp.name, "ggx.bin")
    save_utia(path, raw)
    t0 = time.perf_counter()
    native = load_utia(path)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = load_utia(path, use_native=False)
    numpy_s = time.perf_counter() - t0
    if not np.allclose(native, plain, rtol=1e-6, atol=0.0):
        raise AssertionError("phase 17: the native UTIA parser disagrees "
                             "with numpy beyond rtol 1e-6")
    table = torch.from_numpy(native).cuda()
    log(f"phase 17 bake_utia GGX elliptic{UTIA_PARAMS} on the card: "
        f"{bake_s:.4f} s, max abs err vs the CPU bake {bake_err:.3e}; "
        f"load_utia native {native_s:.4f} s, numpy {numpy_s:.4f} s, max "
        f"abs diff {float(np.abs(native - plain).max()):.3e}")
    out["bake"] = {"s": bake_s, "max_abs_err_vs_cpu": bake_err,
                   "load_native_s": native_s, "load_numpy_s": numpy_s}

    # -- Utia.build and evalp at N = 2^23, its row gather
    t0 = time.perf_counter()
    u = utia_mod.Utia.build(table)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    i, o = sample_direction_set(N_UTIA, dgen, "cuda")
    with torch.no_grad():
        vals = u.evalp(i, o)
        ms = min(cuda_ms(lambda: u.evalp(i, o), 5) for _ in range(2))
        prof = profile_frame(lambda: u.evalp(i, o))
        row, _, _ = utia_mod.corner_taps(i, o)
        packed = u.packed
        lane = torch.arange(packed.shape[1], device="cuda")
        forms = {"index_select": lambda: packed.index_select(0, row),
                 "indexing": lambda: packed[row],
                 "take": lambda: torch.take(packed, row[:, None]
                                            * packed.shape[1] + lane),
                 "gather_rows (in use)": lambda: utia_mod.gather_rows(
                     packed, row)}
        want = forms["indexing"]()
        for name, fn in forms.items():
            exact(f"phase 17 gather {name}", fn(), want)
        del want
        gather_ms = {name: [] for name in forms}
        for name in [*forms, *reversed(forms)]:      # in turns
            gather_ms[name].append(cuda_ms(forms[name], 5))
        del row
    cpu_err, cpu_share = within(
        "phase 17 Utia.evalp", vals[:N_SLICE],
        utia_mod.Utia.build(table.cpu()).evalp(i[:N_SLICE].cpu(),
                                               o[:N_SLICE].cpu()),
        1e-4, 1e-6 * float(vals.abs().max()), EVAL_MAX_FLIPS)
    nbytes = 36 * N_UTIA + packed.numel() * packed.element_size()
    b_ms, _ = bound(nbytes, 0)
    fastest = min(gather_ms, key=lambda k: min(gather_ms[k]))
    log(f"phase 17 Utia.build {build_s:.4f} s; evalp N={N_UTIA}: {ms:.3f} "
        f"ms, {N_UTIA / (ms * 1e-3):.4g} evals/s, byte bound {b_ms:.4f} ms "
        f"({nbytes / 1e6:.1f} MB), {b_ms / ms:.2%} of it; {prof['kernels']} "
        f"kernels, device busy {prof['device_busy_ms']:.3f} ms, largest "
        f"{prof['largest_kernel']} {prof['largest_kernel_ms']:.3f} ms; vs "
        f"CPU on {N_SLICE}: max abs err {cpu_err:.3e}, {cpu_share:.2e} "
        f"beyond; row gather of (N, 48) in turns (ms): "
        f"{ {k: [round(x, 4) for x in v] for k, v in gather_ms.items()} }, "
        f"fastest {fastest}, bit for bit")
    out["evalp"] = {"ms": ms, "evals_per_s": N_UTIA / (ms * 1e-3),
                    "bound_ms": b_ms, "profile": prof,
                    "cpu_max_abs_err": cpu_err, "cpu_share_beyond": cpu_share,
                    "gather_ms": gather_ms, "gather_fastest": fastest}
    del vals, i, o

    # -- nrm_utia on the card in a subprocess, default grid
    bakes = {"ggx.bin": raw}
    for name, albedo in (("lambert-0.7.bin", 0.7), ("lambert-3.0.bin", 3.0)):
        bakes[name] = bake_utia(Lambert(reflectance=torch.full(
            (3,), albedo, device="cuda")).eval)
    for name, t in bakes.items():
        save_utia(os.path.join(tmp.name, name), t)

    def nrm_utia(*names):
        proc, wall = run_module(
            "dj_brdf_torch.cli.nrm_utia", "--device", "cuda",
            *(os.path.join(tmp.name, n) for n in names))
        verdicts = re.findall(r"=> (ok|FAILURE) \(max integral ([0-9.]+)\)",
                              proc.stdout)
        if proc.returncode not in (0, 1) or len(verdicts) != len(names):
            raise AssertionError(f"phase 17: nrm_utia exited "
                                 f"{proc.returncode}:\n{proc.stdout}\n"
                                 f"{proc.stderr}")
        return proc.returncode, wall, {n: (v, float(x)) for n, (v, x)
                                       in zip(names, verdicts)}

    rc, wall, verdicts = nrm_utia("ggx.bin", "lambert-0.7.bin")
    rc_hot, wall_hot, hot = nrm_utia("lambert-3.0.bin")
    log(f"phase 17 nrm_utia --device cuda (64x256 outgoing x 64x256 "
        f"incoming, 268M evals a file): GGX bake and 0.7 Lambert bake exit "
        f"{rc} in {wall:.2f} s {verdicts}; 3.0 Lambert bake exit {rc_hot} "
        f"in {wall_hot:.2f} s {hot}")
    if (verdicts["lambert-0.7.bin"][0] != "ok" or rc_hot != 1
            or rc != (0 if verdicts["ggx.bin"][0] == "ok" else 1)):
        raise AssertionError("phase 17: nrm_utia's verdicts are wrong")
    out["nrm_utia"] = {"exit": rc, "wall_s": wall, "verdicts": verdicts,
                       "hot_exit": rc_hot, "hot_wall_s": wall_hot}
    tmp.cleanup()

    # -- the 90x90 anisotropic tabulation on the card
    def build(model, device="cuda"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist, fres = tabular_aniso.build_tabular_anisotropic(
            model, RES_ANISO, RES_ANISO, device=device)
        float(dist.p22.sum())                  # as bench.py:664 syncs
        return dist, fres, time.perf_counter() - t0

    torch.cuda.synchronize()
    before_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    build(eval_fn)                             # warm
    runs = [build(eval_fn) for _ in range(2)]
    peak_gb = (torch.cuda.max_memory_allocated() - before_bytes) / 1e9
    dist_a, fres_a, _ = runs[0]
    wall_a = min(r[2] for r in runs)
    dist_u, fres_u, wall_u = build(u)
    t0 = time.perf_counter()
    cpu_a, cfres_a, _ = build(utia_ggx_eval("cpu"), "cpu")
    cpu_u, cfres_u, _ = build(utia_mod.Utia.build(table.cpu()))
    cpu_s = time.perf_counter() - t0
    rel_a, moved_a = tables_within("phase 17 analytic 90x90", dist_a, cpu_a)
    rel_u, moved_u = tables_within("phase 17 UTIA 90x90", dist_u, cpu_u)
    for label, f, cf in (("analytic", fres_a, cfres_a),
                         ("UTIA", fres_u, cfres_u)):
        within(f"phase 17 {label} Fresnel points", f.points, cf.points, 1e-4,
               1e-5)
    n = (RES_ANISO - 1) * RES_ANISO
    a_mat = torch.rand((n, n), generator=dgen, device="cuda")
    v = torch.ones(n, device="cuda")

    def four():
        w = v
        for _ in range(4):
            w = a_mat @ w
        return w

    four()
    mv_ms = min(cuda_ms(four, 25) for _ in range(2)) / 4
    mv_bound, _ = bound(4 * n * n + 8 * n, 2 * n * n)
    del a_mat
    log(f"phase 17 build_tabular_anisotropic {RES_ANISO}x{RES_ANISO} (n = "
        f"{n}, device f32 power stage): analytic GGX "
        f"aniso_fit90_wall_seconds {wall_a:.4f} (best of 2 after a warm "
        f"run: {[round(r[2], 4) for r in runs]}), UTIA {wall_u:.4f} s; peak "
        f"{peak_gb:.3f} GB above the {before_bytes / 1e9:.3f} GB held "
        f"before (max_memory_allocated {torch.cuda.max_memory_allocated() / 1e9:.3f}"
        f" GB); vs the CPU path ({cpu_s:.2f} s for both): max rel err "
        f"{rel_a:.3e} / {rel_u:.3e}, qf entries one grid step off "
        f"{moved_a} / {moved_u} of {2 * RES_ANISO * RES_ANISO}; "
        f"power_iteration_matvecs_per_s_n8010 {1e3 / mv_ms:.4g} "
        f"({mv_ms:.4f} ms a matvec, byte bound {mv_bound:.4f} ms, "
        f"{mv_bound / mv_ms:.1%} of it)")
    out["aniso"] = {"aniso_fit90_wall_seconds": wall_a,
                    "walls_s": [r[2] for r in runs], "utia_wall_s": wall_u,
                    "peak_gb_above": peak_gb,
                    "max_memory_allocated_gb":
                        torch.cuda.max_memory_allocated() / 1e9,
                    "max_rel_err_vs_cpu": [rel_a, rel_u],
                    "qf_moved": [moved_a, moved_u], "cpu_s": cpu_s,
                    "matvecs_per_s": 1e3 / mv_ms, "matvec_ms": mv_ms,
                    "matvec_bound_ms": mv_bound}

    # -- the anisotropic moment fits, card against the CPU path
    fits = {}
    for label, card, cpu in (("analytic", dist_a, cpu_a),
                             ("UTIA", dist_u, cpu_u)):
        for fit in (moments.fit_beckmann_parameters_anisotropic,
                    moments.fit_ggx_parameters_anisotropic):
            got, want = fit(card), fit(cpu)
            vals = {}
            for f in ("ax", "ay", "rho", "txn", "tyn"):
                within(f"phase 17 {label} {fit.__name__} {f}",
                       torch.as_tensor(getattr(got, f)),
                       torch.as_tensor(getattr(want, f)), 1e-4, 1e-6)
                vals[f] = float(getattr(got, f))
            fits[f"{label} {fit.__name__}"] = vals
    log(f"phase 17 moment fits on the card, within rtol 1e-4 of the CPU "
        f"path: { {k: {f: round(x, 5) for f, x in v.items()} for k, v in fits.items()} }")
    out["moments"] = fits

    # -- fit_lsq (K1) on UTIA targets
    i2, o2 = sample_direction_set(N_UTIA_FIT, dgen, "cuda")
    with torch.no_grad():
        target = u.evalp(i2, o2)
    torch.cuda.synchronize()
    reset_counts(mg, ff)
    with StepTimer() as timer:
        t0 = time.perf_counter()
        params, fres, losses = fit_lsq(GGX(), i2, o2, target,
                                       steps=UTIA_FIT_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launched = ff.LAUNCHES
    step_ms = timer.median_ms()
    sl = slice(0, N_SLICE)
    _, _, card_losses = fit_lsq(GGX(), i2[sl], o2[sl], target[sl], steps=50)
    _, _, cpu_losses = fit_lsq(GGX(), i2[sl].cpu(), o2[sl].cpu(),
                               target[sl].cpu(), steps=50)
    traj_err, _ = within("phase 17 fit_lsq trajectory", card_losses,
                         cpu_losses, 1e-4, 1e-7)
    log(f"phase 17 fit_lsq GGX on Utia.evalp targets N={N_UTIA_FIT} "
        f"{UTIA_FIT_STEPS} steps: {wall:.2f} s, median step {step_ms:.3f} "
        f"ms, launches {launched}, loss {float(losses[0]):.4e} -> "
        f"{float(losses[-1]):.4e}, ax {float(params.ax):.4f} ay "
        f"{float(params.ay):.4f} rho {float(params.rho):.4f}; card vs CPU "
        f"at N={N_SLICE} over 50 steps: max abs loss err {traj_err:.3e}")
    if launched != UTIA_FIT_STEPS:
        raise AssertionError(f"phase 17: {launched} kernel launches for "
                             f"{UTIA_FIT_STEPS} fit_lsq steps")
    if not (torch.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError("phase 17: the fit on UTIA targets did not "
                             "lower its loss")
    out["fit_lsq"] = {"wall_s": wall, "median_step_ms": step_ms,
                      "launches": launched, "first_loss": float(losses[0]),
                      "last_loss": float(losses[-1]),
                      "cpu_traj_max_abs_err": traj_err}
    del i2, o2, target

    # -- renders of utia_fit's and utia_tab's materials
    p_fit = moments.fit_beckmann_parameters_anisotropic(dist_u)
    materials = {
        "utia_fit": lambda dev: MicrofacetMaterial(
            Beckmann(), to_device(fres_u, dev), to_device(p_fit, dev)),
        "utia_tab": lambda dev: MicrofacetMaterial(
            dist=to_device(dist_u, dev), fres=to_device(fres_u, dev),
            params=to_device(MicrofacetParams.standard(), dev))}
    out["render"] = {}
    for label, make in materials.items():
        sphere, floor_mat = make("cuda"), pt_scene("ggx", "cuda")[1]
        gen = torch.Generator(device="cuda").manual_seed(0)

        def frame():
            return pathtrace.render(sphere, floor_mat, PT_LIGHT, PT_LIGHT_RAD,
                                    PT_SKY, res=UTIA_RES, spp=UTIA_SPP,
                                    max_bounces=PT_BOUNCES, generator=gen)

        with torch.no_grad():
            img = frame()
            walls = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                img = frame()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            prof = profile_frame(frame)
        ms = statistics.median(walls)
        res, spp = 32, 4
        u_small = torch.rand((PT_BOUNCES, res * res * spp, 2),
                             generator=torch.Generator().manual_seed(1))
        small = {dev: pathtrace.render(
            make(dev), pt_scene("ggx", dev)[1], PT_LIGHT, PT_LIGHT_RAD,
            PT_SKY, res=res, spp=spp, max_bounces=PT_BOUNCES,
            u=u_small.to(dev)).cpu() for dev in ("cuda", "cpu")}
        diff = (small["cuda"] - small["cpu"]).abs()
        flips = int((diff > PT_ATOL + PT_RTOL * small["cpu"].abs()).any(-1)
                    .sum())
        finite = bool(torch.isfinite(img).all())
        log(f"phase 17 render {label} sphere / GGX floor res {UTIA_RES} spp "
            f"{UTIA_SPP} {PT_BOUNCES} bounces (generic loop): median frame "
            f"{ms:.3f} ms of 3 ({[round(w, 3) for w in walls]}), "
            f"{UTIA_RES * UTIA_RES * UTIA_SPP / (ms * 1e-3):.4g} samples/s, "
            f"{prof['kernels']} kernels, device busy "
            f"{prof['device_busy_ms']:.3f} ms, largest {prof['largest_kernel']}"
            f" {prof['largest_kernel_ms']:.3f} ms; mean {float(img.mean()):.5f}"
            f", finite {finite}; card vs CPU res {res} spp {spp}: max abs err "
            f"{float(diff.max()):.3e}, {flips} of {res * res} pixels beyond "
            f"tolerance (allowed {int(PT_MAX_FLIPS * res * res)})")
        if not (finite and float(img.mean()) > 0.0
                and flips <= PT_MAX_FLIPS * res * res):
            raise AssertionError(f"phase 17 {label}: the frame is not finite "
                                 "or disagrees with the CPU path")
        out["render"][label] = {"median_frame_ms": ms, "frames_ms": walls,
                                "profile": prof, "mean": float(img.mean()),
                                "cpu_parity_flips": flips,
                                "cpu_parity_max_abs_err": float(diff.max())}
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase 17 wall {out['wall_s']:.1f} s")
    results["utia"] = out
    return launched


def stack_evalp(model, i, o, count=None, chunk=8):
    """(M, N, 3) ``evalp`` of the first ``count`` (default: every)
    materials of a stacked SGD or ABC model at the shared directions, a
    few materials at a time, as ``targets_for`` chunks."""
    import dataclasses

    leaves = {f.name: getattr(model, f.name)
              for f in dataclasses.fields(model)}
    m = count or next(iter(leaves.values())).shape[0]
    out = torch.empty((m, i.shape[0], 3), device=i.device)
    for k in range(0, m, chunk):
        part = type(model)(**{name: x[k:min(k + chunk, m), None]
                              for name, x in leaves.items()})
        out[k:k + chunk] = part.evalp(i, o)
    return out


def phase18_sgd_abc_native(mg, ff, i, o, results):
    """SGD and ABC at MERL scale, ``fit_materials`` (K3) on the SGD
    targets, and the native ``djbio`` parsers and map builders against
    the numpy and torch versions. Returns K3's launches on its main
    path."""
    import numpy as np

    from dj_brdf_torch.fit.batch import fit_materials
    from dj_brdf_torch.io import hdr, native
    from dj_brdf_torch.io.merl_io import load_merl, save_merl
    from dj_brdf_torch.io.utia_io import load_utia, save_utia
    from dj_brdf_torch.lean import maps
    from dj_brdf_torch.models.abc_model import ABC
    from dj_brdf_torch.models.sgd import SGD

    out = {}
    t_phase = time.perf_counter()
    n = i.shape[0]
    targets = {}
    for name, model in (("SGD", SGD), ("ABC", ABC)):
        stacked = model.all_materials()
        with torch.no_grad():
            t = stack_evalp(stacked, i, o)
            ms = cuda_ms(lambda: stack_evalp(stacked, i, o), 3)
        m = t.shape[0]
        err, share = within(
            f"phase 18 {name}.evalp", t[:4],
            stack_evalp(model.all_materials(device="cpu"), i.cpu(), o.cpu(),
                        count=4), 1e-4, 1e-6 * float(t[:4].abs().max()),
            EVAL_MAX_FLIPS)
        log(f"phase 18 {name}.all_materials().evalp at {m} x {n}: {ms:.3f} "
            f"ms, {m * n / (ms * 1e-3):.4g} evals/s, finite "
            f"{bool(torch.isfinite(t).all())}; vs CPU on 4 materials max abs "
            f"err {err:.3e}, {share:.2e} beyond")
        if not torch.isfinite(t).all():
            raise AssertionError(f"phase 18: {name} evaluations not finite")
        out[name] = {"ms": ms, "evals_per_s": m * n / (ms * 1e-3),
                     "cpu_max_abs_err": err, "cpu_share_beyond": share}
        targets[name] = t
    del targets["ABC"]

    # -- fit_materials (K3) on the 100 SGD targets
    sgd_t = targets.pop("SGD")
    _, _, first = fit_materials(sgd_t, i, o, steps=1)
    torch.cuda.synchronize()
    reset_counts(mg, ff)
    with StepTimer() as timer:
        t0 = time.perf_counter()
        params, fres, losses = fit_materials(sgd_t, i, o, steps=SGD_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launched = ff.LAUNCHES
    step_ms = timer.median_ms()
    fell = int((losses < first).sum())
    log(f"phase 18 fit_materials GGX on the {sgd_t.shape[0]} SGD targets x "
        f"{n} {SGD_STEPS} steps: {wall:.2f} s, median step {step_ms:.3f} ms, "
        f"launches {launched}, losses fell for {fell} of {losses.numel()} "
        f"(median {float(first.median()):.4e} -> "
        f"{float(losses.median()):.4e}, max {float(losses.max()):.4e})")
    if launched != SGD_STEPS:
        raise AssertionError(f"phase 18: {launched} kernel launches for "
                             f"{SGD_STEPS} fit_materials steps")
    if not (torch.isfinite(losses).all() and fell == losses.numel()):
        raise AssertionError("phase 18: a material's loss is not finite or "
                             "did not fall")
    out["fit_materials"] = {"wall_s": wall, "median_step_ms": step_ms,
                            "launches": launched,
                            "median_first_loss": float(first.median()),
                            "median_last_loss": float(losses.median()),
                            "max_last_loss": float(losses.max())}
    del sgd_t

    # -- the native djbio library against numpy and torch
    rng = np.random.default_rng(0)
    checks, secs = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        def timed(key, fn):
            t0 = time.perf_counter()
            value = fn()
            secs[key] = time.perf_counter() - t0
            return value

        p = os.path.join(tmp, "m.binary")
        save_merl(p, rng.uniform(0, 2, (3, 90, 90, 180)))
        a = timed("merl_native", lambda: load_merl(p))
        b = timed("merl_numpy", lambda: load_merl(p, use_native=False))
        checks["merl"] = bool(np.array_equal(a, b))
        p = os.path.join(tmp, "u.bin")
        save_utia(p, rng.uniform(-0.5, 3, (3, 6, 48, 6, 48)))
        a, b = load_utia(p), load_utia(p, use_native=False)
        checks["utia"] = bool(np.allclose(a, b, rtol=1e-6, atol=0.0)
                              and a.min() >= 0.0)
        img = (rng.uniform(0, 1, (256, 512, 3)) ** 2 * 30).astype(np.float32)
        p = os.path.join(tmp, "probe.hdr")
        hdr.write_hdr(p, img)
        a = timed("hdr_native", lambda: native.load_hdr(p))
        b = timed("hdr_numpy", lambda: hdr.load_hdr(p))
        checks["hdr"] = bool(np.array_equal(a, b))
    dmap = rng.uniform(0, 1, (512, 512)).astype(np.float32)
    for clamp in (False, True):
        a = native.dmap_to_nmap(dmap, 0.05, clamp)
        b = maps.dmap_to_nmap(torch.from_numpy(dmap).cuda(), 0.05, clamp)
        checks[f"dmap_to_nmap clamp={clamp}"] = bool(np.allclose(
            a, b.cpu().numpy(), rtol=0.0, atol=1e-6))
    nmap = native.dmap_to_nmap(dmap, 0.1)
    lean = native.nmap_to_lean(nmap, 0.05, 25.0)
    want = maps.nmap_to_lean(torch.from_numpy(nmap).cuda(), 0.05, 25.0)
    planes = (want.E1, want.E2, want.E3, want.E4, want.E5)
    checks["nmap_to_lean"] = all(np.allclose(
        lean[k], x.cpu().numpy(), rtol=1e-5, atol=1e-5)
        for k, x in enumerate(planes))
    red = native.lean_mip_reduce(lean)
    want = maps.mip_reduce(want)
    checks["lean_mip_reduce"] = all(np.allclose(
        red[k], x.cpu().numpy(), rtol=1e-5, atol=1e-5)
        for k, x in enumerate((want.E1, want.E2, want.E3, want.E4, want.E5)))
    log(f"phase 18 native djbio against numpy and torch on the card: "
        f"{checks}; host seconds { {k: round(v, 4) for k, v in secs.items()} }")
    if not all(checks.values()):
        raise AssertionError("phase 18: the native library disagrees with "
                             "the numpy or torch version")
    out["native"] = {"checks": checks, "host_s": secs}
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase 18 wall {out['wall_s']:.1f} s")
    results["sgd_abc_native"] = out
    return launched


def phase19_lookup_backward(mg, tables, i, o, results):
    """The MERL lookup's backward on the card (``MerlLookupGrad``: the
    kernel forward, a scatter-add of torch ops backward) at M = 100 x
    N = 1,458,000 against the CPU path's autograd. Returns the lookup's
    launches on the path."""
    from dj_brdf_torch.models import merl as merl_mod

    scales = merl_mod.SCALES
    flat = tables.reshape(M_MERL, 3, -1)
    idx = merl_mod.merl_flat_index(i, o).reshape(-1).contiguous()
    iz = i[:, 2].contiguous()
    g = torch.rand((M_MERL, N_MERL, 3), device="cuda",
                   generator=torch.Generator(device="cuda").manual_seed(19))

    # the main path: merl_lookup of tables and iz that require grad
    torch.cuda.synchronize()
    mg.LAUNCHES["merl_lookup"] = 0
    t = flat.detach().clone().requires_grad_(True)
    z = iz.detach().clone().requires_grad_(True)
    t0 = time.perf_counter()
    out = mg.merl_lookup(t, idx, scales, z)
    out.backward(g)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    looked = mg.LAUNCHES["merl_lookup"]
    if looked != 2:
        raise AssertionError(f"phase 19: {looked} lookup launches for a "
                             "forward and a backward (want 2: the forward "
                             "and the backward's rgb)")

    # the CPU path's autograd, ten materials at a time
    idx_c, iz_c = idx.cpu(), iz.detach().cpu().requires_grad_(True)
    grad_t = torch.empty(flat.shape)
    for a in range(0, M_MERL, 10):
        tc = flat[a:a + 10].cpu().requires_grad_(True)
        mg.plain_merl_lookup(tc, idx_c, scales, iz_c).backward(
            g[a:a + 10].cpu())
        grad_t[a:a + 10] = tc.grad
    # atomics add the f32 terms in another order than the CPU's loop
    err_t, _ = within("phase 19 grad w.r.t. the tables", t.grad, grad_t,
                      1e-5, 1e-12)
    err_z, _ = within("phase 19 grad w.r.t. iz", z.grad, iz_c.grad, 1e-5,
                      1e-12)
    nonzero = float((grad_t != 0).double().mean())

    def backward():
        return mg.lookup_backward(flat, idx, scales, iz, g,
                                  mg.kernel_merl_lookup)

    def tables_only():
        return mg.lookup_backward(flat, idx, scales, iz, g,
                                  mg.kernel_merl_lookup, need_iz=False)

    backward()
    ms = min(cuda_ms(backward, 5) for _ in range(2))
    ms_tables = min(cuda_ms(tables_only, 5) for _ in range(2))
    # inputs read once (the output gradient, indices, cosines, tables for
    # the horizon mask), outputs written once (both gradients)
    nbytes = (12 * M_MERL * N_MERL + 12 * N_MERL
              + 24 * M_MERL * flat.shape[-1])
    # per (material, sample, channel): g * iz * scale, the scatter's add,
    # and the iz gradient's multiply-add
    b_ms, b_by = bound(nbytes, 5 * 3 * M_MERL * N_MERL)
    log(f"phase 19 merl_lookup backward M={M_MERL} N={N_MERL}: forward + "
        f"backward {wall:.3f} s (first call), {looked} lookup launches; "
        f"card vs CPU autograd: tables max abs err {err_t:.3e} "
        f"({nonzero:.4f} of the cells have a gradient), iz {err_z:.3e}; "
        f"backward {ms:.3f} ms (tables only {ms_tables:.3f} ms, iz part "
        f"with its rgb lookup {ms - ms_tables:.3f} ms), "
        f"{nbytes / 1e9:.3f} GB moved at least, bound {b_ms:.4f} ms (set by "
        f"{b_by}), {b_ms / ms:.1%} of it")
    results["lookup_backward"] = {
        "wall_s": wall, "launches": looked, "max_abs_err_tables": err_t,
        "max_abs_err_iz": err_z, "cells_with_grad": nonzero, "ms": ms,
        "tables_only_ms": ms_tables, "bytes": nbytes, "bound_ms": b_ms,
        "bound_by": b_by}
    del g, out, t, z, grad_t
    return looked


def collective_ms(mesh, x, op):
    """CUDA-event ms of one all-gather or all-reduce of ``x``."""
    import torch.distributed as dist

    def gather():
        mesh.all_gather(x)

    def reduce():
        dist.all_reduce(x.clone())
    fn = gather if op == "all_gather" else reduce
    fn()
    return min(cuda_ms(fn, 20) for _ in range(2))


def timed_call(fn):
    """``(result, wall seconds)`` of ``fn()`` ending in a synchronise;
    in a process group of more than one rank every rank starts together
    (a barrier)."""
    import torch.distributed as dist

    torch.cuda.synchronize()
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier(device_ids=[torch.cuda.current_device()])
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def turns(mg, ff, unsharded, sharded):
    """Both calls in turns (unsharded, sharded, sharded, unsharded), so
    that neither pays a first call's costs alone. Returns the results of
    the last call of each, the shorter wall of each, and the launch
    counts of the first sharded call (set to 0 just before it): the
    fused fit's and the lookup's."""
    _, a = timed_call(unsharded)
    reset_counts(mg, ff)
    _, b = timed_call(sharded)
    counts = (ff.LAUNCHES, mg.LAUNCHES["merl_lookup"])
    got, c = timed_call(sharded)
    want, d = timed_call(unsharded)
    return want, got, min(b, c), min(a, d), counts


def identical(name, got, want):
    """Every tensor of two pytrees equal bit for bit."""
    from dj_brdf_torch.core.pytree import tree_leaves

    a, b = tree_leaves(got), tree_leaves(want)
    if len(a) != len(b) or not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError(f"{name}: the sharded call differs from the "
                             "unsharded one")


def mesh_checks(mg, ff, mesh, alphas, f0s, i, o, i1, o1, table0, tmpdir,
                say=log):
    """Phase 20's sharded calls over ``mesh`` (NCCL, any world size),
    each against its unsharded call on this rank's card, in turns:
    ``fit_materials`` on phase 3's materials (bit for bit, K3 once a
    step), ``fit_lsq`` on phase 5's problem (rtol 1e-6, atol 1e-7, K1
    once a step), the 90x90 anisotropic builder against the device power stage
    (phase 17's tolerance), ``furnace_test`` at 64x256 on a UTIA bake
    (equal), a MERL frame at res 512 (the lookup) and an envmap frame
    (bit for bit), a backward through the sharded MERL frame (rtol
    1e-5), ``dryrun_multichip``, and the collectives' ms. Raises on any
    mismatch. Returns the results, the launches of K3 and K1 (GGX) and
    of the lookup on the sharded paths, the fitted state, the table,
    the furnace verdict and the UTIA file it wrote into ``tmpdir``."""
    import dataclasses

    from dj_brdf_torch.core.pytree import tree_leaves
    from dj_brdf_torch.entry import dryrun_multichip
    from dj_brdf_torch.fit import tabular_aniso
    from dj_brdf_torch.fit.batch import fit_materials
    from dj_brdf_torch.fit.lsq import fit_lsq
    from dj_brdf_torch.io.synth import bake_utia
    from dj_brdf_torch.io.utia_io import load_utia, save_utia
    from dj_brdf_torch.microfacet.ndf import GGX
    from dj_brdf_torch.models import utia as utia_mod
    from dj_brdf_torch.parallel import integrals
    from dj_brdf_torch.render import pathtrace
    from dj_brdf_torch.render.envmap import EnvMap
    from dj_brdf_torch.render.materials import MeasuredMaterial

    dev = mesh.device
    out, launches, walls = {}, {"ggx": 0, "merl_lookup": 0}, {}
    coll = {
        "all_reduce_9_floats": collective_ms(mesh, torch.ones(
            9, device=dev), "all_reduce"),
        "all_gather_100x3": collective_ms(mesh, torch.ones(
            (M_MERL, 3), device=dev), "all_gather"),
        "all_gather_n8010": collective_ms(mesh, torch.ones(
            8010, device=dev), "all_gather"),
        "all_gather_pixels_512x512x3": collective_ms(mesh, torch.ones(
            (PT_RES * PT_RES, 3), device=dev), "all_gather")}
    say(f"phase 20 collectives at world {mesh.size} (ms) "
        f"{ {k: round(v, 4) for k, v in coll.items()} }")
    out["collectives_ms"] = coll

    def pair(name, unsharded, sharded):
        want, got, walls[name], walls[name + "_unsharded"], counts = turns(
            mg, ff, unsharded, sharded)
        return want, got, counts

    # fit_materials: phase 3's targets, 100 steps, bit for bit
    targets = targets_for(GGX(), alphas, f0s, i, o)
    want, got, (k3, _) = pair(
        "fit_materials", lambda: fit_materials(targets, i, o,
                                               steps=MESH_STEPS),
        lambda: fit_materials(targets, i, o, steps=MESH_STEPS, mesh=mesh))
    identical("phase 20 fit_materials", got, want)
    if k3 != MESH_STEPS:
        raise AssertionError(f"phase 20: {k3} K3 launches for {MESH_STEPS} "
                             "sharded steps")
    launches["ggx"] += k3
    fitted = got
    del targets

    # fit_lsq: phase 5's problem against the unsharded fit; the
    # step times of the last call of each
    target = targets_for(GGX(), torch.tensor([0.25], device=dev),
                         torch.tensor([[0.9, 0.6, 0.3]], device=dev),
                         i1, o1)[0]
    t_un, t_sh = StepTimer(), StepTimer()

    def lsq(timer, mesh_):
        with timer:
            return fit_lsq(GGX(), i1, o1, target, steps=MESH_STEPS,
                           mesh=mesh_)

    want, got, (k1, _) = pair("fit_lsq", lambda: lsq(t_un, None),
                              lambda: lsq(t_sh, mesh))
    # past one rank the ranks' gradients are summed in another order:
    # parameters whose truth is 0 (rho, txn, tyn) land ~1e-10 apart, so
    # the atol is tests/test_torch_mesh.py's for the same comparison
    err_lsq = max(within("phase 20 fit_lsq", a, b, 1e-6, 1e-7)[0]
                  for a, b in zip(tree_leaves(got), tree_leaves(want)))
    if k1 != MESH_STEPS:
        raise AssertionError(f"phase 20: {k1} K1 launches for {MESH_STEPS} "
                             "sharded steps")
    launches["ggx"] += k1
    steps = {"fit_lsq_unsharded": t_un.median_ms(),
             "fit_lsq": t_sh.median_ms()}
    del target

    # the anisotropic builder at 90x90: the sharded stage 1 against the
    # device f32 power stage (phase 17's path)
    ggx = utia_ggx_eval(dev)
    want, got, _ = pair(
        "aniso", lambda: tabular_aniso.build_tabular_anisotropic(
            ggx, RES_ANISO, RES_ANISO, power="device", device=dev),
        lambda: tabular_aniso.build_tabular_anisotropic(
            ggx, RES_ANISO, RES_ANISO, mesh=mesh, device=dev))
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    tabular_aniso.build_tabular_anisotropic(ggx, RES_ANISO, RES_ANISO,
                                            mesh=mesh, device=dev)
    peak = (torch.cuda.max_memory_allocated() - held) / 1e9
    rel, moved = tables_within("phase 20 aniso 90x90", got[0],
                               to_device(want[0], "cpu"))
    within("phase 20 aniso Fresnel", got[1].points, want[1].points, 1e-4,
           1e-6)
    aniso = got[0]

    # furnace_test on the UTIA table at 64x256
    utia_path = os.path.join(tmpdir, f"ggx-{mesh.rank}.bin")
    save_utia(utia_path, bake_utia(ggx, dev))
    u = utia_mod.Utia.build(torch.as_tensor(load_utia(utia_path),
                                            device=dev))
    want, got, _ = pair(
        "furnace", lambda: integrals.furnace_test(u.evalp, device=dev),
        lambda: integrals.furnace_test(u.evalp, mesh=mesh, device=dev))
    if got != want:
        raise AssertionError(f"phase 20: furnace_test {got} sharded, {want} "
                             "unsharded")
    furnace = got

    # render: a MERL sphere (the lookup) at bench.py's size, and an envmap
    # frame, equal to the unsharded frames; a backward through the sharded
    # MERL frame w.r.t. the table and the floor's f0
    measured = MeasuredMaterial.from_merl(table0)
    _, floor_mat = pt_scene("ggx", dev)

    def merl_frame(res, mesh_, sphere=measured, floor=floor_mat):
        return pathtrace.render(
            sphere, floor, PT_LIGHT, PT_LIGHT_RAD, PT_SKY, res=res,
            spp=PT_SPP, max_bounces=PT_BOUNCES, mesh=mesh_,
            generator=torch.Generator(device=dev).manual_seed(20))

    with torch.no_grad():
        want, got, (_, looked) = pair(
            "merl_frame", lambda: merl_frame(PT_RES, None),
            lambda: merl_frame(PT_RES, mesh))
        identical("phase 20 MERL frame", got, want)
        em = EnvMap.build(env_image(*ENV_SIZES[0]), device=dev)
        sphere, floor_b = pt_scene("beck", dev)
        black = (0.0, 0.0, 0.0)

        def env_frame(mesh_):
            return pathtrace.render(
                sphere, floor_b, PT_LIGHT, black, black, res=ENV_RES,
                spp=ENV_SPP, max_bounces=ENV_BOUNCES, envmap=em, mesh=mesh_,
                generator=torch.Generator(device=dev).manual_seed(21))

        want, got, _ = pair("env_frame", lambda: env_frame(None),
                            lambda: env_frame(mesh))
        identical("phase 20 envmap frame", got, want)
    if looked < 1 or not bool(torch.isfinite(got).all()):
        raise AssertionError("phase 20: the sharded MERL frame launched no "
                             "lookup, or the frames are not finite")
    launches["merl_lookup"] += looked

    def backward(mesh_):
        """The gradients of the frame's mean w.r.t. the table and the
        floor's f0."""
        table = table0.clone().requires_grad_(True)
        f0 = torch.tensor([0.3, 0.3, 0.3], device=dev, requires_grad=True)
        floor = dataclasses.replace(floor_mat, fres=dataclasses.replace(
            floor_mat.fres, f0=f0))
        sphere = dataclasses.replace(measured, model=dataclasses.replace(
            measured.model, table=table))
        merl_frame(BWD_RES, mesh_, sphere, floor).mean().backward()
        return table.grad, f0.grad

    want, got, (_, looked_bwd) = pair("backward", lambda: backward(None),
                                      lambda: backward(mesh))
    launches["merl_lookup"] += looked_bwd
    err_t, _ = within("phase 20 sharded backward, d/d table", got[0],
                      want[0], 1e-5, 1e-6 * float(want[0].abs().max()))
    err_f, _ = within("phase 20 sharded backward, d/d floor f0", got[1],
                      want[1], 1e-5, 1e-9)
    if not (want[0].abs().max() > 0 and want[1].abs().max() > 0):
        raise AssertionError("phase 20: the frame's gradient is zero")

    _, walls["dryrun_multichip"] = timed_call(
        lambda: dryrun_multichip(mesh.size))

    pairs = {k: [round(walls[k], 4), round(walls[k + "_unsharded"], 4)]
             for k in walls if k + "_unsharded" in walls}
    say(f"phase 20 sharded against unsharded at world {mesh.size}, wall s "
        f"(the shorter of two calls each, in turns): {pairs}; "
        f"dryrun_multichip({mesh.size}) {walls['dryrun_multichip']:.4f} s")
    say(f"phase 20 fit_materials M={M_MERL} N={N_MERL} {MESH_STEPS} steps: "
        f"bit for bit, K3 {k3} launches; fit_lsq N={N_SINGLE}: max abs err "
        f"{err_lsq:.3e} (rtol 1e-6, atol 1e-7), K1 {k1} launches, median "
        f"step {steps['fit_lsq']:.3f} ms against "
        f"{steps['fit_lsq_unsharded']:.3f} unsharded; aniso 90x90 sharded "
        f"max rel err {rel:.3e} against the device power stage ({moved} qf "
        f"entries one step off), peak {peak:.3f} GB above {held / 1e9:.3f} "
        f"held; furnace_test 64x256 {furnace}; MERL frame res {PT_RES} spp "
        f"{PT_SPP} and envmap frame res {ENV_RES}: bit for bit, lookups "
        f"{looked}; backward res {BWD_RES}: d/d table max abs err "
        f"{err_t:.3e}, d/d f0 {err_f:.3e}")
    out.update(world=mesh.size, walls_s=walls, step_ms=steps, k3=k3, k1=k1,
               fit_lsq_max_abs_err=err_lsq,
               aniso_max_rel_err=rel, aniso_qf_moved=moved,
               aniso_peak_gb=peak, furnace=list(furnace),
               merl_frame_lookups=looked, backward_err_table=err_t,
               backward_err_f0=err_f)
    return out, launches, fitted, aniso, furnace, utia_path


def start_mesh(n_devices, say=log):
    """``make_mesh`` on the card and NCCL's first all-reduce (where it
    makes its communicator), timed."""
    import torch.distributed as dist

    from dj_brdf_torch.parallel.mesh import make_mesh

    t0 = time.perf_counter()
    mesh = make_mesh(n_devices, "cuda")
    dist.all_reduce(torch.ones(1, device=mesh.device))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    if dist.get_backend() != "nccl" or mesh.device.type != "cuda":
        raise AssertionError(f"phase 20: backend {dist.get_backend()} on "
                             f"{mesh.device}, want nccl on the card")
    say(f"phase 20 mesh: NCCL world of {mesh.size} on {mesh.device} (rank "
        f"{mesh.rank}), init and first all-reduce {init_s:.3f} s")
    return mesh, init_s


def phase20_mesh(mg, ff, alphas, f0s, i, o, i1, o1, table0, cli_tables,
                 results):
    """The mesh on the card: an NCCL process group of one rank started
    in-process, :func:`mesh_checks`, ``dryrun_multichip(1)``, and both
    programs with ``--mesh 1`` in subprocesses. Returns the launches of
    K3 and K1 (GGX) and of the lookup on the sharded paths."""
    import torch.distributed as dist

    from dj_brdf_torch.io.merl_io import save_merl

    mesh, init_s = start_mesh(1)
    tmp = tempfile.TemporaryDirectory()
    out, launches, fitted, aniso, furnace, utia_path = mesh_checks(
        mg, ff, mesh, alphas, f0s, i, o, i1, o1, table0, tmp.name)
    out["init_s"] = init_s
    phase5 = results["fit_lsq_ggx"]["median_step_ms"]
    log(f"phase 20 fit_lsq median step: phase 5 {phase5:.3f} ms")
    out["step_ms"]["phase5"] = phase5

    files = []
    for k in range(N_CLI):
        files.append(os.path.join(tmp.name, f"synth-{k:03d}.binary"))
        save_merl(files[-1], cli_tables[k])
    params = os.path.join(tmp.name, "params.txt")

    def program(module, *args):
        return run_module(module, "--device", "cuda", "--mesh", "1", *args)

    walls = out["walls_s"]
    proc, walls["merl_params_mesh1"] = program(
        "dj_brdf_torch.cli.merl_params", "-o", params, *files)
    if proc.returncode != 0:
        raise AssertionError(f"phase 20: merl_params --mesh 1 exited "
                             f"{proc.returncode}:\n{proc.stderr}")
    with open(params) as fh:
        rows = [ln.split() for ln in fh.read().splitlines()[1:]]
    if rows != results["cli"]["rows"]:
        raise AssertionError(f"phase 20: merl_params --mesh 1 wrote {rows}, "
                             f"phase 10 {results['cli']['rows']}")
    proc, walls["nrm_utia_mesh1"] = program("dj_brdf_torch.cli.nrm_utia",
                                            utia_path)
    verdict = re.findall(r"=> (ok|FAILURE) \(max integral ([0-9.]+)\)",
                         proc.stdout)
    want_v = [("ok" if furnace[0] else "FAILURE", f"{furnace[1]:.4f}")]
    if verdict != want_v or proc.returncode != (0 if furnace[0] else 1):
        raise AssertionError(f"phase 20: nrm_utia --mesh 1 said {verdict} "
                             f"(exit {proc.returncode}), furnace_test "
                             f"{want_v}")
    tmp.cleanup()
    dist.destroy_process_group()
    log(f"phase 20 merl_params --mesh 1 rows {rows} in "
        f"{walls['merl_params_mesh1']:.1f} s; nrm_utia --mesh 1 {verdict} "
        f"exit {proc.returncode} in {walls['nrm_utia_mesh1']:.1f} s")
    out.update(merl_params_rows=rows, nrm_utia=verdict)
    results["mesh"] = out
    return launches, fitted, aniso


def mesh_only(args):
    """Phase 20's :func:`mesh_checks` alone over the process group that
    ``torchrun --nproc-per-node N`` started (NCCL, one card a rank), at
    phase 3's and phase 5's sizes, materials drawn as phase 3 draws them
    and a MERL bake of the first. Rank 0 prints the results and writes them to ``--out``;
    any mismatch raises, and torchrun then stops every rank."""
    import torch.distributed as dist

    from dj_brdf_torch import fresnel
    from dj_brdf_torch.fit.batch import sample_direction_set
    from dj_brdf_torch.io.synth import bake_merl
    from dj_brdf_torch.microfacet import brdf
    from dj_brdf_torch.microfacet.ndf import GGX
    from dj_brdf_torch.microfacet.params import MicrofacetParams
    from dj_brdf_torch.ops import _build
    from dj_brdf_torch.ops import fused_fit as ff
    from dj_brdf_torch.ops import merl_gather as mg

    rank = int(os.environ.get("RANK", 0))
    say = log if rank == 0 else (lambda *_: None)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    say(" | ".join(smi.splitlines()))
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh, init_s = start_mesh(None, say)
    if mesh.rank == 0:               # one build; the other ranks load it
        _build.build_all(["fused_fit", "merl_gather", "alias"])
    dist.barrier(device_ids=[mesh.device.index])
    ff._lib()
    mg._lib()
    dev = mesh.device
    gen = torch.Generator().manual_seed(args.seed)
    dirgen = torch.Generator(device=dev).manual_seed(0)
    i, o = sample_direction_set(N_MERL, dirgen, dev)
    lo, hi = ALPHA_RANGE_GGX
    alphas = (lo + (hi - lo) * torch.rand(M_MERL, generator=gen)).to(dev)
    f0s = (0.05 + 0.9 * torch.rand((M_MERL, 3), generator=gen)).to(dev)
    i1, o1 = sample_direction_set(N_SINGLE, dirgen, dev)
    table0 = bake_merl(lambda ii, oo: brdf.eval(
        GGX(), fresnel.Schlick(f0=f0s[0]), MicrofacetParams.isotropic(
            alphas[0]), ii, oo), device=dev).float()
    with tempfile.TemporaryDirectory() as tmp:
        out = mesh_checks(mg, ff, mesh, alphas, f0s, i, o, i1, o1, table0,
                          tmp, say)[0]
    out.update(init_s=init_s, nvidia_smi=smi)
    if mesh.rank == 0:
        say(json.dumps(out))
        if args.out:
            with open(args.out, "w") as fh:
                json.dump(out, fh, indent=1)
    dist.destroy_process_group()


def phase21_cli_utils(mg, ff, table0, fitted, aniso, i, o, alphas, f0s,
                      results):
    """The programs and the utilities on the card: ``cli/render.py`` for
    four models and a path-traced envmap frame against the same renders
    called directly, ``dmap2nmap``/``nmap2leanmap`` on a 512x512 PNG of
    the port's codec against the CPU, checkpoint round trips of a fitted
    state and a 90x90 table, and a ``trace()`` of one fit step."""
    import numpy as np

    from dj_brdf_torch import fresnel
    from dj_brdf_torch.cli import dmap2nmap, nmap2leanmap
    from dj_brdf_torch.cli import render as cli_render
    from dj_brdf_torch.core.pytree import tree_leaves
    from dj_brdf_torch.fit import moments, tabular, tabular_aniso
    from dj_brdf_torch.fit.batch import fit_materials
    from dj_brdf_torch.io import png
    from dj_brdf_torch.io.merl_io import save_merl
    from dj_brdf_torch.io.synth import bake_utia
    from dj_brdf_torch.io.utia_io import load_utia, save_utia
    from dj_brdf_torch.lean.filtered import FilteredBeckmannMaterial
    from dj_brdf_torch.lean.lrep import Lrep
    from dj_brdf_torch.microfacet.ndf import GGX
    from dj_brdf_torch.microfacet.params import MicrofacetParams
    from dj_brdf_torch.models.merl import Merl
    from dj_brdf_torch.models.utia import Utia
    from dj_brdf_torch.render import pathtrace
    from dj_brdf_torch.render.envmap import EnvMap
    from dj_brdf_torch.render.materials import (MeasuredMaterial,
                                                MicrofacetMaterial)
    from dj_brdf_torch.render.sphere import (render_sphere, sample_texture,
                                             sphere_normals, sphere_uv)
    from dj_brdf_torch.utils import checkpoint, profiling

    tmp = tempfile.TemporaryDirectory()
    d = tmp.name
    out = {}

    def path(name):
        return os.path.join(d, name)

    def f32(*x):
        return torch.tensor(x, dtype=torch.float32, device="cuda")

    # dmap2nmap and nmap2leanmap on a 512x512 PNG of the port's codec,
    # the card against the CPU
    y, x = np.meshgrid(np.arange(512), np.arange(512), indexing="ij")
    dmap = (127.5 + 127.5 * np.sin(2 * np.pi * x / 64)
            * np.cos(2 * np.pi * y / 96)).astype(np.uint8)
    png.write_png(path("dmap.png"), dmap)
    walls = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        dmap2nmap.main([path("dmap.png"), "--scale", "0.02", "-o",
                        path(f"nmap-{dev}.png"), "--device", dev])
        nmap2leanmap.main([path(f"nmap-{dev}.png"), "--base-roughness",
                           "0.1", "--out1", path(f"l1-{dev}.npy"), "--out2",
                           path(f"l2-{dev}.npy"), "--device", dev])
        walls[dev] = time.perf_counter() - t0
    nm = [png.read_png(path(f"nmap-{dev}.png")).astype(int)
          for dev in ("cuda", "cpu")]
    lsb = int(np.abs(nm[0] - nm[1]).max())
    if nm[0].shape != (512, 512, 3) or lsb > 1:
        raise AssertionError(f"phase 21: dmap2nmap on the card differs from "
                             f"the CPU by {lsb} 8-bit steps")
    for k in ("l1", "l2"):
        within(f"phase 21 nmap2leanmap {k}", torch.from_numpy(np.load(
            path(f"{k}-cuda.npy"))), np.load(path(f"{k}-cpu.npy")), 1e-5,
            1e-6)
    out["maps"] = {"wall_s": walls, "nmap_max_lsb": lsb}

    # cli/render.py against the same renders called directly on the card
    save_merl(path("m.binary"), table0)
    utia_raw = bake_utia(utia_ggx_eval("cuda"))
    save_utia(path("u.bin"), utia_raw)
    np.save(path("env.npy"), env_image(*ENV_SIZES[0]))
    table = Merl(table=table0).table
    utia = Utia.build(torch.as_tensor(load_utia(path("u.bin")),
                                      device="cuda"))
    light, res = (0.3, 0.4, 0.8), PT_RES

    def sphere(mat):
        return render_sphere(mat.evalp, light, res=res, device="cuda")

    def merl_direct():
        return sphere(MeasuredMaterial.from_merl(table))

    def merl_fit_direct():
        tab, tab_fres = tabular.build_tabular(Merl(table=table), RES_TAB,
                                              shadow=False)
        return sphere(MicrofacetMaterial(
            GGX(), tab_fres, moments.fit_ggx_parameters(tab)))

    def utia_tab_direct():
        tab, tab_fres = tabular_aniso.build_tabular_anisotropic(
            utia, RES_ANISO, RES_ANISO)
        return sphere(MicrofacetMaterial(tab, tab_fres,
                                         MicrofacetParams.isotropic(f32(1.0)[0])))

    def lean_direct():
        m1 = torch.as_tensor(np.load(path("l1-cuda.npy")), device="cuda")
        m2 = torch.as_tensor(np.load(path("l2-cuda.npy")), device="cuda")
        uu, vv = sphere_uv(sphere_normals(res, device="cuda")[0])
        lean = Lrep(*(sample_texture(t, uu, vv) for t in (
            m1[..., 0], m1[..., 1], m2[..., 0], m2[..., 1], m2[..., 2])))
        return sphere(FilteredBeckmannMaterial(
            lean=lean, base_params=MicrofacetParams.elliptic(
                f32(0.3)[0], f32(0.3)[0], f32(0.0)[0]),
            eta=f32(*GOLD_ETA), k=f32(*GOLD_K), dmap_scale=f32(1.0)[0]))

    def pathtrace_direct():
        s_mat = MicrofacetMaterial(GGX(), fresnel.Schlick(f0=f32(1, 1, 1)),
                                   MicrofacetParams.elliptic(
                                       f32(0.3)[0], f32(0.3)[0], f32(0.0)[0]))
        f_mat = MicrofacetMaterial(GGX(), fresnel.Schlick(
            f0=f32(0.35, 0.35, 0.35)), MicrofacetParams.isotropic(
                f32(0.4)[0]))
        em = EnvMap.build(torch.from_numpy(np.load(path("env.npy"))),
                          device="cuda")
        return pathtrace.render(
            s_mat, f_mat, light, cli_render.LIGHT_RADIANCE,
            cli_render.SKY_RADIANCE, res=res, spp=PT_SPP,
            max_bounces=PT_BOUNCES, envmap=em,
            generator=torch.Generator(device="cuda").manual_seed(0))

    cases = {
        "merl": (["--file", path("m.binary")], merl_direct),
        "merl_fit": (["--file", path("m.binary")], merl_fit_direct),
        "utia_tab": (["--file", path("u.bin")], utia_tab_direct),
        "lean": (["--leanmap1", path("l1-cuda.npy"), "--leanmap2",
                  path("l2-cuda.npy")], lean_direct),
        "ggx": (["--pathtrace", "--envmap", path("env.npy"), "--spp",
                 str(PT_SPP), "--bounces", str(PT_BOUNCES), "--floor-model",
                 "ggx"], pathtrace_direct)}
    for name, (args, direct) in cases.items():
        argv = ["--model", name, *args, "--res", str(res), "--device",
                "cuda"]
        t0 = time.perf_counter()
        cli_render.main(argv + ["-o", path(f"{name}.npy")])
        wall = time.perf_counter() - t0
        got = torch.from_numpy(np.load(path(f"{name}.npy")))
        with torch.no_grad():
            want, direct_wall = timed_call(direct)
        err, _ = within(f"phase 21 render --model {name}", got, want, 1e-6,
                        1e-7 * float(want.abs().max()))
        if not (got.shape == (res, res, 3) and float(got.max()) > 0.0):
            raise AssertionError(f"phase 21: render --model {name} is empty")
        out[f"render_{name}"] = {"wall_s": wall, "direct_s": direct_wall,
                                 "max_abs_err": err}
    cli_render.main(["--model", "merl", "--file", path("m.binary"), "--res",
                     str(res), "--device", "cuda", "-o", path("merl.png")])
    # the program's tone map, on the card as it runs it
    img = torch.from_numpy(np.load(path("merl.npy"))).cuda()
    tone = ((torch.clamp(img * 1.0, 0.0, 1.0) ** (1 / 2.2)).cpu().numpy()
            * 255).astype(np.uint8)
    if not np.array_equal(png.read_png(path("merl.png")), tone):
        raise AssertionError("phase 21: render's PNG is not its image")
    log(f"phase 21 cli/render.py --device cuda res {res}: "
        f"{ {k[7:]: [round(v['wall_s'], 3), round(v['direct_s'], 3), v['max_abs_err']] for k, v in out.items() if k.startswith('render_')} } "
        f"(program s, direct render s, max abs err); PNG = the tonemapped "
        f"image; dmap2nmap + nmap2leanmap 512x512 card {walls['cuda']:.3f} s,"
        f" CPU {walls['cpu']:.3f} s, normal map within {lsb} step")

    # checkpoints of a fitted M = 100 state and the 90x90 table, on the card
    for name, tree in (("fit", fitted), ("aniso", aniso)):
        f = path(f"{name}.pt")
        checkpoint.save_checkpoint(f, tree)
        back = checkpoint.load_checkpoint(f, like=tree, map_location="cuda")
        leaves = tree_leaves(back)
        if not (type(back) is type(tree) and all(
                t.is_cuda for t in leaves) and all(
                torch.equal(a, b) for a, b in zip(leaves,
                                                  tree_leaves(tree)))):
            raise AssertionError(f"phase 21: the {name} checkpoint does not "
                                 "round-trip on the card")
        out[f"checkpoint_{name}_bytes"] = os.path.getsize(f)

    # a trace of one fit step, which must show the fit kernel
    targets = targets_for(GGX(), alphas, f0s, i, o)
    torch.cuda.synchronize()
    with profiling.trace(path("trace")) as prof:
        fit_materials(targets, i, o, steps=1)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()]
    hits = [n for n in names if "fused_fit_kernel" in n]
    with open(path("trace/trace.json")) as fh:
        in_file = "fused_fit_kernel" in fh.read()
    if not (hits and in_file):
        raise AssertionError("phase 21: the trace of a fit step shows no "
                             "fused_fit_kernel")
    log(f"phase 21 checkpoints: fit state {out['checkpoint_fit_bytes']} B, "
        f"90x90 table {out['checkpoint_aniso_bytes']} B, bit for bit on the "
        f"card; trace() of one fit step: {len(names)} event names, "
        f"{hits[0][:60]!r} among them and in trace.json")
    out["trace_kernel"] = hits[0]
    results["cli_utils"] = out
    tmp.cleanup()


# phase 22: the port's bench at bench.py's sizes, its tools
BENCH_TIMEOUT = 900
N_SCALING = 1 << 20             # bench_scaling's default batch
# each bench metric and the earlier phase's timing of the same call at
# the same shape, as (bench metric, label, rate of the phase from results)
BENCH_VS_PHASES = (
    ("ggx_evalp_fwdbwd_evals_per_s_per_chip", "K1 alone at 2^23 (phase 6)",
     lambda r: r["timings"][f"ggx_M1_N{N_SINGLE}"]["kernel_evals_per_s"]),
    ("fit_step_evals_per_s", "fit_lsq's median step at 2^23 (phase 5)",
     lambda r: r["fit_lsq_ggx"]["evals_per_s"]),
    ("utia_eval_evals_per_s", "Utia.evalp at 2^23 (phase 17)",
     lambda r: r["utia"]["evalp"]["evals_per_s"]),
    ("pathtrace_samples_per_s", "Beckmann-floor frame (phase 13)",
     lambda r: r["pathtrace"]["beck"]["samples_per_s"]),
    ("pathtrace_ggx_samples_per_s", "GGX-floor frame (phase 13)",
     lambda r: r["pathtrace"]["ggx"]["samples_per_s"]),
    ("pathtrace_envmap_samples_per_s", "32x64 envmap frame (phase 15)",
     lambda r: r["envmap"]["32x64"]["samples_per_s"]),
    ("pathtrace_envmap_1024x2048_samples_per_s",
     "1024x2048 envmap frame (phase 15)",
     lambda r: r["envmap"]["1024x2048"]["samples_per_s"]),
    ("pathtrace_matpreview_samples_per_s", "matpreview frame (phase 16)",
     lambda r: r["matpreview"]["samples_per_s"]),
    ("power_iteration_matvecs_per_s_n8010", "8010^2 matvec (phase 17)",
     lambda r: r["utia"]["aniso"]["matvecs_per_s"]),
    ("aniso_fit90_wall_seconds", "90x90 build, s (phase 17)",
     lambda r: r["utia"]["aniso"]["aniso_fit90_wall_seconds"]),
    ("batch_tabulate_res90_materials_per_s",
     "tabulate_merl_batch, 100 at res 90 (phase 9)",
     lambda r: M_MERL / r["tabulate"]["wall_s"]),
)


def phase22_kernels(mg, ff):
    """The kernels of the bench's and ``bench_scaling``'s paths at their
    shapes and on their own inputs, each against its plain version (phase
    2's tolerances, phase 8's bit for bit): K1 at the headline's 2^23, K2
    at ``fit_step_beckmann``'s start, K3 at ``fit_batch_step``'s 16 x
    2^20, the MERL lookup at ``merl_eval``'s one table x 2^23 and K1 at
    ``bench_scaling``'s 2^20. Returns the largest errors: {"ggx": ...,
    "beck": ..., "merl_lookup": ...}."""
    from dj_brdf_torch import bench
    from dj_brdf_torch.fit import lsq
    from dj_brdf_torch.models import merl as merl_mod
    from dj_brdf_torch.ops import soa
    from dj_brdf_torch.tools import bench_scaling as bs

    def rows(planes):
        return tuple(t[None] for t in planes)

    n = N_SINGLE                                 # the bench's BENCH_N
    i, o, comp, targets, pvec = bench.headline_inputs(n, "cuda")
    errs = {"ggx": compare(f"headline K1 M=1 N={n}", "ggx", pvec[None],
                           comp, rows(targets), n, phase=22)}
    start = soa.raw_to_pvec(lsq.raw_init(device="cuda"))
    truth = torch.tensor(bench.PVEC_TRUE, device="cuda")
    errs["beck"] = compare(
        f"fit_step_beckmann K2 M=1 N={n}", "beck", start[None], comp,
        rows(soa.beckmann_evalp_soa(truth, *comp)), n, phase=22)
    bcomp, btgts, leaves = bench.batch_inputs(i, o, bench.BATCH_M)
    nm = bcomp[0].shape[0]
    errs["ggx"] = max(errs["ggx"], compare(
        f"fit_batch_step K3 M={bench.BATCH_M} N={nm}", "ggx",
        soa.raw_to_pvec(lsq.RawFit(*leaves)), bcomp, btgts, nm, phase=22))
    del bcomp, btgts
    tables = bench.merl_eval_table("cuda").reshape(1, 3, merl_mod.PLANE)
    idx = merl_mod.merl_flat_index(i, o).reshape(-1).contiguous()
    iz = i[:, 2].contiguous()
    errs["merl_lookup"] = exact(
        f"merl_eval lookup M=1 N={n}",
        mg.kernel_merl_lookup(tables, idx, merl_mod.SCALES, iz),
        mg.plain_merl_lookup(tables, idx, merl_mod.SCALES, iz))
    log(f"phase 22 merl_eval lookup M=1 N={n}: bit for bit")
    del i, o, comp, targets, tables, idx, iz
    spvec, scomp, stgts = bs.make_inputs(N_SCALING, "cuda")
    errs["ggx"] = max(errs["ggx"], compare(
        f"bench_scaling K1 M=1 N={N_SCALING}", "ggx", spvec[None], scomp,
        rows(stgts), N_SCALING, phase=22))
    return errs


def phase22_bench(ops, results):
    """The port's programs on the card: ``python -m dj_brdf_torch.bench``
    at bench.py's sizes (its line, its records and the kernels they
    launched, each rate against the earlier phase's timing of the same
    call), ``bench_scaling`` at a world of one card against the unsharded
    step, and ``validate_merl_fits`` on the synthetic corpus. Returns the
    bench's kernel launches and the largest errors of phase22_kernels,
    each {"ggx": ..., "beck": ..., "merl_lookup": ...}."""
    from dj_brdf_torch import bench
    from dj_brdf_torch.ops import fused_fit as ff
    from dj_brdf_torch.ops import merl_gather as mg
    from dj_brdf_torch.tools import bench_scaling as bs

    counted = {k: ops[k] for k in bench.SASS_OPS}
    if counted != bench.SASS_OPS:
        raise AssertionError(f"phase 22: the bench's share_of_bound takes "
                             f"{bench.SASS_OPS} f32 operations, this build's "
                             f"SASS has {counted} (phase 1)")
    out = {"kernel_errs": phase22_kernels(mg, ff)}
    torch.cuda.empty_cache()
    proc, wall = run_module("dj_brdf_torch.bench", timeout=BENCH_TIMEOUT)
    out["stderr"] = proc.stderr
    if proc.returncode != 0:
        raise AssertionError(f"phase 22: the bench exited {proc.returncode}:"
                             f"\n{proc.stderr[-3000:]}")
    lines = proc.stdout.strip().splitlines()
    line = json.loads(lines[-1])
    recs = {r["metric"]: r for r in (json.loads(ln) for ln in
                                     proc.stderr.splitlines()
                                     if ln.startswith("{"))}
    values = [line["value"], *line["secondary"].values()]
    log(f"phase 22 python -m dj_brdf_torch.bench: exit 0 in {wall:.1f} s, "
        f"{len(lines[-1])} characters: {lines[-1]}")
    if not (len(lines) == 1 and len(lines[-1]) < 2000
            and line["failed"] == []
            and set(line["secondary"]) == set(bench.METRICS)
            and all(math.isfinite(v) and v > 0 for v in values)
            and line["consistent_vs_fit_step"]
            and line["device"]["platform"] == "gpu"):
        raise AssertionError("phase 22: the bench's line is not one line "
                             "under 2,000 characters with every metric "
                             "finite, positive and not failed, consistent "
                             "with the fit step, from the card")
    launched = {"ggx": 0, "beck": 0, "merl_lookup": 0}
    for name, rec in recs.items():
        family = "beck" if name == "fit_step_beckmann_evals_per_s" else "ggx"
        launched[family] += rec["launches"]["fused_fit"]
        launched["merl_lookup"] += rec["launches"]["merl_lookup"]
    for name, kernel in ((bench.HEADLINE, "fused_fit"),
                         ("fit_step_evals_per_s", "fused_fit"),
                         ("fit_step_beckmann_evals_per_s", "fused_fit"),
                         ("fit_batch_step_evals_per_s", "fused_fit"),
                         ("merl_eval_evals_per_s", "merl_lookup"),
                         ("batch_tabulate_res90_materials_per_s",
                          "merl_lookup")):
        if recs[name]["launches"][kernel] == 0:
            raise AssertionError(f"phase 22: {name} launched no {kernel} "
                                 "kernel")
    shares = {name: recs[name]["share_of_bound"] for name in (
        bench.HEADLINE, "merl_eval_evals_per_s", "fit_step_evals_per_s",
        "fit_step_beckmann_evals_per_s", "fit_batch_step_evals_per_s")}
    log(f"phase 22 launches by metric: "
        f"{ {k: r['launches'] for k, r in recs.items()} }; share of the "
        f"card's bound: {shares}")
    ratios = {}
    for name, label, mine in BENCH_VS_PHASES:
        ratios[name] = recs[name]["value"] / mine(results)
        log(f"phase 22 {name} {recs[name]['value']:.5g} / {label} "
            f"{mine(results):.5g} = {ratios[name]:.4f}")
    out.update(wall_s=wall, line=line, records=recs, shares=shares,
               ratios=ratios, launches=launched)

    # bench_scaling at a world of one card: the unsharded step bit for bit
    with tempfile.TemporaryDirectory() as tmp:
        worlds = os.path.join(tmp, "worlds.json")
        proc, wall = run_module("dj_brdf_torch.tools.bench_scaling",
                                "--devices", "1", "--out", worlds)
        if proc.returncode != 0:
            raise AssertionError(f"phase 22: bench_scaling exited "
                                 f"{proc.returncode}:\n{proc.stderr[-3000:]}")
        with open(worlds) as fh:
            world = json.load(fh)["1"]
    scaling = json.loads(proc.stdout.strip().splitlines()[-1])
    loss, grad = bs.unsharded_step(*bs.make_inputs(N_SCALING, "cuda"))
    log(f"phase 22 bench_scaling --devices 1: exit 0 in {wall:.1f} s, "
        f"{scaling}; loss {world['loss']!r} against the unsharded "
        f"{float(loss)!r}, gradient equal: {world['grad'] == grad.tolist()}")
    if world["loss"] != float(loss) or world["grad"] != grad.tolist():
        raise AssertionError("phase 22: bench_scaling at a world of one is "
                             "not the unsharded step bit for bit")
    out["bench_scaling"] = {"wall_s": wall, "line": scaling}

    proc, wall = run_module("dj_brdf_torch.tools.validate_merl_fits")
    pinned = proc.stdout.count("pinned ok")
    log(f"phase 22 validate_merl_fits: exit {proc.returncode} in {wall:.1f} "
        f"s:\n{proc.stdout.strip()}\n{proc.stderr.strip()}")
    if proc.returncode != 0 or pinned != 3:
        raise AssertionError(f"phase 22: validate_merl_fits exited "
                             f"{proc.returncode} with {pinned} of 3 "
                             "materials pinned ok")
    out["validate_merl_fits"] = {"wall_s": wall, "stdout": proc.stdout}
    results["bench"] = out
    return launched, out["kernel_errs"]


def ab_times(root, seed):
    """One process of phase 14: the MERL lookup at ``AB_LOOKUPS``, K5 and
    K6 at phase 7's shape and K4 at N = 2^23 + 1000, of the
    ``dj_brdf_torch`` in the checkout
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
    plane = torch.rand(N_MERL, generator=dgen, device="cuda")
    gidx = torch.randint(0, N_MERL, (N_GATHER,), generator=dgen,
                         device="cuda", dtype=torch.int32)
    plane2d = mg.pad_plane(plane)
    row, lane = mg.row_lane(gidx)
    out["gathers"] = {}
    for name, fn in (
            ("gather_plane", lambda: mg.kernel_gather_plane(plane, gidx)),
            ("gather_rowlane",
             lambda: mg.kernel_gather_rowlane(plane2d, row, lane))):
        digest = hashlib.sha256(fn().cpu().numpy().tobytes()).hexdigest()
        ms = [device_ms(fn, 20) for _ in range(2)]
        out["gathers"][name] = {"ms": min(ms), "sha256": digest}
    del plane, plane2d
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
    """The MERL lookup, K5, K6 and K4 of this checkout against those of
    the checkout ``baseline``, each in processes of its own, in turns."""
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
    out["gathers"] = {}
    for key in runs[0]["gathers"]:
        if len({r["gathers"][key]["sha256"] for r in runs}) != 1:
            raise AssertionError(f"phase 14: {key} of the two checkouts "
                                 "differ")
        b = [r["gathers"][key]["ms"] for r in base]
        t = [r["gathers"][key]["ms"] for r in this]
        out["gathers"][key] = {"baseline_runs_ms": b, "current_runs_ms": t,
                               "current_over_baseline": min(t) / min(b)}
        log(f"phase 14 A/B {key} N={N_GATHER} (device time): baseline {b} "
            f"ms, this {t} ms, this/baseline {min(t) / min(b):.4f}; bit for "
            "bit")
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
