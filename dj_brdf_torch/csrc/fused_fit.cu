// Fused fit step for Hopper (sm_90a): the relative-L2 loss of the GGX or
// Beckmann + Schlick microfacet BRDF and its hand-written gradient w.r.t.
// the 8 constrained parameters [ax, ay, rho, txn, tyn, f0r, f0g, f0b], for
// M materials fitted against one shared set of N direction pairs.
//
// Replaces dj_brdf_tpu/ops/fused_fit.py:51 (_kernel_hand), the Pallas body
// behind ggx_lsq_value_and_grad (:113, single material) and
// ggx_lsq_value_and_grad_batched (:180, M materials), for both families. A
// single-material call is the batched kernel with M = 1. The per-sample
// math is that of dj_brdf_torch/ops/soa.py::_lsq_fwdbwd, the plain version
// this kernel is tested against, line for line: the same 1e-24 floors
// under sqrt(1 - rho^2) and the rsqrt of the half-vector and warp norms,
// the same 1e-12 gates, valid_h = hz > 1e-4, the clip of cos(theta_d),
// third = float(1/3), the Beckmann c_std >= 1 branch and the A&S 7.1.26
// erf polynomial (not erff). Gated samples add exactly 0 to every term.
//
// Numerics: built without --use_fast_math, so sqrtf, expf and "/" are the
// IEEE versions the plain PyTorch path uses. Only the per-sample
// reciprocals that the TPU kernel took through _recip_nr (inv_si, inv_so,
// inv_den, inv_hz, inv_t1, inv_oz4, inv_tr/tg/tb and Beckmann's nu) use
// rcp.approx.ftz.f32 plus one Newton step; the per-material scalars 1/ax,
// 1/ay and 1/s stay exact.
//
// What bounds it on an H100 SXM (700 W; chip_smoke.py counts the SASS and
// times the kernel, PERF.md has the probes). Per sample, 24 B of
// directions (read once for all materials); per sample and material, 12 B
// of targets and one `accumulate`, which compiles to 253 SASS
// instructions for GGX (244 f32 operations) and 481 for Beckmann (405).
// At M = 100, N = 1,458,000 the bytes need 0.53 ms at 3.35 TB/s, and a
// variant that only streams them runs in ~0.67 ms; but the accumulates
// alone need ~1.10 ms (GGX) and ~2.10 ms (Beckmann) of issue slots at one
// warp instruction per cycle on each of the 132 x 4 schedulers at the
// ~1.98 GHz the card holds, and a variant without target loads runs in
// ~1.34 / ~2.15 ms. The kernel is bound by instruction issue, within
// ~5-7% of its compute-only variant: it has to
// hide the memory stream behind the arithmetic and spend few
// instructions on anything else. At M = 1 (N = 2^23) the 302 MB of
// directions and targets set the bound (0.090 ms); there the memory-only
// variant takes ~0.12 ms and the compute-only one ~0.11 (GGX) / ~0.16 ms
// (Beckmann).
//
// The design (one launch per step):
// - A work stream of (tile, material) units, tile-major: a tile is kTile
//   consecutive samples, and each thread owns kItems consecutive samples
//   of it. The grid is persistent, (SMs x resident CTAs per SM) CTAs, and
//   CTA g takes the contiguous slice [W g / G, W (g + 1) / G) of the W =
//   tiles x M units. Every CTA does the same work to within one unit (a
//   tile-strided walk would leave 1,424 tiles on 264 CTAs at 5 or 6 each,
//   and a grid of one CTA per tile a 39%-full last wave), and touches at
//   most two partial tiles, so directions still cost ~24 B/sample.
// - A ring of kStages shared-memory stages, filled with cp.async: while
//   unit e is computed, unit e+1 is in flight: the 3 target rows of its
//   material over the tile and, for the first unit of a tile, the tile's
//   6 direction rows, all in the unit's stage. Each thread copies exactly
//   the samples it will compute and reads back only those, so the ring
//   needs cp.async.wait_group and no barrier, and no register is held by
//   a load in flight. A copy is 16 B (kItems samples) where the row is
//   aligned and the tile full, else 4 B per sample (rows k*N of an N that
//   is not a multiple of 4 are not 16-B aligned). Two stages, not three or
//   four: at two, two CTAs of 256 threads are resident per SM (the
//   registers allow no more), which keeps ~72 KB of loads in flight per
//   SM, and a third stage would cost one of them.
// - Samples past the end of the last tile are computed too, on a stand-in
//   (kDeadDir, zero targets) that every gate closes on, so the 4 samples
//   of a thread are branch-free chains the compiler interleaves.
// - The materials' scalars (sqrt(1 - rho^2), 1/ax, ...) are computed once
//   per chunk of kChunk units into shared memory, not per unit by every
//   thread. Per unit, the 9 terms (loss + 8 gradients) are summed in
//   registers over the thread's samples, then over the warp by a
//   reduce-scatter butterfly (14 shuffles, not 45), and every kChunk
//   units across warps in shared memory, in float; each unit's CTA sum is
//   then added in double, in unit order, to the CTA's running sums by one
//   thread per (material, term) of the chunk. The sums live in shared
//   memory behind the ring where that costs no resident CTA (M up to ~490
//   on an H100), else in the CTA's row of partials (G, M*9), which no
//   other CTA touches: one code path with another pointer. At M = 100 GGX
//   the shared-memory sums are 1.2-1.9% faster, since an add to L2 at a
//   chunk's start stalls the 5 warps that make it and the chunk's
//   barriers wait for them; holding that load across the chunk instead
//   spills at 128 registers.
// - The epilogue sums the partials in a fixed order in two levels: the
//   last CTA of each group of `group` CTAs (an integer ticket per group,
//   after __threadfence) sums its group's rows, and the last group sums
//   the group rows into out (M, 9), in double, then resets the tickets
//   for the next launch. The result is the same bit for bit from run to
//   run on one device, with no float atomics.
//
// Registers, spills, shared memory: ptxas reports 128 / 126 registers
// (GGX / Beckmann), no spills, and 6,224 B of static shared memory; the
// dynamic part is the ring, 73,728 B, and where they fit the running sums
// (72 B per material: 80,928 B in all at M = 100). Two CTAs are resident
// per SM, limited by registers (djbt_fused_fit_occupancy). Of the variants
// measured (2 or 4 samples per thread, 1 to 3 resident CTAs, 2 or 3
// stages), this one was the fastest without spills.
//
// The kernel allocates nothing and does not synchronise: the caller passes
// the partials, tickets and output buffers and PyTorch's current stream,
// and each launch's cudaGetLastError() is returned to it.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlock = 256;
constexpr int kItems = 4;     // consecutive samples per thread: one 16-B copy
constexpr int kStages = 2;
constexpr int kMinBlocks = 2;
constexpr int kTile = kBlock * kItems;
constexpr int kWarps = kBlock / 32;
constexpr int kTerms = 9;   // loss + 8 gradient components
constexpr int kChunk = 16;  // units reduced per shared-memory round
constexpr int kRows = 9;    // rows of a ring stage: 3 targets, 6 directions
constexpr int kRingBytes =
    static_cast<int>(sizeof(float)) * kStages * kRows * kTile;
static_assert(kChunk * kTerms <= kBlock, "a thread per (material, term)");

constexpr float kEps = 1e-2f;
constexpr float kThird = 1.0f / 3.0f;
constexpr float kInvPi = 0.318309886183790671538f;
constexpr float kSqrtPiInv = 0.5641895835477563f;

// approximate reciprocal + one Newton step (the TPU kernel's _recip_nr)
__device__ __forceinline__ float recip_nr(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r * (2.0f - x * r);
}

// Abramowitz & Stegun 7.1.26 erf (dj_brdf_tpu/core/special.py), with the
// caller's exp(-x*x) passed in, as XLA shares it in the reference.
__device__ __forceinline__ float erf_as(float x, float e_mx2) {
  const float a1 = 0.254829592f, a2 = -0.284496736f, a3 = 1.421413741f;
  const float a4 = -1.453152027f, a5 = 1.061405429f, p = 0.3275911f;
  const float sign = x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
  const float t = 1.0f / (1.0f + p * fabsf(x));
  const float y =
      1.0f - (((((a5 * t + a4) * t) + a3) * t + a2) * t + a1) * t * e_mx2;
  return sign * y;
}

struct alignas(16) Material {  // 16-B aligned: read from shared memory as 4 vectors
  float ax, ay, rho, txn, tyn, f0r, f0g, f0b;
  float s, inv_ax, inv_ay, inv_s, inv_axays, ay_rho, ay_s;
};

__device__ __forceinline__ Material load_material(const float* __restrict__ p) {
  Material q;
  q.ax = __ldg(p + 0);
  q.ay = __ldg(p + 1);
  q.rho = __ldg(p + 2);
  q.txn = __ldg(p + 3);
  q.tyn = __ldg(p + 4);
  q.f0r = __ldg(p + 5);
  q.f0g = __ldg(p + 6);
  q.f0b = __ldg(p + 7);
  q.s = sqrtf(fmaxf(1.0f - q.rho * q.rho, 1e-24f));
  q.inv_ax = 1.0f / q.ax;
  q.inv_ay = 1.0f / q.ay;
  q.inv_s = 1.0f / q.s;
  q.inv_axays = q.inv_ax * q.inv_ay * q.inv_s;
  q.ay_rho = q.ay * q.rho;
  q.ay_s = q.ay * q.s;
  return q;
}

// One direction pair with every material-independent term precomputed.
struct Dir {
  float ix, iy, iz, ox, oy, oz;
  float bsx, bsy;   // -h.x / h.z, -h.y / h.z
  float inv_hz4;    // 1 / h.z^4
  float c5;         // (1 - cos(theta_d))^5
  float r_oz4;      // 1 / (4 o.z)
  bool valid_h, ok_oz;
};

__device__ __forceinline__ Dir load_dir(float ix, float iy, float iz,
                                        float ox, float oy, float oz) {
  Dir d;
  d.ix = ix;
  d.iy = iy;
  d.iz = iz;
  d.ox = ox;
  d.oy = oy;
  d.oz = oz;
  float hx = d.ix + d.ox, hy = d.iy + d.oy, hz = d.iz + d.oz;
  const float hn = rsqrtf(fmaxf(hx * hx + hy * hy + hz * hz, 1e-24f));
  hx *= hn;
  hy *= hn;
  hz *= hn;
  d.valid_h = hz > 1e-4f;
  const float inv_hz = recip_nr(d.valid_h ? hz : 1.0f);
  d.bsx = -hx * inv_hz;
  d.bsy = -hy * inv_hz;
  const float inv_hz2 = inv_hz * inv_hz;
  d.inv_hz4 = inv_hz2 * inv_hz2;
  const float cosd = fminf(fmaxf(d.ox * hx + d.oy * hy + d.oz * hz, 0.0f), 1.0f);
  const float c1 = 1.0f - cosd;
  const float c2 = c1 * c1;
  d.c5 = c2 * c2 * c1;
  const float oz4 = 4.0f * d.oz;
  d.ok_oz = fabsf(oz4) >= 1e-12f;
  d.r_oz4 = recip_nr(d.ok_oz ? oz4 : 1.0f);
  return d;
}

// sigma(k) of the warped direction and the forward values its adjoint reuses
struct Sigma {
  float sig, a, b, c, inv_nrm;
  float c_std, sin2, f, fp;  // Beckmann only
};

template <bool kBeck>
__device__ __forceinline__ Sigma sigma(const Material& p, float kx, float ky,
                                       float kz) {
  Sigma r;
  r.a = kx * p.ax + ky * p.ay_rho;
  r.b = ky * p.ay_s;
  r.c = kz - kx * p.txn - ky * p.tyn;
  const float q = r.a * r.a + r.b * r.b + r.c * r.c;
  r.inv_nrm = rsqrtf(fmaxf(q, 1e-24f));
  const float nrm = q * r.inv_nrm;
  if (!kBeck) {
    r.sig = (nrm + r.c) * 0.5f;
    return r;
  }
  r.c_std = r.c * r.inv_nrm;
  r.sin2 = fmaxf(1.0f - r.c_std * r.c_std, 1e-24f);
  const float sin_k = sqrtf(r.sin2);
  const float nu = r.c_std * recip_nr(fmaxf(sin_k, 1e-12f));
  const float e_nu2 = expf(-nu * nu);
  const float half_1pe = 0.5f * (1.0f + erf_as(nu, e_nu2));
  const float f = r.c_std * half_1pe + 0.5f * sin_k * e_nu2 * kSqrtPiInv;
  r.f = r.c_std >= 1.0f ? 1.0f : f;
  r.fp = half_1pe - 0.5f * nu * e_nu2 * kSqrtPiInv;
  r.sig = nrm * r.f;
  return r;
}

template <bool kBeck>
__device__ __forceinline__ void sigma_bwd(const Material& p, const Sigma& s,
                                          float gsig, float kx, float ky,
                                          float* acc) {
  float da, db, dc;
  if (kBeck) {
    // sigma = nrm * f(c/nrm): d/da = (a/nrm)(f - f' c_std); d/db likewise;
    // d/dc = c_std f + f' sin^2
    const float rad = s.f - s.fp * s.c_std;
    da = gsig * s.a * s.inv_nrm * rad;
    db = gsig * s.b * s.inv_nrm * rad;
    dc = gsig * (s.c_std * s.f + s.fp * s.sin2);
  } else {
    da = 0.5f * gsig * s.a * s.inv_nrm;
    db = 0.5f * gsig * s.b * s.inv_nrm;
    dc = 0.5f * gsig * (s.c * s.inv_nrm + 1.0f);
  }
  acc[1] += da * kx;
  acc[2] += ky * (da * p.rho + db * p.s);
  acc[3] += ky * p.ay * (da - db * p.rho * p.inv_s);
  acc[4] += -dc * kx;
  acc[5] += -dc * ky;
}

// Adds one sample's loss (without the 1/3) and its 8 gradient terms to acc.
template <bool kBeck>
__device__ __forceinline__ void accumulate(const Material& p, const Dir& d,
                                           float tr, float tg, float tb,
                                           float* acc) {
  const Sigma si = sigma<kBeck>(p, d.ix, d.iy, d.iz);
  const Sigma so = sigma<kBeck>(p, d.ox, d.oy, d.oz);
  const bool ok_i = si.c > 0.0f && fabsf(si.sig) >= 1e-12f;
  const bool ok_o = so.c > 0.0f && fabsf(so.sig) >= 1e-12f;
  const float inv_si = ok_i ? recip_nr(si.sig) : 0.0f;
  const float inv_so = ok_o ? recip_nr(so.sig) : 0.0f;
  const float g1i = d.iz * inv_si;
  const float g1o = d.oz * inv_so;
  const float tmp = g1i * g1o;
  const float den = g1i + g1o - tmp;
  const bool ok_g = tmp > 0.0f && fabsf(den) >= 1e-12f;
  const float inv_den = ok_g ? recip_nr(den) : 0.0f;
  const float g = tmp * inv_den;

  // D: slopes, affine warp, p22 (Gaussian for Beckmann, GGX otherwise)
  const float u = (d.bsx - p.txn) * p.inv_ax;
  const float v = (d.bsy - p.tyn) * p.inv_ay;
  const float y = (v - p.rho * u) * p.inv_s;
  const float r2 = u * u + y * y;
  float p22, q4;
  if (kBeck) {
    p22 = expf(-r2);
    q4 = 2.0f;
  } else {
    const float inv_t1 = recip_nr(1.0f + r2);
    p22 = inv_t1 * inv_t1;
    q4 = 4.0f * inv_t1;
  }
  const float dd = d.valid_h ? ((kInvPi * p.inv_axays) * d.inv_hz4) * p22 : 0.0f;

  const float inv_oz4 = (g > 0.0f && d.ok_oz) ? d.r_oz4 : 0.0f;
  const float base = dd * g * inv_oz4;

  // loss (per-sample sum over channels) + upstream weights
  const float inv_tr = recip_nr(tr + kEps);
  const float inv_tg = recip_nr(tg + kEps);
  const float inv_tb = recip_nr(tb + kEps);
  const float fr = p.f0r + d.c5 * (1.0f - p.f0r);
  const float fg = p.f0g + d.c5 * (1.0f - p.f0g);
  const float fb = p.f0b + d.c5 * (1.0f - p.f0b);
  const float rr = (fr * base - tr) * inv_tr;
  const float rg = (fg * base - tg) * inv_tg;
  const float rb = (fb * base - tb) * inv_tb;
  acc[0] += rr * rr + rg * rg + rb * rb;

  const float two_thirds = 2.0f * kThird;
  const float wr = two_thirds * rr * inv_tr;
  const float wg = two_thirds * rg * inv_tg;
  const float wb = two_thirds * rb * inv_tb;
  const float one_m_c5_base = (1.0f - d.c5) * base;
  acc[6] += wr * one_m_c5_base;
  acc[7] += wg * one_m_c5_base;
  acc[8] += wb * one_m_c5_base;

  const float gbase = wr * fr + wg * fg + wb * fb;
  const float gd = gbase * g * inv_oz4;   // dL/dD (inv_oz4 gates)
  const float gg = gbase * dd * inv_oz4;  // dL/dG

  // G path: dG/dg1 = (other/den)^2; dg1/dsigma = -g1/sigma
  const float ti = g1o * inv_den;
  const float to = g1i * inv_den;
  sigma_bwd<kBeck>(p, si, -gg * (ti * ti) * g1i * inv_si, d.ix, d.iy, acc);
  sigma_bwd<kBeck>(p, so, -gg * (to * to) * g1o * inv_so, d.ox, d.oy, acc);

  // D path: dD/dp = D * (-dlog(ax ay s)/dp - (q4/2) dr^2/dp)
  const float S = gd * dd;
  const float inv_s2 = p.inv_s * p.inv_s;
  acc[1] += S * p.inv_ax * (q4 * (u * u - y * p.rho * u * p.inv_s) - 1.0f);
  acc[2] += S * p.inv_ay * (q4 * y * v * p.inv_s - 1.0f);
  acc[3] += S * (p.rho * inv_s2 - q4 * y * (y * p.rho * inv_s2 - u * p.inv_s));
  acc[4] += S * q4 * p.inv_ax * (u - y * p.rho * p.inv_s);
  acc[5] += S * q4 * p.inv_ay * p.inv_s * y;
}

// ---- asynchronous copies into shared memory (cp.async, sm_80+)

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Copies this thread's kItems samples j0 .. j0+kItems-1 of one row: one
// 16-B copy where the span is aligned and in range, else one 4-B copy per
// live sample; a sample past the end gets `fill` instead.
__device__ __forceinline__ void copy_items(float* dst, const float* row,
                                           long long j0, long long n,
                                           float fill) {
  const float* src = row + j0;
  if (j0 + kItems <= n && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    cp_async16(dst, src);
    return;
  }
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    if (j0 + q < n)
      cp_async4(dst + q, src + q);
    else
      dst[q] = fill;
  }
}

struct Items {
  float v[kItems];
};

// This thread's kItems values of one shared-memory row.
__device__ __forceinline__ Items read_items(const float* s) {
  const float4 x = *reinterpret_cast<const float4*>(s);
  return Items{{x.x, x.y, x.z, x.w}};
}

struct Inputs {
  const float* pvecs;
  const float* dirs[6];  // ix, iy, iz, ox, oy, oz
  const float* tgts[3];  // tr, tg, tb
  long long n;
  int m;
};

// The sample that stands in for every sample past the end of a row: i =
// (0, 0, 1), o = -i (below the horizon) and zero targets. Every gate of
// `accumulate` closes on it (valid_h, ok_o, ok_g, g > 0), so each of its
// 9 terms is +0 or -0, and adding it leaves a sum unchanged bit for bit,
// for any material whose slope offsets txn/ax and tyn/ay square to a
// finite float. The tail then needs no branch, and the samples of a
// thread stay independent chains that the compiler can interleave.
__constant__ float kDeadDir[6] = {0.0f, 0.0f, 1.0f, 0.0f, 0.0f, -1.0f};

// Issues the copies of unit (tile u, material k) into ring stage `stage`:
// its 3 target rows and, when `with_dirs`, the tile's 6 direction rows.
// Always commits one group, so that every unit is one group.
__device__ __forceinline__ void issue_unit(const Inputs& in, float* ring,
                                           bool valid, int u, int k,
                                           int stage, bool with_dirs) {
  if (valid) {
    const long long j0 = static_cast<long long>(u) * kTile + threadIdx.x * kItems;
    float* st = ring + stage * (kRows * kTile) + threadIdx.x * kItems;
    const long long row = static_cast<long long>(k) * in.n;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      copy_items(st + c * kTile, in.tgts[c] + row, j0, in.n, 0.0f);
    if (with_dirs) {
#pragma unroll
      for (int c = 0; c < 6; ++c)
        copy_items(st + (3 + c) * kTile, in.dirs[c], j0, in.n, kDeadDir[c]);
    }
  }
  cp_async_commit();
}

// Sums the 9 terms of acc over the warp in a fixed order: the loss by a
// butterfly (every lane gets it), the 8 gradient terms by a
// reduce-scatter butterfly, in which each step sends half of the values
// a lane still holds to its partner and keeps the other half. Returns
// gradient term 1 + grad_slot(lane) in every lane: 9 shuffles instead of
// the 40 of a butterfly per term.
__device__ __forceinline__ int grad_slot(int lane) {
  return 4 * (lane & 1) + 2 * ((lane >> 1) & 1) + ((lane >> 2) & 1);
}

__device__ __forceinline__ float warp_sum_terms(const float* acc, int lane,
                                                float* loss) {
  float l = acc[0];
#pragma unroll
  for (int sh = 16; sh > 0; sh >>= 1) l += __shfl_xor_sync(0xffffffffu, l, sh);
  *loss = l;
  const bool b1 = lane & 1, b2 = lane & 2, b4 = lane & 4;
  float h[4], q[2];
#pragma unroll
  for (int j = 0; j < 4; ++j) {  // h[j]: term 1 + j + 4 b1
    const float send = b1 ? acc[1 + j] : acc[5 + j];
    const float keep = b1 ? acc[5 + j] : acc[1 + j];
    h[j] = keep + __shfl_xor_sync(0xffffffffu, send, 1);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {  // q[j]: term 1 + j + 2 b2 + 4 b1
    const float send = b2 ? h[j] : h[j + 2];
    const float keep = b2 ? h[j + 2] : h[j];
    q[j] = keep + __shfl_xor_sync(0xffffffffu, send, 2);
  }
  const float send = b4 ? q[0] : q[1];
  float r = (b4 ? q[1] : q[0]) + __shfl_xor_sync(0xffffffffu, send, 4);
  r += __shfl_xor_sync(0xffffffffu, r, 8);
  r += __shfl_xor_sync(0xffffffffu, r, 16);
  return r;
}

// The last CTA of a set of `members` CTAs to arrive on `ticket`: true in
// every thread of that CTA, which also resets the ticket for the next
// launch. Call after this CTA's global writes.
__device__ __forceinline__ bool last_to_arrive(unsigned* ticket,
                                               unsigned members,
                                               bool* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    *flag = atomicAdd(ticket, 1u) == members - 1;
    if (*flag) *ticket = 0u;
  }
  __syncthreads();
  if (!*flag) return false;
  __threadfence();
  return true;
}

template <bool kBeck>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
fused_fit_kernel(Inputs in, int ntiles, int acc_in_smem, int group,
                 double* __restrict__ partials,
                 unsigned* __restrict__ tickets, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  __shared__ Material mats[kChunk];
  __shared__ float red[kChunk][kWarps][kTerms];
  __shared__ float tsum[kChunk][kTerms];
  __shared__ bool flag;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int m = in.m;
  const int ncta = gridDim.x;
  const int nout = m * kTerms;

  // this CTA's slice of the (tile, material) units; its running sums in
  // double, behind the ring in shared memory or in its row of partials
  const long long work = static_cast<long long>(ntiles) * m;
  const long long e0 = work * blockIdx.x / ncta;
  const int count = static_cast<int>(work * (blockIdx.x + 1) / ncta - e0);
  double* prow = partials + static_cast<long long>(blockIdx.x) * nout;
  double* sums = acc_in_smem ? reinterpret_cast<double*>(ring + kRingBytes / 4)
                             : prow;
  for (int o = tid; o < nout; o += kBlock) sums[o] = 0.0;

  // prefetch cursor: the next unit to issue (tiles and units fit in int)
  int pu = static_cast<int>(e0 / m);
  int pk = static_cast<int>(e0 - static_cast<long long>(pu) * m);
  int pi = 0;
  auto issue_next = [&]() {
    issue_unit(in, ring, pi < count, pu, pk, pi % kStages, pk == 0 || pi == 0);
    ++pi;
    if (++pk == m) {
      pk = 0;
      ++pu;
    }
  };
  int ck = pk;  // the material of the unit being computed
#pragma unroll 1
  for (int s = 0; s < kStages - 1; ++s) issue_next();

  // The units go in chunks of kChunk. A chunk starts with its materials'
  // scalars in shared memory and the previous chunk's sums added to the
  // running sums, while the other warps go on; it ends with each unit's
  // float sum over the CTA. Unit kk of a chunk that starts at material k0
  // is of material (k0 + kk) mod m: thread (j, c) adds term c of units j,
  // j + m, j + 2m, ... (all those of one material) in unit order.
  auto add_chunk = [&](int k0, int units) {
    if (tid < min(m, units) * kTerms) {
      const int j = tid / kTerms;
      const int c = tid - j * kTerms;
      double* s = sums + (k0 + j < m ? k0 + j : k0 + j - m) * kTerms + c;
      double v = *s;
      for (int kk = j; kk < units; kk += m)
        v += static_cast<double>(tsum[kk][c]);
      *s = v;
    }
  };
  Dir dir[kItems];
  int kprev = 0, nprev = 0;
#pragma unroll 1
  for (int c0 = 0; c0 < count; c0 += kChunk) {
    const int cn = min(kChunk, count - c0);
    if (tid < cn) mats[tid] = load_material(in.pvecs + 8 * ((ck + tid) % m));
    __syncthreads();
    add_chunk(kprev, nprev);
    kprev = ck;
    nprev = cn;
#pragma unroll 1
    for (int j = 0; j < cn; ++j) {
      const int i = c0 + j;
      issue_next();
      cp_async_wait<kStages - 1>();  // unit i has landed (this thread's part)
      const float* st = ring + (i % kStages) * (kRows * kTile) + tid * kItems;
      if (ck == 0 || i == 0) {
        // the tile's directions: loaded once, reused for every material
        Items c[6];
#pragma unroll
        for (int a = 0; a < 6; ++a) c[a] = read_items(st + (3 + a) * kTile);
#pragma unroll
        for (int q = 0; q < kItems; ++q)
          dir[q] = load_dir(c[0].v[q], c[1].v[q], c[2].v[q], c[3].v[q],
                            c[4].v[q], c[5].v[q]);
      }
      const Material p = mats[j];
      const Items t0 = read_items(st);
      const Items t1 = read_items(st + kTile);
      const Items t2 = read_items(st + 2 * kTile);
      float acc[kTerms];
#pragma unroll
      for (int c = 0; c < kTerms; ++c) acc[c] = 0.0f;
#pragma unroll
      for (int q = 0; q < kItems; ++q)
        accumulate<kBeck>(p, dir[q], t0.v[q], t1.v[q], t2.v[q], acc);
      float loss;
      const float g = warp_sum_terms(acc, lane, &loss);
      if (lane < 8) red[j][warp][1 + grad_slot(lane)] = g;
      if (lane == 0) red[j][warp][0] = loss;
      if (++ck == m) ck = 0;
    }
    __syncthreads();
    for (int t = tid; t < cn * kTerms; t += kBlock) {
      const int kk = t / kTerms;
      const int c = t - kk * kTerms;
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += red[kk][w][c];
      tsum[kk][c] = c == 0 ? kThird * s : s;
    }
  }
  __syncthreads();
  add_chunk(kprev, nprev);
  cp_async_wait<0>();
  if (acc_in_smem) {
    __syncthreads();
    for (int o = tid; o < nout; o += kBlock) prow[o] = sums[o];
  }

  // epilogue, level 1: the last CTA of this group sums the group's rows
  const int grp = blockIdx.x / group;
  const int first = grp * group;
  const int members = min(group, ncta - first);
  if (!last_to_arrive(tickets + grp, members, &flag)) return;
  const int ngroups = (ncta + group - 1) / group;
  double* grow = partials + static_cast<long long>(ncta + grp) * nout;
  for (int o = tid; o < nout; o += kBlock) {
    double s = 0.0;
    for (int b = 0; b < members; ++b)
      s += __ldcg(partials + static_cast<long long>(first + b) * nout + o);
    grow[o] = s;
  }
  // level 2: the last group sums the group rows into out
  if (!last_to_arrive(tickets + ngroups, ngroups, &flag)) return;
  for (int o = tid; o < nout; o += kBlock) {
    double s = 0.0;
    for (int b = 0; b < ngroups; ++b)
      s += __ldcg(partials + static_cast<long long>(ncta + b) * nout + o);
    out[o] = static_cast<float>(s);
  }
}

// The resident CTAs per SM of one family with `smem` bytes of dynamic
// shared memory, after raising its limit to the device's opt-in maximum.
template <bool kBeck>
cudaError_t occupancy(int device, int smem, int* ctas_per_sm) {
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fused_fit_kernel<kBeck>);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fused_fit_kernel<kBeck>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin - static_cast<int>(attr.sharedSizeBytes));
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, fused_fit_kernel<kBeck>, kBlock, smem);
}

// Dynamic shared memory of a CTA: the ring, and the running sums of m
// materials where they are kept there.
int smem_bytes(int m, int acc_in_smem) {
  return kRingBytes +
         (acc_in_smem ? static_cast<int>(sizeof(double)) * kTerms * m : 0);
}

}  // namespace

extern "C" {

// Samples per direction tile.
int djbt_fused_fit_tile() { return kTile; }

const char* djbt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Resident CTAs per SM of family (0 = GGX, 1 = Beckmann) on `device` for
// m materials: with the running sums in global memory (ctas) and in
// shared memory (ctas_sums_in_smem, 0 where they do not fit). Also sets
// the kernel's shared-memory limit there, so call it on a device before
// the first launch. Returns the CUDA error (0 on success).
int djbt_fused_fit_occupancy(int device, int family, int m, int* ctas,
                             int* ctas_sums_in_smem) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (family != 0 && family != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t (*query)(int, int, int*) =
      family == 0 ? &occupancy<false> : &occupancy<true>;
  err = query(device, smem_bytes(m, 0), ctas);
  if (err != cudaSuccess) return static_cast<int>(err);
  *ctas_sums_in_smem = 0;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err == cudaSuccess && static_cast<long long>(kRingBytes) +
                                    8LL * kTerms * m <= optin)
    err = query(device, smem_bytes(m, 1), ctas_sums_in_smem);
  return static_cast<int>(err);
}

// device: the CUDA device of every pointer and of `stream`. family: 0 =
// GGX, 1 = Beckmann. pvecs (m, 8); ix..oz (n); tr, tg, tb (m, n), all
// float32 and contiguous. The schedule (ops/fused_fit.py::launch_schedule):
// grid CTAs; acc_in_smem (1: the running sums in shared memory); `group`
// CTAs per epilogue group. partials: float64 (grid + groups, m*9);
// tickets: (groups + 1) uint32, zero before the first launch and left
// zero by each; out (m, 9) = [loss_sum, grad_sum(8)]. Returns the CUDA
// error of the launch (0 on success).
int djbt_fused_fit(int device, int family, const void* pvecs, const void* ix,
                   const void* iy, const void* iz, const void* ox,
                   const void* oy, const void* oz, const void* tr,
                   const void* tg, const void* tb, long long n, int m,
                   int grid, int acc_in_smem, int group, void* partials,
                   void* tickets, void* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long ntiles = (n + kTile - 1) / kTile;
  if (grid < 1 || group < 1 || m < 1 || n < 1 || ntiles * m > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  Inputs in{f(pvecs), {f(ix), f(iy), f(iz), f(ox), f(oy), f(oz)},
            {f(tr), f(tg), f(tb)}, n, m};
  double* part = static_cast<double*>(partials);
  unsigned* tick = static_cast<unsigned*>(tickets);
  float* o = static_cast<float*>(out);
  const int nt = static_cast<int>(ntiles);
  const int smem = smem_bytes(m, acc_in_smem);
  if (family == 0) {
    fused_fit_kernel<false><<<grid, kBlock, smem, s>>>(in, nt, acc_in_smem,
                                                       group, part, tick, o);
  } else if (family == 1) {
    fused_fit_kernel<true><<<grid, kBlock, smem, s>>>(in, nt, acc_in_smem,
                                                      group, part, tick, o);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
