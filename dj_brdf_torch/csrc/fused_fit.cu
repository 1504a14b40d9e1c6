// Fused fit step for Hopper (sm_90a): the relative-L2 loss of the GGX or
// Beckmann + Schlick microfacet BRDF and its hand-written gradient w.r.t.
// the 8 constrained parameters [ax, ay, rho, txn, tyn, f0r, f0g, f0b], for
// M materials fitted against one shared set of N direction pairs.
//
// Replaces dj_brdf_tpu/ops/fused_fit.py::_kernel_hand, the Pallas body
// behind ggx_lsq_value_and_grad (single material) and
// ggx_lsq_value_and_grad_batched (M materials), for both families. A
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
// What bounds it on an H100: per sample, 24 B of directions (read once for
// all materials); per sample and material, 12 B of targets against roughly
// 200-300 f32 flop-equivalents (more for Beckmann: five exps and two erf
// polynomials). At 67 TFLOP/s of f32 and 3.35 TB/s that is ~20 flop/B of
// balance, so the step sits near both roofs and is compute-heavy for
// Beckmann. The design therefore (1) loads each CTA's direction tile into
// registers once, with the material-independent terms (half vector,
// slopes, cos^4, Schlick c5, 1/(4 o.z)) precomputed, and loops over all M
// materials inside the CTA, so directions cost 24 B/sample in total;
// (2) streams the targets exactly once, coalesced, with 64-bit offsets
// k*N + j (M*N exceeds 2^31 at MERL scale); (3) reduces the 9 per-sample
// terms (loss + 8 gradients) in registers, then by warp shuffles and
// shared memory, into partials (nblocks, M, 9); and (4) sums the partials
// in a second kernel, one CTA per material, in a fixed order in double,
// so the loss is the same from run to run (no float atomics). The ragged
// tail is masked, not padded. Register budget: kItems = 4 samples per
// thread keeps the tile at ~44 live floats per thread; -Xptxas -v at
// build time reports registers and spills (see ops/_build.py).
//
// The kernel allocates nothing and does not synchronise: the caller passes
// the partials and output buffers and PyTorch's current stream, and each
// launch's cudaGetLastError() is returned to it.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr int kItems = 4;
constexpr int kTile = kBlock * kItems;
constexpr int kWarps = kBlock / 32;
constexpr int kTerms = 9;   // loss + 8 gradient components
constexpr int kChunk = 16;  // materials reduced per shared-memory round

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

struct Material {
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

__device__ __forceinline__ Dir load_dir(const float* __restrict__ ix,
                                        const float* __restrict__ iy,
                                        const float* __restrict__ iz,
                                        const float* __restrict__ ox,
                                        const float* __restrict__ oy,
                                        const float* __restrict__ oz,
                                        long long j) {
  Dir d;
  d.ix = __ldg(ix + j);
  d.iy = __ldg(iy + j);
  d.iz = __ldg(iz + j);
  d.ox = __ldg(ox + j);
  d.oy = __ldg(oy + j);
  d.oz = __ldg(oz + j);
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

template <bool kBeck>
__global__ void __launch_bounds__(kBlock)
fused_fit_pass1(const float* __restrict__ pvecs, const float* __restrict__ ix,
                const float* __restrict__ iy, const float* __restrict__ iz,
                const float* __restrict__ ox, const float* __restrict__ oy,
                const float* __restrict__ oz, const float* __restrict__ tr,
                const float* __restrict__ tg, const float* __restrict__ tb,
                long long n, int m, float* __restrict__ partials) {
  __shared__ float red[kChunk][kWarps][kTerms];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long tile0 = static_cast<long long>(blockIdx.x) * kTile;

  // the direction tile: loaded once, reused for every material
  Dir dir[kItems];
  bool live[kItems];
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const long long j = tile0 + it * kBlock + tid;
    live[it] = j < n;
    if (live[it]) dir[it] = load_dir(ix, iy, iz, ox, oy, oz, j);
  }

  for (int k0 = 0; k0 < m; k0 += kChunk) {
    const int kn = min(kChunk, m - k0);
    for (int kk = 0; kk < kn; ++kk) {
      const int k = k0 + kk;
      const Material p = load_material(pvecs + 8 * static_cast<long long>(k));
      const long long row = static_cast<long long>(k) * n;
      float acc[kTerms];
#pragma unroll
      for (int c = 0; c < kTerms; ++c) acc[c] = 0.0f;
#pragma unroll
      for (int it = 0; it < kItems; ++it) {
        if (!live[it]) continue;
        const long long off = row + tile0 + it * kBlock + tid;
        accumulate<kBeck>(p, dir[it], __ldg(tr + off), __ldg(tg + off),
                          __ldg(tb + off), acc);
      }
#pragma unroll
      for (int c = 0; c < kTerms; ++c) {
#pragma unroll
        for (int sh = 16; sh > 0; sh >>= 1)
          acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], sh);
      }
      if (lane == 0) {
#pragma unroll
        for (int c = 0; c < kTerms; ++c) red[kk][warp][c] = acc[c];
      }
    }
    __syncthreads();
    for (int t = tid; t < kn * kTerms; t += kBlock) {
      const int kk = t / kTerms;
      const int c = t - kk * kTerms;
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += red[kk][w][c];
      const long long out = (static_cast<long long>(blockIdx.x) * m + k0 + kk) * kTerms + c;
      partials[out] = c == 0 ? kThird * s : s;
    }
    __syncthreads();
  }
}

// One CTA per material: sums that material's partials over the pass-1
// blocks in a fixed order, in double.
__global__ void __launch_bounds__(kBlock)
fused_fit_pass2(const float* __restrict__ partials, int nblocks, int m,
                float* __restrict__ out) {
  __shared__ double red[kWarps][kTerms];
  const int k = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  double acc[kTerms];
#pragma unroll
  for (int c = 0; c < kTerms; ++c) acc[c] = 0.0;
  for (int b = tid; b < nblocks; b += kBlock) {
    const float* row = partials + (static_cast<long long>(b) * m + k) * kTerms;
#pragma unroll
    for (int c = 0; c < kTerms; ++c) acc[c] += row[c];
  }
#pragma unroll
  for (int c = 0; c < kTerms; ++c) {
#pragma unroll
    for (int sh = 16; sh > 0; sh >>= 1)
      acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], sh);
  }
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < kTerms; ++c) red[warp][c] = acc[c];
  }
  __syncthreads();
  if (tid < kTerms) {
    double s = 0.0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][tid];
    out[static_cast<long long>(k) * kTerms + tid] = static_cast<float>(s);
  }
}

}  // namespace

extern "C" {

// Samples per pass-1 CTA: the caller sizes partials as
// (ceil(n / tile), m, 9).
int djbt_fused_fit_tile(void) { return kTile; }

const char* djbt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// device: the CUDA device of every pointer and of `stream`. family: 0 =
// GGX, 1 = Beckmann. pvecs (m, 8); ix..oz (n); tr, tg, tb (m, n);
// partials (nblocks, m, 9); out (m, 9) = [loss_sum, grad_sum(8)]. All
// float32 and contiguous. Returns the CUDA error of the launches (0 on
// success).
int djbt_fused_fit(int device, int family, const void* pvecs, const void* ix,
                   const void* iy, const void* iz, const void* ox,
                   const void* oy, const void* oz, const void* tr,
                   const void* tg, const void* tb, long long n, int m,
                   int nblocks, void* partials, void* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  float* part = static_cast<float*>(partials);
  if (family == 0) {
    fused_fit_pass1<false><<<nblocks, kBlock, 0, s>>>(
        f(pvecs), f(ix), f(iy), f(iz), f(ox), f(oy), f(oz), f(tr), f(tg),
        f(tb), n, m, part);
  } else if (family == 1) {
    fused_fit_pass1<true><<<nblocks, kBlock, 0, s>>>(
        f(pvecs), f(ix), f(iy), f(iz), f(ox), f(oy), f(oz), f(tr), f(tg),
        f(tb), n, m, part);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_fit_pass2<<<m, kBlock, 0, s>>>(part, nblocks, m,
                                       static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
