// The autodiff cross-check of the fit step for Hopper (sm_90a): the
// relative-L2 loss of the GGX + Schlick microfacet BRDF against one
// material's targets, summed over N direction pairs, with its gradient
// w.r.t. the 8 constrained parameters [ax, ay, rho, txn, tyn, f0r, f0g, f0b]
// derived by forward-mode automatic differentiation.
//
// Replaces dj_brdf_tpu/ops/fused_fit.py::_kernel_ad, the Pallas body behind
// ggx_lsq_value_and_grad(..., adjoint="ad"), which takes jax.vjp of
// dj_brdf_tpu/ops/soa.py::ggx_lsq_loss_soa inside the kernel. Its purpose is
// to derive the gradient a second way, independently of the hand-written
// adjoint of csrc/fused_fit.cu (K1), so it shares no code with it. Every
// value is a Dual: a float and its 8 tangents d/d pvec[k]. The 8 parameters
// are seeded with unit tangents, the samples and targets are constants, and
// the loss is written once over Dual, following soa.py::ggx_evalp_soa
// (:22-108) and ggx_lsq_loss_soa (:213-221) line by line: the same 1e-24
// floor under sqrt(1 - rho^2) and the half-vector rsqrt, the same 1e-12
// gates, valid_h = hz > 1e-4, the clip of cos(theta_d). Values are divided
// exactly (no rcp.approx, unlike K1): the JAX kernel calls the loss without
// recip. The tangents of a divide or a sqrt take one exact reciprocal of
// the divisor, (a' - (a/b) b') * (1/b), where nine exact divides would
// repeat it: they differ from a divide per tangent by an ulp or two, far
// inside the gradient tolerances (rtol 3e-4). Selects and gates test the
// value only, so a gated sample adds exactly 0 to every tangent. The plain
// version this kernel is held against is torch.autograd of
// dj_brdf_torch/ops/soa.py::ggx_lsq_loss_soa.
//
// Where forward and reverse mode may differ: at an exact tie of a max or a
// clip, JAX's VJP splits the cotangent between the two branches, while a
// forward-mode select takes one. The only such ties here are rho = +-1 (the
// 1e-24 floor) and samples exactly on a gate; random directions miss them.
//
// What bounds it on an H100: per sample, 36 B read (six direction and
// three target components) against ~1,000-1,700 f32 operations (each Dual
// operation does the value and 8 tangents): ~40 operations per byte, far
// above the 3.35 TB/s balance, so the kernel is compute-bound, and with
// one exact divide per tangent (88 per sample) it stalled on their
// dependent reciprocal-refinement chains. The design: one reciprocal per
// divisor (above); the per-material Duals computed once per thread, from
// unit seeds whose zero tangents the compiler folds away; one persistent
// launch of as many CTAs as the card holds, each walking an even,
// contiguous share of the 256-sample units, one sample per thread per
// unit (only one sample's Duals live at a time). A thread sums its terms
// (loss + 8 tangents) in float over kFlush units, then in double; the CTA
// reduces them in a fixed order into its row of partials, and the last
// CTA to arrive (an integer ticket) sums the rows in a fixed order in
// double. So one launch per call, and the same bits from run to run (no
// float atomics). The ragged tail is masked in-kernel, not padded.
// -Xptxas -v at build time reports registers and spills (see
// ops/_build.py).
//
// The kernel allocates nothing and does not synchronise: the caller passes
// the partials, ticket and output buffers and PyTorch's current stream,
// and the launch's cudaGetLastError() is returned to it.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;    // also the samples of one unit
constexpr int kMinBlocks = 2;  // resident CTAs per SM: 128 registers each
constexpr int kFlush = 4;      // units summed in float before double
constexpr int kWarps = kBlock / 32;
constexpr int kP = 8;       // tangents: one per constrained parameter
constexpr int kTerms = 9;   // loss + 8 gradient components

constexpr float kEps = 1e-2f;
constexpr float kInvPi = 0.318309886183790671538f;

// A value with its derivatives w.r.t. the 8 parameters.
struct Dual {
  float v;
  float d[kP];
};

__device__ __forceinline__ Dual constant(float v) {
  Dual r;
  r.v = v;
#pragma unroll
  for (int k = 0; k < kP; ++k) r.d[k] = 0.0f;
  return r;
}

__device__ __forceinline__ Dual seed(float v, int slot) {
  Dual r = constant(v);
  r.d[slot] = 1.0f;
  return r;
}

__device__ __forceinline__ Dual operator+(const Dual& a, const Dual& b) {
  Dual r;
  r.v = a.v + b.v;
#pragma unroll
  for (int k = 0; k < kP; ++k) r.d[k] = a.d[k] + b.d[k];
  return r;
}

__device__ __forceinline__ Dual operator+(const Dual& a, float b) {
  Dual r = a;
  r.v = a.v + b;
  return r;
}

__device__ __forceinline__ Dual operator+(float a, const Dual& b) {
  return b + a;
}

__device__ __forceinline__ Dual operator-(const Dual& a) {
  Dual r;
  r.v = -a.v;
#pragma unroll
  for (int k = 0; k < kP; ++k) r.d[k] = -a.d[k];
  return r;
}

__device__ __forceinline__ Dual operator-(const Dual& a, const Dual& b) {
  Dual r;
  r.v = a.v - b.v;
#pragma unroll
  for (int k = 0; k < kP; ++k) r.d[k] = a.d[k] - b.d[k];
  return r;
}

__device__ __forceinline__ Dual operator-(const Dual& a, float b) {
  Dual r = a;
  r.v = a.v - b;
  return r;
}

__device__ __forceinline__ Dual operator-(float a, const Dual& b) {
  Dual r;
  r.v = a - b.v;
#pragma unroll
  for (int k = 0; k < kP; ++k) r.d[k] = -b.d[k];
  return r;
}

__device__ __forceinline__ Dual operator*(const Dual& a, const Dual& b) {
  Dual r;
  r.v = a.v * b.v;
#pragma unroll
  for (int k = 0; k < kP; ++k) r.d[k] = a.d[k] * b.v + a.v * b.d[k];
  return r;
}

__device__ __forceinline__ Dual operator*(const Dual& a, float b) {
  Dual r;
  r.v = a.v * b;
#pragma unroll
  for (int k = 0; k < kP; ++k) r.d[k] = a.d[k] * b;
  return r;
}

__device__ __forceinline__ Dual operator*(float a, const Dual& b) {
  return b * a;
}

// a / b: the value by an exact divide, the tangents by one exact
// reciprocal, (a' - (a/b) b') * (1/b)
__device__ __forceinline__ Dual operator/(const Dual& a, const Dual& b) {
  Dual r;
  r.v = a.v / b.v;
  const float rb = 1.0f / b.v;
#pragma unroll
  for (int k = 0; k < kP; ++k) r.d[k] = (a.d[k] - r.v * b.d[k]) * rb;
  return r;
}

__device__ __forceinline__ Dual operator/(const Dual& a, float b) {
  Dual r;
  r.v = a.v / b;
  const float rb = 1.0f / b;
#pragma unroll
  for (int k = 0; k < kP; ++k) r.d[k] = a.d[k] * rb;
  return r;
}

__device__ __forceinline__ Dual operator/(float a, const Dual& b) {
  Dual r;
  r.v = a / b.v;
  const float rb = 1.0f / b.v;
#pragma unroll
  for (int k = 0; k < kP; ++k) r.d[k] = -r.v * b.d[k] * rb;
  return r;
}

__device__ __forceinline__ Dual dsqrt(const Dual& x) {
  Dual r;
  r.v = sqrtf(x.v);
  const float h = 1.0f / (2.0f * r.v);
#pragma unroll
  for (int k = 0; k < kP; ++k) r.d[k] = x.d[k] * h;
  return r;
}

// max(x, c) for a constant c: the select takes x's tangents above c
__device__ __forceinline__ Dual dmax(const Dual& x, float c) {
  return x.v > c ? x : constant(c);
}

__device__ __forceinline__ Dual select(bool cond, const Dual& a,
                                       const Dual& b) {
  return cond ? a : b;
}

// The per-material Duals of ggx_evalp_soa, computed once per thread.
struct Material {
  Dual ax, ay, rho, txn, tyn, f0r, f0g, f0b;
  Dual s, inv_ax, inv_axays, ay_rho, ay_s;
};

__device__ __forceinline__ Material load_material(const float* __restrict__ p) {
  Material m;
  m.ax = seed(__ldg(p + 0), 0);
  m.ay = seed(__ldg(p + 1), 1);
  m.rho = seed(__ldg(p + 2), 2);
  m.txn = seed(__ldg(p + 3), 3);
  m.tyn = seed(__ldg(p + 4), 4);
  m.f0r = seed(__ldg(p + 5), 5);
  m.f0g = seed(__ldg(p + 6), 6);
  m.f0b = seed(__ldg(p + 7), 7);
  m.s = dsqrt(dmax(1.0f - m.rho * m.rho, 1e-24f));
  m.inv_ax = 1.0f / m.ax;
  m.inv_axays = 1.0f / (m.ax * m.ay * m.s);
  m.ay_rho = m.ay * m.rho;
  m.ay_s = m.ay * m.s;
  return m;
}

// warp + closed-form GGX sigma_std: sigma = (|warp(k)| + c) / 2; also c
__device__ __forceinline__ void sigma(const Material& m, float kx, float ky,
                                      float kz, Dual* sig, Dual* c) {
  const Dual a = kx * m.ax + ky * m.ay_rho;
  const Dual b = ky * m.ay_s;
  *c = kz - kx * m.txn - ky * m.tyn;
  const Dual nrm = dsqrt(a * a + b * b + *c * *c);
  *sig = (nrm + *c) * 0.5f;
}

// Smith G1 = k.z / sigma(k), gated as in ggx_evalp_soa
__device__ __forceinline__ Dual g1(float kz, const Dual& sig, const Dual& c) {
  const bool ok = c.v > 0.0f && fabsf(sig.v) >= 1e-12f;
  return ok ? constant(kz) / sig : constant(0.0f);
}

// One sample's relative-L2 term lr^2 + lg^2 + lb^2 (without the 1/3) with
// its tangents, added to acc.
__device__ __forceinline__ void accumulate(const Material& m, float ix,
                                           float iy, float iz, float ox,
                                           float oy, float oz, float tr,
                                           float tg, float tb, float* acc) {
  float hx = ix + ox, hy = iy + oy, hz = iz + oz;
  const float hn = rsqrtf(fmaxf(hx * hx + hy * hy + hz * hz, 1e-24f));
  hx *= hn;
  hy *= hn;
  hz *= hn;

  Dual si, ci, so, co;
  sigma(m, ix, iy, iz, &si, &ci);
  sigma(m, ox, oy, oz, &so, &co);
  const Dual g1i = g1(iz, si, ci);
  const Dual g1o = g1(oz, so, co);
  const Dual tmp = g1i * g1o;
  const Dual den = g1i + g1o - tmp;
  const Dual g = select(tmp.v > 0.0f && fabsf(den.v) >= 1e-12f, tmp / den,
                        constant(0.0f));

  // ndf: slopes, affine warp, GGX p22
  const bool valid_h = hz > 1e-4f;
  const float inv_hz = 1.0f / (valid_h ? hz : 1.0f);
  const Dual sx = -hx * inv_hz - m.txn;
  const Dual sy = -hy * inv_hz - m.tyn;
  const Dual x_ = sx * m.inv_ax;
  const Dual y_ = (m.ax * sy - m.ay_rho * sx) * m.inv_axays;
  const Dual r2 = x_ * x_ + y_ * y_;
  const Dual t1 = 1.0f + r2;
  const float inv_hz2 = inv_hz * inv_hz;
  const Dual d_num = (kInvPi * m.inv_axays) * (inv_hz2 * inv_hz2);
  const Dual d = select(valid_h, d_num / (t1 * t1), constant(0.0f));

  const float cosd = fminf(fmaxf(ox * hx + oy * hy + oz * hz, 0.0f), 1.0f);
  const float c1 = 1.0f - cosd;
  const float c2 = c1 * c1;
  const float c5 = c2 * c2 * c1;

  const float oz4 = 4.0f * oz;
  const Dual base = select(g.v > 0.0f && fabsf(oz4) >= 1e-12f, d * g / oz4,
                           constant(0.0f));
  const Dual lr = ((m.f0r + c5 * (1.0f - m.f0r)) * base - tr) / (tr + kEps);
  const Dual lg = ((m.f0g + c5 * (1.0f - m.f0g)) * base - tg) / (tg + kEps);
  const Dual lb = ((m.f0b + c5 * (1.0f - m.f0b)) * base - tb) / (tb + kEps);
  const Dual l = lr * lr + lg * lg + lb * lb;
  acc[0] += l.v;
#pragma unroll
  for (int k = 0; k < kP; ++k) acc[1 + k] += l.d[k];
}

// The last CTA of the grid to arrive on `ticket`: true in every thread of
// that CTA, which also resets the ticket for the next launch. Call after
// this CTA's global writes.
__device__ __forceinline__ bool last_to_arrive(unsigned* ticket, bool* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    *flag = atomicAdd(ticket, 1u) == gridDim.x - 1;
    if (*flag) *ticket = 0u;
  }
  __syncthreads();
  if (!*flag) return false;
  __threadfence();
  return true;
}

// CTA b walks units [units * b / grid, units * (b + 1) / grid), unit u
// being samples [u * kBlock, (u + 1) * kBlock); its row of partials holds
// its 9 sums in double; the last CTA to arrive sums the rows into out.
__global__ void __launch_bounds__(kBlock, kMinBlocks)
fused_fit_ad_kernel(const float* __restrict__ pvec,
                    const float* __restrict__ ix, const float* __restrict__ iy,
                    const float* __restrict__ iz, const float* __restrict__ ox,
                    const float* __restrict__ oy, const float* __restrict__ oz,
                    const float* __restrict__ tr, const float* __restrict__ tg,
                    const float* __restrict__ tb, long long n,
                    double* __restrict__ partials,
                    unsigned* __restrict__ ticket, float* __restrict__ out) {
  __shared__ double red[kWarps][kTerms];
  __shared__ bool flag;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long units = (n + kBlock - 1) / kBlock;
  const long long u0 = units * blockIdx.x / gridDim.x;
  const long long u1 = units * (blockIdx.x + 1) / gridDim.x;
  const Material m = load_material(pvec);

  float acc[kTerms];
  double dacc[kTerms];
#pragma unroll
  for (int c = 0; c < kTerms; ++c) {
    acc[c] = 0.0f;
    dacc[c] = 0.0;
  }
  int held = 0;  // units summed in acc
#pragma unroll 1
  for (long long u = u0; u < u1; ++u) {
    const long long j = u * kBlock + tid;
    if (j < n) {  // the ragged tail: masked, not padded
      accumulate(m, __ldg(ix + j), __ldg(iy + j), __ldg(iz + j),
                 __ldg(ox + j), __ldg(oy + j), __ldg(oz + j), __ldg(tr + j),
                 __ldg(tg + j), __ldg(tb + j), acc);
    }
    if (++held == kFlush || u + 1 == u1) {
#pragma unroll
      for (int c = 0; c < kTerms; ++c) {
        dacc[c] += acc[c];
        acc[c] = 0.0f;
      }
      held = 0;
    }
  }
#pragma unroll
  for (int c = 0; c < kTerms; ++c) {
#pragma unroll
    for (int sh = 16; sh > 0; sh >>= 1)
      dacc[c] += __shfl_xor_sync(0xffffffffu, dacc[c], sh);
  }
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < kTerms; ++c) red[warp][c] = dacc[c];
  }
  __syncthreads();
  if (tid < kTerms) {
    double s = 0.0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][tid];
    partials[static_cast<long long>(blockIdx.x) * kTerms + tid] = s;
  }

  if (!last_to_arrive(ticket, &flag)) return;
  // warp w sums terms w and w + kWarps over the rows: lane l the rows
  // l, l + 32, ..., then a fixed shuffle tree
  for (int c = warp; c < kTerms; c += kWarps) {
    double s = 0.0;
    for (int b = lane; b < static_cast<int>(gridDim.x); b += 32)
      s += __ldcg(partials + static_cast<long long>(b) * kTerms + c);
#pragma unroll
    for (int sh = 16; sh > 0; sh >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, sh);
    // the loss is the channel mean: (lr^2 + lg^2 + lb^2) / 3
    if (lane == 0) out[c] = static_cast<float>(s / 3.0);
  }
}

}  // namespace

extern "C" {

// Samples per unit of work: a CTA walks a contiguous run of units.
int djbt_fused_fit_ad_unit(void) { return kBlock; }

const char* djbt_fused_fit_ad_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Resident CTAs per SM of the kernel on `device` (its grid is this times
// the SM count at most). Returns the CUDA error (0 on success).
int djbt_fused_fit_ad_occupancy(int device, int* ctas_per_sm) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, fused_fit_ad_kernel, kBlock, 0));
}

// device: the CUDA device of every pointer and of `stream`. pvec (8);
// ix..oz, tr, tg, tb (n), float32 and contiguous; grid CTAs, 1 <= grid <=
// ceil(n / unit); partials: float64 (grid, 9); ticket: one uint32, zero
// before the launch and left zero by it; out (9) float32 = [loss_sum,
// grad_sum(8)]. Returns the CUDA error of the launch (0 on success).
int djbt_fused_fit_ad(int device, const void* pvec, const void* ix,
                      const void* iy, const void* iz, const void* ox,
                      const void* oy, const void* oz, const void* tr,
                      const void* tg, const void* tb, long long n, int grid,
                      void* partials, void* ticket, void* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n < 1 || grid < 1 || grid > (n + kBlock - 1) / kBlock)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  fused_fit_ad_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      f(pvec), f(ix), f(iy), f(iz), f(ox), f(oy), f(oz), f(tr), f(tg), f(tb),
      n, static_cast<double*>(partials), static_cast<unsigned*>(ticket),
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
