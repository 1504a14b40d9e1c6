// K5 designs that were measured and not kept (see scripts/
// gather_designs.py): the kept kernel, one position a thread through L2,
// is dj_brdf_torch/csrc/merl_gather.cu. Each design here computes K5,
// out[n] = plane[clip(idx[n])], bit for bit; the script holds each
// against plane[idx] and times it against the kept kernel.
//
//   persistent  a persistent grid of resident CTAs; a thread takes groups
//               of four positions (one 16-B index load, a scalar head and
//               tail) and keeps kGroups groups in flight; indices read and
//               outputs written evict-first (__ldcs, __stcs).
//   mixed       the plane's first `held` entries in the shared memory of
//               every thread-block cluster (C CTAs of 1024 threads, one an
//               SM), filled by bulk copies of the tensor memory accelerator
//               while each thread's first step gathers through L2; after
//               it a thread serves an index below `held` by a load over the
//               cluster (ld.shared::cluster), any other through L2.
//   helpers     the same held share, but the two kinds of load in separate
//               warps: a lead warp gathers the entries not held through L2
//               and hands the held ones (compacted) to a helper warp, which
//               loads them over the cluster; two chunks in flight a pair.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlock = 256;     // persistent
constexpr int kGroups = 2;      // persistent: groups of 4 in flight a thread
constexpr int kBlockB = 1024;   // mixed, helpers: one CTA an SM
constexpr int kLeads = 16;      // helpers: lead warps of a CTA; as many helpers
constexpr int kChunk = 256;     // helpers: positions a lead takes at a time
constexpr int kRing = 2;        // helpers: chunks of a lead in flight
constexpr int kGranule = 1024;  // plane entries a CTA holds in a row

__device__ __forceinline__ long long clip(long long i, long long hi) {
  return i < 0 ? 0 : (i > hi ? hi : i);
}

// The four flat indices k[0..3] of positions j0 .. j0 + 3, -1 for a
// position outside [0, n). `idx - skew` is 16-B aligned, so a group whose
// four positions all lie in range is one vector load.
struct Flat {
  const int* idx;
  long long hi;  // plane length - 1

  __device__ __forceinline__ void load4(long long j0, long long n,
                                        long long k[4]) const {
    if (j0 >= 0 && j0 + 3 < n) {
      const int4 v = __ldcs(reinterpret_cast<const int4*>(idx + j0));
      k[0] = clip(v.x, hi);
      k[1] = clip(v.y, hi);
      k[2] = clip(v.z, hi);
      k[3] = clip(v.w, hi);
      return;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long long j = j0 + e;
      k[e] = (j >= 0 && j < n) ? clip(__ldcs(idx + j), hi) : -1;
    }
  }
};

template <class Index>
__global__ void __launch_bounds__(kBlock)
persistent_kernel(const float* __restrict__ plane, Index ix, long long n,
                  int skew, bool vec_out, float* __restrict__ out) {
  const long long groups = (n + skew + 3) >> 2;
  const long long stride = static_cast<long long>(gridDim.x) * kBlock;
  for (long long g = static_cast<long long>(blockIdx.x) * kBlock +
                     threadIdx.x;
       g < groups; g += stride * kGroups) {
    long long k[kGroups][4];
#pragma unroll
    for (int u = 0; u < kGroups; ++u) {
      const long long gu = g + u * stride;
      if (gu < groups) {
        ix.load4(4 * gu - skew, n, k[u]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) k[u][e] = -1;
      }
    }
    float v[kGroups][4];
#pragma unroll
    for (int u = 0; u < kGroups; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[u][e] = k[u][e] >= 0 ? __ldg(plane + k[u][e]) : 0.0f;
#pragma unroll
    for (int u = 0; u < kGroups; ++u) {
      const long long j0 = 4 * (g + u * stride) - skew;
      if (vec_out && j0 >= 0 && j0 + 3 < n) {
        __stcs(reinterpret_cast<float4*>(out + j0),
               make_float4(v[u][0], v[u][1], v[u][2], v[u][3]));
        continue;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (k[u][e] >= 0) __stcs(out + j0 + e, v[u][e]);
    }
  }
}

__device__ __forceinline__ unsigned cluster_reg(int which) {
  unsigned r;
  if (which == 0) asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  else if (which == 1)
    asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  else if (which == 2) asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(r));
  else asm volatile("mov.u32 %0, %%nclusterid.x;" : "=r"(r));
  return r;
}

// Every thread of the cluster; release/acquire at cluster scope, so that
// the shared memory written (or observed filled) before it is seen by
// every CTA after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The 4-B word at shared address `addr` of CTA `rank` of the cluster.
__device__ __forceinline__ float load_cluster(uint32_t addr, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote) : "r"(addr), "r"(rank));
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];"
               : "=f"(v) : "r"(remote) : "memory");
  return v;
}

__device__ __forceinline__ void arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(bar)
               : "memory");
}

__device__ __forceinline__ void wait_parity(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], "
        "%2; selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// The bulk fill of a CTA's share (slots granules, 4 KB each) on the
// mbarrier `filled`, by thread 0; the plane 16-B aligned.
__device__ __forceinline__ void bulk_fill(const float* plane, uint32_t base,
                                          uint32_t filled, unsigned rank,
                                          unsigned size, int slots) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(filled), "r"(slots * kGranule * 4) : "memory");
  for (int s = 0; s < slots; ++s) {
    const float* src = plane + static_cast<long long>(rank + size * s) *
                                   kGranule;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];"
        :: "r"(base + s * kGranule * 4), "l"(src), "r"(kGranule * 4),
           "r"(filled) : "memory");
  }
}

template <class Index>
__global__ void __launch_bounds__(kBlockB, 1)
mixed_kernel(const float* __restrict__ plane, Index ix, long long n,
             int skew, bool vec_out, int held, int slots,
             float* __restrict__ out) {
  extern __shared__ __align__(128) float4 held4[];
  __shared__ __align__(8) uint64_t filled_bar;
  const unsigned rank = cluster_reg(0);
  const unsigned size = cluster_reg(1);
  const unsigned shift = __ffs(size) - 1;
  const unsigned cluster = cluster_reg(2);
  const unsigned clusters = cluster_reg(3);
  const uint32_t base = smem_addr(held4);
  const uint32_t filled = smem_addr(&filled_bar);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(filled));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    bulk_fill(plane, base, filled, rank, size, slots);
  }
  const long long groups = (n + skew + 3) >> 2;
  const long long team = static_cast<long long>(size) * kBlockB;
  const long long stride = static_cast<long long>(clusters) * team;
  auto step = [&](long long g, bool from_cluster) {
    long long k[kGroups][4];
#pragma unroll
    for (int u = 0; u < kGroups; ++u) {
      const long long gu = g + u * stride;
      if (gu < groups) {
        ix.load4(4 * gu - skew, n, k[u]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) k[u][e] = -1;
      }
    }
    float v[kGroups][4];
#pragma unroll
    for (int u = 0; u < kGroups; ++u) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long ke = k[u][e];
        if (from_cluster && ke >= 0 && ke < held) {
          const unsigned granule = static_cast<unsigned>(ke) / kGranule;
          const unsigned word = (granule >> shift) * kGranule +
                                static_cast<unsigned>(ke) % kGranule;
          v[u][e] = load_cluster(base + 4 * word, granule & (size - 1));
        } else {
          v[u][e] = ke >= 0 ? __ldg(plane + ke) : 0.0f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kGroups; ++u) {
      const long long j0 = 4 * (g + u * stride) - skew;
      if (vec_out && j0 >= 0 && j0 + 3 < n) {
        __stcs(reinterpret_cast<float4*>(out + j0),
               make_float4(v[u][0], v[u][1], v[u][2], v[u][3]));
        continue;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (k[u][e] >= 0) __stcs(out + j0 + e, v[u][e]);
    }
  };
  __syncthreads();  // the mbarrier initialised before anyone waits on it
  long long g = cluster * team + rank * kBlockB + threadIdx.x;
  step(g, false);
  wait_parity(filled, 0);
  cluster_sync();  // every CTA of the cluster filled
  for (g += stride * kGroups; g < groups; g += stride * kGroups)
    step(g, true);
  cluster_sync();  // no CTA leaves while another may read its memory
}

// The helpers design's hand-off between a lead warp and its helper: the
// lead's requests for the entries held in cluster memory, compacted
// (position in the chunk << 20 | CTA rank << 16 | word in that CTA), and
// the helper's answers by position in the chunk; two chunks in flight.
struct Pair {
  uint32_t req[kRing][kChunk];
  float res[kRing][kChunk];
  int count[kRing];
};

// helpers. Every cluster holds the plane's first `held` entries (slots
// granules a CTA, held = slots * C * kGranule <= the plane's length, C
// CTAs a cluster): CTA r granules r, r + C, ..., copied in by the tensor
// memory accelerator. The index stream is cut into chunks of kChunk positions, dealt round the lead warps of the grid.
// Warps 0 .. kLeads - 1 lead: a lead loads a chunk's indices, gathers the
// entries not held through L2, and hands the held ones to its helper (warp
// kLeads + lead), which loads them from the cluster's shared memory; the
// lead then stores the chunk. Separate warps keep the two kinds of loads
// apart, so that neither waits on the other's latency. Each lead's first
// chunk goes through L2 only, while the fill lands.
template <class Index>
__global__ void __launch_bounds__(kBlockB, 1)
helpers_kernel(const float* __restrict__ plane, Index ix, long long n,
               int skew, bool vec_out, int held, int slots,
               float* __restrict__ out) {
  extern __shared__ __align__(128) float4 held4[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * kLeads * kRing];
  Pair* pairs = reinterpret_cast<Pair*>(held4 + slots * (kGranule / 4));
  const unsigned rank = cluster_reg(0);
  const unsigned size = cluster_reg(1);
  const unsigned shift = __ffs(size) - 1;  // size is a power of two
  const unsigned cluster = cluster_reg(2);
  const unsigned clusters = cluster_reg(3);
  const uint32_t base = smem_addr(held4);
  const uint32_t filled = smem_addr(&bars[0]);
  // full[l][s] = bars[1 + 2 (l kRing + s)], done[l][s] the one after it
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(filled));
    for (int b = 1; b < 1 + 2 * kLeads * kRing; ++b)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 32;"
                   :: "r"(smem_addr(&bars[b])));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) bulk_fill(plane, base, filled, rank, size, slots);

  // chunk q: lane l takes groups q kChunk / 4 + u 32 + l, u < kU; group
  // g covers positions 4 g - skew .. 4 g - skew + 3
  const long long groups = (n + skew + 3) >> 2;
  const long long chunks = (groups + kChunk / 4 - 1) / (kChunk / 4);
  const long long leads = static_cast<long long>(clusters) * size * kLeads;
  const int lead = warp < kLeads ? warp : warp - kLeads;
  const long long first = (static_cast<long long>(cluster) * size + rank) *
                              kLeads + lead;
  constexpr int kU = kChunk / 128;  // groups a lane takes per chunk

  auto load = [&](long long q, int k[kU][4]) {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const long long g = q * (kChunk / 4) + u * 32 + lane;
      long long kk[4] = {-1, -1, -1, -1};
      if (g < groups) ix.load4(4 * g - skew, n, kk);
#pragma unroll
      for (int e = 0; e < 4; ++e) k[u][e] = static_cast<int>(kk[e]);
    }
  };
  auto store = [&](long long q, const int k[kU][4], const float v[kU][4]) {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const long long j0 = 4 * (q * (kChunk / 4) + u * 32 + lane) - skew;
      if (vec_out && j0 >= 0 && j0 + 3 < n) {
        __stcs(reinterpret_cast<float4*>(out + j0),
               make_float4(v[u][0], v[u][1], v[u][2], v[u][3]));
        continue;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (k[u][e] >= 0) __stcs(out + j0 + e, v[u][e]);
    }
  };

  // the first chunk, through L2 only
  if (warp < kLeads && first < chunks) {
    int k[kU][4];
    float v[kU][4];
    load(first, k);
#pragma unroll
    for (int u = 0; u < kU; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[u][e] = k[u][e] >= 0 ? __ldg(plane + k[u][e]) : 0.0f;
    store(first, k, v);
  }
  wait_parity(filled, 0);
  cluster_sync();  // every CTA of the cluster filled

  Pair& pair = pairs[lead];
  const uint32_t bar0 = smem_addr(&bars[1 + 2 * kRing * lead]);
  if (warp < kLeads) {
    int kp[kU][4];     // the chunk in the helper's hands
    float vp[kU][4];
    long long qp = -1;
    for (long long i = 0, q = first + leads; q < chunks; ++i, q += leads) {
      const int s = static_cast<int>(i & 1);
      int k[kU][4];
      float v[kU][4];
      load(q, k);
      int count = 0;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ke = k[u][e];
          const bool mine = ke >= 0 && ke < held;
          const unsigned ballot = __ballot_sync(0xffffffffu, mine);
          if (mine) {
            const unsigned granule = static_cast<unsigned>(ke) / kGranule;
            const unsigned word = (granule >> shift) * kGranule +
                                  static_cast<unsigned>(ke) % kGranule;
            const unsigned pos = u * 128 + lane * 4 + e;
            pair.req[s][count + __popc(ballot & ((1u << lane) - 1))] =
                pos << 20 | (granule & (size - 1)) << 16 | word;
          }
          count += __popc(ballot);
          v[u][e] = ke >= 0 && !mine ? __ldg(plane + ke) : 0.0f;
        }
      }
      if (lane == 0) pair.count[s] = count;
      arrive(bar0 + 16 * s);  // full[lead][s]
      if (qp >= 0) {
        const int sp = s ^ 1;
        wait_parity(bar0 + 16 * sp + 8, static_cast<uint32_t>((i - 1) >> 1) & 1);
#pragma unroll
        for (int u = 0; u < kU; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (kp[u][e] >= 0 && kp[u][e] < held)
              vp[u][e] = pair.res[sp][u * 128 + lane * 4 + e];
        store(qp, kp, vp);
      }
#pragma unroll
      for (int u = 0; u < kU; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          kp[u][e] = k[u][e];
          vp[u][e] = v[u][e];
        }
      qp = q;
      if (q + leads >= chunks) {  // the last chunk: take it back now
        wait_parity(bar0 + 16 * s + 8, static_cast<uint32_t>(i >> 1) & 1);
#pragma unroll
        for (int u = 0; u < kU; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (kp[u][e] >= 0 && kp[u][e] < held)
              vp[u][e] = pair.res[s][u * 128 + lane * 4 + e];
        store(qp, kp, vp);
      }
    }
  } else {
    for (long long i = 0, q = first + leads; q < chunks; ++i, q += leads) {
      const int s = static_cast<int>(i & 1);
      wait_parity(bar0 + 16 * s, static_cast<uint32_t>(i >> 1) & 1);
      const int count = pair.count[s];
      uint32_t r[kChunk / 32];
      float v[kChunk / 32];
#pragma unroll
      for (int t = 0; t < kChunk / 32; ++t) {
        const int at = t * 32 + lane;
        r[t] = at < count ? pair.req[s][at] : 0xffffffffu;
        v[t] = r[t] != 0xffffffffu
                   ? load_cluster(base + 4 * (r[t] & 0xffffu),
                                  (r[t] >> 16) & 0xfu)
                   : 0.0f;
      }
#pragma unroll
      for (int t = 0; t < kChunk / 32; ++t)
        if (r[t] != 0xffffffffu) pair.res[s][r[t] >> 20] = v[t];
      arrive(bar0 + 16 * s + 8);  // done[lead][s]
    }
  }
  cluster_sync();  // no CTA leaves while another may read its memory
}

int skew_of(const void* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

size_t smem_bytes(int helpers, int slots) {
  return static_cast<size_t>(slots) * kGranule * 4 +
         (helpers ? kLeads * sizeof(Pair) : 0);
}

template <class K>
cudaError_t cluster_launch(K kernel, int helpers, int size, int slots,
                           int clusters, cudaStream_t s, const float* plane,
                           Flat ix, long long n, int skew, bool vec_out,
                           int held, float* out, int* resident) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_bytes(helpers, slots)));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cfg.gridDim = dim3(static_cast<unsigned>(clusters * size), 1, 1);
  cfg.blockDim = dim3(kBlockB, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes(helpers, slots);
  cfg.stream = s;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = static_cast<unsigned>(size);
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  if (resident) return cudaOccupancyMaxActiveClusters(resident, kernel, &cfg);
  err = cudaLaunchKernelEx(&cfg, kernel, plane, ix, n, skew, vec_out, held,
                           slots, out);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The persistent design on `device` (its resident CTAs a SM asked once).
int design_persistent(int device, const void* plane, long long len,
                      const void* idx, long long n, void* out, void* stream) {
  static int resident = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (resident == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &resident, persistent_kernel<Flat>, kBlock, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int skew = skew_of(idx);
  const long long groups = (n + skew + 3) >> 2;
  const long long want = (groups + kBlock * kGroups - 1) / (kBlock * kGroups);
  const long long cap = static_cast<long long>(sms) * resident;
  persistent_kernel<Flat><<<static_cast<unsigned>(want < cap ? want : cap),
                            kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(plane),
      Flat{static_cast<const int*>(idx), len - 1}, n, skew,
      skew_of(out) == skew, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The shared memory a CTA of the mixed (helpers 0) or helpers (1) design
// may give the plane (bytes).
int design_plane_bytes(int device, int helpers, int* bytes) {
  const cudaError_t err = cudaDeviceGetAttribute(
      bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  *bytes -= static_cast<int>(smem_bytes(helpers, 0)) + 1024;
  return static_cast<int>(err);
}

// The mixed (helpers 0) or helpers (1) design: the plane's first `held`
// = slots * size * 1024 entries (<= len; plane 16-B aligned) in each of
// `clusters` clusters of `size` CTAs (a power of two, at most 16). With
// `resident` non-null, launches nothing and sets the clusters the card
// holds at once.
int design_clusters(int device, int helpers, const void* plane,
                    long long len, const void* idx, long long n, int held,
                    int size, int slots, int clusters, void* out,
                    void* stream, int* resident) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (held != slots * size * kGranule || held > len ||
      (reinterpret_cast<uintptr_t>(plane) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int skew = skew_of(idx);
  const Flat ix{static_cast<const int*>(idx), len - 1};
  const float* p = static_cast<const float*>(plane);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec_out = skew_of(out) == skew;
  return static_cast<int>(
      helpers ? cluster_launch(helpers_kernel<Flat>, 1, size, slots, clusters,
                               s, p, ix, n, skew, vec_out, held, o, resident)
              : cluster_launch(mixed_kernel<Flat>, 0, size, slots, clusters,
                               s, p, ix, n, skew, vec_out, held, o,
                               resident));
}

}  // extern "C"
