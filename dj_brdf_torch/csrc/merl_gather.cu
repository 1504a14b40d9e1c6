// MERL table gathers for Hopper (sm_90a).
//
// Replaces the two Pallas formulations of the MERL table lookup in
// tools/gather_experiments.py: v4 (body k4, :113-116), a gather from one
// MERL channel plane by flat int32 index, and v5 (body k5, :142-145), the
// same gather with a two-level (row, lane) index into the plane padded to
// (rows, 128). On the product path the JAX package does this lookup with
// jnp.take inside dj_brdf_tpu/models/merl.py::Merl.eval (:164); here that
// lookup is the first two entries below, for M tables at once:
//
//   djbt_merl_lookup         out[m, n, c] = table[m, c, clip(idx[n])] *
//                            scale[c], all three channels set to 0 where
//                            any is negative (below-horizon bins), then
//                            times iz[n] if given (Merl.evalp); tables
//                            (M, 3, P), out (M, N, 3). The direct kernel.
//   djbt_merl_lookup_packed  the same function by mark, pack and look up
//                            (below), for large N.
//   djbt_gather_plane        K5: out[n] = plane[clip(idx[n])].
//   djbt_gather_rowlane      K6: out[n] = plane2d[clip(row[n]), clip(lane[n])].
//
// Indices are clipped into range, the counterpart of jnp.take's
// mode="clip" that Merl.eval uses, so no index reads outside a table.
// The arithmetic is the plain version's (dj_brdf_torch/ops/merl_gather.py)
// operation for operation: one f32 multiply by the scale, the compare
// after scaling, one f32 multiply by iz; no add is there to contract into
// an FMA, so both lookup paths and the plain version agree bit for bit.
//
// What bounds the lookup on an H100: a MERL table is 17.5 MB (5.8 MB a
// channel plane), which does not fit a block's 227 KB of shared memory as
// it fit the TPU's VMEM, but does fit the 50 MB L2. The direct kernel
// reads three 4-B entries at random offsets per lookup, 5.8 MB apart: a
// whole 32-B L2 sector each. Measured on the card, random sectors come
// from L2 at ~137 G/s, so at M = 100, N = 1,458,000 the 437 M table
// sectors alone take ~3.2 ms, where the output (1.75 GB to HBM) needs
// 0.52 ms at the HBM rate. The packed path reads one sector per lookup
// for two tables instead of three per table:
//
//   mark     once per call, a byte per table cell that the (shared) index
//            set touches;
//   pack     per pair of tables (the last table of an odd M alone), the
//            marked cells of their three planes (read evict-first: each
//            entry once) into one 16-B record (r*s0, g*s1, b*s2, unused)
//            per table, 0 where any is negative; the two records of a
//            cell side by side (32 B, one sector), written in place at the
//            cell's index so that only the touched ~16 MB of the buffer is
//            written and stays in L2;
//   look up  a lane pair per lookup, each lane one table's record: one
//            warp load fetches 16 whole sectors, one per cell, for both
//            tables; times iz; staged per warp through shared memory and
//            stored coalesced and evict-first, so that the output stream
//            does not push the records out of L2.
//
// The pairs go in order, a pack launch and a lookup launch each, so the
// record buffer of one pair is reused by the next. On the card the pack
// (0.74 ms of the 2.4 at M = 100, N = 1,458,000) is bound by the HBM reads
// of the scattered touched sectors and the lookups by the output's HBM
// writes with the record reads beside them; packing the next pair while
// the last is looked up, in one grid, was no faster: both halves wait on
// HBM. The wrapper takes the direct kernel (one launch for all M) where N
// is too small to pay for the pack: ops/merl_gather.py::lookup_packs.
// Offsets are 64-bit: M*3*P and M*N*3 exceed 2^31 at MERL scale.
//
// The kernels allocate nothing and do not synchronise: the caller passes
// the output and scratch buffers and PyTorch's current stream, and each
// entry returns the launches' cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;
constexpr long long kMaxBlocksX = 1 << 20;  // grid-stride beyond this
// Loads in flight per thread, measured best on an H100 at M = 100, N =
// 1,458,000 (of 1, 2, 4, 8 and of 1, 2, 4): lookups a lane step, cells a
// pack step.
constexpr int kUnroll = 4;
constexpr int kPackUnroll = 2;

__device__ __forceinline__ long long clip(long long i, long long hi) {
  return i < 0 ? 0 : (i > hi ? hi : i);
}

// One table's (r, g, b) at cell k, scaled, 0 where any is negative; read
// evict-first where kOnce (the pack reads each entry once).
template <bool kOnce = false>
__device__ __forceinline__ float3 scaled_cell(const float* __restrict__ tab,
                                              long long plane, long long k,
                                              float s0, float s1, float s2) {
  const float* p = tab + k;
  float r = (kOnce ? __ldcs(p) : __ldg(p)) * s0;
  float g = (kOnce ? __ldcs(p + plane) : __ldg(p + plane)) * s1;
  float b = (kOnce ? __ldcs(p + 2 * plane) : __ldg(p + 2 * plane)) * s2;
  if (r < 0.0f || g < 0.0f || b < 0.0f) {
    r = 0.0f;
    g = 0.0f;
    b = 0.0f;
  }
  return make_float3(r, g, b);
}

// The warp's `count` lookups of one table, staged as 3 * count floats in
// `st`, stored contiguously from out[3 * w0] (evict-first).
__device__ __forceinline__ void store_staged(const float* st, int count,
                                             long long w0, long long n,
                                             int lane, float* __restrict__ o) {
  const long long left = n - w0;
  const int valid = 3 * static_cast<int>(left < count ? left : count);
  for (int e = lane; e < valid; e += 32) __stcs(o + 3 * w0 + e, st[e]);
}

// One lookup per thread, the material on grid.y; each thread stores its
// own 12 B.
__global__ void __launch_bounds__(kBlock)
merl_lookup_kernel(const float* __restrict__ tables,
                   const int* __restrict__ idx,
                   const float* __restrict__ iz, long long n,
                   long long plane, float s0, float s1, float s2,
                   float* __restrict__ out) {
  const long long m = blockIdx.y;
  const float* tab = tables + m * 3 * plane;
  float* o = out + m * n * 3;
  const long long stride = static_cast<long long>(gridDim.x) * kBlock;
  for (long long j = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
       j < n; j += stride) {
    float3 v = scaled_cell(tab, plane, clip(idx[j], plane - 1), s0, s1, s2);
    if (iz != nullptr) {
      const float c = iz[j];
      v.x *= c;
      v.y *= c;
      v.z *= c;
    }
    o[3 * j] = v.x;
    o[3 * j + 1] = v.y;
    o[3 * j + 2] = v.z;
  }
}

__global__ void __launch_bounds__(kBlock)
mark_kernel(const int* __restrict__ idx, long long n, long long plane,
            unsigned char* __restrict__ mark) {
  const long long stride = static_cast<long long>(gridDim.x) * kBlock;
  for (long long j = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
       j < n; j += stride) {
    mark[clip(idx[j], plane - 1)] = 1;
  }
}

// Thread t packs cells t + u kBlock, u < kPackUnroll, of its grid step
// where they are marked: the G tables m0.. (a pair, or the last table
// of an odd M alone), each cell's G
// records side by side. The loads of a thread are in flight together.
template <int G>
__global__ void __launch_bounds__(kBlock)
pack_kernel(const float* __restrict__ tables, long long m0, long long plane,
            float s0, float s1, float s2,
            const unsigned char* __restrict__ mark,
            float4* __restrict__ rec) {
  const long long stride =
      static_cast<long long>(gridDim.x) * kBlock * kPackUnroll;
  for (long long k0 =
           static_cast<long long>(blockIdx.x) * kBlock * kPackUnroll +
           threadIdx.x;
       k0 < plane; k0 += stride) {
    bool marked[kPackUnroll];
#pragma unroll
    for (int u = 0; u < kPackUnroll; ++u) {
      const long long k = k0 + u * kBlock;
      marked[u] = k < plane && mark[k];
    }
    float3 v[kPackUnroll][G];
#pragma unroll
    for (int u = 0; u < kPackUnroll; ++u) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (marked[u])
          v[u][g] = scaled_cell<true>(tables + (m0 + g) * 3 * plane, plane,
                                      k0 + u * kBlock, s0, s1, s2);
      }
    }
#pragma unroll
    for (int u = 0; u < kPackUnroll; ++u) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (marked[u])
          rec[(k0 + u * kBlock) * G + g] =
              make_float4(v[u][g].x, v[u][g].y, v[u][g].z, 0.0f);
      }
    }
  }
}

// Lane pairs (G = 2) or single lanes (G = 1): in a warp step of kStep
// lookups, lane l looks up cells idx[w0 + u * kPer + l / G], u < kUnroll,
// in the record of table m0 + l % G. The kUnroll loads of a lane are
// independent and in flight together.
template <int G>
__global__ void __launch_bounds__(kBlock)
lookup_packed_kernel(const float4* __restrict__ rec,
                     const int* __restrict__ idx,
                     const float* __restrict__ iz, long long n,
                     long long plane, float* __restrict__ out) {
  constexpr int kPer = 32 / G;          // lookups per warp load
  constexpr int kStep = kUnroll * kPer;  // lookups per warp step
  __shared__ float stage[kWarps][G][3 * kStep];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q = lane / G;
  const int g = lane % G;
  float* st = stage[warp][g];
  const long long stride = static_cast<long long>(gridDim.x) * kWarps * kStep;
  for (long long w0 = (static_cast<long long>(blockIdx.x) * kWarps + warp) *
                      kStep;
       w0 < n; w0 += stride) {
    long long k[kUnroll];
    float c[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = w0 + u * kPer + q;
      k[u] = j < n ? clip(idx[j], plane - 1) : -1;
      c[u] = (iz != nullptr && j < n) ? iz[j] : 1.0f;
    }
    float4 r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (k[u] >= 0) r[u] = __ldcg(rec + k[u] * G + g);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (k[u] < 0) continue;
      float x = r[u].x, y = r[u].y, z = r[u].z;
      if (iz != nullptr) {
        x *= c[u];
        y *= c[u];
        z *= c[u];
      }
      const int e = 3 * (u * kPer + q);
      st[e] = x;
      st[e + 1] = y;
      st[e + 2] = z;
    }
    __syncwarp();
#pragma unroll
    for (int h = 0; h < G; ++h)
      store_staged(stage[warp][h], kStep, w0, n, lane, out + h * n * 3);
    __syncwarp();
  }
}

// K5 and K6: one kernel, two index policies, each turning a position
// into a flat clipped index as the plain versions clip it (per
// coordinate for K6). What bounds them on an H100 at the gather script's
// shapes (2^22 uniform indices into a 1,458,000-entry plane): the card
// serves random 4-B entries from L2 at ~137 G sectors/s in all, a rate
// half of its SMs already reach, so the gathers alone take ~0.031 ms
// (chip_smoke.py phase 7's probes). Designs measured and not kept, each
// no faster than this one (scripts/gather_designs.py): a persistent grid
// with 16-B index loads and eight gathers in flight a thread; a share of
// the plane held in the shared memory of thread-block clusters, its
// lookups mixed into the same warps or handed to helper warps. Loads
// over a cluster share the L2 loads' rate rather than add to it.
struct FlatIndex {  // K5: clip(idx[j])
  const int* idx;
  long long hi;  // plane length - 1

  __device__ __forceinline__ long long at(long long j) const {
    return clip(__ldg(idx + j), hi);
  }
};

struct RowLaneIndex {  // K6: clip(row[j]) * lanes + clip(lane[j])
  const int* row;
  const int* lane;
  int rows;
  int lanes;

  __device__ __forceinline__ long long at(long long j) const {
    return clip(__ldg(row + j), rows - 1) * lanes +
           clip(__ldg(lane + j), lanes - 1);
  }
};

template <class Index>
__global__ void __launch_bounds__(kBlock)
gather_kernel(const float* __restrict__ plane, Index ix, long long n,
              float* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * kBlock;
  for (long long j = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
       j < n; j += stride) {
    out[j] = __ldg(plane + ix.at(j));
  }
}

unsigned int blocks_for(long long n) {
  long long b = (n + kBlock - 1) / kBlock;
  return static_cast<unsigned int>(b < kMaxBlocksX ? b : kMaxBlocksX);
}

}  // namespace

extern "C" {

const char* djbt_gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// device: the CUDA device of every pointer and of `stream`. tables
// (m, 3, plane) f32; idx (n) int32; iz (n) f32 or null; out (m, n, 3) f32.
// All contiguous; n >= 1, 1 <= m <= 65535. Returns the launch's CUDA error
// (0 on success).
int djbt_merl_lookup(int device, const void* tables, const void* idx,
                     const void* iz, long long n, int m, long long plane,
                     float s0, float s1, float s2, void* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(blocks_for(n), static_cast<unsigned int>(m));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* t = static_cast<const float*>(tables);
  const int* ix = static_cast<const int*>(idx);
  const float* z = static_cast<const float*>(iz);
  float* o = static_cast<float*>(out);
  merl_lookup_kernel<<<grid, kBlock, 0, s>>>(t, ix, z, n, plane, s0, s1, s2,
                                             o);
  return static_cast<int>(cudaGetLastError());
}

// The same lookup by mark, pack and look up. mark: (plane) bytes of
// scratch; rec: (plane, min(m, 2)) float4 of scratch. Launches one memset
// and one mark kernel, then a pack and a lookup kernel per pair of tables
// (the last table of an odd m alone).
int djbt_merl_lookup_packed(int device, const void* tables, const void* idx,
                            const void* iz, long long n, int m,
                            long long plane, float s0, float s1, float s2,
                            void* mark, void* rec, void* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* t = static_cast<const float*>(tables);
  const int* ix = static_cast<const int*>(idx);
  const float* z = static_cast<const float*>(iz);
  unsigned char* mk = static_cast<unsigned char*>(mark);
  float4* r = static_cast<float4*>(rec);
  float* o = static_cast<float*>(out);
  err = cudaMemsetAsync(mk, 0, plane, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  mark_kernel<<<blocks_for(n), kBlock, 0, s>>>(ix, n, plane, mk);
  const long long steps = (n + kUnroll - 1) / kUnroll;  // lane steps a table
  const long long pack_steps = (plane + kPackUnroll - 1) / kPackUnroll;
  for (long long m0 = 0; m0 < m; m0 += 2) {
    float* om = o + m0 * n * 3;
    if (m0 + 1 < m) {
      pack_kernel<2><<<blocks_for(pack_steps), kBlock, 0, s>>>(
          t, m0, plane, s0, s1, s2, mk, r);
      lookup_packed_kernel<2><<<blocks_for(2 * steps), kBlock, 0, s>>>(
          r, ix, z, n, plane, om);
    } else {
      pack_kernel<1><<<blocks_for(pack_steps), kBlock, 0, s>>>(
          t, m0, plane, s0, s1, s2, mk, r);
      lookup_packed_kernel<1><<<blocks_for(steps), kBlock, 0, s>>>(
          r, ix, z, n, plane, om);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// plane (len) f32; idx (n) int32; out (n) f32; n >= 1.
int djbt_gather_plane(int device, const void* plane, long long len,
                      const void* idx, long long n, void* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  gather_kernel<<<blocks_for(n), kBlock, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(plane),
      FlatIndex{static_cast<const int*>(idx), len - 1}, n,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// plane2d (rows, lanes) f32; row, lane (n) int32; out (n) f32; n >= 1.
int djbt_gather_rowlane(int device, const void* plane2d, int rows, int lanes,
                        const void* row, const void* lane, long long n,
                        void* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  gather_kernel<<<blocks_for(n), kBlock, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(plane2d),
      RowLaneIndex{static_cast<const int*>(row),
                   static_cast<const int*>(lane), rows, lanes},
      n, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
