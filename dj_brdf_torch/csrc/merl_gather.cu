// MERL table gathers for Hopper (sm_90a).
//
// Replaces the two Pallas formulations of the MERL table lookup in
// tools/gather_experiments.py: v4 (body k4, :113-116), a gather from one
// MERL channel plane by flat int32 index, and v5 (body k5, :142-145), the
// same gather with a two-level (row, lane) index into the plane padded to
// (rows, 128). On the product path the JAX package does this lookup with
// jnp.take inside dj_brdf_tpu/models/merl.py::Merl.eval (:164); here that
// lookup is the first entry below, for M tables at once:
//
//   djbt_merl_lookup     out[m, n, c] = table[m, c, clip(idx[n])] * scale[c],
//                        all three channels set to 0 where any is negative
//                        (below-horizon bins), then times iz[n] if given
//                        (Merl.evalp); tables (M, 3, P), out (M, N, 3).
//   djbt_gather_plane    K5: out[n] = plane[clip(idx[n])].
//   djbt_gather_rowlane  K6: out[n] = plane2d[clip(row[n]), clip(lane[n])].
//
// Indices are clipped into range, the counterpart of jnp.take's
// mode="clip" that Merl.eval uses, so no index reads outside a table.
// The arithmetic is the plain version's (dj_brdf_torch/ops/merl_gather.py)
// operation for operation: one f32 multiply by the scale, the compare
// after scaling, one f32 multiply by iz; no add is there to contract into
// an FMA, so kernel and plain version agree bit for bit.
//
// What bounds it on an H100: a MERL table is 17.5 MB (5.8 MB a channel
// plane), which does not fit a block's 227 KB of shared memory as it fit
// the TPU's VMEM, but does fit the 50 MB L2. Each lookup reads 4 B of
// index (coalesced), three 4 B table entries at random offsets (a 32 B L2
// sector each) and writes 12 B. The grid puts the material on its slow
// axis (blockIdx.y), so the blocks of one table are scheduled together
// and that table stays L2-resident while its lookups run: HBM sees each
// table about once, and the random reads are served by L2. The output
// (12 B per lookup, 1.75 GB at M = 100, N = 1,458,000) and the L2 sector
// traffic bound it. Offsets are 64-bit: M*3*P and M*N*3 exceed 2^31 at
// MERL scale.
//
// The kernels allocate nothing and do not synchronise: the caller passes
// the output buffer and PyTorch's current stream, and each entry returns
// the launch's cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr long long kMaxBlocksX = 1 << 20;  // grid-stride beyond this

__device__ __forceinline__ long long clip(long long i, long long hi) {
  return i < 0 ? 0 : (i > hi ? hi : i);
}

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
    const long long k = clip(idx[j], plane - 1);
    float r = __ldg(tab + k) * s0;
    float g = __ldg(tab + plane + k) * s1;
    float b = __ldg(tab + 2 * plane + k) * s2;
    if (r < 0.0f || g < 0.0f || b < 0.0f) {
      r = 0.0f;
      g = 0.0f;
      b = 0.0f;
    }
    if (iz != nullptr) {
      const float c = iz[j];
      r *= c;
      g *= c;
      b *= c;
    }
    o[3 * j] = r;
    o[3 * j + 1] = g;
    o[3 * j + 2] = b;
  }
}

__global__ void __launch_bounds__(kBlock)
gather_plane_kernel(const float* __restrict__ plane, long long len,
                    const int* __restrict__ idx, long long n,
                    float* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * kBlock;
  for (long long j = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
       j < n; j += stride) {
    out[j] = __ldg(plane + clip(idx[j], len - 1));
  }
}

__global__ void __launch_bounds__(kBlock)
gather_rowlane_kernel(const float* __restrict__ plane2d, int rows, int lanes,
                      const int* __restrict__ row,
                      const int* __restrict__ lane, long long n,
                      float* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * kBlock;
  for (long long j = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
       j < n; j += stride) {
    const long long r = clip(row[j], rows - 1);
    const long long l = clip(lane[j], lanes - 1);
    out[j] = __ldg(plane2d + r * lanes + l);
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
  merl_lookup_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tables), static_cast<const int*>(idx),
      static_cast<const float*>(iz), n, plane, s0, s1, s2,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// plane (len) f32; idx (n) int32; out (n) f32; n >= 1.
int djbt_gather_plane(int device, const void* plane, long long len,
                      const void* idx, long long n, void* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  gather_plane_kernel<<<blocks_for(n), kBlock, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(plane), len, static_cast<const int*>(idx), n,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// plane2d (rows, lanes) f32; row, lane (n) int32; out (n) f32; n >= 1.
int djbt_gather_rowlane(int device, const void* plane2d, int rows, int lanes,
                        const void* row, const void* lane, long long n,
                        void* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  gather_rowlane_kernel<<<blocks_for(n), kBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(plane2d), rows, lanes,
      static_cast<const int*>(row), static_cast<const int*>(lane), n,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
