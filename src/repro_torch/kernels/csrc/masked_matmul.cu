// FedAP structured-pruning matmul, forward: y = x @ w with pruned 128-column
// blocks skipped, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/masked_matmul.py::_masked_mm_kernel
// (pallas_call in _fwd_call(), line 122).
//
// x [M,K], w [K,N], block_mask float32 [N/128], y [M,N], all row-major and
// contiguous; K and N are multiples of 128, M is any size.  Column block j
// is computed iff block_mask[j] > 0; otherwise it is written as zeros and
// that block of w is never read.  Sums run in f32; y has x's type.
//
// What bounds it on an H100: bytes.  At decode M is the slot count (<= 8 in
// serving), so each w element read is used for at most 8 multiply-adds:
// the kernel streams the kept column blocks of w once, and the pruned ones
// not at all (FedAP's saving shows up as bytes not moved).  The design keeps
// many 16-byte loads of w in flight and touches x only through shared memory:
//   * one thread block per (8-row M tile, 32-column slice of a 128-column
//     block); a pruned block's slices exit after writing zeros;
//   * 256 threads = 64 K-groups x 4 column groups; each thread owns 8 columns
//     and reads 8 rows of w per 512-deep K chunk as 16-byte vectors, all
//     in flight before any is used; the x chunk [8, 512] is staged in shared
//     memory as f32;
//   * partial sums over the K-groups are reduced with warp shuffles and then
//     across the 8 warps in shared memory.
// Known weak spot: an M tile larger than 8 rows re-reads w once per tile,
// which is fine at decode and wasteful for large M (a tensor-core tile is
// the later fix).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBM = 8;                  // rows of x per block
constexpr int kBlockN = 128;            // mask granularity (columns)
constexpr int kCW = 32;                 // columns per block
constexpr int kVec = 8;                 // columns per thread
constexpr int kTPR = kCW / kVec;        // threads across one row slice (4)
constexpr int kThreads = 256;
constexpr int kKG = kThreads / kTPR;    // K-groups (64)
constexpr int kKC = 512;                // K chunk staged in shared memory
constexpr int kRows = kKC / kKG;        // w rows per thread per chunk (8)
constexpr int kWarps = kThreads / 32;

template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int kU4 = 2;         // 8 floats = 2 x 16 bytes
  __device__ static void unpack(const uint4* u, float* f) {
    const float4 a = *reinterpret_cast<const float4*>(&u[0]);
    const float4 b = *reinterpret_cast<const float4*>(&u[1]);
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int kU4 = 1;         // 8 bf16 = 16 bytes
  __device__ static void unpack(const uint4* u, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
masked_matmul_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const float* __restrict__ block_mask, T* __restrict__ y,
                     int M, int K, int N) {
  const int m0 = blockIdx.x * kBM;
  const int col0 = blockIdx.y * kCW;
  const int tid = threadIdx.x;

  if (!(block_mask[col0 / kBlockN] > 0.f)) {  // pruned (NaN counts as pruned)
    for (int i = tid; i < kBM * kCW; i += kThreads) {
      const int r = i / kCW, c = i % kCW;
      if (m0 + r < M) store(y + static_cast<size_t>(m0 + r) * N + col0 + c, 0.f);
    }
    return;
  }

  __shared__ float xs[kBM][kKC];
  __shared__ float red[kWarps][kBM][kCW];

  const int cg = tid % kTPR;
  const int kg = tid / kTPR;
  const int c0 = col0 + cg * kVec;
  constexpr int kU4 = Vec<T>::kU4;

  float acc[kBM][kVec];
#pragma unroll
  for (int r = 0; r < kBM; ++r)
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc[r][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kKC) {
    const int kn = min(kKC, K - k0);
    __syncthreads();  // previous chunk of xs consumed
    for (int i = tid; i < kBM * kKC; i += kThreads) {
      const int r = i / kKC, kk = i % kKC;
      xs[r][kk] = (m0 + r < M && kk < kn)
                      ? to_f32(x[static_cast<size_t>(m0 + r) * K + k0 + kk]) : 0.f;
    }
    uint4 raw[kRows][kU4];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int kk = kg + j * kKG;
      if (kk < kn) {
        const uint4* src = reinterpret_cast<const uint4*>(
            w + static_cast<size_t>(k0 + kk) * N + c0);
#pragma unroll
        for (int u = 0; u < kU4; ++u) raw[j][u] = src[u];
      } else {
#pragma unroll
        for (int u = 0; u < kU4; ++u) raw[j][u] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    __syncthreads();  // xs chunk staged
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int kk = kg + j * kKG;
      float wf[kVec];
      Vec<T>::unpack(raw[j], wf);
#pragma unroll
      for (int r = 0; r < kBM; ++r) {
        const float xv = xs[r][kk];
#pragma unroll
        for (int c = 0; c < kVec; ++c) acc[r][c] += xv * wf[c];
      }
    }
  }

  // lanes of one warp hold 8 K-groups of the same 4 column groups:
  // lane = (kg % 8) * kTPR + cg, so xor over lane bits 2..4 sums them
#pragma unroll
  for (int r = 0; r < kBM; ++r)
#pragma unroll
    for (int c = 0; c < kVec; ++c) {
      float s = acc[r][c];
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      acc[r][c] = s;
    }
  const int lane = tid & 31, warp = tid >> 5;
  if (lane < kTPR) {
#pragma unroll
    for (int r = 0; r < kBM; ++r)
#pragma unroll
      for (int c = 0; c < kVec; ++c) red[warp][r][cg * kVec + c] = acc[r][c];
  }
  __syncthreads();
  for (int i = tid; i < kBM * kCW; i += kThreads) {
    const int r = i / kCW, c = i % kCW;
    float s = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) s += red[wi][r][c];
    if (m0 + r < M) store(y + static_cast<size_t>(m0 + r) * N + col0 + c, s);
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* block_mask, void* y,
           int M, int K, int N, cudaStream_t stream) {
  const dim3 grid((M + kBM - 1) / kBM, N / kCW);
  masked_matmul_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(block_mask), static_cast<T*>(y), M, K, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch.
extern "C" int masked_matmul_launch(const void* x, const void* w, const void* block_mask,
                                    void* y, int M, int K, int N, int dtype,
                                    void* stream) {
  if (M <= 0 || N <= 0 || K % kBlockN != 0 || N % kBlockN != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, w, block_mask, y, M, K, N, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w, block_mask, y, M, K, N, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
