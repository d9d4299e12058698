// Single-token GQA attention against a KV cache (flash-decode), for sm_90a.
//
// Replaces the TPU kernel repro/kernels/decode_attention.py::_decode_kernel
// (pallas_call in decode_attention(), line 110).
//
// q [B,1,H,hd], k/v [B,S,KV,hd] (row-major, contiguous), lengths int32 [B]
// or null, out [B,1,H,hd].  Query head h = g*KV + kv reads kv head kv
// (h % KV), the reference's [g, kv] grouping.  Cache slot i of sequence b is
// attended iff i < lengths[b] (all S slots when lengths is null).
//
// What bounds it on an H100: bytes.  Each (b, kv) block must stream its
// valid K/V prefix once (lengths[b] * hd * 2 values) and does 4 flops per
// streamed value pair, far under the card's ~295 flops/byte ridge.  The
// design therefore only tries to keep bytes in flight and never to move
// more of them than needed:
//   * one thread block per (kv head, sequence) holds the G query rows and
//     the online-softmax state (m, l in shared memory, acc [G, hd] in f32);
//   * the cache is walked in tiles of rows copied with 16-byte cp.async into
//     a two-stage shared-memory ring, so tile t+1 loads while tile t is used;
//   * the walk stops at lengths[b], read on the device: the invalid tail is
//     never read, so a stale row (even a non-finite one) cannot reach the
//     output, and no host read of lengths is needed;
//   * a length of 0 leaves l = 0 and writes 0, as the reference kernel does.
// Known weak spot: with G = 1 and B*KV = 128 blocks the grid is under one
// wave of the 132 SMs; a split over S (flash-decoding) is the later fix.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTileBytes = 8192;  // bytes of one K (or V) tile stage

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows of one cache tile: what fits kTileBytes, at least 8.
__host__ __device__ inline int tile_rows(int hd, int elem_bytes) {
  const int rows = kTileBytes / (hd * elem_bytes);
  return rows < 8 ? 8 : rows;
}

__host__ inline size_t smem_bytes(int G, int hd, int tile, int elem_bytes) {
  return 2 * 2 * static_cast<size_t>(tile) * hd * elem_bytes  // K, V x 2 stages
         + (2 * static_cast<size_t>(G) * hd                    // q, acc
            + static_cast<size_t>(G) * tile                    // scores / p
            + 3 * static_cast<size_t>(G)) * sizeof(float);     // m, l, alpha
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ lengths,
                        T* __restrict__ out, int S, int KV, int G, int hd,
                        float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int kv = blockIdx.x;
  const int b = blockIdx.y;
  const int H = G * KV;
  const int tile = tile_rows(hd, sizeof(T));
  const int stage = tile * hd;  // elements in one K (or V) stage

  T* ks = reinterpret_cast<T*>(smem);               // [2][tile][hd]
  T* vs = ks + 2 * stage;                           // [2][tile][hd]
  float* qs = reinterpret_cast<float*>(vs + 2 * stage);  // [G][hd]
  float* acc = qs + G * hd;                         // [G][hd]
  float* ps = acc + G * hd;                         // [G][tile]
  float* m_s = ps + G * tile;                       // [G]
  float* l_s = m_s + G;                             // [G]
  float* a_s = l_s + G;                             // [G]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  int len = S;
  if (lengths != nullptr) {
    len = lengths[b];
    len = len < 0 ? 0 : (len > S ? S : len);
  }

  for (int i = tid; i < G * hd; i += kThreads) {
    const int g = i / hd, d = i - (i / hd) * hd;
    qs[i] = to_f32(q[(static_cast<size_t>(b) * H + g * KV + kv) * hd + d]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = -1e30f;
    l_s[g] = 0.f;
  }

  const size_t row_stride = static_cast<size_t>(KV) * hd;
  const T* kbase = k + (static_cast<size_t>(b) * S * KV + kv) * hd;
  const T* vbase = v + (static_cast<size_t>(b) * S * KV + kv) * hd;
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte copy
  const int chunks = hd / kVec;
  const int ntiles = (len + tile - 1) / tile;

  auto prefetch = [&](int t, int st) {
    const int t0 = t * tile;
    const int n = min(tile, len - t0);
    T* kd = ks + st * stage;
    T* vd = vs + st * stage;
    for (int i = tid; i < n * chunks; i += kThreads) {
      const int r = i / chunks, c = i - (i / chunks) * chunks;
      const size_t off = static_cast<size_t>(t0 + r) * row_stride + c * kVec;
      cp_async16(kd + r * hd + c * kVec, kbase + off);
      cp_async16(vd + r * hd + c * kVec, vbase + off);
    }
    cp_async_commit();
  };

  if (ntiles > 0) prefetch(0, 0);
  for (int t = 0; t < ntiles; ++t) {
    const int st = t & 1;
    if (t + 1 < ntiles) {
      prefetch(t + 1, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t resident for every thread (and q/acc set)

    const int n = min(tile, len - t * tile);
    const T* kt = ks + st * stage;
    const T* vt = vs + st * stage;

    // scores: one warp per cache row, lanes across hd
    for (int r = warp; r < n; r += kWarps) {
      for (int g = 0; g < G; ++g) {
        float part = 0.f;
        for (int d = lane; d < hd; d += 32) part += qs[g * hd + d] * to_f32(kt[r * hd + d]);
        part = warp_sum(part);
        if (lane == 0) ps[g * tile + r] = part * scale;
      }
    }
    __syncthreads();

    // online softmax, one warp per query row g
    for (int g = warp; g < G; g += kWarps) {
      float mx = -1e30f;
      for (int r = lane; r < n; r += 32) mx = fmaxf(mx, ps[g * tile + r]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int r = lane; r < n; r += 32) {
        const float p = expf(ps[g * tile + r] - m_new);
        ps[g * tile + r] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc[g, d] = acc * alpha + sum_r p[g, r] * V[r, d]
    for (int i = tid; i < G * hd; i += kThreads) {
      const int g = i / hd, d = i - (i / hd) * hd;
      const float* pg = ps + g * tile;
      float a = 0.f;
      for (int r = 0; r < n; ++r) a += pg[r] * to_f32(vt[r * hd + d]);
      acc[i] = acc[i] * a_s[g] + a;
    }
    __syncthreads();  // stage st free for the next iteration's prefetch
  }
  __syncthreads();

  for (int i = tid; i < G * hd; i += kThreads) {
    const int g = i / hd, d = i - (i / hd) * hd;
    store(out + (static_cast<size_t>(b) * H + g * KV + kv) * hd + d,
          acc[i] / fmaxf(l_s[g], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           void* out, int B, int S, int H, int KV, int hd, float scale,
           cudaStream_t stream) {
  const int G = H / KV;
  const int tile = tile_rows(hd, sizeof(T));
  const size_t smem = smem_bytes(G, hd, tile, sizeof(T));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(KV, B);
  decode_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(lengths), static_cast<T*>(out), S, KV, G, hd, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* lengths, void* out, int B, int S,
                                       int H, int KV, int hd, int dtype, float scale,
                                       void* stream) {
  if (B <= 0 || KV <= 0 || H % KV != 0 || hd % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(q, k, v, lengths, out, B, S, H, KV, hd, scale, s);
  if (dtype == 1) return launch<__nv_bfloat16>(q, k, v, lengths, out, B, S, H, KV, hd, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
