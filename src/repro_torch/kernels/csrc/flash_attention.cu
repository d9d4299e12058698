// Blocked online-softmax GQA attention over a whole sequence (flash
// attention, forward only), for sm_90a.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::_flash_kernel
// (pallas_call in flash_attention(), line 102).
//
// q [B,Sq,H,hd], k/v [B,Skv,KV,hd] (row-major, contiguous), out [B,Sq,H,hd]
// in q's type.  Query head h reads kv head h % KV (the reference's [g, kv]
// grouping) straight from the [B,S,KV,hd] layout: no transpose and no K/V
// replication.  Key kpos is visible to query qpos (both counted from 0, also
// when Sq != Skv) iff kpos < Skv, kpos <= qpos when causal, and
// kpos > qpos - window when a window is given.  Scores are scaled by
// 1/sqrt(hd); the softmax statistics (running max m, running sum l) and the
// output accumulator are f32, and P stays f32 for P @ V, as in the Pallas
// kernel.  A row that sees no key ends with l = 0 and is written as 0 (the
// Pallas kernel's max(l, 1e-30)).
//
// What bounds it on an H100: operations.  At olmo-1b scoring (S = 2048,
// hd = 128) every K/V tile is reused by 64 query rows, ~4 flops per byte
// read from L2 per row; the work is 4*S*S*hd/2 flops per (batch, head).
// This first version computes in f32 outside the tensor cores (67 TFLOP/s
// peak), so it sits far above the bf16 tensor-core bound; the design keeps
// the SIMT inner loops fed from shared memory:
//   * one 128-thread block per (query tile of 64 rows, query head, batch);
//     heavy (late, causal) query tiles are launched first;
//   * the block walks the kv tiles (32 keys) in order with an online
//     softmax; kv tiles that the causal mask or the window hides from every
//     row of the query tile are never loaded or computed, so the work is
//     the visible triangle or band, not the square;
//   * each thread owns 4 query rows x 4 keys of S = Q K^T and 4 rows x hd/8
//     columns of the output, reading 16-byte vectors from shared memory
//     laid out so that no load of a warp meets a bank conflict;
//   * Q, K and V tiles are converted to f32 once when staged (Q pre-scaled),
//     so bf16 and f32 inputs share one inner loop;
//   * the ragged tails (Sq, Skv not multiples of the tiles) are zero-filled
//     and masked, so any Sq and Skv work.
// Later: bf16 P and mma/wgmma tensor-core products, TMA and a load ring.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;       // 16 row groups x 8 column lanes
constexpr int kBQ = 64;             // query rows per block
constexpr int kBK = 32;             // keys per kv tile
constexpr int kRows = kBQ / 16;     // query rows per thread
constexpr int kCols = kBK / 8;      // keys per thread in S
constexpr int kPStride = kBK + 4;   // row stride of the P tile (floats)

__device__ __forceinline__ void load8(const float* p, float* d) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  d[0] = a.x; d[1] = a.y; d[2] = a.z; d[3] = a.w;
  d[4] = b.x; d[5] = b.y; d[6] = b.z; d[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* d) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    d[2 * i] = f.x;
    d[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b, float c, float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 u;
  u.x = *reinterpret_cast<unsigned*>(&lo);
  u.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// Stage `rows` rows of hd values (row r of the tile = sequence position
// pos0 + r, valid below `limit`) into dst [rows][stride] as f32, times
// `scale`; rows past `limit` are zeros.
template <typename T, int HD>
__device__ __forceinline__ void stage(const T* __restrict__ src, size_t row_stride,
                                      int pos0, int limit, int rows, float scale,
                                      float* dst, int stride) {
  constexpr int kChunks = HD / 8;
  for (int i = threadIdx.x; i < rows * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i - r * kChunks) * 8;
    float v[8];
    if (pos0 + r < limit) {
      load8(src + static_cast<size_t>(pos0 + r) * row_stride + c, v);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] *= scale;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = 0.f;
    }
    float* o = dst + r * stride + c;
    store4(o, v[0], v[1], v[2], v[3]);
    store4(o + 4, v[4], v[5], v[6], v[7]);
  }
}

template <int HD>
__host__ __device__ constexpr int smem_floats() {
  return kBQ * (HD + 4) + kBK * (HD + 4) + kBK * HD + kBQ * kPStride;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int Sq,
                       int Skv, int H, int KV, int causal, int window,
                       float scale) {
  constexpr int kQS = HD + 4;       // row stride of the Q and K tiles
  constexpr int kDG = HD / 32;      // output column groups of 4 per thread
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                 // [kBQ][kQS]
  float* ks = qs + kBQ * kQS;       // [kBK][kQS]
  float* vs = ks + kBK * kQS;       // [kBK][HD]
  float* ps = vs + kBK * HD;        // [kBQ][kPStride]

  const int qt = gridDim.x - 1 - blockIdx.x;   // late (heavy) tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h % KV;
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x;
  const int ty = tid >> 3;          // row group: rows ty*kRows + i
  const int tx = tid & 7;           // keys tx + 8j; output cols tx*4 + 32g + e

  const size_t q_row = static_cast<size_t>(H) * HD;
  const size_t kv_row = static_cast<size_t>(KV) * HD;
  const T* qb = q + (static_cast<size_t>(b) * Sq * H + h) * HD;
  const T* kb = k + (static_cast<size_t>(b) * Skv * KV + kvh) * HD;
  const T* vb = v + (static_cast<size_t>(b) * Skv * KV + kvh) * HD;

  // kv tiles some row of this query tile can see
  const int q_last = min(q0 + kBQ, Sq) - 1;
  int kt_begin = 0;
  int kt_end = (Skv + kBK - 1) / kBK;
  if (causal) kt_end = min(kt_end, q_last / kBK + 1);
  if (window > 0 && q0 - window + 1 > 0) kt_begin = (q0 - window + 1) / kBK;

  stage<T, HD>(qb, q_row, q0, Sq, kBQ, scale, qs, kQS);

  float m[kRows], l[kRows], o[kRows][4 * kDG];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -1e30f;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * kDG; ++c) o[i][c] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's K, V and P are consumed
    stage<T, HD>(kb, kv_row, k0, Skv, kBK, 1.f, ks, kQS);
    stage<T, HD>(vb, kv_row, k0, Skv, kBK, 1.f, vs, HD);
    __syncthreads();

    // S = (scale Q) K^T for rows ty*kRows + i, keys tx + 8j
    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[kRows], kv4[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (ty * kRows + i) * kQS + d);
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        kv4[j] = *reinterpret_cast<const float4*>(ks + (tx + 8 * j) * kQS + d);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv4[j].x, a);
          a = fmaf(qv[i].y, kv4[j].y, a);
          a = fmaf(qv[i].z, kv4[j].z, a);
          a = fmaf(qv[i].w, kv4[j].w, a);
          s[i][j] = a;
        }
    }

    // mask, online softmax (a row's 8 threads are 8 neighbouring lanes)
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = q0 + ty * kRows + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kpos = k0 + tx + 8 * j;
        bool ok = kpos < Skv;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        s[i][j] = ok ? s[i][j] : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);        // finite: m starts at -1e30
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_new);    // masked: exp(-inf) = 0
        sum += p;
        ps[(ty * kRows + i) * kPStride + tx + 8 * j] = p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * kDG; ++c) o[i][c] *= alpha;
    }
    __syncthreads();

    // O += P V for rows ty*kRows + i, columns tx*4 + 32g + e
#pragma unroll 2
    for (int c = 0; c < kBK; c += 4) {
      float4 pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        pv[i] = *reinterpret_cast<const float4*>(ps + (ty * kRows + i) * kPStride + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float4 vv[kDG];
#pragma unroll
        for (int g = 0; g < kDG; ++g)
          vv[g] = *reinterpret_cast<const float4*>(vs + (c + cc) * HD + tx * 4 + 32 * g);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float p = cc == 0 ? pv[i].x : cc == 1 ? pv[i].y : cc == 2 ? pv[i].z : pv[i].w;
#pragma unroll
          for (int g = 0; g < kDG; ++g) {
            o[i][4 * g + 0] = fmaf(p, vv[g].x, o[i][4 * g + 0]);
            o[i][4 * g + 1] = fmaf(p, vv[g].y, o[i][4 * g + 1]);
            o[i][4 * g + 2] = fmaf(p, vv[g].z, o[i][4 * g + 2]);
            o[i][4 * g + 3] = fmaf(p, vv[g].w, o[i][4 * g + 3]);
          }
        }
      }
    }
  }

  T* ob = out + (static_cast<size_t>(b) * Sq * H + h) * HD;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qpos = q0 + ty * kRows + i;
    if (qpos >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* row = ob + static_cast<size_t>(qpos) * q_row;
#pragma unroll
    for (int g = 0; g < kDG; ++g)
      store4(row + tx * 4 + 32 * g, o[i][4 * g] * inv, o[i][4 * g + 1] * inv,
             o[i][4 * g + 2] * inv, o[i][4 * g + 3] * inv);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B, int Sq,
           int Skv, int H, int KV, int causal, int window, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_floats<HD>() * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), Sq, Skv, H, KV, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* out, int B, int Sq,
              int Skv, int H, int KV, int hd, int causal, int window, float scale,
              cudaStream_t s) {
  switch (hd) {
    case 64: return launch<T, 64>(q, k, v, out, B, Sq, Skv, H, KV, causal, window, scale, s);
    case 128: return launch<T, 128>(q, k, v, out, B, Sq, Skv, H, KV, causal, window, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; hd in {64, 128}; window <= 0 means
// none.  Returns the cudaError_t of the launch.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* out, int B, int Sq, int Skv, int H,
                                      int KV, int hd, int dtype, int causal,
                                      int window, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || KV <= 0 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_hd<float>(q, k, v, out, B, Sq, Skv, H, KV, hd, causal, window, scale, s);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(q, k, v, out, B, Sq, Skv, H, KV, hd, causal, window,
                                    scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
