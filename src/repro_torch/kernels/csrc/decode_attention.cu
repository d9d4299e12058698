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
// What bounds it on an H100: bytes.  Each (b, kv) pair must stream its
// valid K/V prefix once (lengths[b] * hd * 2 values) and does 4 flops per
// streamed value pair per query row, far under the card's ~295 flops/byte
// ridge.  At serving's shape (B = 8, KV = 16) there are only 128 such pairs
// for 132 SMs, so the design splits the cache and keeps as many bytes in
// flight as it can (split-S flash-decoding), in one launch:
//   * grid (KV * ceil(G / GB), B, splits): a block owns GB (1 or 4) query
//     rows of one kv head, one sequence and one split of ceil(S / splits)
//     cache rows.  `splits` comes from the host (shapes only: 128-row splits,
//     4 at S = 512), never from lengths, which stay on the device;
//   * of a sequence's splits only the first `used` = ceil(lengths[b] /
//     split rows) hold rows; the others return at once.  None of them reads
//     a row at or past lengths[b], so a stale row (even a non-finite one)
//     cannot reach the output.  A length of 0 makes split 0 write zeros, as
//     the reference kernel does;
//   * inside a split, no block-wide barrier until the end: each of the 4
//     warps walks its own rows with 16-byte loads straight into registers
//     (P lanes per row, 32/P rows per load instruction: 2 rows of bf16 at
//     hd 128) and issues a batch of NB row steps' K and V loads before it
//     uses any.  Each lane keeps its slice of q and, per query row, a
//     running max, sum and acc in f32 registers; a row's score is a
//     lane-partial dot product plus a shuffle over the row's P lanes;
//   * the row groups of a warp merge by shuffles, the 4 warps once through
//     shared memory, each in a fixed order;
//   * with used = 1 (every length up to one split: all of serving's) the
//     split writes acc / max(l, 1e-30) itself.  With used > 1 each split
//     writes (m, l, acc [GB, hd]) in f32 to a workspace and counts itself
//     in an arrival counter of its (kv, b) block; the last to arrive
//     rescales by exp(m_s - m), sums splits 0..used-1 in that order, writes
//     the output and resets the counter.  Which split arrives last does not
//     change the order, so the output is bitwise reproducible.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T> struct Vec16;         // 16 bytes of T -> f32
template <> struct Vec16<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x); f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z); f[3] = __uint_as_float(u.w);
  }
};
template <> struct Vec16<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void unpack(const uint4& u, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
};

// Row steps whose K and V loads a warp has in flight at once.
template <int U, int GB>
__host__ __device__ constexpr int batch_steps() { return (GB == 1 ? 8 : 4) / U; }

// Lanes that share a cache row of `chunks` 16-byte vectors, U per lane: the
// least power of two that covers the row.
template <int U>
__host__ __device__ inline int lanes_per_row(int chunks) {
  int P = 1;
  while (P * U < chunks) P <<= 1;
  return P;
}

// One split of one (kv head, sequence) for GB query rows.  U: 16-byte
// vectors of a row per lane, P lanes per row (U <= 2, so hd <= 256 in f32
// and 512 in bf16).  ws holds [splits][B*H][hd] sums, then [splits][B*H]
// (m, l) pairs; arrivals one counter per (blockIdx.x, blockIdx.y), zero
// between launches.  Both may be null when gridDim.z is 1.
template <typename T, int U, int GB>
__global__ void __launch_bounds__(kThreads, 1)  // without the 1, ptxas spills <float, 1, 4>
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const int* __restrict__ lengths, T* __restrict__ out, float* ws,
                    int* __restrict__ arrivals, int B, int S, int KV, int G, int hd,
                    int split_len, float scale) {
  constexpr int E = Vec16<T>::kN;             // elements of one 16-byte vector
  constexpr int UE = U * E;                   // elements of a row per lane
  constexpr int NB = batch_steps<U, GB>();
  extern __shared__ __align__(16) float red[];  // [kWarps][GB][hd], then [kWarps][GB][2]
  __shared__ int last;

  const int gblocks = (G + GB - 1) / GB;
  const int kv = blockIdx.x / gblocks;
  const int g0 = (blockIdx.x % gblocks) * GB;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int H = G * KV;
  const int BH = B * H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  auto out_at = [&](int g, int d) {           // row g of the block is query head h
    return (static_cast<size_t>(b) * H + (g0 + g) * KV + kv) * hd + d;
  };

  int len = S;
  if (lengths != nullptr) {
    len = lengths[b];
    len = len < 0 ? 0 : (len > S ? S : len);
  }
  const int used = len == 0 ? 0 : (len + split_len - 1) / split_len;  // splits with rows
  if (split >= max(used, 1)) return;
  if (used == 0) {                              // nothing to attend: exact zeros
    for (int i = tid; i < GB * hd; i += kThreads)
      if (g0 + i / hd < G) store(out + out_at(i / hd, i % hd), 0.f);
    return;
  }
  const int r0 = split * split_len;
  const int r1 = min(r0 + split_len, len);      // rows [r0, r1): valid, this split

  const int chunks = hd / E;                    // 16-byte vectors per row
  const int P = lanes_per_row<U>(chunks);
  const int R = 32 / P;                         // rows per warp step
  const int rg = lane / P, pl = lane % P;       // row group, lane within the row

  float qf[GB][UE], acc[GB][UE], m[GB], l[GB];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = -1e30f;
    l[g] = 0.f;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = pl + P * u;
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if (g0 + g < G && c < chunks)
        raw = *reinterpret_cast<const uint4*>(q + out_at(g, c * E));
      Vec16<T>::unpack(raw, &qf[g][u * E]);
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][u * E + e] = 0.f;
    }
  }

  const size_t row_stride = static_cast<size_t>(KV) * hd;
  const T* kbase = k + (static_cast<size_t>(b) * S * KV + kv) * hd;
  const T* vbase = v + (static_cast<size_t>(b) * S * KV + kv) * hd;
  const int steps = (r1 - r0 + R - 1) / R;

  for (int st0 = warp * NB; st0 < steps; st0 += kWarps * NB) {
    uint4 kr[NB][U], vr[NB][U];
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const int row = r0 + (st0 + i) * R + rg;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int c = pl + P * u;
        if (row < r1 && c < chunks) {
          const size_t off = static_cast<size_t>(row) * row_stride + c * E;
          kr[i][u] = *reinterpret_cast<const uint4*>(kbase + off);
          vr[i][u] = *reinterpret_cast<const uint4*>(vbase + off);
        } else {
          kr[i][u] = make_uint4(0u, 0u, 0u, 0u);
          vr[i][u] = make_uint4(0u, 0u, 0u, 0u);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const bool valid = r0 + (st0 + i) * R + rg < r1;   // the same for the row's lanes
      float kf[UE], vf[UE];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        Vec16<T>::unpack(kr[i][u], &kf[u * E]);
        Vec16<T>::unpack(vr[i][u], &vf[u * E]);
      }
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < UE; ++e) s = fmaf(qf[g][e], kf[e], s);
        for (int o = P / 2; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
        if (valid) {
          s *= scale;
          const float m_new = fmaxf(m[g], s);
          const float alpha = expf(m[g] - m_new);
          const float p = expf(s - m_new);
          l[g] = l[g] * alpha + p;
#pragma unroll
          for (int e = 0; e < UE; ++e) acc[g][e] = fmaf(acc[g][e], alpha, p * vf[e]);
          m[g] = m_new;
        }
      }
    }
  }

  // merge the row groups of the warp: lanes P, 2P, .. 16 apart hold the
  // same slice of other rows
  for (int o = P; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      const float mo = __shfl_xor_sync(kFull, m[g], o);
      const float lo = __shfl_xor_sync(kFull, l[g], o);
      const float mn = fmaxf(m[g], mo);
      const float a = expf(m[g] - mn), ao = expf(mo - mn);
      l[g] = l[g] * a + lo * ao;
#pragma unroll
      for (int e = 0; e < UE; ++e) {
        const float ac = __shfl_xor_sync(kFull, acc[g][e], o);
        acc[g][e] = acc[g][e] * a + ac * ao;
      }
      m[g] = mn;
    }
  }

  // merge the warps, in warp order, through shared memory
  float* ml = red + kWarps * GB * hd;
  if (rg == 0) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int c = pl + P * u;
        if (c < chunks)
#pragma unroll
          for (int e = 0; e < E; ++e) red[(warp * GB + g) * hd + c * E + e] = acc[g][u * E + e];
      }
      if (lane == 0) {
        ml[2 * (warp * GB + g)] = m[g];
        ml[2 * (warp * GB + g) + 1] = l[g];
      }
    }
  }
  __syncthreads();
  float* ws_ml = used > 1 ? ws + static_cast<size_t>(gridDim.z) * BH * hd : nullptr;
  for (int i = tid; i < GB * hd; i += kThreads) {
    const int g = i / hd, d = i % hd;
    if (g0 + g >= G) continue;
    float mx = -1e30f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, ml[2 * (w * GB + g)]);
    float lsum = 0.f, asum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(ml[2 * (w * GB + g)] - mx);
      lsum += ml[2 * (w * GB + g) + 1] * f;
      asum += red[(w * GB + g) * hd + d] * f;
    }
    if (used == 1) {
      store(out + out_at(g, d), asum / fmaxf(lsum, 1e-30f));
      continue;
    }
    const size_t at = static_cast<size_t>(split) * BH + out_at(g, 0) / hd;
    ws[at * hd + d] = asum;
    if (d == 0) {
      ws_ml[2 * at] = mx;
      ws_ml[2 * at + 1] = lsum;
    }
  }
  if (used == 1) return;

  // count this split in; the last of the `used` to arrive merges them all
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int cid = blockIdx.y * gridDim.x + blockIdx.x;
    last = atomicAdd(&arrivals[cid], 1) == used - 1;
    if (last) arrivals[cid] = 0;              // every split of the pair has arrived
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = tid; i < GB * hd; i += kThreads) {
    const int g = i / hd, d = i % hd;
    if (g0 + g >= G) continue;
    const size_t bh = out_at(g, 0) / hd;
    float mx = -1e30f;
    for (int s = 0; s < used; ++s) mx = fmaxf(mx, __ldcg(ws_ml + 2 * (s * BH + bh)));
    float lsum = 0.f, asum = 0.f;
    for (int s = 0; s < used; ++s) {
      const size_t at = static_cast<size_t>(s) * BH + bh;
      const float f = expf(__ldcg(ws_ml + 2 * at) - mx);
      lsum += __ldcg(ws_ml + 2 * at + 1) * f;
      asum += __ldcg(ws + at * hd + d) * f;
    }
    store(out + out_at(g, d), asum / fmaxf(lsum, 1e-30f));
  }
}

template <typename T, int U, int GB>
int launch_split(const T* q, const T* k, const T* v, const int* lengths, T* out, float* ws,
                 int* arrivals, int B, int S, int KV, int G, int hd, int splits,
                 float scale, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kWarps) * GB * (hd + 2) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(decode_split_kernel<T, U, GB>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int split_len = (S + splits - 1) / splits;
  const dim3 grid(KV * ((G + GB - 1) / GB), B, splits);
  decode_split_kernel<T, U, GB><<<grid, kThreads, smem, stream>>>(
      q, k, v, lengths, out, ws, arrivals, B, S, KV, G, hd, split_len, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int U>
int launch_u(const T* q, const T* k, const T* v, const int* lengths, T* out, float* ws,
             int* arrivals, int B, int S, int KV, int G, int hd, int splits, float scale,
             cudaStream_t stream) {
  if (G == 1)
    return launch_split<T, U, 1>(q, k, v, lengths, out, ws, arrivals, B, S, KV, G, hd, splits,
                                 scale, stream);
  return launch_split<T, U, 4>(q, k, v, lengths, out, ws, arrivals, B, S, KV, G, hd, splits,
                               scale, stream);
}

template <typename T>
int launch(const void* qp, const void* kp, const void* vp, const void* lengths, void* outp,
           void* wsp, void* arrivals, int B, int S, int H, int KV, int hd, int splits,
           float scale, cudaStream_t stream) {
  const T* q = static_cast<const T*>(qp);
  const T* k = static_cast<const T*>(kp);
  const T* v = static_cast<const T*>(vp);
  const int* len = static_cast<const int*>(lengths);
  T* out = static_cast<T*>(outp);
  float* ws = static_cast<float*>(wsp);
  int* arr = static_cast<int*>(arrivals);
  const int G = H / KV;
  const int chunks = hd / Vec16<T>::kN;
  if (chunks <= 32)
    return launch_u<T, 1>(q, k, v, len, out, ws, arr, B, S, KV, G, hd, splits, scale, stream);
  if (chunks <= 64)
    return launch_u<T, 2>(q, k, v, len, out, ws, arr, B, S, KV, G, hd, splits, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The layout of the instance that runs hd (`chunks` 16-byte vectors a row,
// at most 64) and G: {query rows a block, lanes a cache row, row steps a
// batch}.
template <int U>
void layout_u(int chunks, int G, int* want) {
  want[0] = G == 1 ? 1 : 4;
  want[1] = lanes_per_row<U>(chunks);
  want[2] = G == 1 ? batch_steps<U, 1>() : batch_steps<U, 4>();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  `splits` >= 1 divides the S cache rows
// into splits of ceil(S / splits).  With splits > 1, `ws` is an f32
// workspace of splits * B * H * (hd + 2) elements and `arrivals` an int32
// array of KV * ceil(G / gb) * B counters that are zero (the kernel leaves
// them zero); both are unused, and may be null, at 1.  Returns the
// cudaError_t of the launch.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* lengths, void* out, void* ws,
                                       void* arrivals, int B, int S, int H, int KV, int hd,
                                       int splits, int dtype, float scale, void* stream) {
  if (B <= 0 || KV <= 0 || H % KV != 0 || hd % 8 != 0 || hd <= 0 || splits < 1 ||
      (splits > 1 && (ws == nullptr || arrivals == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, lengths, out, ws, arrivals, B, S, H, KV, hd, splits, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, lengths, out, ws, arrivals, B, S, H, KV, hd, splits,
                                 scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// 0 if the kernel that runs head_dim hd and G query rows per kv head in
// `dtype` has the host's layout (gb query rows a block, `lanes` lanes a
// cache row, nb row steps a batch), else cudaErrorInvalidValue.  The
// wrapper asks once per shape, so that its replayed layout is the kernel's.
extern "C" int decode_attention_layout_check(int hd, int G, int dtype, int gb, int lanes,
                                             int nb) {
  if (hd <= 0 || hd % 8 != 0 || G <= 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = hd * (dtype == 0 ? 4 : 2) / 16;
  if (chunks > 64) return static_cast<int>(cudaErrorInvalidValue);
  int want[3];
  if (chunks <= 32) layout_u<1>(chunks, G, want);
  else layout_u<2>(chunks, G, want);
  return want[0] == gb && want[1] == lanes && want[2] == nb
             ? 0 : static_cast<int>(cudaErrorInvalidValue);
}
