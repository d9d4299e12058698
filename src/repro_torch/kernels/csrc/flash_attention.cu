// Blocked online-softmax GQA attention over a whole sequence (flash
// attention, forward only), for sm_90a.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::_flash_kernel
// (pallas_call in flash_attention(), line 102).
//
// q [B,Sq,H,hd], k/v [B,Skv,KV,hd] (row-major, contiguous), out [B,Sq,H,hd]
// in q's type, hd in {64, 128}.  Query head h reads kv head h % KV (the
// reference's [g, kv] grouping) straight from the [B,S,KV,hd] layout: no
// transpose and no K/V replication.  Key kpos is visible to query qpos (both
// counted from 0, also when Sq != Skv) iff kpos < Skv, kpos <= qpos when
// causal, and kpos > qpos - window when a window is given.  Scores are
// scaled by 1/sqrt(hd); the softmax statistics (running max m, running sum
// l) and the output accumulator are f32.  A row that sees no key ends with
// l = 0 and is written as 0 (the Pallas kernel's max(l, 1e-30)).  Any Sq and
// Skv: ragged tails are zero-filled and masked.
//
// What bounds it on an H100: operations, 4 flops per visible (query, key,
// head-dim) triple (QK^T and PV), each K/V tile reused by every row of a
// query tile.  Two bodies:
//
// bf16: a warp-specialised wgmma kernel, so the products run on the tensor
// cores (989 TFLOP/s) instead of in f32 SIMT (67):
//   * one 384-thread block per (head, batch, 128-row query tile), the heavy
//     (late, causal) query tiles of every head launched first.  Warpgroup 0
//     is the producer: one thread loads Q once and then K and V tiles of 64
//     keys through a 4-D TMA tensor map over [B,S,KV,hd] into a 4-stage
//     mbarrier ring, 128-byte swizzled.  Warpgroups 1 and 2 own 64 query
//     rows each and take the registers the producer gives up (setmaxnreg).
//     Registers set the kv tile: a consumer thread holds O (hd/2 f32), S
//     (32 f32) and P_hi, P_lo (16 bf16x2 each); with 128-key tiles S and P
//     double and ptxas, which allocates within the launch's 168 per thread,
//     spills;
//   * S = Q K^T is an SS wgmma (both K-major, bf16, f32 accumulator, so the
//     products are exact); the scale is applied to S in f32 after the
//     product (folded with log2(e) for exp2), as the plain version scales
//     the f32 scores;
//   * each consumer classifies every kv tile against its 64 rows: hidden
//     from all of them (no product, the slot is only released), fully
//     visible (no mask work), or cut by the causal diagonal, the window's
//     edge or the ragged end (masked per element).  The producer loads only
//     the tiles some row of the block can see;
//   * P V keeps P to about 16 bits: P = P_hi + P_lo, each bf16, is taken from
//     the S accumulator's registers into the RS A-fragment layout, and two RS
//     wgmmas (V MN-major through the transpose bit, exact in bf16) add P_hi V
//     and P_lo V into one f32 O accumulator.  One bf16 P would round each
//     weight by up to 2^-9, more than a per-element bf16 check allows for
//     outputs near zero; the split costs 1.5x the tensor work of one pass;
//   * a tile's P V wgmmas stay in flight while the next tile's S is issued,
//     so the tensor cores run the two back to back; its ring slot is
//     released once they complete.  exp2 is one MUFU.EX2 (flush to zero).
//
// f32: the SIMT kernel (flash_attention_kernel): f32 has no tensor-core path
// without TF32 rounding, so it stays exact in f32 FMAs:
//   * one 128-thread block per (query tile of 64 rows, query head, batch);
//     heavy (late, causal) query tiles are launched first;
//   * the block walks the kv tiles (32 keys) in order with an online
//     softmax; kv tiles that the causal mask or the window hides from every
//     row of the query tile are never loaded or computed, so the work is
//     the visible triangle or band, not the square;
//   * each thread owns 4 query rows x 4 keys of S = Q K^T and 4 rows x hd/8
//     columns of the output, reading 16-byte vectors from shared memory
//     laid out so that no load of a warp meets a bank conflict;
//   * Q is pre-scaled when staged, and P stays f32 for P @ V, as in the
//     Pallas kernel.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

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

__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
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

// ---------------------------------------------------------------------------
// bf16: the wgmma kernel (see the notes at the top).
// ---------------------------------------------------------------------------

constexpr int kTcBQ = 128;        // query rows per block: two consumer warpgroups of 64
constexpr int kTcBK = 64;         // keys per kv tile
constexpr int kTcThreads = 384;   // producer warpgroup + two consumer warpgroups

template <int HD>
struct TcShape {
  static constexpr int kBoxes = HD / 64;               // 64-wide swizzle boxes per row
  static constexpr int kStages = 4;
  static constexpr uint32_t kQBox = kTcBQ * 128;       // one box: 128 bytes of each row
  static constexpr uint32_t kKVBox = kTcBK * 128;
  static constexpr uint32_t kQBytes = kBoxes * kQBox;
  static constexpr uint32_t kStageBytes = 2 * kBoxes * kKVBox;   // K boxes, then V boxes
  static constexpr size_t kSmem =
      1024 + kQBytes + kStages * kStageBytes + (2 * kStages + 1) * sizeof(uint64_t);
};

enum TileKind { kHidden = 0, kFull = 1, kMasked = 2 };

// The keys [*kmin, *kmax] that some query row in [lo, hi] sees (empty when
// *kmin > *kmax); every key in the range is seen by some row.
__device__ __forceinline__ void seen_keys(int lo, int hi, int Skv, int causal, int window,
                                          int* kmin, int* kmax) {
  *kmin = window > 0 ? max(0, lo - window + 1) : 0;
  *kmax = causal ? min(hi, Skv - 1) : Skv - 1;
}

// How the query rows [lo, hi] (hi < lo: none) meet the keys [k0, k1].
__device__ __forceinline__ int classify(int lo, int hi, int k0, int k1, int Skv, int causal,
                                        int window) {
  if (hi < lo) return kHidden;
  int kmin, kmax;
  seen_keys(lo, hi, Skv, causal, window, &kmin, &kmax);
  if (kmin > kmax || k0 > kmax || k1 < kmin) return kHidden;
  const bool full = k1 < Skv && (!causal || k1 <= lo) && (window <= 0 || k0 > hi - window);
  return full ? kFull : kMasked;
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int Skv, int causal, int window) {
  return kpos < Skv && (!causal || kpos <= qpos) && (window <= 0 || kpos > qpos - window);
}

// 2^x in one MUFU.EX2 (results below 2^-126 flush to 0: far below what a
// softmax weight can add to a sum that holds a 1).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int HD>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                             const __grid_constant__ CUtensorMap kmap,
                             const __grid_constant__ CUtensorMap vmap,
                             __nv_bfloat16* __restrict__ out, int Sq, int Skv, int H, int KV,
                             int causal, int window, float scale_log2) {
  using namespace hopper;
  using Shape = TcShape<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = align1024(smem_raw);
  uint8_t* ring = qs + Shape::kQBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + Shape::kStages * Shape::kStageBytes);
  uint64_t* empty = full + Shape::kStages;
  uint64_t* qbar = empty + Shape::kStages;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kTcBQ;   // late (heavy) tiles first
  int kmin, kmax;
  seen_keys(q0, min(q0 + kTcBQ, Sq) - 1, Skv, causal, window, &kmin, &kmax);
  const int kt_begin = kmin / kTcBK;
  const int kt_end = kmin <= kmax ? kmax / kTcBK + 1 : kt_begin;

  if (threadIdx.x == 0) {
    for (int s = 0; s < Shape::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    mbar_init(qbar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    reg_dealloc<24>();
    if (threadIdx.x == 0) {
      const int kvh = h % KV;
      mbar_expect_tx(qbar, Shape::kQBytes);
      for (int x = 0; x < Shape::kBoxes; ++x)
        tma_load_4d(qs + x * Shape::kQBox, &qmap, qbar, 64 * x, h, q0, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int kt = kt_begin; kt < kt_end; ++kt) {
        mbar_wait(&empty[stage], phase ^ 1);
        uint8_t* ks = ring + stage * Shape::kStageBytes;
        uint8_t* vs = ks + Shape::kBoxes * Shape::kKVBox;
        mbar_expect_tx(&full[stage], Shape::kStageBytes);
        for (int x = 0; x < Shape::kBoxes; ++x) {
          tma_load_4d(ks + x * Shape::kKVBox, &kmap, &full[stage], 64 * x, kvh, kt * kTcBK, b);
          tma_load_4d(vs + x * Shape::kKVBox, &vmap, &full[stage], 64 * x, kvh, kt * kTcBK, b);
        }
        if (++stage == Shape::kStages) { stage = 0; phase ^= 1; }
      }
    }
  } else {
    reg_alloc<240>();
    const int half = wg - 1;                       // query rows 64*half.. of the tile
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid / 32, lane = tid % 32;
    const int lo = q0 + 64 * half;
    const int hi = min(lo + 63, Sq - 1);
    const int row = lo + 16 * warp + lane / 4;     // this thread's rows: row, row + 8
    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    float m[2] = {-1e30f, -1e30f};                 // running max, log2 units
    float l[2] = {0.f, 0.f};                       // this thread's share of the row sums
    const uint32_t qa = smem_u32(qs) + half * 64 * 128;
    mbar_wait(qbar, 0);
    // P of the last computed tile, read by its P V wgmmas, which may still be
    // in flight while the next tile's S is issued; `pending` is that tile's
    // ring slot (-1: none), released once its P V has completed.
    uint32_t p_hi[16], p_lo[16];
    int pending = -1;
    int stage = 0;
    uint32_t phase = 0;
    for (int kt = kt_begin; kt < kt_end; ++kt) {
      const int k0 = kt * kTcBK;
      const int kind = classify(lo, hi, k0, k0 + kTcBK - 1, Skv, causal, window);
      mbar_wait(&full[stage], phase);
      if (kind == kHidden) {          // nothing to compute; keep no slot held
        if (pending >= 0) {
          wgmma_wait<0>();
          fence_regs<HD / 2>(o);
          if (lane == 0) mbar_arrive(&empty[pending]);
          pending = -1;
        }
        if (lane == 0) mbar_arrive(&empty[stage]);
        if (++stage == Shape::kStages) { stage = 0; phase ^= 1; }
        continue;
      }
      const uint32_t ka = smem_u32(ring + stage * Shape::kStageBytes);
      const uint32_t va = ka + Shape::kBoxes * Shape::kKVBox;
      float s[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss_m64n64k16<0>(
            s, desc_sw128(qa + (kk / 4) * Shape::kQBox + 32 * (kk % 4), 16, 1024),
            desc_sw128(ka + (kk / 4) * Shape::kKVBox + 32 * (kk % 4), 16, 1024), kk > 0);
      wgmma_commit();
      wgmma_wait<1>();                             // the previous tile's P V is done
      fence_regs<HD / 2>(o);
      fence_regs<16>(p_hi);
      fence_regs<16>(p_lo);
      if (pending >= 0 && lane == 0) mbar_arrive(&empty[pending]);
      wgmma_wait<0>();
      fence_regs<32>(s);

      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float t = s[4 * j + e] * scale_log2;
          if (kind == kMasked &&
              !visible(row + 8 * (e / 2), k0 + 8 * j + 2 * (lane % 4) + (e % 2), Skv, causal,
                       window))
            t = -INFINITY;
          s[4 * j + e] = t;
          mx[e / 2] = fmaxf(mx[e / 2], t);
        }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {        // a row's 4 threads are 4 neighbouring lanes
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);    // finite: m starts at -1e30
        alpha[r] = exp2_ftz(m[r] - m_new);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
      // P = P_hi + P_lo in the RS A-fragment order: k-step kk (keys
      // 16kk..16kk+15) is S columns 8(2kk)..8(2kk+1)+7, registers
      // (row, 2kk), (row + 8, 2kk), (row, 2kk + 1), (row + 8, 2kk + 1).
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float p0 = exp2_ftz(s[4 * j + 2 * r] - m[r]);   // masked: exp2(-inf) = 0
          const float p1 = exp2_ftz(s[4 * j + 2 * r + 1] - m[r]);
          l[r] += p0 + p1;
          const __nv_bfloat162 ph = __floats2bfloat162_rn(p0, p1);
          const float2 back = __bfloat1622float2(ph);
          const int i = 4 * (j / 2) + 2 * (j % 2) + r;
          p_hi[i] = *reinterpret_cast<const uint32_t*>(&ph);
          p_lo[i] = pack_bf16(p0 - back.x, p1 - back.y);     // exact differences
        }
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] *= alpha[(i % 4) / 2];
      fence_regs<HD / 2>(o);
      fence_regs<16>(p_hi);
      fence_regs<16>(p_lo);
      wgmma_fence();
#pragma unroll
      for (int part = 0; part < 2; ++part)
#pragma unroll
        for (int kk = 0; kk < kTcBK / 16; ++kk) {
          const uint32_t* a = (part == 0 ? p_hi : p_lo) + 4 * kk;
          const uint64_t vd = desc_sw128(va + 2048 * kk, Shape::kKVBox, 1024);
          if constexpr (HD == 128)
            wgmma_rs_m64n128k16<1>(o, a, vd, 1);
          else
            wgmma_rs_m64n64k16<1>(o, a, vd, 1);
        }
      wgmma_commit();                              // completes under the next S
      pending = stage;
      if (++stage == Shape::kStages) { stage = 0; phase ^= 1; }
    }
    wgmma_wait<0>();
    fence_regs<HD / 2>(o);
    fence_regs<16>(p_hi);
    fence_regs<16>(p_lo);
    if (pending >= 0 && lane == 0) mbar_arrive(&empty[pending]);

    __nv_bfloat16* ob = out + (static_cast<size_t>(b) * Sq * H + h) * HD + 2 * (lane % 4);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const float inv = 1.f / fmaxf(l[r], 1e-30f);
      const int qpos = row + 8 * r;
      if (qpos >= Sq) continue;
      __nv_bfloat16* dst = ob + static_cast<size_t>(qpos) * H * HD;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<uint32_t*>(dst + 8 * j) =
            pack_bf16(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
    }
  }
}

template <int HD>
int launch_wgmma(const void* q, const void* k, const void* v, void* out, int B, int Sq,
                 int Skv, int H, int KV, int causal, int window, float scale,
                 cudaStream_t stream) {
  using Shape = TcShape<HD>;
  constexpr uint64_t kRow = HD * sizeof(__nv_bfloat16);
  CUtensorMap qmap, kmap, vmap;
  const uint64_t qdims[4] = {HD, static_cast<uint64_t>(H), static_cast<uint64_t>(Sq),
                             static_cast<uint64_t>(B)};
  const uint64_t qstrides[3] = {kRow, kRow * H, kRow * H * Sq};
  const uint64_t kvdims[4] = {HD, static_cast<uint64_t>(KV), static_cast<uint64_t>(Skv),
                              static_cast<uint64_t>(B)};
  const uint64_t kvstrides[3] = {kRow, kRow * KV, kRow * KV * Skv};
  // 64 columns of one head at kTcBQ (Q) or kTcBK (K, V) positions
  const uint32_t qbox[4] = {64, 1, kTcBQ, 1};
  const uint32_t kvbox[4] = {64, 1, kTcBK, 1};
  int e = hopper::make_map(&qmap, q, 4, qdims, qstrides, qbox);
  if (e == 0) e = hopper::make_map(&kmap, k, 4, kvdims, kvstrides, kvbox);
  if (e == 0) e = hopper::make_map(&vmap, v, 4, kvdims, kvstrides, kvbox);
  if (e == 0) e = hopper::allow_smem(flash_attention_wgmma_kernel<HD>, Shape::kSmem);
  if (e != 0) return e;
  const dim3 grid(H, B, (Sq + kTcBQ - 1) / kTcBQ);
  flash_attention_wgmma_kernel<HD><<<grid, kTcThreads, Shape::kSmem, stream>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(out), Sq, Skv, H, KV, causal, window,
      scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
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
  if (dtype == 1 && hd == 64)
    return launch_wgmma<64>(q, k, v, out, B, Sq, Skv, H, KV, causal, window, scale, s);
  if (dtype == 1 && hd == 128)
    return launch_wgmma<128>(q, k, v, out, B, Sq, Skv, H, KV, causal, window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
