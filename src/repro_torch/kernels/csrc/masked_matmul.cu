// FedAP structured-pruning matmul for sm_90a: the forward y = x @ w (K1) and
// its two backward products dx = dy @ w^T (K2) and dw = x^T @ dy (K3), with
// pruned 128-column blocks of w skipped.
//
// Replaces the TPU kernels of repro/kernels/masked_matmul.py:
//   K1 _masked_mm_kernel (pallas_call in _fwd_call(), line 122),
//   K2 _masked_dx_kernel (pallas_call in _dx_call(), line 142),
//   K3 _masked_dw_kernel (pallas_call in _dw_call(), line 162).
//
// Shapes: x [M,K], w [K,N], dy [M,N], block_mask float32 [N/128]; every
// operand row-major and contiguous; K and N are multiples of 128, M is any
// size.  Column block j of w is kept iff block_mask[j] > 0 (NaN counts as
// pruned), read on the device.  Sums run in f32; outputs have the inputs'
// type (float32 or bfloat16).
//   K1: pruned column blocks of y are written as zeros; w there is never read.
//   K2: the contraction over N skips pruned blocks (exact: the forward zeroed
//       those output columns, so their cotangent never contributes).
//   K3: pruned column blocks of dw are written as exact zeros; x and dy are
//       not read for them.
//
// What bounds them on an H100, and the bodies below.
//   * K1 at decode (M = serving slots, <= 64), either type: bytes.  Each w
//     element read feeds at most M multiply-adds, so the best the kernel can
//     do is read the kept blocks of w once at the memory's rate.  The decode
//     body is a streaming split-K GEMV: a block owns 64 columns (half a mask
//     block) and one of `splits` shares of the contraction, with `splits` a
//     function of the shapes and the SM count only, never of the mask (5 at
//     K = 2048, N = 8192 on 132 SMs: 640 blocks with every block kept, 320
//     with half kept, at least 2 per SM either way).  The block's w slice
//     streams through a ring of 32-row stages in shared memory filled by
//     16-byte cp.async, the next stages in flight while one is used (6
//     stages of bf16, 3 of f32).  In bf16 the products run on the tensor
//     cores (mma.sync m16n8k16, bf16 operands, f32 sums; x staged once by
//     cp.async as bf16): with f32 FMAs, the issue time of 8 multiply-adds
//     per 2 bytes read did not overlap the stream.  In f32
//     (4 per 4 bytes) the body is SIMT, x staged once as f32 with 16-byte
//     loads.  The warps' sums meet in shared memory in a fixed order.  With
//     more than one split each block writes an f32 partial to a workspace,
//     and the last block of a column tile to arrive (an arrival counter,
//     left at zero for the next call) sums the partials in split order and
//     writes y: no atomic add of a partial sum, bitwise reproducible, no
//     allocation and no host sync per call.  What is left is the read
//     itself: under chip_smoke.py's timer (L2 flushed by a write) a bare
//     read of the same bytes takes ~2x the byte bound (PERF.md).
//   * K1 in bf16 at M > 64 (masked scoring: M = 8192, K = 2048, N = 8192):
//     operations, 2*M*K*N_kept flops over 2 bytes per element is ~2700
//     flops per byte, far above the ~295 at which 989 TFLOP/s of bf16
//     tensor cores meet 3.35 TB/s.  Only wgmma reaches that rate, so this
//     path is a warp-specialised wgmma GEMM: 256x128 output tiles (one mask
//     block per tile column), a producer warpgroup whose one thread keeps
//     TMA loads of x [256 x 64] and w [64 x 128] in a 4-stage mbarrier ring,
//     two consumer warpgroups of 128 rows each issuing m64n128k16 wgmmas
//     for two 64-row halves (w read MN-major with the transpose bit) into
//     f32 registers, and a persistent grid of one block per SM walking the
//     tiles so that one tile's stores overlap the next tile's loads.  A
//     256-row tile uses each w tile for twice the rows a 128-row tile
//     does, so fewer bytes cross from L2 per flop: at M = 8192 it ran
//     faster than 128x128 tiles with the same ring.  A pruned tile writes
//     zeros and loads nothing; rows past M arrive as TMA's zero fill and
//     are not stored.
//   * K1 in f32 at M > 64 and K3 (training shapes M = 512, K = 2048,
//     N = 8192; K3 also in bf16): operations.  2*M*K*N_kept flops over
//     (M*K + K*N + M*N) elements is ~230 flops per f32 element, above the
//     20 flops per byte at which 67 TFLOP/s of f32 (no TF32: the products
//     are held to f32) meets 3.35 TB/s.  The GEMM body below is a SIMT f32
//     GEMM with 256x128 output tiles and 8x16 sums per thread, both operands
//     MN-major (K3's x^T and dy, K1's w; K1's x is first transposed by a
//     small launch, as the body read it K-major more slowly), streamed
//     untransposed into [k][m] rows through a 2-stage cp.async ring of
//     64-deep stages and read with 16-byte loads.  Rows past P or R are
//     zero-filled; C is stored 16 bytes at a time.  The grid is persistent,
//     one block per SM, each block taking kept tiles by rank so that
//     pruning shortens every walk alike, and the ring runs on across tile
//     boundaries, so a tile's stores overlap the next tile's first loads:
//     that hides the fill and drain of K3's short (512-deep) contraction
//     over its 512 tiles.  Tensor cores are not used: TF32 would round the
//     f32 operands.
//   * K2 (training: dx [512, 2048] from a contraction over N = 8192; also
//     bf16): operations, as K1 in f32.  Its long dimension is the
//     contraction and its output is small: 32 tiles of 256x128 for 132 SMs.
//     So the split kernel further down divides the kept N-blocks of the
//     contraction among `splits` blocks per output tile (4 at the training
//     shape: 128 blocks, one wave at one block per SM).  Each block counts
//     the kept blocks of the mask itself (no host read) and takes its
//     balanced share by rank, so pruning never leaves a split idle while
//     another works.  Both operands have the contraction contiguous, so
//     they are copied untransposed with 16-byte cp.async into a 3-stage ring
//     of 32-deep tiles whose padded rows keep the inner loop's shared loads
//     conflict-free; each thread keeps 8x16 f32 sums.  The splits' f32
//     partial tiles go to a workspace and a second kernel sums them in split
//     order (bitwise reproducible, no atomics) and casts once to the output
//     type.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kBlockN = 128;            // mask granularity (columns)

// E consecutive elements (global or shared memory) -> f32
template <typename T, int E> struct Load;
template <> struct Load<float, 4> {
  __device__ static void run(const float* p, float* r) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    r[0] = v.x; r[1] = v.y; r[2] = v.z; r[3] = v.w;
  }
};
template <> struct Load<float, 2> {
  __device__ static void run(const float* p, float* r) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    r[0] = v.x; r[1] = v.y;
  }
};
template <> struct Load<__nv_bfloat16, 4> {
  __device__ static void run(const __nv_bfloat16* p, float* r) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    r[0] = a.x; r[1] = a.y; r[2] = b.x; r[3] = b.y;
  }
};
template <> struct Load<__nv_bfloat16, 2> {
  __device__ static void run(const __nv_bfloat16* p, float* r) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    r[0] = a.x; r[1] = a.y;
  }
};

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = hopper::pack_bf16(a, b);
}
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(hopper::pack_bf16(v[0], v[1]), hopper::pack_bf16(v[2], v[3]));
}

// 16-byte global -> shared copy, zero-filled (nothing read) when !valid.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// K1 at decode (M <= 64): the streaming split-K GEMV (see the notes at the
// top).  Grid (N/64, splits): block (x, y) owns columns [64x, 64x + 64) and
// ring stages [y*per, min((y+1)*per, K/32)) of the contraction (a stage is
// 32 rows of w), for 8*MT staged rows of x (rows past M are zeros).  Only
// split 0 of a pruned column tile writes its zeros; no block of it reads
// anything.  Two bodies share the schedule, the ring and the merge:
//   bf16: tensor cores.  The stage's w and the block's x stay bf16 in
//     shared memory (both copied by cp.async, rows padded by 16 bytes so
//     that ldmatrix reads them without bank conflicts).  Warp wp takes
//     columns 16*(wp%4).. and contraction rows 16*(wp/4).. of each stage:
//     one ldmatrix.x4.trans gives it w^T as the A operand of
//     mma.m16n8k16 (16 columns x 16 k), one ldmatrix.x2 per 8 rows of x
//     the B operand, and the f32 sums stay in the accumulator.  Products
//     of bf16 are exact in f32, so this differs from f32 FMAs only in how
//     the additions round.
//   f32: SIMT.  x is staged as f32 [k][8*MT], so that two 16-byte shared
//     loads give the whole warp 8 rows of x at one k; warp wp, lane l sums
//     rows wp + 8j (j < 4) of each stage into columns 2l and 2l + 1.
// The warps' sums meet in shared memory in warp order; with more than one
// split each block writes an f32 partial, and the last of the column
// tile's splits to arrive adds them in split order and writes y.
// ---------------------------------------------------------------------------

constexpr int kGvCols = 64;             // columns of w a block
constexpr int kGvBK = 32;               // rows of w a ring stage
constexpr int kGvThreads = 256;
constexpr int kGvXBytes = 65536;        // the most staged x a block holds (as f32)
constexpr int kDecodeMaxM = 64;         // K1 runs this body up to here
constexpr int kGvRedLd = kGvCols + 4;   // row pitch of the warp sums (floats)

template <typename T> struct GvTile;
template <> struct GvTile<float> {
  static constexpr int kLdW = kGvCols;                          // w row pitch
  static constexpr int kStages = 3;                              // 24 KB
};
template <> struct GvTile<__nv_bfloat16> {
  static constexpr int kLdW = kGvCols + 8;                       // +16 bytes
  static constexpr int kStages = 6;                              // 27 KB
};
template <typename T> struct GvRing {
  static constexpr int kStage = kGvBK * GvTile<T>::kLdW;        // elements
  static constexpr int kBytes = GvTile<T>::kStages * kStage * static_cast<int>(sizeof(T));
  static constexpr int kVec = 16 / sizeof(T);                    // elements a copy
  static constexpr int kRowCopies = kGvCols / kVec;              // copies a w row
  static constexpr int kStep = kGvThreads / kRowCopies;          // rows between a thread's copies
  static constexpr int kCopies = kGvBK / kStep;                  // a thread's copies a stage
};

struct GvPlan {
  int mt;      // 8-row groups of x staged (1, 2, 4 or 8)
  int splits;  // shares of the contraction
  int per;     // ring stages a share (the last one may have fewer)
};

// The decode body's schedule, from the shapes and the SM count only: the
// K/32 ring stages are cut into splits of `per` stages, as deep as lets 4
// blocks run per SM with every column block kept (so 2 with half kept),
// shallower where a split's staged x would pass kGvXBytes.
// masked_matmul.decode_plan is its copy on the host.
inline GvPlan gv_plan(int M, int K, int N, int sms) {
  GvPlan g;
  g.mt = M <= 8 ? 1 : M <= 16 ? 2 : M <= 32 ? 4 : 8;
  const int stages = K / kGvBK;
  const int tiles = N / kGvCols;
  const int cap = kGvXBytes / (kGvBK * 8 * g.mt * 4);   // stages whose x fits
  int want = (4 * sms + tiles - 1) / tiles;
  const int need = (stages + cap - 1) / cap;
  if (want < need) want = need;
  if (want > stages) want = stages;
  if (want < 1) want = 1;
  g.per = (stages + want - 1) / want;
  g.splits = (stages + g.per - 1) / g.per;
  return g;
}

// int32 arrival counters at the head of the workspace (one a column tile,
// rounded up to 16 bytes); the f32 partials [splits][M][N] follow.
inline int gv_counters(int N) { return (N / kGvCols + 3) / 4 * 4; }

// Shared memory of a decode block: the ring, then x (bf16 [8*MT][kc + 8],
// or f32 [kc][8*MT]), kc = 32*per.
template <typename T>
size_t gv_smem(int mt, int per) {
  const size_t kc = static_cast<size_t>(per) * kGvBK;
  const size_t x = std::is_same<T, float>::value ? kc * 8 * mt * sizeof(float)
                                                 : 8 * mt * (kc + 8) * sizeof(T);
  return GvRing<T>::kBytes + x;
}

// A stage's w copies: rows lrow + n * kStep of the block's 64 columns.
template <typename T>
__device__ __forceinline__ void gv_load(T* ring, const T* src, int t, int N, int lrow,
                                        int lcol) {
  using R = GvRing<T>;
  T* dst = ring + (t % GvTile<T>::kStages) * R::kStage + lrow * GvTile<T>::kLdW + lcol;
  const T* s = src + static_cast<size_t>(t) * kGvBK * N;
#pragma unroll
  for (int n = 0; n < R::kCopies; ++n)
    cp_async16(dst + n * R::kStep * GvTile<T>::kLdW, s + static_cast<size_t>(n) * R::kStep * N,
               true);
}

// The block's sum s for row m of x, columns col0 + rc, rc + 1: to y (one
// split) or to this split's partial.
template <typename T>
__device__ __forceinline__ void gv_emit(float2 s, T* y, float* part, int M, int N, int col0,
                                        int m, int rc, int split, int splits) {
  if (m >= M) return;
  const size_t at = static_cast<size_t>(m) * N + col0 + rc;
  if (splits == 1)
    store2(y + at, s.x, s.y);
  else
    *reinterpret_cast<float2*>(part + static_cast<size_t>(split) * M * N + at) = s;
}

// Count this split in; the last of the column tile's splits to arrive adds
// their partials in split order and writes y.  The arrival is a release
// (after the block's barrier) and an acquire for the last block, so the
// partials it reads are the others' finished ones; it resets the counter.
template <typename T>
__device__ __forceinline__ void gv_merge(const float* part, int* arrivals, T* y, int M, int N,
                                         int col0, int tile, int splits, int tid, int* last) {
  __syncthreads();                             // this block's partial is written
  if (tid == 0) {
    int old;
    asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;\n"
                 : "=r"(old) : "l"(arrivals + tile) : "memory");
    *last = old == splits - 1;
    if (*last) arrivals[tile] = 0;             // every split of the tile has arrived
  }
  __syncthreads();
  if (!*last) return;
  for (int i = tid; i < M * (kGvCols / 2); i += kGvThreads) {
    const size_t at = static_cast<size_t>(i / (kGvCols / 2)) * N + col0 + 2 * (i % (kGvCols / 2));
    float2 s = __ldcg(reinterpret_cast<const float2*>(part + at));
    for (int sp = 1; sp < splits; ++sp) {
      const float2 o =
          __ldcg(reinterpret_cast<const float2*>(part + static_cast<size_t>(sp) * M * N + at));
      s.x += o.x;
      s.y += o.y;
    }
    store2(y + at, s.x, s.y);
  }
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s) : "memory");
}
__device__ __forceinline__ void ldsm_x2(uint32_t* r, const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(s) : "memory");
}
// d[16 x 8] += a[16 x 16] b[16 x 8], bf16 operands, f32 sums.
__device__ __forceinline__ void mma_bf16_16816(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int MT>
__global__ void __launch_bounds__(kGvThreads, MT <= 2 ? 5 : 2)
masked_gemv_tc_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                      const float* __restrict__ block_mask, __nv_bfloat16* __restrict__ y,
                      float* __restrict__ part, int* __restrict__ arrivals, int M, int K, int N,
                      int per) {
  using T = __nv_bfloat16;
  using R = GvRing<T>;
  constexpr int NS = GvTile<T>::kStages;
  constexpr int LDW = GvTile<T>::kLdW;
  extern __shared__ __align__(16) unsigned char gv_smem_raw[];
  T* ring = reinterpret_cast<T*>(gv_smem_raw);
  T* xs = reinterpret_cast<T*>(gv_smem_raw + R::kBytes);
  __shared__ int last;

  const int tid = threadIdx.x, lane = tid % 32, wp = tid / 32;
  const int tile = blockIdx.x, split = blockIdx.y, splits = gridDim.y;
  const int col0 = tile * kGvCols;

  if (!(block_mask[col0 / kBlockN] > 0.f)) {    // pruned (NaN counts as pruned)
    if (split == 0)
      for (int i = tid; i < M * (kGvCols / 2); i += kGvThreads)
        store2(y + static_cast<size_t>(i / (kGvCols / 2)) * N + col0 + 2 * (i % (kGvCols / 2)),
               0.f, 0.f);
    return;
  }

  const int s0 = split * per;
  const int nst = min(per, K / kGvBK - s0);    // ring stages of this split (>= 1)
  const int k0 = s0 * kGvBK;
  const int kc = nst * kGvBK;
  const int ldx = per * kGvBK + 8;             // x row pitch (elements)

  // x[:, k0 : k0 + kc] as bf16 rows, zero rows past M: part of group 0
  for (int i = tid; i < 8 * MT * (kc / 8); i += kGvThreads) {
    const int m = i / (kc / 8), v = i % (kc / 8);
    const bool ok = m < M;
    cp_async16(xs + m * ldx + 8 * v, ok ? x + static_cast<size_t>(m) * K + k0 + 8 * v : x, ok);
  }
  const int lrow = tid / R::kRowCopies, lcol = (tid % R::kRowCopies) * R::kVec;
  const T* src = w + static_cast<size_t>(k0 + lrow) * N + col0 + lcol;
#pragma unroll
  for (int t = 0; t < NS - 1; ++t) {
    if (t < nst) gv_load(ring, src, t, N, lrow, lcol);
    cp_async_commit();
  }

  // warp wp: columns 16*cg.., contraction rows 16*ks.. of each stage
  const int cg = wp % 4, ks = wp / 4;
  const int lr = lane % 8, lj = lane / 8;
  // ldmatrix row addresses: A (w^T) matrix lj = (k half lj/2, column half lj%2)
  const int a_off = (16 * ks + lr + 8 * (lj / 2)) * LDW + 16 * cg + 8 * (lj % 2);
  // B (x^T) matrix lj%2 = k half, row lr of x (lanes 16.. repeat 0..15)
  const int b_off = lr * ldx + 16 * ks + 8 * (lj % 2);
  float acc[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) acc[mt][0] = acc[mt][1] = acc[mt][2] = acc[mt][3] = 0.f;

  for (int t = 0; t < nst; ++t) {
    cp_async_wait<NS - 2>();
    __syncthreads();                           // stage t (and x) landed; stage t-1 consumed
    if (t + NS - 1 < nst) gv_load(ring, src, t + NS - 1, N, lrow, lcol);
    cp_async_commit();
    uint32_t a[4];
    ldsm_x4_trans(a, ring + (t % NS) * R::kStage + a_off);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      uint32_t b[2];
      ldsm_x2(b, xs + 8 * mt * ldx + b_off + t * kGvBK);
      mma_bf16_16816(acc[mt], a, b);
    }
  }
  cp_async_wait<0>();

  // acc[mt]: (column 16cg + g (+8), row 8mt + 2t4 (+1)) with g = lane/4,
  // t4 = lane%4; the two k halves' warps add in order through red
  float* red = reinterpret_cast<float*>(gv_smem_raw);    // [2][8][kGvRedLd]
  const int g = lane / 4, t4 = lane % 4;
  const int rr = tid / 32, rc = 2 * (tid % 32);          // this thread's sum: row rr, 2 columns
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    __syncthreads();                           // the ring (or the last group) is read
    float* r = red + ks * 8 * kGvRedLd + 16 * cg + g;
    r[(2 * t4) * kGvRedLd] = acc[mt][0];
    r[(2 * t4 + 1) * kGvRedLd] = acc[mt][1];
    r[(2 * t4) * kGvRedLd + 8] = acc[mt][2];
    r[(2 * t4 + 1) * kGvRedLd + 8] = acc[mt][3];
    __syncthreads();
    float2 s = *reinterpret_cast<const float2*>(red + rr * kGvRedLd + rc);
    const float2 o = *reinterpret_cast<const float2*>(red + (8 + rr) * kGvRedLd + rc);
    s.x += o.x;
    s.y += o.y;
    gv_emit(s, y, part, M, N, col0, 8 * mt + rr, rc, split, splits);
  }
  if (splits > 1) gv_merge(part, arrivals, y, M, N, col0, tile, splits, tid, &last);
}

template <int MT>
__global__ void __launch_bounds__(kGvThreads, MT == 1 ? 5 : MT == 2 ? 3 : MT == 4 ? 2 : 1)
masked_gemv_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ block_mask, float* __restrict__ y,
                   float* __restrict__ part, int* __restrict__ arrivals, int M, int K, int N,
                   int per) {
  using T = float;
  using R = GvRing<T>;
  constexpr int XS = 8 * MT;                   // rows of x staged (floats a k)
  constexpr int NS = GvTile<T>::kStages;
  extern __shared__ __align__(16) unsigned char gv_smem_raw[];
  T* ring = reinterpret_cast<T*>(gv_smem_raw);
  float* xs = reinterpret_cast<float*>(gv_smem_raw + R::kBytes);
  __shared__ int last;

  const int tid = threadIdx.x, lane = tid % 32, wp = tid / 32;
  const int tile = blockIdx.x, split = blockIdx.y, splits = gridDim.y;
  const int col0 = tile * kGvCols;

  if (!(block_mask[col0 / kBlockN] > 0.f)) {    // pruned (NaN counts as pruned)
    if (split == 0)
      for (int i = tid; i < M * (kGvCols / 2); i += kGvThreads)
        store2(y + static_cast<size_t>(i / (kGvCols / 2)) * N + col0 + 2 * (i % (kGvCols / 2)),
               0.f, 0.f);
    return;
  }

  const int s0 = split * per;
  const int nst = min(per, K / kGvBK - s0);    // ring stages of this split (>= 1)
  const int k0 = s0 * kGvBK;

  const int lrow = tid / R::kRowCopies, lcol = (tid % R::kRowCopies) * R::kVec;
  const T* src = w + static_cast<size_t>(k0 + lrow) * N + col0 + lcol;
#pragma unroll
  for (int t = 0; t < NS - 1; ++t) {
    if (t < nst) gv_load(ring, src, t, N, lrow, lcol);
    cp_async_commit();
  }

  // x[:, k0 : k0 + 32*nst] -> xs[k][m] with 16-byte loads, while the first
  // stages of w are in flight
  const int vecs = nst * kGvBK / 4;            // 16-byte vectors of one x row
  for (int i = tid; i < XS * vecs; i += kGvThreads) {
    const int m = i % XS, v = i / XS;
    float f[4] = {0.f, 0.f, 0.f, 0.f};
    if (m < M) Load<float, 4>::run(x + static_cast<size_t>(m) * K + k0 + 4 * v, f);
#pragma unroll
    for (int e = 0; e < 4; ++e) xs[(4 * v + e) * XS + m] = f[e];
  }

  float acc[MT][8][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[mt][i][0] = acc[mt][i][1] = 0.f;

  for (int t = 0; t < nst; ++t) {
    cp_async_wait<NS - 2>();
    __syncthreads();                           // stage t (and x) landed; stage t-1 consumed
    if (t + NS - 1 < nst) gv_load(ring, src, t + NS - 1, N, lrow, lcol);
    cp_async_commit();
    const T* wt = ring + (t % NS) * R::kStage + 2 * lane;
    const float* xt = xs + t * kGvBK * XS;
#pragma unroll
    for (int j = 0; j < kGvBK / 8; ++j) {
      const int r = wp + 8 * j;
      float wv[2];
      Load<T, 2>::run(wt + r * kGvCols, wv);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float xv[8];
        Load<float, 4>::run(xt + r * XS + 8 * mt, xv);
        Load<float, 4>::run(xt + r * XS + 8 * mt + 4, xv + 4);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc[mt][i][0] = fmaf(xv[i], wv[0], acc[mt][i][0]);
          acc[mt][i][1] = fmaf(xv[i], wv[1], acc[mt][i][1]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // the 8 warps' sums, 8 rows of x at a time, in warp order through the
  // (now free) ring: red[warp][row][column]
  float* red = reinterpret_cast<float*>(gv_smem_raw);
  const int rr = tid / 32, rc = 2 * (tid % 32);          // this thread's sum: row rr, 2 columns
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    __syncthreads();                           // the ring (or the last group) is read
#pragma unroll
    for (int i = 0; i < 8; ++i)
      *reinterpret_cast<float2*>(red + (wp * 8 + i) * kGvRedLd + 2 * lane) =
          make_float2(acc[mt][i][0], acc[mt][i][1]);
    __syncthreads();
    float2 s = *reinterpret_cast<const float2*>(red + rr * kGvRedLd + rc);
#pragma unroll
    for (int v = 1; v < kGvThreads / 32; ++v) {
      const float2 o = *reinterpret_cast<const float2*>(red + (v * 8 + rr) * kGvRedLd + rc);
      s.x += o.x;
      s.y += o.y;
    }
    gv_emit(s, y, part, M, N, col0, 8 * mt + rr, rc, split, splits);
  }
  if (splits > 1) gv_merge(part, arrivals, y, M, N, col0, tile, splits, tid, &last);
}

template <typename T, int MT>
int launch_gemv_mt(const void* x, const void* w, const void* mask, void* y, void* ws, int M,
                   int K, int N, const GvPlan& g, cudaStream_t stream) {
  const size_t smem = gv_smem<T>(MT, g.per);
  int* arrivals = static_cast<int*>(ws);
  float* part = ws == nullptr ? nullptr : reinterpret_cast<float*>(arrivals + gv_counters(N));
  const dim3 grid(N / kGvCols, g.splits);
  if constexpr (std::is_same<T, float>::value) {
    if (smem > 48 * 1024) {
      const int e = hopper::allow_smem(masked_gemv_kernel<MT>, smem);
      if (e != 0) return e;
    }
    masked_gemv_kernel<MT><<<grid, kGvThreads, smem, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(mask), static_cast<float*>(y), part, arrivals, M, K, N, g.per);
  } else {
    if (smem > 48 * 1024) {
      const int e = hopper::allow_smem(masked_gemv_tc_kernel<MT>, smem);
      if (e != 0) return e;
    }
    masked_gemv_tc_kernel<MT><<<grid, kGvThreads, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const float*>(mask),
        static_cast<T*>(y), part, arrivals, M, K, N, g.per);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_gemv(const void* x, const void* w, const void* mask, void* y, void* ws, int M,
                int K, int N, cudaStream_t stream) {
  const GvPlan g = gv_plan(M, K, N, hopper::num_sms());
  if (g.splits > 1 && ws == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  switch (g.mt) {
    case 1: return launch_gemv_mt<T, 1>(x, w, mask, y, ws, M, K, N, g, stream);
    case 2: return launch_gemv_mt<T, 2>(x, w, mask, y, ws, M, K, N, g, stream);
    case 4: return launch_gemv_mt<T, 4>(x, w, mask, y, ws, M, K, N, g, stream);
    default: return launch_gemv_mt<T, 8>(x, w, mask, y, ws, M, K, N, g, stream);
  }
}

// ---------------------------------------------------------------------------
// The GEMM body of K1 (f32, M > 64) and K3:
//   C[P,Q] = sum_r A(p,r) B(r,q),  A(p,r) = a[r*lda + p], B(r,q) = b[r*ldb + q],
// C row-major: both operands MN-major (K3: x^T and dy; K1: x^T, written by
// transpose_kernel below, and w).  256x128 tiles of C, one mask block per
// tile column: a pruned tile writes zeros and reads nothing.  A persistent
// grid of min(tiles, SMs) blocks, fixed by the shapes: each block ranks the
// kept column blocks itself (warp ballots, into shared memory), and block b
// takes the kept tiles of ranks b, b + grid, ... (kept tile r is row tile
// r % ptiles of the (r / ptiles)-th kept column block), so pruning shortens
// every block's walk alike.  One 2-stage cp.async ring of 64-deep stages
// runs through all of a block's tiles, A and B copied untransposed into
// [k][p] and [k][q] rows.  Warp w computes rows 32w.. of a tile; lane
// 8*lr + lc the columns 4lc + 32j + e (j, e < 4) and the rows 4lr + 16h + e
// (h < 2, e < 4): a contraction step is two 16-byte shared loads of A and
// four of B (the 8 lanes of a quarter-warp share A's, so neither conflicts)
// and 128 multiply-adds.  Only P (K1: M) and R (K3: M) may be ragged: rows
// past them are zero-filled by cp.async and never stored.
// ---------------------------------------------------------------------------

constexpr int kGmRows = 256;            // C tile rows (P)
constexpr int kGmCols = 128;            // C tile columns (Q) = one mask block
constexpr int kGmThreads = 256;
// Ring stage depth, stages, and contraction steps unrolled into one loop
// body, chosen on the H100 at the training shapes (tools/mm_variants.py,
// PERF.md): 3 stages of 32 ran slower, and unrolling the whole 64-deep
// stage overflowed the instruction cache.  The body's speed also moves
// with ptxas's register allocation, by several percent for edits that do
// not change what it computes (the variant "loader_inline"): re-time K1
// and K3 (tools/mm_ab.py) after any edit of the body.
constexpr int kGmBK = 64;
constexpr int kGmStages = 2;
constexpr int kGmUnroll = 16;

template <typename T> struct GmTile {
  static constexpr int kVec = 16 / sizeof(T);                   // elements a copy
  static constexpr int kA = kGmBK * kGmRows;                    // A elements a stage
  static constexpr int kStage = kA + kGmBK * kGmCols;
  static constexpr size_t kSmem = static_cast<size_t>(kGmStages) * kStage * sizeof(T);
  static constexpr int kACpr = kGmRows / kVec;                  // copies an A row
  static constexpr int kAStep = kGmThreads / kACpr;
  static constexpr int kAN = kGmBK / kAStep;
  static constexpr int kBCpr = kGmCols / kVec;                  // copies a B row
  static constexpr int kBStep = kGmThreads / kBCpr;
  static constexpr int kBN = kGmBK / kBStep;
};

template <typename T>
__global__ void __launch_bounds__(kGmThreads, 1)
masked_gemm_kernel(const T* __restrict__ a, const T* __restrict__ b,
                   const float* __restrict__ mask, T* __restrict__ c, int P, int Q, int R,
                   int lda, int ldb) {
  using Tile = GmTile<T>;
  constexpr int BM = kGmRows, TN = 16, BK = kGmBK, NS = kGmStages, U = kGmUnroll;
  extern __shared__ __align__(16) unsigned char gm_smem[];
  T* ring = reinterpret_cast<T*>(gm_smem);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int lr = lane / 8, lc = lane % 8;
  const int wrow = 32 * warp;                         // the warp tile's first row
  const int wcol = 4 * lc;                            // + 32j + e
  const int ptiles = (P + BM - 1) / BM;
  const int nb = Q / kGmCols;                         // column blocks = mask entries
  const int tiles = ptiles * nb;
  const int nst = (R + BK - 1) / BK;                  // ring stages a tile

  // kcol[c]: the c-th kept column block (NaN is pruned), ranked in parallel
  int* kcol = reinterpret_cast<int*>(gm_smem + Tile::kSmem);
  __shared__ int warp_kept[kGmThreads / 32];
  int nkept = 0;
  for (int base = 0; base < nb; base += kGmThreads) {
    const int j = base + tid;
    const bool keep = j < nb && mask[j] > 0.f;
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) warp_kept[warp] = __popc(ballot);
    __syncthreads();
    int rank = nkept + __popc(ballot & ((1u << lane) - 1u));
    for (int w = 0; w < kGmThreads / 32; ++w) {
      if (w < warp) rank += warp_kept[w];
      nkept += warp_kept[w];
    }
    if (keep) kcol[rank] = j;
    __syncthreads();
  }

  // the pruned tiles, round robin: zeros, 16 bytes a store, nothing read
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    if (mask[t / ptiles] > 0.f) continue;
    const int p0 = (t % ptiles) * BM, q0 = (t / ptiles) * kGmCols;
    const float z[4] = {0.f, 0.f, 0.f, 0.f};
    for (int i = tid; i < BM * kGmCols / 4; i += kGmThreads) {
      const int p = p0 + i / (kGmCols / 4);
      if (p < P) store4(c + static_cast<size_t>(p) * Q + q0 + 4 * (i % (kGmCols / 4)), z);
    }
  }
  const int ktiles = nkept * ptiles;
  const int mine = blockIdx.x < ktiles ? (ktiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int total = mine * nst;                       // ring stages of this block

  // the producer's cursor: the next stage to load is stage ls of the kept
  // tile of rank lt
  int lt = blockIdx.x, ls = 0;
  const int arow = tid / Tile::kACpr, acol = (tid % Tile::kACpr) * Tile::kVec;
  const int brow = tid / Tile::kBCpr, bcol = (tid % Tile::kBCpr) * Tile::kVec;
  auto load = [&](int slot) {
    const int p0 = (lt % ptiles) * BM, q0 = kcol[lt / ptiles] * kGmCols;
    const int r0 = ls * BK;
    T* as = ring + slot * Tile::kStage;
    T* bs = as + Tile::kA;
#pragma unroll
    for (int n = 0; n < Tile::kAN; ++n) {
      const int row = arow + n * Tile::kAStep;
      const int p = p0 + acol;
      const int r = r0 + row;
      const bool ok = p < P && r < R;
      const T* src = a + (static_cast<size_t>(r) * lda + p);   // see kGmUnroll
      cp_async16(as + row * BM + acol, ok ? src : a, ok);
    }
#pragma unroll
    for (int n = 0; n < Tile::kBN; ++n) {
      const int row = brow + n * Tile::kBStep;
      const bool ok = r0 + row < R;
      cp_async16(bs + row * kGmCols + bcol,
                 ok ? b + static_cast<size_t>(r0 + row) * ldb + q0 + bcol : b, ok);
    }
    if (++ls == nst) {
      ls = 0;
      lt += gridDim.x;
    }
  };

  float acc[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < total) load(s);
    cp_async_commit();
  }
  int ct = blockIdx.x, cs = 0;                        // the tile being summed, its stage
  for (int g = 0; g < total; ++g) {
    cp_async_wait<NS - 2>();
    __syncthreads();                                  // stage g landed; stage g-1 consumed
    if (g + NS - 1 < total) load((g + NS - 1) % NS);
    cp_async_commit();
    const T* as = ring + (g % NS) * Tile::kStage;
    const T* bs = as + Tile::kA + wcol;
    const T* ap = as + wrow + 4 * lr;
#pragma unroll 1
    for (int k0 = 0; k0 < BK; k0 += U) {
#pragma unroll
      for (int k = k0; k < k0 + U; ++k) {
        float av[8], bv[TN];
        Load<T, 4>::run(ap + k * BM, av);
        Load<T, 4>::run(ap + k * BM + 16, av + 4);
#pragma unroll
        for (int j = 0; j < TN / 4; ++j) Load<T, 4>::run(bs + k * kGmCols + 32 * j, bv + 4 * j);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    if (++cs < nst) continue;
    // tile ct is summed: store it (the next tile's first stages are in flight)
    const int p0 = (ct % ptiles) * BM, q0 = kcol[ct / ptiles] * kGmCols;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int p = p0 + wrow + 4 * lr + 16 * (i / 4) + i % 4;
      if (p < P) {
#pragma unroll
        for (int j = 0; j < TN / 4; ++j)
          store4(c + static_cast<size_t>(p) * Q + q0 + wcol + 32 * j, &acc[i][4 * j]);
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
    }
    cs = 0;
    ct += gridDim.x;
  }
  cp_async_wait<0>();
}

template <typename T>
int launch_gemm(const void* a, const void* b, const void* mask, void* c, int P, int Q, int R,
                int lda, int ldb, cudaStream_t stream) {
  using Tile = GmTile<T>;
  const size_t smem = Tile::kSmem + sizeof(int) * (Q / kGmCols);   // the ring, kcol
  const int e = hopper::allow_smem(masked_gemm_kernel<T>, smem);
  if (e != 0) return e;
  const int tiles = ((P + kGmRows - 1) / kGmRows) * (Q / kGmCols);
  const int grid = tiles < hopper::num_sms() ? tiles : hopper::num_sms();
  masked_gemm_kernel<T><<<grid, kGmThreads, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<const float*>(mask),
      static_cast<T*>(c), P, Q, R, lda, ldb);
  return static_cast<int>(cudaGetLastError());
}

// K1 in f32 at M > 64: x [M,K] -> xt [K][ldx], ldx = M rounded up to 4 (so
// that the GEMM body's 16-byte copies of xt rows stay aligned; columns M..
// are zeros), through a 32x33 shared tile so that both the reads of x and
// the writes of xt are coalesced.  With x^T the GEMM body reads K1's A
// MN-major as it does K3's; reading x K-major from padded rows instead was
// slower than this launch and the MN-major body together (PERF.md).
inline int xt_pitch(int M) { return (M + 3) / 4 * 4; }

__global__ void __launch_bounds__(256)
transpose_kernel(const float* __restrict__ x, float* __restrict__ xt, int M, int K, int ldx) {
  __shared__ float tile[32][33];
  const int k0 = blockIdx.x * 32, m0 = blockIdx.y * 32;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
#pragma unroll
  for (int r = ty; r < 32; r += 8) {
    const int m = m0 + r;
    tile[r][tx] = m < M ? x[static_cast<size_t>(m) * K + k0 + tx] : 0.f;
  }
  __syncthreads();
#pragma unroll
  for (int r = ty; r < 32; r += 8)
    if (m0 + tx < ldx) xt[static_cast<size_t>(k0 + r) * ldx + m0 + tx] = tile[tx][r];
}

int launch_fwd_f32(const void* x, const void* w, const void* mask, void* y, void* ws, int M,
                   int K, int N, cudaStream_t stream) {
  if (ws == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int ldx = xt_pitch(M);
  float* xt = static_cast<float*>(ws);
  transpose_kernel<<<dim3(K / 32, (ldx + 31) / 32), 256, 0, stream>>>(
      static_cast<const float*>(x), xt, M, K, ldx);
  const int e = static_cast<int>(cudaGetLastError());
  if (e != 0) return e;
  return launch_gemm<float>(xt, w, mask, y, M, N, K, ldx, N, stream);
}

// ---------------------------------------------------------------------------
// K2: dx[M,K] = dy[M,N] @ w[K,N]^T over the kept N-blocks, split over them.
// Grid (K/128, ceil(M/256), splits); block (x, y, z) owns the 256x128 tile
// of dx at rows 256y, columns 128x, and the z-th share of the kept blocks:
// ranks [z*kept/splits, (z+1)*kept/splits) in mask order.  Its 8 warps each
// take 32 rows of the tile and all 128 columns; lane = 8*lr + lc holds rows
// 32*warp + lr + 4i (i < 8) and columns lc + 8j (j < 16), 128 f32 sums.
// Per pair of contraction steps a thread loads its 8 A values once (8-byte
// shared loads, kept in registers) and then, column by column, 2 B values
// for 16 multiply-adds; one shared load of A reads 4 distinct rows and one
// of B 8, each in its own banks thanks to the row pitch (36 floats, 40
// bf16).  A ring stage is 32 deep (a 128-byte line of each operand row), 3
// stages deep.  The 8x16 thread tile needs ~250 registers, so one block
// runs per SM and `splits` (the wrapper's dx_splits) fills the SMs with
// blocks.  Rows of dy past M are zero-filled by cp.async (never read) and
// never stored.  An empty share (kept < splits, or every block pruned)
// writes a zero tile, so the sum below never meets uninitialised workspace.
// ---------------------------------------------------------------------------

constexpr int kDxRows = 256;            // dx tile rows (rows of dy)
constexpr int kDxCols = 128;            // dx tile columns (rows of w)
constexpr int kDxBK = 32;               // contraction depth of a ring stage
constexpr int kDxStages = 3;            // ring stages: 2 in flight while one is used
constexpr int kDxThreads = 256;
constexpr int kDxTI = 8, kDxTJ = 16;    // rows x columns of dx per thread

template <typename T> struct DxTile {
  static constexpr int kLd = std::is_same<T, float>::value ? kDxBK + 4 : kDxBK + 8;  // pitch
  static constexpr int kVec = 16 / sizeof(T);        // elements of one 16-byte copy
  static constexpr int kCopies = kDxBK / kVec;       // copies per tile row
  static constexpr int kStep = kDxThreads / kCopies; // rows between one thread's copies
  static constexpr int kA = kDxRows * kLd;           // elements of a stage's dy tile
  static constexpr int kStage = (kDxRows + kDxCols) * kLd;
  static constexpr size_t kSmem = static_cast<size_t>(kDxStages) * kStage * sizeof(T);
};


// The first block index >= j whose mask entry is > 0 (NaN is pruned), or nb.
__device__ __forceinline__ int kept_from(int j, int nb, const float* mask) {
  while (j < nb && !(mask[j] > 0.f)) ++j;
  return j;
}

template <typename T>
__global__ void __launch_bounds__(kDxThreads, 1)
masked_dx_split_kernel(const T* __restrict__ dy, const T* __restrict__ w,
                       const float* __restrict__ mask, T* __restrict__ dx,
                       float* __restrict__ ws, int M, int K, int N) {
  using Tile = DxTile<T>;
  extern __shared__ __align__(16) unsigned char dx_smem[];
  T* ring = reinterpret_cast<T*>(dx_smem);    // stage s: dy tile, then w tile

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kDxCols;        // columns of dx = rows of w
  const int p0 = blockIdx.y * kDxRows;        // rows of dx = rows of dy
  const int split = blockIdx.z, splits = gridDim.z;
  const int nb = N / kBlockN;

  int kept = 0;
  for (int base = 0; base < nb; base += kDxThreads) {
    const int j = base + tid;
    kept += __syncthreads_count(j < nb && mask[j] > 0.f);
  }
  const int lo = static_cast<int>(static_cast<long long>(split) * kept / splits);
  const int hi = static_cast<int>(static_cast<long long>(split + 1) * kept / splits);
  const int nst = (hi - lo) * (kBlockN / kDxBK);   // ring stages of this share

  // the kept block of rank lo, found in parallel: each thread ranks its own
  // mask entry from warp ballots (a serial walk would cost the last split
  // lo dependent loads)
  __shared__ int warp_kept[kDxThreads / 32];
  __shared__ int first;
  if (tid == 0) first = nb;
  for (int base = 0, seen = 0; base < nb; base += kDxThreads) {
    const int j = base + tid;
    const bool keep = j < nb && mask[j] > 0.f;
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (tid % 32 == 0) warp_kept[tid / 32] = __popc(ballot);
    __syncthreads();
    int rank = seen + __popc(ballot & ((1u << (tid % 32)) - 1u));
    for (int w = 0; w < kDxThreads / 32; ++w) {
      if (w < tid / 32) rank += warp_kept[w];
      seen += warp_kept[w];
    }
    if (keep && rank == lo) first = j;
    __syncthreads();
  }
  int blk = first;                                 // producer cursor: kept block of rank lo
  int sub = 0;                                     // and its stage within that block

  // this thread's copies: rows lrow + n * kStep of each operand tile, at lcol
  const int lrow = tid / Tile::kCopies, lcol = (tid % Tile::kCopies) * Tile::kVec;
  const T* a_src = dy + static_cast<size_t>(p0 + lrow) * N + lcol;
  const T* b_src = w + static_cast<size_t>(q0 + lrow) * N + lcol;
  const size_t step = static_cast<size_t>(Tile::kStep) * N;
  const int a_rows = M - p0 - lrow;                // copy n reads a row < M iff n * kStep < a_rows
  auto load = [&](int slot) {
    T* as = ring + slot * Tile::kStage + lrow * Tile::kLd + lcol;
    T* bs = as + Tile::kA;
    const int r0 = blk * kBlockN + sub * kDxBK;
#pragma unroll
    for (int n = 0; n < kDxRows / Tile::kStep; ++n) {
      const bool valid = n * Tile::kStep < a_rows;
      cp_async16(as + n * Tile::kStep * Tile::kLd, valid ? a_src + n * step + r0 : dy, valid);
    }
#pragma unroll
    for (int n = 0; n < kDxCols / Tile::kStep; ++n)
      cp_async16(bs + n * Tile::kStep * Tile::kLd, b_src + n * step + r0, true);
    if (++sub == kBlockN / kDxBK) {
      sub = 0;
      blk = kept_from(blk + 1, nb, mask);
    }
  };

  const int lane = tid % 32;
  const int arow = (tid / 32) * (4 * kDxTI) + lane / 8;   // + 4i
  const int bcol = lane % 8;                               // + 8j

  float acc[kDxTI][kDxTJ];
#pragma unroll
  for (int i = 0; i < kDxTI; ++i)
#pragma unroll
    for (int j = 0; j < kDxTJ; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < kDxStages - 1; ++s) {
    if (s < nst) load(s);
    cp_async_commit();
  }
  for (int t = 0; t < nst; ++t) {
    cp_async_wait<kDxStages - 2>();
    __syncthreads();                               // stage t landed; stage t-1 consumed
    if (t + kDxStages - 1 < nst) load((t + kDxStages - 1) % kDxStages);
    cp_async_commit();
    const T* as = ring + (t % kDxStages) * Tile::kStage;
    const T* bs = as + Tile::kA;
#pragma unroll 8
    for (int kq = 0; kq < kDxBK; kq += 2) {
      float av[kDxTI][2];
#pragma unroll
      for (int i = 0; i < kDxTI; ++i) Load<T, 2>::run(as + (arow + 4 * i) * Tile::kLd + kq, av[i]);
#pragma unroll
      for (int j = 0; j < kDxTJ; ++j) {
        float bv[2];
        Load<T, 2>::run(bs + (bcol + 8 * j) * Tile::kLd + kq, bv);
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
#pragma unroll
          for (int i = 0; i < kDxTI; ++i) acc[i][j] = fmaf(av[i][kk], bv[kk], acc[i][j]);
      }
    }
  }
  cp_async_wait<0>();

  float* part = ws == nullptr ? nullptr : ws + static_cast<size_t>(split) * M * K;
#pragma unroll
  for (int i = 0; i < kDxTI; ++i) {
    const int p = p0 + arow + 4 * i;
    if (p >= M) continue;
#pragma unroll
    for (int j = 0; j < kDxTJ; ++j) {
      const size_t at = static_cast<size_t>(p) * K + q0 + bcol + 8 * j;
      if (part != nullptr) part[at] = acc[i][j];
      else store(dx + at, acc[i][j]);
    }
  }
}

// dx = sum over s = 0..splits-1, in that order, of ws[s] (each [M,K] f32).
// Launched as a programmatic dependent of the split kernel: its blocks are
// set up while the split kernel drains and wait here for all of its writes.
template <typename T>
__global__ void __launch_bounds__(256)
masked_dx_reduce_kernel(const float* __restrict__ ws, T* __restrict__ dx, size_t n4,
                        int splits) {
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const float4* src = reinterpret_cast<const float4*>(ws);
  for (size_t i = static_cast<size_t>(blockIdx.x) * 256 + threadIdx.x; i < n4;
       i += static_cast<size_t>(gridDim.x) * 256) {
    float4 s = src[i];
    for (int sp = 1; sp < splits; ++sp) {
      const float4 v = src[static_cast<size_t>(sp) * n4 + i];
      s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
    }
    T* out = dx + 4 * i;
    store(out, s.x); store(out + 1, s.y); store(out + 2, s.z); store(out + 3, s.w);
  }
}

template <typename T>
int launch_dx(const void* dy, const void* w, const void* mask, void* dx, void* ws, int M,
              int K, int N, int splits, cudaStream_t stream) {
  constexpr size_t smem = DxTile<T>::kSmem;
  int e = hopper::allow_smem(masked_dx_split_kernel<T>, smem);
  if (e == 0)
    e = static_cast<int>(cudaFuncSetAttribute(masked_dx_split_kernel<T>,
                                              cudaFuncAttributePreferredSharedMemoryCarveout,
                                              cudaSharedmemCarveoutMaxShared));
  if (e != 0) return e;
  float* part = splits > 1 ? static_cast<float*>(ws) : nullptr;
  const dim3 grid(K / kDxCols, (M + kDxRows - 1) / kDxRows, splits);
  masked_dx_split_kernel<T><<<grid, kDxThreads, smem, stream>>>(
      static_cast<const T*>(dy), static_cast<const T*>(w), static_cast<const float*>(mask),
      static_cast<T*>(dx), part, M, K, N);
  e = static_cast<int>(cudaGetLastError());
  if (e != 0 || splits == 1) return e;
  const size_t n4 = static_cast<size_t>(M) * K / 4;   // K is a multiple of 128
  const size_t want = (n4 + 255) / 256;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(want < 8 * 132 ? want : 8 * 132));
  cfg.blockDim = dim3(256);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = static_cast<int>(cudaLaunchKernelEx(&cfg, masked_dx_reduce_kernel<T>,
                                          static_cast<const float*>(part), static_cast<T*>(dx),
                                          n4, splits));
  return e != 0 ? e : static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// K1 in bf16 at M > 64: the wgmma GEMM (see the notes at the top).
// Warpgroup 0 is the producer (thread 0 issues every TMA load); warpgroups 1
// and 2 compute rows 0-127 and 128-255 of each 256x128 tile, each as two
// 64-row accumulators.  Ring slot s holds x [256 rows][64 K] (32 KB, one
// swizzle box) and w [64 K][128 cols] (two 64-column boxes of 8 KB).
// full[s] completes when the slot's bytes have landed; empty[s] when all 8
// consumer warps are done reading it.
// ---------------------------------------------------------------------------

constexpr int kTcBM = 256;              // rows of a tile
constexpr int kTcBN = 128;              // columns of a tile = one mask block
constexpr int kTcBK = 64;               // contraction depth of a ring slot
constexpr int kTcStages = 4;
constexpr int kTcThreads = 384;         // 3 warpgroups
constexpr uint32_t kTcABytes = kTcBM * kTcBK * 2;
constexpr uint32_t kTcBBox = kTcBK * 64 * 2;       // one 64-column box of w
constexpr uint32_t kTcStageBytes = kTcABytes + 2 * kTcBBox;
constexpr size_t kTcSmem = 1024 + kTcStages * kTcStageBytes + 2 * kTcStages * sizeof(uint64_t);

__global__ void __launch_bounds__(kTcThreads, 1)
masked_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                           const __grid_constant__ CUtensorMap wmap,
                           const float* __restrict__ block_mask,
                           __nv_bfloat16* __restrict__ y, int M, int K, int N) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kTcStages * kTcStageBytes);
  uint64_t* empty = full + kTcStages;

  const int m_tiles = (M + kTcBM - 1) / kTcBM;
  const int tiles = m_tiles * (N / kTcBN);
  const int kblocks = K / kTcBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    reg_dealloc<40>();
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int nt = t / m_tiles, mt = t % m_tiles;
        if (!(block_mask[nt] > 0.f)) continue;   // pruned: nothing to load
        for (int kb = 0; kb < kblocks; ++kb) {
          mbar_wait(&empty[stage], phase ^ 1);
          uint8_t* a = ring + stage * kTcStageBytes;
          uint8_t* b = a + kTcABytes;
          mbar_expect_tx(&full[stage], kTcStageBytes);
          tma_load_2d(a, &xmap, &full[stage], kb * kTcBK, mt * kTcBM);
          tma_load_2d(b, &wmap, &full[stage], nt * kTcBN, kb * kTcBK);
          tma_load_2d(b + kTcBBox, &wmap, &full[stage], nt * kTcBN + 64, kb * kTcBK);
          if (++stage == kTcStages) { stage = 0; phase ^= 1; }
        }
      }
    }
  } else {
    reg_alloc<232>();
    const int half = wg - 1;                       // rows 128*half.. of a tile
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid / 32, lane = tid % 32;
    int stage = 0;
    uint32_t phase = 0;
    float acc[2][64];                              // rows 128*half + 64*i + ...
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[i][e] = 0.f;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int nt = t / m_tiles, mt = t % m_tiles;
      const int row = mt * kTcBM + half * 128 + warp * 16 + lane / 4;
      __nv_bfloat16* out = y + nt * kTcBN + 2 * (lane % 4);
      if (!(block_mask[nt] > 0.f)) {             // pruned: exact zeros
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 16; ++j)
#pragma unroll
            for (int r = 0; r < 2; ++r)
              if (row + 64 * i + 8 * r < M)
                *reinterpret_cast<uint32_t*>(
                    out + static_cast<size_t>(row + 64 * i + 8 * r) * N + 8 * j) = 0u;
        continue;
      }
      int prev = 0;
      for (int kb = 0; kb < kblocks; ++kb) {
        mbar_wait(&full[stage], phase);
        const uint32_t a = smem_u32(ring + stage * kTcStageBytes) + half * 128 * 128;
        const uint32_t b = smem_u32(ring + stage * kTcStageBytes + kTcABytes);
        fence_regs<64>(acc[0]);
        fence_regs<64>(acc[1]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kTcBK / 16; ++kk)
#pragma unroll
          for (int i = 0; i < 2; ++i)
            wgmma_ss_m64n128k16<1>(acc[i], desc_sw128(a + 64 * 128 * i + 32 * kk, 16, 1024),
                                   desc_sw128(b + 2048 * kk, kTcBBox, 1024), kb + kk > 0);
        wgmma_commit();
        wgmma_wait<1>();                           // the previous slot's group is done
        fence_regs<64>(acc[0]);
        fence_regs<64>(acc[1]);
        if (kb > 0 && lane == 0) mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == kTcStages) { stage = 0; phase ^= 1; }
      }
      wgmma_wait<0>();
      fence_regs<64>(acc[0]);
      fence_regs<64>(acc[1]);
      if (lane == 0) mbar_arrive(&empty[prev]);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            if (row + 64 * i + 8 * r < M)
              *reinterpret_cast<uint32_t*>(
                  out + static_cast<size_t>(row + 64 * i + 8 * r) * N + 8 * j) =
                  pack_bf16(acc[i][4 * j + 2 * r], acc[i][4 * j + 2 * r + 1]);
    }
  }
}

int launch_fwd_wgmma(const void* x, const void* w, const void* block_mask, void* y, int M,
                     int K, int N, cudaStream_t stream) {
  CUtensorMap xmap, wmap;
  const uint64_t xdims[2] = {static_cast<uint64_t>(K), static_cast<uint64_t>(M)};
  const uint64_t xstrides[1] = {static_cast<uint64_t>(K) * 2};
  const uint32_t xbox[2] = {kTcBK, kTcBM};
  const uint64_t wdims[2] = {static_cast<uint64_t>(N), static_cast<uint64_t>(K)};
  const uint64_t wstrides[1] = {static_cast<uint64_t>(N) * 2};
  const uint32_t wbox[2] = {64, kTcBK};
  int e = hopper::make_map(&xmap, x, 2, xdims, xstrides, xbox);
  if (e == 0) e = hopper::make_map(&wmap, w, 2, wdims, wstrides, wbox);
  if (e == 0) e = hopper::allow_smem(masked_matmul_wgmma_kernel, kTcSmem);
  if (e != 0) return e;
  const int tiles = ((M + kTcBM - 1) / kTcBM) * (N / kTcBN);
  const int grid = tiles < hopper::num_sms() ? tiles : hopper::num_sms();
  masked_matmul_wgmma_kernel<<<grid, kTcThreads, kTcSmem, stream>>>(
      xmap, wmap, static_cast<const float*>(block_mask), static_cast<__nv_bfloat16*>(y), M,
      K, N);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_fwd(const void* x, const void* w, const void* block_mask, void* y, void* ws,
               int M, int K, int N, cudaStream_t stream) {
  if (M <= kDecodeMaxM) return launch_gemv<T>(x, w, block_mask, y, ws, M, K, N, stream);
  // y[M,N] = x[M,K] @ w[K,N]
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return launch_fwd_wgmma(x, w, block_mask, y, M, K, N, stream);
  else
    return launch_fwd_f32(x, w, block_mask, y, ws, M, K, N, stream);
}

bool bad_shape(int M, int K, int N) {
  return M <= 0 || K <= 0 || N <= 0 || K % kBlockN != 0 || N % kBlockN != 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Each launcher returns the cudaError_t
// of its launch.

// K1: y[M,N] = x[M,K] @ w[K,N], pruned column blocks of y written as zeros.
// `ws` is a workspace: for M <= 64 with more than one split
// (masked_matmul_decode_splits), int32 arrival counters, zero, for the N/64
// column tiles (rounded up to a multiple of 4), then splits*M*N f32
// partials, the counters left at zero; in f32 at M > 64, K * (M rounded up
// to 4) floats for x^T.  Otherwise it is unused and may be null.
extern "C" int masked_matmul_launch(const void* x, const void* w, const void* block_mask,
                                    void* y, void* ws, int M, int K, int N, int dtype,
                                    void* stream) {
  if (bad_shape(M, K, N)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_fwd<float>(x, w, block_mask, y, ws, M, K, N, s);
  if (dtype == 1) return launch_fwd<__nv_bfloat16>(x, w, block_mask, y, ws, M, K, N, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K1 at M <= 64: how many ways the decode body splits the contraction on a
// card of `sms` SMs (a function of the shapes and `sms` only), or -1 for
// shapes it does not take.  The host sizes the workspace with it.
extern "C" int masked_matmul_decode_splits(int M, int K, int N, int sms) {
  if (bad_shape(M, K, N) || M > kDecodeMaxM || sms < 1) return -1;
  return gv_plan(M, K, N, sms).splits;
}

// K2: dx[M,K] = dy[M,N] @ w[K,N]^T over the kept N-blocks only, their
// contraction split `splits` ways; with splits > 1, `ws` is an f32
// workspace of splits*M*K elements (unused, and may be null, at 1).
// tile_rows x tile_cols is the dx tile the host counted its splits with;
// any other than kDxRows x kDxCols is refused.
extern "C" int masked_matmul_dx_launch(const void* dy, const void* w, const void* block_mask,
                                       void* dx, void* ws, int M, int K, int N, int splits,
                                       int tile_rows, int tile_cols, int dtype,
                                       void* stream) {
  if (bad_shape(M, K, N) || splits < 1 || (splits > 1 && ws == nullptr) ||
      tile_rows != kDxRows || tile_cols != kDxCols)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dx<float>(dy, w, block_mask, dx, ws, M, K, N, splits, s);
  if (dtype == 1)
    return launch_dx<__nv_bfloat16>(dy, w, block_mask, dx, ws, M, K, N, splits, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K3: dw[K,N] = x[M,K]^T @ dy[M,N], pruned column blocks of dw exact zeros.
extern "C" int masked_matmul_dw_launch(const void* x, const void* dy, const void* block_mask,
                                       void* dw, int M, int K, int N, int dtype,
                                       void* stream) {
  if (bad_shape(M, K, N)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // P = K, Q = N, R = M; A(p,r) = x[r*K + p], B(r,q) = dy[r*N + q]
  if (dtype == 0) return launch_gemm<float>(x, dy, block_mask, dw, K, N, M, K, N, s);
  if (dtype == 1) return launch_gemm<__nv_bfloat16>(x, dy, block_mask, dw, K, N, M, K, N, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
