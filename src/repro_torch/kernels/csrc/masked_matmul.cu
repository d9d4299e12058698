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
// What bounds them on an H100, and the three bodies below.
//   * K1 at decode (M = serving slots, <= 64), either type: bytes.  Each w
//     element read feeds at most M multiply-adds, so the decode tile streams
//     the kept blocks of w once and keeps many 16-byte loads in flight.
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
//     are held to f32) meets 3.35 TB/s.  The tiled body below is a SIMT f32
//     GEMM: a 128x128 (or 64x64, when that gives too few blocks to fill 132
//     SMs) output tile per 256-thread block, 8x8 (or 4x4) outputs per
//     thread in registers, the A and B tiles staged through a two-stage
//     shared-memory ring with the next tile's global loads in flight while
//     the current one is used.  Tensor cores are not used: TF32 would round
//     the f32 operands.
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

// ---------------------------------------------------------------------------
// K1 decode tile (M <= 64): one thread block per (8-row M tile, 32-column
// slice of a 128-column block); a pruned block's slices exit after writing
// zeros.  256 threads = 64 K-groups x 4 column groups; each thread owns 8
// columns and reads 8 rows of w per 512-deep K chunk as 16-byte vectors, all
// in flight before any is used; the x chunk [8, 512] is staged in shared
// memory as f32.  Partial sums over the K-groups are reduced with warp
// shuffles and then across the 8 warps in shared memory.  An M tile re-reads
// w, so larger M goes to the tiled body further down.
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// The tiled body shared by K1 (f32, M > 64) and K3:
//   C[P,Q] = sum_r A(p,r) B(r,q), C row-major,
// where A(p,r) is a[p*lda + r] (kATrans false) or a[r*lda + p] (true), and
// B(r,q) is b[r*ldb + q] (kBTrans false) or b[q*ldb + r] (true).  The mask
// gates 128-column blocks of C: a pruned tile writes zeros and reads nothing.
// Ragged sizes: only P (K1: M) and R (K3: M) may be any size; the launcher
// checks the other alignments.
// ---------------------------------------------------------------------------

constexpr int kTK = 8;                  // contraction depth of one stage

template <typename T, int E> struct Load;   // E consecutive elements -> f32
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

template <int H> struct Lds;                // H consecutive floats of smem
template <> struct Lds<4> {
  __device__ static void run(const float* p, float* r) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    r[0] = v.x; r[1] = v.y; r[2] = v.z; r[3] = v.w;
  }
};
template <> struct Lds<2> {
  __device__ static void run(const float* p, float* r) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    r[0] = v.x; r[1] = v.y;
  }
};

template <typename T, int TM, bool kATrans, bool kBTrans>
__global__ void __launch_bounds__(kThreads)
tiled_kernel(const T* __restrict__ a, const T* __restrict__ b,
             const float* __restrict__ mask, T* __restrict__ c,
             int P, int Q, int R, int lda, int ldb) {
  constexpr int BT = 16 * TM;           // output tile edge (128 or 64)
  constexpr int H = TM / 2;             // outputs per thread per half-tile
  constexpr int E = BT * kTK / kThreads;  // elements a thread loads per operand
  __shared__ __align__(16) float As[2][kTK][BT];
  __shared__ __align__(16) float Bs[2][kTK][BT];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * BT;
  const int p0 = blockIdx.y * BT;

  if (!(mask[q0 / kBlockN] > 0.f)) {   // pruned output block
    for (int i = tid; i < BT * BT; i += kThreads) {
      const int r = i / BT, col = i % BT;
      if (p0 + r < P) store(c + static_cast<size_t>(p0 + r) * Q + q0 + col, 0.f);
    }
    return;
  }

  // where this thread's loads land: (row, col) within the stage's tile
  // non-transposed A / transposed B: BT rows of kTK contiguous elements
  constexpr int kRowThreads = kTK / E;
  const int ld_row = tid / kRowThreads, ld_col = (tid % kRowThreads) * E;
  // transposed A / non-transposed B: kTK rows of BT contiguous elements
  constexpr int kColThreads = BT / E;
  const int st_row = tid / kColThreads, st_col = (tid % kColThreads) * E;

  float ra[E], rb[E];
  auto load = [&](int r0) {
    if (!kATrans) {
      const int p = p0 + ld_row;
      if (p < P) Load<T, E>::run(a + static_cast<size_t>(p) * lda + r0 + ld_col, ra);
      else for (int e = 0; e < E; ++e) ra[e] = 0.f;
    } else {
      const int r = r0 + st_row;
      if (r < R) Load<T, E>::run(a + static_cast<size_t>(r) * lda + p0 + st_col, ra);
      else for (int e = 0; e < E; ++e) ra[e] = 0.f;
    }
    if (!kBTrans) {
      const int r = r0 + st_row;
      if (r < R) Load<T, E>::run(b + static_cast<size_t>(r) * ldb + q0 + st_col, rb);
      else for (int e = 0; e < E; ++e) rb[e] = 0.f;
    } else {
      const int q = q0 + ld_row;
      if (q < Q) Load<T, E>::run(b + static_cast<size_t>(q) * ldb + r0 + ld_col, rb);
      else for (int e = 0; e < E; ++e) rb[e] = 0.f;
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (!kATrans) As[buf][ld_col + e][ld_row] = ra[e];
      else As[buf][st_row][st_col + e] = ra[e];
      if (!kBTrans) Bs[buf][st_row][st_col + e] = rb[e];
      else Bs[buf][ld_col + e][ld_row] = rb[e];
    }
  };

  float acc[TM][TM];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) acc[i][j] = 0.f;

  load(0);                              // R > 0: the launcher checks M
  stash(0);
  __syncthreads();
  int buf = 0;
  for (int r0 = 0; r0 < R; r0 += kTK) {
    const int rn = r0 + kTK;
    if (rn < R) load(rn);               // next stage's loads in flight
#pragma unroll
    for (int k = 0; k < kTK; ++k) {
      float av[TM], bv[TM];
      Lds<H>::run(&As[buf][k][ty * H], av);
      Lds<H>::run(&As[buf][k][BT / 2 + ty * H], av + H);
      Lds<H>::run(&Bs[buf][k][tx * H], bv);
      Lds<H>::run(&Bs[buf][k][BT / 2 + tx * H], bv + H);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TM; ++j) acc[i][j] += av[i] * bv[j];
    }
    if (rn < R) stash(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int p = p0 + (i < H ? ty * H + i : BT / 2 + ty * H + i - H);
    if (p >= P) continue;
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      const int q = q0 + (j < H ? tx * H + j : BT / 2 + tx * H + j - H);
      store(c + static_cast<size_t>(p) * Q + q, acc[i][j]);
    }
  }
}

// 128x128 tiles when they give at least one block per SM, else 64x64.
constexpr int kNumSMs = 132;

template <typename T, bool kATrans, bool kBTrans>
int launch_tiled(const void* a, const void* b, const void* mask, void* c,
                 int P, int Q, int R, int lda, int ldb, cudaStream_t stream) {
  const long big_tiles = static_cast<long>(Q / 128) * ((P + 127) / 128);
  if (big_tiles >= kNumSMs) {
    const dim3 grid(Q / 128, (P + 127) / 128);
    tiled_kernel<T, 8, kATrans, kBTrans><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(a), static_cast<const T*>(b),
        static_cast<const float*>(mask), static_cast<T*>(c), P, Q, R, lda, ldb);
  } else {
    const dim3 grid(Q / 64, (P + 63) / 64);
    tiled_kernel<T, 4, kATrans, kBTrans><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(a), static_cast<const T*>(b),
        static_cast<const float*>(mask), static_cast<T*>(c), P, Q, R, lda, ldb);
  }
  return static_cast<int>(cudaGetLastError());
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

constexpr int kDecodeMaxM = 64;         // K1 takes the decode tile up to here

template <typename T>
int launch_fwd(const void* x, const void* w, const void* block_mask, void* y,
               int M, int K, int N, cudaStream_t stream) {
  if (M > kDecodeMaxM) {  // y[M,N] = x[M,K] @ w[K,N]
    if constexpr (std::is_same<T, __nv_bfloat16>::value)
      return launch_fwd_wgmma(x, w, block_mask, y, M, K, N, stream);
    else
      return launch_tiled<T, false, false>(x, w, block_mask, y, M, N, K, K, N,
                                              stream);
  }
  const dim3 grid((M + kBM - 1) / kBM, N / kCW);
  masked_matmul_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(block_mask), static_cast<T*>(y), M, K, N);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int M, int K, int N) {
  return M <= 0 || K <= 0 || N <= 0 || K % kBlockN != 0 || N % kBlockN != 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Each returns the cudaError_t of its
// launch.

// K1: y[M,N] = x[M,K] @ w[K,N], pruned column blocks of y written as zeros.
extern "C" int masked_matmul_launch(const void* x, const void* w, const void* block_mask,
                                    void* y, int M, int K, int N, int dtype,
                                    void* stream) {
  if (bad_shape(M, K, N)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_fwd<float>(x, w, block_mask, y, M, K, N, s);
  if (dtype == 1) return launch_fwd<__nv_bfloat16>(x, w, block_mask, y, M, K, N, s);
  return static_cast<int>(cudaErrorInvalidValue);
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
  if (dtype == 0)
    return launch_tiled<float, true, false>(x, dy, block_mask, dw, K, N, M, K, N, s);
  if (dtype == 1)
    return launch_tiled<__nv_bfloat16, true, false>(x, dy, block_mask, dw, K, N, M,
                                                       K, N, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
