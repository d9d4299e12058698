// Mamba2 SSD scan (the chunked state-space recurrence), for sm_90a.
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py::_ssd_kernel
// (pallas_call in ssd_scan(), line 84).
//
// x [B,S,nh,p], bmat/cmat [B,S,N], dt [B,S,nh] of one type (f32 or bf16),
// each with its own row stride (the step t of batch b starts at (b*S + t) *
// row elements; within a row x is [nh][p] and contiguous, B, C and dt are
// contiguous), a_log/d/dt_bias [nh] f32, y [B,S,nh,p] contiguous in x's
// type.  Per head h, with dtv_t = softplus(dt_t + dt_bias_h) and
// la_t = -dtv_t * exp(a_log_h) (the Pallas form, no clip):
//   H_t = exp(la_t) H_{t-1} + (dtv_t x_t) B_t^T,   y_t = C_t H_t + D_h x_t,
// with the state H [p, N] in f32, zero at t = -1.  N = 64; p any multiple
// of 8.  The rows of p are independent, so the passes work on sub-heads of
// 64 of them: head h is sub-heads h * nsub .. h * nsub + nsub - 1, nsub =
// ceil(p / 64), the last one's columns past p zero-filled and not stored.
// p = 64 (zamba2, one sub-head a head) runs its own instance (kWhole).
//
// What bounds it on an H100.  At zamba2 (B = 1, S = 8192, nh = 64) the
// inputs and y are 0.14 GB in bf16: 0.041 ms at 3.35 TB/s.  The kernel this
// one replaces was bound by latency: one block per (16 rows of p, head)
// walked all S steps in series, 2 blocks per SM, f32 FMAs, and C B^T
// recomputed by each of the 256 blocks that share it (1.94 ms, 47x the
// bound).  The chunked form below runs in parallel over chunks and puts its
// products (~17 GFLOP at a chunk of 128, ~35 with the bf16 hi/lo splits) on
// the tensor cores; it moves ~0.46 GB at a chunk of 128 (x read twice, y,
// and the f32 states written, passed and read: 0.14 ms at 3.35 TB/s).  What
// bounds it now is latency in pass 3 (PERF.md: its time does not move with
// L2 reuse between the passes, and drops when its products are removed).
//
// The design: the state-space-duality chunked form (the structure of the
// mamba_ssm chunk_state / state_passing / chunk_scan kernels), three
// launches on one stream, chunks of Q = kChunk<T> steps (the result does not
// depend on Q beyond f32 rounding).  "Head" below means sub-head.
//   1. ssd_chunk_state_kernel, one 256-thread block per (chunk c < nc-1,
//      4 heads, batch): per head the chunk's prefix sum cum of la (one warp
//      a head), total_c = cum_{Q-1} (written to `totals`), and the chunk's
//      own state S_c = sum_j exp(total_c - cum_j) dtv_j x_j B_j^T, a
//      (p x Q)(Q x N) product on the tensor cores (warps w and w + 4 share
//      the rows [16(w%4), +16) of p, each half of N), written to `state`.
//   2. ssd_state_pass_kernel: H_c = exp(total_c) H_{c-1} + S_c in series
//      over the chunks, in parallel over the (b, h, p, n) elements (262144 at
//      zamba2), 8 chunks' loads in flight a thread; it overwrites S_c with
//      H_c, the state entering chunk c + 1 (for bf16 already split into the
//      bf16 hi + lo that pass 3's products take, in the same 4 bytes).
//   3. ssd_chunk_scan_kernel, one block of Q/32 warps per (chunk, 16 heads,
//      batch), two blocks an SM.  Warp w owns the row tiles w and Q/16-1-w
//      of the chunk, so every warp has the same causal work.  C B^T is
//      computed once per block (the heads share it) and kept in registers,
//      the causal half only.  Per head:
//        y = exp(cum_i) C H_{c-1}^T + G X + D x,
//        G_ij = (C B^T)_ij exp(cum_i - cum_j) dtv_j for j <= i, else 0 (the
//      mask inside the exp: exp is never taken of a positive exponent).
//      The next head's x and state stream in by cp.async while this head
//      computes (two state tiles take turns, one in the space of B, free
//      once C B^T is done).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kP = 64;          // columns of p a sub-head
constexpr int kN = 64;          // state size N
// The chunk Q each type runs, chosen by measurement (PERF.md): a larger Q
// moves fewer state bytes, a smaller one does less masked work and needs
// fewer registers (f32 at 128 takes one block an SM).
template <typename T>
constexpr int kChunk = sizeof(T) == 2 ? 128 : 64;
constexpr int kHG = 16;         // heads per block of pass 3 (they share C B^T)
constexpr int kHG1 = 4;         // heads per block of pass 1
constexpr int kStateSplitN = 2;   // pass 1: warps that share a p slice, N split
constexpr int kStateThreads = 128 * kStateSplitN;
constexpr int kPassThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

// Shared-memory row pitch of a 64-wide tile: 16 bytes of padding, so the 8
// row addresses of an ldmatrix (and the f32 fragment loads) hit distinct
// banks.
template <typename T>
constexpr int kLd = 64 + 16 / static_cast<int>(sizeof(T));

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

__device__ __forceinline__ float softplus(float z) {
  return fmaxf(z, 0.f) + log1pf(expf(-fabsf(z)));   // jax.nn.softplus
}

// 16-byte global -> shared copy, zero-filled (nothing read) when !valid.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows [0, Q) of a 64-wide tile from global rows `row` elements apart;
// rows at or past `rows`, and columns at or past `cols` (a multiple of 8),
// are zero-filled.
template <typename T, int Q, int kThreads>
__device__ __forceinline__ void load_rows(T* dst, const T* src, size_t row, int rows,
                                          int cols, int tid) {
  constexpr int kE = 16 / static_cast<int>(sizeof(T));   // elements a piece
  constexpr int kC = 64 / kE;                            // pieces a row
#pragma unroll 4
  for (int i = tid; i < Q * kC; i += kThreads) {
    const int r = i / kC, q = i % kC;
    const bool ok = r < rows && q * kE < cols;
    cp_async16(dst + r * kLd<T> + q * kE, ok ? src + r * row + q * kE : src, ok);
  }
}

// ---------------------------------------------------------------------------
// tensor-core fragments
// ---------------------------------------------------------------------------

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s) : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s) : "memory");
}
// d[16 x 8] += a[16 x 16] b[16 x 8], bf16 operands, f32 sums.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// d[16 x 8] += a[16 x 8] b[8 x 8], tf32 operands, f32 sums.
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// One 16-deep step of an operand.  A: a 16 x 16 tile; B: two 16 x 8 tiles
// (output columns n0..n0+7 and n0+8..n0+15).  Lane l holds, with g = l / 4
// and t = l % 4 ("the fragment order", 8 floats of A, 4 of each B tile):
//   A: (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1), then the same at k + 8;
//   B: (k 2t, n g), (2t+1, g), (2t+8, g), (2t+9, g).
// bf16: hi[] are the m16n8k16 registers (B: hi[0..1] tile 0, hi[2..3]
// tile 1); lo[] the remainder v - hi of an operand that was f32.
// f32: A keeps big[]/small[], its tf32 parts in m16n8k8 register order, two
// 8-deep steps ([0..3], [4..7]), logical k 2t and 2t+1 in the m16n8k8 slots
// t and t + 4 (A is used for several B tiles, so it is split once); B keeps
// its values v[] (tile 0 [0..3], tile 1 [4..7], each in the fragment order)
// and is split where it is used, once.
template <typename T> struct Frag;
template <> struct Frag<bf16> { uint32_t hi[4], lo[4]; };
template <> struct Frag<float> { uint32_t big[8], small[8]; };
template <typename T> struct FragB { using type = Frag<T>; };
struct FragB32 { float v[8]; };
template <> struct FragB<float> { using type = FragB32; };
template <typename T> using BFrag = typename FragB<T>::type;

__device__ __forceinline__ void split_tf32(float v, uint32_t& big, uint32_t& small) {
  big = to_tf32(v);
  small = to_tf32(v - __uint_as_float(big));
}

// A from 8 f32 values in the fragment order (the f32-valued operands).
__device__ __forceinline__ void make_a(Frag<bf16>& f, const float* v) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f.hi[i] = pack_bf16(v[2 * i], v[2 * i + 1]);
    const float2 h = unpack_bf16(f.hi[i]);
    f.lo[i] = pack_bf16(v[2 * i] - h.x, v[2 * i + 1] - h.y);
  }
}
__device__ __forceinline__ void make_a(Frag<float>& f, const float* v) {
  constexpr int kOrder[8] = {0, 2, 1, 3, 4, 6, 5, 7};
#pragma unroll
  for (int i = 0; i < 8; ++i) split_tf32(v[kOrder[i]], f.big[i], f.small[i]);
}

// A stored [m][k] (k contiguous), exact in bf16.
__device__ __forceinline__ void load_a(Frag<bf16>& f, const bf16* s, int m0, int k0, int lane) {
  const int mi = lane >> 3, r = lane & 7;
  ldsm_x4(f.hi, s + (m0 + r + 8 * (mi & 1)) * kLd<bf16> + k0 + 8 * (mi >> 1));
}
__device__ __forceinline__ void load_a(Frag<float>& f, const float* s, int m0, int k0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  float v[8];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 e = *reinterpret_cast<const float2*>(
        s + (m0 + g + 8 * (q & 1)) * kLd<float> + k0 + 2 * t + 8 * (q >> 1));
    v[2 * q] = e.x;
    v[2 * q + 1] = e.y;
  }
  make_a(f, v);
}

// A stored [k][m] (m contiguous), as f32 values in the fragment order.
__device__ __forceinline__ void load_a_t(float* v, const bf16* s, int m0, int k0, int lane) {
  const int mi = lane >> 3, r = lane & 7;
  uint32_t u[4];
  ldsm_x4_t(u, s + (k0 + r + 8 * (mi >> 1)) * kLd<bf16> + m0 + 8 * (mi & 1));
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 e = unpack_bf16(u[q]);
    v[2 * q] = e.x;
    v[2 * q + 1] = e.y;
  }
}
__device__ __forceinline__ void load_a_t(float* v, const float* s, int m0, int k0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float* p = s + (k0 + 2 * t + 8 * (q >> 1)) * kLd<float> + m0 + g + 8 * (q & 1);
    v[2 * q] = p[0];
    v[2 * q + 1] = p[kLd<float>];
  }
}

// B for two n tiles, stored [n][k] (k contiguous), exact in bf16.
__device__ __forceinline__ void load_b(Frag<bf16>& f, const bf16* s, int n0, int k0, int lane) {
  const int mi = lane >> 3, r = lane & 7;
  ldsm_x4(f.hi, s + (n0 + r + 8 * (mi >> 1)) * kLd<bf16> + k0 + 8 * (mi & 1));
}
__device__ __forceinline__ void load_b(FragB32& f, const float* s, int n0, int k0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const float* p = s + (n0 + 8 * q + g) * kLd<float> + k0 + 2 * t;
    const float2 e0 = *reinterpret_cast<const float2*>(p);
    const float2 e8 = *reinterpret_cast<const float2*>(p + 8);
    f.v[4 * q] = e0.x;
    f.v[4 * q + 1] = e0.y;
    f.v[4 * q + 2] = e8.x;
    f.v[4 * q + 3] = e8.y;
  }
}

// B for two n tiles, stored [k][n] (n contiguous), exact in bf16.
__device__ __forceinline__ void load_b_t(Frag<bf16>& f, const bf16* s, int n0, int k0, int lane) {
  const int mi = lane >> 3, r = lane & 7;
  ldsm_x4_t(f.hi, s + (k0 + r + 8 * (mi & 1)) * kLd<bf16> + n0 + 8 * (mi >> 1));
}
__device__ __forceinline__ void load_b_t(FragB32& f, const float* s, int n0, int k0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const float* p = s + (k0 + 2 * t) * kLd<float> + n0 + 8 * q + g;
    f.v[4 * q] = p[0];
    f.v[4 * q + 1] = p[kLd<float>];
    f.v[4 * q + 2] = p[8 * kLd<float>];
    f.v[4 * q + 3] = p[9 * kLd<float>];
  }
}

// The state H [p][N] as a B operand (k = n, output column = p).  bf16: the
// tile holds hi rows [0, p) and lo rows [p, 2p) (H was f32); f32: H itself.
template <typename T> struct StateTile;
template <> struct StateTile<bf16> { static constexpr int kRows = 2 * kP; };
template <> struct StateTile<float> { static constexpr int kRows = kP; };

__device__ __forceinline__ void load_h(Frag<bf16>& f, const bf16* s, int n0, int k0, int lane) {
  load_b(f, s, n0, k0, lane);
  const int mi = lane >> 3, r = lane & 7;
  ldsm_x4(f.lo, s + (kP + n0 + r + 8 * (mi >> 1)) * kLd<bf16> + k0 + 8 * (mi & 1));
}
__device__ __forceinline__ void load_h(FragB32& f, const float* s, int n0, int k0, int lane) {
  load_b(f, s, n0, k0, lane);
}

// 8-byte global -> shared copy.
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem));
}

// One head's state [p][N] (pass 2's output) into a state tile, by cp.async.
// Each 16-byte piece i holds the elements 4i..4i+3 of [p][N]: in f32 as they
// are; for bf16 pass 2 has split them, hi0..hi3 then lo0..lo3.
__device__ __forceinline__ void load_state(bf16* tile, const float* src, int tid,
                                           int threads) {
  const uint8_t* g = reinterpret_cast<const uint8_t*>(src);
#pragma unroll 4
  for (int i = tid; i < kP * kN / 4; i += threads) {
    bf16* d = tile + (4 * i / kN) * kLd<bf16> + 4 * i % kN;
    cp_async8(d, g + 16 * i);
    cp_async8(d + kP * kLd<bf16>, g + 16 * i + 8);
  }
}
__device__ __forceinline__ void load_state(float* tile, const float* src, int tid,
                                           int threads) {
#pragma unroll 4
  for (int i = tid; i < kP * kN / 4; i += threads)
    cp_async16(tile + (4 * i / kN) * kLd<float> + 4 * i % kN, src + 4 * i, true);
}

// d0, d1 (the two n tiles of b) += a b.  bf16: one product of the hi parts,
// plus a.lo b.hi when A was f32 and a.hi b.lo when B was; f32: 3xTF32, the
// small terms first.
template <bool kASplit, bool kBSplit>
__device__ __forceinline__ void mma2(float* d0, float* d1, const Frag<bf16>& a,
                                     const Frag<bf16>& b) {
  if (kASplit) {
    mma_bf16(d0, a.lo, b.hi);
    mma_bf16(d1, a.lo, b.hi + 2);
  }
  if (kBSplit) {
    mma_bf16(d0, a.hi, b.lo);
    mma_bf16(d1, a.hi, b.lo + 2);
  }
  mma_bf16(d0, a.hi, b.hi);
  mma_bf16(d1, a.hi, b.hi + 2);
}
template <bool kASplit, bool kBSplit>
__device__ __forceinline__ void mma2(float* d0, float* d1, const Frag<float>& a,
                                     const FragB32& b) {
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    float* d = q ? d1 : d0;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      uint32_t big[2], small[2];
      split_tf32(b.v[4 * q + 2 * s], big[0], small[0]);
      split_tf32(b.v[4 * q + 2 * s + 1], big[1], small[1]);
      mma_tf32(d, a.small + 4 * s, big);
      mma_tf32(d, a.big + 4 * s, small);
      mma_tf32(d, a.big + 4 * s, big);
    }
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const bf16* p) {
  return unpack_bf16(*reinterpret_cast<const uint32_t*>(p));
}

// One warp: dtv and the inclusive prefix sum of la = -dtv * exp(a_log) over
// the Q steps of a chunk of one head (lane l takes steps [lE, lE + E) in
// order, then the lanes' sums are scanned).  Returns the chunk's total.
template <typename T, int Q>
__device__ __forceinline__ float chunk_cumsum(const T* dtb, size_t dt_row, int rows,
                                              float bias, float a, float* cum, float* dtv,
                                              int lane) {
  constexpr int kE = Q / 32;
  float c[kE], d[kE], run = 0.f;
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    const int i = lane * kE + e;
    d[e] = i < rows ? softplus(to_f32(dtb[i * dt_row]) + bias) : 0.f;
    run -= d[e] * a;
    c[e] = run;
  }
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  const float before = incl - run;
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    cum[lane * kE + e] = c[e] + before;
    dtv[lane * kE + e] = d[e];
  }
  return __shfl_sync(0xffffffffu, incl, 31);
}

struct Args {
  const void* x;
  const void* bmat;
  const void* cmat;
  const void* dt;
  const float* a_log;
  const float* d;
  const float* dt_bias;
  void* y;
  float* state;    // [B][nc-1][nsh][64][N]
  float* totals;   // [B][nc-1][nsh]
  int S, nh, P, nsub, nsh, nc;   // nsh = nh * nsub sub-heads
  size_t x_row, b_row, c_row, dt_row;
};

// Sub-head s: head h, its first column col of p and its width cols (<= 64).
// kWhole (p = 64, every registered config): sub-head s is head s, whole, and
// the column tests fold away (the general instance at p = 64 is ~5% slower,
// PERF.md).
struct Sub {
  int h, col, cols;
};
template <bool kWhole>
__device__ __forceinline__ Sub sub_head(const Args& a, int s) {
  if (kWhole) return {s, 0, kP};
  const int h = s / a.nsub, col = (s - h * a.nsub) * kP;
  return {h, col, min(kP, a.P - col)};
}

// ---------------------------------------------------------------------------
// pass 1: each chunk's own state S_c and total_c (chunks 0 .. nc-2)
// ---------------------------------------------------------------------------

template <int Q>
constexpr int state_smem_bytes(int elt) {
  return 3 * Q * (64 + 16 / elt) * elt + 2 * kHG1 * Q * 4;
}

template <typename T, int Q, bool kWhole>
__global__ void __launch_bounds__(kStateThreads)
ssd_chunk_state_kernel(Args a) {
  constexpr int kL = kLd<T>;
  const int P = kWhole ? kP : a.P;
  extern __shared__ __align__(16) uint8_t smem[];
  T* bs = reinterpret_cast<T*>(smem);         // [Q][kL] B
  T* xs = bs + Q * kL;                        // [2][Q][kL] x of one head
  float* wts = reinterpret_cast<float*>(xs + 2 * Q * kL);   // [kHG1][Q] weights
  float* cums = wts + kHG1 * Q;               // [kHG1][Q] cum

  const int c = blockIdx.x, h0 = blockIdx.y * kHG1, b = blockIdx.z;
  const int heads = min(kHG1, a.nsh - h0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int t0 = c * Q;
  const int rows = min(Q, a.S - t0);
  const size_t step0 = static_cast<size_t>(b) * a.S + t0;
  const T* xb = static_cast<const T*>(a.x) + step0 * a.x_row;
  const T* dtb = static_cast<const T*>(a.dt) + step0 * a.dt_row;

  load_rows<T, Q, kStateThreads>(bs, static_cast<const T*>(a.bmat) + step0 * a.b_row,
                                 a.b_row, rows, kN, tid);
  const Sub first = sub_head<kWhole>(a, h0);
  load_rows<T, Q, kStateThreads>(xs, xb + static_cast<size_t>(first.h) * P + first.col,
                                 a.x_row, rows, first.cols, tid);
  cp_async_commit();
  for (int hh = warp; hh < heads; hh += kStateThreads / 32) {
    const int h = sub_head<kWhole>(a, h0 + hh).h;
    float* w = wts + hh * Q;
    float* cum = cums + hh * Q;
    const float total = chunk_cumsum<T, Q>(dtb + h, a.dt_row, rows, a.dt_bias[h],
                                           expf(a.a_log[h]), cum, w, lane);
    __syncwarp();
    for (int i = lane; i < Q; i += 32) w[i] *= expf(total - cum[i]);
    if (lane == 0)
      a.totals[(static_cast<size_t>(b) * (a.nc - 1) + c) * a.nsh + h0 + hh] = total;
  }

  for (int hh = 0; hh < heads; ++hh) {
    cp_async_wait_all();
    __syncthreads();
    if (hh + 1 < heads) {
      const Sub next = sub_head<kWhole>(a, h0 + hh + 1);
      load_rows<T, Q, kStateThreads>(xs + ((hh + 1) & 1) * Q * kL,
                                     xb + static_cast<size_t>(next.h) * P + next.col,
                                     a.x_row, rows, next.cols, tid);
      cp_async_commit();
    }
    const T* xcur = xs + (hh & 1) * Q * kL;
    const float* w = wts + hh * Q;
    constexpr int kNT = 8 / kStateSplitN;         // n tiles of 8 a warp
    const int pw = warp % 4, n0 = (warp / 4) * 8 * kNT;
    float acc[kNT][4];
#pragma unroll
    for (int i = 0; i < kNT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < Q / 16; ++kk) {
      float v[8];
      load_a_t(v, xcur, 16 * pw, 16 * kk, lane);
      const float2 w0 = *reinterpret_cast<const float2*>(w + 16 * kk + 2 * t);
      const float2 w8 = *reinterpret_cast<const float2*>(w + 16 * kk + 8 + 2 * t);
      v[0] *= w0.x; v[1] *= w0.y; v[2] *= w0.x; v[3] *= w0.y;
      v[4] *= w8.x; v[5] *= w8.y; v[6] *= w8.x; v[7] *= w8.y;
      Frag<T> fa;
      make_a(fa, v);
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        BFrag<T> fb;
        load_b_t(fb, bs, n0 + 16 * np, 16 * kk, lane);
        mma2<true, false>(acc[2 * np], acc[2 * np + 1], fa, fb);
      }
    }
    float* out = a.state + ((static_cast<size_t>(b) * (a.nc - 1) + c) * a.nsh + h0 + hh) *
                               (kP * kN);
    const int p0 = 16 * pw + g;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      store2(out + p0 * kN + n0 + 8 * nt + 2 * t, acc[nt][0], acc[nt][1]);
      store2(out + (p0 + 8) * kN + n0 + 8 * nt + 2 * t, acc[nt][2], acc[nt][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// pass 2: the state entering each chunk, in series over the chunks
// ---------------------------------------------------------------------------

// Each thread reads a 16-byte piece of S_c and writes H_c over it: as f32,
// or (kSplit, for the bf16 pass 3) as bf16 hi0..hi3 then lo0..lo3, where
// hi = bf16(H) and lo = bf16(H - hi), the split pass 3's products use.
template <bool kSplit>
__global__ void __launch_bounds__(kPassThreads)
ssd_state_pass_kernel(float* __restrict__ state, const float* __restrict__ totals, int B,
                      int nc1, int nh) {
  constexpr int kE4 = kP * kN / 4;     // float4 pieces of one head's state
  constexpr int kAhead = 8;            // chunks whose loads are in flight
  const size_t per_b = static_cast<size_t>(nh) * kE4;
  const size_t idx = static_cast<size_t>(blockIdx.x) * kPassThreads + threadIdx.x;
  if (idx >= per_b * B) return;
  const int b = static_cast<int>(idx / per_b);
  const size_t e = idx % per_b;
  const int h = static_cast<int>(e / kE4);
  float4* s = reinterpret_cast<float4*>(state) + static_cast<size_t>(b) * nc1 * per_b + e;
  const float* tot = totals + static_cast<size_t>(b) * nc1 * nh + h;
  float4 H = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < nc1; c0 += kAhead) {
    float4 v[kAhead];
    float f[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (c0 + k < nc1) {
        v[k] = s[static_cast<size_t>(c0 + k) * per_b];
        f[k] = expf(tot[static_cast<size_t>(c0 + k) * nh]);
      }
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (c0 + k < nc1) {
        H.x = fmaf(f[k], H.x, v[k].x);
        H.y = fmaf(f[k], H.y, v[k].y);
        H.z = fmaf(f[k], H.z, v[k].z);
        H.w = fmaf(f[k], H.w, v[k].w);
        float4* out = s + static_cast<size_t>(c0 + k) * per_b;
        if (kSplit) {
          const uint32_t h0 = pack_bf16(H.x, H.y), h1 = pack_bf16(H.z, H.w);
          const float2 a = unpack_bf16(h0), b = unpack_bf16(h1);
          *reinterpret_cast<uint4*>(out) =
              make_uint4(h0, h1, pack_bf16(H.x - a.x, H.y - a.y), pack_bf16(H.z - b.x, H.w - b.y));
        } else {
          *out = H;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// pass 3: y per chunk from its inputs and the state entering it
// ---------------------------------------------------------------------------

// Shared memory of pass 3: C, B (whose space takes a state tile once C B^T
// is done), x twice, a second state tile, cum and dtv.  The state tiles take
// turns: head hh's state lands in tile hh % 2 while head hh - 1 computes.
template <typename T, int Q>
__host__ __device__ constexpr int b_bytes() {
  return Q * kLd<T> * static_cast<int>(sizeof(T)) >
                 StateTile<T>::kRows * kLd<T> * static_cast<int>(sizeof(T))
             ? Q * kLd<T> * static_cast<int>(sizeof(T))
             : StateTile<T>::kRows * kLd<T> * static_cast<int>(sizeof(T));
}
template <typename T, int Q>
constexpr int scan_smem_bytes() {
  return (3 * Q + StateTile<T>::kRows) * kLd<T> * static_cast<int>(sizeof(T)) +
         b_bytes<T, Q>() + 2 * kHG * Q * 4;
}

// 2^x in one instruction (relative error ~2^-22; results below 2^-126
// flush to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float gate(float cb, float c2i, int i, float c2j, float dtvj, int j) {
  return j <= i ? ex2(c2i - c2j) * (cb * dtvj) : 0.f;
}

// Warp w of pass 3 owns the row tiles w and kT-1-w (kT = Q/16), so that the
// causal work is the same for every warp: kT + 1 (row tile, key group)
// products, slot s of its C B^T registers holding
//   s <= w: row tile w, key group s;   s > w: row tile kT-1-w, group kT-s.
// scan_tile computes one of the two row tiles (kSecond) for one head:
// acc = exp(cum_i) C_i H^T (after the first chunk), += G X over the tile's
// slots, then + D x, stored for the rows inside S and the columns inside p.
template <typename T, int kT, bool kSecond>
__device__ __forceinline__ void scan_tile(const float (&cb)[kT + 1][2][4], int w, bool carry,
                                          const T* cs, const T* hs, const T* xcur,
                                          const float* c2, const float* dv, float dh, T* yb,
                                          size_t y_row, int rows, int cols, int lane) {
  constexpr int kL = kLd<T>;
  const int g = lane >> 2, t = lane & 3;
  const int r = kSecond ? kT - 1 - w : w;
  const int i0 = 16 * r + g, i1 = i0 + 8;
  const float c2i0 = c2[i0], c2i1 = c2[i1];
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  if (carry) {
    // f32 keeps this loop rolled: unrolled, its 3xTF32 fragments spill
    constexpr int kUnroll = sizeof(T) == 2 ? kN / 16 : 1;
#pragma unroll kUnroll
    for (int kk = 0; kk < kN / 16; ++kk) {
      Frag<T> fa;
      load_a(fa, cs, 16 * r, 16 * kk, lane);
#pragma unroll
      for (int np = 0; np < kP / 16; ++np) {
        BFrag<T> fb;
        load_h(fb, hs, 16 * np, 16 * kk, lane);
        mma2<false, true>(acc[2 * np], acc[2 * np + 1], fa, fb);
      }
    }
    const float e0 = ex2(c2i0), e1 = ex2(c2i1);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      acc[i][0] *= e0; acc[i][1] *= e0;
      acc[i][2] *= e1; acc[i][3] *= e1;
    }
  }
#pragma unroll
  for (int s = 0; s <= kT; ++s) {
    if ((s > w) != kSecond) continue;
    const int kk = kSecond ? kT - s : s;
    const int j = 16 * kk + 2 * t;
    const float2 cj0 = *reinterpret_cast<const float2*>(c2 + j);
    const float2 cj8 = *reinterpret_cast<const float2*>(c2 + j + 8);
    const float2 dj0 = *reinterpret_cast<const float2*>(dv + j);
    const float2 dj8 = *reinterpret_cast<const float2*>(dv + j + 8);
    const float* lo = cb[s][0];
    const float* hi = cb[s][1];
    float v[8];
    v[0] = gate(lo[0], c2i0, i0, cj0.x, dj0.x, j);
    v[1] = gate(lo[1], c2i0, i0, cj0.y, dj0.y, j + 1);
    v[2] = gate(lo[2], c2i1, i1, cj0.x, dj0.x, j);
    v[3] = gate(lo[3], c2i1, i1, cj0.y, dj0.y, j + 1);
    v[4] = gate(hi[0], c2i0, i0, cj8.x, dj8.x, j + 8);
    v[5] = gate(hi[1], c2i0, i0, cj8.y, dj8.y, j + 9);
    v[6] = gate(hi[2], c2i1, i1, cj8.x, dj8.x, j + 8);
    v[7] = gate(hi[3], c2i1, i1, cj8.y, dj8.y, j + 9);
    Frag<T> fa;
    make_a(fa, v);
#pragma unroll
    for (int np = 0; np < kP / 16; ++np) {
      BFrag<T> fb;
      load_b_t(fb, xcur, 16 * np, 16 * kk, lane);
      mma2<true, false>(acc[2 * np], acc[2 * np + 1], fa, fb);
    }
  }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = 8 * nt + 2 * t;
    if (col >= cols) continue;
    if (i0 < rows) {
      const float2 xv = load2(xcur + i0 * kL + col);
      store2(yb + i0 * y_row + col, fmaf(dh, xv.x, acc[nt][0]), fmaf(dh, xv.y, acc[nt][1]));
    }
    if (i1 < rows) {
      const float2 xv = load2(xcur + i1 * kL + col);
      store2(yb + i1 * y_row + col, fmaf(dh, xv.x, acc[nt][2]), fmaf(dh, xv.y, acc[nt][3]));
    }
  }
}

template <typename T, int Q, bool kWhole>
__global__ void __launch_bounds__(Q, 2)
ssd_chunk_scan_kernel(Args a) {
  constexpr int kT = Q / 16, kThreads = Q, kL = kLd<T>;
  const int P = kWhole ? kP : a.P;
  extern __shared__ __align__(16) uint8_t smem[];
  T* cs = reinterpret_cast<T*>(smem);                     // [Q][kL] C
  uint8_t* un = smem + Q * kL * sizeof(T);                // B, then state tile 0
  T* bs = reinterpret_cast<T*>(un);                       // [Q][kL] B
  T* xs = reinterpret_cast<T*>(un + b_bytes<T, Q>());     // [2][Q][kL] x of one head
  T* const tile0 = reinterpret_cast<T*>(un);              // state tiles (StateTile)
  T* const tile1 = xs + 2 * Q * kL;
  float* c2s = reinterpret_cast<float*>(tile1 + StateTile<T>::kRows * kL);  // [kHG][Q]
  float* dvs = c2s + kHG * Q;                             // [kHG][Q]

  const int c = blockIdx.x, h0 = blockIdx.y * kHG, b = blockIdx.z;
  const int heads = min(kHG, a.nsh - h0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t0 = c * Q;
  const int rows = min(Q, a.S - t0);
  const bool carry = c > 0;
  const size_t step0 = static_cast<size_t>(b) * a.S + t0;
  const T* xb = static_cast<const T*>(a.x) + step0 * a.x_row;
  const T* dtb = static_cast<const T*>(a.dt) + step0 * a.dt_row;
  const float* hin = carry ? a.state + ((static_cast<size_t>(b) * (a.nc - 1) + c - 1) * a.nsh +
                                        h0) * (kP * kN)
                           : nullptr;

  load_rows<T, Q, kThreads>(cs, static_cast<const T*>(a.cmat) + step0 * a.c_row, a.c_row,
                            rows, kN, tid);
  load_rows<T, Q, kThreads>(bs, static_cast<const T*>(a.bmat) + step0 * a.b_row, a.b_row,
                            rows, kN, tid);
  const Sub first = sub_head<kWhole>(a, h0);
  load_rows<T, Q, kThreads>(xs, xb + static_cast<size_t>(first.h) * P + first.col, a.x_row,
                            rows, first.cols, tid);
  cp_async_commit();
  for (int hh = warp; hh < heads; hh += kThreads / 32) {
    const int h = sub_head<kWhole>(a, h0 + hh).h;
    chunk_cumsum<T, Q>(dtb + h, a.dt_row, rows, a.dt_bias[h], expf(a.a_log[h]), c2s + hh * Q,
                       dvs + hh * Q, lane);
    __syncwarp();
    for (int i = lane; i < Q; i += 32) c2s[hh * Q + i] *= kLog2e;
  }
  cp_async_wait_all();
  __syncthreads();

  // C B^T for this warp's two row tiles, the causal half, in its slots
  float cb[kT + 1][2][4];
#pragma unroll
  for (int s = 0; s <= kT; ++s)
#pragma unroll
    for (int i = 0; i < 8; ++i) cb[s][i / 4][i % 4] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kN / 16; ++kk) {
    Frag<T> fa0, fa1;
    load_a(fa0, cs, 16 * warp, 16 * kk, lane);
    load_a(fa1, cs, 16 * (kT - 1 - warp), 16 * kk, lane);
#pragma unroll
    for (int s = 0; s <= kT; ++s) {
      const bool second = s > warp;
      BFrag<T> fb;
      load_b(fb, bs, 16 * (second ? kT - s : s), 16 * kk, lane);
      if (second)
        mma2<false, false>(cb[s][0], cb[s][1], fa1, fb);
      else
        mma2<false, false>(cb[s][0], cb[s][1], fa0, fb);
    }
  }
  __syncthreads();   // B is consumed: its space takes state tile 0
  if (carry) {
    load_state(tile0, hin, tid, kThreads);
    cp_async_commit();
  }

  const size_t y_row = static_cast<size_t>(a.nh) * P;
  for (int hh = 0; hh < heads; ++hh) {
    const Sub sub = sub_head<kWhole>(a, h0 + hh);
    cp_async_wait_all();
    __syncthreads();   // x and the state of this head have landed; head hh-1 is done
    if (hh + 1 < heads) {
      const Sub next = sub_head<kWhole>(a, h0 + hh + 1);
      load_rows<T, Q, kThreads>(xs + ((hh + 1) & 1) * Q * kL,
                                xb + static_cast<size_t>(next.h) * P + next.col, a.x_row,
                                rows, next.cols, tid);
      if (carry)
        load_state((hh & 1) ? tile0 : tile1, hin + static_cast<size_t>(hh + 1) * (kP * kN),
                   tid, kThreads);
      cp_async_commit();
    }
    const T* hs = (hh & 1) ? tile1 : tile0;
    const T* xcur = xs + (hh & 1) * Q * kL;
    const float* c2 = c2s + hh * Q;
    const float* dv = dvs + hh * Q;
    const float dh = a.d[sub.h];
    T* yb = static_cast<T*>(a.y) + (step0 * a.nh + sub.h) * P + sub.col;
    scan_tile<T, kT, false>(cb, warp, carry, cs, hs, xcur, c2, dv, dh, yb, y_row, rows,
                            sub.cols, lane);
    scan_tile<T, kT, true>(cb, warp, carry, cs, hs, xcur, c2, dv, dh, yb, y_row, rows,
                           sub.cols, lane);
  }
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, bool kWhole>
int launch(const Args& a, int B, cudaStream_t stream) {
  constexpr int Q = kChunk<T>;
  const int groups = (a.nsh + kHG - 1) / kHG;
  const int groups1 = (a.nsh + kHG1 - 1) / kHG1;
  const int s1 = state_smem_bytes<Q>(static_cast<int>(sizeof(T)));
  const int s3 = scan_smem_bytes<T, Q>();
  static const cudaError_t attr = [&] {
    const cudaError_t e = allow_smem(ssd_chunk_state_kernel<T, Q, kWhole>, s1);
    return e != cudaSuccess ? e : allow_smem(ssd_chunk_scan_kernel<T, Q, kWhole>, s3);
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (a.nc > 1) {
    ssd_chunk_state_kernel<T, Q, kWhole>
        <<<dim3(a.nc - 1, groups1, B), kStateThreads, s1, stream>>>(a);
    const size_t n4 = static_cast<size_t>(B) * a.nsh * (kP * kN / 4);
    ssd_state_pass_kernel<sizeof(T) == 2>
        <<<static_cast<unsigned>((n4 + kPassThreads - 1) / kPassThreads), kPassThreads, 0,
           stream>>>(a.state, a.totals, B, a.nc - 1, a.nsh);
  }
  ssd_chunk_scan_kernel<T, Q, kWhole><<<dim3(a.nc, groups, B), Q, s3, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The chunk Q of a type (dtype as below): the host sizes the workspace by it.
extern "C" int ssd_scan_chunk(int dtype) {
  return dtype == 0 ? kChunk<float> : dtype == 1 ? kChunk<bf16> : 0;
}

// dtype: 0 = float32, 1 = bfloat16 (x, bmat, cmat, dt and y); N = 64, P a
// multiple of 8; the row strides are in elements.  state and totals: f32
// workspaces of (nc-1) * B * nh * ceil(P / 64) * 64 * N and (nc-1) * B * nh *
// ceil(P / 64) elements, nc = ceil(S / ssd_scan_chunk(dtype)) (unused when
// nc = 1).  Returns the cudaError_t of the launches.
extern "C" int ssd_scan_launch(const void* x, const void* bmat, const void* cmat,
                               const void* dt, const void* a_log, const void* d,
                               const void* dt_bias, void* y, void* state, void* totals, int B,
                               int S, int nh, int P, int N, int dtype, int x_row, int b_row,
                               int c_row, int dt_row, void* stream) {
  const int Q = ssd_scan_chunk(dtype);
  if (B <= 0 || S <= 0 || nh <= 0 || P <= 0 || P % 8 || N != kN || x_row < nh * P ||
      b_row < N || c_row < N || dt_row < nh || Q == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nsub = (P + kP - 1) / kP;
  Args a{x, bmat, cmat, dt, static_cast<const float*>(a_log), static_cast<const float*>(d),
         static_cast<const float*>(dt_bias), y, static_cast<float*>(state),
         static_cast<float*>(totals), S, nh, P, nsub, nh * nsub, (S + Q - 1) / Q,
         static_cast<size_t>(x_row), static_cast<size_t>(b_row), static_cast<size_t>(c_row),
         static_cast<size_t>(dt_row)};
  if (a.nc > 1 && (state == nullptr || totals == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool whole = P == kP;
  if (dtype == 0) return whole ? launch<float, true>(a, B, s) : launch<float, false>(a, B, s);
  return whole ? launch<bf16, true>(a, B, s) : launch<bf16, false>(a, B, s);
}
