// Mamba2 SSD scan (the chunked state-space recurrence), for sm_90a.
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py::_ssd_kernel
// (pallas_call in ssd_scan(), line 84).
//
// x [B,S,nh,p], bmat/cmat [B,S,N], dt [B,S,nh] (one type: f32 or bf16,
// row-major, contiguous), a_log/d/dt_bias [nh] f32, y [B,S,nh,p] in x's
// type.  Per head h, with dtv_t = softplus(dt_t + dt_bias_h) and
// la_t = -dtv_t * exp(a_log_h) (the Pallas form, no clip):
//   H_t = exp(la_t) H_{t-1} + (dtv_t x_t) B_t^T,   y_t = C_t H_t + D_h x_t,
// with the state H [p, N] in f32, zero at t = -1.
//
// What bounds it on an H100: operations, run in f32 as the Pallas kernel
// runs them (~26 GFLOP in the Pallas kernel's square chunk form at zamba2,
// S = 8192, against ~137 MB moved).  The TPU kernel keeps the whole state
// [nh, p, N] (1 MiB per sequence at zamba2) and a [chunk, chunk, nh] decay
// tensor in VMEM; on Hopper neither fits a block.  The rows of H are
// independent across heads and across p, so:
//   * one 128-thread block per (p-slice of 16 rows, head, batch) keeps its
//     H[16, N] slice in shared memory in f32 (256 blocks at zamba2, B = 1);
//   * the block walks the sequence in sub-chunks of L = 32 steps (its own
//     chunk: the result does not depend on it beyond f32 rounding, and the
//     wrapper's `chunk` is accepted for signature parity only); per
//     sub-chunk one warp takes the prefix sum of la (cum), then
//       G[i][j] = (C_i . B_j) exp(cum_i - cum_j) for j <= i, else 0 (the
//                 causal mask inside the exp: exp is never taken of a
//                 positive exponent), a 32 x 32 tile, never the whole
//                 chunk's C B^T;
//       y_i = sum_j G[i][j] dtv_j x_j + exp(cum_i) C_i . H + D x_i;
//       H  <- exp(cum_L) H + sum_j exp(cum_L - cum_j) dtv_j x_j B_j^T;
//   * C B^T is recomputed by each of the nh * p/16 blocks that share a
//     sub-chunk (it depends on the batch only): 2x the useful work at
//     zamba2, the price of keeping the state slice in one block;
//   * any S works: steps past S get dtv = la = 0 (the state is unchanged)
//     and are not written.
// Later: tensor-core products for C B^T and G x, a load ring, and a
// parallel-over-chunks form when B * nh * p / 16 leaves SMs idle.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kL = 32;               // sub-chunk length: one warp's scan
constexpr int kPS = 16;              // p rows per block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

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

__device__ __forceinline__ float softplus(float z) {
  return fmaxf(z, 0.f) + log1pf(expf(-fabsf(z)));   // jax.nn.softplus
}

template <int N>
__host__ __device__ constexpr int smem_floats() {
  return 2 * kL * (N + 4)      // B, C sub-chunk rows
         + 2 * kL * kPS        // x, dtv * x
         + kL * (kL + 1)       // G
         + N * kPS             // state slice, n-major
         + 4 * kL + 4;         // dtv, exp(cum), exp(cum_L - cum), exp(cum_L)
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const T* __restrict__ bmat,
                const T* __restrict__ cmat, const T* __restrict__ dt,
                const float* __restrict__ a_log, const float* __restrict__ dvec,
                const float* __restrict__ dt_bias, T* __restrict__ y, int S,
                int nh, int P) {
  constexpr int kNS = N + 4;         // row stride of the B and C tiles
  constexpr int kNG = N / 16;        // state columns per thread
  extern __shared__ __align__(16) float smem[];
  float* bs = smem;                  // [kL][kNS]
  float* cs = bs + kL * kNS;         // [kL][kNS]
  float* xr = cs + kL * kNS;         // [kL][kPS] x
  float* xs = xr + kL * kPS;         // [kL][kPS] dtv * x
  float* gs = xs + kL * kPS;         // [kL][kL + 1]
  float* hs = gs + kL * (kL + 1);    // [N][kPS] state H^T
  float* dtv_s = hs + N * kPS;       // [kL]
  float* ecum = dtv_s + kL;          // [kL] exp(cum_i)
  float* wend = ecum + kL;           // [kL] exp(cum_L - cum_j)
  float* tot = wend + kL;            // [1]  exp(cum_L)

  const int p0 = blockIdx.x * kPS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const float a_h = expf(a_log[h]);
  const float d_h = dvec[h];
  const float bias_h = dt_bias[h];

  for (int i = tid; i < N * kPS; i += kThreads) hs[i] = 0.f;

  const size_t x_row = static_cast<size_t>(nh) * P;
  const T* xb = x + static_cast<size_t>(b) * S * x_row + static_cast<size_t>(h) * P + p0;
  T* yb = y + static_cast<size_t>(b) * S * x_row + static_cast<size_t>(h) * P + p0;
  const T* bb = bmat + static_cast<size_t>(b) * S * N;
  const T* cb = cmat + static_cast<size_t>(b) * S * N;
  const T* db = dt + static_cast<size_t>(b) * S * nh + h;
  const int prows = min(kPS, P - p0);

  // thread roles: G rows gi0 + 16a, keys gj0 + 8c; y row yi, p yp..yp+3;
  // state p sp, sp+1 at n = sn0 + 16k
  const int gi0 = tid >> 3, gj0 = tid & 7;
  const int yi = tid >> 2, yp = (tid & 3) * 4;
  const int sp = (tid & 7) * 2, sn0 = tid >> 3;

  for (int t0 = 0; t0 < S; t0 += kL) {
    __syncthreads();  // the previous sub-chunk's tiles and state are consumed
    for (int i = tid; i < 2 * kL * (N / 8); i += kThreads) {
      const int which = i / (kL * (N / 8));
      const int r = (i / (N / 8)) % kL;
      const int c = (i % (N / 8)) * 8;
      float v[8];
      if (t0 + r < S) {
        load8((which ? cb : bb) + static_cast<size_t>(t0 + r) * N + c, v);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = 0.f;
      }
      float* o = (which ? cs : bs) + r * kNS + c;
#pragma unroll
      for (int e = 0; e < 8; ++e) o[e] = v[e];
    }
    for (int i = tid; i < kL * kPS; i += kThreads) {
      const int r = i / kPS, c = i % kPS;
      xr[i] = (t0 + r < S && c < prows)
                  ? to_f32(xb[static_cast<size_t>(t0 + r) * x_row + c]) : 0.f;
    }
    if (tid < kL) {             // warp 0: dtv, log-decay and its prefix sum
      const bool live = t0 + tid < S;
      const float dv = live ? softplus(to_f32(db[static_cast<size_t>(t0 + tid) * nh]) + bias_h)
                            : 0.f;
      float cum = -dv * a_h;
#pragma unroll
      for (int o = 1; o < kL; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, cum, o);
        if (tid >= o) cum += u;
      }
      const float last = __shfl_sync(0xffffffffu, cum, kL - 1);
      dtv_s[tid] = dv;
      ecum[tid] = expf(cum);
      wend[tid] = expf(last - cum);
      // keep cum itself for G: exp(cum_i - cum_j) from the two logs, not a
      // ratio of exps (which could underflow to 0/0)
      gs[tid * (kL + 1) + kL] = cum;
      if (tid == 0) tot[0] = expf(last);
    }
    __syncthreads();

    for (int i = tid; i < kL * kPS; i += kThreads) xs[i] = xr[i] * dtv_s[i / kPS];
    {
      float acc[2][4];
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; n += 4) {
        float4 cv[2], bv[4];
#pragma unroll
        for (int a = 0; a < 2; ++a)
          cv[a] = *reinterpret_cast<const float4*>(cs + (gi0 + 16 * a) * kNS + n);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          bv[c] = *reinterpret_cast<const float4*>(bs + (gj0 + 8 * c) * kNS + n);
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            float s = acc[a][c];
            s = fmaf(cv[a].x, bv[c].x, s);
            s = fmaf(cv[a].y, bv[c].y, s);
            s = fmaf(cv[a].z, bv[c].z, s);
            s = fmaf(cv[a].w, bv[c].w, s);
            acc[a][c] = s;
          }
      }
      float g[2][4];
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int i = gi0 + 16 * a;
        const float cum_i = gs[i * (kL + 1) + kL];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = gj0 + 8 * c;
          g[a][c] = j <= i ? acc[a][c] * expf(cum_i - gs[j * (kL + 1) + kL]) : 0.f;
        }
      }
      __syncthreads();   // every thread has read the cum column of gs
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          gs[(gi0 + 16 * a) * (kL + 1) + gj0 + 8 * c] = g[a][c];
    }
    __syncthreads();

    // y rows of this sub-chunk: intra-chunk + carried state + D x
    {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int j = 0; j <= yi; ++j) {
        const float gv = gs[yi * (kL + 1) + j];
        const float4 xv = *reinterpret_cast<const float4*>(xs + j * kPS + yp);
        acc[0] = fmaf(gv, xv.x, acc[0]);
        acc[1] = fmaf(gv, xv.y, acc[1]);
        acc[2] = fmaf(gv, xv.z, acc[2]);
        acc[3] = fmaf(gv, xv.w, acc[3]);
      }
      float car[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int n = 0; n < N; n += 4) {
        const float4 cv = *reinterpret_cast<const float4*>(cs + yi * kNS + n);
        const float cn[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float4 hv = *reinterpret_cast<const float4*>(hs + (n + e) * kPS + yp);
          car[0] = fmaf(cn[e], hv.x, car[0]);
          car[1] = fmaf(cn[e], hv.y, car[1]);
          car[2] = fmaf(cn[e], hv.z, car[2]);
          car[3] = fmaf(cn[e], hv.w, car[3]);
        }
      }
      const float ec = ecum[yi];
      if (t0 + yi < S) {
        T* row = yb + static_cast<size_t>(t0 + yi) * x_row;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (yp + e < prows)
            store(row + yp + e, acc[e] + ec * car[e] + d_h * xr[yi * kPS + yp + e]);
      }
    }
    __syncthreads();   // y has read the old state

    // H <- exp(cum_L) H + sum_j exp(cum_L - cum_j) (dtv_j x_j) B_j^T
    {
      float acc[kNG][2];
#pragma unroll
      for (int k = 0; k < kNG; ++k) acc[k][0] = acc[k][1] = 0.f;
      for (int j = 0; j < kL; ++j) {
        const float w = wend[j];
        const float2 xv = *reinterpret_cast<const float2*>(xs + j * kPS + sp);
        const float x0 = w * xv.x, x1 = w * xv.y;
#pragma unroll
        for (int k = 0; k < kNG; ++k) {
          const float bv = bs[j * kNS + sn0 + 16 * k];
          acc[k][0] = fmaf(x0, bv, acc[k][0]);
          acc[k][1] = fmaf(x1, bv, acc[k][1]);
        }
      }
      const float tt = tot[0];
#pragma unroll
      for (int k = 0; k < kNG; ++k) {
        float* hrow = hs + (sn0 + 16 * k) * kPS + sp;
        hrow[0] = fmaf(tt, hrow[0], acc[k][0]);
        hrow[1] = fmaf(tt, hrow[1], acc[k][1]);
      }
    }
  }
}

template <typename T, int N>
int launch(const void* x, const void* bm, const void* cm, const void* dt,
           const void* a_log, const void* d, const void* dt_bias, void* y, int B,
           int S, int nh, int P, cudaStream_t stream) {
  const size_t smem = smem_floats<N>() * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_scan_kernel<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((P + kPS - 1) / kPS, nh, B);
  ssd_scan_kernel<T, N><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(bm), static_cast<const T*>(cm),
      static_cast<const T*>(dt), static_cast<const float*>(a_log),
      static_cast<const float*>(d), static_cast<const float*>(dt_bias),
      static_cast<T*>(y), S, nh, P);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_n(const void* x, const void* bm, const void* cm, const void* dt,
             const void* a_log, const void* d, const void* dt_bias, void* y, int B,
             int S, int nh, int P, int N, cudaStream_t s) {
  switch (N) {
    case 64: return launch<T, 64>(x, bm, cm, dt, a_log, d, dt_bias, y, B, S, nh, P, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, bmat, cmat, dt and y); N = 64
// (zamba2's).  Returns the cudaError_t of the launch.
extern "C" int ssd_scan_launch(const void* x, const void* bmat, const void* cmat,
                               const void* dt, const void* a_log, const void* d,
                               const void* dt_bias, void* y, int B, int S, int nh,
                               int P, int N, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || nh <= 0 || P <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_n<float>(x, bmat, cmat, dt, a_log, d, dt_bias, y, B, S, nh, P, N, s);
  if (dtype == 1)
    return launch_n<__nv_bfloat16>(x, bmat, cmat, dt, a_log, d, dt_bias, y, B, S, nh, P,
                                   N, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
