// K6: the Mamba-1 selective scan (forward) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _scan_kernel of
// src/repro/kernels/selective_scan.py (called through selective_scan):
//   h_t = exp(dt_t * A) (.) h_{t-1} + (dt_t * x_t) (x) B_t,   h_0 = 0
//   y_t = sum_N h_t (.) C_t
// with dt/x (B, S, D) in f32 or bf16, B/C (B, S, N) and A (D, N) in f32, y
// (B, S, D) in x's dtype.  Unlike the TPU kernel, which keeps the last
// state in its scratch and drops it, this kernel also writes the final
// state h_S (B, D, N) in f32: prefill hands it to the decode cache.
//
// Design.  Blocks over (channel tile, batch); the sequence loop runs inside
// the block (the TPU kernel relied on its sequence grid axis running in
// order, which CUDA blocks do not).  Each thread owns 4 of a channel's N
// states in registers for the whole sequence, N / 4 neighbouring lanes
// share a channel and add their parts of y_t with warp shuffles, so the
// (D, N) state never leaves the chip and device-memory traffic stays
// O(B * S * (D + N)).  Per chunk of 32 steps the block stages dt, x (its
// channels) and B_t, C_t (shared by all channels) in shared memory with
// coalesced loads, walks the chunk, and writes the chunk's y back
// coalesced.  D and S may be ragged.  N is 8 or 16.  The recurrence rounds
// each product and sum on its own (no FMA contraction), as PyTorch's
// elementwise ops do, so over hundreds of steps the state tracks the plain
// version's instead of drifting by an ulp a step; only y's sum over N
// runs in another order.
//
// Bound on an H100.  At falcon-mamba-7b's prefill (B 4, S 512, D 8192,
// N 16, f32 dt/x/y) the function moves ~204 MB (dt, x, y: 67 MB each; B,
// C, A and h_S ~3 MB): ~61 us at 3.35 TB/s.  It also takes one exp per
// (b, t, d, n), 2.7e8 in all; the SFU computes 16 exp2 per clock per SM
// (CUDA C Programming Guide, throughput table, cc 9.0), about 4.2e12/s at
// 1.98 GHz on 132 SMs: ~64 us on the SFU alone.  A share of the exps could
// run as polynomial code on the FP32 pipes, which the recurrence's ~1.3
// GFLOP leaves mostly idle, so the operations need less than the bytes:
// the bound is the bytes, ~61 us.  The design reads each input once and
// keeps every exp on the SFU (expf = one ex2.approx plus range FMAs), so
// it cannot go below ~64 us; splitting the exps is left for later.
//
// C interface (loaded with ctypes): pointers and the stream as void*; the
// launcher returns cudaGetLastError() as an int (or cudaErrorInvalidValue
// for a shape it does not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int NPT = 4;  // states per thread
constexpr int TC = 32;  // steps staged per chunk

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, int N>
__global__ void __launch_bounds__(THREADS)
    scan_kernel(const T* __restrict__ dt, const T* __restrict__ x,
                const float* __restrict__ bm, const float* __restrict__ cm,
                const float* __restrict__ a, T* __restrict__ y,
                float* __restrict__ h_last, int S, int D) {
  constexpr int LPC = N / NPT;         // lanes per channel
  constexpr int CPB = THREADS / LPC;   // channels per block
  __shared__ float dt_s[TC][CPB];
  __shared__ float x_s[TC][CPB];
  __shared__ float y_s[TC][CPB];
  __shared__ float b_s[TC][N];
  __shared__ float c_s[TC][N];

  const int tid = threadIdx.x;
  const int cl = tid / LPC, part = tid % LPC;
  const int d0 = blockIdx.x * CPB;
  const int d = d0 + cl;
  const int b = blockIdx.y;
  const long long row0 = (long long)b * S;  // first (b, t) row

  float av[NPT], h[NPT];
#pragma unroll
  for (int n = 0; n < NPT; ++n) {
    av[n] = d < D ? a[(long long)d * N + part * NPT + n] : 0.f;
    h[n] = 0.f;
  }

  for (int t0 = 0; t0 < S; t0 += TC) {
    const int tc = min(TC, S - t0);
    __syncthreads();  // the previous chunk's y_s is written out
    for (int i = tid; i < TC * CPB; i += THREADS) {
      const int tt = i / CPB, cc = i % CPB;
      const bool ok = tt < tc && d0 + cc < D;
      const long long off = (row0 + t0 + tt) * D + d0 + cc;
      dt_s[tt][cc] = ok ? to_f32(dt[off]) : 0.f;
      x_s[tt][cc] = ok ? to_f32(x[off]) : 0.f;
    }
    for (int i = tid; i < TC * N; i += THREADS) {
      const int tt = i / N, nn = i % N;
      const bool ok = tt < tc;
      const long long off = (row0 + t0 + tt) * N + nn;
      b_s[tt][nn] = ok ? bm[off] : 0.f;
      c_s[tt][nn] = ok ? cm[off] : 0.f;
    }
    __syncthreads();
    for (int tt = 0; tt < tc; ++tt) {
      const float dtv = dt_s[tt][cl];
      const float dx = __fmul_rn(dtv, x_s[tt][cl]);
      float ys = 0.f;
#pragma unroll
      for (int n = 0; n < NPT; ++n) {
        const int nn = part * NPT + n;
        // each product and sum rounded on its own, in the plain
        // version's order
        const float da = expf(__fmul_rn(dtv, av[n]));
        h[n] = __fadd_rn(__fmul_rn(da, h[n]), __fmul_rn(dx, b_s[tt][nn]));
        ys += h[n] * c_s[tt][nn];
      }
#pragma unroll
      for (int off = 1; off < LPC; off <<= 1)
        ys += __shfl_xor_sync(0xffffffffu, ys, off);
      if (part == 0) y_s[tt][cl] = ys;
    }
    __syncthreads();
    for (int i = tid; i < TC * CPB; i += THREADS) {
      const int tt = i / CPB, cc = i % CPB;
      if (tt < tc && d0 + cc < D)
        store(&y[(row0 + t0 + tt) * D + d0 + cc], y_s[tt][cc]);
    }
  }
  if (d < D) {
#pragma unroll
    for (int n = 0; n < NPT; ++n)
      h_last[((long long)b * D + d) * N + part * NPT + n] = h[n];
  }
}

template <typename T, int N>
int launch(const void* dt, const void* x, const void* bm, const void* cm,
           const void* a, void* y, void* h_last, int B, int S, int D,
           cudaStream_t stream) {
  constexpr int CPB = THREADS / (N / NPT);
  dim3 grid((D + CPB - 1) / CPB, B);
  scan_kernel<T, N><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(dt), static_cast<const T*>(x),
      static_cast<const float*>(bm), static_cast<const float*>(cm),
      static_cast<const float*>(a), static_cast<T*>(y),
      static_cast<float*>(h_last), S, D);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (dt, x and y share it).
extern "C" int selective_scan_launch(const void* dt, const void* x,
                                     const void* bm, const void* cm,
                                     const void* a, void* y, void* h_last,
                                     int dtype, int B, int S, int D, int N,
                                     void* stream) {
  if (B < 1 || B > 65535 || S < 1 || D < 1 || (N != 8 && N != 16) ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return N == 8 ? launch<float, 8>(dt, x, bm, cm, a, y, h_last, B, S, D, st)
                  : launch<float, 16>(dt, x, bm, cm, a, y, h_last, B, S, D,
                                      st);
  return N == 8
             ? launch<__nv_bfloat16, 8>(dt, x, bm, cm, a, y, h_last, B, S, D,
                                        st)
             : launch<__nv_bfloat16, 16>(dt, x, bm, cm, a, y, h_last, B, S,
                                         D, st);
}
