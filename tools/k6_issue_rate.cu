// The arithmetic of one step of K6's per-head kernel (scan_head_kernel in
// src/repro_torch/kernels/csrc/selective_scan.cu), alone and from
// registers: K = 4 channels x M = 8 states a thread, each state updated
// as h = da * h + dx * b and read as h * c with every product and sum
// rounded on its own, y's halving tree over the thread's 8 states, and the
// thread's 4 partials stored to shared memory.  No operand is read from
// memory and no block synchronises, so its time is what the kernel's
// unfused f32 instruction stream costs at the kernel's thread shape.
// MODE 0: that step; MODE 1: the state updates alone (no y).
//
// C interface (loaded with ctypes): issue_rate_launch(mode, out, blocks,
// steps, stream) returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int K = 4, M = 8, THREADS = 128;

template <int W, int L>
__device__ __forceinline__ void halve(float (&p)[L]) {
#pragma unroll
  for (int i = 0; i < W; ++i) p[i] = __fadd_rn(p[i], p[i + W]);
  if constexpr (W > 1) halve<W / 2>(p);
}

template <int MODE>
__global__ void __launch_bounds__(THREADS, 2)
    step_kernel(float* out, int steps, float seed) {
  __shared__ float part[16][8][64];
  float h[K][M], b[M], c[M], da[K], dx[K];
#pragma unroll
  for (int q = 0; q < M; ++q) {
    b[q] = seed * (q + 1) + threadIdx.x;
    c[q] = seed * (q + 2);
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    da[k] = 0.9f + seed * (threadIdx.x + k);
    dx[k] = 0.5f + seed * k;
#pragma unroll
    for (int q = 0; q < M; ++q) h[k][q] = 0.f;
  }
  const int j = threadIdx.x / 16, c0 = 4 * (threadIdx.x % 16);
#pragma unroll 2
  for (int t = 0; t < steps; ++t) {
    // the step's decay and dt * x change from step to step
#pragma unroll
    for (int k = 0; k < K; ++k) {
      da[k] = __fmul_rn(da[k], 1.0000001f);
      dx[k] = __fmul_rn(dx[k], 0.9999999f);
    }
    float hc[K][M];
#pragma unroll
    for (int q = 0; q < M; ++q)
#pragma unroll
      for (int k = 0; k < K; ++k) {
        h[k][q] = __fadd_rn(__fmul_rn(da[k], h[k][q]),
                            __fmul_rn(dx[k], b[q]));
        if (MODE == 0) hc[k][q] = __fmul_rn(h[k][q], c[q]);
      }
    if (MODE == 0) {
#pragma unroll
      for (int k = 0; k < K; ++k) halve<M / 2>(hc[k]);
      *reinterpret_cast<float4*>(&part[t & 15][j][c0]) =
          make_float4(hc[0][0], hc[1][0], hc[2][0], hc[3][0]);
    }
  }
  float s = part[threadIdx.x % 16][j][c0];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int q = 0; q < M; ++q) s += h[k][q];
  out[blockIdx.x * THREADS + threadIdx.x] = s;
}

}  // namespace

extern "C" int issue_rate_launch(int mode, void* out, int blocks, int steps,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (mode == 0)
    step_kernel<0><<<blocks, THREADS, 0, st>>>(o, steps, 1e-3f);
  else
    step_kernel<1><<<blocks, THREADS, 0, st>>>(o, steps, 1e-3f);
  return (int)cudaGetLastError();
}
