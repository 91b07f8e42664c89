// K6: the selective scan (forward) of Mamba-1 and Mamba-2 for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel _scan_kernel of
// src/repro/kernels/selective_scan.py (called through selective_scan):
//   h_t = exp(dt_t * A) (.) h_{t-1} + (dt_t * x_t) (x) B_t,   h_0 = 0
//   y_t = sum_N h_t (.) C_t
// with dt/x (B, S, D) in f32 or bf16, B/C (B, S, N) and A (D, N) in f32, y
// (B, S, D) in x's dtype.  A may also be (D,), one decay per channel: the
// per-channel form Mamba-2 takes (its per-head decay repeated over the
// head's channels, the same for all N states; the TPU kernel takes it as
// a (D, N) broadcast).  Unlike the TPU kernel, which keeps the last
// state in its scratch and drops it, this kernel also writes the final
// state h_S (B, D, N) in f32: prefill hands it to the decode cache.
//
// Design.  Blocks over (tile of 64 channels, batch); the sequence loop
// runs inside the block (the TPU kernel relied on its sequence grid axis
// running in order, which CUDA blocks do not).  One thread per (b, d)
// channel holds all N of its states in registers for the whole sequence,
// so the (D, N) state never leaves the chip and device-memory traffic
// stays O(B * S * (D + N)), and the per-step work of a channel (its dt and
// x, dx = dt * x, y's sum over N, the store of y) is paid once per N
// states.  (Two threads per channel, N / 2 states each and one shuffle for
// y, gave twice the warps but ran 25 % slower at falcon-mamba-7b's
// prefill.)  Neighbouring threads hold neighbouring channels, so the
// dt/x reads and y writes of a step are coalesced rows of the (B, S, D)
// layout.  dt and x (the block's channels) and B_t, C_t (shared by every
// channel of a (b, t)) come through a two-stage ring of 32-step chunks in
// shared memory, filled with 16-byte cp.async copies: chunk c + 1 is in
// flight while chunk c is walked, one barrier per chunk.  B_t and C_t are
// read as float4 broadcasts.  The step loop is unrolled by 4, so the exps
// of later steps, which do not depend on the state, overlap the updates
// of earlier ones.  The copies need D a multiple of 16 bytes of dt/x and
// 16-byte aligned tensors; otherwise (vec = 0) the same kernel stages
// element by element.  D and S may be ragged; N is 8 or 16 for a (D, N)
// decay.
//
// Per-channel form (scan_pc_kernel, N 16 or 64).  A step takes one exp
// for the channel, bitwise the value the (D, N) form takes N times over,
// so h_S stays equal to the plain version's.  At N = 64 one thread per
// channel holds 64 states and the 64 products of y's tree, with one warp
// per SM sub-partition at zamba2's prefill; four lanes per channel in one
// warp read B_t / C_t at four addresses per 16-byte load, four shared
// memory wavefronts where a broadcast takes one.  Both ran slower than
// this design on an H100 at that prefill.  Here a block of 64 channels
// has G = 4 state groups of 64 threads: thread (j, channel) holds states
// j, j + 4, ..., 16 at N = 64, so each warp is one group and its B_t /
// C_t reads are broadcasts from a group-major copy in shared memory
// (filled with 4-byte cp.async copies), and there are four times the
// warps.  y's
// halving tree keeps its order: the levels at offsets N/2 .. 4 pair
// states of one thread; each group's partial goes to shared memory and,
// once a chunk is done, the last two levels ((p0 + p2) + (p1 + p3)) run
// with the store of the chunk's rows of y.  Bound at zamba2-1.2b's
// prefill (B 4, S 512, D 4096, N 64, f32 dt/x/y): ~30 MB (dt, x, y
// 8.4 MB each; B, C, A and h_S ~5.3 MB), ~9 us at 3.35 TB/s; its 5 FLOPs
// per state-step are 2.7e9 on the f32 pipes, ~40 us at 67 TFLOP/s, so
// the bound is the operations (and, with no FMA to fuse them, ~80 us of
// issue on 132 SMs).
//
// Arithmetic.  The decay is expf(__fmul_rn(dt, a)), the function
// torch.exp computes on the card; the recurrence rounds each product and
// sum on its own (no FMA contraction), as PyTorch's elementwise ops do, so
// the final state h_S equals the plain version's bit for bit.  y's sum
// over N takes the halving tree that torch.sum's warp reduction takes
// over a last axis of 8, 16 or 64, each product rounded before it is added,
// so y equals the plain version's bit for bit too.  A faster exp
// (ex2.approx of a pre-scaled argument) or a contracted update would drift
// from the plain version by an ulp a step over long sequences.
//
// Bound on an H100.  At falcon-mamba-7b's prefill (B 4, S 512, D 8192,
// N 16, f32 dt/x/y) the function moves ~204 MB (dt, x, y: 67 MB each; B,
// C, A and h_S ~3 MB): ~61 us at 3.35 TB/s.  It also takes one exp per
// (b, t, d, n), 2.7e8 in all; the SFU computes 16 exp2 per clock per SM
// (CUDA C Programming Guide, throughput table, cc 9.0), about 4.2e12/s at
// 1.98 GHz on 132 SMs: ~64 us on the SFU alone.  A share of the exps could
// run as polynomial code on the FP32 pipes, which the recurrence's ~1.3
// GFLOP leaves mostly idle, so the bound is the bytes, ~61 us.  The
// kernel keeps every exp on the SFU: expf is one MUFU.EX2 plus about six
// FP32 and integer instructions of range reduction, so with the update and
// y's tree a state-step issues about 13 instructions, ~105 us of issue for
// 132 SMs at 1.98 GHz.  One thread per channel gives only 32,768 threads
// at this shape, about 8 warps per SM, so latency is hidden by the 16
// independent states of a step and the 4 unrolled steps, not by warps.
//
// C interface (loaded with ctypes): pointers and the stream as void*; the
// launcher returns cudaGetLastError() as an int (or cudaErrorInvalidValue
// for a shape it does not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int CPB = 64;  // channels per block
constexpr int TC = 32;   // steps per chunk

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16-byte copy; src_bytes 0 fills the 16 bytes with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Sum of p[0, M) by halving: p[i] += p[i + M / 2], then the same over the
// first half, down to p[0]; each sum rounded on its own.  (torch.sum
// over a last axis of 8 or 16 on the card: a warp reduction with
// shuffle-down offsets 8, 4, 2, 1; over 64, each of 32 lanes adds p[i]
// and p[i + 32] first.)
template <int W, int M>
__device__ __forceinline__ void halve(float (&p)[M]) {
#pragma unroll
  for (int i = 0; i < W; ++i) p[i] = __fadd_rn(p[i], p[i + W]);
  if constexpr (W > 1) halve<W / 2>(p);
}
template <int M>
__device__ __forceinline__ float tree_sum(float (&p)[M]) {
  if constexpr (M > 1) halve<M / 2>(p);
  return p[0];
}

// One stage of the ring: a chunk of TC steps.
template <typename T, int N>
struct Stage {
  T dt[TC][CPB];
  T x[TC][CPB];
  float4 b[TC][N / 4];
  float4 c[TC][N / 4];
};

// Steps [t0, t0 + TC) of the block's channels [d0, d0 + CPB) and of B/C
// into a stage; 0 past S and past D.
template <typename T, int N, int THREADS>
__device__ __forceinline__ void load_chunk(Stage<T, N>& st,
                                           const T* __restrict__ dt,
                                           const T* __restrict__ x,
                                           const float* __restrict__ bm,
                                           const float* __restrict__ cm,
                                           long long row0, int t0, int d0,
                                           int S, int D, bool vec) {
  constexpr int E = 16 / sizeof(T);  // elements per 16-byte copy
  constexpr int RC = CPB / E;        // copies per step row of dt or x
  if (vec) {
#pragma unroll
    for (int it = 0; it < TC * RC / THREADS; ++it) {
      const int i = threadIdx.x + it * THREADS;
      const int tt = i / RC, cc = (i % RC) * E;
      const bool ok = t0 + tt < S && d0 + cc < D;
      const long long off = ok ? (row0 + t0 + tt) * D + d0 + cc : 0;
      cp_async16(&st.dt[tt][cc], dt + off, ok ? 16 : 0);
      cp_async16(&st.x[tt][cc], x + off, ok ? 16 : 0);
    }
    for (int i = threadIdx.x; i < TC * N / 4; i += THREADS) {
      const int tt = i / (N / 4), q = i % (N / 4);
      const bool ok = t0 + tt < S;
      const long long off = ok ? (row0 + t0 + tt) * N + 4 * q : 0;
      cp_async16(&st.b[tt][q], bm + off, ok ? 16 : 0);
      cp_async16(&st.c[tt][q], cm + off, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < TC * CPB; i += THREADS) {
      const int tt = i / CPB, cc = i % CPB;
      const bool ok = t0 + tt < S && d0 + cc < D;
      const long long off = (row0 + t0 + tt) * D + d0 + cc;
      store(&st.dt[tt][cc], ok ? to_f32(dt[off]) : 0.f);
      store(&st.x[tt][cc], ok ? to_f32(x[off]) : 0.f);
    }
    float* b_s = &st.b[0][0].x;
    float* c_s = &st.c[0][0].x;
    for (int i = threadIdx.x; i < TC * N; i += THREADS) {
      const int tt = i / N, nn = i % N;
      const bool ok = t0 + tt < S;
      const long long off = (row0 + t0 + tt) * N + nn;
      b_s[tt * N + nn] = ok ? bm[off] : 0.f;
      c_s[tt * N + nn] = ok ? cm[off] : 0.f;
    }
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(CPB)
    scan_kernel(const T* __restrict__ dt, const T* __restrict__ x,
                const float* __restrict__ bm, const float* __restrict__ cm,
                const float* __restrict__ a, T* __restrict__ y,
                float* __restrict__ h_last, int S, int D, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Stage<T, N>* ring = reinterpret_cast<Stage<T, N>*>(smem_raw);

  const int cl = threadIdx.x;  // this thread's channel in the tile
  const int d0 = blockIdx.x * CPB;
  const int d = d0 + cl;
  const int b = blockIdx.y;
  const long long row0 = (long long)b * S;  // first (b, t) row

  float av[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    av[n] = d < D ? a[(long long)d * N + n] : 0.f;
    h[n] = 0.f;
  }

  const int nc = (S + TC - 1) / TC;
  load_chunk<T, N, CPB>(ring[0], dt, x, bm, cm, row0, 0, d0, S, D, vec);
  cp_async_commit();
  for (int ci = 0; ci < nc; ++ci) {
    const int t0 = ci * TC;
    cp_async_wait_all();
    __syncthreads();  // chunk ci landed; chunk ci - 1's stage is free
    if (ci + 1 < nc)
      load_chunk<T, N, CPB>(ring[(ci + 1) & 1], dt, x, bm, cm, row0, t0 + TC,
                            d0, S, D, vec);
    cp_async_commit();
    const Stage<T, N>& st = ring[ci & 1];
    const int tc = min(TC, S - t0);
    T* yrow = y + (row0 + t0) * D + d;
#pragma unroll 4
    for (int tt = 0; tt < tc; ++tt) {
      const float dtv = to_f32(st.dt[tt][cl]);
      const float dx = __fmul_rn(dtv, to_f32(st.x[tt][cl]));
      float bb[N], cc[N];
#pragma unroll
      for (int q = 0; q < N / 4; ++q) {
        const float4 bq = st.b[tt][q], cq = st.c[tt][q];
        bb[4 * q] = bq.x, bb[4 * q + 1] = bq.y;
        bb[4 * q + 2] = bq.z, bb[4 * q + 3] = bq.w;
        cc[4 * q] = cq.x, cc[4 * q + 1] = cq.y;
        cc[4 * q + 2] = cq.z, cc[4 * q + 3] = cq.w;
      }
      float hc[N];
#pragma unroll
      for (int n = 0; n < N; ++n) {
        // each product and sum rounded on its own, in the plain
        // version's order
        const float da = expf(__fmul_rn(dtv, av[n]));
        h[n] = __fadd_rn(__fmul_rn(da, h[n]), __fmul_rn(dx, bb[n]));
        hc[n] = __fmul_rn(h[n], cc[n]);
      }
      // y: the halving tree over N that torch.sum's warp reduction takes
      const float yv = tree_sum<N>(hc);
      if (d < D) store(yrow + (long long)tt * D, yv);
    }
  }
  if (d < D) {
    float4* hl =
        reinterpret_cast<float4*>(h_last + ((long long)b * D + d) * N);
#pragma unroll
    for (int q = 0; q < N / 4; ++q)
      hl[q] = make_float4(h[4 * q], h[4 * q + 1], h[4 * q + 2], h[4 * q + 3]);
  }
}

template <typename T, int N>
int launch(const void* dt, const void* x, const void* bm, const void* cm,
           const void* a, void* y, void* h_last, int B, int S, int D,
           int vec, cudaStream_t stream) {
  constexpr size_t smem = 2 * sizeof(Stage<T, N>);
  cudaError_t err = cudaFuncSetAttribute(
      scan_kernel<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((D + CPB - 1) / CPB, B);
  scan_kernel<T, N><<<grid, CPB, smem, stream>>>(
      static_cast<const T*>(dt), static_cast<const T*>(x),
      static_cast<const float*>(bm), static_cast<const float*>(cm),
      static_cast<const float*>(a), static_cast<T*>(y),
      static_cast<float*>(h_last), S, D, vec);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Per-channel form (Mamba-2): a is (D,), G state groups per channel
// ---------------------------------------------------------------------------

constexpr int G = 4;  // state groups: group j holds states j, j + G, ...

// One stage of the per-channel ring: dt and x as in Stage; B_t and C_t
// group-major, row [tt][j] holding states j, j + G, ... of step tt.
template <typename T, int N>
struct StagePC {
  T dt[TC][CPB];
  T x[TC][CPB];
  float4 b[TC][G][N / G / 4];
  float4 c[TC][G][N / G / 4];
};

// 4-byte copy; src_bytes 0 fills with zero
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

template <typename T, int N>
__device__ __forceinline__ void load_chunk_pc(StagePC<T, N>& st,
                                              const T* __restrict__ dt,
                                              const T* __restrict__ x,
                                              const float* __restrict__ bm,
                                              const float* __restrict__ cm,
                                              long long row0, int t0, int d0,
                                              int S, int D, bool vec) {
  constexpr int THREADS = CPB * G;
  constexpr int E = 16 / sizeof(T);
  constexpr int RC = CPB / E;
  if (vec) {
#pragma unroll
    for (int it = 0; it < TC * RC / THREADS; ++it) {
      const int i = threadIdx.x + it * THREADS;
      const int tt = i / RC, cc = (i % RC) * E;
      const bool ok = t0 + tt < S && d0 + cc < D;
      const long long off = ok ? (row0 + t0 + tt) * D + d0 + cc : 0;
      cp_async16(&st.dt[tt][cc], dt + off, ok ? 16 : 0);
      cp_async16(&st.x[tt][cc], x + off, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < TC * CPB; i += THREADS) {
      const int tt = i / CPB, cc = i % CPB;
      const bool ok = t0 + tt < S && d0 + cc < D;
      const long long off = (row0 + t0 + tt) * D + d0 + cc;
      store(&st.dt[tt][cc], ok ? to_f32(dt[off]) : 0.f);
      store(&st.x[tt][cc], ok ? to_f32(x[off]) : 0.f);
    }
  }
  // state n = j + G * q of step tt goes to row [tt][j], column q
  float* b_s = &st.b[0][0][0].x;
  float* c_s = &st.c[0][0][0].x;
  for (int i = threadIdx.x; i < TC * N; i += THREADS) {
    const int tt = i / N, n = i % N;
    const bool ok = t0 + tt < S;
    const long long off = ok ? (row0 + t0 + tt) * N + n : 0;
    const int at = (tt * G + n % G) * (N / G) + n / G;
    cp_async4(b_s + at, bm + off, ok ? 4 : 0);
    cp_async4(c_s + at, cm + off, ok ? 4 : 0);
  }
}

// Threads: channel cl = threadIdx.x % CPB (neighbouring lanes hold
// neighbouring channels, so dt / x reads are rows), group j =
// threadIdx.x / CPB (the same for a whole warp, so B_t / C_t reads are
// broadcasts).
template <typename T, int N>
__global__ void __launch_bounds__(CPB * G)
    scan_pc_kernel(const T* __restrict__ dt, const T* __restrict__ x,
                   const float* __restrict__ bm, const float* __restrict__ cm,
                   const float* __restrict__ a, T* __restrict__ y,
                   float* __restrict__ h_last, int S, int D, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  StagePC<T, N>* ring = reinterpret_cast<StagePC<T, N>*>(smem_raw);
  // each group's partial of y's tree for a chunk: [tt][j][channel]
  float* part = reinterpret_cast<float*>(ring + 2);
  constexpr int M = N / G;  // states per thread
  const int cl = threadIdx.x % CPB;
  const int j = threadIdx.x / CPB;
  const int d0 = blockIdx.x * CPB;
  const int d = d0 + cl;
  const int b = blockIdx.y;
  const long long row0 = (long long)b * S;
  const float av = d < D ? a[d] : 0.f;
  float h[M];
#pragma unroll
  for (int q = 0; q < M; ++q) h[q] = 0.f;

  const int nc = (S + TC - 1) / TC;
  load_chunk_pc<T, N>(ring[0], dt, x, bm, cm, row0, 0, d0, S, D, vec);
  cp_async_commit();
  for (int ci = 0; ci < nc; ++ci) {
    const int t0 = ci * TC;
    cp_async_wait_all();
    __syncthreads();  // chunk ci landed; chunk ci - 1's stage and the
                      // partials are free
    if (ci + 1 < nc)
      load_chunk_pc<T, N>(ring[(ci + 1) & 1], dt, x, bm, cm, row0, t0 + TC,
                          d0, S, D, vec);
    cp_async_commit();
    const StagePC<T, N>& st = ring[ci & 1];
    const int tc = min(TC, S - t0);
#pragma unroll 2
    for (int tt = 0; tt < tc; ++tt) {
      const float dtv = to_f32(st.dt[tt][cl]);
      const float dx = __fmul_rn(dtv, to_f32(st.x[tt][cl]));
      const float da = expf(__fmul_rn(dtv, av));
      float hc[M];
#pragma unroll
      for (int q4 = 0; q4 < M / 4; ++q4) {
        const float4 b4 = st.b[tt][j][q4], c4 = st.c[tt][j][q4];
        const float bb[4] = {b4.x, b4.y, b4.z, b4.w};
        const float cc[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int q = 4 * q4 + r;
          h[q] = __fadd_rn(__fmul_rn(da, h[q]), __fmul_rn(dx, bb[r]));
          hc[q] = __fmul_rn(h[q], cc[r]);
        }
      }
      // y's halving tree over N: offsets N/2 .. G pair states of this
      // group (q and q + M/2, ...)
      part[(tt * G + j) * CPB + cl] = tree_sum<M>(hc);
    }
    __syncthreads();
    // the tree's last levels, offsets 2 and 1 over the groups: y =
    // (p0 + p2) + (p1 + p3); then the chunk's rows of y
    for (int i = threadIdx.x; i < tc * CPB; i += CPB * G) {
      const int tt = i / CPB, c = i % CPB;
      const float* p = part + tt * G * CPB + c;
      const float yv = __fadd_rn(__fadd_rn(p[0], p[2 * CPB]),
                                 __fadd_rn(p[CPB], p[3 * CPB]));
      if (d0 + c < D) store(y + (row0 + t0 + tt) * D + d0 + c, yv);
    }
  }
  if (d < D) {
    float* hl = h_last + ((long long)b * D + d) * N + j;
#pragma unroll
    for (int q = 0; q < M; ++q) hl[G * q] = h[q];
  }
}

template <typename T, int N>
int launch_pc(const void* dt, const void* x, const void* bm, const void* cm,
              const void* a, void* y, void* h_last, int B, int S, int D,
              int vec, cudaStream_t stream) {
  constexpr size_t smem =
      2 * sizeof(StagePC<T, N>) + sizeof(float) * TC * G * CPB;
  cudaError_t err = cudaFuncSetAttribute(
      scan_pc_kernel<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((D + CPB - 1) / CPB, B);
  scan_pc_kernel<T, N><<<grid, CPB * G, smem, stream>>>(
      static_cast<const T*>(dt), static_cast<const T*>(x),
      static_cast<const float*>(bm), static_cast<const float*>(cm),
      static_cast<const float*>(a), static_cast<T*>(y),
      static_cast<float*>(h_last), S, D, vec);
  return (int)cudaGetLastError();
}

// the instantiated (N, form) pairs: (D, N) decays at N 8 and 16 (Mamba-1),
// per-channel decays at N 16 and 64 (Mamba-2)
template <typename T>
int dispatch(const void* dt, const void* x, const void* bm, const void* cm,
             const void* a, void* y, void* h_last, int B, int S, int D,
             int N, int per_channel, int vec, cudaStream_t st) {
  if (!per_channel && N == 8)
    return launch<T, 8>(dt, x, bm, cm, a, y, h_last, B, S, D, vec, st);
  if (!per_channel && N == 16)
    return launch<T, 16>(dt, x, bm, cm, a, y, h_last, B, S, D, vec, st);
  if (per_channel && N == 16)
    return launch_pc<T, 16>(dt, x, bm, cm, a, y, h_last, B, S, D, vec, st);
  if (per_channel && N == 64)
    return launch_pc<T, 64>(dt, x, bm, cm, a, y, h_last, B, S, D, vec, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (dt, x and y share it).  per_channel:
// 1 = a is (D,), one decay per channel; 0 = a is (D, N).  vec: 1 = 16-byte
// cp.async copies of dt and x, which need D * sizeof(dtype) % 16 == 0 and
// 16-byte aligned tensors; 0 = element-wise staging in the same kernel.
extern "C" int selective_scan_launch(const void* dt, const void* x,
                                     const void* bm, const void* cm,
                                     const void* a, void* y, void* h_last,
                                     int dtype, int B, int S, int D, int N,
                                     int per_channel, int vec, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || D < 1 || (dtype != 0 && dtype != 1) ||
      (vec && D % (dtype == 0 ? 4 : 8)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(dt, x, bm, cm, a, y, h_last, B, S, D, N,
                           per_channel, vec, st);
  return dispatch<__nv_bfloat16>(dt, x, bm, cm, a, y, h_last, B, S, D, N,
                                 per_channel, vec, st);
}
