// K6: the selective scan (forward) of Mamba-1 and Mamba-2 for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel _scan_kernel of
// src/repro/kernels/selective_scan.py (called through selective_scan):
//   h_t = exp(dt_t * A) (.) h_{t-1} + (dt_t * x_t) (x) B_t,   h_0 = 0
//   y_t = sum_N h_t (.) C_t
// with x (B, S, D) in f32 or bf16, B/C (B, S, N) in f32, y (B, S, D) in
// x's dtype, in two forms: dt (B, S, D) in x's dtype with A (D, N) f32
// (Mamba-1, scan_kernel), and dt (B, S, H) with A (H,) (Mamba-2's per-head
// form, scan_head_kernel): channel d takes the step and decay of head
// d / P, P = D / H, the same for all N states (the TPU kernel takes dt
// repeated over each head's channels and A broadcast to (D, N)).  Unlike
// the TPU kernel, which keeps the last state in its scratch and drops it,
// both also write the final state h_S (B, D, N) in f32: prefill hands it
// to the decode cache.
//
// (D, N) form.  Blocks over (tile of 64 channels, batch); the sequence
// loop runs inside the block (the TPU kernel relied on its sequence grid
// axis running in order, which CUDA blocks do not).  One thread per (b, d)
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
// element by element.  D and S may be ragged; N is 8 or 16.
//
// Bound of the (D, N) form on an H100.  At falcon-mamba-7b's prefill
// (B 4, S 512, D 8192, N 16, f32 dt/x/y) the function moves ~204 MB (dt,
// x, y: 67 MB each; B, C, A and h_S ~3 MB): ~61 us at 3.35 TB/s.  It also
// takes one exp per (b, t, d, n), 2.7e8 in all; the SFU computes 16 exp2
// per clock per SM (CUDA C Programming Guide, throughput table, cc 9.0),
// about 4.2e12/s at 1.98 GHz on 132 SMs: ~64 us on the SFU alone.  A share
// of the exps could run as polynomial code on the FP32 pipes, which the
// recurrence's ~1.3 GFLOP leaves mostly idle, so the bound is the bytes,
// ~61 us.  The kernel keeps every exp on the SFU: expf is one MUFU.EX2 plus
// about six FP32 and integer instructions of range reduction, so with the
// update and y's tree a state-step issues about 13 instructions, ~105 us
// of issue for 132 SMs at 1.98 GHz.
//
// Per-head form (scan_head_kernel, N 16 or 64).  A block takes a tile of
// 64 channels of one batch row; its threads hold K = 4 neighbouring
// channels and M states each (M = 8 at N = 64: states j, j + G, ... of
// G = N / M groups), so one read of B_t / C_t serves K channels and the
// lanes of a warp that share a group read one address.  Per chunk of 16
// steps, with dt of the tile's heads, x and the B / C rows staged by
// 16-byte cp.async copies one chunk ahead in a two-stage ring: one pass
// writes the group-major copy of B / C the steps read, exp(dt * a) once
// per (step, head) and dt * x once per (step, channel), so the step loop
// issues neither an exp nor the dt * x product; the steps write each
// group's partial of y's tree; at the next chunk's start the last levels
// of the tree run over the G partials and the chunk's rows of y are
// stored four channels at once.  Blocks of every second wave start with a
// half chunk, so that the chunk boundaries of the two blocks an SM holds
// do not coincide.
//
// Bound of the per-head form at zamba2-1.2b's prefill (B 4, S 512, H 64,
// P 64, N 64, f32): 72.9 MB (x, y 33.6 MB each; dt 0.5 MB; B, C 1.0 MB;
// h_S 4.2 MB), 21.75 us at 3.35 TB/s (dt repeated over the channels, as
// the per-channel call took it, made it 105.9 MB, 31.62 us); its 5 FLOPs
// per state-step are 2.7e9 on the f32 pipes, 40.06 us at 67 TFLOP/s, so
// the bound is the operations.
// Kept bitwise (below), they are 2.7e9 unfused instructions: ~80 us of
// issue on 132 SMs x 4 schedulers at 1.98 GHz.  Measured on an NVIDIA
// H100 80GB HBM3 at 700 W (chip_smoke.py phase 10, twice each in one
// run; PERF.md): this kernel 158.1-159.3 us against 182.3-182.8 us for
// the earlier per-channel kernel on dt repeated over each head's
// channels.  The step's arithmetic alone, from registers, at this
// kernel's thread shape (tools/k6_issue_rate.py, the same run) takes
// 108.0 us: issued at 0.74 instructions per scheduler and clock, the
// unfused stream does not reach the 80 us floor, and the steps'
// shared-memory reads and the chunk boundaries add the rest.  Designs
// measured on the same card and left, each slower than this one: one
// channel a thread with its groups as the lanes of a warp and y's tree
// ended with shuffles (a B_t / C_t read then serves 4 channels, not 32,
// and shared memory becomes the bound); one channel a thread with a warp
// per group; a producer / consumer split of the warps with named
// barriers; 2 channels a thread, or 16 states (one warp a scheduler).
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
// Per-head form (Mamba-2): a is (H,), dt (B, S, H); channel d takes head d / P
// ---------------------------------------------------------------------------

constexpr int TCH = 16;  // steps per chunk of the per-head form

constexpr int KH = 4;    // channels a thread of the per-head form holds

// The states of each channel a thread of the per-head form holds at each
// instantiated N: M of them, j, j + G, ... of G = N / M groups.
template <int N>
struct HeadShape;
template <>
struct HeadShape<16> {
  static constexpr int M = 4;
};
template <>
struct HeadShape<64> {
  static constexpr int M = 8;
};

// One stage of the per-head ring, as the rows lie in memory: x of the
// tile's channels, dt of its heads (at most CPB of them), B_t and C_t.
template <typename T, int N>
struct StageH {
  T x[TCH][CPB];
  T dt[TCH][CPB];
  float4 b[TCH][N / 4];
  float4 c[TCH][N / 4];
};

template <typename T, int N>
struct SmemH {
  static constexpr int M = HeadShape<N>::M, G = N / M;
  StageH<T, N> ring[2];
  // the chunk's B_t / C_t group-major: row [tt][j] holds states j, j + G,
  // ... of step tt
  float4 b[TCH][G][M / 4];
  float4 c[TCH][G][M / 4];
  float da[TCH][CPB];  // exp(dt * a) per (step, head of the tile)
  float dx[TCH][CPB];  // dt * x per (step, channel)
  // each group's partial of y's tree per (step, group, channel)
  float part[TCH][G][CPB];
  float a[CPB];  // the tile's heads' decays
};

// 4-byte copy; src_bytes 0 fills with zero
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// Steps [t0, t0 + TCH) into a stage: x of channels [d0, d0 + CPB), dt of
// heads [h0, h0 + nht), the B and C rows; 0 past S and past D.
template <typename T, int N, int THREADS>
__device__ __forceinline__ void load_chunk_h(
    StageH<T, N>& st, const T* __restrict__ dt, const T* __restrict__ x,
    const float* __restrict__ bm, const float* __restrict__ cm,
    long long row0, int t0, int d0, int h0, int nht, int S, int D, int H,
    bool vec) {
  constexpr int E = 16 / sizeof(T);  // elements per 16-byte copy
  constexpr int RC = CPB / E;        // copies per step row of x
  if (vec) {
    for (int i = threadIdx.x; i < TCH * RC; i += THREADS) {
      const int tt = i / RC, cc = (i % RC) * E;
      const bool ok = t0 + tt < S && d0 + cc < D;
      const long long off = ok ? (row0 + t0 + tt) * D + d0 + cc : 0;
      cp_async16(&st.x[tt][cc], x + off, ok ? 16 : 0);
    }
    for (int i = threadIdx.x; i < TCH * N / 4; i += THREADS) {
      const int tt = i / (N / 4), q = i % (N / 4);
      const bool ok = t0 + tt < S;
      const long long off = ok ? (row0 + t0 + tt) * N + 4 * q : 0;
      cp_async16(&st.b[tt][q], bm + off, ok ? 16 : 0);
      cp_async16(&st.c[tt][q], cm + off, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < TCH * CPB; i += THREADS) {
      const int tt = i / CPB, cc = i % CPB;
      const bool ok = t0 + tt < S && d0 + cc < D;
      const long long off = (row0 + t0 + tt) * D + d0 + cc;
      store(&st.x[tt][cc], ok ? to_f32(x[off]) : 0.f);
    }
    float* b_s = &st.b[0][0].x;
    float* c_s = &st.c[0][0].x;
    for (int i = threadIdx.x; i < TCH * N; i += THREADS) {
      const int tt = i / N;
      const bool ok = t0 + tt < S;
      const long long off = ok ? (row0 + t0) * N + i : 0;
      cp_async4(b_s + i, bm + off, ok ? 4 : 0);
      cp_async4(c_s + i, cm + off, ok ? 4 : 0);
    }
  }
  // dt: one value per (step, head); 4-byte copies in f32, bf16 loaded
  for (int i = threadIdx.x; i < TCH * nht; i += THREADS) {
    const int tt = i / nht, hl = i - tt * nht;
    const bool ok = t0 + tt < S;
    const long long off = (row0 + t0 + tt) * H + h0 + hl;
    if constexpr (sizeof(T) == 4)
      cp_async4(&st.dt[tt][hl], dt + (ok ? off : 0), ok ? 4 : 0);
    else
      store(&st.dt[tt][hl], ok ? to_f32(dt[off]) : 0.f);
  }
}

// The last levels of y's tree over the groups' partials, for the chunk's
// rows [t0, t0 + tc): four neighbouring channels a thread, stored
// coalesced (four at once where vec says the rows allow it).
template <typename T, int G, int THREADS>
__device__ __forceinline__ void store_rows(T* __restrict__ y,
                                           const float (&part)[TCH][G][CPB],
                                           long long row0, int t0, int tc,
                                           int d0, int D, bool vec) {
  constexpr int Q = CPB / 4;  // four-channel quads per row
#pragma unroll
  for (int r = 0; r < TCH * Q / THREADS; ++r) {
    const int i = threadIdx.x + r * THREADS;
    const int tt = i / Q, c = 4 * (i % Q);
    float p[4][G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float4 f = *reinterpret_cast<const float4*>(&part[tt][g][c]);
      p[0][g] = f.x, p[1][g] = f.y, p[2][g] = f.z, p[3][g] = f.w;
    }
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = tree_sum<G>(p[k]);
    if (tt >= tc) continue;
    T* row = y + (row0 + t0 + tt) * D + d0 + c;
    if (vec && d0 + c + 4 <= D) {
      if constexpr (sizeof(T) == 4) {
        *reinterpret_cast<float4*>(row) =
            make_float4(v[0], v[1], v[2], v[3]);
      } else {
        __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
        __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
        uint2 u;
        u.x = *reinterpret_cast<uint32_t*>(&lo);
        u.y = *reinterpret_cast<uint32_t*>(&hi);
        *reinterpret_cast<uint2*>(row) = u;
      }
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (d0 + c + k < D) store(row + k, v[k]);
    }
  }
}

// The chunk's B_t / C_t rows of a landed stage into the group-major copy
// the steps read: state n = j + G * q goes to row [tt][j], column q.
template <typename T, int N, int THREADS>
__device__ __forceinline__ void transpose_bc(SmemH<T, N>& sm,
                                             const StageH<T, N>& st) {
  constexpr int M = HeadShape<N>::M, G = N / M;
  float* b_g = &sm.b[0][0][0].x;
  float* c_g = &sm.c[0][0][0].x;
#pragma unroll
  for (int r = 0; r < TCH * N / 4 / THREADS; ++r) {
    const int i = threadIdx.x + r * THREADS;
    const int tt = i / (N / 4), n0 = 4 * (i % (N / 4));
    const float4 b4 = st.b[tt][n0 / 4], c4 = st.c[tt][n0 / 4];
    const float bb[4] = {b4.x, b4.y, b4.z, b4.w};
    const float cc[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int n = n0 + k, at = (tt * G + n % G) * M + n / G;
      b_g[at] = bb[k];
      c_g[at] = cc[k];
    }
  }
}

// Threads: group j = threadIdx.x / (CPB / KH), holding states j, j + G,
// ... of the KH neighbouring channels KH * (threadIdx.x % (CPB / KH)) + k:
// one read of B_t / C_t serves KH channels, and the lanes of a warp that
// share a group read the same address (a broadcast).  Two blocks an SM.
template <typename T, int N>
__global__ void __launch_bounds__(CPB / KH * (N / HeadShape<N>::M), 2)
    scan_head_kernel(const T* __restrict__ dt, const T* __restrict__ x,
                     const float* __restrict__ bm,
                     const float* __restrict__ cm,
                     const float* __restrict__ a, T* __restrict__ y,
                     float* __restrict__ h_last, int S, int D, int H,
                     int vec, int sms) {
  constexpr int K = KH;               // channels per thread
  constexpr int M = HeadShape<N>::M;  // states per channel and thread
  constexpr int G = N / M;            // state groups
  constexpr int THREADS = CPB / K * G;
  static_assert(K == 4 && THREADS % CPB == 0 && M % 4 == 0 &&
                    (TCH * N / 4) % THREADS == 0 &&
                    (TCH * CPB / 4) % THREADS == 0,
                "thread shape");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SmemH<T, N>& sm = *reinterpret_cast<SmemH<T, N>*>(smem_raw);
  const int P = D / H;  // channels per head
  const int d0 = blockIdx.x * CPB;
  const int b = blockIdx.y;
  const long long row0 = (long long)b * S;
  const int h0 = d0 / P;
  const int nht = (min(d0 + CPB, D) - 1) / P + 1 - h0;  // heads in the tile
  for (int i = threadIdx.x; i < nht; i += THREADS) sm.a[i] = a[h0 + i];

  const int c0 = K * (threadIdx.x % (CPB / K));  // this thread's channels
  const int j = threadIdx.x / (CPB / K);         // and group
  int hk[K];  // each channel's head in the tile
#pragma unroll
  for (int k = 0; k < K; ++k)
    hk[k] = d0 + c0 + k < D ? (d0 + c0 + k) / P - h0 : 0;
  const int cp = threadIdx.x % CPB;  // the precompute's channel
  const int hp = d0 + cp < D ? (d0 + cp) / P - h0 : 0;
  float h[K][M];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int q = 0; q < M; ++q) h[k][q] = 0.f;

  // chunk ci holds steps [ci * TCH - shift, (ci + 1) * TCH - shift) within
  // [0, S): the blocks of every second wave (an SM holds block w and block
  // w + sms side by side) start with a half chunk, so that one block's
  // chunk boundaries fall in the middle of the other's steps
  const int shift =
      (blockIdx.y * gridDim.x + blockIdx.x) / sms % 2 ? TCH / 2 : 0;
  const int nc = (S + shift + TCH - 1) / TCH;
  load_chunk_h<T, N, THREADS>(sm.ring[0], dt, x, bm, cm, row0, 0, d0, h0,
                              nht, S, D, H, vec);
  cp_async_commit();
  int t0 = 0, tc = 0;
  for (int ci = 0; ci < nc; ++ci) {
    cp_async_wait_all();
    __syncthreads();  // chunk ci landed; chunk ci - 1's steps are done, so
                      // its stage is free and its partials are complete
    if (ci > 0)
      store_rows<T, G, THREADS>(y, sm.part, row0, t0, tc, d0, D, vec);
    t0 = max(ci * TCH - shift, 0);
    tc = min((ci + 1) * TCH - shift, S) - t0;
    if (ci + 1 < nc)
      load_chunk_h<T, N, THREADS>(sm.ring[(ci + 1) & 1], dt, x, bm, cm, row0,
                                  (ci + 1) * TCH - shift, d0, h0, nht, S, D,
                                  H, vec);
    cp_async_commit();
    const StageH<T, N>& st = sm.ring[ci & 1];
    // the chunk's operands for the steps: B_t / C_t group-major, one exp
    // per (step, head), and dt * x per (step, channel); the step loop
    // issues neither an exp nor the dt * x product
    transpose_bc<T, N, THREADS>(sm, st);
    for (int i = threadIdx.x; i < TCH * nht; i += THREADS) {
      const int tt = i / nht, k = i - tt * nht;
      sm.da[tt][k] = expf(__fmul_rn(to_f32(st.dt[tt][k]), sm.a[k]));
    }
#pragma unroll
    for (int tt = threadIdx.x / CPB; tt < TCH; tt += THREADS / CPB)
      sm.dx[tt][cp] = __fmul_rn(to_f32(st.dt[tt][hp]), to_f32(st.x[tt][cp]));
    __syncthreads();  // the operands are ready; chunk ci - 1's partials read
#pragma unroll 2
    for (int tt = 0; tt < tc; ++tt) {
      float da[K];
#pragma unroll
      for (int k = 0; k < K; ++k) da[k] = sm.da[tt][hk[k]];
      const float4 dx4 = *reinterpret_cast<const float4*>(&sm.dx[tt][c0]);
      const float dx[K] = {dx4.x, dx4.y, dx4.z, dx4.w};
      float hc[K][M];
#pragma unroll
      for (int q4 = 0; q4 < M / 4; ++q4) {
        const float4 b4 = sm.b[tt][j][q4], c4 = sm.c[tt][j][q4];
        const float bb[4] = {b4.x, b4.y, b4.z, b4.w};
        const float cc[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const int q = 4 * q4 + r;
            // each product and sum rounded on its own, in the plain
            // version's order
            h[k][q] = __fadd_rn(__fmul_rn(da[k], h[k][q]),
                                __fmul_rn(dx[k], bb[r]));
            hc[k][q] = __fmul_rn(h[k][q], cc[r]);
          }
      }
      // y's halving tree over N: offsets N/2 .. G pair states of this
      // thread (q and q + M/2, ...); offsets G/2 .. 1 pair the groups'
      // partials at the next chunk's start (store_rows)
      *reinterpret_cast<float4*>(&sm.part[tt][j][c0]) =
          make_float4(tree_sum<M>(hc[0]), tree_sum<M>(hc[1]),
                      tree_sum<M>(hc[2]), tree_sum<M>(hc[3]));
    }
  }
  __syncthreads();
  store_rows<T, G, THREADS>(y, sm.part, row0, t0, tc, d0, D, vec);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (d0 + c0 + k >= D) continue;
    float* hq = h_last + ((long long)b * D + d0 + c0 + k) * N + j;
#pragma unroll
    for (int q = 0; q < M; ++q) hq[G * q] = h[k][q];
  }
}

template <typename T, int N>
int launch_head(const void* dt, const void* x, const void* bm,
                const void* cm, const void* a, void* y, void* h_last, int B,
                int S, int D, int H, int vec, cudaStream_t stream) {
  constexpr size_t smem = sizeof(SmemH<T, N>);
  constexpr int threads = CPB / KH * (N / HeadShape<N>::M);
  cudaError_t err = cudaFuncSetAttribute(
      scan_head_kernel<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((D + CPB - 1) / CPB, B);
  scan_head_kernel<T, N><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(dt), static_cast<const T*>(x),
      static_cast<const float*>(bm), static_cast<const float*>(cm),
      static_cast<const float*>(a), static_cast<T*>(y),
      static_cast<float*>(h_last), S, D, H, vec, sms);
  return (int)cudaGetLastError();
}

// the instantiated (N, form) pairs: (D, N) decays at N 8 and 16 (Mamba-1),
// per-head decays at N 16 and 64 (Mamba-2)
template <typename T>
int dispatch(const void* dt, const void* x, const void* bm, const void* cm,
             const void* a, void* y, void* h_last, int B, int S, int D,
             int N, int heads, int vec, cudaStream_t st) {
  if (!heads && N == 8)
    return launch<T, 8>(dt, x, bm, cm, a, y, h_last, B, S, D, vec, st);
  if (!heads && N == 16)
    return launch<T, 16>(dt, x, bm, cm, a, y, h_last, B, S, D, vec, st);
  if (heads && N == 16)
    return launch_head<T, 16>(dt, x, bm, cm, a, y, h_last, B, S, D, heads,
                              vec, st);
  if (heads && N == 64)
    return launch_head<T, 64>(dt, x, bm, cm, a, y, h_last, B, S, D, heads,
                              vec, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (dt, x and y share it).  heads: 0 = a
// is (D, N) and dt (B, S, D); H > 0 = a is (H,) and dt (B, S, H), one
// decay and step per head of D / H channels.  vec: 1 = 16-byte cp.async
// copies of dt (the (D, N) form) and x, which need D * sizeof(dtype) % 16
// == 0 and 16-byte aligned tensors; 0 = element-wise staging in the same
// kernel.
extern "C" int selective_scan_launch(const void* dt, const void* x,
                                     const void* bm, const void* cm,
                                     const void* a, void* y, void* h_last,
                                     int dtype, int B, int S, int D, int N,
                                     int heads, int vec, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || D < 1 || (dtype != 0 && dtype != 1) ||
      (vec && D % (dtype == 0 ? 4 : 8)) || heads < 0 ||
      (heads && D % heads))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(dt, x, bm, cm, a, y, h_last, B, S, D, N, heads,
                           vec, st);
  return dispatch<__nv_bfloat16>(dt, x, bm, cm, a, y, h_last, B, S, D, N,
                                 heads, vec, st);
}
