// K5: causal GQA flash attention (forward) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _flash_kernel of
// src/repro/kernels/flash_attention.py (called through flash_attention):
// q (B, H, S, hd), k/v (B, K, S, hd) with H % K == 0, query head h reading
// kv head h / (H / K); causal, with an optional sliding window (a key is
// live for a query row when row - window < col <= row); f32 or bf16 in,
// f32 running max / denominator / accumulator, q's dtype out.
//
// Design.  One block per (64-row q tile, head, batch).  The TPU kernel
// carried its online-softmax state across the kv grid axis, which the TPU
// runs in order; CUDA blocks run in no order, so the kv loop runs inside
// the block instead.  It starts at the first kv tile the window reaches and
// stops at the diagonal tile, the bounds the TPU kernel's pl.when(live)
// skip gives.  Per kv tile of 64 keys: K is staged to shared memory as f32,
// each of the 256 threads computes a 4 x 4 block of scores with FMAs, the
// masked scores go to shared memory, four threads per row fold them into
// the running max and denominator, V replaces K in the same buffer, and
// each thread updates its 4 rows x hd/16 dims of the f32 accumulator in
// registers.  Ragged S is masked (rows and keys past S read as 0 and are
// never written or counted); hd <= 128 (64 and 128 instantiations, the
// dims past hd padded with 0).  Rows with no live key in a tile keep their
// state: a running max of -inf means "nothing seen yet" and gives p = 0.
//
// Bound on an H100.  At granite-3-2b's prefill (B 4, H 32, K 8, S 512,
// hd 64, bf16) the function moves 21 MB (q, k, v read once, o written
// once: ~6.3 us at 3.35 TB/s) and does 4 * B * H * hd * S (S + 1) / 2 =
// 4.3 GFLOP of causal products (~4.4 us at the 989 TFLOP/s bf16 tensor
// rate), so bytes bound it at this S.  This first kernel does not reach
// that bound: its products run on the FP32 pipes from shared memory (8
// shared loads per 16 FMAs), so shared-memory bandwidth limits it.  The
// tensor-core form (mma.sync / wgmma with TMA-fed tiles) is later work.
//
// C interface (loaded with ctypes): pointers and the stream as void*; the
// launcher returns cudaGetLastError() as an int (or cudaErrorInvalidValue
// for a shape it does not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per kv tile
constexpr int THREADS = 256;
constexpr int TY = 16;          // thread grid of the tile products
constexpr int TX = 16;
constexpr int RPT = BQ / TY;    // rows per thread
constexpr int CPT = BK / TX;    // score columns per thread
constexpr int PLD = BK + 1;     // padded row stride of the score tile

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * BQ * (HD + 1) + BQ * PLD + 3 * BQ);
}

// Stage rows [r0, r0 + BQ) x [0, HD) of a (S, hd) head slice as f32, with
// 0 past S and past hd.
template <typename T, int HD>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      int r0, int S, int hd) {
  constexpr int LD = HD + 1;
  for (int i = threadIdx.x; i < BQ * HD; i += THREADS) {
    const int r = i / HD, d = i % HD;
    float val = 0.f;
    if (r0 + r < S && d < hd) val = to_f32(src[(long long)(r0 + r) * hd + d]);
    dst[r * LD + d] = val;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int H,
                     int G, int S, int hd, int window, float scale) {
  constexpr int LD = HD + 1;
  constexpr int DPT = HD / TX;  // accumulator dims per thread
  extern __shared__ float smem[];
  float* q_s = smem;            // BQ x LD
  float* kv_s = q_s + BQ * LD;  // BK x LD: K, then V of the same tile
  float* p_s = kv_s + BK * LD;  // BQ x PLD scores, then probabilities
  float* m_s = p_s + BQ * PLD;  // running max per row
  float* l_s = m_s + BQ;        // running denominator per row
  float* a_s = l_s + BQ;        // this tile's rescale factor per row

  const int tid = threadIdx.x;
  const int ty = tid / TX, tx = tid % TX;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int K = H / G;
  const T* qh = q + ((long long)b * H + h) * S * hd;
  const T* kh = k + ((long long)b * K + h / G) * S * hd;
  const T* vh = v + ((long long)b * K + h / G) * S * hd;
  T* oh = o + ((long long)b * H + h) * S * hd;

  stage<T, HD>(q_s, qh, q0, S, hd);
  for (int r = tid; r < BQ; r += THREADS) {
    m_s[r] = -CUDART_INF_F;
    l_s[r] = 0.f;
  }
  float acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;

  const int last_row = min(q0 + BQ, S) - 1;
  const int kt_lo = window > 0 ? max(0, q0 - window + 1) / BK : 0;
  const int kt_hi = last_row / BK;
  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int c0 = kt * BK;
    __syncthreads();  // the previous tile's products are done with kv_s
    stage<T, HD>(kv_s, kh, c0, S, hd);
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 16
    for (int d = 0; d < HD; ++d) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = q_s[(ty + TY * i) * LD + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = kv_s[(tx + TX * j) * LD + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] += qv[i] * kv[j];
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = q0 + ty + TY * i;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = c0 + tx + TX * j;
        const bool live = col <= row && col < S &&
                          (window <= 0 || col > row - window);
        p_s[(ty + TY * i) * PLD + tx + TX * j] =
            live ? s[i][j] * scale : -CUDART_INF_F;
      }
    }
    __syncthreads();  // scores written; K no longer read

    stage<T, HD>(kv_s, vh, c0, S, hd);
    {
      // online softmax: four neighbouring lanes per row
      const int r = tid / 4, part = tid % 4;
      float* pr = p_s + r * PLD;
      float mx = -CUDART_INF_F;
      for (int c = part; c < BK; c += 4) mx = fmaxf(mx, pr[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float alpha = 1.f, sum = 0.f;
      if (m_new == -CUDART_INF_F) {
        for (int c = part; c < BK; c += 4) pr[c] = 0.f;
      } else {
        alpha = expf(m_prev - m_new);
        for (int c = part; c < BK; c += 4) {
          const float p = expf(pr[c] - m_new);
          pr[c] = p;
          sum += p;
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        m_s[r] = m_new;
        l_s[r] = alpha * l_s[r] + sum;
        a_s[r] = alpha;
      }
    }
    __syncthreads();  // V staged, probabilities and rescale factors ready

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float al = a_s[ty + TY * i];
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= al;
    }
#pragma unroll 8
    for (int c = 0; c < BK; ++c) {
      float pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = p_s[(ty + TY * i) * PLD + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const float vv = kv_s[c * LD + tx + TX * j];
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][j] += pv[i] * vv;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = ty + TY * i;
    if (q0 + r >= S) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = tx + TX * j;
      if (d < hd) store(&oh[(long long)(q0 + r) * hd + d], acc[i][j] / l);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int K, int S, int hd, int window, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, H / K, S, hd, window,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int dtype,
                                      int B, int H, int K, int S, int hd,
                                      int window, float scale,
                                      void* stream) {
  if (B < 1 || K < 1 || H % K || S < 1 || hd < 1 || hd > 128 ||
      H > 65535 || B > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return hd <= 64 ? launch<float, 64>(q, k, v, o, B, H, K, S, hd, window,
                                        scale, st)
                    : launch<float, 128>(q, k, v, o, B, H, K, S, hd, window,
                                         scale, st);
  return hd <= 64 ? launch<__nv_bfloat16, 64>(q, k, v, o, B, H, K, S, hd,
                                               window, scale, st)
                  : launch<__nv_bfloat16, 128>(q, k, v, o, B, H, K, S, hd,
                                                window, scale, st);
}
