// K5: causal GQA flash attention (forward) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _flash_kernel of
// src/repro/kernels/flash_attention.py (called through flash_attention):
// q (B, H, S, hd), k/v (B, K, S, hd) with H % K == 0, query head h reading
// kv head h / (H / K); causal, with an optional sliding window (a key is
// live for a query row when row - window < col <= row); f32 or bf16 in,
// f32 running max / denominator / accumulator, q's dtype out.  Two kernels
// serve the two dtypes; flash_attention_launch routes by dtype.
//
// Both kernels are FlashAttention-2.  The TPU kernel carried its
// online-softmax state across the kv grid axis, which the TPU runs in
// order; CUDA blocks run in no order, so the kv loop runs inside the
// block.  One block of four warps per (64-row q tile, head, batch), the
// longest q tiles issued first; each warp owns 16 q rows.  The loop
// starts at the first kv tile the window reaches and stops at the
// diagonal tile, the bounds the TPU kernel's pl.when(live) skip gives; a
// warp skips a tile in which none of its rows has a live key.  The scores
// stay in registers, and the online softmax runs on them where they are:
// a row lives in a few lanes, a few shuffles per row reduction.  K and V
// tiles come through a two-stage ring of 16-byte cp.async copies: tile
// kt + 1 loads while tile kt computes, one barrier per tile.  The tiles
// use XOR-swizzled layouts, so the operand loads are free of bank
// conflicts.  Ragged S is masked (rows and keys past S read as 0 and are
// never written or counted); hd <= 192 (64, 128 and 192 instantiations,
// the dims past hd padded with 0; 192 is nemotron-4-340b's head dim, as
// the TPU kernel, whose BlockSpecs carry hd whole, takes any).  At hd 192
// the bf16 kernel's tiles take 120 KiB of shared memory (one block an
// SM) and its 24 accumulator tiles 96 f32 registers a thread beside 48
// for the q fragments; the f32 kernel keeps one kv stage (below).  The 16-byte copies need 16-byte aligned
// rows (hd % 8 == 0 in bf16, hd % 4 == 0 in f32) and aligned tensors;
// otherwise the launcher passes vec = 0 and the same kernel stages element
// by element.  A row with no live key keeps a running max of -inf
// ("nothing seen yet") and gets p = 0.
//
// bf16: flash_mma_kernel, on the tensor cores.  Q.K^T and P.V run as
// mma.sync.m16n8k16 (bf16 in, f32 accumulate) on operands that ldmatrix
// brings from bf16 tiles (.trans for V); the softmax runs on the
// accumulator fragments (a row in one quad of lanes).  The m16n8k16
// accumulator of two 8-key tiles has the layout of one 16-key A operand,
// so P goes into P.V without a shuffle, as three bf16 parts that sum to P
// exactly.  With P as one bf16 (2^-9 relative per probability) the output
// of a row whose values sit in [2, 4) moved by two bf16 ulps against the
// plain version at granite-3-2b's layers, past the 6e-3 bar; with two
// parts (2^-17) every launch met the bar but the 40-layer prefill's logits
// drifted to 2.02 % of max|logit| from the plain route (bar 2 %).  Three
// parts cost 64 more mma per (warp, kv tile) at hd 64 than one.
//
// f32: flash_fma_kernel, register-tiled FMAs on the FP32 pipes.  The JAX
// suite's 5e-6 bar for f32, held against the plain version, rules out
// bf16 operands, and on an H100 it ruled out 3xTF32 on mma.sync too (each
// operand split into two tf32 parts, three mma per product): 160 us at
// granite-3-2b's prefill against 304 us for an FMA kernel that read both
// operands from shared memory, but with q scaled by 8 (scores up to about
// 30) its outputs moved by up to 3.4e-5 from the plain version's (1.8e-5
// with each step's and each tile's products summed in registers apart).
// There the plain f32 version is itself 1.7e-5 from a float64 reference
// (3xTF32 with the separate sums 8.5e-6): the bar holds a kernel to the
// plain version's own rounding, which a kernel that sums the products over
// d in order with IEEE FMAs, as this one does, keeps (within 4.3e-6).
// Each lane of a row group of 8 owns 4 q rows: its 4 x 8 scores (keys
// 8 cg + j) come from float4 loads of q and K (12 loads per 128 FMAs),
// never pass through shared memory, and its 4 x HD / 8 outputs (chunks
// cg + 8 u) take P from the group's lanes by shuffle.
//
// Bound on an H100.  At granite-3-2b's prefill (B 4, H 32, K 8, S 512,
// hd 64) the function moves 21 MB in bf16 (q, k, v read once, o written
// once: ~6.3 us at 3.35 TB/s) and does 4 * B * H * hd * S (S + 1) / 2 =
// 4.3 GFLOP of causal products (~4.4 us at the 989 TFLOP/s bf16 tensor
// rate), so bytes bound it at this S.  The bf16 kernel computes whole
// 64 x 64 tiles up to the diagonal (1.9e7 scores), and with P in three
// parts its mma work is 2.4 GFLOP for Q.K^T and 7.2 for P.V: ~10 us at
// the full tensor rate, which mma.sync does not reach (wgmma is the
// full-rate path).  Its 1.9e7 exps take ~4.5 us on the SFU (16 per clock
// per SM at 1.98 GHz).  Within a warp the products, the softmax and the
// exps run in sequence; other warps of the SM overlap them.  In f32 the
// function moves 42 MB (~12.5 us); as 3xTF32 its 3 x 4.3 GFLOP would take
// ~26 us at the 495 TFLOP/s dense TF32 rate, which bounds the function.
// This kernel does the 4.3 GFLOP once on the 67 TFLOP/s FP32 pipes (~64
// us, its own floor); its whole tiles to the diagonal are 4.8 GFLOP (~72
// us), with the loads, shuffles and softmax on top in the same issue
// slots.
//
// C interface (loaded with ctypes): pointers and the stream as void*; the
// launcher returns cudaGetLastError() as an int (or cudaErrorInvalidValue
// for a shape it does not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per kv tile

// ---------------------------------------------------------------------------
// bf16 route: FlashAttention-2 on the tensor cores (mma.sync)
// ---------------------------------------------------------------------------

constexpr int MMA_THREADS = 128;  // four warps, 16 q rows each
constexpr float LOG2E = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

template <int HD>
constexpr size_t mma_smem_bytes() {
  // the q tile, then two stages of K and of V
  return sizeof(bf16) * HD * (BQ + 4 * BK);
}

// Element offset of (row, 16-byte chunk) in a tile of HD bf16 columns: the
// chunk index is XOR-ed with row % 8, so the eight rows an ldmatrix phase
// reads sit in eight different bank groups.
template <int HD>
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * HD + ((chunk ^ (row & 7)) << 3);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy; src_bytes 0 fills the 16 bytes with zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// (a, b) as three bf16 pairs whose sum is (a, b) exactly: hi = (a, b)
// rounded, mid = the remainders rounded, lo = what is left
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const float ra = a - hf.x, rb = b - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(ra, rb);
  const float2 mf = __bfloat1622float2(m);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&m);
  lo = pack_bf16(ra - mf.x, rb - mf.y);
}

// Rows [r0, r0 + 64) x [0, HD) of an (S, hd) head slice into a swizzled
// tile, 0 past S and past hd.  vec: 16-byte cp.async copies (hd % 8 == 0,
// 16-byte aligned rows); otherwise element by element, synchronously.
template <int HD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* __restrict__ src,
                                          int r0, int S, int hd, bool vec) {
  constexpr int CH = HD / 8;
  if (vec) {
    const int nch = hd >> 3;
#pragma unroll
    for (int it = 0; it < 64 * CH / MMA_THREADS; ++it) {
      const int i = threadIdx.x + it * MMA_THREADS;
      const int r = i / CH, c = i % CH;
      const bool ok = r0 + r < S && c < nch;
      const bf16* g = ok ? src + (long long)(r0 + r) * hd + c * 8 : src;
      cp_async16(smem_u32(dst + swz<HD>(r, c)), g, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < 64 * HD; i += MMA_THREADS) {
      const int r = i / HD, d = i % HD;
      bf16 val = __float2bfloat16(0.f);
      if (r0 + r < S && d < hd) val = src[(long long)(r0 + r) * hd + d];
      dst[swz<HD>(r, d >> 3) + (d & 7)] = val;
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(MMA_THREADS)
    flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     int H, int G, int S, int hd, int window,
                     float scale_log2, int vec) {
  constexpr int KS = HD / 16;  // 16-wide steps over the head dim
  constexpr int NT = BK / 8;   // 8-key score tiles of a kv tile
  constexpr int OT = HD / 8;   // 8-dim output tiles
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // BQ x HD
  bf16* k_s = q_s + BQ * HD;                      // 2 stages of BK x HD
  bf16* v_s = k_s + 2 * BK * HD;                  // 2 stages of BK x HD

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // the longest q tiles (most kv tiles to walk) are issued first
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int h = blockIdx.x, b = blockIdx.y;
  const int K = H / G;
  const bf16* qh = q + ((long long)b * H + h) * S * hd;
  const bf16* kh = k + ((long long)b * K + h / G) * S * hd;
  const bf16* vh = v + ((long long)b * K + h / G) * S * hd;
  bf16* oh = o + ((long long)b * H + h) * S * hd;

  const int last_row = min(q0 + BQ, S) - 1;
  const int kt_lo = window > 0 ? max(0, q0 - window + 1) / BK : 0;
  const int kt_hi = last_row / BK;
  const int w0 = q0 + warp * 16;  // this warp's first row
  const int row_a = w0 + g, row_b = row_a + 8;

  load_tile<HD>(q_s, qh, q0, S, hd, vec);
  load_tile<HD>(k_s, kh, kt_lo * BK, S, hd, vec);
  load_tile<HD>(v_s, vh, kt_lo * BK, S, hd, vec);
  cp_async_commit();

  uint32_t qf[KS][4];
  float acc[OT][4];
#pragma unroll
  for (int j = 0; j < OT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m_a = -CUDART_INF_F, m_b = -CUDART_INF_F;  // running max (log2 units)
  float l_a = 0.f, l_b = 0.f;  // this thread's share of the denominators

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int st = (kt - kt_lo) & 1;
    cp_async_wait_all();
    __syncthreads();  // tile kt landed; tile kt - 1's stage is free
    if (kt < kt_hi) {
      load_tile<HD>(k_s + (st ^ 1) * BK * HD, kh, (kt + 1) * BK, S, hd, vec);
      load_tile<HD>(v_s + (st ^ 1) * BK * HD, vh, (kt + 1) * BK, S, hd, vec);
    }
    cp_async_commit();
    if (kt == kt_lo) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        ldsm_x4(qf[ks], smem_u32(q_s + swz<HD>(warp * 16 + (lane & 15),
                                                2 * ks + (lane >> 4))));
    }
    const int c0 = kt * BK;
    // a tile with no live key for any of this warp's rows: nothing to do
    if (w0 >= S || c0 > w0 + 15 ||
        (window > 0 && c0 + BK - 1 <= w0 - window))
      continue;
    const bf16* kst = k_s + st * BK * HD;
    const bf16* vst = v_s + st * BK * HD;

    // scores S = Q K^T, 16 rows x 64 keys per warp, in registers
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int p = 0; p < NT / 2; ++p) {
        uint32_t kb[4];
        ldsm_x4(kb, smem_u32(kst + swz<HD>(p * 16 + (lane & 7) +
                                               ((lane >> 4) << 3),
                                           2 * ks + ((lane >> 3) & 1))));
        mma_bf16(s[2 * p], qf[ks], kb[0], kb[1]);
        mma_bf16(s[2 * p + 1], qf[ks], kb[2], kb[3]);
      }
    }

    // scale into log2 units and mask (causal, band, keys past S)
    const bool masked = c0 + BK - 1 > w0 || c0 + BK > S ||
                        (window > 0 && c0 <= w0 + 15 - window);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float val = s[j][e] * scale_log2;
        if (masked) {
          const int col = c0 + 8 * j + 2 * t + (e & 1);
          const int row = e < 2 ? row_a : row_b;
          const bool live = col <= row && col < S &&
                            (window <= 0 || col > row - window);
          if (!live) val = -CUDART_INF_F;
        }
        s[j][e] = val;
      }

    // online softmax on the fragments: each row lives in one quad of lanes
    float mx_a = -CUDART_INF_F, mx_b = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      mx_a = fmaxf(mx_a, fmaxf(s[j][0], s[j][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[j][2], s[j][3]));
    }
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    // a running max of -inf means "no live key yet": p = 0, alpha = 0
    const float base_a = mn_a == -CUDART_INF_F ? 0.f : mn_a;
    const float base_b = mn_b == -CUDART_INF_F ? 0.f : mn_b;
    const float al_a = exp2f(m_a - base_a), al_b = exp2f(m_b - base_b);
    m_a = mn_a;
    m_b = mn_b;
    l_a *= al_a;
    l_b *= al_b;
#pragma unroll
    for (int j = 0; j < OT; ++j) {
      acc[j][0] *= al_a;
      acc[j][1] *= al_a;
      acc[j][2] *= al_b;
      acc[j][3] *= al_b;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = exp2f(s[j][0] - base_a);
      s[j][1] = exp2f(s[j][1] - base_a);
      s[j][2] = exp2f(s[j][2] - base_b);
      s[j][3] = exp2f(s[j][3] - base_b);
      l_a += s[j][0] + s[j][1];
      l_b += s[j][2] + s[j][3];
    }

    // O += P V: two score tiles make one A operand of 16 keys.  P goes in
    // as three bf16 parts (hi + mid + lo = P exactly: 3 x 8 bits of f32's
    // 24-bit significand), three mma per tile; the products with bf16 V
    // are exact, so O is summed in f32 like the plain version's.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pp[3][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float* pr = s[2 * kk + (r >> 1)] + 2 * (r & 1);
        split_bf16(pr[0], pr[1], pp[0][r], pp[1][r], pp[2][r]);
      }
#pragma unroll
      for (int np = 0; np < OT / 2; ++np) {
        uint32_t vb[4];
        ldsm_x4_t(vb, smem_u32(vst + swz<HD>(kk * 16 + (lane & 7) +
                                                 (((lane >> 3) & 1) << 3),
                                             2 * np + (lane >> 4))));
#pragma unroll
        for (int part = 0; part < 3; ++part) {
          mma_bf16(acc[2 * np], pp[part], vb[0], vb[1]);
          mma_bf16(acc[2 * np + 1], pp[part], vb[2], vb[3]);
        }
      }
    }
  }

  // epilogue: finish the denominators across the quad, stage the warp's
  // 16 rows of O in its own rows of q_s, then write 16-byte rows out
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
  const float inv_a = l_a > 0.f ? 1.f / l_a : 0.f;
  const float inv_b = l_b > 0.f ? 1.f / l_b : 0.f;
  const int ra = warp * 16 + g, rb = ra + 8;
#pragma unroll
  for (int j = 0; j < OT; ++j) {
    const int col = 8 * j + 2 * t;
    *reinterpret_cast<uint32_t*>(q_s + swz<HD>(ra, j) + (col & 7)) =
        pack_bf16(acc[j][0] * inv_a, acc[j][1] * inv_a);
    *reinterpret_cast<uint32_t*>(q_s + swz<HD>(rb, j) + (col & 7)) =
        pack_bf16(acc[j][2] * inv_b, acc[j][3] * inv_b);
  }
  __syncwarp();
  constexpr int CH = HD / 8;
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = i / CH, c = i % CH;
    const int row = w0 + r;
    if (row >= S || c * 8 >= hd) continue;
    const bf16* src = q_s + swz<HD>(warp * 16 + r, c);
    bf16* dst = oh + (long long)row * hd + c * 8;
    if (vec) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int d = 0; d < 8 && c * 8 + d < hd; ++d) dst[d] = src[d];
    }
  }
}

// ---------------------------------------------------------------------------
// f32 route: register-tiled FMA products on the FP32 pipes
// ---------------------------------------------------------------------------

constexpr int FMA_RT = 4;  // q rows per thread; a row group is 8 lanes

template <int HD, int STAGES>
constexpr size_t fma_smem_bytes() {
  // the q tile, then STAGES stages of K and of V
  return sizeof(float) * HD * (BQ + 2 * STAGES * BK);
}

// Float offset of (row, 4-float chunk) in a tile of HD f32 columns: the
// chunk index is XOR-ed with (row ^ row / 8) % 8, so the eight key rows
// 8 c + j (c = 0..7) of a K load, the four q rows of a Q load (one per row
// group of the warp) and the eight chunks of a V load each sit in
// different groups of four banks: every 16-byte load is one wavefront.
template <int HD>
__device__ __forceinline__ int swzf(int row, int chunk) {
  return row * HD + ((chunk ^ ((row ^ (row >> 3)) & 7)) << 2);
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Rows [r0, r0 + 64) x [0, HD) of an (S, hd) f32 head slice into a
// swizzled tile, 0 past S and past hd.  vec: 16-byte cp.async copies
// (hd % 4 == 0, 16-byte aligned rows); otherwise element by element,
// synchronously.
template <int HD>
__device__ __forceinline__ void load_tile_f32(float* dst,
                                              const float* __restrict__ src,
                                              int r0, int S, int hd,
                                              bool vec) {
  constexpr int CH = HD / 4;
  if (vec) {
    const int nch = hd >> 2;
#pragma unroll
    for (int it = 0; it < 64 * CH / MMA_THREADS; ++it) {
      const int i = threadIdx.x + it * MMA_THREADS;
      const int r = i / CH, c = i % CH;
      const bool ok = r0 + r < S && c < nch;
      const float* g = ok ? src + (long long)(r0 + r) * hd + c * 4 : src;
      cp_async16(smem_u32(dst + swzf<HD>(r, c)), g, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < 64 * HD; i += MMA_THREADS) {
      const int r = i / HD, d = i % HD;
      float val = 0.f;
      if (r0 + r < S && d < hd) val = src[(long long)(r0 + r) * hd + d];
      dst[swzf<HD>(r, d >> 2) + (d & 3)] = val;
    }
  }
}

// Thread layout: lane cg = tid % 8 of row group rg = tid / 8 owns q rows
// 4 rg + i (i < 4); warp w's four row groups are rows 16 w .. 16 w + 15.
// Q.K^T: the thread's 4 x 8 scores are keys 8 cg + j of its rows, summed
// over d in order with FMAs (4 + 8 float4 loads per 128 FMAs).  A row's 64
// scores are in its group's 8 lanes: the row max and sum take three
// shuffles.  P.V: the thread's outputs are its rows x the 4-float chunks
// cg + 8 u; the probabilities of key 8 c + j come from lane c of the group
// by shuffle (4 shuffles per 4 x 4 HD / 32 FMAs), summed over the keys in
// order.
//
// STAGES is 2 (the next kv tile's cp.async in flight under this tile's
// math) where two stages fit a block's 227 KB of shared memory, and 1 at
// hd 192 (two stages would take 240 KB): there the next tile is loaded
// once every warp is done with this one.
template <int HD, int STAGES>
__global__ void __launch_bounds__(MMA_THREADS)
    flash_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     int H, int G, int S, int hd, int window, float scale,
                     int vec) {
  constexpr int KC = HD / 4;   // 4-float chunks of a row
  constexpr int DC = HD / 32;  // output chunks per thread
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);  // BQ x HD
  float* k_s = q_s + BQ * HD;                  // STAGES stages of BK x HD
  float* v_s = k_s + STAGES * BK * HD;         // STAGES stages of BK x HD

  const int tid = threadIdx.x, warp = tid >> 5;
  const int rg = tid >> 3, cg = tid & 7;
  // the longest q tiles (most kv tiles to walk) are issued first
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int h = blockIdx.x, b = blockIdx.y;
  const int K = H / G;
  const float* qh = q + ((long long)b * H + h) * S * hd;
  const float* kh = k + ((long long)b * K + h / G) * S * hd;
  const float* vh = v + ((long long)b * K + h / G) * S * hd;
  float* oh = o + ((long long)b * H + h) * S * hd;

  const int last_row = min(q0 + BQ, S) - 1;
  const int kt_lo = window > 0 ? max(0, q0 - window + 1) / BK : 0;
  const int kt_hi = last_row / BK;
  const int w0 = q0 + warp * 16;  // this warp's first row
  const int r0 = FMA_RT * rg;     // this thread's first row in the tile

  load_tile_f32<HD>(q_s, qh, q0, S, hd, vec);
  load_tile_f32<HD>(k_s, kh, kt_lo * BK, S, hd, vec);
  load_tile_f32<HD>(v_s, vh, kt_lo * BK, S, hd, vec);
  cp_async_commit();

  float acc[FMA_RT][4 * DC];
  float m[FMA_RT], l[FMA_RT];  // running max; this lane's share of the sum
#pragma unroll
  for (int i = 0; i < FMA_RT; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < 4 * DC; ++d) acc[i][d] = 0.f;
  }

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int st = STAGES == 2 ? (kt - kt_lo) & 1 : 0;
    if (STAGES == 1 && kt > kt_lo) {
      __syncthreads();  // every warp is done with tile kt - 1
      load_tile_f32<HD>(k_s, kh, kt * BK, S, hd, vec);
      load_tile_f32<HD>(v_s, vh, kt * BK, S, hd, vec);
      cp_async_commit();
    }
    cp_async_wait_all();
    __syncthreads();  // tile kt landed; tile kt - 1's stage is free
    if (STAGES == 2) {
      if (kt < kt_hi) {
        load_tile_f32<HD>(k_s + (st ^ 1) * BK * HD, kh, (kt + 1) * BK, S,
                          hd, vec);
        load_tile_f32<HD>(v_s + (st ^ 1) * BK * HD, vh, (kt + 1) * BK, S,
                          hd, vec);
      }
      cp_async_commit();
    }
    const int c0 = kt * BK;
    // a tile with no live key for any of this warp's rows: nothing to do
    if (w0 >= S || c0 > w0 + 15 ||
        (window > 0 && c0 + BK - 1 <= w0 - window))
      continue;
    const float* kst = k_s + st * BK * HD;
    const float* vst = v_s + st * BK * HD;

    float s[FMA_RT][8];
#pragma unroll
    for (int i = 0; i < FMA_RT; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int c = 0; c < KC; ++c) {
      float4 kv[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = lds4(kst + swzf<HD>(8 * cg + j, c));
#pragma unroll
      for (int i = 0; i < FMA_RT; ++i) {
        const float4 qv = lds4(q_s + swzf<HD>(r0 + i, c));
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float x = fmaf(qv.x, kv[j].x, s[i][j]);
          x = fmaf(qv.y, kv[j].y, x);
          x = fmaf(qv.z, kv[j].z, x);
          s[i][j] = fmaf(qv.w, kv[j].w, x);
        }
      }
    }

    // scale and mask (causal, band, keys past S), in natural units as the
    // plain version's softmax; then the online softmax per row
    const bool masked = c0 + BK - 1 > w0 || c0 + BK > S ||
                        (window > 0 && c0 <= w0 + 15 - window);
#pragma unroll
    for (int i = 0; i < FMA_RT; ++i) {
      const int row = q0 + r0 + i;
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float val = s[i][j] * scale;
        if (masked) {
          const int col = c0 + 8 * cg + j;
          const bool live = col <= row && col < S &&
                            (window <= 0 || col > row - window);
          if (!live) val = -CUDART_INF_F;
        }
        s[i][j] = val;
        mx = fmaxf(mx, val);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float mn = fmaxf(m[i], mx);
      // a running max of -inf means "no live key yet": p = 0, alpha = 0
      const float base = mn == -CUDART_INF_F ? 0.f : mn;
      const float al = expf(m[i] - base);
      m[i] = mn;
      l[i] *= al;
#pragma unroll
      for (int d = 0; d < 4 * DC; ++d) acc[i][d] *= al;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = expf(s[i][j] - base);
        l[i] += s[i][j];
      }
    }

    // O += P V over the keys in order; key groups past the warp's last
    // row hold p = 0 for all its rows and are skipped
    const int c_last = min(7, (w0 + 15 - c0) >> 3);
    for (int c = 0; c <= c_last; ++c) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float p[FMA_RT];
#pragma unroll
        for (int i = 0; i < FMA_RT; ++i)
          p[i] = __shfl_sync(0xffffffffu, s[i][j], c, 8);
#pragma unroll
        for (int u = 0; u < DC; ++u) {
          const float4 vv = lds4(vst + swzf<HD>(8 * c + j, cg + 8 * u));
#pragma unroll
          for (int i = 0; i < FMA_RT; ++i) {
            acc[i][4 * u] = fmaf(p[i], vv.x, acc[i][4 * u]);
            acc[i][4 * u + 1] = fmaf(p[i], vv.y, acc[i][4 * u + 1]);
            acc[i][4 * u + 2] = fmaf(p[i], vv.z, acc[i][4 * u + 2]);
            acc[i][4 * u + 3] = fmaf(p[i], vv.w, acc[i][4 * u + 3]);
          }
        }
      }
    }
  }

  // epilogue: each row's denominator is the sum over its group's lanes
#pragma unroll
  for (int i = 0; i < FMA_RT; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    li += __shfl_xor_sync(0xffffffffu, li, 4);
    const int row = q0 + r0 + i;
    if (row >= S) continue;
#pragma unroll
    for (int u = 0; u < DC; ++u) {
      const int d0 = 4 * (cg + 8 * u);
      if (d0 >= hd) continue;
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        x[e] = li > 0.f ? acc[i][4 * u + e] / li : 0.f;
      float* dst = oh + (long long)row * hd + d0;
      if (vec) {  // hd % 4 == 0: the whole chunk is inside the row
        *reinterpret_cast<float4*>(dst) = make_float4(x[0], x[1], x[2], x[3]);
      } else {
        for (int e = 0; e < 4 && d0 + e < hd; ++e) dst[e] = x[e];
      }
    }
  }
}

template <int HD>
int launch_mma(const void* q, const void* k, const void* v, void* o, int B,
               int H, int K, int S, int hd, int window, float scale, int vec,
               cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_mma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(H, B, (S + BQ - 1) / BQ);
  flash_mma_kernel<HD><<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), H, H / K, S, hd,
      window, scale * LOG2E, vec);
  return (int)cudaGetLastError();
}

template <int HD, int STAGES>
int launch_fma(const void* q, const void* k, const void* v, void* o, int B,
               int H, int K, int S, int hd, int window, float scale, int vec,
               cudaStream_t stream) {
  constexpr size_t smem = fma_smem_bytes<HD, STAGES>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fma_kernel<HD, STAGES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(H, B, (S + BQ - 1) / BQ);
  flash_fma_kernel<HD, STAGES><<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), H, H / K, S, hd,
      window, scale, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (flash_fma_kernel), 1 = bfloat16 (flash_mma_kernel);
// q, k, v and o share it.  vec: 1 = 16-byte cp.async copies, which need
// 16-byte aligned q/k/v/o and hd % 8 == 0 (bf16) or hd % 4 == 0 (f32);
// 0 = element-wise staging in the same kernel.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int dtype,
                                      int B, int H, int K, int S, int hd,
                                      int window, float scale, int vec,
                                      void* stream) {
  if (B < 1 || K < 1 || H % K || S < 1 || hd < 1 || hd > 192 ||
      H > 65535 || B > 65535 || (dtype != 0 && dtype != 1) ||
      (vec && hd % (dtype == 1 ? 8 : 4)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (hd <= 64)
      return launch_fma<64, 2>(q, k, v, o, B, H, K, S, hd, window, scale,
                               vec, st);
    if (hd <= 128)
      return launch_fma<128, 2>(q, k, v, o, B, H, K, S, hd, window, scale,
                                vec, st);
    return launch_fma<192, 1>(q, k, v, o, B, H, K, S, hd, window, scale, vec,
                              st);
  }
  if (hd <= 64)
    return launch_mma<64>(q, k, v, o, B, H, K, S, hd, window, scale, vec,
                          st);
  if (hd <= 128)
    return launch_mma<128>(q, k, v, o, B, H, K, S, hd, window, scale, vec,
                           st);
  return launch_mma<192>(q, k, v, o, B, H, K, S, hd, window, scale, vec, st);
}
