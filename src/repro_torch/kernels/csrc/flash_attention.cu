// K5: causal GQA flash attention (forward) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _flash_kernel of
// src/repro/kernels/flash_attention.py (called through flash_attention):
// q (B, H, S, hd), k/v (B, K, S, hd) with H % K == 0, query head h reading
// kv head h / (H / K); causal, with an optional sliding window (a key is
// live for a query row when row - window < col <= row); f32 or bf16 in,
// f32 running max / denominator / accumulator, q's dtype out.  Three
// kernels, routed by the host before the launch: bf16 tensors that TMA
// can describe (16-byte aligned bases, 16-byte multiple strides, so hd %
// 8 == 0) run flash_wgmma_kernel; other bf16 tensors flash_mma_kernel,
// which stages element by element; f32 flash_fma_kernel.
//
// All three are FlashAttention-2 in the online-softmax form.  The TPU
// kernel carried its softmax state across the kv grid axis, which the TPU
// runs in order; CUDA blocks run in no order, so the kv loop runs inside
// the block.  The loop starts at the first kv tile the window reaches and
// stops at the diagonal tile, the bounds the TPU kernel's pl.when(live)
// skip gives, and the longest loops are issued first.
// Ragged S is masked (rows and keys past S read as 0 and are never
// written or counted); hd <= 192 (64, 128 and 192 instantiations, the
// dims past hd read as 0; 192 is nemotron-4-340b's head dim, as the TPU
// kernel, whose BlockSpecs carry hd whole, takes any).  A row with no
// live key keeps a running max of -inf ("nothing seen yet") and gets p =
// 0.
//
// bf16, flash_wgmma_kernel: Hopper's warpgroup products on a TMA-fed K/V
// ring.  A block of three warpgroups serves units of two 64-row q tiles
// that read the same kv head: the items of a kv head are its G = H / K q
// heads times its row tiles, head fastest, so a unit is two q heads of
// one GQA group on the same rows where G is even (granite-3-2b's 4,
// qwen2-vl-72b's 8, nemotron-4-340b's 12) and two neighbouring row tiles
// where G = 1; each K/V tile is read from L2 once for 128 q rows.  The
// grid is persistent, one block an SM: a block walks its units in rounds
// of the grid, every other round backwards, the longest loops first.
// Each of q, k, v and o has a 4-D tensor map (hd, S, heads, B) with byte
// strides taken from the tensor's own strides (the transposed (B, S, H,
// hd) views of the model reach the kernel as they are), a 64 x 64 box
// (two boxes across at hd 128, three at 192) and 128-byte swizzle; reads
// out of bounds fill with zeros, so ragged S reads zeros and not the next
// head's rows, and danube's hd 120 is declared 120 wide.  The maps are
// built on the host at every launch (cuTensorMapEncodeTiled, fetched with
// cudaGetDriverEntryPointByVersion: no -lcuda) and passed by value as
// __grid_constant__ parameters, so a CUDA graph bakes them with the
// replayed step's addresses.  Warpgroup 0 is the producer (setmaxnreg
// down to 24 registers): one thread decodes each unit, hands its
// description to the consumers beside their q tiles (two q buffers a
// consumer, so the next unit's q tile loads under this one), and keeps a
// ring of K/V stages in flight across units, each stage a full and an
// empty mbarrier with its own phase parity.  Warpgroups 1 and 2 are the
// consumers (240 registers), one q tile each: S = Q K^T as wgmma
// m64n64k16 with both operands in shared memory (K-major, the
// descriptors' swizzle the box's); O += P V as m64nHDk16 with P from
// registers (the accumulator rows of a warp already have the A-operand
// layout, so P needs no shuffle) and V from shared memory as a transposed
// (MN-major) B.  P goes in as three bf16 parts that sum to P exactly: with
// P as one bf16 (2^-9 relative per probability) the output of a row whose
// values sit in [2, 4) moved by two bf16 ulps against the plain version at
// granite-3-2b's layers, past the 6e-3 bar; with two parts (2^-17) every
// launch met the bar but the 40-layer prefill's logits drifted to 2.02 %
// of max|logit| from the plain route (bar 2 %).  The parts are cut by
// truncation with masks and byte permutes on the integer pipes
// (split_bf16), not by rounding conversions, which were slower on an
// H100.  The next tile's Q K^T and this tile's P V are issued together
// and the softmax of the next tile runs while P V is on the tensor cores
// (wgmma.commit_group / wait_group 1), so the exps overlap the products.
// A consumer passes over the ring's tiles in which none of its rows has a
// live key (it waits for the stage and releases it).  The O tile goes out
// through the consumer's q buffer and a TMA store, which clips rows past S
// and dims past hd.  Three consumers (192 q rows a K/V tile) at hd 64 were
// slower on an H100 at granite's shapes (160 registers a thread), and a
// fourth ring stage changed nothing.
//
// bf16, flash_mma_kernel: the route for tensors TMA cannot describe (hd
// % 8 != 0, or a base that is not 16-byte aligned; the host gives it
// contiguous tensors).  One block of four warps per (64-row q tile,
// head, batch), each warp 16 q rows; tiles staged element by element
// into XOR-swizzled shared memory, Q.K^T and P.V as mma.sync.m16n8k16 on
// ldmatrix operands (.trans for V), P in three bf16 parts as above.
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
// cg + 8 u) take P from the group's lanes by shuffle.  One block of four
// warps per (64-row q tile, head, batch), K/V through a cp.async ring.
//
// Bound on an H100.  At granite-3-2b's prefill (B 4, H 32, K 8, S 512,
// hd 64) the function moves 21 MB in bf16 (q, k, v read once, o written
// once: ~6.3 us at 3.35 TB/s) and does 4 * B * H * hd * S (S + 1) / 2 =
// 4.3 GFLOP of causal products (~4.4 us at the 989 TFLOP/s bf16 tensor
// rate), so bytes bound it at this S.  The wgmma kernel computes whole
// 64 x 64 tiles up to the diagonal (1.9e7 scores), and with P in three
// parts its tensor work is 2.4 GFLOP for Q.K^T and 7.2 for P.V: ~9.8 us
// at the full rate, which wgmma can reach, so the parts and not the
// bytes set this design's floor.  Its 1.9e7 exps take ~4.5 us on the SFU
// (16 per clock per SM at 1.98 GHz), beside the products; the softmax,
// the rescale and the parts' split take as many issue slots again.  With
// two consumer warps an SM sub-partition, these chains overlap the
// products only in part: the kernel runs at about a quarter of its
// tensor floor at this shape.  In f32 the
// function moves 42 MB (~12.5 us); as 3xTF32 its 3 x 4.3 GFLOP would take
// ~26 us at the 495 TFLOP/s dense TF32 rate, which bounds the function.
// The FMA kernel does the 4.3 GFLOP once on the 67 TFLOP/s FP32 pipes
// (~64 us, its own floor); its whole tiles to the diagonal are 4.8 GFLOP
// (~72 us), with the loads, shuffles and softmax on top in the same issue
// slots.
//
// C interface (loaded with ctypes): pointers and the stream as void*; the
// launchers return cudaGetLastError() as an int (or cudaErrorInvalidValue
// for a shape they do not take or a tensor map that does not encode).

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int BQ = 64;          // query rows per q tile
constexpr int BK = 64;          // keys per kv tile
constexpr int MMA_THREADS = 128;  // four warps, 16 q rows each
constexpr float LOG2E = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// (a, b) as three bf16 pairs whose sum is (a, b) exactly, by truncation:
// hi = the top 16 bits of each f32 (its sign, exponent and 8 significant
// bits), mid = the top 16 bits of the remainder (exact in f32, at most 16
// significant bits), lo = the rest (at most 8 significant bits, so its
// top 16 bits are all of it).  Masks and byte permutes on the integer
// pipes, no conversions.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& mid, uint32_t& lo) {
  const uint32_t ua = __float_as_uint(a), ub = __float_as_uint(b);
  const float ra = a - __uint_as_float(ua & 0xffff0000u);
  const float rb = b - __uint_as_float(ub & 0xffff0000u);
  const uint32_t va = __float_as_uint(ra), vb = __float_as_uint(rb);
  const float la = ra - __uint_as_float(va & 0xffff0000u);
  const float lb = rb - __uint_as_float(vb & 0xffff0000u);
  hi = __byte_perm(ua, ub, 0x7632);
  mid = __byte_perm(va, vb, 0x7632);
  lo = __byte_perm(__float_as_uint(la), __float_as_uint(lb), 0x7632);
}

// 2^x on the SFU alone (MUFU.EX2; results below 2^-126 flush to 0)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One tile's online softmax on the scores s of 64 keys [c0, c0 + 64) in
// the m16n8 accumulator layout (s[4 j + e]: row row_a for e < 2, row_b
// = row_a + 8 otherwise, key c0 + 8 j + 2 t + (e & 1); a row lives in
// one quad of lanes): scale into log2 units, mask (causal, band, keys
// past S), update the running max m and this thread's share l of the
// denominator, and leave the probabilities in s.  Returns each row's
// rescale factor of what was accumulated before, in al_a / al_b.  w0 is
// the warp's first row.
__device__ __forceinline__ void online_softmax(
    float (&s)[32], int c0, int w0, int row_a, int row_b, int t, int S,
    int window, float scale_log2, float& m_a, float& m_b, float& l_a,
    float& l_b, float& al_a, float& al_b) {
  const bool masked = c0 + BK - 1 > w0 || c0 + BK > S ||
                      (window > 0 && c0 <= w0 + 15 - window);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float val = s[4 * j + e] * scale_log2;
      if (masked) {
        const int col = c0 + 8 * j + 2 * t + (e & 1);
        const int row = e < 2 ? row_a : row_b;
        const bool live = col <= row && col < S &&
                          (window <= 0 || col > row - window);
        if (!live) val = -CUDART_INF_F;
      }
      s[4 * j + e] = val;
    }
  float mx_a = -CUDART_INF_F, mx_b = -CUDART_INF_F;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    mx_a = fmaxf(mx_a, fmaxf(s[4 * j], s[4 * j + 1]));
    mx_b = fmaxf(mx_b, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
  mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
  mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
  mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
  const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
  // a running max of -inf means "no live key yet": p = 0, alpha = 0
  const float base_a = mn_a == -CUDART_INF_F ? 0.f : mn_a;
  const float base_b = mn_b == -CUDART_INF_F ? 0.f : mn_b;
  al_a = exp2_ftz(m_a - base_a);
  al_b = exp2_ftz(m_b - base_b);
  m_a = mn_a;
  m_b = mn_b;
  l_a *= al_a;
  l_b *= al_b;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    s[4 * j] = exp2_ftz(s[4 * j] - base_a);
    s[4 * j + 1] = exp2_ftz(s[4 * j + 1] - base_a);
    s[4 * j + 2] = exp2_ftz(s[4 * j + 2] - base_b);
    s[4 * j + 3] = exp2_ftz(s[4 * j + 3] - base_b);
    l_a += s[4 * j] + s[4 * j + 1];
    l_b += s[4 * j + 2] + s[4 * j + 3];
  }
}

// P (the probabilities s of 64 keys, m16n8 accumulator layout) as three
// bf16 parts in the 16-key A-operand layout: part[4 kk + r] holds keys
// 16 kk .. 16 kk + 15 (two 8-key accumulator tiles make one A operand)
__device__ __forceinline__ void split_p(const float (&s)[32],
                                        uint32_t (&p)[3][16]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float* pr = s + 4 * (2 * kk + (r >> 1)) + 2 * (r & 1);
      split_bf16(pr[0], pr[1], p[0][4 * kk + r], p[1][4 * kk + r],
                 p[2][4 * kk + r]);
    }
}

// ---------------------------------------------------------------------------
// bf16 route for tensors TMA describes: wgmma on a TMA-fed K/V ring
// ---------------------------------------------------------------------------

constexpr int WG_THREADS = 128;  // a warpgroup
constexpr int NC = 2;            // consumer warpgroups, one q tile each
constexpr int WGMMA_THREADS = (NC + 1) * WG_THREADS;
constexpr int BOX_BYTES = 64 * 64 * 2;  // a TMA box: 64 rows of 64 bf16
// the producer hands back all but 24 registers a thread; a consumer
// thread takes 240 (O is 32, 64 or 96 of them at hd 64, 128, 192)
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;

// Shared memory of flash_wgmma_kernel, from a 1024-byte aligned base (the
// 128-byte swizzle repeats every 8 rows of 128 bytes): two q tiles for
// each consumer (the unit in hand and the next; a unit's O tile goes out
// through its q tile), RING K tiles, RING V tiles, then the mbarriers
// full[RING], empty[RING], qfull[NC][2] and qempty[NC][2], and the two
// units' descriptions (Work) that the producer hands the consumers beside
// their q tiles.  A tile is 64 rows of HD / 64 boxes side by side.  RING
// is 3, and 2 at hd 192, where three stages beside four q tiles would
// pass the 227 KB of a block.
struct Work {
  int q0[NC], head[NC], b, kt_lo, kt_hi;
};

template <int HD>
struct WgmmaSmem {
  static constexpr int RING = HD == 192 ? 2 : 3;
  static constexpr int BOXES = HD / 64;
  static constexpr int TILE = BOXES * BOX_BYTES;
  static constexpr int Q = 0;
  static constexpr int K = 2 * NC * TILE;
  static constexpr int V = K + RING * TILE;
  static constexpr int BAR = V + RING * TILE;
  static constexpr int WORK = BAR + 8 * (2 * RING + 4 * NC);
  static constexpr int BYTES = WORK + 2 * sizeof(Work) + 1024;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// wait until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// one box of a 4-D tensor map at (col, row, head, batch) into shared
// memory, completing on bar's transaction count
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A wgmma shared-memory descriptor for a tile in the 128-byte swizzle:
// the start address, the leading and stride byte offsets (16-byte units)
// and the swizzle mode (1 = 128 bytes)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pin registers that an asynchronous wgmma reads or writes: the compiler
// may neither move their other uses across this point nor reuse them
// while the product is in flight.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void reg_fence(uint32_t (&r)[3][16]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 16; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// d (64 x 64, f32) (+)= A (64 x 16) * B (16 x 64), A and B K-major in
// shared memory (descriptors); scale_d == 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64, f32) += A (64 x 16, bf16 in registers) * B (16 x 64), B
// MN-major (transposed) in shared memory
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128, f32) += A (64 x 16, bf16 in registers) * B (16 x 128), B
// MN-major (transposed) in shared memory
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 192, f32) += A (64 x 16, bf16 in registers) * B (16 x 192), B
// MN-major (transposed) in shared memory
__device__ __forceinline__ void wgmma_rs_n192(float (&d)[96],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// S (64 x 64 keys) = Q K^T over HD: both tiles K-major in boxes of 64
// columns; a 16-wide step is 32 bytes into a box's 128-byte rows
template <int HD>
__device__ __forceinline__ void wgmma_qk(float (&s)[32], uint32_t q_s,
                                         uint32_t k_s) {
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    const uint32_t off = (ks / 4) * BOX_BYTES + (ks % 4) * 32;
    wgmma_ss_n64(s, sw128_desc(q_s + off, 16, 1024),
                 sw128_desc(k_s + off, 16, 1024), ks > 0);
  }
}

// O (64 x HD) += P V, P's three parts 16 keys at a time, one m64nHDk16
// a step; V is B transposed (MN-major): 8 keys of 128-byte rows make a
// 1024-byte swizzle atom (the stride byte offset), and the boxes across
// HD lie BOX_BYTES apart (the leading byte offset)
template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&o)[HD / 2],
                                         uint32_t (&p)[3][16],
                                         uint32_t v_s) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int part = 0; part < 3; ++part) {
      const uint32_t(&a)[4] =
          *reinterpret_cast<const uint32_t(*)[4]>(&p[part][4 * kk]);
      const uint64_t db = sw128_desc(v_s + kk * 2048, BOX_BYTES, 1024);
      if constexpr (HD == 64) wgmma_rs_n64(o, a, db);
      if constexpr (HD == 128) wgmma_rs_n128(o, a, db);
      if constexpr (HD == 192) wgmma_rs_n192(o, a, db);
    }
}

// A unit: NC 64-row q tiles (items) that read kv head kvh of batch b
// over the same K/V tiles.  The items of a kv head are its G q heads
// times its row tiles, head fastest, so a unit takes heads of one GQA
// group on the same rows where NC divides G, and neighbouring row tiles
// where G = 1; the last unit of a kv head may hold fewer (a slot with q0
// = S has no rows).  The unit's K/V tiles kt_lo .. kt_hi are the union of
// its items' live ones.  Units are numbered from the last rows (the
// longest loops first); within that, the R = G / NC units of a kv head
// on one row tile (1 unless NC divides G) come one after another, then
// the kv heads, then the batch rows.
struct Unit : Work {
  int kvh;
};

__host__ __device__ __forceinline__ int units_per_kv_head(int G, int S) {
  return (G * ((S + BQ - 1) / BQ) + NC - 1) / NC;
}

__device__ __forceinline__ Unit unit_at(int u, int K, int B, int G, int S,
                                        int window) {
  const int R = G % NC == 0 ? G / NC : 1;
  const int per = units_per_kv_head(G, S);
  const int rest = u / R;
  Unit w;
  w.kvh = rest % K;
  w.b = rest / K % B;
  const int j = (per / R - 1 - rest / (K * B)) * R + u % R;
  int last = 0;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int i = NC * j + c;
    const bool any = i < G * ((S + BQ - 1) / BQ);
    w.head[c] = w.kvh * G + (any ? i % G : 0);
    w.q0[c] = any ? i / G * BQ : S;
    if (any) last = w.q0[c];
  }
  w.kt_lo = window > 0 ? max(0, w.q0[0] - window + 1) / BK : 0;
  w.kt_hi = (min(last + BQ, S) - 1) / BK;
  return w;
}

// The n-th unit of this block: a persistent grid walks the units in
// rounds of gridDim.x, every other round backwards (a snake, so that the
// blocks' shares of long and short loops even out); -1 past the last.
__device__ __forceinline__ int nth_unit(int n, int units) {
  const int u = n * gridDim.x +
                (n & 1 ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
  return u < units ? u : -1;
}

// A persistent block per SM walks its units (nth_unit).  One producer
// thread decodes each unit and hands it to the consumers: once they have
// released buffer n & 1 (qempty), it writes the unit's description there
// and loads the unit's q tiles into it (qfull), then loads the unit's K/V
// tiles into the ring: ring slot i (counted across units)
// is stage i % RING, its i / RING-th fill, loaded once both consumers
// released the stage's previous fill (empty).  So the next unit's loads
// run under this unit's last tiles and epilogue.  Consumer c takes item c
// of every unit.
template <int HD>
__global__ void __launch_bounds__(WGMMA_THREADS, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const __grid_constant__ CUtensorMap map_o, int G, int S,
                       int window, float scale_log2, int K, int B,
                       int units) {
  using L = WgmmaSmem<HD>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* const gbase = smem_raw + (base - raw);
  // barriers: full[RING], empty[RING], qfull[c][buf], qempty[c][buf]
  const uint32_t full = base + L::BAR, empty = full + 8 * L::RING,
                 qfull = empty + 8 * L::RING, qempty = qfull + 16 * NC;
  const int wg = threadIdx.x / WG_THREADS;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::RING; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * NC);  // lane 0 of each consumer warp
    }
    for (int i = 0; i < 2 * NC; ++i) {
      mbar_init(qfull + 8 * i, 1);
      mbar_init(qempty + 8 * i, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // the producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      int slot = 0;
      for (int n = 0, u; (u = nth_unit(n, units)) >= 0; ++n) {
        const Unit w = unit_at(u, K, B, G, S, window);
        const int buf = n & 1;
        // the buffers' unit n - 2 stored its O tiles and let go of them
        if (n >= 2)
          for (int c = 0; c < NC; ++c)
            mbar_wait(qempty + 8 * (2 * c + buf), (n / 2 - 1) & 1);
        *reinterpret_cast<Work*>(gbase + L::WORK + buf * sizeof(Work)) = w;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const uint32_t qf = qfull + 8 * (2 * c + buf);
          if (w.q0[c] >= S) {  // no rows: complete the phase with no load
            mbar_arrive(qf);
            continue;
          }
          mbar_expect_tx(qf, L::TILE);
          for (int x = 0; x < L::BOXES; ++x)
            tma_load(base + L::Q + (2 * c + buf) * L::TILE + x * BOX_BYTES,
                     &map_q, qf, 64 * x, w.q0[c], w.head[c], w.b);
        }
        for (int kt = w.kt_lo; kt <= w.kt_hi; ++kt, ++slot) {
          const int st = slot % L::RING;
          // the stage's previous fill released by both consumers
          if (slot >= L::RING)
            mbar_wait(empty + 8 * st, (slot / L::RING - 1) & 1);
          mbar_expect_tx(full + 8 * st, 2 * L::TILE);
          for (int x = 0; x < L::BOXES; ++x) {
            tma_load(base + L::K + st * L::TILE + x * BOX_BYTES, &map_k,
                     full + 8 * st, 64 * x, kt * BK, w.kvh, w.b);
            tma_load(base + L::V + st * L::TILE + x * BOX_BYTES, &map_v,
                     full + 8 * st, 64 * x, kt * BK, w.kvh, w.b);
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int c = wg - 1;
    const int tid = threadIdx.x - wg * WG_THREADS;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, tq = lane & 3;
    // a ring slot with no live key for this tile: wait for it, release it
    auto pass = [&](int i) {
      mbar_wait(full + 8 * (i % L::RING), (i / L::RING) & 1);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * (i % L::RING));
    };
    int slot = 0;
    for (int n = 0; nth_unit(n, units) >= 0; ++n) {
      const int buf = n & 1;
      const uint32_t q_s = base + L::Q + (2 * c + buf) * L::TILE;
      // the unit's description comes with the q tile
      mbar_wait(qfull + 8 * (2 * c + buf), (n / 2) & 1);
      const Work& wk =
          *reinterpret_cast<const Work*>(gbase + L::WORK + buf * sizeof(Work));
      const int qc = wk.q0[c], hc = wk.head[c], b = wk.b;
      const int kt_lo = wk.kt_lo, kt_hi = wk.kt_hi;
      // this tile's live kv tiles lo .. hi (none for a tile past S)
      int lo = kt_hi + 1, hi = kt_hi;
      if (qc < S) {
        lo = window > 0 ? max(0, qc - window + 1) / BK : 0;
        hi = (min(qc + BQ, S) - 1) / BK;
      }
      if (qc >= S) {
        // every thread has read the description before it is let go
        asm volatile("bar.sync %0, %1;\n" ::"r"(1 + c), "n"(WG_THREADS)
                     : "memory");
        if (tid == 0) mbar_arrive(qempty + 8 * (2 * c + buf));
        for (int kt = kt_lo; kt <= kt_hi; ++kt) pass(slot++);
        continue;
      }
      for (int kt = kt_lo; kt < lo; ++kt) pass(slot++);
      const int w0 = qc + 16 * warp;  // this warp's first row
      const int row_a = w0 + g, row_b = row_a + 8;
      float o[HD / 2];
#pragma unroll
      for (int j = 0; j < HD / 2; ++j) o[j] = 0.f;
      float s[32];
      uint32_t p[3][16];
      float m_a = -CUDART_INF_F, m_b = -CUDART_INF_F;  // log2 units
      float l_a = 0.f, l_b = 0.f;  // this thread's share of the sums
      float al_a, al_b;

      // the first live tile: S, its softmax and P
      int st = slot % L::RING;
      mbar_wait(full + 8 * st, (slot / L::RING) & 1);
      wgmma_fence();
      wgmma_qk<HD>(s, q_s, base + L::K + st * L::TILE);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(s);
      online_softmax(s, lo * BK, w0, row_a, row_b, tq, S, window,
                     scale_log2, m_a, m_b, l_a, l_b, al_a, al_b);
      split_p(s, p);
      for (int kt = lo + 1; kt <= hi; ++kt) {
        const int prev = st;
        st = (++slot) % L::RING;
        mbar_wait(full + 8 * st, (slot / L::RING) & 1);
        // this tile's S and the previous tile's P V in flight together
        reg_fence(s);
        reg_fence(o);
        reg_fence(p);
        wgmma_fence();
        wgmma_qk<HD>(s, q_s, base + L::K + st * L::TILE);
        wgmma_commit();
        wgmma_pv<HD>(o, p, base + L::V + prev * L::TILE);
        wgmma_commit();
        wgmma_wait<1>();  // S done; the softmax runs beside P V
        reg_fence(s);
        online_softmax(s, kt * BK, w0, row_a, row_b, tq, S, window,
                       scale_log2, m_a, m_b, l_a, l_b, al_a, al_b);
        wgmma_wait<0>();
        reg_fence(o);
        reg_fence(p);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * prev);
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          o[4 * j] *= al_a;
          o[4 * j + 1] *= al_a;
          o[4 * j + 2] *= al_b;
          o[4 * j + 3] *= al_b;
        }
        split_p(s, p);
      }
      reg_fence(o);
      reg_fence(p);
      wgmma_fence();
      wgmma_pv<HD>(o, p, base + L::V + st * L::TILE);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(o);
      reg_fence(p);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * st);
      ++slot;

      // epilogue: finish the denominators across the quad, write the O
      // tile in bf16 over this tile's q buffer in the boxes' swizzled
      // layout (16-byte chunk index XOR-ed with row % 8), then one TMA
      // store per box (rows past S and dims past hd are clipped); the
      // buffer is released once the store has read it
      l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
      l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
      const float inv_a = l_a > 0.f ? 1.f / l_a : 0.f;
      const float inv_b = l_b > 0.f ? 1.f / l_b : 0.f;
      unsigned char* const og = gbase + (q_s - base);
      const int ra = 16 * warp + g, rb = ra + 8;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        const int box = j / 8, ch = j % 8;
        *reinterpret_cast<uint32_t*>(og + box * BOX_BYTES + ra * 128 +
                                     ((ch ^ g) << 4) + 4 * tq) =
            pack_bf16(o[4 * j] * inv_a, o[4 * j + 1] * inv_a);
        *reinterpret_cast<uint32_t*>(og + box * BOX_BYTES + rb * 128 +
                                     ((ch ^ g) << 4) + 4 * tq) =
            pack_bf16(o[4 * j + 2] * inv_b, o[4 * j + 3] * inv_b);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + c), "n"(WG_THREADS)
                   : "memory");
      if (tid == 0) {
        for (int x = 0; x < L::BOXES; ++x)
          tma_store(&map_o, q_s + x * BOX_BYTES, 64 * x, qc, hc, b);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        mbar_arrive(qempty + 8 * (2 * c + buf));
      }
      for (int kt = hi + 1; kt <= kt_hi; ++kt) pass(slot++);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 route for the rest: mma.sync on element-wise staged tiles
// ---------------------------------------------------------------------------

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

// Rows [r0, r0 + 64) x [0, HD) of an (S, hd) head slice into a swizzled
// tile, element by element, 0 past S and past hd.
template <int HD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* __restrict__ src,
                                          int r0, int S, int hd) {
  for (int i = threadIdx.x; i < 64 * HD; i += MMA_THREADS) {
    const int r = i / HD, d = i % HD;
    bf16 val = __float2bfloat16(0.f);
    if (r0 + r < S && d < hd) val = src[(long long)(r0 + r) * hd + d];
    dst[swz<HD>(r, d >> 3) + (d & 7)] = val;
  }
}

template <int HD>
__global__ void __launch_bounds__(MMA_THREADS)
    flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     int H, int G, int S, int hd, int window,
                     float scale_log2) {
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

  load_tile<HD>(q_s, qh, q0, S, hd);
  load_tile<HD>(k_s, kh, kt_lo * BK, S, hd);
  load_tile<HD>(v_s, vh, kt_lo * BK, S, hd);

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
    __syncthreads();  // tile kt landed; tile kt - 1's stage is free
    if (kt < kt_hi) {
      load_tile<HD>(k_s + (st ^ 1) * BK * HD, kh, (kt + 1) * BK, S, hd);
      load_tile<HD>(v_s + (st ^ 1) * BK * HD, vh, (kt + 1) * BK, S, hd);
    }
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
    float s[4 * NT];
#pragma unroll
    for (int j = 0; j < 4 * NT; ++j) s[j] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int p = 0; p < NT / 2; ++p) {
        uint32_t kb[4];
        ldsm_x4(kb, smem_u32(kst + swz<HD>(p * 16 + (lane & 7) +
                                               ((lane >> 4) << 3),
                                           2 * ks + ((lane >> 3) & 1))));
        mma_bf16(*reinterpret_cast<float(*)[4]>(&s[8 * p]), qf[ks], kb[0],
                 kb[1]);
        mma_bf16(*reinterpret_cast<float(*)[4]>(&s[8 * p + 4]), qf[ks],
                 kb[2], kb[3]);
      }
    }
    float al_a, al_b;
    online_softmax(s, c0, w0, row_a, row_b, t, S, window, scale_log2, m_a,
                   m_b, l_a, l_b, al_a, al_b);
#pragma unroll
    for (int j = 0; j < OT; ++j) {
      acc[j][0] *= al_a;
      acc[j][1] *= al_a;
      acc[j][2] *= al_b;
      acc[j][3] *= al_b;
    }

    // O += P V: two score tiles make one A operand of 16 keys, P in its
    // three bf16 parts, three mma per tile
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pp[3][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float* pr = s + 4 * (2 * kk + (r >> 1)) + 2 * (r & 1);
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
  // 16 rows of O in its own rows of q_s, then write them out
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
    for (int d = 0; d < 8 && c * 8 + d < hd; ++d) dst[d] = src[d];
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
               int H, int K, int S, int hd, int window, float scale,
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
      window, scale * LOG2E);
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

// cuTensorMapEncodeTiled, fetched through the CUDA runtime so that the
// library needs no -lcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A bf16 tensor map of dims (hd, S, heads, B), byte strides of S, heads
// and B, 64 x 64 boxes in the 128-byte swizzle, zeros out of bounds
bool encode_map(CUtensorMap* map, const void* ptr,
                const unsigned long long* dims,
                const unsigned long long* strides) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t gdim[4] = {dims[0], dims[1], dims[2], dims[3]};
  const cuuint64_t gstride[3] = {strides[0], strides[1], strides[2]};
  const cuuint32_t box[4] = {64, 64, 1, 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            gdim, gstride, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// SMs of the current device, asked once
int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n > 0 ? n : 1;
}

template <int HD>
int launch_wgmma(const void* const* ptrs, const unsigned long long* dims,
                 const unsigned long long* strides, int window, float scale,
                 cudaStream_t stream) {
  using L = WgmmaSmem<HD>;
  CUtensorMap maps[4];
  for (int i = 0; i < 4; ++i)
    if (!encode_map(&maps[i], ptrs[i], dims + 4 * i, strides + 3 * i))
      return (int)cudaErrorInvalidValue;
  const int S = (int)dims[1], H = (int)dims[2], B = (int)dims[3];
  const int K = (int)dims[6], G = H / K;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::BYTES);
  if (err != cudaSuccess) return (int)err;
  const int units = K * B * units_per_kv_head(G, S);
  const int grid = units < sm_count() ? units : sm_count();
  flash_wgmma_kernel<HD><<<grid, WGMMA_THREADS, L::BYTES, stream>>>(
      maps[0], maps[1], maps[2], maps[3], G, S, window, scale * LOG2E, K, B,
      units);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (flash_fma_kernel), 1 = bfloat16 (flash_mma_kernel,
// element by element); q, k, v and o share it and are contiguous.  vec
// (f32 only): 1 = 16-byte cp.async copies, which need 16-byte aligned
// q/k/v/o and hd % 4 == 0; 0 = element-wise staging in the same kernel.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int dtype,
                                      int B, int H, int K, int S, int hd,
                                      int window, float scale, int vec,
                                      void* stream) {
  if (B < 1 || K < 1 || H % K || S < 1 || hd < 1 || hd > 192 ||
      H > 65535 || B > 65535 || (dtype != 0 && dtype != 1) ||
      (vec && (dtype != 0 || hd % 4)))
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
    return launch_mma<64>(q, k, v, o, B, H, K, S, hd, window, scale, st);
  if (hd <= 128)
    return launch_mma<128>(q, k, v, o, B, H, K, S, hd, window, scale, st);
  return launch_mma<192>(q, k, v, o, B, H, K, S, hd, window, scale, st);
}

// bf16 q, k, v and o of any strides that TMA takes (flash_wgmma_kernel):
// dims[4 i ..] = (hd, S, heads, B) and strides[3 i ..] = the byte strides
// of S, heads and B of q, k, v, o (i = 0 .. 3), as
// repro_torch.kernels.flash_attention.tma_plan gives them.
extern "C" int flash_wgmma_launch(const void* q, const void* k,
                                  const void* v, void* o,
                                  const unsigned long long* dims,
                                  const unsigned long long* strides,
                                  int window, float scale, void* stream) {
  const unsigned long long hd = dims[0], S = dims[1], H = dims[2],
                           B = dims[3], K = dims[6];
  bool ok = hd >= 1 && hd <= 192 && hd % 8 == 0 && S >= 1 && K >= 1 &&
            H % K == 0 && B >= 1 && H * B * ((S + BQ - 1) / BQ) < (1u << 30);
  for (int i = 1; i < 4; ++i)  // k and v as (hd, S, K, B), o as q
    for (int d = 0; d < 4; ++d)
      ok = ok && dims[4 * i + d] == (d == 2 && i < 3 ? K : dims[d]);
  if (!ok) return (int)cudaErrorInvalidValue;
  const void* const ptrs[4] = {q, k, v, o};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd <= 64) return launch_wgmma<64>(ptrs, dims, strides, window, scale, st);
  if (hd <= 128)
    return launch_wgmma<128>(ptrs, dims, strides, window, scale, st);
  return launch_wgmma<192>(ptrs, dims, strides, window, scale, st);
}
