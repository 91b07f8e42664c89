// Fleet-scale MAIZ ranking (Eq. 2 + Eq. 1 + tile top-k) for Hopper (sm_90a).
//
// Replaces the four Pallas TPU kernels of src/repro/kernels/maizx_rank.py:
//   K1 maiz_lohi    <- _lohi_kernel    (sweep 1: the masked min/max of each
//                                       Eq. 1 term over the valid nodes,
//                                       the (R, 2) normalizers, folded in
//                                       the kernel)
//   K2 maiz_topk    <- _topk_kernel    (sweep 2: normalized weighted score
//                                       per node + tile-local top-k in
//                                       (score, index) order: the k rounds
//                                       of lexicographic argmin, computed
//                                       by a sort and merge)
//   K3 maiz_lohi_b  <- _lohi_kernel_b  (K1 over a leading lane axis, a
//                                       per-lane en block)
//   K4 maiz_topk_b  <- _topk_kernel_b  (K2 over a leading lane axis, a
//                                       per-lane lohi, shared weights)
//
// Layout of K2/K4: one block per 1024-node tile (the TPU kernel's (8, 128)
// block), TPB = 256 threads, each owning NPT = 4 nodes at stride TPB so
// every load is coalesced.  Nothing carries over between blocks, so the
// grid order is free (the TPU grid's sequential order was never relied
// on).  The batched kernels put the lane on blockIdx.y: each block offsets
// its stream, en, lohi and output pointers by its lane, so lane l computes
// exactly what K1/K2 compute on lane l's arrays (one launch for all lanes
// instead of L).
//
// Bound on an H100: both sweeps stream each node input once.  K1 reads 24
// B/node (36 with the marginal streams pk/cap/ct) and writes only the
// (R, 2) result and a few partials; K2 reads the same and writes 4 B/node
// of scores plus nt x k candidates.  At N = 1,048,576 that is 25-38 MB,
// ~7.5-12.5 us at 3.35 TB/s: device-memory bytes bound both sweeps.
//
// K1/K3's sweep, one launch per call.  A per-tile grid (1,024 blocks at
// N = 1,048,576) is a single wave in which no block's reduction overlaps
// another's loads, and its (nt, R) partials needed three more launches to
// fold.  Here each thread owns 4 consecutive nodes of a 1024-node chunk
// and reads each stream with one 16-byte read-only load (ld.global.nc.v4),
// all 6 (9) loads issued before any arithmetic; a full chunk takes a
// branch-free path and only the chunk that holds n_valid masks nodes.
// The grid is persistent (the resident blocks, split over the lanes):
// each block strides over the chunks with its running min/max in
// registers and reduces once.  One thread per block writes the block's
// (R, 2) partial and takes its lane's atomic ticket (acquire-release);
// the lane's last block folds the partials into the (R, 2) result and
// resets the ticket, so a launch needs no fold launch and no memset.  The
// tickets live between launches, one buffer per (device, stream) so that
// no two streams share one.  (Folding with atomic min/max into one shared
// line instead was slower: ~800 blocks contend for it.)  The same
// template with the fold off writes one (R) lo/hi partial per tile
// (maiz_lohi_tiles, held against the twin tile by tile).
//
// K2's selection.  The reference extracts the tile's top-k in k rounds of
// a block-wide (score, index) argmin; as a chain of k block reductions (two
// barriers each, ~1 us a round) that was latency bound, 85 us at k = 64
// against the 8.9 us byte bound.  Here each node becomes one 64-bit key
// (the score's bits mapped to an unsigned order, -0.0 as +0.0, the
// tile-local index below), each warp sorts its 128 keys in registers with
// a bitonic network (shuffles, no barrier), and three merge levels through
// shared memory, one barrier each, keep the first k of the eight warp
// lists.  The cost barely depends on k, so k reaches 128 (one warp list;
// the reference caps k at 64).  The k-round rule for a tile with fewer
// than k finite scores is kept: every rank whose score is +inf gets
// tile-local index 0.  k = 1 (the fused ranking) stays one argmin round.
//
// Exactness: built with -fmad=false and IEEE division, every value is
// rounded after each operation in the order the reference writes them, so
// the kernel computes bit for bit what the plain torch twin
// (repro_torch/kernels/maizx_rank.py) computes.  Min/max do not depend on
// order but for the sign of zero, which compares equal: K1/K3 take min and
// max on an order-preserving integer image of the f32 bits in which -0.0
// lies below +0.0 (IEEE 754-2019 minimum/maximum), so the result does not
// depend on the fold order; the twin's fold (fold_lohi) orders the zeros
// the same way.  Ties break toward the lower node index, as jnp.argmin
// does.
//
// C interface (loaded with ctypes): pointers and the stream as void*, each
// launcher returns cudaGetLastError() as an int.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int TILE = 1024;
constexpr int TPB = 256;
constexpr int NPT = TILE / TPB;
constexpr int WARPS = TPB / 32;
constexpr int MAX_R = 5;
constexpr float BIG = 3e38f;  // finite sentinel of masked min/max (_BIG)

struct Streams {
  const float* ec;
  const float* pue;
  const float* ci;
  const float* fc;
  const float* eff;
  const float* sw;
  const float* pk;   // marginal streams: null unless r == 5
  const float* cap;
  const float* ct;
};

// The Eq. 1 terms of one node in the reference's op order (_tile_terms,
// _tile_mcfp), from its stream values; R = 5 adds the marginal CFP, with
// en = [idle_frac, dyn_frac, embodied*horizon, w_marginal].
template <int R>
__device__ __forceinline__ void terms_of(float ec, float pue, float ci,
                                         float fc, float eff, float sw,
                                         float pk, float cap, float ct,
                                         float en0, float en1, float en2,
                                         float* t) {
  const float base = ec * pue;
  t[0] = base * ci;
  t[1] = base * fc;
  t[2] = eff;
  t[3] = sw;
  if constexpr (R == 5) {
    float an = pk * pue;
    an = an * ci;
    const float inv = 1.0f / fmaxf(ct, 1.0f);
    const float m_dyn = (an * inv) * en1;
    const float m_wake = an * en0 + en2;
    t[4] = m_dyn + (cap == ct ? m_wake : 0.0f);
  }
}

// The terms of node i, read from the streams (K2/K4).
__device__ __forceinline__ void node_terms(const Streams& s, int64_t i, int r,
                                           const float* en, float* t) {
  if (r == 5)
    terms_of<5>(s.ec[i], s.pue[i], s.ci[i], s.fc[i], s.eff[i], s.sw[i],
                s.pk[i], s.cap[i], s.ct[i], en[0], en[1], en[2], t);
  else
    terms_of<4>(s.ec[i], s.pue[i], s.ci[i], s.fc[i], s.eff[i], s.sw[i],
                0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, t);
}

// The lane's view of the node streams: every stream (L, n) row-major, so
// lane l starts at l * n.  Absent marginal streams stay null.
__device__ __forceinline__ Streams lane_streams(Streams s, int64_t off) {
  return Streams{s.ec + off, s.pue + off, s.ci + off, s.fc + off,
                 s.eff + off, s.sw + off, s.pk ? s.pk + off : nullptr,
                 s.cap ? s.cap + off : nullptr, s.ct ? s.ct + off : nullptr};
}

// An order-preserving map of f32 bits to int (an involution): min/max of
// the images are min/max of the values, with -0.0 (image -1) below +0.0
// (image 0), whatever the order of the operands.
__device__ __forceinline__ int okey(float x) {
  const int b = __float_as_int(x);
  return b ^ ((b >> 31) & 0x7fffffff);
}

__device__ __forceinline__ float unkey(int k) {
  return __int_as_float(k ^ ((k >> 31) & 0x7fffffff));
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float comp(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// Fold node e of a thread's four (loaded as v[stream]) into the running
// term images; a masked node leaves them as they are.
template <int R>
__device__ __forceinline__ void take(const float4 (&v)[9], int e, bool valid,
                                     float en0, float en1, float en2,
                                     int (&klo)[R], int (&khi)[R]) {
  float t[R];
  terms_of<R>(comp(v[0], e), comp(v[1], e), comp(v[2], e), comp(v[3], e),
              comp(v[4], e), comp(v[5], e), comp(v[6], e), comp(v[7], e),
              comp(v[8], e), en0, en1, en2, t);
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int k = okey(t[q]);
    klo[q] = valid ? min(klo[q], k) : klo[q];
    khi[q] = valid ? max(khi[q], k) : khi[q];
  }
}

// Block-wide min of klo and max of khi into out[0..R) (lo) and
// out[R..2R) (hi), both in shared memory; every thread reads out after the
// call.
template <int R>
__device__ __forceinline__ void block_lohi(int (&klo)[R], int (&khi)[R],
                                           int (*red)[WARPS], int* out) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int q = 0; q < R; ++q) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      klo[q] = min(klo[q], __shfl_xor_sync(0xffffffffu, klo[q], off));
      khi[q] = max(khi[q], __shfl_xor_sync(0xffffffffu, khi[q], off));
    }
    if (lane == 0) {
      red[q][warp] = klo[q];
      red[R + q][warp] = khi[q];
    }
  }
  __syncthreads();
  if (tid < 2 * R) {
    int a = red[tid][0];
    for (int w = 1; w < WARPS; ++w)
      a = tid < R ? min(a, red[tid][w]) : max(a, red[tid][w]);
    out[tid] = a;
  }
  __syncthreads();
}

// K1 (grid (G, 1)) and K3 (grid (G, L), the lane on blockIdx.y: streams
// (L, n), en (L, 4)).  Block b sweeps chunks b, b + G, ... of the lane's
// first `nchunks` 1024-node chunks.
//   FOLD: G is the persistent grid; each block writes its partial images
//     part[lane][b][2R] and takes a ticket[lane]; the lane's last block
//     folds the partials into out[lane][R][2] (lo, hi) and resets the
//     ticket to 0.
//   !FOLD: G = nchunks = nt tiles; block b writes tile b's lo/hi[lane][b][R]
//     (maiz_lohi_tiles).
template <int R, bool FOLD>
__global__ void __launch_bounds__(TPB)
lohi_kernel(Streams s, const float* __restrict__ en, int64_t n,
            int64_t n_valid, int nchunks, float* __restrict__ lo,
            float* __restrict__ hi, int* part, unsigned* ticket,
            float* __restrict__ out) {
  const int tid = threadIdx.x;
  const int64_t lane = blockIdx.y;
  s = lane_streams(s, lane * n);
  float en0 = 0.0f, en1 = 0.0f, en2 = 0.0f;
  if constexpr (R == 5) {
    en0 = en[lane * 4];
    en1 = en[lane * 4 + 1];
    en2 = en[lane * 4 + 2];
  }
  int klo[R], khi[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    klo[q] = okey(BIG);
    khi[q] = okey(-BIG);
  }
  for (int c = blockIdx.x; c < nchunks; c += gridDim.x) {
    const int64_t i0 = (int64_t)c * TILE + NPT * tid;
    // every load first: 6 (9) independent 16-byte loads in flight
    float4 v[9];
    v[0] = ldg4(s.ec + i0);
    v[1] = ldg4(s.pue + i0);
    v[2] = ldg4(s.ci + i0);
    v[3] = ldg4(s.fc + i0);
    v[4] = ldg4(s.eff + i0);
    v[5] = ldg4(s.sw + i0);
    if constexpr (R == 5) {
      v[6] = ldg4(s.pk + i0);
      v[7] = ldg4(s.cap + i0);
      v[8] = ldg4(s.ct + i0);
    } else {
      v[6] = v[7] = v[8] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    if ((int64_t)(c + 1) * TILE <= n_valid) {  // a full chunk: no mask
#pragma unroll
      for (int e = 0; e < NPT; ++e)
        take<R>(v, e, true, en0, en1, en2, klo, khi);
    } else {                                   // the chunk of n_valid
#pragma unroll
      for (int e = 0; e < NPT; ++e)
        take<R>(v, e, i0 + e < n_valid, en0, en1, en2, klo, khi);
    }
  }
  __shared__ int red[2 * MAX_R][WARPS];
  __shared__ int res[2 * MAX_R];
  block_lohi<R>(klo, khi, red, res);
  if constexpr (!FOLD) {
    if (tid == 0) {
      const int64_t o = (lane * gridDim.x + blockIdx.x) * R;
#pragma unroll
      for (int q = 0; q < R; ++q) {
        lo[o + q] = unkey(res[q]);
        hi[o + q] = unkey(res[R + q]);
      }
    }
    return;
  }
  __shared__ int is_last;
  if (tid == 0) {
    // one thread writes the block's partial images and takes a ticket
    // with release semantics (the partial is visible first) and acquire
    // semantics (so is every earlier block's)
    int* mine = part + (lane * gridDim.x + blockIdx.x) * 2 * R;
#pragma unroll
    for (int q = 0; q < 2 * R; ++q) mine[q] = res[q];
    unsigned old;
    asm volatile("atom.acq_rel.gpu.add.u32 %0, [%1], 1;"
                 : "=r"(old)
                 : "l"(ticket + lane)
                 : "memory");
    is_last = old == gridDim.x - 1;
  }
  __syncthreads();
  if (!is_last) return;
  // the lane's last block: fold every block's partial (read from L2)
#pragma unroll
  for (int q = 0; q < R; ++q) {
    klo[q] = okey(BIG);
    khi[q] = okey(-BIG);
  }
  const int* lp = part + lane * gridDim.x * 2 * R;
  for (int b = tid; b < (int)gridDim.x; b += TPB) {
#pragma unroll
    for (int q = 0; q < R; ++q) {
      klo[q] = min(klo[q], __ldcg(lp + b * 2 * R + q));
      khi[q] = max(khi[q], __ldcg(lp + b * 2 * R + R + q));
    }
  }
  block_lohi<R>(klo, khi, red, res);
  if (tid < R) {
    out[(lane * R + tid) * 2] = unkey(res[tid]);
    out[(lane * R + tid) * 2 + 1] = unkey(res[R + tid]);
  }
  if (tid == 0) ticket[lane] = 0u;    // ready for the next launch
}

// (score, tile-local index) lexicographic min: the reference's
// m = min(cur); pos = min(fid where cur == m).
__device__ __forceinline__ void lex_min(float& s, int& p, float s2, int p2) {
  if (s2 < s || (s2 == s && p2 < p)) {
    s = s2;
    p = p2;
  }
}

using u64 = unsigned long long;
constexpr int WARP_LIST = 32 * NPT;  // keys a warp sorts: the tile-k cap

// A node's selection key: an order-preserving map of its score's f32 bits
// in the high word (-0.0 first becomes +0.0, which lex_min treats as
// equal), its tile-local index in the low word.  Keys are distinct, and
// their unsigned order is lex_min's (score, index) order.
__device__ __forceinline__ u64 sort_key(float sc, int idx) {
  uint32_t u = __float_as_uint(sc == 0.0f ? 0.0f : sc);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((u64)u << 32) | (uint32_t)idx;
}

// Sort a warp's 128 keys ascending in registers: a bitonic network over
// the element e = lane * NPT + j, one step per (SIZE, STRIDE), unrolled by
// template recursion so that key[] stays in registers.  Strides 1 and 2
// pair a thread's own registers; strides 4-64 pair lanes through
// shuffles.  No barrier.
template <int SIZE, int STRIDE>
__device__ __forceinline__ void bitonic_step(u64 (&key)[NPT], int lane) {
#pragma unroll
  for (int j = 0; j < NPT; ++j) {
    const bool up = ((lane * NPT + j) & SIZE) == 0;  // an ascending run
    if constexpr (STRIDE >= NPT) {
      constexpr int mask = STRIDE / NPT;
      const u64 o = __shfl_xor_sync(0xffffffffu, key[j], mask);
      // the lower element of a pair keeps the min of an ascending run
      const bool keep_min = ((lane & mask) == 0) == up;
      key[j] = (o < key[j]) == keep_min ? o : key[j];
    } else if (!(j & STRIDE)) {
      u64& a = key[j];
      u64& b = key[j | STRIDE];
      if ((b < a) == up) {
        const u64 x = a;
        a = b;
        b = x;
      }
    }
  }
  if constexpr (STRIDE > 1)
    bitonic_step<SIZE, STRIDE / 2>(key, lane);
  else if constexpr (SIZE < WARP_LIST)
    bitonic_step<2 * SIZE, SIZE>(key, lane);
}

// One merge level: src holds `lists` sorted lists of k keys; pairs of them
// merge into lists / 2 lists of their first k keys in dst.  A key's place
// in the merged list is its place in its own list plus the number of keys
// of the other list below it (binary search, 8 steps for k <= 128).
__device__ __forceinline__ void merge_level(const u64* src, u64* dst,
                                            int lists, int k) {
  for (int i = threadIdx.x; i < lists * k; i += TPB) {
    const int list = i / k, pos = i - list * k;
    const u64 x = src[i];
    const u64* other = src + (list ^ 1) * k;
    int below = 0;
#pragma unroll
    for (int step = WARP_LIST; step > 0; step >>= 1)
      if (below + step <= k && other[below + step - 1] < x) below += step;
    if (pos + below < k) dst[(list >> 1) * k + pos + below] = x;
  }
}

// BATCHED = false is K2 (grid (nt, 1)); true is K4 (grid (nt, L), lane on
// blockIdx.y, en (L, 4), lohi (L, r, 2), scores (L, n), tmin/targ
// (L, nt, k); the weights are shared).  targ holds lane-local node ids.
// k <= WARP_LIST.
template <bool BATCHED>
__global__ void topk_kernel(Streams s, int r, const float* __restrict__ en,
                            const float* __restrict__ lohi,
                            const float* __restrict__ w, int64_t n,
                            int64_t n_valid, int k,
                            float* __restrict__ scores,
                            float* __restrict__ tmin,
                            int* __restrict__ targ) {
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  if (BATCHED) {
    const int64_t lane = blockIdx.y;
    s = lane_streams(s, lane * n);
    if (en) en += lane * 4;
    lohi += lane * r * 2;
    scores += lane * n;
    tmin += lane * gridDim.x * k;
    targ += lane * gridDim.x * k;
  }
  // per-term (lo, reciprocal span) exactly as _tile_score's norm()
  float lo[MAX_R], rcp[MAX_R];
#pragma unroll
  for (int q = 0; q < MAX_R; ++q) {
    lo[q] = 0.0f;
    rcp[q] = 0.0f;
    if (q < r) {
      lo[q] = lohi[2 * q];
      const float span = lohi[2 * q + 1] - lo[q];
      rcp[q] = span > 1e-12f ? 1.0f / fmaxf(span, 1e-12f) : 0.0f;
    }
  }
  float cur[NPT];
#pragma unroll
  for (int j = 0; j < NPT; ++j) {
    const int64_t i = (int64_t)tile * TILE + j * TPB + tid;
    float sc = CUDART_INF_F;
    if (i < n_valid) {
      float t[MAX_R];
      node_terms(s, i, r, en, t);
      sc = w[0] * ((t[0] - lo[0]) * rcp[0]) + w[1] * ((t[1] - lo[1]) * rcp[1]);
      sc = sc + w[2] * (1.0f - (t[2] - lo[2]) * rcp[2]);
      sc = sc + w[3] * ((t[3] - lo[3]) * rcp[3]);
      if (r == 5) sc = sc + en[3] * ((t[4] - lo[4]) * rcp[4]);
    }
    scores[(int64_t)tile * TILE + j * TPB + tid] = sc;
    cur[j] = sc;
  }
  const int lane = tid & 31, warp = tid >> 5;
  if (k == 1) {
    // one round of the block-wide lexicographic min
    __shared__ float ws[WARPS];
    __shared__ int wp[WARPS];
    float m = cur[0];
    int p = tid;
#pragma unroll
    for (int j = 1; j < NPT; ++j) lex_min(m, p, cur[j], j * TPB + tid);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
      const int p2 = __shfl_xor_sync(0xffffffffu, p, off);
      lex_min(m, p, m2, p2);
    }
    if (lane == 0) {
      ws[warp] = m;
      wp[warp] = p;
    }
    __syncthreads();
    if (tid == 0) {
      float bm = ws[0];
      int bp = wp[0];
      for (int q = 1; q < WARPS; ++q) lex_min(bm, bp, ws[q], wp[q]);
      tmin[tile] = bm;
      targ[tile] = bp + tile * TILE;
    }
    return;
  }
  // k > 1: each warp sorts its 128 keys, then three merge levels keep the
  // first k of the eight warp lists
  __shared__ float tile_sc[TILE];
  __shared__ u64 lists_a[WARPS * WARP_LIST];
  __shared__ u64 lists_b[WARPS / 2 * WARP_LIST];
  u64 key[NPT];
#pragma unroll
  for (int j = 0; j < NPT; ++j) {
    key[j] = sort_key(cur[j], j * TPB + tid);
    tile_sc[j * TPB + tid] = cur[j];
  }
  bitonic_step<2, 1>(key, lane);
#pragma unroll
  for (int j = 0; j < NPT; ++j) {
    const int e = lane * NPT + j;
    if (e < k) lists_a[warp * k + e] = key[j];
  }
  __syncthreads();
  merge_level(lists_a, lists_b, WARPS, k);
  __syncthreads();
  merge_level(lists_b, lists_a, WARPS / 2, k);
  __syncthreads();
  merge_level(lists_a, lists_b, WARPS / 4, k);
  __syncthreads();
  for (int i = tid; i < k; i += TPB) {
    // the winner's own score bits; a rank whose score is +inf gets
    // tile-local index 0: the k-round rule, once only +inf is left, picks
    // the lowest id of a tile that then holds +inf everywhere
    const int idx = (int)(lists_b[i] & 0xffffffffu);
    const float sc = tile_sc[idx];
    tmin[(int64_t)tile * k + i] = sc;
    targ[(int64_t)tile * k + i] = (sc == CUDART_INF_F ? 0 : idx) +
                                  tile * TILE;
  }
}

Streams make_streams(const void* ec, const void* pue, const void* ci,
                     const void* fc, const void* eff, const void* sw,
                     const void* pk, const void* cap, const void* ct) {
  return Streams{(const float*)ec, (const float*)pue, (const float*)ci,
                 (const float*)fc, (const float*)eff, (const float*)sw,
                 (const float*)pk, (const float*)cap, (const float*)ct};
}

// FOLD: grid (blocks, lanes), part (lanes, blocks, 2r) int32 scratch,
// ticket (lanes,) zeros (left zero), out (lanes, r, 2); !FOLD: grid
// (n / 1024, lanes), lo/hi (lanes, n / 1024, r).
template <bool FOLD>
int launch_lohi(const Streams& s, const void* en, int r, long long lanes,
                long long n, long long n_valid, long long blocks, void* lo,
                void* hi, void* part, void* ticket, void* out,
                void* stream) {
  if (r != 4 && r != 5) return (int)cudaErrorInvalidValue;
  const long long nt = n / TILE;
  const long long nv = n_valid < 0 ? 0 : (n_valid > n ? n : n_valid);
  // the fused sweep visits only the chunks that hold valid nodes
  const long long nchunks = FOLD ? (nv + TILE - 1) / TILE : nt;
  const dim3 grid((unsigned)(FOLD ? blocks : nt), (unsigned)lanes);
  const cudaStream_t st = (cudaStream_t)stream;
  if (r == 5)
    lohi_kernel<5, FOLD><<<grid, TPB, 0, st>>>(
        s, (const float*)en, (int64_t)n, (int64_t)nv, (int)nchunks,
        (float*)lo, (float*)hi, (int*)part, (unsigned*)ticket,
        (float*)out);
  else
    lohi_kernel<4, FOLD><<<grid, TPB, 0, st>>>(
        s, (const float*)en, (int64_t)n, (int64_t)nv, (int)nchunks,
        (float*)lo, (float*)hi, (int*)part, (unsigned*)ticket,
        (float*)out);
  return (int)cudaGetLastError();
}

template <bool BATCHED>
int launch_topk(const Streams& s, const void* en, int r, const void* lohi,
                const void* w, int k, long long lanes, long long n,
                long long n_valid, void* scores, void* tmin, void* targ,
                void* stream) {
  if (k < 1 || k > WARP_LIST) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(n / TILE), (unsigned)lanes);
  topk_kernel<BATCHED><<<grid, TPB, 0, (cudaStream_t)stream>>>(
      s, r, (const float*)en, (const float*)lohi, (const float*)w,
      (int64_t)n, (int64_t)n_valid, k, (float*)scores, (float*)tmin,
      (int*)targ);
  return (int)cudaGetLastError();
}

}  // namespace

// K1 (lanes 1) and K3: node streams (lanes, n), en (lanes, 4) or null,
// `blocks` per lane (at most maiz_lohi_resident(r) / lanes), part
// (lanes, blocks, 2r) int32 scratch, ticket (lanes,) zeros (left zero
// again), out (lanes, r, 2): each lane's folded lo/hi.
extern "C" int maiz_lohi_launch(const void* ec, const void* pue,
                                const void* ci, const void* fc,
                                const void* eff, const void* sw,
                                const void* pk, const void* cap,
                                const void* ct, const void* en, int r,
                                long long lanes, long long n,
                                long long n_valid, long long blocks,
                                void* part, void* ticket, void* out,
                                void* stream) {
  const Streams s = make_streams(ec, pue, ci, fc, eff, sw, pk, cap, ct);
  return launch_lohi<true>(s, en, r, lanes, n, n_valid, blocks, nullptr,
                           nullptr, part, ticket, out, stream);
}

// The blocks of the fused K1/K3 resident on the current device at once:
// SMs x blocks per SM (its occupancy at r terms), or -1 on an error.
extern "C" int maiz_lohi_resident(int r) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return -1;
  const cudaError_t e =
      r == 5 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   &per_sm, lohi_kernel<5, true>, TPB, 0)
             : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   &per_sm, lohi_kernel<4, true>, TPB, 0);
  return e == cudaSuccess ? sms * per_sm : -1;
}

// K1/K3 tile by tile (maiz_lohi_tiles[_b]): node streams (lanes, n), en
// (lanes, 4) or null, lo/hi (lanes, n / 1024, r).
extern "C" int maiz_lohi_tiles_launch(const void* ec, const void* pue,
                                      const void* ci, const void* fc,
                                      const void* eff, const void* sw,
                                      const void* pk, const void* cap,
                                      const void* ct, const void* en, int r,
                                      long long lanes, long long n,
                                      long long n_valid, void* lo, void* hi,
                                      void* stream) {
  const Streams s = make_streams(ec, pue, ci, fc, eff, sw, pk, cap, ct);
  return launch_lohi<false>(s, en, r, lanes, n, n_valid, 0, lo, hi, nullptr,
                            nullptr, nullptr, stream);
}

// K2: node streams (n,), lohi (r, 2), w (4,), scores (n,), tmin/targ
// (n / 1024, k).
extern "C" int maiz_topk_launch(const void* ec, const void* pue,
                                const void* ci, const void* fc,
                                const void* eff, const void* sw,
                                const void* pk, const void* cap,
                                const void* ct, const void* en, int r,
                                const void* lohi, const void* w, int k,
                                long long n, long long n_valid, void* scores,
                                void* tmin, void* targ, void* stream) {
  const Streams s = make_streams(ec, pue, ci, fc, eff, sw, pk, cap, ct);
  return launch_topk<false>(s, en, r, lohi, w, k, 1, n, n_valid, scores, tmin,
                            targ, stream);
}

// K4: node streams (lanes, n), lohi (lanes, r, 2), w (4,), scores
// (lanes, n), tmin/targ (lanes, n / 1024, k).
extern "C" int maiz_topk_b_launch(const void* ec, const void* pue,
                                  const void* ci, const void* fc,
                                  const void* eff, const void* sw,
                                  const void* pk, const void* cap,
                                  const void* ct, const void* en, int r,
                                  const void* lohi, const void* w, int k,
                                  long long lanes, long long n,
                                  long long n_valid, void* scores,
                                  void* tmin, void* targ, void* stream) {
  const Streams s = make_streams(ec, pue, ci, fc, eff, sw, pk, cap, ct);
  return launch_topk<true>(s, en, r, lohi, w, k, lanes, n, n_valid, scores,
                           tmin, targ, stream);
}
