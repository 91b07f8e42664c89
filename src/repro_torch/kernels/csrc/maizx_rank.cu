// Fleet-scale MAIZ ranking (Eq. 2 + Eq. 1 + tile top-k) for Hopper (sm_90a).
//
// Replaces the four Pallas TPU kernels of src/repro/kernels/maizx_rank.py:
//   K1 maiz_lohi    <- _lohi_kernel    (sweep 1: per-tile min/max of the
//                                       Eq. 1 terms, folded to the (R, 2)
//                                       normalizers by the wrapper)
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
// Layout: one block per 1024-node tile (the TPU kernel's (8, 128) block),
// TPB = 256 threads, each owning NPT = 4 nodes at stride TPB so every load
// is coalesced.  Nothing carries over between blocks, so the grid order is
// free (the TPU grid's sequential order was never relied on).  The batched
// kernels are the same templates with the lane on blockIdx.y: each block
// offsets its stream, en, lohi and output pointers by its lane, so lane l
// computes exactly what K1/K2 compute on lane l's arrays (one launch for
// all lanes instead of L).
//
// Bound on an H100: both sweeps stream each node input once.  K1 reads 24
// B/node (36 with the marginal streams pk/cap/ct) and writes only nt x R x 2
// floats; K2 reads the same and writes 4 B/node of scores plus nt x k
// candidates.  At N = 1,048,576 that is 25-38 MB, ~7.5-12.5 us at 3.35 TB/s:
// device-memory bytes bound the streaming part.
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
// order.  Ties break toward the lower node index, as jnp.argmin does.
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

// The Eq. 1 terms of node i in the reference's op order (_tile_terms,
// _tile_mcfp).  en = [idle_frac, dyn_frac, embodied*horizon, w_marginal].
__device__ __forceinline__ void node_terms(const Streams& s, int64_t i, int r,
                                           const float* en, float* t) {
  const float pue = s.pue[i];
  const float ci = s.ci[i];
  const float base = s.ec[i] * pue;
  t[0] = base * ci;
  t[1] = base * s.fc[i];
  t[2] = s.eff[i];
  t[3] = s.sw[i];
  if (r == 5) {
    float an = s.pk[i] * pue;
    an = an * ci;
    const float ct = s.ct[i];
    const float inv = 1.0f / fmaxf(ct, 1.0f);
    const float m_dyn = (an * inv) * en[1];
    const float m_wake = an * en[0] + en[2];
    t[4] = m_dyn + (s.cap[i] == ct ? m_wake : 0.0f);
  }
}

// The lane's view of the node streams: every stream (L, n) row-major, so
// lane l starts at l * n.  Absent marginal streams stay null.
__device__ __forceinline__ Streams lane_streams(Streams s, int64_t off) {
  return Streams{s.ec + off, s.pue + off, s.ci + off, s.fc + off,
                 s.eff + off, s.sw + off, s.pk ? s.pk + off : nullptr,
                 s.cap ? s.cap + off : nullptr, s.ct ? s.ct + off : nullptr};
}

// BATCHED = false is K1 (grid (nt, 1)); true is K3 (grid (nt, L), lane on
// blockIdx.y, en (L, 4), lo/hi (L, nt, r)).
template <bool BATCHED>
__global__ void lohi_kernel(Streams s, int r, const float* __restrict__ en,
                            int64_t n, int64_t n_valid,
                            float* __restrict__ lo, float* __restrict__ hi) {
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  if (BATCHED) {
    const int64_t lane = blockIdx.y;
    s = lane_streams(s, lane * n);
    if (en) en += lane * 4;
    lo += lane * gridDim.x * r;
    hi += lane * gridDim.x * r;
  }
  float tlo[MAX_R], thi[MAX_R];
#pragma unroll
  for (int q = 0; q < MAX_R; ++q) {
    tlo[q] = BIG;
    thi[q] = -BIG;
  }
#pragma unroll
  for (int j = 0; j < NPT; ++j) {
    const int64_t i = (int64_t)tile * TILE + j * TPB + tid;
    if (i < n_valid) {
      float t[MAX_R];
      node_terms(s, i, r, en, t);
#pragma unroll
      for (int q = 0; q < MAX_R; ++q) {
        if (q < r) {
          tlo[q] = fminf(tlo[q], t[q]);
          thi[q] = fmaxf(thi[q], t[q]);
        }
      }
    }
  }
  __shared__ float slo[MAX_R][WARPS], shi[MAX_R][WARPS];
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int q = 0; q < MAX_R; ++q) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      tlo[q] = fminf(tlo[q], __shfl_xor_sync(0xffffffffu, tlo[q], off));
      thi[q] = fmaxf(thi[q], __shfl_xor_sync(0xffffffffu, thi[q], off));
    }
    if (lane == 0) {
      slo[q][warp] = tlo[q];
      shi[q][warp] = thi[q];
    }
  }
  __syncthreads();
  if (tid < r) {
    float a = BIG, b = -BIG;
    for (int w = 0; w < WARPS; ++w) {
      a = fminf(a, slo[tid][w]);
      b = fmaxf(b, shi[tid][w]);
    }
    lo[(int64_t)tile * r + tid] = a;
    hi[(int64_t)tile * r + tid] = b;
  }
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

template <bool BATCHED>
int launch_lohi(const Streams& s, const void* en, int r, long long lanes,
                long long n, long long n_valid, void* lo, void* hi,
                void* stream) {
  const dim3 grid((unsigned)(n / TILE), (unsigned)lanes);
  lohi_kernel<BATCHED><<<grid, TPB, 0, (cudaStream_t)stream>>>(
      s, r, (const float*)en, (int64_t)n, (int64_t)n_valid, (float*)lo,
      (float*)hi);
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

// K1: node streams (n,), en (4,) or null, lo/hi (n / 1024, r).
extern "C" int maiz_lohi_launch(const void* ec, const void* pue,
                                const void* ci, const void* fc,
                                const void* eff, const void* sw,
                                const void* pk, const void* cap,
                                const void* ct, const void* en, int r,
                                long long n, long long n_valid, void* lo,
                                void* hi, void* stream) {
  const Streams s = make_streams(ec, pue, ci, fc, eff, sw, pk, cap, ct);
  return launch_lohi<false>(s, en, r, 1, n, n_valid, lo, hi, stream);
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

// K3: node streams (lanes, n), en (lanes, 4) or null, lo/hi
// (lanes, n / 1024, r).
extern "C" int maiz_lohi_b_launch(const void* ec, const void* pue,
                                  const void* ci, const void* fc,
                                  const void* eff, const void* sw,
                                  const void* pk, const void* cap,
                                  const void* ct, const void* en, int r,
                                  long long lanes, long long n,
                                  long long n_valid, void* lo, void* hi,
                                  void* stream) {
  const Streams s = make_streams(ec, pue, ci, fc, eff, sw, pk, cap, ct);
  return launch_lohi<true>(s, en, r, lanes, n, n_valid, lo, hi, stream);
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
