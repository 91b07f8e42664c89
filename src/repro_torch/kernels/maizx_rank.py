"""Fleet-scale MAIZ_RANKING kernels for Hopper (Eq. 2 + Eq. 1 + tile top-k).

Twin of ``repro.kernels.maizx_rank``.  Two memory-bound sweeps over the
node axis, each reading every input stream once:

K1 ``maiz_lohi`` (replaces ``_lohi_kernel``) — compute the Eq. 1 terms
    and their masked (lo, hi) over the valid nodes: the global (R, 2)
    min-max normalizers, in one launch (a persistent grid whose last block
    folds the blocks' partials).  ``maiz_lohi_tiles`` runs the same kernel
    with the fold off: the reference's per-tile (lo, hi).

K2 ``maiz_topk`` (replaces ``_topk_kernel``) — per node the normalized
    weighted score; per tile the local top-k in (score, index) order,
    lowest index first on ties: what k rounds of lexicographic min
    extraction give (the plain twin runs those rounds; the kernel sorts
    and merges).

K3 ``maiz_lohi_b`` / K4 ``maiz_topk_b`` (replace ``_lohi_kernel_b`` /
    ``_topk_kernel_b``) — K1/K2 over a leading lane axis in one launch:
    node streams (L, N), per-lane ``en`` (L, 4) and ``lohi`` (L, R, 2),
    shared weights.  Each lane is bitwise what K1/K2 give on that lane.

±0.0 compare equal, so a min/max keeps whichever zero its reduction order
meets first; K1/K3 and the twins' fold (``fold_lohi``) order -0.0 below
+0.0 instead, so the (R, 2) result does not depend on the fold order.
K1/K3 read each stream with 16-byte loads: every stream (and so every
lane's row) must start on a 16-byte boundary, or the wrapper raises.

R = 5 when the marginal-CFP streams (``pk``/``cap``/``ct`` plus the (4,)
``en = [idle_frac, dyn_frac, embodied·horizon, w_marginal]``) are given,
else 4.  The kernels are CUDA C++ for ``sm_90a`` in ``csrc/maizx_rank.cu``
(bounds and design are noted there), compiled with ``nvcc`` at first use
into ``build/repro_torch_kernels/`` and bound with ``ctypes``.

Each wrapper dispatches on the device of its inputs: CPU tensors go to the
plain torch twin (``maiz_lohi_plain``/``maiz_topk_plain`` and their ``_b``
forms), CUDA tensors to the kernel, which is built or the call raises.
``launches`` on each wrapper counts kernel launches (plain-twin calls do
not count).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build

TILE = 1024        # nodes per tile: the TPU kernel's (8, 128) block
# tile-local k is capped at one warp's sorted list in the kernel (128
# keys); the reference's unrolled extraction caps it at 64.  Larger
# shortlists are merged from the full score vector (see
# ops.maiz_ranking_topk)
MAX_TILE_K = 128
_BIG = 3e38        # finite sentinel for masked min/max (below f32 max)

SOURCE = _build.CSRC / "maizx_rank.cu"
# no FMA contraction: the kernels are bitwise equal to their plain twins
NVCC_FLAGS = _build.BASE_FLAGS + ("-fmad=false",)


def _check_tile_k(k: int) -> None:
    if not 1 <= k <= MAX_TILE_K:
        raise ValueError(
            f"tile-local top-k k={k} is outside [1, MAX_TILE_K={MAX_TILE_K}]"
            " — the kernel keeps one warp's sorted list per tile, so the"
            " per-tile candidate list is capped.  Either shrink the"
            f" shortlist (placement needs k = shortlist + 1 <= {MAX_TILE_K})"
            " or call repro_torch.kernels.ops.maiz_ranking_topk, which"
            " merges oversized shortlists from the full score vector.")


# ---------------------------------------------------------------------------
# plain torch twins (the CPU path, and what the kernels are held against)
# ---------------------------------------------------------------------------


# The twins take node streams (N,) or (L, N); ``en`` (4,) or (L, 4) and
# ``lohi`` (R, 2) or (L, R, 2) follow.  ``x[..., i:i + 1]`` picks a
# per-lane scalar as an (L, 1) column that broadcasts against the lane's
# row (a (1,) slice without lanes), so every element sees the same ops in
# the same order with or without the lane axis.


def _terms(ec, pue, ci, fc, eff, sw, pk, cap, ct, en):
    """The Eq. 1 terms in the kernel's op order (``_tile_terms`` and
    ``_tile_mcfp`` of the reference)."""
    base = ec * pue
    terms = [base * ci, base * fc, eff, sw]
    if en is not None:
        an = pk * pue
        an = an * ci
        inv = torch.reciprocal(torch.clamp_min(ct, 1.0))
        m_dyn = an * inv * en[..., 1:2]
        m_wake = an * en[..., 0:1] + en[..., 2:3]
        terms.append(m_dyn + torch.where(cap == ct, m_wake, 0.0))
    return terms


def _valid(n: int, n_valid: int, device) -> torch.Tensor:
    return torch.arange(n, device=device) < n_valid


def maiz_lohi_plain(ec, pue, ci, fc, eff, sw, n_valid: int, *, pk=None,
                    cap=None, ct=None, en=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1's plain twin: per-tile (lo, hi), each (nt, R) f32 ((L, nt, R)
    for (L, N) streams)."""
    n = ec.shape[-1]
    tiles = ec.shape[:-1] + (n // TILE, TILE)
    valid = _valid(n, n_valid, ec.device)
    terms = _terms(ec, pue, ci, fc, eff, sw, pk, cap, ct, en)
    lo = torch.stack([torch.where(valid, t, _BIG).reshape(tiles).amin(-1)
                      for t in terms], dim=-1)
    hi = torch.stack([torch.where(valid, t, -_BIG).reshape(tiles).amax(-1)
                      for t in terms], dim=-1)
    return lo, hi


def fold_lohi(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Fold per-tile (lo, hi), each (..., nt, R), into the (..., R, 2)
    normalizers: the min of lo and the max of hi over the tiles, with -0.0
    below +0.0 (amin/amax alone keep whichever zero they meet first)."""
    a, b = lo.amin(-2), hi.amax(-2)
    neg0 = ((lo == 0) & torch.signbit(lo)).any(-2)
    pos0 = ((hi == 0) & ~torch.signbit(hi)).any(-2)
    zero = torch.zeros((), dtype=lo.dtype, device=lo.device)
    a = torch.where(a == 0, torch.where(neg0, -zero, zero), a)
    b = torch.where(b == 0, torch.where(pos0, zero, -zero), b)
    return torch.stack([a, b], dim=-1)


def _scores_plain(ec, pue, ci, fc, eff, sw, n_valid, lohi, w, pk, cap, ct,
                  en):
    terms = _terms(ec, pue, ci, fc, eff, sw, pk, cap, ct, en)

    def norm(x, i):
        lo, hi = lohi[..., i, 0:1], lohi[..., i, 1:2]
        span = hi - lo
        rcp = torch.where(span > 1e-12,
                          torch.reciprocal(torch.clamp_min(span, 1e-12)), 0.0)
        return (x - lo) * rcp

    score = (w[0] * norm(terms[0], 0) + w[1] * norm(terms[1], 1)
             + w[2] * (1.0 - norm(terms[2], 2)) + w[3] * norm(terms[3], 3))
    if en is not None:
        # select-then-add: with w_m == 0 this adds ±0.0, a bitwise no-op
        score = score + en[..., 3:4] * norm(terms[4], 4)
    return torch.where(_valid(ec.shape[-1], n_valid, ec.device), score,
                       torch.inf)


def _tile_topk_plain(scores: torch.Tensor, k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k rounds of min extraction per tile, literally ``_tile_topk``: the
    winner is set to +inf, so a tile with fewer than k finite scores keeps
    re-selecting the lowest id that holds +inf.  ``scores`` (..., N) ->
    (..., nt, k) each; node ids are local to their lane."""
    lead, n = scores.shape[:-1], scores.shape[-1]
    nt = n // TILE
    cur = scores.reshape(-1, TILE).clone()
    fids = torch.arange(TILE, device=scores.device, dtype=torch.int32)
    base = (torch.arange(cur.shape[0], device=scores.device,
                         dtype=torch.int32) % nt) * TILE
    tmin, targ = [], []
    for _ in range(k):
        m = cur.amin(1, keepdim=True)
        pos = torch.where(cur == m, fids, TILE).amin(1, keepdim=True)
        tmin.append(m[:, 0])
        targ.append(pos[:, 0] + base)
        cur = torch.where(fids == pos, torch.inf, cur)
    shape = lead + (nt, k)
    return torch.stack(tmin, 1).reshape(shape), \
        torch.stack(targ, 1).reshape(shape)


def maiz_topk_plain(ec, pue, ci, fc, eff, sw, n_valid: int, lohi, weights,
                    *, k: int, pk=None, cap=None, ct=None, en=None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2's plain twin: (scores (N,), tmin (nt, k) f32, targ (nt, k) i32),
    each with a leading lane axis for (L, N) streams."""
    scores = _scores_plain(ec, pue, ci, fc, eff, sw, n_valid, lohi, weights,
                           pk, cap, ct, en)
    tmin, targ = _tile_topk_plain(scores, k)
    return scores, tmin, targ


def maiz_lohi_plain_b(ec, pue, ci, fc, eff, sw, n_valid: int, *, pk=None,
                      cap=None, ct=None, en=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3's plain twin: (L, N) streams, ``en`` (L, 4) -> per-tile (lo, hi),
    each (L, nt, R)."""
    _check_lanes(ec, en, None)
    return maiz_lohi_plain(ec, pue, ci, fc, eff, sw, n_valid, pk=pk,
                           cap=cap, ct=ct, en=en)


def maiz_topk_plain_b(ec, pue, ci, fc, eff, sw, n_valid: int, lohi,
                      weights, *, k: int, pk=None, cap=None, ct=None,
                      en=None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4's plain twin: (L, N) streams, ``lohi`` (L, R, 2), shared
    ``weights`` (4,) -> (scores (L, N), tmin (L, nt, k), targ (L, nt, k))."""
    _check_lanes(ec, en, lohi)
    return maiz_topk_plain(ec, pue, ci, fc, eff, sw, n_valid, lohi,
                           weights, k=k, pk=pk, cap=cap, ct=ct, en=en)


def _check_lanes(ec, en, lohi) -> None:
    """The batched forms take (L, N) streams with per-lane en/lohi."""
    if ec.dim() != 2:
        raise ValueError(f"batched rank kernels take (L, N) node streams; "
                         f"got {tuple(ec.shape)}")
    L = ec.shape[0]
    if en is not None and tuple(en.shape) != (L, 4):
        raise ValueError(f"en must be ({L}, 4); got {tuple(en.shape)}")
    r = 5 if en is not None else 4
    if lohi is not None and tuple(lohi.shape) != (L, r, 2):
        raise ValueError(f"lohi must be ({L}, {r}, 2); got "
                         f"{tuple(lohi.shape)}")


# ---------------------------------------------------------------------------
# build + bind the CUDA kernels (first use only; never at import)
# ---------------------------------------------------------------------------

def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.maiz_lohi_launch.argtypes = [p] * 10 + [i, ll, ll, ll, ll] + [p] * 4
    lib.maiz_lohi_launch.restype = i
    lib.maiz_lohi_resident.argtypes = [i]
    lib.maiz_lohi_resident.restype = i
    lib.maiz_lohi_tiles_launch.argtypes = [p] * 10 + [i, ll, ll, ll, p, p, p]
    lib.maiz_lohi_tiles_launch.restype = i
    lib.maiz_topk_launch.argtypes = ([p] * 10 + [i, p, p, i, ll, ll]
                                     + [p] * 4)
    lib.maiz_topk_launch.restype = i
    lib.maiz_topk_b_launch.argtypes = ([p] * 10 + [i, p, p, i, ll, ll, ll]
                                       + [p] * 4)
    lib.maiz_topk_b_launch.restype = i


def _lib() -> ctypes.CDLL:
    return _build.load(SOURCE, NVCC_FLAGS, _bind)


_check = _build.check


def _kernel_args(streams, extra, aligned=False):
    """Validate the node streams for a launch, all (N,) or all (L, N), and
    return (N, their pointers) (null for absent marginal streams).
    ``aligned``: each stream must start on a 16-byte boundary (K1/K3's
    vector loads; with N % 1024 == 0 every lane's row then does too)."""
    shape = tuple(streams[0].shape)
    n = shape[-1]
    if n % TILE:
        raise ValueError(f"node arrays must be padded to {TILE}: N={n}")
    ptrs = []
    for x in list(streams) + list(extra):
        if x is None:
            ptrs.append(None)
            continue
        if (x.device.type != "cuda" or x.dtype != torch.float32
                or not x.is_contiguous() or tuple(x.shape) != shape):
            raise ValueError("rank kernel streams must be contiguous f32 "
                             f"{shape} CUDA tensors; got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
        if aligned and x.data_ptr() % 16:
            raise ValueError("maiz_lohi reads each stream with 16-byte "
                             "loads: a stream starts at address "
                             f"{x.data_ptr():#x}, not on a 16-byte boundary")
        ptrs.append(x.data_ptr())
    return n, ptrs


def _small(x: Optional[torch.Tensor], shape, name: str):
    if x is None:
        return None
    if (x.device.type != "cuda" or x.dtype != torch.float32
            or not x.is_contiguous() or tuple(x.shape) != shape):
        raise ValueError(f"{name} must be a contiguous f32 {shape} CUDA "
                         f"tensor; got {x.dtype} {tuple(x.shape)}")
    return x.data_ptr()


# ---------------------------------------------------------------------------
# public wrappers: device dispatch + launch counters
# ---------------------------------------------------------------------------


# per (device, r): the fused K1/K3's resident blocks; per (device, stream):
# the lane tickets its last blocks count on (left zero by every launch), so
# two streams never share one
_RESIDENT: Dict[Tuple[int, int], int] = {}
_TICKETS: Dict[Tuple[int, int], torch.Tensor] = {}


def lohi_blocks(device, r: int, lanes: int, n_valid: int) -> int:
    """Blocks per lane of the fused K1/K3's persistent grid: the device's
    resident blocks split over the lanes, at most one per chunk of valid
    nodes, at least one."""
    key = (torch.device(device).index, r)
    if key not in _RESIDENT:
        with torch.cuda.device(key[0]):
            res = _lib().maiz_lohi_resident(r)
        if res <= 0:
            raise RuntimeError(f"maiz_lohi: occupancy query failed ({res})")
        _RESIDENT[key] = res
    chunks = -(-max(int(n_valid), 0) // TILE)
    return max(1, min(chunks, _RESIDENT[key] // lanes))


def _tickets(dev: torch.device, stream: int, lanes: int) -> torch.Tensor:
    """The (device, stream)'s lane tickets, at least ``lanes`` of them
    (zeroed on ``stream`` when made)."""
    key = (dev.index, stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < lanes:
        t = torch.zeros(max(lanes, 8), dtype=torch.int32, device=dev)
        _TICKETS[key] = t
    return t


def _lohi_fused(ec, pue, ci, fc, eff, sw, n_valid, pk, cap, ct, en,
                lanes: int) -> torch.Tensor:
    """Launch the fused K1/K3 over ``lanes`` rows: (lanes, R, 2)."""
    r = 5 if en is not None else 4
    n, ptrs = _kernel_args((ec, pue, ci, fc, eff, sw), (pk, cap, ct),
                           aligned=True)
    en_p = _small(en, (lanes, 4) if ec.dim() == 2 else (4,), "en")
    dev = ec.device
    n_valid = min(max(int(n_valid), 0), n)
    blocks = lohi_blocks(dev, r, lanes, n_valid)
    part = torch.empty((lanes, blocks, 2 * r), dtype=torch.int32,
                       device=dev)
    out = torch.empty((lanes, r, 2), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ticket = _tickets(dev, stream, lanes)
    _check(_lib().maiz_lohi_launch(*ptrs, en_p, r, lanes, n, n_valid,
                                   blocks, part.data_ptr(), ticket.data_ptr(),
                                   out.data_ptr(), stream),
           "maiz_lohi")
    return out


def _lohi_tiles(ec, pue, ci, fc, eff, sw, n_valid, pk, cap, ct, en,
                lanes: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K1/K3 with the fold off: per-tile (lo, hi), (lanes, nt, R)."""
    r = 5 if en is not None else 4
    n, ptrs = _kernel_args((ec, pue, ci, fc, eff, sw), (pk, cap, ct),
                           aligned=True)
    en_p = _small(en, (lanes, 4) if ec.dim() == 2 else (4,), "en")
    lo = torch.empty((lanes, n // TILE, r), dtype=torch.float32,
                     device=ec.device)
    hi = torch.empty_like(lo)
    stream = torch.cuda.current_stream(ec.device).cuda_stream
    _check(_lib().maiz_lohi_tiles_launch(*ptrs, en_p, r, lanes, n,
                                         int(n_valid), lo.data_ptr(),
                                         hi.data_ptr(), stream),
           "maiz_lohi_tiles")
    return lo, hi


def maiz_lohi(ec, pue, ci, fc, eff, sw, n_valid: int, *, pk=None, cap=None,
              ct=None, en=None) -> torch.Tensor:
    """Sweep 1: the global (R, 2) term lo/hi.  Node arrays (N,) f32 with
    N % 1024 == 0; ``n_valid`` masks the padded tail.  R = 5 with the
    marginal streams, else 4.  On the card one launch of the fused K1."""
    if ec.device.type == "cpu":
        return fold_lohi(*maiz_lohi_plain(ec, pue, ci, fc, eff, sw, n_valid,
                                          pk=pk, cap=cap, ct=ct, en=en))
    out = _lohi_fused(ec, pue, ci, fc, eff, sw, n_valid, pk, cap, ct, en, 1)
    maiz_lohi.launches += 1
    return out[0]


def maiz_lohi_tiles(ec, pue, ci, fc, eff, sw, n_valid: int, *, pk=None,
                    cap=None, ct=None, en=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K1 tile by tile: per-tile (lo, hi), each (nt, R), on ``ec``'s
    stream (what ``maiz_lohi_plain`` gives)."""
    lo, hi = _lohi_tiles(ec, pue, ci, fc, eff, sw, n_valid, pk, cap, ct, en,
                         1)
    maiz_lohi.launches += 1
    return lo[0], hi[0]


def maiz_topk(ec, pue, ci, fc, eff, sw, n_valid: int, lohi, weights, *,
              k: int, pk=None, cap=None, ct=None, en=None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sweep 2: scores + per-tile top-k.  Returns (scores (N,) with +inf in
    the padded tail, tile_topk_scores (nt, k), tile_topk_idx (nt, k))."""
    _check_tile_k(k)
    r = 5 if en is not None else 4
    if tuple(lohi.shape) != (r, 2):
        raise ValueError(f"lohi must be ({r}, 2); got {tuple(lohi.shape)}")
    if ec.device.type == "cpu":
        return maiz_topk_plain(ec, pue, ci, fc, eff, sw, n_valid, lohi,
                               weights, k=k, pk=pk, cap=cap, ct=ct, en=en)
    n, ptrs = _kernel_args((ec, pue, ci, fc, eff, sw), (pk, cap, ct))
    en_p = _small(en, (4,), "en")
    lohi_p = _small(lohi, (r, 2), "lohi")
    w_p = _small(weights, (4,), "weights")
    nt = n // TILE
    dev = ec.device
    scores = torch.empty(n, dtype=torch.float32, device=dev)
    tmin = torch.empty((nt, k), dtype=torch.float32, device=dev)
    targ = torch.empty((nt, k), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _check(_lib().maiz_topk_launch(*ptrs, en_p, r, lohi_p, w_p, k, n,
                                   int(n_valid), scores.data_ptr(),
                                   tmin.data_ptr(), targ.data_ptr(), stream),
           "maiz_topk")
    maiz_topk.launches += 1
    return scores, tmin, targ


# one launch handles at most this many lanes (the grid's y dimension)
MAX_LANES = 65535


def _check_lane_count(L: int) -> None:
    if not 1 <= L <= MAX_LANES:
        raise ValueError(f"{L} lanes is outside [1, {MAX_LANES}]")


def maiz_lohi_b(ec, pue, ci, fc, eff, sw, n_valid: int, *, pk=None,
                cap=None, ct=None, en=None) -> torch.Tensor:
    """Batched sweep 1: node arrays (L, N) with N % 1024 == 0, ``en``
    (L, 4) -> the per-lane (L, R, 2) lo/hi in one launch of the fused
    K3."""
    if ec.device.type == "cpu":
        return fold_lohi(*maiz_lohi_plain_b(ec, pue, ci, fc, eff, sw,
                                            n_valid, pk=pk, cap=cap, ct=ct,
                                            en=en))
    _check_lanes(ec, en, None)
    _check_lane_count(ec.shape[0])
    out = _lohi_fused(ec, pue, ci, fc, eff, sw, n_valid, pk, cap, ct, en,
                      ec.shape[0])
    maiz_lohi_b.launches += 1
    return out


def maiz_lohi_tiles_b(ec, pue, ci, fc, eff, sw, n_valid: int, *, pk=None,
                      cap=None, ct=None, en=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K3 tile by tile: per-lane, per-tile (lo, hi), each
    (L, nt, R)."""
    _check_lanes(ec, en, None)
    _check_lane_count(ec.shape[0])
    lo, hi = _lohi_tiles(ec, pue, ci, fc, eff, sw, n_valid, pk, cap, ct, en,
                         ec.shape[0])
    maiz_lohi_b.launches += 1
    return lo, hi


def maiz_topk_b(ec, pue, ci, fc, eff, sw, n_valid: int, lohi, weights, *,
                k: int, pk=None, cap=None, ct=None, en=None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched sweep 2: node arrays (L, N), ``lohi`` (L, R, 2), shared
    ``weights`` (4,), ``en`` (L, 4).  Returns (scores (L, N), tmin
    (L, nt, k), targ (L, nt, k)) from one launch; each lane equals
    ``maiz_topk`` on that lane."""
    _check_tile_k(k)
    _check_lanes(ec, en, lohi)
    if ec.device.type == "cpu":
        return maiz_topk_plain_b(ec, pue, ci, fc, eff, sw, n_valid, lohi,
                                 weights, k=k, pk=pk, cap=cap, ct=ct, en=en)
    L = ec.shape[0]
    _check_lane_count(L)
    r = 5 if en is not None else 4
    n, ptrs = _kernel_args((ec, pue, ci, fc, eff, sw), (pk, cap, ct))
    en_p = _small(en, (L, 4), "en")
    lohi_p = _small(lohi, (L, r, 2), "lohi")
    w_p = _small(weights, (4,), "weights")
    nt = n // TILE
    dev = ec.device
    scores = torch.empty((L, n), dtype=torch.float32, device=dev)
    tmin = torch.empty((L, nt, k), dtype=torch.float32, device=dev)
    targ = torch.empty((L, nt, k), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _check(_lib().maiz_topk_b_launch(*ptrs, en_p, r, lohi_p, w_p, k, L, n,
                                     int(n_valid), scores.data_ptr(),
                                     tmin.data_ptr(), targ.data_ptr(),
                                     stream),
           "maiz_topk_b")
    maiz_topk_b.launches += 1
    return scores, tmin, targ


WRAPPERS = (maiz_lohi, maiz_topk, maiz_lohi_b, maiz_topk_b)


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0


reset_launch_counts()
