"""Public wrappers of the kernels (twin of ``repro.kernels.ops``).  Each
runs on its inputs' device: the CUDA kernels for CUDA tensors, their plain
torch versions for CPU tensors.  ``use_kernel=False`` on the attention and
scan wrappers runs the plain version on any device (the model's plain
route, which ``chip_smoke.py`` holds the kernel route against)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import (attention_plain,
                                                 flash_attention)
from repro_torch.kernels.maizx_rank import (MAX_TILE_K, TILE, maiz_lohi,
                                            maiz_lohi_b, maiz_topk,
                                            maiz_topk_b)
from repro_torch.kernels.selective_scan import (selective_scan,
                                                selective_scan_plain)


def flash_attention_op(q, k, v, *, window: int = 0,
                       use_kernel: bool = True) -> torch.Tensor:
    """Causal GQA flash attention: q (B,H,S,hd), k/v (B,K,S,hd) -> (B,H,
    S,hd) in q's dtype (K5).  Views go to the kernel as they are: it reads
    any strides TMA describes and copies the rest itself."""
    if not use_kernel:
        return attention_plain(q, k, v, window=window)
    return flash_attention(q, k, v, window=window)


def selective_scan_op(dt, x, b, c, a, *, use_kernel: bool = True
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Selective scan (K6): x (B,S,D), b/c (B,S,N), dt (B,S,D) with a
    (D,N) (Mamba-1) or dt (B,S,H) with a (H,) (one step and decay per
    head of D/H channels, Mamba-2) -> (y (B,S,D) in x's dtype, final
    state (B,D,N) f32)."""
    if not use_kernel:
        return selective_scan_plain(dt, x, b, c, a)
    f32 = [t.to(torch.float32).contiguous() for t in (b, c, a)]
    return selective_scan(dt.to(x.dtype).contiguous(), x.contiguous(), *f32)


def lex_head(values: torch.Tensor, k: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The first ``k`` of ``values`` along the last axis in (value,
    position) order: a stable ascending sort keeps the lower position first
    on ties, which is ``lax.top_k(-values, k)``'s rule."""
    order = torch.sort(values, dim=-1, stable=True).indices[..., :k]
    return values.gather(-1, order), order


def maiz_ranking_topk(ec, pue, ci_now, ci_fc, eff, sched, weights, *,
                      k: int = 16, lohi: Optional[torch.Tensor] = None,
                      pk: Optional[torch.Tensor] = None,
                      cap: Optional[torch.Tensor] = None,
                      chips_total: Optional[torch.Tensor] = None,
                      en: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fleet-scale fused MAIZ ranking with a merged top-k shortlist.

    Arrays (N,) of any float dtype; padded to the 1024-node tile here
    (padded nodes are masked and never shortlisted).  Pass ``lohi`` (R, 2)
    to pin the normalizers and skip sweep 1 (the placement engine freezes
    them per decision epoch).  ``pk``/``cap``/``chips_total`` + ``en`` (4,)
    thread the marginal-CFP term as a fifth score term.

    Returns (scores (N,), topk_scores (k',), topk_nodes (k',) int32) with
    k' = min(k, N), ordered by (score, node index)."""
    n = ec.shape[0]
    k_out = min(k, n)
    k_tile = min(k_out, MAX_TILE_K)
    pad = (-n) % TILE

    def padded(x):
        return F.pad(x.to(torch.float32), (0, pad)).contiguous()

    args = tuple(padded(a) for a in (ec, pue, ci_now, ci_fc, eff, sched))
    mkw = {}
    if en is not None:
        mkw = dict(pk=padded(pk), cap=padded(cap), ct=padded(chips_total),
                   en=en.to(torch.float32).contiguous())
    if lohi is None:
        lohi = maiz_lohi(*args, n, **mkw)
    scores, tmin, targ = maiz_topk(
        *args, n, lohi.contiguous(), weights.to(torch.float32).contiguous(),
        k=k_tile, **mkw)
    scores = scores[:n]
    if k_out > k_tile:
        # the tile-local k is capped: one tile could hold more than k_tile
        # of the global top-k_out, so merge from the full score vector
        top_s, pos = lex_head(scores, k_out)
        return scores, top_s, pos.to(torch.int32)
    # tile candidates arrive in (tile, rank) order, so the stable merge
    # keeps the global (score, node) order.  The port's tile cap (128) is
    # above the reference's (64), so a shortlist of 64 (k = 65) merges here
    # where the reference sorts the full vector: each of the global top
    # k_out is in its tile's top k_tile >= k_out, and with k_out <= n there
    # are k_out finite candidates ahead of any +inf one, so the result is
    # the same
    top_s, pos = lex_head(tmin.reshape(-1), k_out)
    return scores, top_s, targ.reshape(-1)[pos]


def maiz_ranking_topk_batched(ec, pue, ci_now, ci_fc, eff, sched, weights,
                              *, k: int = 16,
                              lohi: Optional[torch.Tensor] = None,
                              pk: Optional[torch.Tensor] = None,
                              cap: Optional[torch.Tensor] = None,
                              chips_total: Optional[torch.Tensor] = None,
                              en: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """``maiz_ranking_topk`` over a leading ensemble-lane axis.

    Node arrays (L, N), shared ``weights`` (4,), optional per-lane ``lohi``
    (L, R, 2) and marginal streams (``pk``/``cap``/``chips_total`` (L, N),
    ``en`` (L, 4)).  Sweep 1 (without ``lohi``) and sweep 2 are one launch
    each for all lanes; each lane's tile candidates are merged in (score,
    node index) order.  Each lane's (scores, topk_scores, topk_nodes) equals
    ``maiz_ranking_topk`` on that lane."""
    L, n = ec.shape
    k_out = min(k, n)
    k_tile = min(k_out, MAX_TILE_K)
    pad = (-n) % TILE

    def padded(x):
        return F.pad(x.to(torch.float32), (0, pad)).contiguous()

    args = tuple(padded(a) for a in (ec, pue, ci_now, ci_fc, eff, sched))
    mkw = {}
    if en is not None:
        mkw = dict(pk=padded(pk), cap=padded(cap), ct=padded(chips_total),
                   en=en.to(torch.float32).contiguous())
    if lohi is None:
        lohi = maiz_lohi_b(*args, n, **mkw)
    scores, tmin, targ = maiz_topk_b(
        *args, n, lohi.contiguous(), weights.to(torch.float32).contiguous(),
        k=k_tile, **mkw)
    scores = scores[:, :n]
    if k_out > k_tile:
        # the same oversized-shortlist merge as the sequential wrapper, per
        # lane from the full score rows
        top_s, pos = lex_head(scores, k_out)
        return scores, top_s, pos.to(torch.int32)
    top_s, pos = lex_head(tmin.reshape(L, -1), k_out)
    return scores, top_s, targ.reshape(L, -1).gather(1, pos)


def maiz_ranking_fused(ec, pue, ci_now, ci_fc, eff, sched, weights
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fleet-scale fused MAIZ ranking (k=1 shortlist): both sweeps.

    Returns (scores (N,), best_score, best_node)."""
    scores, top_s, top_i = maiz_ranking_topk(
        ec, pue, ci_now, ci_fc, eff, sched, weights, k=1)
    return scores, top_s[0], top_i[0]
