"""GQA attention: the chunked training path, prefill through the
flash-attention kernel K5, and KV-cache decode (twin of
``repro.models.attention``).

Training runs the JAX package's own route: ``attention_core`` walks
query chunks, each under ``torch.utils.checkpoint`` (the JAX package's
``jax.checkpoint``), so no more than one chunk's (chunk x T) f32 score
matrix is live, and autograd differentiates it (K5 has no backward, as
the Pallas kernel has no VJP).  Prefill computes the same function in one
K5 launch per layer.  Sliding-window attention (h2o-danube) is a band
mask in training and keeps a ring-buffer KV cache whose size is the
window.  Positions are (B, S), or (B, S, 3) M-RoPE ids (qwen2-vl); K5
sees q and k after the rotation either way.  Decode is plain torch: one
query row per sequence against the cache.
"""
from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import Param, is_dtensor, local_rows
from repro_torch.kernels.ops import flash_attention_op
from repro_torch.models.layers import apply_rope

NEG_INF = -1e30


def attn_template(cfg: ArchConfig) -> Dict[str, Param]:
    D, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": Param((D, H * hd), ("fsdp", "tp")),
        "wk": Param((D, K * hd), ("fsdp", "tp")),
        "wv": Param((D, K * hd), ("fsdp", "tp")),
        "wo": Param((H * hd, D), ("tp", "fsdp")),
    }


class KVCache(NamedTuple):
    k: torch.Tensor       # (B, S_cache, K, hd)
    v: torch.Tensor       # (B, S_cache, K, hd)


# ---------------------------------------------------------------------------
# Core masked attention over query chunks (the training path)
# ---------------------------------------------------------------------------


def _block_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  row_ids: torch.Tensor, col_ids: torch.Tensor,
                  window: int) -> torch.Tensor:
    """q: (B, Q, H, hd); k/v: (B, T, H, hd), kv already expanded to H
    heads.  ids give absolute positions; window <= 0 = full causal.  The
    scores are f32 products of the inputs (the JAX package's
    ``preferred_element_type=f32``)."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bthd->bhqt", q.float(), k.float()) * scale
    mask = col_ids[None, :] <= row_ids[:, None]
    if window > 0:
        mask &= col_ids[None, :] > (row_ids[:, None] - window)
    scores = torch.where(mask[None, None], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqt,bthd->bqhd", w.to(v.dtype), v)


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   window: int = 0, q_offset: int = 0,
                   chunk: int = 1024) -> torch.Tensor:
    """Causal (optionally banded) attention over query chunks.

    q: (B, S, K, G, hd) vs k/v: (B, T, K, hd) with absolute query
    positions q_offset..q_offset+S-1 and key positions 0..T-1.  The last
    chunk is padded; each chunk runs under a checkpoint, so backward
    recomputes its scores.  Returns (B, S, K, G, hd)."""
    if is_dtensor(q):
        # on a mesh, each rank attends its own rows (the products flatten
        # (batch, head) into one bmm dim, which DTensor cannot always
        # place); heads are replicated there
        return local_rows(functools.partial(
            attention_core, window=window, q_offset=q_offset, chunk=chunk),
            q, k, v)
    B, S, K, G, hd = q.shape
    H = K * G
    T = k.shape[1]
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:
        q = F.pad(q, (0, 0, 0, 0, 0, 0, 0, pad))
    nc = q.shape[1] // chunk
    qh = q.reshape(B, nc * chunk, H, hd)
    # kv expanded to H heads, head h = k * G + g (jnp.repeat's order)
    ke = torch.repeat_interleave(k, G, dim=2)
    ve = torch.repeat_interleave(v, G, dim=2)
    col_ids = torch.arange(T, device=q.device)
    rows = torch.arange(chunk, device=q.device) + q_offset
    outs = [checkpoint(_block_attend, qh[:, i * chunk:(i + 1) * chunk],
                       ke, ve, rows + i * chunk, col_ids, window,
                       use_reentrant=False)
            for i in range(nc)]
    out = torch.cat(outs, dim=1).reshape(B, nc * chunk, K, G, hd)
    return out[:, :S]


def _project_qkv(cfg: ArchConfig, p, x, positions):
    B, S, _ = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(B, S, K, H // K, hd)
    k = (x @ p["wk"]).reshape(B, S, K, hd)
    v = (x @ p["wv"]).reshape(B, S, K, hd)
    if cfg.rope != "none":
        q = apply_rope(q.reshape(B, S, H, hd), positions,
                       cfg.rope_theta).reshape(B, S, K, H // K, hd)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_apply(cfg: ArchConfig, p: Dict[str, torch.Tensor],
                    x: torch.Tensor, positions: torch.Tensor, *,
                    chunk: int = 1024) -> torch.Tensor:
    """Training-time attention (no cache) through ``attention_core``."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(cfg, p, x, positions)
    window = cfg.window if cfg.attention == "swa" else 0
    out = attention_core(q, k, v, window=window, chunk=chunk)
    return out.reshape(B, S, cfg.n_heads * cfg.head_dim) @ p["wo"]


def attention_prefill(cfg: ArchConfig, p, x, positions, cache_len: int, *,
                      use_kernel: bool = True
                      ) -> Tuple[torch.Tensor, KVCache]:
    """Prefill: returns the output and a cache sized ``cache_len``.

    q (B, S, K, G, hd) goes to K5 as (B, H, S, hd) with head h = k·G + g,
    so the kernel's h // G is the kv head.  For SWA the cache is the ring
    buffer of the last ``window`` positions."""
    B, S, _ = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = _project_qkv(cfg, p, x, positions)
    window = cfg.window if cfg.attention == "swa" else 0
    out = flash_attention_op(
        q.reshape(B, S, H, hd).transpose(1, 2), k.transpose(1, 2),
        v.transpose(1, 2), window=window, use_kernel=use_kernel)
    out = out.transpose(1, 2).reshape(B, S, H * hd)
    if cfg.attention == "swa":
        cl = min(cache_len, cfg.window)
        # the last min(S, cl) tokens land at slots pos % cl
        n = min(S, cl)
        slots = (S - n + torch.arange(n, device=x.device)) % cl
        ck = k.new_zeros((B, cl) + k.shape[2:])
        cv = v.new_zeros((B, cl) + v.shape[2:])
        ck[:, slots] = k[:, -n:]
        cv[:, slots] = v[:, -n:]
    else:
        ck = k.new_zeros((B, cache_len) + k.shape[2:])
        cv = v.new_zeros((B, cache_len) + v.shape[2:])
        ck[:, :S] = k
        cv[:, :S] = v
    return out @ p["wo"], KVCache(ck, cv)


def cache_template(cfg: ArchConfig, batch: int,
                   seq_len: int) -> Dict[str, Param]:
    cl = min(seq_len, cfg.window) if cfg.attention == "swa" else seq_len
    shp = (batch, cl, cfg.n_kv_heads, cfg.head_dim)
    axes = ("batch", "kv_seq", "kv_heads", None)
    return {"k": Param(shp, axes, init="zeros"),
            "v": Param(shp, axes, init="zeros")}


def attention_decode(cfg: ArchConfig, p, x, cache: KVCache,
                     positions: torch.Tensor,
                     rope_positions: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, KVCache]:
    """x: (B, 1, D); positions: (B,) absolute position of the new token
    (its cache slot); ``rope_positions`` optionally carries the token's
    M-RoPE ids (B, 3), which then turn q and k in place of ``positions``.
    Writes the new k/v into ``cache`` in place (the JAX package returns an
    updated copy; in place saves a cache copy per layer and step) and
    returns it."""
    B = x.shape[0]
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rp = positions if rope_positions is None else rope_positions
    q, k_new, v_new = _project_qkv(cfg, p, x, rp[:, None])
    ck, cv = cache
    cl = ck.shape[1]
    is_swa = cfg.attention == "swa"
    slot = positions % cl if is_swa else positions
    rows = torch.arange(B, device=x.device)
    ck[rows, slot] = k_new[:, 0]
    cv[rows, slot] = v_new[:, 0]

    scores = torch.einsum("bkgh,btkh->bkgt", q[:, 0].float(),
                          ck.float()) * (hd ** -0.5)
    slot_ids = torch.arange(cl, device=x.device)[None, :]      # (1, cl)
    if is_swa:
        # slot s holds absolute position p' with p' % cl == s and
        # p' in (pos - cl, pos]; valid once written
        ahead = (slot_ids > slot[:, None]).to(positions.dtype)
        abs_pos = (positions[:, None] // cl - ahead) * cl + slot_ids
        valid = ((abs_pos >= 0) & (abs_pos <= positions[:, None])
                 & (abs_pos > positions[:, None] - cl))
    else:
        valid = slot_ids <= positions[:, None]
    scores = scores.masked_fill(~valid[:, None, None], NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgt,btkh->bkgh", w.to(cv.dtype), cv)
    out = out.reshape(B, 1, H * hd) @ p["wo"]
    return out, KVCache(ck, cv)
