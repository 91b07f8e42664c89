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
query row per sequence against the cache, which it reads in place: two
batched products a step and layer, each on a view of a cache, bf16
products summed in f32 (no f32 or permuted copy of the cache).
"""
from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import (Param, constrain, is_dtensor,
                                              local_rows, matmul, reshape,
                                              write_rows)
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
        # on a mesh, each rank attends its own rows and kv heads (the
        # products flatten (batch, head) into one bmm dim, which DTensor
        # cannot always place); a split of the query heads within a kv
        # group, or of the sequence, is gathered there
        return local_rows(functools.partial(
            attention_core, window=window, q_offset=q_offset, chunk=chunk),
            q, k, v, dims=(0, 2))
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
    q = constrain(reshape(matmul(x, p["wq"]), B, S, K, H // K, hd),
                  "batch", "seq", "kv_heads", None, None)
    k = constrain(reshape(matmul(x, p["wk"]), B, S, K, hd),
                  "batch", "seq", "kv_heads", None)
    v = constrain(reshape(matmul(x, p["wv"]), B, S, K, hd),
                  "batch", "seq", "kv_heads", None)
    if cfg.rope != "none":
        q = reshape(apply_rope(reshape(q, B, S, H, hd), positions,
                               cfg.rope_theta), B, S, K, H // K, hd)
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
    return matmul(reshape(out, B, S, cfg.n_heads * cfg.head_dim), p["wo"])


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
    # K5 on DTensors: each rank runs its own rows and kv heads (q's heads
    # split as k's: head h reads kv head h // G)
    out = local_rows(functools.partial(
        flash_attention_op, window=window, use_kernel=use_kernel),
        reshape(q, B, S, H, hd).transpose(1, 2), k.transpose(1, 2),
        v.transpose(1, 2), dims=(0, 1))
    out = reshape(out.transpose(1, 2), B, S, H * hd)
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
    return matmul(out, p["wo"]), KVCache(ck, cv)


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
    if is_dtensor(positions):
        # the (B,) positions whole on every rank: the mask's integer math
        # (floor division) has no DTensor rule
        positions = positions.full_tensor()
    rp = positions if rope_positions is None else rope_positions
    q, k_new, v_new = _project_qkv(cfg, p, x, rp[:, None])
    ck, cv = cache
    cl = ck.shape[1]
    is_swa = cfg.attention == "swa"
    slot = positions % cl if is_swa else positions
    write_rows(ck, slot, k_new[:, 0])
    write_rows(cv, slot, v_new[:, 0])

    if is_dtensor(ck):
        out = _decode_attend_split(q[:, 0], ck, cv, positions, slot,
                                   is_swa)
        return matmul(reshape(out, B, 1, H * hd), p["wo"]), KVCache(ck, cv)
    out = _decode_attend(q[:, 0], ck, cv, positions, slot, is_swa)
    out = out.reshape(B, 1, H * hd) @ p["wo"]
    return out, KVCache(ck, cv)


def _decode_attend(q, ck, cv, positions, slot, is_swa: bool):
    """Decode attention on one device: q (B, K, G, hd) against the caches
    (B, cl, K, hd), read in place as (B, cl, K·hd) matrices.

    Each product is one batched matmul over the rows, on the cache's own
    layout.  q goes in block-diagonal, (B, H, K·hd) with head (k, g)'s
    query in kv head k's block and zeros elsewhere, so a head's scores
    against all K·hd columns are its own products plus exact zeros; the
    values are weighted for every (head, kv head) pair and the diagonal
    blocks kept.  The products grow K-fold and cost nothing beside the
    cache's bytes (H FLOPs a byte, against the card's ~295), where one
    product per kv head on strided views ran cuBLAS's small-N kernels
    far below the card's bandwidth.  The scores and weights are laid out
    (B, cl, H), heads innermost, so every operand's and result's
    contiguous dim is H or K·hd: cuBLAS falls back to element-aligned
    kernels, several times slower, where one is not a multiple of 8, as
    the served caches' 3,021 slots are not.  The scores are f32 sums of
    the products (``bmm``'s ``out_dtype``: a product of two bf16 values
    is exact in f32), scaled, masked to the live slots and softmaxed in
    f32; the weights, rounded to the cache's dtype, weight the values.
    Returns (B, K, G, hd) in the cache's dtype, a view."""
    B, K, G, hd = q.shape
    H, cl = K * G, ck.shape[1]
    scores = _decode_scores(q, ck) * (hd ** -0.5)
    slot_ids = torch.arange(cl, device=q.device)[None, :]      # (1, cl)
    valid = _live_slots(slot_ids, positions, slot, cl, is_swa)
    scores = scores.masked_fill(~valid[:, :, None], NEG_INF)
    # softmax over slots made innermost (torch's softmax over an inner dim
    # runs several times slower), the weights back to heads innermost
    w = torch.softmax(scores.transpose(1, 2), dim=-1).transpose(1, 2)
    w = w.to(cv.dtype, memory_format=torch.contiguous_format)
    out = torch.bmm(w.transpose(1, 2), cv.view(B, cl, K * hd))
    return out.view(B, K, G, K, hd).diagonal(0, 1, 3).permute(0, 3, 1, 2)


def _decode_scores(q, ck):
    """(B, cl, H) f32, head h = k·G + g: q (B, K, G, hd) times the K cache
    (B, cl, K, hd) with f32 sums, as one batched product of a view of the
    cache and the block-diagonal q (``_decode_attend``)."""
    B, K, G, hd = q.shape
    cl = ck.shape[1]
    qd = q.new_zeros((B, K, G, K, hd))
    qd.diagonal(0, 1, 3).copy_(q.permute(0, 2, 3, 1))
    qd = qd.view(B, K * G, K * hd).transpose(1, 2)
    keys = ck.view(B, cl, K * hd)
    if ck.dtype == torch.float32:
        return torch.bmm(keys, qd)
    return torch.bmm(keys, qd, out_dtype=torch.float32)


def _bmm_out_dtype_cpu(a, b, out_dtype):
    """aten's ``bmm.dtype`` on the CPU, where torch has none (the card's
    is cuBLAS's): the product of the operands cast to ``out_dtype``, one
    batch entry at a time, so no cast of a whole cache is held.  Every
    device then runs the same aten ops, and ``launch.step_cost`` counts
    the card's decode step on the CPU and on meta alike."""
    out = a.new_empty((a.shape[0], a.shape[1], b.shape[2]), dtype=out_dtype)
    for i in range(a.shape[0]):
        torch.mm(a[i].to(out_dtype), b[i].to(out_dtype), out=out[i])
    return out


_ATEN_CPU = torch.library.Library("aten", "IMPL")
if not torch._C._dispatch_has_kernel_for_dispatch_key("aten::bmm.dtype",
                                                      "CPU"):
    _ATEN_CPU.impl("bmm.dtype", _bmm_out_dtype_cpu, "CPU")


def _live_slots(slot_ids, positions, slot, cl: int, is_swa: bool):
    """(B, len(slot_ids)): which cache slots hold a position the new
    token attends to."""
    if is_swa:
        # slot s holds absolute position p' with p' % cl == s and
        # p' in (pos - cl, pos]; valid once written
        ahead = (slot_ids > slot[:, None]).to(positions.dtype)
        abs_pos = (positions[:, None] // cl - ahead) * cl + slot_ids
        return ((abs_pos >= 0) & (abs_pos <= positions[:, None])
                & (abs_pos > positions[:, None] - cl))
    return slot_ids <= positions[:, None]


def _decode_attend_split(q, ck, cv, positions, slot, is_swa: bool):
    """Decode attention against a DTensor cache (rows, positions and kv
    heads split over the mesh), each rank on the cache entries it holds:
    the softmax over positions split across ranks takes the max and the
    sum across them (collectives of those mesh dims), and so does the
    weighted sum of values.  q (B, K, G, hd) and the (B,) positions are
    taken whole; returns (B, K, G, hd) split as the cache's rows and
    heads.  (DTensor's einsum flattens a split position dim, which torch
    2.11 refuses.)"""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    mesh, cl, hd = ck.device_mesh, ck.shape[1], ck.shape[-1]
    (nb, nt, nk, _), (b0, t0, k0, _) = compute_local_shape_and_global_offset(
        ck.shape, mesh, ck.placements)
    groups = [mesh.get_group(i) for i, p in enumerate(ck.placements)
              if isinstance(p, Shard) and p.dim % 4 == 1]
    qw = q.full_tensor() if is_dtensor(q) else q
    q_loc = qw[b0:b0 + nb, k0:k0 + nk]
    pos = positions[b0:b0 + nb]
    slot_ids = torch.arange(t0, t0 + nt, device=pos.device)[None, :]
    valid = _live_slots(slot_ids, pos, slot[b0:b0 + nb], cl, is_swa)
    s = torch.einsum("bkgh,btkh->bkgt", q_loc.float(),
                     ck.to_local().float()) * (hd ** -0.5)
    s = s.masked_fill(~valid[:, None, None], NEG_INF)
    m = s.amax(-1, keepdim=True)
    for g in groups:
        torch.distributed.all_reduce(m, torch.distributed.ReduceOp.MAX,
                                     group=g)
    e = torch.exp(s - m)
    den = e.sum(-1, keepdim=True)
    out = torch.einsum("bkgt,btkh->bkgh", e.to(cv.dtype), cv.to_local())
    for g in groups:
        torch.distributed.all_reduce(den, group=g)
        torch.distributed.all_reduce(out, group=g)
    out = (out.float() / den).to(cv.dtype)
    pl = [Shard(0) if isinstance(p, Shard) and p.dim % 4 == 0 else
          Shard(1) if isinstance(p, Shard) and p.dim % 4 == 2 else
          Replicate() for p in ck.placements]
    return DTensor.from_local(out, mesh, pl, run_check=False)
