"""Decoder blocks + layer-stacked training forward, prefill and decode
for every family (twin of ``repro.models.transformer``): dense and MoE
attention blocks, Mamba-1 and Mamba-2 blocks, and the zamba2 hybrid,
whose groups of Mamba-2 blocks are each followed by one weight-tied
attention(+MLP) block.

Layer parameters are stacked along a leading L axis, as in the JAX tree;
where the JAX package runs ``lax.scan`` over that axis, the port runs a
Python loop over the layers.  Prefill and decode take layer slices
(views, no copies).  The training forward takes ``unbind(0)`` of each
stacked leaf once, so backward writes each leaf's gradient with one
``stack`` (indexing layer by layer would add a full-size zero gradient
per layer per leaf).  Its remat modes mirror the JAX package's:
``none``, ``full`` (a checkpoint per layer, saving nothing) and ``dots``
(a selective checkpoint that saves the matmuls' outputs, the
``dots_with_no_batch_dims_saveable`` policy: ``mm`` / ``addmm`` are the
products without batch dims, attention's batched ``bmm`` is recomputed).
The hybrid's tied block is checkpointed the same way.  Caches come back
stacked; the hybrid keeps one KV cache per application of its tied
block.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import constrain, stack_trees, tree_map
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (mlp_apply, mlp_template, rmsnorm,
                                       rmsnorm_template)

SSM_ALGOS = ("scan", "ssd")


def _stack(tpl, n: int):
    return tree_map(lambda p: p.stack(n), tpl)


def layer_slice(tree, i: int):
    """Layer ``i`` of a layer-stacked tree (views of the stacked tensors)."""
    return tree_map(lambda a: a[i], tree)


def block_template(cfg: ArchConfig) -> Dict[str, Any]:
    """Template for ONE layer of the arch's repeated block."""
    D = cfg.d_model
    if cfg.has_ssm:        # ssm + hybrid families: pure SSM repeated block
        tpl = (ssm_mod.mamba1_template if cfg.ssm_variant == "mamba1"
               else ssm_mod.mamba2_template)
        return {"ln": rmsnorm_template(D), "ssm": tpl(cfg)}
    return {
        "ln1": rmsnorm_template(D),
        "attn": attn.attn_template(cfg),
        "ln2": rmsnorm_template(D),
        "mlp": (moe_mod.moe_template(cfg) if cfg.is_moe
                else mlp_template(D, cfg.d_ff, cfg.mlp)),
    }


def shared_attn_template(cfg: ArchConfig) -> Dict[str, Any]:
    """zamba2's single weight-tied attention(+MLP) block."""
    D = cfg.d_model
    return {
        "ln1": rmsnorm_template(D),
        "attn": attn.attn_template(cfg),
        "ln2": rmsnorm_template(D),
        "mlp": mlp_template(D, cfg.d_ff, cfg.mlp),
    }


def hybrid_groups(cfg: ArchConfig) -> List[int]:
    """Split n_layers SSM blocks into groups; the shared attention runs
    after each group.  38 layers, attn_every=6 -> [6]*6 + [2]."""
    k = cfg.attn_every
    full, rem = divmod(cfg.n_layers, k)
    return [k] * full + ([rem] if rem else [])


def stack_template(cfg: ArchConfig) -> Dict[str, Any]:
    out = {"layers": _stack(block_template(cfg), cfg.n_layers)}
    if cfg.family == "hybrid":
        out["shared_attn"] = shared_attn_template(cfg)
    return out


def stack_cache_template(cfg: ArchConfig, batch: int,
                         seq_len: int) -> Dict[str, Any]:
    if not cfg.has_ssm:
        return {"layers": _stack(attn.cache_template(cfg, batch, seq_len),
                                 cfg.n_layers)}
    out = {"layers": _stack(ssm_mod.mamba1_cache_template(cfg, batch),
                            cfg.n_layers)}
    if cfg.family == "hybrid":
        # the weights are tied, but each application has its own KV cache
        out["shared_attn"] = _stack(attn.cache_template(cfg, batch, seq_len),
                                    len(hybrid_groups(cfg)))
    return out


# ---------------------------------------------------------------------------
# Training forward (no cache)
# ---------------------------------------------------------------------------

REMAT_POLICIES = ("none", "full", "dots")
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _maybe_remat(fn, policy: str):
    if policy == "none":
        return fn
    if policy == "dots":
        ctx = functools.partial(create_selective_checkpoint_contexts,
                                _save_dots)
        return functools.partial(checkpoint, fn, use_reentrant=False,
                                 context_fn=ctx)
    if policy == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    raise ValueError(f"unknown remat policy {policy!r}; one of "
                     f"{REMAT_POLICIES}")


def _ssm_fn(cfg: ArchConfig, ssm_algo: str):
    if cfg.ssm_variant == "mamba1":
        return ssm_mod.mamba1_apply
    if ssm_algo not in SSM_ALGOS:
        raise ValueError(f"unknown ssm_algo {ssm_algo!r}; one of "
                         f"{SSM_ALGOS}")
    return (ssm_mod.mamba2_apply_ssd if ssm_algo == "ssd"
            else ssm_mod.mamba2_apply)


def _ffn(cfg: ArchConfig, p, h) -> torch.Tensor:
    """The block's MLP or MoE on h (prefill and decode drop the MoE's aux
    loss)."""
    if cfg.is_moe:
        return moe_mod.moe_apply(cfg, p, h)[0]
    return mlp_apply(p, h, cfg.mlp)


def block_apply(cfg: ArchConfig, p, x, positions, *, attn_chunk: int,
                ssm_chunk: int, ssm_algo: str = "scan"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One repeated block.  Returns (x, aux_loss_increment)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    x = constrain(x, "batch", "seq", None)
    if cfg.has_ssm:
        fn = _ssm_fn(cfg, ssm_algo)
        y = fn(cfg, p["ssm"], rmsnorm(x, p["ln"], cfg.norm_eps),
               chunk=ssm_chunk)
        return constrain(x + y, "batch", "seq", None), aux
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    x = x + attn.attention_apply(cfg, p["attn"], h, positions,
                                 chunk=attn_chunk)
    x = constrain(x, "batch", "seq", None)
    h = rmsnorm(x, p["ln2"], cfg.norm_eps)
    if cfg.is_moe:
        y, aux = moe_mod.moe_apply(cfg, p["mlp"], h)
        x = x + y
    else:
        x = x + mlp_apply(p["mlp"], h, cfg.mlp)
    return constrain(x, "batch", "seq", None), aux


def shared_attn_apply(cfg: ArchConfig, p, x, positions, *,
                      attn_chunk: int) -> torch.Tensor:
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    x = x + attn.attention_apply(cfg, p["attn"], h, positions,
                                 chunk=attn_chunk)
    h = rmsnorm(x, p["ln2"], cfg.norm_eps)
    return x + mlp_apply(p["mlp"], h, cfg.mlp)


def unstack_layers(tree, n: int) -> list:
    """The per-layer trees of a layer-stacked tree: ``unbind(0)`` of each
    leaf, taken once."""
    parts = tree_map(lambda a: a.unbind(0), tree)
    return [tree_map(lambda t: t[i], parts) for i in range(n)]


def stack_apply(cfg: ArchConfig, params, x, positions, *,
                remat: str = "full", attn_chunk: int = 1024,
                ssm_chunk: int = 64, ssm_algo: str = "scan"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run all layers (the training forward).  Returns (hidden, aux); the
    hybrid runs its tied block after each group of SSM blocks."""
    def layer(x, pl):
        return block_apply(cfg, pl, x, positions, attn_chunk=attn_chunk,
                           ssm_chunk=ssm_chunk, ssm_algo=ssm_algo)

    layer = _maybe_remat(layer, remat)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    layers = unstack_layers(params["layers"], cfg.n_layers)
    if cfg.family != "hybrid":
        for pl in layers:
            x, a = layer(x, pl)
            aux = aux + a
        return x, aux
    shared = _maybe_remat(functools.partial(
        shared_attn_apply, cfg, params["shared_attn"],
        positions=positions, attn_chunk=attn_chunk), remat)
    off = 0
    for g in hybrid_groups(cfg):
        for pl in layers[off:off + g]:
            x, a = layer(x, pl)
            aux = aux + a
        x = shared(x)
        off += g
    return x, aux


def _ssm_prefill(cfg: ArchConfig, pl, x, ssm_algo: str, ssm_chunk: int,
                 use_kernel: bool):
    """One SSM layer's prefill -> (x, {"h", "conv"}): the scan through K6
    (or its plain version), or the SSD form in chunks of ``ssm_chunk``."""
    h = rmsnorm(x, pl["ln"], cfg.norm_eps)
    fn = _ssm_fn(cfg, ssm_algo)
    if fn is ssm_mod.mamba2_apply_ssd:
        y, cache = fn(cfg, pl["ssm"], h, chunk=ssm_chunk, return_state=True)
    else:
        y, cache = fn(cfg, pl["ssm"], h, return_state=True,
                      use_kernel=use_kernel)
    return x + y, cache


def _attn_prefill(cfg: ArchConfig, p, x, positions, cache_len: int,
                  use_kernel: bool):
    """An attention block's prefill (a stacked layer or the hybrid's tied
    block) -> (x, {"k", "v"})."""
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    y, kv = attn.attention_prefill(cfg, p["attn"], h, positions, cache_len,
                                   use_kernel=use_kernel)
    x = x + y
    x = x + _ffn(cfg, p["mlp"], rmsnorm(x, p["ln2"], cfg.norm_eps))
    return x, {"k": kv.k, "v": kv.v}


def stack_prefill(cfg: ArchConfig, params, x, positions, cache_len: int, *,
                  use_kernel: bool = True, ssm_algo: str = "scan",
                  ssm_chunk: int = 64):
    """Prefill all layers; returns (hidden, caches) with the layer caches
    stacked under "layers" (and the hybrid's per-application KV caches
    under "shared_attn")."""
    caches = []
    shared = []
    groups = (hybrid_groups(cfg) if cfg.family == "hybrid"
              else [cfg.n_layers])
    off = 0
    for g in groups:
        for i in range(off, off + g):
            pl = layer_slice(params["layers"], i)
            if cfg.has_ssm:
                x, c = _ssm_prefill(cfg, pl, x, ssm_algo, ssm_chunk,
                                    use_kernel)
            else:
                x, c = _attn_prefill(cfg, pl, x, positions, cache_len,
                                     use_kernel)
            caches.append(c)
        if cfg.family == "hybrid":
            x, c = _attn_prefill(cfg, params["shared_attn"], x, positions,
                                 cache_len, use_kernel)
            shared.append(c)
        off += g
    out = {"layers": stack_trees(caches)}
    if shared:
        out["shared_attn"] = stack_trees(shared)
    return x, out


def _attn_decode(cfg: ArchConfig, p, cache, x, positions, rope_positions):
    """An attention block's decode step; its KV cache is written in
    place."""
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    y, _ = attn.attention_decode(cfg, p["attn"], h,
                                 attn.KVCache(cache["k"], cache["v"]),
                                 positions, rope_positions)
    x = x + y
    return x + _ffn(cfg, p["mlp"], rmsnorm(x, p["ln2"], cfg.norm_eps))


def stack_decode(cfg: ArchConfig, params, caches, x, positions,
                 rope_positions=None):
    """One decode step through all layers.  x: (B, 1, D); positions (B,)
    are linear cache slots; ``rope_positions`` (B, 3) optionally carries
    M-RoPE ids.  Attention caches are updated in place; the SSM state and
    conv history of each layer are written back into the stacked cache.
    Returns (hidden, caches)."""
    step = (ssm_mod.mamba1_step if cfg.ssm_variant == "mamba1"
            else ssm_mod.mamba2_step)
    groups = (hybrid_groups(cfg) if cfg.family == "hybrid"
              else [cfg.n_layers])
    off = 0
    for gi, g in enumerate(groups):
        for i in range(off, off + g):
            pl = layer_slice(params["layers"], i)
            cl = layer_slice(caches["layers"], i)
            if not cfg.has_ssm:
                x = _attn_decode(cfg, pl, cl, x, positions, rope_positions)
                continue
            h = rmsnorm(x, pl["ln"], cfg.norm_eps)
            y, nc = step(cfg, pl["ssm"], h[:, 0],
                         ssm_mod.SSMCache(cl["h"], cl["conv"]))
            cl["h"].copy_(nc.h)
            cl["conv"].copy_(nc.conv)
            x = x + y[:, None]
        if cfg.family == "hybrid":
            x = _attn_decode(cfg, params["shared_attn"],
                             layer_slice(caches["shared_attn"], gi), x,
                             positions, rope_positions)
        off += g
    return x, caches
