"""Decoder blocks + layer-stacked training forward, prefill and decode
for the ``dense`` and ``ssm`` families (twin of
``repro.models.transformer``).

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
Caches come back stacked.  MoE and the zamba2 hybrid are not ported yet.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import stack_trees, tree_map
from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (mlp_apply, mlp_template, rmsnorm,
                                       rmsnorm_template)

_NOT_PORTED = {
    "moe": "MoE blocks are not ported yet: ROADMAP Queue 1 item M4 (MoE)",
    "hybrid": ("the zamba2 hybrid is not ported yet: ROADMAP Queue 1 item "
               "M5 (Mamba-2 and the zamba2 hybrid)"),
    "mamba2": ("Mamba-2 is not ported yet: ROADMAP Queue 1 item M5 "
               "(Mamba-2 and the zamba2 hybrid)"),
}


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` naming the ROADMAP item for what the
    port does not run yet."""
    if cfg.is_moe:
        raise NotImplementedError(_NOT_PORTED["moe"])
    if cfg.family == "hybrid":
        raise NotImplementedError(_NOT_PORTED["hybrid"])
    if cfg.has_ssm and cfg.ssm_variant != "mamba1":
        raise NotImplementedError(_NOT_PORTED["mamba2"])


def _stack(tpl, n: int):
    return tree_map(lambda p: p.stack(n), tpl)


def layer_slice(tree, i: int):
    """Layer ``i`` of a layer-stacked tree (views of the stacked tensors)."""
    return tree_map(lambda a: a[i], tree)


def block_template(cfg: ArchConfig) -> Dict[str, Any]:
    """Template for ONE layer of the arch's repeated block."""
    check_supported(cfg)
    D = cfg.d_model
    if cfg.has_ssm:
        return {"ln": rmsnorm_template(D), "ssm": ssm_mod.mamba1_template(cfg)}
    return {
        "ln1": rmsnorm_template(D),
        "attn": attn.attn_template(cfg),
        "ln2": rmsnorm_template(D),
        "mlp": mlp_template(D, cfg.d_ff, cfg.mlp),
    }


def stack_template(cfg: ArchConfig) -> Dict[str, Any]:
    return {"layers": _stack(block_template(cfg), cfg.n_layers)}


def stack_cache_template(cfg: ArchConfig, batch: int,
                         seq_len: int) -> Dict[str, Any]:
    check_supported(cfg)
    tpl = (ssm_mod.mamba1_cache_template(cfg, batch) if cfg.has_ssm
           else attn.cache_template(cfg, batch, seq_len))
    return {"layers": _stack(tpl, cfg.n_layers)}


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


def block_apply(cfg: ArchConfig, p, x, positions, *, attn_chunk: int,
                ssm_chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One repeated block.  Returns (x, aux_loss_increment)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.has_ssm:
        return x + ssm_mod.mamba1_apply(
            cfg, p["ssm"], rmsnorm(x, p["ln"], cfg.norm_eps),
            chunk=ssm_chunk), aux
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    x = x + attn.attention_apply(cfg, p["attn"], h, positions,
                                 chunk=attn_chunk)
    h = rmsnorm(x, p["ln2"], cfg.norm_eps)
    return x + mlp_apply(p["mlp"], h, cfg.mlp), aux


def unstack_layers(tree, n: int) -> list:
    """The per-layer trees of a layer-stacked tree: ``unbind(0)`` of each
    leaf, taken once."""
    parts = tree_map(lambda a: a.unbind(0), tree)
    return [tree_map(lambda t: t[i], parts) for i in range(n)]


def stack_apply(cfg: ArchConfig, params, x, positions, *,
                remat: str = "full", attn_chunk: int = 1024,
                ssm_chunk: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run all layers (the training forward).  Returns (hidden, aux)."""
    check_supported(cfg)

    def layer(x, pl):
        return block_apply(cfg, pl, x, positions, attn_chunk=attn_chunk,
                           ssm_chunk=ssm_chunk)

    layer = _maybe_remat(layer, remat)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for pl in unstack_layers(params["layers"], cfg.n_layers):
        x, a = layer(x, pl)
        aux = aux + a
    return x, aux


def _layer_prefill(cfg: ArchConfig, pl, x, positions, cache_len: int,
                   use_kernel: bool):
    """One layer prefill -> (x, layer_cache)."""
    if cfg.has_ssm:
        h = rmsnorm(x, pl["ln"], cfg.norm_eps)
        y, cache = ssm_mod.mamba1_apply(cfg, pl["ssm"], h, return_state=True,
                                        use_kernel=use_kernel)
        return x + y, cache
    h = rmsnorm(x, pl["ln1"], cfg.norm_eps)
    y, kv = attn.attention_prefill(cfg, pl["attn"], h, positions, cache_len,
                                   use_kernel=use_kernel)
    x = x + y
    h = rmsnorm(x, pl["ln2"], cfg.norm_eps)
    x = x + mlp_apply(pl["mlp"], h, cfg.mlp)
    return x, {"k": kv.k, "v": kv.v}


def stack_prefill(cfg: ArchConfig, params, x, positions, cache_len: int, *,
                  use_kernel: bool = True):
    """Prefill all layers; returns (hidden, {"layers": stacked caches})."""
    caches = []
    for i in range(cfg.n_layers):
        x, c = _layer_prefill(cfg, layer_slice(params["layers"], i), x,
                              positions, cache_len, use_kernel)
        caches.append(c)
    return x, {"layers": stack_trees(caches)}


def stack_decode(cfg: ArchConfig, params, caches, x, positions):
    """One decode step through all layers.  x: (B, 1, D); positions (B,)
    are linear cache slots.  Attention caches are updated in place; the
    SSM state and conv history of each layer are written back into the
    stacked cache.  Returns (hidden, caches)."""
    for i in range(cfg.n_layers):
        pl = layer_slice(params["layers"], i)
        cl = layer_slice(caches["layers"], i)
        if cfg.has_ssm:
            h = rmsnorm(x, pl["ln"], cfg.norm_eps)
            y, nc = ssm_mod.mamba1_step(cfg, pl["ssm"], h[:, 0],
                                        ssm_mod.SSMCache(cl["h"], cl["conv"]))
            cl["h"].copy_(nc.h)
            cl["conv"].copy_(nc.conv)
            x = x + y[:, None]
            continue
        h = rmsnorm(x, pl["ln1"], cfg.norm_eps)
        y, _ = attn.attention_decode(cfg, pl["attn"], h,
                                     attn.KVCache(cl["k"], cl["v"]),
                                     positions)
        x = x + y
        h = rmsnorm(x, pl["ln2"], cfg.norm_eps)
        x = x + mlp_apply(pl["mlp"], h, cfg.mlp)
    return x, caches
