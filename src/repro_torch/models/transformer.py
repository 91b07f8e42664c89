"""Decoder blocks + layer-stacked prefill/decode for the ``dense`` and
``ssm`` families (twin of the cache-carrying half of
``repro.models.transformer``).

Layer parameters are stacked along a leading L axis, as in the JAX tree;
where the JAX package runs ``lax.scan`` over that axis, the port runs a
Python loop over layer slices (views, no copies).  Caches come back
stacked the same way.  MoE and the zamba2 hybrid are not ported yet.
"""
from __future__ import annotations

from typing import Any, Dict

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
