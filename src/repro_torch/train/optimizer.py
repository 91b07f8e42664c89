"""AdamW with bf16 params + f32 moments, global-norm clipping, LR schedule
(twin of ``repro.train.optimizer``).

Plain functions over the port's nested-dict trees.  The arithmetic is the
JAX package's, op for op and in its order (f32 moments, the bias
corrections ``b ** t`` in f32, decoupled weight decay on every leaf with
``ndim >= 2``, the stacked norm scales and Mamba's ``A_log`` included).
``adamw_update`` writes the new parameters and moments into the tensors
it is given, the port's counterpart of a jitted JAX step whose state is
donated: in-place ops round as the out-of-place form does, and a
multi-GB model's step holds one copy of its state (granite-3-2b's
functional update needs 26 GB more than the 37 GB state at its peak) and
a few f32 buffers of one leaf.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.distributed.sharding import Param, tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to 10 %, in f32."""
    step = torch.as_tensor(step).float()
    warm = cfg.lr_peak * step / max(cfg.warmup_steps, 1)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.lr_peak * (0.1 + 0.45 * (1 + torch.cos(math.pi * frac)))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def opt_template(param_template) -> Dict[str, Any]:
    """Moment templates mirror the parameter shapes in f32."""
    def f32(p: Param) -> Param:
        return dataclasses.replace(p, dtype=torch.float32, init="zeros")
    return {"mu": tree_map(f32, param_template),
            "nu": tree_map(f32, param_template)}


def init_opt(params) -> Dict[str, Any]:
    def z():
        return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)
    return {"mu": z(), "nu": z()}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares, leaf by leaf in sorted key order (the
    JAX package's ``jax.tree.leaves`` order)."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, opt, step
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step.  params bf16 (or f32), grads any float, moments
    f32.  Updates ``params`` and ``opt``'s tensors in place and returns
    the same trees; callers that keep the old values pass copies."""
    gnorm = global_norm(grads)
    scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9),
                            1.0)
    lr = lr_at(cfg, step)
    t = (torch.as_tensor(step) + 1).float()
    c1 = 1 - cfg.b1 ** t
    c2 = 1 - cfg.b2 ** t

    def upd(p, g, mu, nu):
        g = g.float() * scale
        mu.mul_(cfg.b1)
        mu += (1 - cfg.b1) * g
        g2 = (1 - cfg.b2) * g
        g2 *= g
        nu.mul_(cfg.b2)
        nu += g2
        del g, g2
        d = nu / c2
        d.sqrt_()
        d += cfg.eps
        u = mu / c1
        u /= d
        del d
        # decoupled weight decay on matrices only (ndim >= 2)
        if p.dim() >= 2:
            u += cfg.weight_decay * p.float()
        u *= lr
        p.copy_(p.float() - u)

    tree_map(upd, params, grads, opt["mu"], opt["nu"])
    return params, opt, {"grad_norm": gnorm, "lr": lr}
