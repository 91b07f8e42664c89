"""Plain float32 forward of the dense family (granite-3-2b as the port's
configuration states it): token embedding, ``n_layers`` blocks of
pre-norm causal GQA attention with RoPE and a pre-norm SwiGLU MLP, each
added to the residual stream, a final RMSNorm and the output head."""
from __future__ import annotations

from typing import Dict

import torch

from bench.reference import common


@torch.no_grad()
def logits(cfg: Dict, params: Dict, tokens: torch.Tensor, first: int,
           precision: str = "f32") -> torch.Tensor:
    """tokens (R, S) int64 -> (R, S - first, vocab) float32 logits at
    positions first..S-1, layer by layer."""
    x = common.embed(params, tokens)
    layers = params["stack"]["layers"]
    for i in range(cfg["n_layers"]):
        x = common.attention_block(cfg, common.layer(layers, i), x,
                                   precision)
    return common.head(cfg, params, x[:, first:], precision)
