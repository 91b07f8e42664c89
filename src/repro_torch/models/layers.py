"""Shared layer primitives: norms, RoPE / M-RoPE, MLP variants,
embeddings (twin of ``repro.models.layers``).

Params are declarative ``Param`` templates; forward functions take plain
dicts of tensors.  Compute dtype follows the parameters (bf16 by default),
with f32 inside the norm, f32 logits and an f32 loss, as in the JAX
package.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (Param, constrain, gather_last,
                                              is_dtensor, lookup_rows, matmul)

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm_template(d: int) -> Param:
    return Param((d,), (None,), init="ones", dtype=torch.float32)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    xf = x.float()
    scale = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * scale * w).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """(head_dim//2,) inverse frequencies."""
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, n_heads, head_dim); positions: (..., S), or (..., S, 3)
    for M-RoPE (temporal / height / width, qwen2-vl style): the first half
    of the frequency channels turns by the temporal id, the next quarter
    by the height id and the last quarter by the width id."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, x.device)             # (hd/2,)
    if positions.dim() == x.dim() - 2:                # plain RoPE
        ang = positions[..., None].float() * inv      # (..., S, hd/2)
    else:                                             # M-RoPE: (..., S, 3)
        n = inv.shape[0]
        s1, s2 = n // 2, (3 * n) // 4
        sec = torch.zeros((n,), dtype=torch.long, device=x.device)
        sec[s1:s2] = 1
        sec[s2:] = 2
        pos = torch.index_select(positions.float(), -1, sec)  # (..., S, n)
        ang = pos * inv
    cos = torch.cos(ang)[..., None, :]                # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs: SwiGLU / squared-ReLU (nemotron) / GELU (musicgen)
# ---------------------------------------------------------------------------


def mlp_template(d: int, f: int, kind: str) -> Dict[str, Param]:
    if kind == "swiglu":
        return {
            "w_gate": Param((d, f), ("fsdp", "tp")),
            "w_up": Param((d, f), ("fsdp", "tp")),
            "w_down": Param((f, d), ("tp", "fsdp")),
        }
    return {
        "w_up": Param((d, f), ("fsdp", "tp")),
        "w_down": Param((f, d), ("tp", "fsdp")),
    }


def mlp_apply(p: Dict[str, torch.Tensor], x: torch.Tensor,
              kind: str) -> torch.Tensor:
    if kind == "swiglu":
        h = F.silu(matmul(x, p["w_gate"])) * matmul(x, p["w_up"])
    elif kind == "relu2":
        h = torch.square(F.relu(matmul(x, p["w_up"])))
    elif kind == "gelu":
        # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(matmul(x, p["w_up"]), approximate="tanh")
    else:
        raise ValueError(f"unknown mlp kind {kind!r}")
    h = constrain(h, "batch", "seq", "tp")
    return matmul(h, p["w_down"])


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------


def embed_template(vocab: int, d: int) -> Param:
    return Param((vocab, d), ("vocab", "fsdp"), init="embed", scale=0.02)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    if is_dtensor(table):
        return lookup_rows(table, tokens)
    return table[tokens]


def lm_head(table_or_w: torch.Tensor, x: torch.Tensor, *,
            tied: bool) -> torch.Tensor:
    w = table_or_w.T if tied else table_or_w
    return matmul(x, w.to(x.dtype)).float()


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean cross-entropy over valid tokens; logits (B, S, V), computed
    in f32."""
    logits = logits.float()
    lz = torch.logsumexp(logits, dim=-1)
    gold = gather_last(logits, labels)
    nll = lz - gold
    if mask is None:
        return torch.mean(nll)
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
