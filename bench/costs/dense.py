"""FLOPs of the dense family (granite-3-2b): a stack of attention + SwiGLU
blocks.  A token costs 2 FLOPs per weight of the products it goes through
(q, k, v, o and the MLP in every layer; the output head only where a
token is sampled), plus the causal attention's two products at its
position, 4 FLOPs per (key, head, dim).  Norms, RoPE and the softmax are
not counted.  ``cfg`` is the benchmark's configuration file (sizes under
the port's ``ArchConfig`` names)."""
from __future__ import annotations

from typing import Dict


def _block_weights(cfg: Dict) -> int:
    D, H, K, hd, F = (cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"],
                      cfg["head_dim"], cfg["d_ff"])
    return D * H * hd + 2 * D * K * hd + H * hd * D + 3 * D * F


def attention_layers(cfg: Dict) -> int:
    """Attention applications a token passes (K5 calls a prefill)."""
    return cfg["n_layers"]


def scan_layers(cfg: Dict) -> int:
    """Selective-scan layers a token passes (K6 calls a prefill)."""
    return 0


def token_weights(cfg: Dict) -> int:
    """Weights of the products every token goes through (no head)."""
    return cfg["n_layers"] * _block_weights(cfg)


def _attn_per_key(cfg: Dict) -> int:
    return attention_layers(cfg) * 4 * cfg["n_heads"] * cfg["head_dim"]


def prefill_flops(cfg: Dict, B: int, S: int) -> int:
    """One prefill of B rows of S tokens: every token's products and its
    causal attention over S (S + 1) / 2 (row, key) pairs, the head once a
    row (the last prompt token's)."""
    head = 2 * cfg["d_model"] * cfg["vocab"]
    return B * (2 * S * token_weights(cfg)
                + _attn_per_key(cfg) * S * (S + 1) // 2 + head)


def decode_flops(cfg: Dict, B: int, pos: int) -> int:
    """One decode step of B rows, the new token at position ``pos``
    (0-based): its products, attention over pos + 1 keys, the head."""
    head = 2 * cfg["d_model"] * cfg["vocab"]
    return B * (2 * token_weights(cfg) + _attn_per_key(cfg) * (pos + 1)
                + head)
