"""FLOPs of the hybrid family (zamba2-1.2b): n_layers Mamba-2 blocks, and
one weight-tied attention + SwiGLU block applied after each group of
``attn_every`` of them (and after the shorter last group).  A token costs
2 FLOPs per weight of the products it goes through (every Mamba-2 block's
in and out projections and conv taps, the tied block's products once per
application, the head only where a token is sampled), the causal
attention's two products at its position in each application (4 FLOPs per
(key, head, dim)), and the selective scan's 5 FLOPs per (channel, state)
in every Mamba-2 block, as K6's count has them.  Norms, gates, the
softmax and the scan's exps are not counted."""
from __future__ import annotations

from typing import Dict

# the scan's x and dt as the port's Mamba-2 prefill hands them to K6
SCAN_DTYPE = "float32"


def d_inner(cfg: Dict) -> int:
    return cfg["expand"] * cfg["d_model"]


def ssm_heads(cfg: Dict) -> int:
    return d_inner(cfg) // cfg["ssm_head_dim"]


def attention_layers(cfg: Dict) -> int:
    """Applications of the tied attention block (K5 calls a prefill)."""
    return -(-cfg["n_layers"] // cfg["attn_every"])


def scan_layers(cfg: Dict) -> int:
    """Mamba-2 blocks (K6 calls a prefill)."""
    return cfg["n_layers"]


def _mamba_weights(cfg: Dict) -> int:
    D, di, N = cfg["d_model"], d_inner(cfg), cfg["ssm_state"]
    return (D * (2 * di + 2 * N + ssm_heads(cfg)) + di * cfg["ssm_conv"]
            + di * D)


def _attn_block_weights(cfg: Dict) -> int:
    D, H, K, hd, F = (cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"],
                      cfg["head_dim"], cfg["d_ff"])
    return D * H * hd + 2 * D * K * hd + H * hd * D + 3 * D * F


def token_weights(cfg: Dict) -> int:
    """Weights of the products every token goes through (no head)."""
    return (cfg["n_layers"] * _mamba_weights(cfg)
            + attention_layers(cfg) * _attn_block_weights(cfg))


def _per_token(cfg: Dict) -> int:
    scan = scan_layers(cfg) * 5 * d_inner(cfg) * cfg["ssm_state"]
    return 2 * token_weights(cfg) + scan


def _attn_per_key(cfg: Dict) -> int:
    return attention_layers(cfg) * 4 * cfg["n_heads"] * cfg["head_dim"]


def prefill_flops(cfg: Dict, B: int, S: int) -> int:
    """One prefill of B rows of S tokens (the head once a row)."""
    head = 2 * cfg["d_model"] * cfg["vocab"]
    return B * (S * _per_token(cfg) + _attn_per_key(cfg) * S * (S + 1) // 2
                + head)


def decode_flops(cfg: Dict, B: int, pos: int) -> int:
    """One decode step of B rows, the new token at position ``pos``."""
    head = 2 * cfg["d_model"] * cfg["vocab"]
    return B * (_per_token(cfg) + _attn_per_key(cfg) * (pos + 1) + head)
