"""Pieces the plain references share: products with a weight (float32, or
float8-rounded inputs for the control), RMSNorm, RoPE, causal GQA
attention and the SwiGLU MLP, all in float32 with TF32 off.  Weights
arrive as the tensors the benchmark drew (bf16) and are upcast at use,
one layer at a time."""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

PRECISIONS = ("f32", "fp8")
E4M3_MAX = 448.0


def strict_f32() -> None:
    """Float32 products in float32: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per slice along
    ``dim`` (its absolute maximum maps to 448), back in float32."""
    scale = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def mm(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """x (..., I) float32 times the weight w (I, O): float32 products, or
    with ``precision="fp8"`` both inputs rounded to e4m3 first (x per row,
    w per output column)."""
    w = w.float()
    if precision == "fp8":
        x, w = _fp8(x, -1), _fp8(w, 0)
    elif precision != "f32":
        raise ValueError(f"precision {precision!r} is not one of "
                         f"{PRECISIONS}")
    return x @ w


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * w.float()


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (R, S, heads, hd) at positions 0..S-1: the first and second halves
    of each head turned as pairs, channel i by position / theta ** (2i /
    hd); the angles in float64."""
    S, hd = x.shape[1], x.shape[-1]
    inv = theta ** (-torch.arange(0, hd, 2, dtype=torch.float64,
                                  device=x.device) / hd)
    ang = torch.arange(S, dtype=torch.float64, device=x.device)[:, None] * inv
    cos = torch.cos(ang).float()[None, :, None, :]
    sin = torch.sin(ang).float()[None, :, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """q (R, S, H, hd), k / v (R, S, K, hd): query head h reads key head
    h // (H / K); softmax(q k^T / sqrt(hd)) over keys at or before the
    query, one row at a time.  Returns (R, S, H, hd)."""
    R, S, H, hd = q.shape
    G = H // k.shape[2]
    keep = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    out = torch.empty_like(q)
    for r in range(R):
        kr = k[r].repeat_interleave(G, dim=1).transpose(0, 1)   # (H, S, hd)
        vr = v[r].repeat_interleave(G, dim=1).transpose(0, 1)
        s = q[r].transpose(0, 1) @ kr.transpose(1, 2) * hd ** -0.5
        s = s.masked_fill(~keep, float("-inf"))
        out[r] = (torch.softmax(s, dim=-1) @ vr).transpose(0, 1)
    return out


def attention_block(cfg: Dict, p: Dict, x: torch.Tensor,
                    precision: str) -> torch.Tensor:
    """Pre-norm attention then pre-norm SwiGLU, each added to x."""
    R, S, _ = x.shape
    H, K, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    eps, theta = cfg["norm_eps"], cfg["rope_theta"]
    h = rmsnorm(x, p["ln1"], eps)
    a = p["attn"]
    q = rope(mm(h, a["wq"], precision).view(R, S, H, hd), theta)
    k = rope(mm(h, a["wk"], precision).view(R, S, K, hd), theta)
    v = mm(h, a["wv"], precision).view(R, S, K, hd)
    o = causal_attention(q, k, v).reshape(R, S, H * hd)
    x = x + mm(o, a["wo"], precision)
    h = rmsnorm(x, p["ln2"], eps)
    m = p["mlp"]
    g = F.silu(mm(h, m["w_gate"], precision)) * mm(h, m["w_up"], precision)
    return x + mm(g, m["w_down"], precision)


def layer(tree: Dict, i: int) -> Dict:
    """Layer i of a tree stacked along a leading layer axis."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def embed(params: Dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens].float()


def head(cfg: Dict, params: Dict, x: torch.Tensor,
         precision: str) -> torch.Tensor:
    """Final RMSNorm and the output head (d_model, vocab)."""
    return mm(rmsnorm(x, params["ln_f"], cfg["norm_eps"]), params["lm_head"],
              precision)
