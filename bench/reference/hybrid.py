"""Plain float32 forward of the hybrid family (zamba2-1.2b as the port's
configuration states it): token embedding, ``n_layers`` pre-norm Mamba-2
blocks added to the residual stream, one weight-tied attention + SwiGLU
block (``common.attention_block``) after each group of ``attn_every`` of
them and after the shorter last group, a final RMSNorm and the head.

A Mamba-2 block: one input product gives z, x, B, C (one group) and dt
per head; x goes through a causal depthwise conv (tap W-1 the current
token) and SiLU; dt = softplus(dt + dt_bias); per head the state follows
h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T with A = -exp(A_log), and
y_t = h_t C_t + D x_t; then y * silu(z) is RMS-normed over d_inner and
projected out.  The recurrence runs in its chunked closed form (SSD):
within a chunk of Q steps as a masked decay-weighted product, across
chunks through the carried state."""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from bench.reference import common

CHUNK = 64


def _ssd(xdt: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor,
         Cm: torch.Tensor) -> torch.Tensor:
    """xdt (R, S, nh, P) = dt x, a (R, S, nh) = dt A, Bm / Cm (R, S, N),
    from a zero state -> y (R, S, nh, P) = sum over s <= t of
    exp(sum a over (s, t]) (C_t . B_s) xdt_s."""
    R, S, nh, P = xdt.shape
    N = Bm.shape[-1]
    Q = CHUNK
    pad = (-S) % Q
    xdt = F.pad(xdt, (0, 0, 0, 0, 0, pad))
    a = F.pad(a, (0, 0, 0, pad))
    Bm, Cm = F.pad(Bm, (0, 0, 0, pad)), F.pad(Cm, (0, 0, 0, pad))
    nc = xdt.shape[1] // Q
    xdt = xdt.view(R, nc, Q, nh, P)
    Bm, Cm = Bm.view(R, nc, Q, N), Cm.view(R, nc, Q, N)
    lc = torch.cumsum(a.view(R, nc, Q, nh), dim=2)
    keep = torch.ones((Q, Q), dtype=torch.bool, device=a.device).tril()
    diff = (lc[:, :, :, None, :] - lc[:, :, None, :, :]).masked_fill(
        ~keep[None, None, :, :, None], float("-inf"))
    m = torch.einsum("rcqn,rcsn->rcqs", Cm, Bm)[..., None] * torch.exp(diff)
    y = torch.einsum("rcqsh,rcshp->rcqhp", m, xdt)
    # each chunk's own contribution to the state at its end
    w = torch.exp(lc[:, :, -1:, :] - lc)                      # (R,nc,Q,nh)
    own = torch.einsum("rcsh,rcshp,rcsn->rchpn", w, xdt, Bm)
    h = torch.zeros((R, nh, P, N), dtype=torch.float32, device=a.device)
    enter = []
    for c in range(nc):
        enter.append(h)
        h = torch.exp(lc[:, c, -1])[:, :, None, None] * h + own[:, c]
    hin = torch.stack(enter, dim=1)                         # (R,nc,nh,P,N)
    y = y + torch.einsum("rcqn,rchpn->rcqhp", Cm, hin) \
        * torch.exp(lc)[..., None]
    return y.reshape(R, nc * Q, nh, P)[:, :S]


def mamba2(cfg: Dict, p: Dict, x: torch.Tensor,
           precision: str) -> torch.Tensor:
    """One Mamba-2 mixer on x (R, S, d_model), already normed."""
    R, S, _ = x.shape
    di = cfg["expand"] * cfg["d_model"]
    N, P, W = cfg["ssm_state"], cfg["ssm_head_dim"], cfg["ssm_conv"]
    nh = di // P
    z, xi, Bm, Cm, dt = torch.split(common.mm(x, p["in_proj"], precision),
                                    [di, di, N, N, nh], dim=-1)
    w = p["conv_w"].float()                                   # (di, W)
    xp = F.pad(xi, (0, 0, W - 1, 0))
    xc = sum(xp[:, j:j + S] * w[:, j] for j in range(W)) + p["conv_b"].float()
    xc = F.silu(xc)
    dt = torch.logaddexp(dt + p["dt_bias"].float(),
                         torch.zeros((), device=x.device))   # (R, S, nh)
    a = dt * -torch.exp(p["A_log"].float())
    xh = xc.view(R, S, nh, P)
    y = _ssd(xh * dt[..., None], a, Bm, Cm)
    y = (y + p["D_skip"].float()[:, None] * xh).reshape(R, S, di)
    y = y * F.silu(z)
    y = common.rmsnorm(y, p["norm_w"], cfg["norm_eps"])
    return common.mm(y, p["out_proj"], precision)


@torch.no_grad()
def logits(cfg: Dict, params: Dict, tokens: torch.Tensor, first: int,
           precision: str = "f32") -> torch.Tensor:
    """tokens (R, S) int64 -> (R, S - first, vocab) float32 logits at
    positions first..S-1, layer by layer."""
    x = common.embed(params, tokens)
    layers = params["stack"]["layers"]
    shared = params["stack"]["shared_attn"]
    L, k = cfg["n_layers"], cfg["attn_every"]
    for i in range(L):
        pl = common.layer(layers, i)
        x = x + mamba2(cfg, pl["ssm"],
                       common.rmsnorm(x, pl["ln"], cfg["norm_eps"]),
                       precision)
        if (i + 1) % k == 0 or i + 1 == L:
            x = common.attention_block(cfg, shared, x, precision)
    return common.head(cfg, params, x[:, first:], precision)
