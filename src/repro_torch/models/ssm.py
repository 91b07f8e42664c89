"""Selective state-space blocks, the Mamba-1 half (falcon-mamba), twin of
``repro.models.ssm``.

Prefill runs the selective scan K6 once per layer: it streams the per-step
terms through the chip and keeps the (d_inner, N) state on it, where the
JAX package's chunked scan builds (B, S, d_inner, N) decay and input
tensors.  K6 also returns the final state for the decode cache.  Decode is
the exact single-step recurrence in plain torch.  Mamba-2 (zamba2) is not
ported yet.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import Param
from repro_torch.kernels.ops import selective_scan_op

def selective_scan_step(dA, dBx, h):
    """Single-token recurrence. dA/dBx: (B, M, N)."""
    return dA * h + dBx


# ---------------------------------------------------------------------------
# Causal depthwise conv (width w) + decode cache
# ---------------------------------------------------------------------------


def causal_conv(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """x: (B, S, C); w: (C, W) depthwise taps (tap W-1 = current token)."""
    W = w.shape[-1]
    out = x * w[:, -1]
    for i in range(1, W):
        shifted = F.pad(x, (0, 0, i, 0))[:, :-i]
        out = out + shifted * w[:, -1 - i]
    return out + b


def causal_conv_step(x_t: torch.Tensor, conv_cache: torch.Tensor,
                     w: torch.Tensor, b: torch.Tensor):
    """x_t: (B, C); conv_cache: (B, W-1, C) past inputs (oldest first)."""
    window = torch.cat([conv_cache, x_t[:, None]], dim=1)   # (B, W, C)
    out = torch.einsum("bwc,cw->bc", window, w) + b
    return out, window[:, 1:]


# ---------------------------------------------------------------------------
# Mamba-1 (falcon-mamba-7b)
# ---------------------------------------------------------------------------


class SSMCache(NamedTuple):
    h: torch.Tensor          # (B, M, N) state
    conv: torch.Tensor       # (B, W-1, d_inner) conv history


def mamba1_template(cfg: ArchConfig) -> Dict[str, Param]:
    D, di, N, R, W = (cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank,
                      cfg.ssm_conv)
    return {
        "in_proj": Param((D, 2 * di), ("fsdp", "tp")),
        "conv_w": Param((di, W), ("tp", None), init="fan_last", scale=0.5),
        "conv_b": Param((di,), ("tp",), init="zeros"),
        "x_proj": Param((di, R + 2 * N), ("tp", None)),
        "dt_proj": Param((R, di), (None, "tp"), init="small"),
        "dt_bias": Param((di,), ("tp",), init="dt", dtype=torch.float32),
        "A_log": Param((di, N), ("tp", None), init="s4d",
                       dtype=torch.float32),
        "D_skip": Param((di,), ("tp",), init="ones", dtype=torch.float32),
        "out_proj": Param((di, D), ("tp", "fsdp")),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.softplus is logaddexp(x, 0), with no linear cut-off
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _mamba1_inputs(cfg: ArchConfig, p, xc):
    """xc: (..., S, di) post-conv activations -> dt, Bm, Cm (f32)."""
    N, R = cfg.ssm_state, cfg.dt_rank
    xdbl = xc @ p["x_proj"]
    dt_r, Bm, Cm = torch.split(xdbl, [R, N, N], dim=-1)
    dt = _softplus((dt_r @ p["dt_proj"]).float() + p["dt_bias"])
    return dt, Bm.float(), Cm.float()


def mamba1_apply(cfg: ArchConfig, p: Dict[str, torch.Tensor],
                 x: torch.Tensor, *, return_state: bool = False,
                 use_kernel: bool = True):
    """Prefill/forward of one Mamba-1 block; the scan is K6."""
    B, S, D = x.shape
    W = cfg.ssm_conv
    x_in, z = torch.chunk(x @ p["in_proj"], 2, dim=-1)
    xc = F.silu(causal_conv(x_in, p["conv_w"], p["conv_b"]))
    dt, Bm, Cm = _mamba1_inputs(cfg, p, xc)
    A = -torch.exp(p["A_log"])                                 # (di, N)
    # x in f32, so y stays f32 until D_skip is added, as in the JAX block
    y, h_last = selective_scan_op(dt, xc.float(), Bm, Cm, A,
                                  use_kernel=use_kernel)
    y = (y + p["D_skip"] * xc.float()).to(x.dtype)
    out = (y * F.silu(z)) @ p["out_proj"]
    if return_state:
        conv_tail = F.pad(x_in, (0, 0, max(W - 1 - S, 0), 0))[:, -(W - 1):]
        return out, {"h": h_last, "conv": conv_tail}
    return out


def mamba1_cache_template(cfg: ArchConfig, batch: int) -> Dict[str, Param]:
    di, N, W = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    return {
        "h": Param((batch, di, N), ("batch", "ssm_inner", None),
                   init="zeros", dtype=torch.float32),
        "conv": Param((batch, W - 1, di), ("batch", None, "ssm_inner"),
                      init="zeros"),
    }


def mamba1_step(cfg: ArchConfig, p, x_t: torch.Tensor,
                cache: SSMCache) -> Tuple[torch.Tensor, SSMCache]:
    """x_t: (B, D) single token."""
    x_in, z = torch.chunk(x_t @ p["in_proj"], 2, dim=-1)
    xc, conv = causal_conv_step(x_in, cache.conv, p["conv_w"], p["conv_b"])
    xc = F.silu(xc)
    dt, Bm, Cm = _mamba1_inputs(cfg, p, xc)
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt[..., None] * A)
    dBx = (dt * xc.float())[..., None] * Bm[:, None, :]
    h = selective_scan_step(dA, dBx, cache.h)
    y = torch.einsum("bmn,bn->bm", h, Cm)
    y = (y + p["D_skip"] * xc.float()).to(x_t.dtype)
    out = (y * F.silu(z)) @ p["out_proj"]
    return out, SSMCache(h, conv)
