"""Selective state-space blocks: Mamba-1 (falcon-mamba) and Mamba-2
(zamba2), twin of ``repro.models.ssm``.

Training runs the JAX package's own route, the **chunked selective
scan**: the (B, S, d_inner, N) decay and input terms are built in f32,
each chunk of Q steps is scanned in log2(Q) doubling passes (the
``_assoc`` combine, Hillis-Steele order) under ``torch.utils.checkpoint``,
and the state is carried from chunk to chunk; autograd differentiates it
(K6 has no backward, as the Pallas kernel has no VJP).  Prefill runs the
selective scan K6 once per layer instead: it streams the per-step terms
through the chip and keeps the (d_inner, N) state on it, and also returns
the final state for the decode cache.  Decode is the exact single-step
recurrence in plain torch.

Mamba-2 has one step and one decay per head, shared by the head's P
channels and its N states: its prefill runs K6 in the per-head form (dt
(B, S, nh) and A (nh,), one exp per (b, t, head)); training runs the same
chunked scan over (B, S, d_inner, N) terms.  ``ssm_algo="ssd"`` runs the SSD
chunk-matmul form instead (``mamba2_apply_ssd``, plain torch, prefill and
training alike), as the JAX package does.
"""
from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import (Param, constrain, is_dtensor,
                                              local_rows, matmul,
                                              whole_local)
from repro_torch.kernels.ops import selective_scan_op

def _scan(dt, x, b, c, a, use_kernel: bool):
    """K6 (``selective_scan_op``); on DTensors each rank runs its own
    rows, with the per-head decay ``a`` whole on every rank."""
    if is_dtensor(a):
        a = whole_local(a, x)
    return local_rows(functools.partial(selective_scan_op,
                                        use_kernel=use_kernel),
                      dt, x, b, c, a)


# ---------------------------------------------------------------------------
# Chunked selective scan (the training path)
# ---------------------------------------------------------------------------


def _scan_chunk(a: torch.Tensor, b: torch.Tensor,
                h: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of h_t = a_t * h_{t-1} + b_t over one chunk
    (B, Q, M, N) from the carry h (B, M, N): step t takes in step t - d
    with ``_assoc``'s combine (a1 * a2, a2 * b1 + b2), d = 1, 2, 4, ..."""
    a = constrain(a, "batch", None, "ssm_inner", None)
    b = constrain(b, "batch", None, "ssm_inner", None)
    Q = a.shape[1]
    d = 1
    while d < Q:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    return constrain(a * h[:, None] + b, "batch", None, "ssm_inner", None)


def chunked_selective_scan(dA: torch.Tensor, dBx: torch.Tensor,
                           h0: torch.Tensor, chunk: int = 64
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dA, dBx: (B, S, M, N) decay/input terms; h0: (B, M, N).  Returns
    (h_all (B, S, M, N), h_last).  The last chunk is padded with a = 1,
    b = 0; each chunk runs under a checkpoint."""
    S = dA.shape[1]
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:
        dA = F.pad(dA, (0, 0, 0, 0, 0, pad), value=1.0)
        dBx = F.pad(dBx, (0, 0, 0, 0, 0, pad))
    h = h0
    outs = []
    for i in range(dA.shape[1] // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        h_all = checkpoint(_scan_chunk, dA[:, sl], dBx[:, sl], h,
                           use_reentrant=False)
        h = h_all[:, -1]
        outs.append(h_all)
    return torch.cat(outs, dim=1)[:, :S], h


def selective_scan_step(dA, dBx, h):
    """Single-token recurrence. dA/dBx: (B, M, N)."""
    return dA * h + dBx


# ---------------------------------------------------------------------------
# Causal depthwise conv (width w) + decode cache
# ---------------------------------------------------------------------------


def causal_conv(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """x: (B, S, C); w: (C, W) depthwise taps (tap W-1 = current token).
    On a DTensor x each rank convolves its own rows (the shifted pads
    along S have no DTensor rule on torch 2.11), the taps whole."""
    if is_dtensor(x):
        return local_rows(causal_conv, x, whole_local(w, x),
                          whole_local(b, x))
    W = w.shape[-1]
    out = x * w[:, -1]
    for i in range(1, W):
        shifted = F.pad(x, (0, 0, i, 0))[:, :-i]
        out = out + shifted * w[:, -1 - i]
    return out + b


def _conv_tail(x_in: torch.Tensor, W: int) -> torch.Tensor:
    """The last W - 1 conv inputs (B, W - 1, C), zero-padded in front
    when S < W - 1: the decode cache's conv history."""
    S = x_in.shape[1]
    return F.pad(x_in, (0, 0, max(W - 1 - S, 0), 0))[:, -(W - 1):]


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
    xdbl = matmul(xc, p["x_proj"])
    dt_r, Bm, Cm = torch.split(xdbl, [R, N, N], dim=-1)
    dt = _softplus(matmul(dt_r, p["dt_proj"]).float() + p["dt_bias"])
    return dt, Bm.float(), Cm.float()


def mamba1_apply(cfg: ArchConfig, p: Dict[str, torch.Tensor],
                 x: torch.Tensor, *, chunk: Optional[int] = None,
                 return_state: bool = False, use_kernel: bool = True):
    """Forward of one Mamba-1 block.  ``chunk=None`` runs the scan
    through K6 (prefill; ``use_kernel=False`` its plain version); an int
    runs the JAX package's chunked scan over (B, S, d_inner, N) f32 terms
    with chunks of ``chunk`` steps, the training route autograd
    differentiates."""
    B, S, D = x.shape
    W = cfg.ssm_conv
    x_in, z = torch.chunk(
        constrain(matmul(x, p["in_proj"]), "batch", "seq", "ssm_inner"), 2,
        dim=-1)
    xc = F.silu(causal_conv(x_in, p["conv_w"], p["conv_b"]))
    dt, Bm, Cm = _mamba1_inputs(cfg, p, xc)
    A = -torch.exp(p["A_log"])                                 # (di, N)
    if chunk is None:
        # x in f32, so y stays f32 until D_skip is added, as in the JAX
        # block
        y, h_last = _scan(dt, xc.float(), Bm, Cm, A, use_kernel)
    else:
        dA = torch.exp(dt[..., None] * A)                      # (B,S,di,N)
        dBx = (dt * xc.float())[..., None] * Bm[:, :, None, :]
        h0 = torch.zeros((B, cfg.d_inner, cfg.ssm_state),
                         dtype=torch.float32, device=x.device)
        h_all, h_last = chunked_selective_scan(dA, dBx, h0, chunk=chunk)
        y = torch.einsum("bsmn,bsn->bsm", h_all, Cm)
    y = (y + p["D_skip"] * xc.float()).to(x.dtype)
    out = matmul(y * F.silu(z), p["out_proj"])
    if return_state:
        return out, {"h": h_last, "conv": local_rows(
            functools.partial(_conv_tail, W=W), x_in)}
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


# ---------------------------------------------------------------------------
# Mamba-2 / SSD (zamba2): scalar decay per head, state (heads, P, N)
# ---------------------------------------------------------------------------


def mamba2_template(cfg: ArchConfig) -> Dict[str, Param]:
    D, di, N, W = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    nh = di // cfg.ssm_head_dim
    return {
        "in_proj": Param((D, 2 * di + 2 * N + nh), ("fsdp", "tp")),
        "conv_w": Param((di, W), ("tp", None), init="fan_last", scale=0.5),
        "conv_b": Param((di,), ("tp",), init="zeros"),
        "A_log": Param((nh,), (None,), init="s4d", dtype=torch.float32),
        "dt_bias": Param((nh,), (None,), init="dt", dtype=torch.float32),
        "D_skip": Param((nh,), (None,), init="ones", dtype=torch.float32),
        "norm_w": Param((di,), ("tp",), init="ones", dtype=torch.float32),
        "out_proj": Param((di, D), ("tp", "fsdp")),
    }


def _mamba2_split(cfg: ArchConfig, zxbcdt: torch.Tensor):
    di, N = cfg.d_inner, cfg.ssm_state
    nh = di // cfg.ssm_head_dim
    z, x_in, Bm, Cm, dt = torch.split(zxbcdt, [di, di, N, N, nh], dim=-1)
    return z, x_in, Bm.float(), Cm.float(), dt


def _gated_rmsnorm(y: torch.Tensor, z: torch.Tensor, w: torch.Tensor,
                   eps: float) -> torch.Tensor:
    y = y * F.silu(z.float())
    scale = torch.rsqrt(torch.mean(y * y, dim=-1, keepdim=True) + eps)
    return y * scale * w


def _mamba2_head(cfg: ArchConfig, p, x):
    """The projections and conv shared by both Mamba-2 routes: (z, x_in,
    xc, Bm, Cm, dt (..., nh) f32 after softplus)."""
    z, x_in, Bm, Cm, dt = _mamba2_split(
        cfg, constrain(matmul(x, p["in_proj"]), "batch", "seq", None))
    xc = F.silu(causal_conv(x_in, p["conv_w"], p["conv_b"]))
    dt = _softplus(dt.float() + p["dt_bias"])
    return z, x_in, xc, Bm, Cm, dt


def _mamba2_tail(cfg: ArchConfig, p, y, xc, z, x_in, h_last, S, dtype,
                 return_state: bool):
    """D skip, gated RMSNorm and the out projection; the decode cache."""
    P, W = cfg.ssm_head_dim, cfg.ssm_conv
    y = y + torch.repeat_interleave(p["D_skip"], P) * xc.float()
    y = _gated_rmsnorm(y, z, p["norm_w"], cfg.norm_eps).to(dtype)
    out = matmul(y, p["out_proj"])
    if return_state:
        return out, {"h": h_last, "conv": local_rows(
            functools.partial(_conv_tail, W=W), x_in)}
    return out


def mamba2_apply(cfg: ArchConfig, p: Dict[str, torch.Tensor],
                 x: torch.Tensor, *, chunk: Optional[int] = None,
                 return_state: bool = False, use_kernel: bool = True):
    """Forward of one Mamba-2 block.  ``chunk=None`` runs the scan through
    K6 in its per-head form (prefill; ``use_kernel=False`` its plain
    version): dt (B, S, nh) and the decay A (nh,), one value per head for
    its P channels.  An int runs the JAX package's chunked scan over
    (B, S, d_inner, N) f32 terms, the training route."""
    B, S, D = x.shape
    di, N, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim
    nh = di // P
    z, x_in, xc, Bm, Cm, dt = _mamba2_head(cfg, p, x)
    A = -torch.exp(p["A_log"])                                   # (nh,)
    if chunk is None:
        y, h_last = _scan(dt, xc.float(), Bm, Cm, A, use_kernel)
    else:
        dA = torch.exp(dt * A)                                   # (B,S,nh)
        xh = xc.reshape(B, S, nh, P).float()
        dBx = ((dt[..., None] * xh).reshape(B, S, di)[..., None]
               * Bm[:, :, None, :])
        dA_full = torch.repeat_interleave(dA, P, dim=-1)[..., None].expand(
            B, S, di, N)
        h0 = torch.zeros((B, di, N), dtype=torch.float32, device=x.device)
        h_all, h_last = chunked_selective_scan(dA_full, dBx, h0, chunk=chunk)
        y = torch.einsum("bsmn,bsn->bsm", h_all, Cm)
    return _mamba2_tail(cfg, p, y, xc, z, x_in, h_last, S, x.dtype,
                        return_state)


def _ssd_chunk(h, al, Bq, Cq, dx):
    """One SSD chunk: al (B, Q, nh) log-decays, Bq / Cq (B, Q, N), dx
    (B, Q, nh, P), carry h (B, nh, P, N) -> (h_new, y (B, Q, nh, P))."""
    Q = al.shape[1]
    lc = torch.cumsum(al, dim=1)                             # (B,Q,nh)
    # intra-chunk: masked decay "attention"
    cb = torch.einsum("bqn,bsn->bqs", Cq, Bq)                # (B,Q,Q)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                 device=al.device))
    diff = lc[:, :, None, :] - lc[:, None, :, :]             # (B,Q,S,nh)
    # clamp masked lanes before exp: exp(+big) in dead lanes would poison
    # the backward pass with inf * 0 = NaN
    diff = torch.where(mask[None, :, :, None], diff, -1e30)
    m = cb[..., None] * torch.exp(diff)
    y_intra = torch.einsum("bqsh,bshp->bqhp", m, dx)
    # inter-chunk: incoming state read by C with the cumulative decay
    y_inter = torch.einsum("bqn,bhpn->bqhp", Cq, h) * torch.exp(lc)[..., None]
    # state update
    w = torch.exp(lc[:, -1][:, None] - lc)[..., None] * dx   # (B,Q,nh,P)
    h_new = (torch.exp(lc[:, -1])[..., None, None] * h
             + torch.einsum("bqhp,bqn->bhpn", w, Bq))
    return h_new, y_intra + y_inter


def _ssd_scan(dtx, a_log, Bm, Cm, chunk: int):
    """SSD's chunks in order from a zero state, each under a checkpoint,
    the tail padded to a whole chunk: dtx (B, S, nh, P), a_log (B, S, nh),
    Bm / Cm (B, S, N) -> (y (B, S, nh, P), h_S as (B, P, nh, N): the head
    on dim 2, as in dtx)."""
    B, S, nh, P = dtx.shape
    Q = min(chunk, S)
    pad = (-S) % Q
    if pad:
        a_log = F.pad(a_log, (0, 0, 0, pad))
        Bm, Cm = F.pad(Bm, (0, 0, 0, pad)), F.pad(Cm, (0, 0, 0, pad))
        dtx = F.pad(dtx, (0, 0, 0, 0, 0, pad))
    h = torch.zeros((B, nh, P, Bm.shape[-1]), dtype=torch.float32,
                    device=dtx.device)
    ys = []
    for i in range(a_log.shape[1] // Q):
        sl = slice(i * Q, (i + 1) * Q)
        h, yc = checkpoint(_ssd_chunk, h, a_log[:, sl], Bm[:, sl], Cm[:, sl],
                           dtx[:, sl], use_reentrant=False)
        ys.append(yc)
    return torch.cat(ys, dim=1)[:, :S], h.transpose(1, 2)


def mamba2_apply_ssd(cfg: ArchConfig, p: Dict[str, torch.Tensor],
                     x: torch.Tensor, *, chunk: int = 128,
                     return_state: bool = False):
    """Mamba-2 through the SSD chunk-matmul form (the JAX package's
    ``mamba2_apply_ssd``): the scalar decay per head lets each chunk of Q
    tokens be two matmuls (intra-chunk masked decay M·X and the inter-chunk
    state read) instead of (B, S, d_inner, N) scan terms.  Plain torch on
    every route, prefill and training alike; each chunk runs under a
    checkpoint, as the JAX body does.  On DTensors each rank runs the
    chunks of its own rows and heads, B and C whole over N (torch 2.11's
    DTensor cannot flatten a split (batch, head) pair in the chunk's
    einsums)."""
    B, S, D = x.shape
    di, N, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim
    nh = di // P
    z, x_in, xc, Bm, Cm, dt = _mamba2_head(cfg, p, x)
    a_log = dt * -torch.exp(p["A_log"])                          # <= 0
    dtx = dt[..., None] * xc.reshape(B, S, nh, P).float()        # (B,S,nh,P)
    dtx = constrain(dtx, "batch", None, "ssm_inner", None)
    y, h = local_rows(functools.partial(_ssd_scan, chunk=chunk), dtx, a_log,
                      Bm, Cm, dims=(0, 2), rows_only=(2, 3))
    y, h = y.reshape(B, S, di), h.transpose(1, 2).reshape(B, di, N)
    return _mamba2_tail(cfg, p, y, xc, z, x_in, h, S, x.dtype, return_state)


mamba2_cache_template = mamba1_cache_template


def mamba2_step(cfg: ArchConfig, p, x_t: torch.Tensor,
                cache: SSMCache) -> Tuple[torch.Tensor, SSMCache]:
    """x_t: (B, D) single token."""
    di, N, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim
    nh = di // P
    z, x_in, Bm, Cm, dt = _mamba2_split(cfg, x_t @ p["in_proj"])
    xc, conv = causal_conv_step(x_in, cache.conv, p["conv_w"], p["conv_b"])
    xc = F.silu(xc)
    dt = _softplus(dt.float() + p["dt_bias"])                    # (B,nh)
    dA = torch.exp(dt * -torch.exp(p["A_log"]))                  # (B,nh)
    dBx = ((dt[..., None] * xc.reshape(-1, nh, P).float())
           .reshape(-1, di)[..., None] * Bm[:, None, :])
    dA_full = torch.repeat_interleave(dA, P, dim=-1)[..., None]
    h = selective_scan_step(dA_full, dBx, cache.h)
    y = torch.einsum("bmn,bn->bm", h, Cm)
    y = y + torch.repeat_interleave(p["D_skip"], P) * xc.float()
    y = _gated_rmsnorm(y, z, p["norm_w"], cfg.norm_eps).to(x_t.dtype)
    return y @ p["out_proj"], SSMCache(h, conv)
