"""Mixture-of-Experts: top-k router + sort-based capacity dispatch (twin of
``repro.models.moe``).

Dispatch is per group (one group = one sequence): each sequence's token
slots are sorted by expert, the first C of each expert keep their place
in that expert's buffer and the rest (overflow) go to a trash row that is
cut off, the standard switch / GShard semantics.  Capacity: C =
ceil(top_k · S · capacity_factor / E), at least 1.  Buffers are
O(E·C·D) per group.  The expert products are batched matmuls over
(E, B·C, D) x (E, D, F), as the JAX package's einsums are; they run
outside any kernel there too.  The load-balance auxiliary loss is the
switch transformer's.

Order rules, which keep the routing equal to the JAX package's:

- top-k takes the experts from a stable descending sort of the router
  probabilities, so ties put the lower expert id first, as
  ``jax.lax.top_k`` does (``torch.topk`` promises no tie order);
- the dispatch sort is stable (``jnp.argsort`` is), and a slot's place in
  its expert's buffer is its rank among that expert's slots;
- combine uses no atomics: each token's k contributions are gathered back
  through the inverse of the dispatch permutation and added in ascending
  sorted position (ascending expert id), the order of the JAX package's
  scatter-add, so a run on the card is deterministic.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import Param
from repro_torch.models.layers import mlp_apply


def moe_template(cfg: ArchConfig) -> Dict[str, Param]:
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    t: Dict[str, Param] = {
        "router": Param((D, E), ("fsdp", None), init="small",
                        dtype=torch.float32),
    }
    names = (("w_gate", "w_up", "w_down") if cfg.mlp == "swiglu"
             else ("w_up", "w_down"))
    for n in names:
        if n == "w_down":
            t[n] = Param((E, Fd, D), ("experts", "tp", "fsdp"))
        else:
            t[n] = Param((E, D, Fd), ("experts", "fsdp", "tp"))
    return t


def _capacity(cfg: ArchConfig, group_tokens: int) -> int:
    return max(math.ceil(cfg.top_k * group_tokens * cfg.capacity_factor
                         / cfg.n_experts), 1)


def route(cfg: ArchConfig, p: Dict[str, torch.Tensor], x: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(probs (B, S, E) f32, top_w (B, S, k) f32 renormalised, top_e
    (B, S, k) int64): the router's softmax over f32 logits and its top k,
    the lower expert id first on ties."""
    probs = torch.softmax(x.float() @ p["router"], dim=-1)
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[..., :cfg.top_k], top_e[..., :cfg.top_k]
    return probs, top_w / torch.sum(top_w, -1, keepdim=True), top_e


def _dispatch(cfg: ArchConfig, top_e: torch.Tensor, capacity: int):
    """top_e: (B, T, k).  Per group, the dispatch sort: (order (B, T·k)
    the stable sort of the flat expert ids, slot (B, T·k) each sorted
    entry's buffer row, E·C for an overflow)."""
    B, T, k = top_e.shape
    E, C = cfg.n_experts, capacity
    flat_e = top_e.reshape(B, T * k)
    s_e, order = torch.sort(flat_e, dim=-1, stable=True)
    experts = torch.arange(E, device=top_e.device).expand(B, E).contiguous()
    start = torch.searchsorted(s_e, experts)                   # (B, E)
    pos = (torch.arange(T * k, device=top_e.device)
           - torch.gather(start, 1, s_e))
    slot = torch.where(pos < C, s_e * C + pos, E * C)
    return order, slot


def _experts(cfg: ArchConfig, p, eb: torch.Tensor) -> torch.Tensor:
    """eb (B, E, C, D) -> (B, E, C, D): each expert's MLP on its rows, as
    batched matmuls over (E, B·C, D) x (E, D, F) that read the stacked
    expert weights in place (``einsum`` copied the weight operand)."""
    B, E, C, D = eb.shape
    xe = eb.transpose(0, 1).reshape(E, B * C, D)
    if cfg.mlp == "swiglu":
        h = (F.silu(torch.bmm(xe, p["w_gate"]))
             * torch.bmm(xe, p["w_up"]))
    else:
        h = F.gelu(torch.bmm(xe, p["w_up"]), approximate="tanh")
    return torch.bmm(h, p["w_down"]).reshape(E, B, C, D).transpose(0, 1)


def moe_apply(cfg: ArchConfig, p: Dict[str, torch.Tensor],
              x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out (B, S, D), aux_loss f32)."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    C = _capacity(cfg, S)
    probs, top_w, top_e = route(cfg, p, x)
    top_w = top_w.to(x.dtype)

    # switch load-balance loss over all tokens; the one-hot as a compare
    # (F.one_hot checks its input's range on the host: a read-back per
    # layer on the card, and another op sequence there than on meta)
    onehot = top_e[..., 0, None] == torch.arange(E, device=x.device)
    frac = torch.mean(onehot.float(), dim=(0, 1))
    aux = E * torch.sum(frac * torch.mean(probs, dim=(0, 1)))

    order, slot = _dispatch(cfg, top_e, C)
    s_tok = torch.div(order, k, rounding_mode="floor")            # (B, T·k)
    rows = torch.arange(B, device=x.device)[:, None]
    # the buffer: row s_e·C + pos holds its token's x; overflow rows land
    # in the trash row E·C, which is cut off
    buf = x.new_zeros((B, E * C + 1, D))
    buf[rows, slot] = x[rows, s_tok]
    y = _experts(cfg, p, buf[:, :E * C].reshape(B, E, C, D))
    y_pad = torch.cat([y.reshape(B, E * C, D), y.new_zeros((B, 1, D))], 1)

    return _combine(y_pad, slot, order, top_w), aux


def _combine(y_pad: torch.Tensor, slot: torch.Tensor, order: torch.Tensor,
             top_w: torch.Tensor) -> torch.Tensor:
    """y_pad (B, E·C + 1, D) expert rows (the last one zeros), slot / order
    (B, T·k) from ``_dispatch``, top_w (B, T, k) -> (B, T, D).  Sorted
    entry j contributes y_pad[slot_j] times its weight (0 for an
    overflow); token t's k entries sit at sorted positions inv[t·k : t·k +
    k] and are added in ascending position, with no atomics."""
    B, T, k = top_w.shape
    D = y_pad.shape[-1]
    trash = y_pad.shape[1] - 1
    rows = torch.arange(B, device=y_pad.device)[:, None]
    s_w = torch.where(slot < trash, torch.gather(
        top_w.reshape(B, T * k), 1, order), 0).to(y_pad.dtype)
    contrib = y_pad[rows, slot] * s_w[..., None]               # (B, T·k, D)
    inv = torch.argsort(order, dim=-1).reshape(B, T, k)
    at = torch.sort(inv, dim=-1).values.reshape(B, T * k)
    parts = contrib[rows, at].reshape(B, T, k, D)
    out = y_pad.new_zeros((B, T, D))
    for i in range(k):
        out = out + parts[:, :, i]
    return out


def moe_ref_dense(cfg: ArchConfig, p: Dict[str, torch.Tensor],
                  x: torch.Tensor) -> torch.Tensor:
    """Oracle: every expert on every token, combined by the router
    weights.  O(E) compute; only for tests at reduced size."""
    probs, top_w, top_e = route(cfg, p, x)
    gate = torch.zeros_like(probs).scatter(-1, top_e, top_w)
    ys = [mlp_apply({n: p[n][e] for n in p if n != "router"}, x, cfg.mlp)
          for e in range(cfg.n_experts)]
    y = torch.stack(ys, dim=-2)                               # (B, S, E, D)
    return torch.einsum("bse,bsed->bsd", gate.to(y.dtype), y)
