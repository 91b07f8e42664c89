"""Plain-torch oracles for the kernels (twins of ``repro.kernels.ref``).
The attention and scan oracles are the kernels' plain versions."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import attention_plain
from repro_torch.kernels.selective_scan import selective_scan_plain


def attention_ref(q, k, v, *, window: int = 0) -> torch.Tensor:
    """Causal (optionally banded) GQA attention.
    q: (B, H, S, hd); k/v: (B, K, S, hd)."""
    return attention_plain(q, k, v, window=window)


def selective_scan_ref(dt, x, b, c, a) -> torch.Tensor:
    """The mamba1 selective-scan recurrence step by step: y (B, S, D)."""
    return selective_scan_plain(dt, x, b, c, a)[0]


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


def _marginal_cfp_ref(pk, pue, ci_now, cap, chips_total, en):
    """Eq. 1 marginal-CFP term, op for op the kernel's: ``en = [idle_frac,
    dyn_frac, embodied·horizon, w_marginal]``."""
    an = _f32(pk) * _f32(pue)
    an = an * _f32(ci_now)
    ct = _f32(chips_total)
    inv = torch.reciprocal(torch.clamp_min(ct, 1.0))
    m_dyn = an * inv * en[1]
    m_wake = an * en[0] + en[2]
    return m_dyn + torch.where(_f32(cap) == ct, m_wake, 0.0)


def _terms(ec, pue, ci_now, ci_fc, eff, sched, pk, cap, chips_total, en):
    base = _f32(ec) * _f32(pue)
    terms = [base * ci_now, base * ci_fc, _f32(eff), _f32(sched)]
    if en is not None:
        terms.append(_marginal_cfp_ref(pk, pue, ci_now, cap, chips_total,
                                       en))
    return terms


def maiz_ranking_ref(ec, pue, ci_now, ci_fc, eff, sched, lohi, weights, *,
                     pk=None, cap=None, chips_total=None, en=None):
    """Oracle for the fused ranking kernel: identical math, plain torch.
    Returns (scores, global_min, global_argmin)."""
    terms = _terms(ec, pue, ci_now, ci_fc, eff, sched, pk, cap, chips_total,
                   en)

    def norm(x, i):
        lo, hi = lohi[i, 0], lohi[i, 1]
        span = hi - lo
        rcp = torch.where(span > 1e-12,
                          torch.reciprocal(torch.clamp_min(span, 1e-12)), 0.0)
        return (x - lo) * rcp

    score = (weights[0] * norm(terms[0], 0) + weights[1] * norm(terms[1], 1)
             + weights[2] * (1.0 - norm(terms[2], 2))
             + weights[3] * norm(terms[3], 3))
    if en is not None:
        # select-then-add: w_m == 0 adds ±0.0, a bitwise no-op
        score = score + en[3] * norm(terms[4], 4)
    return score, torch.min(score), torch.argmin(score)


def term_lohi(ec, pue, ci_now, ci_fc, eff, sched, *,
              pk=None, cap=None, chips_total=None, en=None) -> torch.Tensor:
    """The O(N) normalization pre-pass: (4, 2), or (5, 2) with the
    marginal-CFP streams."""
    terms = torch.stack(_terms(ec, pue, ci_now, ci_fc, eff, sched, pk, cap,
                               chips_total, en))
    return torch.stack([torch.amin(terms, dim=1), torch.amax(terms, dim=1)],
                       dim=-1)
