"""MAIZ_RANKING — paper Eq. 1 (torch twin of ``repro.core.ranking``).

    MAIZ_RANKING = w1·CFP + w2·FCFP + w3·CP_RATIO + w4·SCHEDULE_WEIGHT

Scores are "lower is better"; each term is min-max normalized across the
candidate set and CP_RATIO enters inverted.  The fleet-scale kernel twin
is ``repro_torch.kernels.ops.maiz_ranking_fused``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch._device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class RankWeights:
    w1: float = 0.35    # CFP
    w2: float = 0.25    # FCFP
    w3: float = 0.25    # CP_RATIO (inverted)
    w4: float = 0.15    # SCHEDULE_WEIGHT
    #: Weight of the marginal-CFP term; 0 keeps the historical ranking.
    marginal: float = 0.0

    def as_array(self, device: DeviceLike = None) -> torch.Tensor:
        """The 4 weights the rank kernel consumes, f32 on ``device``."""
        return torch.tensor([self.w1, self.w2, self.w3, self.w4],
                            dtype=torch.float32,
                            device=resolve_device(device))

    def graph_key(self) -> "RankWeights":
        """The weights with ``marginal`` pinned to 0 (the marginal weight
        rides in the EnergyModel instead, as in the reference)."""
        return dataclasses.replace(self, marginal=0.0)


def _minmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Min-max normalize; a degenerate term (span <= 1e-12) contributes
    exactly 0."""
    lo = torch.amin(x, dim=dim, keepdim=True)
    hi = torch.amax(x, dim=dim, keepdim=True)
    span = hi - lo
    rcp = torch.where(span > 1e-12,
                      torch.reciprocal(torch.clamp_min(span, 1e-12)), 0.0)
    return (x - lo) * rcp


def maiz_ranking(cfp: torch.Tensor, fcfp: torch.Tensor,
                 cp_ratio: torch.Tensor, schedule_weight: torch.Tensor,
                 weights: RankWeights = RankWeights(),
                 normalize: bool = True,
                 marginal_cfp: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Eq. 1 over a candidate axis (last). Lower score = better node."""
    if normalize:
        cfp = _minmax(cfp)
        fcfp = _minmax(fcfp)
        eff = 1.0 - _minmax(cp_ratio)
        sw = _minmax(schedule_weight)
    else:
        eff = -cp_ratio
        sw = schedule_weight
    score = (weights.w1 * cfp + weights.w2 * fcfp
             + weights.w3 * eff + weights.w4 * sw)
    if marginal_cfp is not None:
        m = _minmax(marginal_cfp) if normalize else marginal_cfp
        score = score + weights.marginal * m
    return score


def marginal_cfp(cfp: torch.Tensor, chips_total: torch.Tensor, idle_frac,
                 dyn_frac, is_off: torch.Tensor, embodied_g_h=0.0,
                 horizon_h: float = 1.0) -> torch.Tensor:
    """*Marginal* CFP (reference form): dynamic share for on nodes, the
    full two-part price (idle floor + embodied) for powering one on."""
    dyn = cfp * dyn_frac / torch.clamp_min(chips_total, 1)
    wake = cfp * idle_frac + embodied_g_h * horizon_h
    return dyn + torch.where(is_off, wake, 0.0)


def rank_nodes(scores: torch.Tensor, valid: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (order, best). Invalid nodes sort last; ties keep the lower
    index (stable sort, as ``jnp.argsort``)."""
    if valid is not None:
        scores = torch.where(valid, scores, torch.inf)
    order = torch.sort(scores, dim=-1, stable=True).indices
    return order, order[..., 0]
