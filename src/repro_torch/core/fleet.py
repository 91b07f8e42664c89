"""Fleet state: nodes with capacity, health and region telemetry (torch
twin of ``repro.core.fleet``).

A ``Fleet`` is a struct-of-tensors over N nodes on one device, in the
dtypes the reference computes in (f32 floats, int32 chip counts, bool
health).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core import telemetry
from repro_torch.core.energy import DEFAULT_ENERGY, EnergyModel
from repro_torch.core.ranking import RankWeights, marginal_cfp, maiz_ranking

IDLE_POWER_FRAC = DEFAULT_ENERGY.idle_frac

FIELDS = ("ci_now", "ci_forecast", "pue", "power_kw", "capacity", "healthy",
          "straggler_score", "flops_per_j", "chips_total")


@dataclasses.dataclass
class Fleet:
    """Struct-of-tensors fleet; N = number of schedulable nodes."""
    ci_now: torch.Tensor          # (N,) f32 gCO2/kWh current carbon intensity
    ci_forecast: torch.Tensor     # (N,) f32 mean forecast over the horizon
    pue: torch.Tensor             # (N,) f32
    power_kw: torch.Tensor        # (N,) f32 full-load IT power of the node
    capacity: torch.Tensor        # (N,) int32 free chip count
    healthy: torch.Tensor         # (N,) bool
    straggler_score: torch.Tensor  # (N,) f32 EWMA of relative step slowness
    flops_per_j: torch.Tensor     # (N,) f32 chip efficiency
    chips_total: torch.Tensor     # (N,) int32 installed chips

    @property
    def n(self) -> int:
        return self.ci_now.shape[0]

    @property
    def device(self) -> torch.device:
        return self.ci_now.device

    def effective_power_kw(self, capacity: Optional[torch.Tensor] = None,
                           energy: Optional[EnergyModel] = None
                           ) -> torch.Tensor:
        """Utilization-dependent draw: idle + linear dynamic power."""
        cap = self.capacity if capacity is None else capacity
        util = 1.0 - cap.to(torch.float32) / torch.clamp_min(
            self.chips_total.to(torch.float32), 1.0)
        em = DEFAULT_ENERGY if energy is None else energy
        return self.power_kw * (em.idle_frac + em.dyn_frac * util)

    @property
    def sched_term(self) -> torch.Tensor:
        """Eq. 1 SCHEDULE_WEIGHT: straggler EWMA + unhealthy penalty."""
        return self.straggler_score + torch.where(self.healthy, 0.0, 1e3)

    def raw_terms(self, *, horizon_h: float = 1.0,
                  capacity: Optional[torch.Tensor] = None,
                  energy: Optional[EnergyModel] = None):
        """The four un-normalized Eq. 1 terms (cfp, fcfp, cp_ratio, sched)."""
        energy_kwh = self.effective_power_kw(capacity, energy) * horizon_h
        cfp = energy_kwh * self.pue * self.ci_now
        fcfp = energy_kwh * self.pue * self.ci_forecast
        return cfp, fcfp, self.flops_per_j, self.sched_term

    def rank(self, *, horizon_h: float = 1.0,
             weights: RankWeights = RankWeights(),
             demand_chips=None,
             capacity: Optional[torch.Tensor] = None,
             energy: Optional[EnergyModel] = None) -> torch.Tensor:
        """Eq. 1 scores for placing a job of ``demand_chips`` chips."""
        cfp, fcfp, eff, sched = self.raw_terms(horizon_h=horizon_h,
                                               capacity=capacity,
                                               energy=energy)
        cap = self.capacity if capacity is None else capacity
        mcfp = None
        if energy is not None and weights.marginal:
            mcfp = marginal_cfp(cfp, self.chips_total, energy.idle_frac,
                                energy.dyn_frac, cap == self.chips_total,
                                energy.embodied_g_per_node_h, horizon_h)
        scores = maiz_ranking(cfp, fcfp, eff, sched, weights,
                              marginal_cfp=mcfp)
        if demand_chips is not None:
            scores = torch.where(cap >= demand_chips, scores, torch.inf)
        return scores


_NP_DTYPES = {"capacity": np.int32, "chips_total": np.int32,
              "healthy": np.bool_}


def fleet_tensors(device: torch.device, **arrays) -> Fleet:
    """A ``Fleet`` from numpy arrays, cast on the host to the reference's
    dtypes (f64 -> f32 rounds to nearest, as ``jnp.asarray`` does)."""
    return Fleet(**{f: torch.from_numpy(np.ascontiguousarray(
        np.asarray(arrays[f]).astype(_NP_DTYPES.get(f, np.float32)))
    ).to(device) for f in FIELDS})


def synthetic_fleet(n: int, seed: int = 0, chips_per_node: int = 256,
                    hour: int = 0, energy: EnergyModel = DEFAULT_ENERGY, *,
                    device: DeviceLike = None) -> Fleet:
    """Deterministic synthetic fleet spanning the paper's three regions:
    the reference's numpy draws in the reference's order, so the arrays
    are bit-identical to ``repro.core.fleet.synthetic_fleet``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    regions = list(telemetry.REGIONS.values())
    ridx = rng.integers(0, len(regions), n)
    traces = np.stack([telemetry.hourly_ci(r, hours=hour + 25, seed=seed + i)
                       for i, r in enumerate(regions)])
    ci = traces[ridx]
    power_kw = chips_per_node * energy.chip_kw * (1 + 0.1 * rng.random(n))
    capacity = rng.integers(0, chips_per_node + 1, n)
    healthy = rng.random(n) > 0.02
    straggler = np.abs(rng.normal(0, 0.05, n))
    flops = 788e9 * (1 + 0.05 * rng.standard_normal(n))
    return fleet_tensors(
        dev, ci_now=ci[:, hour], ci_forecast=ci[:, hour:hour + 24].mean(-1),
        pue=np.array([r.pue for r in regions])[ridx], power_kw=power_kw,
        capacity=capacity, healthy=healthy, straggler_score=straggler,
        flops_per_j=flops, chips_total=np.full(n, chips_per_node))
