"""Carbon accounting — paper Eq. 2:  CF = EC × PUE × CI.

Torch twin of ``repro.core.carbon``: elementwise over any leading shape,
on whatever device the inputs live on.
"""
from __future__ import annotations

import torch

# TPU v5e hardware constants (used to map training jobs to energy); kept as
# the parity default of the reference's energy model
CHIP_PEAK_FLOPS_BF16 = 197e12       # FLOP/s
CHIP_POWER_W = 250.0                # ~typical board power under load
HOST_POWER_W = 450.0                # amortized host per 8 chips


def carbon_footprint(energy_kwh, pue, ci_g_per_kwh):
    """Eq. 2 — gCO2eq.  Broadcasts over any leading shape."""
    return energy_kwh * pue * ci_g_per_kwh


def emissions_g(power_w: torch.Tensor, pue, ci,
                dt_hours: float = 1.0) -> torch.Tensor:
    """Integrate a power timeseries (..., T) against CI (..., T) -> gCO2eq."""
    energy_kwh = power_w * dt_hours / 1000.0
    return torch.sum(carbon_footprint(energy_kwh, pue, ci), dim=-1)


def job_energy_kwh(step_time_s, steps, chips: int, *,
                   chip_power_w: float = CHIP_POWER_W,
                   host_power_w: float = HOST_POWER_W):
    """Energy for a job: wall time × (chips + hosts)."""
    wall_s = step_time_s * steps
    watts = chips * chip_power_w + (chips / 8.0) * host_power_w
    return wall_s / 3600.0 * watts / 1000.0


def cp_ratio(useful_flops, energy_kwh):
    """Computing-Power ratio (Eq. 1's CP_RATIO): useful FLOPs per joule."""
    joules = energy_kwh * 3.6e6
    return useful_flops / torch.clamp_min(torch.as_tensor(joules), 1e-9)
