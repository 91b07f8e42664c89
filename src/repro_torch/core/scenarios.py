"""The paper's experiment: a year of 3-node operation under four scenarios
(torch twin of ``repro.core.scenarios``).

Reproduces §5: Scenario C (active hourly load-shifting + power-off) vs the
carbon-blind baseline on 2022-like hourly CI traces for ES / NL / DE.
Headline target: **-85.68 % CO2 for Scenario C**.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core import telemetry
from repro_torch.core.carbon import emissions_g
from repro_torch.core.scheduler import SCENARIOS

# Total dynamic demand in node-equivalents of dynamic headroom.
DEFAULT_DEMAND = 0.5


@dataclasses.dataclass(frozen=True)
class ScenarioResult:
    emissions_kg: Dict[str, float]
    reduction_pct: Dict[str, float]
    energy_kwh: Dict[str, float]
    per_unit_saving_kg: Dict[str, float]


def run_paper_experiment(hours: int = telemetry.HOURS_PER_YEAR,
                         seed: int = 2022,
                         demand: float = DEFAULT_DEMAND,
                         node: telemetry.NodePower = telemetry.NodePower(),
                         profiles: Dict[str, telemetry.RegionProfile] = None,
                         *, device: DeviceLike = None) -> ScenarioResult:
    """§5 experiment on ``device``.  ``profiles`` overrides
    ``telemetry.REGIONS`` without mutating it.  Emissions are f32 sums, as
    in the reference."""
    dev = resolve_device(device)
    table = telemetry.REGIONS if profiles is None else profiles
    ci_np, pue_np = telemetry.region_traces(hours, seed, profiles=table)

    def f32(x):
        return torch.from_numpy(np.asarray(x, np.float32)).to(dev)

    ci, pue = f32(ci_np), f32(pue_np)[:, None]
    emissions, energy = {}, {}
    for name, alloc in SCENARIOS.items():
        # C is the only scenario that runs the placement engine
        kw = {"device": dev} if name == "C" else {}
        util, on = alloc(ci_np, pue_np, demand, **kw)
        power_w = node.power_w(f32(util), f32(on))            # (N, T)
        g = emissions_g(power_w, pue, ci)                     # per node
        emissions[name] = float(torch.sum(g)) / 1000.0        # kg
        energy[name] = float(torch.sum(power_w) / 1000.0)     # kWh (dt=1h)

    base = emissions["baseline"]
    reduction = {k: 100.0 * (1 - v / base) for k, v in emissions.items()}
    saving = {k: base - v for k, v in emissions.items()}
    return ScenarioResult(emissions, reduction, energy, saving)


# ---------------------------------------------------------------------------
# One-time calibration (documented; not used at runtime)
# ---------------------------------------------------------------------------


def calibrate_dip_depth(target_pct: float = 85.68,
                        lo: float = 0.3, hi: float = 0.95,
                        iters: int = 24,
                        hours: int = telemetry.HOURS_PER_YEAR, *,
                        device: DeviceLike = None) -> float:
    """Bisection on the ES dip depth so Scenario C hits ``target_pct``.

    The result (0.8171) is frozen in ``telemetry.REGIONS``; kept for
    provenance.  The candidate profile is threaded through
    ``run_paper_experiment`` (never written into ``telemetry.REGIONS``),
    so an exception mid-bisection cannot leave the table patched and
    concurrent calibrations are reentrant."""
    dev = resolve_device(device)
    base_es = telemetry.REGIONS["ES"]
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        profiles = dict(telemetry.REGIONS)
        profiles["ES"] = dataclasses.replace(base_es, dip_depth=mid)
        red = run_paper_experiment(hours=hours, profiles=profiles,
                                   device=dev).reduction_pct["C"]
        if red < target_pct:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)
