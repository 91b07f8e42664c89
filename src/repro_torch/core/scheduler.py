"""Carbon-aware placement: scenario policies + fleet-scale greedy
assignment (torch twin of ``repro.core.scheduler``).

1. **Scenario policies** (paper §4): per-hour (util, on) matrices for the
   Baseline / A / B / C scenarios over N nodes (numpy, as in the
   reference).
2. **Fleet placement**: jobs with chip demands are greedily assigned to
   the best MAIZ-ranked node with free capacity by the shortlist engine
   (``repro_torch.core.placement``), with the full re-rank oracle kept.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import placement
from repro_torch.core.energy import EnergyModel
from repro_torch.core.fleet import Fleet
from repro_torch.core.ranking import RankWeights

# ---------------------------------------------------------------------------
# Paper scenarios (hourly allocation over N nodes)
# ---------------------------------------------------------------------------


def baseline_alloc(ci: np.ndarray, pue: np.ndarray, demand: float
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Even spread, everything on, carbon-blind. Returns (util, on) (N,T)."""
    N, T = ci.shape
    util = np.full((N, T), demand / N)
    return util, np.ones((N, T))


def _effective_rate(ci: np.ndarray, pue: np.ndarray) -> np.ndarray:
    """MAIZX ranks by carbon FOOTPRINT (Eq. 2), i.e. CI × PUE."""
    return ci * pue[:, None]


def scenario_a_alloc(ci: np.ndarray, pue: np.ndarray, demand: float):
    """All compute to the best (lowest CI×PUE) node each hour; others ON."""
    N, T = ci.shape
    best = _effective_rate(ci, pue).argmin(axis=0)
    util = np.zeros((N, T))
    util[best, np.arange(T)] = demand
    return util, np.ones((N, T))


def scenario_b_alloc(ci: np.ndarray, pue: np.ndarray, demand: float):
    """Concentrate on one FIXED node (carbon-blind), power the rest off."""
    N, T = ci.shape
    util = np.zeros((N, T))
    on = np.zeros((N, T))
    util[0], on[0] = demand, 1.0
    return util, on


def scenario_c_alloc(ci: np.ndarray, pue: np.ndarray, demand: float, *,
                     device=None):
    """MAIZX active shifting through the rolling lifecycle simulator
    (``simulator.paper_scenario_alloc``): one 1-epoch job per hour."""
    from repro_torch.core.simulator import paper_scenario_alloc
    return paper_scenario_alloc(ci, pue, demand, device=device)


SCENARIOS = {
    "baseline": baseline_alloc,
    "A": scenario_a_alloc,
    "B": scenario_b_alloc,
    "C": scenario_c_alloc,
}


# ---------------------------------------------------------------------------
# Fleet-scale greedy placement
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Placement:
    node: torch.Tensor      # (J,) chosen node per job, -1 = unplaceable
    scores: torch.Tensor    # (N,) rank scores at FINAL occupancy
    n_sweeps: Optional[int] = None   # full rank sweeps


# Above this N/J the full re-rank's O(J·N) rescore traffic outweighs the
# shortlist engine's per-event overhead on the CPU (the reference's
# measured crossover, kept for the CPU path).
_AUTO_FULL_MAX_N_PER_JOB = 65536


def _auto_engine(n: int, j: int, use_kernel: bool = False,
                 device_type: str = "cpu") -> str:
    """Resolve ``engine="auto"`` from the device type of the fleet's
    tensors: the shortlist engine on an accelerator (its win is counted in
    memory-bound rank sweeps), the N/J crossover on the CPU."""
    del use_kernel  # kept for API parity; does not affect the choice
    if device_type != "cpu":
        return "shortlist"
    return "shortlist" if n // max(j, 1) > _AUTO_FULL_MAX_N_PER_JOB \
        else "full"


def place_jobs(fleet: Fleet, demands, weights: RankWeights = RankWeights(),
               horizon_h: float = 1.0, *,
               engine: str = "auto", shortlist: int = 32,
               use_kernel: bool = False,
               energy: Optional[EnergyModel] = None) -> Placement:
    """Greedy: jobs in given order take the best-ranked node with capacity.

    ``engine="shortlist"`` ranks once per decision epoch against a
    top-``shortlist`` list; ``engine="full"`` is the O(J·N) oracle it is
    bit-identical to; ``use_kernel`` routes the epoch sweeps through the
    rank kernel."""
    if engine == "auto":
        engine = _auto_engine(fleet.n, len(demands), use_kernel,
                              fleet.device.type)
    if engine == "shortlist":
        r = placement.place_jobs_shortlist(
            fleet, demands, weights, horizon_h, shortlist=shortlist,
            use_kernel=use_kernel, energy=energy)
    elif engine == "full":
        r = placement.place_jobs_full_rerank(fleet, demands, weights,
                                             horizon_h, energy=energy)
    else:
        raise ValueError(f"unknown placement engine: {engine!r}")
    return Placement(node=r.node, scores=r.scores, n_sweeps=r.n_sweeps)


def place_events(fleet: Fleet, demands, nodes,
                 weights: RankWeights = RankWeights(),
                 horizon_h: float = 1.0, *,
                 engine: str = "auto", shortlist: int = 32,
                 use_kernel: bool = False,
                 capacity: Optional[torch.Tensor] = None,
                 n_events: Optional[int] = None,
                 eager_sweep: bool = False,
                 energy: Optional[EnergyModel] = None) -> Placement:
    """Lifecycle placement over an interleaved event stream:
    ``demands[e] > 0`` arrival, ``< 0`` release of ``-demands[e]`` chips on
    ``nodes[e]``, ``== 0`` no-op padding (see ``placement``)."""
    if engine == "auto":
        engine = _auto_engine(fleet.n, len(demands), use_kernel,
                              fleet.device.type)
    if engine == "shortlist":
        r = placement.place_lifecycle_shortlist(
            fleet, demands, nodes, weights, horizon_h, shortlist=shortlist,
            use_kernel=use_kernel, capacity=capacity, n_events=n_events,
            eager_sweep=eager_sweep, energy=energy)
    elif engine == "full":
        r = placement.place_lifecycle_full_rerank(
            fleet, demands, nodes, weights, horizon_h, capacity=capacity,
            n_events=n_events, energy=energy)
    else:
        raise ValueError(f"unknown placement engine: {engine!r}")
    return Placement(node=r.node, scores=r.scores, n_sweeps=r.n_sweeps)
