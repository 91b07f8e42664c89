"""Climate Performance Potential (CPP) + EU-taxonomy impact projection
(the port's own copy of ``repro.core.cpp``: pure Python, no tensors).

Reproduces the paper's §5 arithmetic exactly:

- target: 1% of the EU Taxonomy ICT mitigation potential = 19.754 Mt CO2eq;
- per the paper, one "unit" (60 servers / 3 nodes) saves 713.5 kg CO2/yr;
- units required = 19,754,000,000 kg / 713.5 kg = 27,686,054 (paper's number);
- equivalences + eco-costs with factors derived from the paper's own ratios
  (documented — the paper cites impact-forecast.com for them).

NOTE (documented discrepancy): the paper's 713.5 kg/yr per 60-server unit is
far below what 60 physical servers emit (our simulated unit saves ~53 t/yr);
we therefore reproduce the *percentage* (85.68%) from simulation and the
*projection arithmetic* with the paper's own per-unit constant.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

# paper constants
EU_TARGET_KG = 19.754e9            # 19.754 Mt CO2eq
PAPER_UNIT_SAVING_KG_YR = 713.5    # kg CO2 / unit / year (paper §5)
HORIZON_YEARS = 10

# equivalence factors derived from the paper's own equivalences
TREE_KG_PER_YR = EU_TARGET_KG / HORIZON_YEARS / 90e6      # ≈ 21.9 kg/tree/yr
CAR_KG_PER_YR = EU_TARGET_KG / HORIZON_YEARS / 2.44e6     # ≈ 0.81 t/car/yr

# eco-cost rates (€/kg CO2eq) back-derived from the paper's € figures
ECO_RATES_EUR_PER_KG = {
    "human_health": 3.00e9 / EU_TARGET_KG,
    "eco_toxicity": 4.65e9 / EU_TARGET_KG,
    "carbon_footprint": 2.63e9 / EU_TARGET_KG,
}


@dataclasses.dataclass(frozen=True)
class Projection:
    units_required: int
    total_reduction_kg: float
    per_unit_kg_yr: float
    years: int
    trees_equivalent: float
    cars_equivalent: float
    eco_costs_eur: Dict[str, float]


def eu_taxonomy_projection(per_unit_kg_yr: float = PAPER_UNIT_SAVING_KG_YR,
                           target_kg: float = EU_TARGET_KG,
                           years: int = HORIZON_YEARS) -> Projection:
    """The paper's scalability projection (its Results bullet list)."""
    units = int(target_kg / per_unit_kg_yr)
    return Projection(
        units_required=units,
        total_reduction_kg=target_kg,
        per_unit_kg_yr=per_unit_kg_yr,
        years=years,
        trees_equivalent=target_kg / years / TREE_KG_PER_YR,
        cars_equivalent=target_kg / years / CAR_KG_PER_YR,
        eco_costs_eur={k: r * target_kg
                       for k, r in ECO_RATES_EUR_PER_KG.items()},
    )


def cpp_score(baseline_kg: float, achieved_kg: float,
              functional_units: float = 1.0) -> float:
    """Climate-performance-potential per functional unit (FU): avoided
    emissions normalized by the service delivered (LCA functional-unit
    method the paper references)."""
    return (baseline_kg - achieved_kg) / max(functional_units, 1e-9)
