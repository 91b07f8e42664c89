"""The port's ``core/cpp.py`` (the paper's §5 projection) and
``scenarios.calibrate_dip_depth`` against the JAX reference: every
``Projection`` field and every ``cpp_score`` equal, the paper's numbers
(tests/test_maizx_core.py's checks), and the calibration reentrant,
leaving ``telemetry.REGIONS`` untouched and landing where the
reference's does."""
import copy
import dataclasses

import pytest

from test_torch_reference import load_reference, reference_imports

import repro_torch.core as core
from repro_torch.core import cpp, scenarios, telemetry


def test_projection_matches_paper_numbers():
    p = cpp.eu_taxonomy_projection()
    assert p.units_required == 27_686_054
    assert p.trees_equivalent == pytest.approx(90e6, rel=1e-6)
    assert p.cars_equivalent == pytest.approx(2.44e6, rel=1e-6)
    assert p.eco_costs_eur["human_health"] == pytest.approx(3.0e9)
    assert p.eco_costs_eur["eco_toxicity"] == pytest.approx(4.65e9)
    assert p.eco_costs_eur["carbon_footprint"] == pytest.approx(2.63e9)


@pytest.mark.parametrize("kw", [{}, dict(per_unit_kg_yr=53_000.0),
                                dict(per_unit_kg_yr=713.5, years=3),
                                dict(target_kg=1e6, per_unit_kg_yr=1.0)])
def test_projection_fields_equal_reference(kw):
    ref = load_reference().cpp
    got = dataclasses.asdict(cpp.eu_taxonomy_projection(**kw))
    want = dataclasses.asdict(ref.eu_taxonomy_projection(**kw))
    assert got == want
    assert type(got["units_required"]) is int


def test_constants_equal_reference():
    ref = load_reference().cpp
    for k in ("EU_TARGET_KG", "PAPER_UNIT_SAVING_KG_YR", "HORIZON_YEARS",
              "TREE_KG_PER_YR", "CAR_KG_PER_YR", "ECO_RATES_EUR_PER_KG"):
        assert getattr(cpp, k) == getattr(ref, k), k


@pytest.mark.parametrize("args", [(100.0, 20.0, 4.0), (100.0, 20.0),
                                  (5.0, 7.5, 2.0), (1.0, 0.0, 0.0)])
def test_cpp_score_equals_reference(args):
    ref = load_reference().cpp
    assert cpp.cpp_score(*args) == ref.cpp_score(*args)
    if args == (100.0, 20.0, 4.0):
        assert cpp.cpp_score(*args) == pytest.approx(20.0)


def test_core_package_exports_cpp():
    assert core.eu_taxonomy_projection is cpp.eu_taxonomy_projection
    assert core.cpp_score is cpp.cpp_score
    assert core.Projection is cpp.Projection


def test_calibration_is_reentrant_and_leaves_regions_untouched():
    """The candidate profiles are threaded through explicitly: the global
    REGIONS table is never mutated, the same call gives the same answer,
    and it equals the reference's bisection on the same hours."""
    before = copy.deepcopy(telemetry.REGIONS)
    d1 = scenarios.calibrate_dip_depth(iters=3, hours=400, device="cpu")
    assert telemetry.REGIONS == before
    d2 = scenarios.calibrate_dip_depth(iters=3, hours=400, device="cpu")
    assert d1 == d2
    assert 0.3 <= d1 <= 0.95
    with reference_imports():       # scenario C imports the simulator lazily
        want = load_reference().scenarios.calibrate_dip_depth(iters=3,
                                                              hours=400)
    assert d1 == want
