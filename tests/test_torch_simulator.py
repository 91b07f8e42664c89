"""Port host-loop simulator, forecaster and paper experiment vs the JAX
reference: the same seeded jobs and fleets, placements and counters
exact, f64 emissions equal, forecasts to f32 tolerance, Scenario C at the
paper's -85.68 %."""
import dataclasses

import numpy as np
import pytest
import torch

from test_torch_reference import jnp, load_reference, reference_imports

from repro_torch.core import forecast, scenarios, telemetry
from repro_torch.core import simulator as S
from repro_torch.core.ranking import RankWeights

# tests/test_simulator.py's BASE config, with every ported lever on
BASE = dict(epochs=36, seed=11, arrival_rate=8.0, mean_duration_h=8.0,
            shortlist=32, history_h=48, horizon_h=12)
LEVERS = dict(migration_budget=2, deferrable_frac=0.2, outage=(0, 12, 6),
              flash_crowd=(20, 3, 2.5))
NO_FC = (0.35, 0.0, 0.5, 0.15)        # w2 = 0: the forecast is not an input
COUNTERS = ("rank_sweeps", "arrivals_placed", "jobs_completed",
            "jobs_dropped", "jobs_deferred", "migrations", "evictions",
            "deadline_misses", "defer_delay_h", "jobs_active_end")


def _cfgs(weights=None, **kw):
    """The same configuration for the port and the reference."""
    ref = load_reference()
    if weights is not None:
        kw = dict(kw, weights=RankWeights(*weights))
    cp = S.SimConfig(**kw)
    rk = dict(kw)
    if weights is not None:
        rk["weights"] = ref.ranking.RankWeights(*weights)
    return cp, ref.simulator.SimConfig(**rk)


def _run_both(cp, cr, n=192, chips=128):
    ref = load_reference()
    fp, tp, rp = S.synthetic_lifecycle_fleet(n, cp, chips_per_node=chips,
                                             device="cpu")
    fr, tr, rr = ref.simulator.synthetic_lifecycle_fleet(
        n, cr, chips_per_node=chips)
    jobs = S.generate_jobs(cp)
    jobs_r = ref.simulator.generate_jobs(cr)
    a = S.simulate_fleet(fp, tp, rp, cp, jobs=jobs)
    b = ref.simulator.simulate_fleet(fr, tr, rr, cr, jobs=jobs_r)
    return a, b


def _assert_same(a, b):
    np.testing.assert_array_equal(a.node_log, b.node_log)
    np.testing.assert_array_equal(a.first_node, b.first_node)
    np.testing.assert_array_equal(a.start_epoch, b.start_epoch)
    for f in COUNTERS:
        assert getattr(a, f) == getattr(b, f), f
    assert a.emissions_g == b.emissions_g
    assert a.migration_cost_g == b.migration_cost_g
    np.testing.assert_array_equal(a.emissions_series, b.emissions_series)


@pytest.mark.parametrize("kw", [BASE, dict(BASE, **LEVERS),
                                dict(BASE, mean_duration_h=1.5,
                                     diurnal=False),
                                dict(BASE, deferrable_frac=0.5, seed=3)])
def test_generate_jobs_bit_identical(kw):
    ref = load_reference()
    cp, cr = _cfgs(**kw)
    a, b = S.generate_jobs(cp), ref.simulator.generate_jobs(cr)
    for f in ("arrive", "chips", "duration", "load", "deferrable"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("region", [None, 1])
def test_synthetic_lifecycle_fleet_bit_identical(region):
    ref = load_reference()
    cp, cr = _cfgs(**BASE)
    fp, tp, rp = S.synthetic_lifecycle_fleet(300, cp, region=region,
                                             device="cpu")
    fr, tr, rr = ref.simulator.synthetic_lifecycle_fleet(300, cr,
                                                         region=region)
    np.testing.assert_array_equal(tp, tr)
    np.testing.assert_array_equal(rp, rr)
    for f in ("ci_now", "ci_forecast", "pue", "power_kw", "capacity",
              "healthy", "straggler_score", "flops_per_j", "chips_total"):
        x, y = getattr(fp, f).numpy(), np.asarray(getattr(fr, f))
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("engine", ["shortlist", "full", "blind", "spread"])
def test_simulate_fleet_matches_reference_without_forecast(engine):
    cp, cr = _cfgs(weights=NO_FC, engine=engine, **BASE, **LEVERS)
    a, b = _run_both(cp, cr)
    _assert_same(a, b)
    if engine != "blind" and engine != "spread":
        assert a.migrations > 0 and a.evictions > 0


def test_simulate_fleet_engines_agree_and_amortize_sweeps():
    cp, _ = _cfgs(weights=NO_FC, **BASE)
    fp, tp, rp = S.synthetic_lifecycle_fleet(192, cp, chips_per_node=128,
                                             device="cpu")
    a = S.simulate_fleet(fp, tp, rp, cp)
    b = S.simulate_fleet(fp, tp, rp, dataclasses.replace(cp, engine="full"))
    np.testing.assert_array_equal(a.node_log, b.node_log)
    assert a.emissions_g == b.emissions_g
    assert a.rank_sweeps / a.arrivals_placed < 0.5 < \
        b.rank_sweeps / b.arrivals_placed


def test_simulate_fleet_kernel_path_matches_reference_kernel_path():
    """``use_kernel=True`` (plain K2 twin on the CPU; the 5-term sweep with
    w_marginal = 0) against the JAX host loop's Pallas path."""
    kw = dict(BASE, epochs=20, **LEVERS)
    cp, cr = _cfgs(weights=NO_FC, use_kernel=True, **kw)
    a, b = _run_both(cp, cr, n=96)
    _assert_same(a, b)


def test_simulate_fleet_with_forecast_matches_reference():
    """Default weights (w2 = 0.25): the forecaster feeds FCFP and the
    deferral signal.  lstsq is not bit-equal across frameworks, yet no
    placement flipped on this stream: the comparison stays exact."""
    cp, cr = _cfgs(**BASE, **LEVERS)
    a, b = _run_both(cp, cr)
    assert a.jobs_deferred > 0
    _assert_same(a, b)


def test_record_matrices_and_paper_alloc_closed_form():
    ref = load_reference()
    ci, pue = telemetry.region_traces(hours=400)
    util, on = S.paper_scenario_alloc(ci, pue, 0.5, device="cpu")
    u_r, o_r = ref.simulator.paper_scenario_alloc(ci, pue, 0.5)
    np.testing.assert_array_equal(util, u_r)
    np.testing.assert_array_equal(on, o_r)
    best = (ci * pue[:, None]).argmin(axis=0)
    want = np.zeros_like(util)
    want[best, np.arange(400)] = 0.5
    np.testing.assert_array_equal(util, want)


def test_run_paper_experiment_headline_and_per_scenario_kg():
    r = scenarios.run_paper_experiment(device="cpu")
    assert r.reduction_pct["C"] == pytest.approx(85.68, abs=0.05)
    with reference_imports():        # scenario C imports the simulator lazily
        want = load_reference().scenarios.run_paper_experiment()
    for k, v in want.emissions_kg.items():
        assert r.emissions_kg[k] == pytest.approx(v, rel=1e-5), k
        assert r.energy_kwh[k] == pytest.approx(want.energy_kwh[k],
                                                rel=1e-5), k


def _close_to_scale(got, want, rtol=1e-5):
    """Within ``rtol`` of each region's forecast scale: a least-squares
    fit's error is proportional to the solution's size, so where a
    forecast dips near the 12 g floor the elementwise relative error of
    two correct solvers grows (up to 1.1e-4 on these windows)."""
    want = np.atleast_2d(np.asarray(want))
    got = np.atleast_2d(np.asarray(got))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=rtol * float(np.abs(w).max()))


@pytest.mark.parametrize("T,horizon,off,t0", [
    (12, 6, 0, 0), (48, 12, 5, 5), (200, 24, 500, 0), (336, 24, 100, 0),
    (336, 24, 2000, 0), (336, 24, 100, 100)])
def test_forecast_matches_reference_to_tolerance(T, horizon, off, t0):
    ref = load_reference()
    ci, _ = telemetry.region_traces(hours=off + T + horizon, seed=7)
    win = ci[:, off:off + T].astype(np.float32)
    fc, coef = forecast.forecast_regions(torch.from_numpy(win), horizon, t0)
    fc_r, coef_r = ref.forecast.forecast_regions(jnp().asarray(win),
                                                 horizon, t0)
    _close_to_scale(fc.numpy(), fc_r)
    assert coef.shape == np.asarray(coef_r).shape
    one, _ = forecast.fit_forecast(torch.from_numpy(win[1]), horizon, t0)
    one_r, _ = ref.forecast.fit_forecast(jnp().asarray(win[1]), horizon, t0)
    _close_to_scale(one.numpy(), one_r)
    np.testing.assert_array_equal(
        forecast.persistence_forecast(torch.from_numpy(win[0]),
                                      horizon).numpy(),
        np.asarray(ref.forecast.persistence_forecast(jnp().asarray(win[0]),
                                                     horizon)))
    test = ci[0, t0 + T:t0 + T + horizon].astype(np.float32)
    np.testing.assert_allclose(
        float(forecast.forecast_skill(torch.from_numpy(win[0]),
                                      torch.from_numpy(test))),
        float(ref.forecast.forecast_skill(jnp().asarray(win[0]),
                                          jnp().asarray(test))), rtol=1e-4)


# the windows chip_smoke.py fits on the card: (seed, history_h, horizon_h)
# of phase 5's and phase 9's small streams and of the sim_scale config
SMOKE_WINDOWS = [(11, 48, 12), (12, 48, 12), (13, 48, 12), (1, 336, 24),
                 (2, 336, 24)]


@pytest.mark.parametrize("seed,history_h,horizon_h", SMOKE_WINDOWS)
def test_forecast_card_route_matches_reference_on_smoke_windows(
        seed, history_h, horizon_h):
    """The card's lstsq driver (gels, QR) against the reference, on every
    epoch window the simulator fits in chip_smoke.py's phases 5 and 9,
    within 1e-5 of each region's scale.  CPU torch's gels is LAPACK's QR,
    not cuSOLVER's, so this holds the route, not the card's bits: the
    card's own gap is measured on the card (chip_smoke.py)."""
    ref = load_reference()
    cfg = S.SimConfig(epochs=24, seed=seed, history_h=history_h,
                      horizon_h=horizon_h)
    _, traces, _ = S.synthetic_lifecycle_fleet(8, cfg, device="cpu")
    traces = traces.astype(np.float32)
    for t in range(cfg.epochs):
        win = traces[:, t:t + history_h]
        fc, _ = forecast.forecast_regions(torch.from_numpy(win), horizon_h,
                                          0, driver="gels")
        fc_r, _ = ref.forecast.forecast_regions(jnp().asarray(win),
                                                horizon_h, 0)
        _close_to_scale(fc.numpy(), fc_r)


def _traffic():
    from repro_torch.core.traffic import TrafficConfig
    return TrafficConfig(req_rate=8000.0, n_svc=3, flash_rate=0.1,
                         mu_per_chip=0.1)


@pytest.mark.parametrize("kw,item", [(dict(traffic=_traffic()), "item 7b")])
def test_unported_options_raise(kw, item):
    """The options this slice once refused (ROADMAP Queue 1 item 7b,
    serving traffic) now run: ``generate_jobs`` draws the reference's
    serving columns and the host loop gives the reference's placements,
    f64 emissions and request results, equal."""
    from test_torch_reference import ref_sim_config
    ref = load_reference()
    cp = S.SimConfig(**dict(BASE, epochs=12), **kw)
    cr = ref_sim_config(cp)
    jobs = S.generate_jobs(cp)
    jobs_r = ref.simulator.generate_jobs(cr)
    np.testing.assert_array_equal(jobs.svc_class, jobs_r.svc_class)
    np.testing.assert_array_equal(jobs.qps_weight, jobs_r.qps_weight)
    fp, tp, rp = S.synthetic_lifecycle_fleet(96, cp, chips_per_node=64,
                                             device="cpu")
    fr, tr, rr = ref.simulator.synthetic_lifecycle_fleet(96, cr,
                                                         chips_per_node=64)
    a = S.simulate_fleet(fp, tp, rp, cp, jobs=jobs)
    b = ref.simulator.simulate_fleet(fr, tr, rr, cr, jobs=jobs_r)
    _assert_same(a, b)
    assert b.req_served > 0
    for f in ("req_served", "req_offered", "p99_violations", "req_gco2",
              "req_p99_s"):
        assert getattr(a, f) == getattr(b, f), f
