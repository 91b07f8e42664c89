"""The port's scanned driver ``simulate_fleet_scan`` vs the JAX reference's
scanned core and vs the port's own host loop: node_log, first_node,
start epochs and the nine counters exact, emissions to rel 1e-4 (the scan
accounts in f32 on the device).  The reference's scan compiles once per
configuration (about 3 s), so each configuration is run once per module."""
import dataclasses
import functools

import numpy as np
import pytest

from test_torch_reference import load_reference, reference_imports

from repro_torch.core import simulator as S
from repro_torch.core.ranking import RankWeights

# tests/test_simulator_ensemble.py's BASE and MIXED streams
BASE = dict(epochs=24, seed=3, arrival_rate=6.0, mean_duration_h=6.0,
            shortlist=16, history_h=48, horizon_h=8)
MIXED = dict(epochs=36, seed=11, arrival_rate=8.0, mean_duration_h=10.0,
             shortlist=32, history_h=48, horizon_h=12, migration_budget=2,
             deferrable_frac=0.3, outage=(0, 12, 6), flash_crowd=(20, 3, 2.5))
NO_FC = (0.35, 0.0, 0.5, 0.15)        # w2 = 0: the forecast is not an input
COUNTERS = ("rank_sweeps", "arrivals_placed", "jobs_completed",
            "jobs_dropped", "jobs_deferred", "migrations", "evictions",
            "deadline_misses", "defer_delay_h")


def cfgs(weights=None, **kw):
    """The same configuration for the port and the reference."""
    ref = load_reference()
    rk = dict(kw)
    if weights is not None:
        kw = dict(kw, weights=RankWeights(*weights))
        rk["weights"] = ref.ranking.RankWeights(*weights)
    return S.SimConfig(**kw), ref.simulator.SimConfig(**rk)


def assert_same(a, b, *, emissions_rel=1e-4):
    """Placements, start epochs and counters exact; emissions to rel."""
    np.testing.assert_array_equal(a.node_log, b.node_log)
    np.testing.assert_array_equal(a.first_node, b.first_node)
    np.testing.assert_array_equal(a.start_epoch, b.start_epoch)
    for f in COUNTERS:
        assert getattr(a, f) == getattr(b, f), f
    assert a.emissions_g == pytest.approx(b.emissions_g, rel=emissions_rel)
    assert a.migration_cost_g == pytest.approx(b.migration_cost_g,
                                               rel=emissions_rel, abs=1e-6)
    np.testing.assert_allclose(a.emissions_series, b.emissions_series,
                               rtol=emissions_rel)


@functools.lru_cache(maxsize=None)
def _ref_scan(key):
    """The reference's scan on one configuration (cached per module)."""
    name, fc, kernel = key
    cp, cr = _case(name, fc, kernel)
    ref = load_reference()
    f, t, r = ref.simulator.synthetic_lifecycle_fleet(96, cr,
                                                      chips_per_node=64)
    with reference_imports():
        return ref.simulator.simulate_fleet_scan(
            f, t, r, cr, jobs=ref.simulator.generate_jobs(cr))


def _case(name, fc, kernel):
    kw = dict(BASE if name == "base" else MIXED, use_kernel=kernel)
    return cfgs(weights=None if fc else NO_FC, **kw)


def _port_scan(cp, device="cpu", n=96, chips=64):
    f, t, r = S.synthetic_lifecycle_fleet(n, cp, chips_per_node=chips,
                                          device=device)
    return S.simulate_fleet_scan(f, t, r, cp, jobs=S.generate_jobs(cp))


@pytest.mark.parametrize("name,fc,kernel", [
    ("base", True, False), ("base", False, False), ("mixed", True, False),
    ("mixed", False, False), ("mixed", True, True)])
def test_scan_matches_reference_scan(name, fc, kernel):
    """BASE and MIXED, with and without the forecast; the kernel path runs
    the plain K4 twin here against the reference's Pallas kernel in
    interpret mode."""
    cp, _ = _case(name, fc, kernel)
    a = _port_scan(cp)
    b = _ref_scan((name, fc, kernel))
    assert_same(a, b)
    if name == "mixed":
        assert a.migrations > 0 and a.evictions > 0
        if fc:
            assert a.jobs_deferred > 0


@pytest.mark.parametrize("kw", [
    dict(MIXED, weights=RankWeights(*NO_FC)),
    dict(MIXED, deferrable_frac=0.5, seed=12),
    dict(MIXED, engine="full"),
    dict(MIXED, use_kernel=True, shortlist=8),
    dict(BASE, arrival_rate=20.0, chips_lo=32, chips_hi=64),
    dict(BASE, outage=(0, 6, 6), mean_duration_h=12.0, migration_budget=3,
         defer_max_h=0, deferrable_frac=0.4),
    dict(MIXED, power_off_idle=False, consolidate=0.5, outage=((0, 4, 3),
                                                               (2, 10, 5)))],
    ids=["mixed_nofc", "defer_heavy", "full", "kernel", "exhaustion",
         "outage_no_slack", "always_on_two_outages"])
def test_scan_matches_port_host_loop(kw):
    """The port's two drivers on one stream: the scan's f32 device
    bookkeeping against the host loop's numpy bookkeeping."""
    cp = S.SimConfig(**kw)
    n = 8 if kw.get("arrival_rate") == 20.0 else 96
    f, t, r = S.synthetic_lifecycle_fleet(n, cp, chips_per_node=64,
                                          device="cpu")
    jobs = S.generate_jobs(cp)
    host = S.simulate_fleet(f, t, r, cp, jobs=jobs)
    scan = S.simulate_fleet_scan(f, t, r, cp, jobs=jobs)
    assert_same(scan, host)
    assert scan.jobs_active_end == host.jobs_active_end
    assert host.host_syncs == 0 < scan.host_syncs


def test_scan_pad_plan_is_behaviour_neutral():
    cp = S.SimConfig(**MIXED)
    f, t, r = S.synthetic_lifecycle_fleet(96, cp, chips_per_node=64,
                                          device="cpu")
    a = S.simulate_fleet_scan(f, t, r, cp)
    b = S.simulate_fleet_scan(f, t, r, cp, pad_plan=True)
    assert_same(a, b, emissions_rel=0)


def test_scan_plan_matches_reference_plan():
    ref = load_reference()
    for kw in (BASE, MIXED, dict(MIXED, deferrable_frac=0.0)):
        cp, cr = cfgs(**kw)
        jobs = S.generate_jobs(cp)
        jr = ref.simulator.generate_jobs(cr)
        for pad in (False, True):
            a = S._scan_plan(cp, jobs, S.Policy.for_jobs(
                cp.policy, jobs.arrive, jobs.deferrable, cp.defer_max_h),
                pad=pad)
            b = ref.simulator._scan_plan(cr, jr, ref.policy.Policy.for_jobs(
                cr.policy, jr.arrive, jr.deferrable, cr.defer_max_h),
                pad=pad)
            for f in ("slots", "a_max", "d_cap", "rel_cap", "m_evict"):
                assert getattr(a, f) == getattr(b, f), (kw, pad, f)
            np.testing.assert_array_equal(a.arr_ids, b.arr_ids)


def test_scan_overflow_raises_an_actionable_error(monkeypatch):
    """A job table narrower than the trajectory needs is counted, not
    silently wrapped, and the error names the ``scan_slots`` that fixes
    it; rerun with that width, the scan matches the host loop."""
    cp = S.SimConfig(**dict(BASE, arrival_rate=10.0))
    f, t, r = S.synthetic_lifecycle_fleet(96, cp, chips_per_node=64,
                                          device="cpu")
    jobs = S.generate_jobs(cp)
    real = S._scan_plan

    def narrow(cfg, jobs, pol, pad=False):
        plan = real(cfg, jobs, pol, pad)
        if cfg.scan_slots:
            return plan
        return dataclasses.replace(plan, slots=4)

    monkeypatch.setattr(S, "_scan_plan", narrow)
    with pytest.raises(RuntimeError, match=r"scan_slots=\d+") as ei:
        S.simulate_fleet_scan(f, t, r, cp, jobs=jobs)
    width = int(str(ei.value).split("scan_slots=")[1].split(")")[0])
    assert width > 4
    wide = dataclasses.replace(cp, scan_slots=width)
    scan = S.simulate_fleet_scan(f, t, r, wide, jobs=jobs)
    assert_same(scan, S.simulate_fleet(f, t, r, cp, jobs=jobs))


def test_scan_rejects_host_only_engines_and_unported_options():
    """The host-only comparators still refuse; serving traffic, once
    refused, now runs in the scan and matches the reference's host loop
    (request counters exact, request gCO2 to rel 1e-4)."""
    from test_torch_reference import ref_sim_config

    from repro_torch.core.traffic import TrafficConfig
    cp = S.SimConfig(**dict(BASE, epochs=4))
    f, t, r = S.synthetic_lifecycle_fleet(16, cp, device="cpu")
    with pytest.raises(ValueError, match="scanned core"):
        S.simulate_fleet_scan(f, t, r, dataclasses.replace(cp,
                                                           engine="blind"))
    cp = S.SimConfig(**BASE, traffic=TrafficConfig(req_rate=5000.0, n_svc=2,
                                                   mu_per_chip=0.1))
    f, t, r = S.synthetic_lifecycle_fleet(96, cp, chips_per_node=64,
                                          device="cpu")
    ref = load_reference()
    cr = ref_sim_config(cp)
    fr, tr, rr = ref.simulator.synthetic_lifecycle_fleet(96, cr,
                                                         chips_per_node=64)
    jobs = S.generate_jobs(cp)
    scan = S.simulate_fleet_scan(f, t, r, cp, jobs=jobs)
    want = ref.simulator.simulate_fleet(
        fr, tr, rr, cr, jobs=ref.simulator.JobSchedule(
            **dataclasses.asdict(jobs)))
    assert_same(scan, want)
    assert want.req_served > 0
    for k in ("req_served", "req_offered", "p99_violations"):
        assert getattr(scan, k) == getattr(want, k), k
    assert scan.req_gco2 == pytest.approx(want.req_gco2, rel=1e-4)


def test_policy_expressions_on_torch_tensors_match_numpy():
    """The scanned driver evaluates the shared policy expressions with
    ``xp=torch``: the same f32 values as numpy in the same op order."""
    import torch

    from repro_torch.core import policy as policylib
    rng = np.random.default_rng(4)
    cols = {k: rng.random(64).astype(np.float32) * s for k, s in
            (("rate_cur", 900.0), ("best_rate", 900.0), ("chips", 64.0),
             ("remaining", 30.0), ("ckpt", 0.2))}
    e = np.float32(0.30625)
    want = policylib.migration_gain(np, policylib.REACTIVE, e_kwh_h=e,
                                    **cols)
    got = policylib.migration_gain(
        torch, policylib.REACTIVE, e_kwh_h=torch.tensor(e),
        **{k: torch.from_numpy(v) for k, v in cols.items()})
    np.testing.assert_array_equal(got.numpy(), want)
    safe = rng.random(64) < 0.5
    np.testing.assert_array_equal(
        policylib.degraded_gain(torch, got, torch.from_numpy(safe)).numpy(),
        policylib.degraded_gain(np, want, safe))
    np.testing.assert_array_equal(
        policylib.degraded_future(torch, got, torch.from_numpy(safe)).numpy(),
        policylib.degraded_future(np, want, safe))
    cur, fut = cols["rate_cur"], cols["best_rate"]
    np.testing.assert_array_equal(
        policylib.wants_defer(torch.from_numpy(fut), torch.from_numpy(cur),
                              torch.tensor(np.float32(0.95))).numpy(),
        policylib.wants_defer(fut, cur, np.float32(0.95)))
