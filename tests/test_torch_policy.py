"""The carbon policies and tenant attribution in the port against the JAX
reference (the reference's tests/test_policy.py and test_energy.py, run
through both of the port's drivers):

- the green-window planner, SLO deferral and both together: the port's
  host loop == its scanned driver == the reference's host loop
  (placements, start epochs and every counter exact; the host loops' f64
  emissions equal; the scan's f32 emissions to rel 1e-4);
- the SLO queue's invariants on hand-built schedules (deadline-forced
  placement, queue capacity, value weight, misses at the deadline and at
  the horizon), the reactive goldens with the SLO and tenant columns
  drawn after the reactive ones;
- ``green_window_signals`` against the reference within 1e-5 of each
  region's scale, polymorphic in its leading axes (batched == per epoch);
- tenant gCO2: the bins sum to the emissions, host against scan rtol 1e-3;
- the SLO and planner lanes of the ensemble and ``sweep_policies``
  against the reference's."""
import dataclasses
import hashlib

import numpy as np
import pytest
import torch

from test_torch_faults import (BASE, GOLDEN, MIXED, assert_same,
                               assert_three, run_three)
from test_torch_reference import (jnp, load_reference, ref_sim_config,
                                  reference_imports)

from repro_torch.core import forecast
from repro_torch.core import policy as P
from repro_torch.core import simulator as S
from repro_torch.core.ranking import RankWeights


def _jobs(arrive, chips, dur, deferrable, deadline=None, value=None):
    return S.JobSchedule(
        arrive=np.asarray(arrive, np.int64),
        chips=np.asarray(chips, np.int64),
        duration=np.asarray(dur, np.int64),
        load=np.asarray(chips, np.float64),
        deferrable=np.asarray(deferrable, bool),
        deadline=None if deadline is None else np.asarray(deadline,
                                                          np.int64),
        value=None if value is None else np.asarray(value, np.float32))


def _close_to_scale(got, want, rtol=1e-5):
    """Within ``rtol`` of each row's scale (the forecast's bar)."""
    got = np.asarray(got, np.float64).reshape(-1, np.shape(got)[-1])
    want = np.asarray(want, np.float64).reshape(got.shape)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=rtol * float(np.abs(w).max()))


# ---------------------------------------------------------------------------
# generate_jobs: SLO and tenant columns after the reactive ones
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(policy=P.slo_deferral(deadline_hi=8)),
    dict(policy=P.slo_deferral(deadline_lo=3, deadline_hi=2), n_tenants=3),
    dict(n_tenants=4), dict(policy=P.green_window(), n_tenants=2)])
def test_generate_jobs_policy_and_tenant_columns_bit_identical(kw):
    ref = load_reference()
    cfg = dataclasses.replace(MIXED, deferrable_frac=0.5, **kw)
    a = S.generate_jobs(cfg)
    b = ref.simulator.generate_jobs(ref_sim_config(cfg))
    for f in ("arrive", "chips", "duration", "load", "deferrable",
              "deadline", "value", "tenant"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)
    # the reactive columns are those of the reactive stream
    plain = S.generate_jobs(dataclasses.replace(cfg, policy=P.REACTIVE,
                                                n_tenants=0))
    for f in ("arrive", "chips", "duration", "deferrable"):
        np.testing.assert_array_equal(getattr(a, f), getattr(plain, f))


@pytest.mark.parametrize("name", ["base", "mixed"])
def test_reactive_goldens_survive_tenant_columns(name):
    """Tenant ids draw last: turning attribution on moves no placement."""
    cfg = dataclasses.replace(BASE if name == "base" else MIXED,
                              n_tenants=3)
    f, t, r = S.synthetic_lifecycle_fleet(96, cfg, chips_per_node=64,
                                          device="cpu")
    jobs = S.generate_jobs(cfg)
    for drive in (S.simulate_fleet, S.simulate_fleet_scan):
        res = drive(f, t, r, cfg, jobs=jobs)
        got = hashlib.sha256(np.concatenate(
            [res.node_log, res.first_node]).tobytes()).hexdigest()[:16]
        assert got == GOLDEN[name]


# ---------------------------------------------------------------------------
# port host == port scan == reference host, per policy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,pcfg", [
    ("green_window", P.green_window()),
    ("slo", P.slo_deferral(value_weight=0.7, deadline_hi=8)),
    ("slo_tiny_queue", P.slo_deferral(queue_cap=2, deadline_hi=8)),
    ("combined", P.PolicyConfig(migration="lookahead", deferral="slo")),
])
def test_policy_drivers_match_reference(name, pcfg):
    cfg = dataclasses.replace(MIXED, deferrable_frac=0.5, policy=pcfg)
    host, scan, want = run_three(cfg)
    assert_three(host, scan, want)
    if pcfg.deferral == "slo":
        assert host.jobs_deferred > 0


def test_planner_gates_migrations():
    """The green-window gate batches moves: no more migrations than the
    reactive policy on the same stream, never over the budget."""
    re_cfg = dataclasses.replace(MIXED, outage=None)
    gw_cfg = dataclasses.replace(re_cfg, policy=P.green_window())
    re, _, _ = run_three(re_cfg)
    gw, gw_scan, gw_want = run_three(gw_cfg)
    assert_three(gw, gw_scan, gw_want)
    assert re.migrations > 0
    assert gw.migrations <= re.migrations
    assert gw.migrations <= re_cfg.migration_budget * re_cfg.epochs


def test_planner_without_forecast_degrades_to_reactive():
    """w2 = 0 turns the forecast off; the planner then takes the reactive
    migration decisions exactly."""
    w = RankWeights(w1=1.0, w2=0.0, w3=0.05, w4=0.05)
    re_cfg = dataclasses.replace(MIXED, weights=w)
    gw_cfg = dataclasses.replace(re_cfg, policy=P.green_window())
    re, _, _ = run_three(re_cfg)
    gw, gw_scan, gw_want = run_three(gw_cfg)
    np.testing.assert_array_equal(re.node_log, gw.node_log)
    assert re.migrations == gw.migrations
    assert_three(gw, gw_scan, gw_want)


@pytest.mark.parametrize("lookahead_h,discount,gate", [
    (4, 0.5, 1.05), (48, 0.99, 2.0), (1, 0.9, 1.4)])
def test_planner_knobs_match_reference(lookahead_h, discount, gate):
    """Look-ahead windows shorter than, equal to and past the 12-hour
    horizon (clamped), other discounts and gates."""
    cfg = dataclasses.replace(MIXED, policy=P.green_window(
        lookahead_h=lookahead_h, discount=discount, green_gate=gate))
    assert_three(*run_three(cfg))


# ---------------------------------------------------------------------------
# SLO queue invariants (deterministic constructions)
# ---------------------------------------------------------------------------


def _slo_cfg(**kw):
    base = dict(epochs=16, seed=0, arrival_rate=0.0, history_h=48,
                horizon_h=8, shortlist=8, defer_max_h=6)
    base.update(kw)
    return S.SimConfig(**base)


def test_slo_deadline_forces_placement():
    cfg = _slo_cfg(policy=P.slo_deferral(10.0))
    jobs = _jobs([2, 2], [8, 8], [2, 2], [True, False],
                 deadline=[4, 0], value=[1.0, 1.0])
    host, scan, want = run_three(cfg, n=16, jobs=jobs)
    assert host.start_epoch[0] == 2 + 4      # rode the queue to deadline
    assert host.start_epoch[1] == 2          # non-deferrable: immediate
    assert host.deadline_misses == 0
    assert host.defer_delay_h == 4
    assert_three(host, scan, want)


def test_slo_queue_capacity_prioritizes_cheap_flexible_work():
    cfg = _slo_cfg(policy=P.slo_deferral(10.0, value_weight=0.0,
                                         queue_cap=1))
    jobs = _jobs([3, 3], [8, 8], [2, 2], [True, True],
                 deadline=[4, 4], value=[5.0, 0.25])
    host, scan, want = run_three(cfg, n=16, jobs=jobs)
    assert host.start_epoch[0] == 3          # high value: overflow, now
    assert host.start_epoch[1] == 3 + 4      # low value: rode the queue
    assert_three(host, scan, want)


def test_slo_queue_ties_break_on_deadline_then_job_id():
    """Equal values: the later deadline wins the queue, then the lower
    job id (the lexsort's key, on the card as three stable sorts)."""
    cfg = _slo_cfg(policy=P.slo_deferral(10.0, value_weight=0.0,
                                         queue_cap=2))
    jobs = _jobs([3, 3, 3, 3], [8, 8, 8, 8], [2, 2, 2, 2], [True] * 4,
                 deadline=[2, 5, 5, 3], value=[0.5] * 4)
    host, scan, want = run_three(cfg, n=16, jobs=jobs)
    np.testing.assert_array_equal(host.start_epoch, [3, 8, 8, 3])
    assert_three(host, scan, want)


def test_slo_value_weight_places_urgent_work_immediately():
    cfg = _slo_cfg(policy=P.slo_deferral(10.0, value_weight=8.0))
    jobs = _jobs([3, 3], [8, 8], [2, 2], [True, True],
                 deadline=[4, 4], value=[4.0, 0.0])
    host, scan, want = run_three(cfg, n=16, jobs=jobs)
    assert host.start_epoch[0] == 3
    assert host.start_epoch[1] == 3 + 4
    assert_three(host, scan, want)


def test_slo_unplaceable_job_misses_deadline():
    cfg = _slo_cfg(policy=P.slo_deferral(0.0))
    jobs = _jobs([2], [999], [2], [True], deadline=[3], value=[1.0])
    host, scan, want = run_three(cfg, n=8, jobs=jobs)
    assert host.start_epoch[0] == -1
    assert host.jobs_dropped == 1
    assert host.deadline_misses == 1
    assert_three(host, scan, want)


def test_slo_horizon_end_queue_counts_as_misses():
    cfg = _slo_cfg(epochs=6, policy=P.slo_deferral(10.0))
    jobs = _jobs([4], [8], [2], [True], deadline=[6], value=[1.0])
    host, scan, want = run_three(cfg, n=8, jobs=jobs)
    assert host.jobs_dropped == 1 and host.deadline_misses == 1
    assert_three(host, scan, want)


def test_slo_queue_order_key():
    value = np.asarray([1.0, 0.5, 0.5, 0.5], np.float32)
    deadline = np.asarray([9, 3, 7, 7], np.int64)
    jid = np.asarray([0, 1, 2, 3], np.int64)
    order = P.slo_queue_order(value, deadline, jid)
    np.testing.assert_array_equal(jid[order], [2, 3, 1, 0])


def test_defer_green_factor_threads_both_paths():
    never = dataclasses.replace(
        BASE, deferrable_frac=1.0,
        policy=P.PolicyConfig(defer_green_factor=0.0))
    host, scan, _ = run_three(never)
    assert host.jobs_deferred == scan.jobs_deferred == 0
    always = dataclasses.replace(
        BASE, deferrable_frac=1.0,
        policy=P.PolicyConfig(defer_green_factor=100.0))
    host2, scan2, want2 = run_three(always)
    assert host2.jobs_deferred > 0
    assert_three(host2, scan2, want2)


def test_zero_defer_window_drops_without_misses():
    cfg = S.SimConfig(epochs=10, seed=2, arrival_rate=10.0,
                      mean_duration_h=8.0, deferrable_frac=0.8,
                      defer_max_h=0, shortlist=8, history_h=24, horizon_h=6,
                      policy=P.slo_deferral(deadline_hi=0))
    host, scan, want = run_three(cfg, n=4)
    assert host.jobs_dropped > 0
    assert_three(host, scan, want)


@pytest.mark.parametrize("seed,rate,deferrable,vweight,qcap,budget,look", [
    (5, 3.0, 0.4, 0.0, 0, 2, True), (17, 8.0, 1.0, 2.5, 3, 1, False),
    (1234, 6.0, 0.7, 0.7, 1, 0, False), (99, 9.5, 0.2, 1.3, 4, 2, True)])
def test_policy_random_streams_match_reference(seed, rate, deferrable,
                                               vweight, qcap, budget,
                                               look):
    """The reference's random-stream property test, at fixed draws, with
    the scan's plans padded; accounting invariants on the host loop."""
    pcfg = P.PolicyConfig(migration="lookahead" if look else "reactive",
                          deferral="slo", value_weight=vweight,
                          queue_cap=qcap, deadline_hi=5)
    cfg = dataclasses.replace(
        BASE, epochs=12, seed=seed, arrival_rate=rate,
        deferrable_frac=deferrable, migration_budget=budget,
        defer_max_h=4, history_h=24, horizon_h=6, policy=pcfg)
    host, _, want = run_three(cfg, n=24, chips=32)
    assert_same(host, want, emissions_rel=0)
    f, t, r = S.synthetic_lifecycle_fleet(24, cfg, chips_per_node=32,
                                          device="cpu")
    jobs = S.generate_jobs(cfg)
    assert_same(S.simulate_fleet_scan(f, t, r, cfg, jobs=jobs,
                                      pad_plan=True), host)
    pol = P.Policy.for_jobs(pcfg, jobs.arrive, jobs.deferrable,
                            cfg.defer_max_h, jobs.deadline, jobs.value)
    started = host.start_epoch >= 0
    delay = host.start_epoch[started] - jobs.arrive[started]
    assert int(delay.sum()) == host.defer_delay_h
    assert np.all(delay <= pol.slack[started])      # deadlines respected
    assert host.deadline_misses <= int((pol.slack > 0).sum())


def test_pad_plan_is_behavior_neutral_under_slo():
    cfg = dataclasses.replace(MIXED, deferrable_frac=0.4,
                              policy=P.slo_deferral(deadline_hi=8))
    f, t, r = S.synthetic_lifecycle_fleet(96, cfg, chips_per_node=64,
                                          device="cpu")
    jobs = S.generate_jobs(cfg)
    a = S.simulate_fleet_scan(f, t, r, cfg, jobs=jobs)
    b = S.simulate_fleet_scan(f, t, r, cfg, jobs=jobs, pad_plan=True)
    assert_same(a, b, emissions_rel=0)


def test_slo_scan_plan_matches_reference():
    ref = load_reference()
    for kw in (dict(policy=P.slo_deferral(deadline_hi=8)),
               dict(policy=P.slo_deferral(queue_cap=3)),
               dict(deferrable_frac=0.0, policy=P.slo_deferral())):
        cfg = dataclasses.replace(MIXED, **kw)
        cr = ref_sim_config(cfg)
        jobs, jr = S.generate_jobs(cfg), ref.simulator.generate_jobs(cr)
        for pad in (False, True):
            a = S._scan_plan(cfg, jobs, P.Policy.for_jobs(
                cfg.policy, jobs.arrive, jobs.deferrable, cfg.defer_max_h,
                jobs.deadline, jobs.value), pad=pad)
            b = ref.simulator._scan_plan(cr, jr, ref.policy.Policy.for_jobs(
                cr.policy, jr.arrive, jr.deferrable, cr.defer_max_h,
                jr.deadline, jr.value), pad=pad)
            for f in ("slots", "a_max", "d_cap", "rel_cap", "m_evict"):
                assert getattr(a, f) == getattr(b, f), (kw, pad, f)


# ---------------------------------------------------------------------------
# forecast green-window extraction
# ---------------------------------------------------------------------------


def test_green_window_signals_basic():
    fc = torch.tensor(np.stack([np.full(8, 100.0),
                                np.linspace(400, 100, 8)]),
                      dtype=torch.float32)
    rpue = torch.tensor([1.5, 1.0])
    la_ci, gw_min = forecast.green_window_signals(fc, rpue, 4, 0.9)
    assert la_ci.shape == (2,) and gw_min.shape == ()
    assert la_ci.dtype == gw_min.dtype == torch.float32
    assert float(la_ci[0]) == pytest.approx(100.0, rel=1e-6)
    assert float(gw_min) == pytest.approx(
        min(100.0 * 1.5, float(fc[1, 3]) * 1.0), rel=1e-6)


def test_green_window_signals_clamps_short_horizon():
    fc = torch.tensor(np.linspace(300, 100, 6)[None, :], dtype=torch.float32)
    rpue = torch.tensor([2.0])
    la_long, gw_long = forecast.green_window_signals(fc, rpue, 48, 0.9)
    la_all, gw_all = forecast.green_window_signals(fc, rpue, 6, 0.9)
    assert float(la_long[0]) == float(la_all[0])
    assert float(gw_long) == float(gw_all)
    # empty-region +inf PUE rows never win the window min, and a forecast
    # clamped at 0.0 there is no NaN
    fc2 = torch.tensor(np.stack([np.full(6, 50.0), np.zeros(6)]),
                       dtype=torch.float32)
    rpue2 = torch.tensor([1.0, np.inf], dtype=torch.float32)
    _, gw2 = forecast.green_window_signals(fc2, rpue2, 4, 0.9)
    assert float(gw2) == 50.0


def test_green_window_signals_batched_matches_per_epoch():
    """(L, T, R, H) and (T, R, H) against each (R, H): bit for bit."""
    rng = np.random.default_rng(0)
    fc = torch.from_numpy(rng.uniform(50, 500, (2, 5, 3, 12)).astype(
        np.float32))
    rpue = torch.tensor([1.1, 1.4, 1.6])
    la_b, gw_b = forecast.green_window_signals(fc, rpue, 8, 0.9)
    assert la_b.shape == (2, 5, 3) and gw_b.shape == (2, 5)
    for l in range(2):
        la_t, gw_t = forecast.green_window_signals(fc[l], rpue, 8, 0.9)
        assert torch.equal(la_t, la_b[l]) and torch.equal(gw_t, gw_b[l])
        for t in range(5):
            la_1, gw_1 = forecast.green_window_signals(fc[l, t], rpue, 8,
                                                       0.9)
            assert torch.equal(la_1, la_b[l, t])
            assert torch.equal(gw_1, gw_b[l, t])


@pytest.mark.parametrize("lookahead_h,discount", [(12, 0.9), (4, 0.5),
                                                  (48, 0.99), (1, 0.9)])
def test_green_window_signals_match_reference(lookahead_h, discount):
    """On the forecasts of a real trajectory (MIXED's traces, every epoch
    window): la_ci within 1e-5 of each region's scale (float64 weights
    against the reference's f32), gw_min and la_dst equal."""
    ref = load_reference()
    _, traces, ridx = S.synthetic_lifecycle_fleet(96, MIXED, device="cpu")
    tr = torch.from_numpy(traces.astype(np.float32))
    fc = torch.stack([forecast.forecast_regions(
        tr[:, t:t + MIXED.history_h], MIXED.horizon_h)[0]
        for t in range(MIXED.epochs)])                       # (T, R, H)
    rpue = np.full(traces.shape[0], np.inf, np.float32)
    rpue[:2] = [1.2, 1.5]                       # a node-less region too
    la, gw = forecast.green_window_signals(fc, torch.from_numpy(rpue),
                                           lookahead_h, discount)
    la_r, gw_r = ref.forecast.green_window_signals(
        jnp().asarray(fc.numpy()), jnp().asarray(rpue), lookahead_h,
        discount)
    _close_to_scale(la.numpy(), np.asarray(la_r))
    np.testing.assert_array_equal(gw.numpy(), np.asarray(gw_r))
    assert bool(torch.isfinite(gw).all())


def test_forecast_step_planner_signals_equal_the_reference_batch():
    """The host loop's per-epoch signals (``_forecast_step``) against the
    reference's batched ``_lookahead_signals`` over all epochs, with a
    forecast outage epoch falling back to persistence."""
    ref = load_reference()
    f, traces, ridx = S.synthetic_lifecycle_fleet(96, MIXED, device="cpu")
    rpue = S._region_pue(traces.shape[0], ridx, f.pue.numpy()).astype(
        np.float32)
    tr = torch.from_numpy(traces.astype(np.float32))
    fc_ok = np.ones(MIXED.epochs, bool)
    fc_ok[[3, 4, 20]] = False
    steps = [S._forecast_step(tr, torch.from_numpy(rpue),
                              MIXED.history_h + t, MIXED.history_h,
                              MIXED.horizon_h, 6, bool(fc_ok[t]), (12, 0.9))
             for t in range(MIXED.epochs)]
    la, la_dst, gw = (torch.stack([s[k] for s in steps]).numpy()
                      for k in (2, 3, 4))
    with reference_imports():
        la_r, dst_r, gw_r = ref.simulator._lookahead_signals(
            jnp().asarray(traces, jnp().float32), jnp().asarray(rpue),
            jnp().asarray(fc_ok), MIXED.epochs, MIXED.history_h,
            MIXED.horizon_h, 12, 0.9, True)
    _close_to_scale(la, np.asarray(la_r))
    _close_to_scale(la_dst[None], np.asarray(dst_r)[None])
    _close_to_scale(gw[None], np.asarray(gw_r)[None])


# ---------------------------------------------------------------------------
# tenant attribution (tests/test_energy.py:119-134)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("extra", [{}, dict(policy=P.slo_deferral(
    deadline_hi=6)), dict(policy=P.green_window())],
    ids=["reactive", "slo", "planner"])
def test_tenant_attribution_conserves_host_and_scan(extra):
    cfg = dataclasses.replace(MIXED, n_tenants=4, **extra)
    host, scan, want = run_three(cfg)
    assert_three(host, scan, want)
    for res in (host, scan):
        assert res.tenant_emissions_g.shape == (5,)
    np.testing.assert_allclose(host.tenant_emissions_g,
                               want.tenant_emissions_g, rtol=1e-12,
                               atol=1e-9 * host.emissions_g)
    np.testing.assert_allclose(host.tenant_emissions_g.sum(),
                               host.emissions_g, rtol=1e-12)
    np.testing.assert_allclose(scan.tenant_emissions_g.sum(),
                               scan.emissions_g, rtol=1e-5)
    np.testing.assert_allclose(scan.tenant_emissions_g,
                               host.tenant_emissions_g, rtol=1e-3,
                               atol=1e-7 * host.emissions_g)
    assert (host.tenant_emissions_g[:-1] > 0).all()
    assert host.tenant_emissions_g[-1] >= -1e-9 * host.emissions_g


def test_tenants_require_the_column():
    cfg = dataclasses.replace(BASE, n_tenants=2)
    f, t, r = S.synthetic_lifecycle_fleet(16, cfg, device="cpu")
    jobs = S.generate_jobs(dataclasses.replace(cfg, n_tenants=0))
    for drive in (S.simulate_fleet, S.simulate_fleet_scan):
        with pytest.raises(ValueError, match="tenant"):
            drive(f, t, r, cfg, jobs=jobs)


# ---------------------------------------------------------------------------
# the ensemble and sweep_policies under the new policies
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pol", ["slo", "lookahead", "tenants"])
def test_policy_ensemble_lanes_match_reference(pol):
    """Three seeds in one bucket: each lane == the reference ensemble's
    lane, == its own scan and == the port's host loop."""
    ref = load_reference()
    extra = {"slo": dict(policy=P.slo_deferral(deadline_hi=6)),
             "lookahead": dict(policy=P.green_window()),
             "tenants": dict(n_tenants=3, policy=P.slo_deferral(
                 value_weight=1.0, deadline_hi=6))}[pol]
    port, want = [], []
    for s in (11, 12, 13):
        cfg = dataclasses.replace(MIXED, seed=s, deferrable_frac=0.5,
                                  **extra)
        f, t, r = S.synthetic_lifecycle_fleet(96, cfg, chips_per_node=64,
                                              device="cpu")
        port.append((f, t, r, cfg, S.generate_jobs(cfg)))
        cr = ref_sim_config(cfg)
        fr, tr, rr = ref.simulator.synthetic_lifecycle_fleet(
            96, cr, chips_per_node=64)
        want.append((fr, tr, rr, cr, ref.simulator.generate_jobs(cr)))
    got = S.simulate_fleet_ensemble(port)
    with reference_imports():
        ref_lanes = ref.simulator.simulate_fleet_ensemble(want)
    for a, b, sp in zip(got, ref_lanes, port):
        assert_same(a, b)
        assert_same(a, S.simulate_fleet(*sp[:4], jobs=sp[4]))
        if pol == "tenants":
            np.testing.assert_allclose(a.tenant_emissions_g,
                                       b.tenant_emissions_g, rtol=1e-3,
                                       atol=1e-7 * b.emissions_g)


def test_sweep_policies_slo_frontier_matches_reference():
    """The SLO frontier's grid (benchmarks/run.py:537-543) at a small
    size: records, frontier and the ensemble == sequential sweeps."""
    ref = load_reference()
    kw = dict(epochs=12, seed=0, arrival_rate=6.0, mean_duration_h=3.0,
              migration_budget=0, deferrable_frac=0.5, defer_max_h=8,
              history_h=24, horizon_h=6, shortlist=8)
    grid = {"no_defer": P.slo_deferral(0.0, deadline_hi=8)}
    for w in (4.0, 1.0, 0.0):
        grid[f"slo_w{w:g}"] = P.slo_deferral(0.95, value_weight=w,
                                             deadline_hi=8)
    grid_r = {k: ref.policy.PolicyConfig(**dataclasses.asdict(v))
              for k, v in grid.items()}
    args = dict(n=16, seeds=(0, 1), chips_per_node=64, region=0)
    a = S.sweep_policies(S.SimConfig(**kw), grid, device="cpu", **args)
    b = S.sweep_policies(S.SimConfig(**kw), grid, device="cpu",
                         ensemble=False, **args)
    assert a == b
    with reference_imports():
        want = ref.simulator.sweep_policies(ref.simulator.SimConfig(**kw),
                                            grid_r, **args)
    assert len(a) == len(want) == 8
    for x, y in zip(a, want):
        for k in x:
            if k in ("emissions_g", "migration_cost_g"):
                assert x[k] == pytest.approx(y[k], rel=1e-4, abs=1e-6), k
            else:
                assert x[k] == y[k], k
    fa, fb = S.pareto_frontier(a), ref.simulator.pareto_frontier(want)
    assert [p["policy"] for p in fa] == [p["policy"] for p in fb]
    assert sum(r["deferred"] for r in a) > 0
