"""Signal faults in the port against the JAX reference (the reference's
tests/test_faults.py, run through both of the port's drivers):

- ``plan_faults`` byte-equal to the reference's for the same
  ``(fcfg, sim_seed)``;
- a zero-rate ``FaultConfig`` is a bitwise no-op and reproduces the
  BASE/MIXED golden digests on both drivers;
- under every fault class, the port's host loop == the port's scanned
  driver == the reference's host loop: placements, start epochs and
  every integer counter exact, emissions to rel 1e-4 (the host loops'
  f64 emissions are equal);
- the degradation semantics: failed migrations use up their budget and
  back off, safe mode freezes migrations, quarantine re-admits a node
  only after its healthy hours, and no job is silently dropped;
- a (mode x rate x seed) grid is one ensemble bucket whose lanes equal
  their own scans."""
import dataclasses
import hashlib

import numpy as np
import pytest

from test_torch_reference import load_reference, ref_sim_config

from repro_torch.core import simulator as S
from repro_torch.core.faults import FaultConfig, fault_graph_key, plan_faults
from repro_torch.core.policy import slo_deferral

BASE = S.SimConfig(epochs=24, seed=3, arrival_rate=6.0, mean_duration_h=6.0,
                   shortlist=16, history_h=48, horizon_h=8)
MIXED = S.SimConfig(epochs=36, seed=11, arrival_rate=8.0,
                    mean_duration_h=10.0, shortlist=32, history_h=48,
                    horizon_h=12, migration_budget=2, deferrable_frac=0.3,
                    outage=(0, 12, 6), flash_crowd=(20, 3, 2.5))
GOLDEN = {"base": "0141b64da0651227", "mixed": "0e6437d00c3ba558"}
COUNTERS = ("rank_sweeps", "arrivals_placed", "jobs_completed",
            "jobs_dropped", "jobs_deferred", "migrations", "evictions",
            "migrations_failed", "jobs_active_end", "safe_epochs",
            "deadline_misses", "defer_delay_h")
# the reference bench's chaos probe (benchmarks/run.py:829-838)
CHAOS = FaultConfig(ci_dropout=0.6, stale_cap_h=2, safe_stale_h=4,
                    telem_sigma=0.1, fc_outage=((5, 4),), fc_dropout=0.2,
                    mig_fail=0.4, flap_rate=0.03, quarantine_h=2)


def digest(r):
    return hashlib.sha256(np.concatenate(
        [r.node_log, r.first_node]).tobytes()).hexdigest()[:16]


def run_three(cfg, n=96, chips=64, region=None, jobs=None):
    """(port host loop, port scan, reference host loop) on one stream."""
    ref = load_reference()
    cr = ref_sim_config(cfg)
    f, t, r = S.synthetic_lifecycle_fleet(n, cfg, chips_per_node=chips,
                                          region=region, device="cpu")
    fr, tr, rr = ref.simulator.synthetic_lifecycle_fleet(
        n, cr, chips_per_node=chips, region=region)
    jobs = jobs if jobs is not None else S.generate_jobs(cfg)
    jr = ref.simulator.JobSchedule(**dataclasses.asdict(jobs))
    host = S.simulate_fleet(f, t, r, cfg, jobs=jobs)
    scan = S.simulate_fleet_scan(f, t, r, cfg, jobs=jobs)
    want = ref.simulator.simulate_fleet(fr, tr, rr, cr, jobs=jr)
    return host, scan, want


def assert_same(a, b, emissions_rel=1e-4):
    np.testing.assert_array_equal(a.node_log, b.node_log)
    np.testing.assert_array_equal(a.first_node, b.first_node)
    np.testing.assert_array_equal(a.start_epoch, b.start_epoch)
    for f in COUNTERS:
        assert getattr(a, f) == getattr(b, f), f
    if emissions_rel == 0:
        assert a.emissions_g == b.emissions_g
        np.testing.assert_array_equal(a.emissions_series,
                                      b.emissions_series)
    else:
        assert a.emissions_g == pytest.approx(b.emissions_g,
                                              rel=emissions_rel)
        np.testing.assert_allclose(a.emissions_series, b.emissions_series,
                                   rtol=emissions_rel)
    assert a.migration_cost_g == pytest.approx(b.migration_cost_g,
                                               rel=emissions_rel, abs=1e-6)


def assert_three(host, scan, want):
    """Port host == reference host (f64 emissions equal), port scan ==
    port host (f32 accounting)."""
    assert_same(host, want, emissions_rel=0)
    assert_same(scan, host)


def assert_conserved(r, jobs, cfg):
    """No job silently dropped: every in-horizon job is accounted for."""
    in_h = int((np.asarray(jobs.arrive) < cfg.epochs).sum())
    assert r.jobs_completed + r.jobs_dropped + r.jobs_active_end == in_h
    placed = r.first_node >= 0
    assert r.jobs_completed + r.jobs_active_end <= int(placed.sum())
    assert np.all(r.node_log[~placed] == -1)


# ---------------------------------------------------------------------------
# the plan: byte-equal to the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fcfg,budget,sim_seed", [
    (FaultConfig(), 2, 0),
    (FaultConfig(ci_dropout=0.5), 0, 3),
    (FaultConfig(ci_dropout=0.7, stale_cap_h=2, telem_sigma=0.1,
                 telem_bias=0.05), 2, 11),
    (FaultConfig(seed=5, flap_rate=0.05, flap_len_h=3, quarantine_h=4), 0,
     2),
    (FaultConfig(ci_dropout=0.95, stale_cap_h=2, safe_stale_h=3,
                 fc_dropout=0.4, fc_outage=((2, 5), (30, 2))), 3, 7),
    (CHAOS, 2, 3)], ids=["zero", "dropout", "noise_bias", "flap",
                         "safe_fc", "chaos"])
def test_plan_faults_byte_equal_to_reference(fcfg, budget, sim_seed):
    ref = load_reference()
    cfg = dataclasses.replace(BASE, epochs=36, seed=sim_seed)
    _, traces, ridx = S.synthetic_lifecycle_fleet(48, cfg, device="cpu")
    got = plan_faults(fcfg, traces, ridx, cfg.epochs, cfg.history_h,
                      budget, 48, sim_seed)
    want = ref.faults.plan_faults(
        ref.faults.FaultConfig(**dataclasses.asdict(fcfg)), traces, ridx,
        cfg.epochs, cfg.history_h, budget, 48, sim_seed)
    for f in dataclasses.fields(want):
        x, y = getattr(got, f.name), getattr(want, f.name)
        assert x.dtype == y.dtype and x.shape == y.shape, f.name
        assert x.tobytes() == y.tobytes(), f.name
    assert got.has_flaps == want.has_flaps
    assert got.has_migfail == want.has_migfail


def test_fault_graph_key_rates_are_data():
    ref = load_reference().faults
    cases = [None, FaultConfig(),
             FaultConfig(ci_dropout=0.9, stale_cap_h=4, telem_sigma=1.0,
                         fc_dropout=0.5, safe_stale_h=3, mig_backoff_h=7),
             FaultConfig(mig_fail=0.1), FaultConfig(flap_rate=0.1)]
    got = [fault_graph_key(c) for c in cases]
    assert got == [(False, False, False), (True, False, False),
                   (True, False, False), (True, True, False),
                   (True, False, True)]
    assert got == [ref.fault_graph_key(
        None if c is None else ref.FaultConfig(**dataclasses.asdict(c)))
        for c in cases]


def test_faultconfig_validates_rates():
    with pytest.raises(ValueError, match="ci_dropout"):
        FaultConfig(ci_dropout=1.5)
    with pytest.raises(ValueError, match="fc_outage"):
        FaultConfig(fc_outage=((-1, 4),))


# ---------------------------------------------------------------------------
# zero-fault bitwise equivalence
# ---------------------------------------------------------------------------


def test_zero_rate_faultconfig_is_bitwise_noop():
    """A FaultConfig with every rate at zero materializes exact no-op
    streams: emissions (not just placements) match faults=None bitwise on
    both drivers."""
    f, t, r = S.synthetic_lifecycle_fleet(96, BASE, chips_per_node=64,
                                          device="cpu")
    jobs = S.generate_jobs(BASE)
    zero = dataclasses.replace(BASE, faults=FaultConfig())
    for drive in (S.simulate_fleet, S.simulate_fleet_scan):
        a = drive(f, t, r, BASE, jobs=jobs)
        b = drive(f, t, r, zero, jobs=jobs)
        assert_same(a, b, emissions_rel=0)


@pytest.mark.parametrize("name", ["base", "mixed"])
@pytest.mark.parametrize("fcfg", [None, FaultConfig()],
                         ids=["none", "zero_rate"])
def test_zero_fault_runs_reproduce_golden_digests(name, fcfg):
    cfg = dataclasses.replace(BASE if name == "base" else MIXED,
                              faults=fcfg)
    f, t, r = S.synthetic_lifecycle_fleet(96, cfg, chips_per_node=64,
                                          device="cpu")
    jobs = S.generate_jobs(cfg)
    for drive in (S.simulate_fleet, S.simulate_fleet_scan):
        assert digest(drive(f, t, r, cfg, jobs=jobs)) == GOLDEN[name]


# ---------------------------------------------------------------------------
# port host == port scan == reference host under every fault class
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,fcfg", [
    ("dropout_hold", FaultConfig(ci_dropout=0.5)),
    ("dropout_persistence", FaultConfig(ci_dropout=0.7, stale_cap_h=2)),
    ("noise_bias", FaultConfig(ci_dropout=0.3, telem_sigma=0.1,
                               telem_bias=0.05)),
    ("fc_outage", FaultConfig(fc_dropout=0.4, fc_outage=((2, 5),))),
    ("safe_mode", FaultConfig(ci_dropout=0.95, stale_cap_h=2,
                              safe_stale_h=3)),
])
def test_drivers_match_reference_under_signal_faults(name, fcfg):
    cfg = dataclasses.replace(BASE, migration_budget=2,
                              deferrable_frac=0.3, faults=fcfg)
    host, scan, want = run_three(cfg)
    assert_three(host, scan, want)
    assert_conserved(host, S.generate_jobs(cfg), cfg)
    if name == "safe_mode":
        assert host.safe_epochs > 0


def test_drivers_match_reference_under_migration_faults():
    cfg = dataclasses.replace(
        BASE, migration_budget=3, mean_duration_h=16.0,
        faults=FaultConfig(mig_fail=0.5, mig_backoff_h=2))
    host, scan, want = run_three(cfg)
    assert host.migrations_failed > 0 and host.migrations > 0
    assert_three(host, scan, want)
    assert_conserved(scan, S.generate_jobs(cfg), cfg)


def test_drivers_match_reference_under_flapping():
    cfg = dataclasses.replace(
        BASE, faults=FaultConfig(flap_rate=0.03, flap_len_h=2,
                                 quarantine_h=3))
    host, scan, want = run_three(cfg)
    assert host.evictions > 0
    assert_three(host, scan, want)
    assert_conserved(scan, S.generate_jobs(cfg), cfg)


@pytest.mark.parametrize("policy", ["slo", "lookahead"])
def test_drivers_match_reference_under_everything(policy):
    """All fault classes at once, on top of outage windows, a flash crowd
    and a non-reactive policy."""
    from repro_torch.core.policy import green_window
    cfg = dataclasses.replace(
        BASE, epochs=36, migration_budget=2, deferrable_frac=0.4,
        outage=[(0, 12, 6), (2, 4, 3)], flash_crowd=(20, 3, 2.5),
        policy=slo_deferral() if policy == "slo" else green_window(),
        faults=dataclasses.replace(CHAOS, safe_stale_h=4, fc_outage=((5, 4),)))
    host, scan, want = run_three(cfg)
    assert_three(host, scan, want)
    assert_conserved(host, S.generate_jobs(cfg), cfg)
    assert host.migrations_failed > 0 and host.evictions > 0


def test_chaos_probe_matches_reference():
    """The reference bench's chaos parity probe (benchmarks/run.py:829-838),
    whose failures, flaps and safe epochs the card checks too."""
    cfg = S.SimConfig(epochs=36, seed=3, arrival_rate=6.0,
                      mean_duration_h=12.0, migration_budget=2,
                      deferrable_frac=0.3, shortlist=16, history_h=48,
                      horizon_h=8, outage=[(0, 6, 4), (1, 18, 4)],
                      faults=CHAOS)
    host, scan, want = run_three(cfg)
    assert_three(host, scan, want)
    assert host.migrations_failed > 0 and host.evictions > 0


@pytest.mark.parametrize("seed,dropout,cap,mig_fail,flap,safe_h,budget", [
    (1, 0.2, 0, 0.0, 0.0, 0, 0), (7, 0.8, 3, 0.6, 0.02, 2, 2),
    (19, 1.0, 1, 1.0, 0.05, 6, 3), (23, 0.45, 6, 0.3, 0.01, 4, 1)])
def test_random_chaos_streams_match_reference(seed, dropout, cap, mig_fail,
                                              flap, safe_h, budget):
    """The reference's chaos property test, at fixed draws."""
    cfg = dataclasses.replace(
        BASE, epochs=12, seed=seed, history_h=24, horizon_h=6,
        migration_budget=budget, deferrable_frac=0.3, defer_max_h=3,
        faults=FaultConfig(seed=seed, ci_dropout=dropout, stale_cap_h=cap,
                           telem_sigma=0.15, mig_fail=mig_fail,
                           flap_rate=flap, flap_len_h=2, quarantine_h=2,
                           safe_stale_h=safe_h, fc_dropout=dropout / 2))
    host, scan, want = run_three(cfg, n=24, chips=32)
    assert_three(host, scan, want)
    jobs = S.generate_jobs(cfg)
    assert_conserved(host, jobs, cfg)
    assert_conserved(scan, jobs, cfg)


# ---------------------------------------------------------------------------
# degradation semantics
# ---------------------------------------------------------------------------


def test_migration_failures_consume_budget_and_back_off():
    """mig_fail = 1.0: every attempt fails, nothing moves, failures are
    counted and never charged; the fault-free twin does migrate."""
    cfg = dataclasses.replace(
        BASE, migration_budget=3, mean_duration_h=16.0,
        faults=FaultConfig(mig_fail=1.0, mig_backoff_h=2))
    host, scan, want = run_three(cfg)
    assert host.migrations == 0
    assert host.migrations_failed > 0
    assert host.migration_cost_g == 0.0 == scan.migration_cost_g
    assert_three(host, scan, want)
    clean, _, _ = run_three(dataclasses.replace(cfg, faults=None))
    assert clean.migrations > 0
    # a failure blocks the job for mig_backoff_h * 2**(fails - 1) epochs:
    # with every attempt failing, fewer attempts than budget x epochs
    assert host.migrations_failed < cfg.migration_budget * cfg.epochs


def test_safe_mode_freezes_migrations():
    """At 100 % dropout past the staleness horizon the degraded operator
    stops moving jobs; the naive twin keeps migrating on stale data."""
    env = dict(ci_dropout=1.0, stale_cap_h=6)
    cfg_safe = dataclasses.replace(
        BASE, epochs=36, migration_budget=2, mean_duration_h=16.0,
        faults=FaultConfig(safe_stale_h=6, **env))
    host, scan, want = run_three(cfg_safe)
    assert host.safe_epochs > 0 and host.migrations == 0
    assert_three(host, scan, want)
    naive, naive_scan, naive_want = run_three(
        dataclasses.replace(cfg_safe, faults=FaultConfig(**env)))
    assert naive.safe_epochs == 0 and naive.migrations > 0
    assert_three(naive, naive_scan, naive_want)


def test_quarantine_readmission_in_plan():
    """A flapped node is re-admitted exactly quarantine_h healthy hours
    after its spell ends — checked on the materialized plan."""
    fcfg = FaultConfig(seed=5, flap_rate=0.05, flap_len_h=3,
                       quarantine_h=4)
    rng = np.random.default_rng(0)
    traces = rng.random((3, 120)) + 0.5
    plan = plan_faults(fcfg, traces, np.zeros(8, np.int64), epochs=48,
                       history_h=48, budget=0, n_nodes=8)
    assert (~plan.node_up).any(), "stream produced no flaps"
    up, elig = plan.node_up, plan.eligible
    T, N = up.shape
    for n in range(N):
        for t in range(T):
            down_recent = (~up[max(t - 4, 0):t, n]).any()
            assert elig[t, n] == (up[t, n] and not down_recent), (t, n)


def test_quarantine_end_to_end_blocks_placement():
    """Single-region fleet: during a node's quarantine, placements avoid
    it on both drivers."""
    cfg = dataclasses.replace(
        BASE, faults=FaultConfig(seed=2, flap_rate=0.05, flap_len_h=2,
                                 quarantine_h=6))
    host, scan, want = run_three(cfg, n=16, region=0)
    assert_three(host, scan, want)
    _, traces, ridx = S.synthetic_lifecycle_fleet(16, cfg, region=0,
                                                  device="cpu")
    plan = plan_faults(cfg.faults, traces, ridx, cfg.epochs, cfg.history_h,
                       cfg.migration_budget, 16, cfg.seed)
    started = host.start_epoch >= 0
    assert started.any()
    ok = plan.eligible[host.start_epoch[started],
                       host.node_log[started].astype(np.int64)]
    assert ok.all()


def test_persistence_fallback_changes_decisions_only_after_cap():
    f_hold = FaultConfig(seed=7, ci_dropout=0.2)
    f_cap = dataclasses.replace(f_hold, stale_cap_h=23)
    f, t, r = S.synthetic_lifecycle_fleet(96, BASE, chips_per_node=64,
                                          device="cpu")
    jobs = S.generate_jobs(BASE)
    h1 = S.simulate_fleet(f, t, r, dataclasses.replace(BASE, faults=f_hold),
                          jobs=jobs)
    h2 = S.simulate_fleet(f, t, r, dataclasses.replace(BASE, faults=f_cap),
                          jobs=jobs)
    np.testing.assert_array_equal(h1.node_log, h2.node_log)


def test_outage_list_form_and_flaps_size_the_eviction_buffer():
    jobs = S.generate_jobs(BASE)
    pol = S.Policy.for_jobs(BASE.policy, jobs.arrive, jobs.deferrable,
                            BASE.defer_max_h)
    ref = load_reference()
    for cfg in (BASE, dataclasses.replace(BASE, outage=[(0, 2, 4)]),
                dataclasses.replace(BASE, faults=FaultConfig(flap_rate=0.1)),
                dataclasses.replace(BASE, faults=FaultConfig(mig_fail=0.1))):
        a = S._scan_plan(cfg, jobs, pol)
        b = ref.simulator._scan_plan(
            ref_sim_config(cfg), ref.simulator.generate_jobs(
                ref_sim_config(cfg)), ref.policy.Policy.for_jobs(
                ref_sim_config(cfg).policy, jobs.arrive, jobs.deferrable,
                cfg.defer_max_h))
        assert (a.slots, a.m_evict, a.d_cap) == (b.slots, b.m_evict,
                                                 b.d_cap)


# ---------------------------------------------------------------------------
# the robustness grid: one ensemble bucket
# ---------------------------------------------------------------------------


def test_fault_grid_is_one_bucket_and_lanes_equal_their_scans():
    """The robustness bench's three operators x two dropout rates x two
    seeds (benchmarks/run.py:729-734): rates and caps are data, so the
    grid is one bucket, and every lane equals its own scan and, for the
    first seed, the reference's host loop."""
    modes = {"naive": FaultConfig(),
             "degraded": FaultConfig(stale_cap_h=6),
             "safe": FaultConfig(stale_cap_h=6, safe_stale_h=12)}
    base = dataclasses.replace(BASE, migration_budget=2,
                               deferrable_frac=0.2)
    fleets = {s: S.synthetic_lifecycle_fleet(
        96, dataclasses.replace(base, seed=s), chips_per_node=64,
        device="cpu") for s in (3, 4)}
    runs = []
    for mode, fc in modes.items():
        for rate in (0.5, 1.0):
            for s in (3, 4):
                c = dataclasses.replace(
                    base, seed=s, faults=dataclasses.replace(
                        fc, ci_dropout=rate))
                runs.append(fleets[s] + (c, S.generate_jobs(c)))
    keys = {S._bucket_key(S._prepare_scan_run(*sp, pad_plan=True))
            for sp in runs}
    assert len(keys) == 1
    ens = S.simulate_fleet_ensemble(runs)
    ref = load_reference()
    for sp, a in zip(runs, ens):
        assert_same(a, S.simulate_fleet_scan(*sp[:4], jobs=sp[4],
                                             pad_plan=True), emissions_rel=0)
        if sp[3].seed == 3:
            cr = ref_sim_config(sp[3])
            fr, tr, rr = ref.simulator.synthetic_lifecycle_fleet(
                96, cr, chips_per_node=64)
            want = ref.simulator.simulate_fleet(
                fr, tr, rr, cr, jobs=ref.simulator.generate_jobs(cr))
            assert_same(a, want)
    assert sum(r.safe_epochs for r in ens) > 0
